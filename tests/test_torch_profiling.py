"""The port's spans and counters (``utils/profiling.py``) on the CPU: nothing
recorded while tracing is off, counters always on, parent links and
per-thread stacks through autograd, the set-up spans and cache counters of
the GCN and GAT caches, the kernel load, the profiler's annotations, and
``trace``'s default directory."""
import contextlib
import ctypes
import os
import shutil
import sys
import threading

import numpy as np
import pytest
import torch

from tf_geometric_tpu_torch import SparseMatrix, layers
from tf_geometric_tpu_torch.nn.conv.gat import _gat_edge_cache
from tf_geometric_tpu_torch.nn.conv.gcn import compute_cache_key, gcn_norm_adj, maybe_compile_ell
from tf_geometric_tpu_torch.ops import _build
from tf_geometric_tpu_torch.ops.csr_spmm import CsrAdj, csr_spmm
from tf_geometric_tpu_torch.parallel.runner import LAUNCH_FAMILIES, kernel_launch_counts
from tf_geometric_tpu_torch.utils import profiling
from tf_geometric_tpu_torch.utils.profiling import count, counters, span, spans, tracing


@pytest.fixture(autouse=True)
def fresh():
    profiling.reset()
    yield
    profiling.reset()


def _ring(n=12, hub_edges=0):
    """A directed ring on ``n`` nodes, plus ``hub_edges`` edges into node 0."""
    rows = list(range(n)) + [0] * hub_edges
    cols = [(i + 1) % n for i in range(n)] + [1 + i % (n - 1) for i in range(hub_edges)]
    return torch.tensor([rows, cols])


def _named(recorded, name):
    found = [s for s in recorded if s.name == name]
    assert found, (name, [s.name for s in recorded])
    return found


def test_nothing_is_recorded_while_tracing_is_off():
    @span("tfg.test.decorated")
    def work(x):
        return x + 1

    with span("tfg.test.block"):
        assert work(1) == 2
    layers.GCN(4, 3, device="cpu")([torch.ones(12, 4), _ring()], cache={})
    assert spans() == []
    with tracing():
        with tracing():
            with span("tfg.test.on"):
                work(1)
        assert profiling._tracing
    with span("tfg.test.off_again"):
        pass
    assert [s.name for s in spans()] == ["tfg.test.on", "tfg.test.decorated"]
    assert not profiling._tracing


def test_counters_count_while_tracing_is_off():
    count("tfg.test.a")
    count("tfg.test.a", 4)
    cache = {}
    layers.GCN(4, 3, device="cpu")([torch.ones(12, 4), _ring()], cache=cache)
    got = counters()
    assert got["tfg.test.a"] == 5
    assert got["cache.miss.norm_adj"] == 1 and got["cache.miss.csr_layout"] == 1
    assert spans() == []
    got["tfg.test.a"] = 0  # a copy
    assert counters()["tfg.test.a"] == 5


def test_launch_counts_read_the_registry():
    assert set(kernel_launch_counts()) == set(LAUNCH_FAMILIES) and len(LAUNCH_FAMILIES) == 11
    before = kernel_launch_counts()
    count("launches.csr_spmm", 3)
    count("launches.gat_forward")
    after = kernel_launch_counts()
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == {
        "csr_spmm": 3, "gat_forward": 1}
    profiling.reset()
    assert not any(kernel_launch_counts().values())
    for module in ("csr_spmm", "gat_attention", "fixed_k", "spmm_heads", "sorted_segment",
                   "tiled_spmm"):
        mod = sys.modules[f"tf_geometric_tpu_torch.ops.{module}"]
        wrappers = [getattr(mod, n) for n in dir(mod) if n.startswith("launch_")]
        assert wrappers and not any(hasattr(w, "launches") or hasattr(w, "calls")
                                    for w in wrappers), module


def test_chip_smoke_reads_the_registry():
    import chip_smoke
    count("launches.spmm_heads", 2)
    count("launches.tiled_spmm")
    got = dict(zip(chip_smoke._KERNELS, chip_smoke._launch_counts()))
    assert got == dict(kernel_launch_counts()) and got["spmm_heads"] == 2
    chip_smoke._zero_launch_counts()
    assert not any(chip_smoke._launch_counts()) and counters() == {}


def test_parents_link_the_layer_the_op_and_the_backward_on_its_own_thread():
    """A GCN layer's forward nests ``tfg.layers.GCN`` > ``tfg.nn.conv.gcn`` >
    ``tfg.ops.csr_spmm.forward``; the op's backward span is recorded on the
    thread autograd ran it on, under the spans open on that thread."""
    layer = layers.GCN(4, 3, device="cpu")
    x = torch.randn(12, 4)
    cache = {}
    layer([x, _ring()], cache=cache)  # set-up: the caches
    ran_on = []
    with tracing():
        with span("tfg.test.step"):
            out = layer([x, _ring()], cache=cache)
        out.register_hook(lambda g: ran_on.append(threading.get_native_id()))
        with span("tfg.test.backward"):
            out.sum().backward()
    recorded = spans()
    by_name = {s.name: s for s in recorded}
    step, layer_span, conv, fwd = (by_name[n] for n in (
        "tfg.test.step", "tfg.layers.GCN", "tfg.nn.conv.gcn", "tfg.ops.csr_spmm.forward"))
    assert recorded[layer_span.parent] is step and recorded[conv.parent] is layer_span
    assert recorded[fwd.parent] is conv
    assert all(s.start_ns <= s.end_ns for s in recorded)
    assert step.start_ns <= layer_span.start_ns <= fwd.start_ns <= fwd.end_ns <= step.end_ns
    bwd = by_name["tfg.ops.csr_spmm.backward"]
    assert ran_on and bwd.thread == ran_on[0]
    if bwd.parent is not None:  # the CPU engine runs it on the calling thread
        assert recorded[bwd.parent].thread == bwd.thread
        assert recorded[bwd.parent].name == "tfg.test.backward"
    assert {s.thread for s in recorded} >= {threading.get_native_id()}


def test_each_thread_has_its_own_stack():
    """A forward and backward run on a second thread while the main thread
    holds a span open: the second thread's spans have no parent on the main
    thread's stack."""
    adj = CsrAdj.from_coo(_ring(), None, (12, 12), device="cpu")
    h = torch.randn(12, 5, requires_grad=True)
    done = []

    def worker():
        with span("tfg.test.worker"):
            csr_spmm(adj, h).sum().backward()
        done.append(threading.get_native_id())

    with tracing():
        with span("tfg.test.main"):
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=60)
    assert not t.is_alive() and done
    recorded = spans()
    main = _named(recorded, "tfg.test.main")[0]
    work = _named(recorded, "tfg.test.worker")[0]
    assert work.parent is None and work.thread == done[0] != main.thread
    fwd = _named(recorded, "tfg.ops.csr_spmm.forward")[0]
    assert recorded[fwd.parent] is work
    bwd = _named(recorded, "tfg.ops.csr_spmm.backward")[0]
    assert bwd.parent is None or recorded[bwd.parent].thread == bwd.thread
    assert all(s.parent is None or recorded[s.parent].thread == s.thread for s in recorded)


def test_counters_lose_no_update_across_threads():
    threads, per_thread = 2 * (os.cpu_count() or 4), 2000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=lambda: [count("tfg.test.race")
                                                    for _ in range(per_thread)])
                   for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(w.is_alive() for w in workers)
    assert counters()["tfg.test.race"] == threads * per_thread


def test_gcn_cache_miss_then_hit():
    adj = SparseMatrix(_ring(20, hub_edges=70), None, (20, 20), device="cpu")
    cache = {}
    with tracing():
        normed = gcn_norm_adj(adj, cache=cache)
        key = compute_cache_key("both", True, True, True, False)
        csr = maybe_compile_ell(normed, cache, key)
    first = spans()
    assert [s.name for s in first] == ["tfg.setup.norm_adj", "tfg.setup.csr_layout"]
    got = counters()
    assert got["cache.miss.norm_adj"] == 1 and got["cache.miss.csr_layout"] == 1
    assert "cache.hit.norm_adj" not in got and "cache.hit.csr_layout" not in got
    # node 0 holds 72 entries (70 + the ring's + its self-loop, kept apart as the
    # diagonal): one hub of the forward side, split in two virtual rows
    assert got["hubs.split"] == 1 and got["hubs.virtual_rows"] == 2
    assert csr.fwd.num_virtual == 2 and csr.bwd.num_virtual == 0
    with tracing():
        gcn_norm_adj(adj, cache=cache)
        assert maybe_compile_ell(normed, cache, key) is csr
    assert len(spans()) == 2
    got = counters()
    assert got["cache.hit.norm_adj"] == 1 and got["cache.hit.csr_layout"] == 1
    assert got["cache.miss.norm_adj"] == 1 and got["cache.miss.csr_layout"] == 1


def test_gat_cache_miss_then_hit():
    cache = {}
    with tracing():
        first = _gat_edge_cache(_ring(), 12, cache, device="cpu")
        assert _gat_edge_cache(_ring(), 12, cache, device="cpu") is first
    recorded = spans()
    assert [s.name for s in recorded] == ["tfg.setup.gat_layout"] * 2
    assert recorded[1].parent == 0  # CsrGatLayout.build's own span, in the miss's
    got = counters()
    assert got["cache.miss.gat_layout"] == 1 and got["cache.hit.gat_layout"] == 1
    with tracing():
        _gat_edge_cache(_ring(), 12, None, device="cpu")  # no cache: no lookup
    assert len(spans()) == 2 and counters() == got


def test_gat_layer_spans_nest_and_its_backward_is_traced():
    layer = layers.GAT(6, 4, attention_units=4, num_heads=2, device="cpu")
    x = torch.randn(12, 6)
    cache = {}
    with tracing():
        layer([x, _ring()], cache=cache).sum().backward()
    recorded = spans()
    names = [s.name for s in recorded]
    assert names.count("tfg.setup.gat_layout") == 2
    conv = _named(recorded, "tfg.nn.conv.gat")[0]
    assert recorded[conv.parent].name == "tfg.layers.GAT"
    fwd = _named(recorded, "tfg.ops.gat_attention.forward")[0]
    assert recorded[fwd.parent] is conv
    _named(recorded, "tfg.ops.gat_attention.backward")


def test_the_kernel_load_is_a_span_on_first_use_only(monkeypatch, tmp_path):
    class FakeLibrary:
        def __init__(self, path):
            self.path = path
            self.tfg_fake = lambda: 0

    monkeypatch.setattr(_build, "_libraries", {})
    monkeypatch.setattr(_build, "build_all",
                        lambda: {src: tmp_path / src for src in _build.SOURCES})
    monkeypatch.setattr(ctypes, "CDLL", FakeLibrary)
    with tracing():
        for _ in range(3):
            fn = _build.kernel_function("csr_spmm.cu", "tfg_fake", [ctypes.c_int])
    assert fn.argtypes == [ctypes.c_int]
    assert [s.name for s in spans()] == ["tfg.setup.kernel_load"]
    assert counters() == {"kernels.found": 1}


def test_a_span_is_a_profiler_annotation_only_while_a_profiler_runs():
    from torch.profiler import ProfilerActivity, profile
    with tracing():
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with span("tfg.test.annotated"):
                torch.ones(8) + 1
        with span("tfg.test.plain"):
            torch.ones(8) + 1
    names = {e.name for e in prof.events()}
    assert "tfg.test.annotated" in names and "tfg.test.plain" not in names
    assert [s.name for s in spans()] == ["tfg.test.annotated", "tfg.test.plain"]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("tfg.test.off"):
            torch.ones(8) + 1
    assert "tfg.test.off" not in {e.name for e in prof.events()}


def test_trace_writes_to_a_new_directory_by_default():
    dirs = []
    try:
        for _ in range(2):
            with profiling.trace() as log_dir:
                dirs.append(log_dir)
                torch.ones(16, 16) @ torch.ones(16, 16)
        assert dirs[0] != dirs[1]
        for d in dirs:
            assert any(f.endswith(".pt.trace.json") for f in os.listdir(d))
    finally:
        for d in dirs:
            shutil.rmtree(d, ignore_errors=True)


@pytest.mark.parametrize("on", [False, True])
def test_a_traced_step_computes_what_an_untraced_one_does(on):
    """Spans change nothing the layer computes."""
    torch.manual_seed(0)
    layer = layers.GCN(4, 3, device="cpu")
    x = torch.randn(12, 4, requires_grad=True)
    cache = {}
    want = layer([x, _ring()], cache=cache)
    with tracing() if on else contextlib.nullcontext():
        got = layer([x, _ring()], cache=cache)
    np.testing.assert_array_equal(got.detach().numpy(), want.detach().numpy())
    assert bool(spans()) == on
