"""The report of the port's own spans and counters (``gnnbench/port_report.py``)
on a tiny CPU cell, and its readers (``harness/port_trace.py``) on spans and
a Chrome trace written by hand."""
import io
import json
from contextlib import redirect_stdout

import pytest
import torch

from gnnbench import port_report
from gnnbench.harness import port_trace
from tf_geometric_tpu_torch.utils.profiling import Span

from conftest import TINY_CELLS

SEED = 2 ** 31 + 91


@pytest.mark.parametrize("cell", sorted(TINY_CELLS))
def test_the_report_reads_the_port_spans(tiny_root, cell, monkeypatch):
    """Host ms in the port's ops and in its layers, no more together than a
    traced step's host ms; set-up seconds in the layout builds, under the
    set-up's; no kernel load, no launch on the CPU; one build of each layout
    the model uses in set-up and none in a step."""
    monkeypatch.setattr(port_report, "BLOCKS", 4)
    monkeypatch.setattr(port_report, "STEPS", 2)
    monkeypatch.setattr(port_report, "MICRO_CALLS", 100)
    out = io.StringIO()
    with redirect_stdout(out):
        assert port_report.main(["--workload", cell, "--seed", str(SEED)], root=tiny_root,
                                device=torch.device("cpu")) == 0
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert line["ops_host_ms"] > 0 and line["conv_host_ms"] > 0
    assert line["ops_host_ms"] + line["conv_host_ms"] <= line["host_ms_on"]
    assert 0 < line["layout_build_s"] < line["setup_s"]
    assert line["kernel_load_s"] is None
    kinds = ("norm_adj", "csr_layout") if cell.startswith("gcn") else ("gat_layout",)
    setup = line["setup_counters"]
    assert {k: v for k, v in setup.items() if k.startswith("cache.miss.")} == {
        f"cache.miss.{kind}": 1 for kind in kinds}
    assert not any(k.startswith(("kernels.", "launches.")) for k in setup)
    step = line["counters_per_step"]
    assert not any(k.startswith(("cache.miss.", "launches.")) for k in step)
    assert all(step[f"cache.hit.{kind}"] > 0 for kind in kinds)
    assert line["spans_per_step"] > 0 and line["traced_steps"] >= 10
    assert set(line["span_us"]) == {"bare_call", "decorated_off", "with_off", "with_on"}


def test_outer_and_self_ns_count_each_nanosecond_once():
    """A layer span holding a conv span holding an op span, then an op span
    on another thread nested in an op span: ``outer_ns`` counts the nested
    op once; ``self_ns`` takes each span's children off."""
    spans = [Span("tfg.layers.GCN", 0, 100, None, 1),
             Span("tfg.nn.conv.gcn", 10, 90, 0, 1),
             Span("tfg.ops.csr_spmm.forward", 20, 50, 1, 1),
             Span("tfg.ops.csr_spmm.backward", 200, 260, None, 2),
             Span("tfg.ops.spmm.backward", 210, 230, 3, 2),
             Span("tfg.ops.open", 300, None, None, 1)]
    assert port_trace.outer_ns(spans, ["tfg.ops."]) == 30 + 60
    assert port_trace.self_ns(spans, ["tfg.layers.", "tfg.nn.conv."]) == (100 - 80) + (80 - 30)
    assert port_trace.outer_ns(spans, ["tfg.setup."]) is None
    assert port_trace.since(spans, 2)[:3] == [spans[2]._replace(parent=None), spans[3],
                                              spans[4]._replace(parent=1)]
    assert port_trace.per_step({"a": 1, "b": 2}, {"a": 5, "b": 2, "c": 2}, 2) == {"a": 2.0,
                                                                                   "c": 1.0}


def _chrome_trace(path, events):
    path.write_text(json.dumps({"traceEvents": [dict(ph="X", pid=1, **e) for e in events]}))
    return str(path)


def test_idle_gaps_are_labelled_by_the_innermost_port_span_of_the_launching_thread(tmp_path):
    """Two host threads (11: the harness's spans and a layer's forward; 22:
    an op's backward), three gaps: one ended by a launch inside the nested
    forward spans on 11, one by a launch on 22 inside its backward span
    while 11 is in a port span too, one by a launch outside any port span."""
    def op(ts, dur, corr):
        return dict(cat="kernel", name=f"k{corr}", ts=ts, dur=dur, tid=7,
                    args={"correlation": corr})

    def launch(ts, corr, tid):
        return dict(cat="cuda_runtime", name="cudaLaunchKernel", ts=ts, dur=1, tid=tid,
                    args={"correlation": corr})

    def span(name, ts, dur, tid):
        return dict(cat="user_annotation", name=name, ts=ts, dur=dur, tid=tid)

    events = [
        span("forward", 0, 100, 11), span("tfg.layers.GCN", 5, 90, 11),
        span("tfg.nn.conv.gcn", 10, 80, 11), span("tfg.ops.csr_spmm.forward", 20, 10, 11),
        span("backward", 100, 200, 11), span("tfg.test.outer", 100, 200, 11),
        span("tfg.ops.csr_spmm.backward", 150, 50, 22),
        launch(25, 1, 11), op(30, 5, 1),            # ends nothing: the first op
        launch(40, 2, 11), op(50, 5, 2),            # gap 15: in tfg.nn.conv.gcn
        launch(160, 3, 22), op(170, 10, 3),         # gap 115: thread 22's backward span
        launch(350, 4, 11), op(400, 5, 4),          # gap 220: no span open on 11
    ]
    prof = port_trace.read_chrome_trace(_chrome_trace(tmp_path / "t.json", events), 1)
    assert prof.idle_gaps_by_span() == [["between_steps", 220e-6], ["tfg.ops.csr_spmm.backward",
                                        115e-6], ["tfg.nn.conv.gcn", 15e-6]]
    # the harness's own labels stay as they were
    assert [g[0] for g in prof.idle_gaps()] == ["between_steps", "backward", "forward"]
    assert [s[0] for s in prof.spans] == ["forward", "backward"]
    assert prof.idle_gaps_by_span(top=1) == [["between_steps", 220e-6]]
