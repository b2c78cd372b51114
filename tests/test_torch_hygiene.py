"""Hygiene of the PyTorch port: it never imports JAX or the JAX package, its
entry points do not fall back to the CPU, and its kernel wrappers and build
refuse what they cannot run."""
import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "tf_geometric_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "tf_geometric_tpu")


def _is_forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top.startswith("jax") or top in FORBIDDEN


def test_importing_the_port_loads_no_jax():
    code = textwrap.dedent("""
        import sys
        import tf_geometric_tpu_torch, tf_geometric_tpu_torch.bench
        import tf_geometric_tpu_torch.entry, chip_smoke
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0].startswith("jax") or m.split(".")[0] in
                     ("flax", "optax", "tf_geometric_tpu"))
        print(bad)
        sys.exit(1 if bad else 0)
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_no_source_file_of_the_port_imports_jax():
    """Also catches imports inside functions, which the subprocess misses."""
    offenders = []
    for path in list(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            offenders += [f"{path.name}:{node.lineno} {n}" for n in names
                          if _is_forbidden(n)]
    assert not offenders, offenders


# the host-side modules (native ops, graph and data utilities), each imported alone
HOST_MODULES = ("tf_geometric_tpu_torch.native", "tf_geometric_tpu_torch.utils.graph_utils",
                "tf_geometric_tpu_torch.utils.metrics", "tf_geometric_tpu_torch.utils.data_utils",
                "tf_geometric_tpu_torch.utils.torch_utils",
                "tf_geometric_tpu_torch.utils.profiling", "tf_geometric_tpu_torch.data.dataset")
HOST_FORBIDDEN = FORBIDDEN + ("sklearn", "networkx")


@pytest.mark.parametrize("module", HOST_MODULES)
def test_host_modules_load_no_jax_sklearn_or_networkx(module):
    """Importing each host-side module (and building the native library)
    loads no JAX, no JAX package, no sklearn and no networkx (the card's
    machine has neither of the last two; networkx is imported only inside
    ``convert_edge_to_nx_graph``)."""
    code = textwrap.dedent(f"""
        import sys
        import {module}
        import tf_geometric_tpu_torch.native as native
        native.available()
        bad = sorted(m for m in sys.modules if m.split(".")[0].startswith("jax")
                     or m.split(".")[0] in {HOST_FORBIDDEN!r})
        print(bad)
        sys.exit(1 if bad else 0)
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_no_source_file_of_the_port_imports_sklearn():
    offenders = []
    for path in list(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            offenders += [f"{path.name}:{node.lineno} {n}" for n in names
                          if n.split(".")[0] == "sklearn"]
    assert not offenders, offenders


def test_entry_points_raise_without_cuda():
    """Called with no device, bench.main() and entry() ask for the card and
    raise here instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    from tf_geometric_tpu_torch import bench
    from tf_geometric_tpu_torch.entry import entry
    with pytest.raises((AssertionError, RuntimeError)):
        bench.main(num_nodes=200, num_edges=600, steps=1)
    with pytest.raises((AssertionError, RuntimeError)):
        entry()
    with pytest.raises(ValueError):
        bench.main(num_nodes=200, num_edges=600, steps=1, device="cpu")


def test_chip_smoke_fails_without_cuda_and_alone(tmp_path):
    """chip_smoke.py exits non-zero and prints no result without a card,
    and when it is alone in a directory."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    (tmp_path / "chip_smoke.py").write_text((REPO / "chip_smoke.py").read_text())
    for cwd in (REPO, tmp_path):
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout


def test_kernel_wrappers_refuse_cpu_tensors():
    from tf_geometric_tpu_torch.ops.csr_spmm import CsrAdj, launch_csr_spmm
    from tf_geometric_tpu_torch.ops.sorted_segment import launch_sorted_segment_sum
    from tf_geometric_tpu_torch.utils.profiling import counters
    adj = CsrAdj.from_coo([[0, 1], [1, 0]], None, (2, 2), device="cpu")
    side, h = adj.fwd, torch.ones(2, 3)
    before = counters()
    with pytest.raises(ValueError, match="CUDA"):
        launch_csr_spmm(side.row_ptr, side.col, side.val, h, None, 2)
    with pytest.raises(ValueError, match="CUDA"):
        launch_sorted_segment_sum(h, torch.tensor([0, 1, 2], dtype=torch.int32),
                                  torch.empty(2, 3), True)
    assert counters() == before


def test_build_is_keyed_by_source_and_raises_without_nvcc(tmp_path, monkeypatch):
    from tf_geometric_tpu_torch.ops import _build
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "a.cu").write_text("// one")
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    first = _build._digest()
    (csrc / "a.cu").write_text("// two")
    assert _build._digest() != first
    monkeypatch.setattr(_build, "SOURCES", ("a.cu",))
    monkeypatch.setattr(_build, "_nvcc", lambda: str(tmp_path / "no-such-nvcc"))
    with pytest.raises((RuntimeError, OSError)):
        _build.build_all()
    # a compiler that fails raises with its output
    fake = tmp_path / "fake_nvcc"
    fake.write_text("#!/bin/sh\necho 'error: refused' >&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    with pytest.raises(RuntimeError, match="refused"):
        _build.build_all()
    assert not list((tmp_path / "build").rglob("*.so"))


def test_gat_kernel_wrappers_refuse_cpu_tensors():
    from tf_geometric_tpu_torch.ops import gat_attention as ga
    layout = ga.CsrGatLayout.build([[0, 1, 1], [1, 0, 1]], 2, device="cpu")
    q = torch.ones(2, 8)
    stats = torch.zeros(2, 2)
    from tf_geometric_tpu_torch.utils.profiling import counters
    before = counters()
    with pytest.raises(ValueError, match="CUDA"):
        ga.launch_gat_forward(layout.dst, q, q, q, 2)
    with pytest.raises(ValueError, match="CUDA"):
        ga.launch_gat_backward_dst(layout.dst, q, q, q, q, stats, q, 2)
    with pytest.raises(ValueError, match="CUDA"):
        ga.launch_gat_backward_src(layout.src, q, q, torch.zeros(layout.num_edges, 4), 2)
    # arrays indexed by edge id must hold the layout's edges (else the kernel
    # would read past them)
    with pytest.raises(ValueError, match=r"w must be float32 \[3, 4\]"):
        ga.launch_gat_backward_src(layout.src, q, q, torch.zeros(layout.num_edges - 1, 4), 2)
    with pytest.raises(ValueError, match=r"keep must be float32 \[3, 2\]"):
        ga.launch_gat_forward(layout.dst, q, q, q, 2, keep=torch.ones(layout.num_edges - 1, 2))
    assert counters() == before


def test_gat_unequal_head_widths_raise_off_the_cpu():
    """On a device other than the CPU and the card, gat() with d_q != d_v
    raises instead of running the segment path there (meta tensors stand in
    for one)."""
    from tf_geometric_tpu_torch.nn import gat
    x = torch.ones(4, 3, device="meta")
    wq, wv = torch.ones(3, 4, device="meta"), torch.ones(3, 8, device="meta")
    with pytest.raises(NotImplementedError, match="kernels"):
        gat(x, [[0, 1], [1, 2]], wq, torch.zeros(4, device="meta"), None,
            wq, torch.zeros(4, device="meta"), None, wv, num_heads=2)


def test_layers_ask_for_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    from tf_geometric_tpu_torch import layers
    for make in (lambda: layers.GAT(4, 8, num_heads=2), lambda: layers.GCN(4, 8),
                 lambda: layers.MeanGraphSage(4, 8), lambda: layers.SumGraphSage(4, 8),
                 lambda: layers.GCNGraphSage(4, 8), lambda: layers.MeanPoolGraphSage(4, 8),
                 lambda: layers.MaxPoolGraphSage(4, 8), lambda: layers.LSTMGraphSage(4, 8)):
        with pytest.raises((AssertionError, RuntimeError)):
            make()


def test_sampler_and_sage_bench_ask_for_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    from tf_geometric_tpu_torch import bench
    from tf_geometric_tpu_torch.nn import DeviceNeighborSampler
    with pytest.raises((AssertionError, RuntimeError)):
        DeviceNeighborSampler([[0, 1], [1, 0]])
    with pytest.raises((AssertionError, RuntimeError)):
        bench.build_sage_problem(50, 200, 4)


def test_host_sampled_sage_and_gae_ask_for_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    from tf_geometric_tpu_torch import bench
    with pytest.raises((AssertionError, RuntimeError)):
        bench.build_host_sage_problem(50, 200, 4)
    with pytest.raises((AssertionError, RuntimeError)):
        bench.build_gae_problem(200, 800)


def test_fixed_k_kernel_wrappers_refuse_cpu_tensors():
    from tf_geometric_tpu_torch.ops import fixed_k as fk
    from tf_geometric_tpu_torch.utils.profiling import counters
    before = counters()
    ints = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        fk.launch_draw_fixed_k(ints, ints[0], ints[0], ints[0])
    with pytest.raises(ValueError, match="CUDA"):
        fk.launch_fixed_k_forward(torch.ones(3, 4), ints, torch.ones(2, 3))
    with pytest.raises(ValueError, match="CUDA"):
        fk.launch_fixed_k_backward(torch.ones(3, 4), ints, torch.ones(2, 3), 3)
    assert counters() == before


def test_fixed_k_ops_raise_off_the_cpu():
    """On a device with no kernel (meta tensors stand in for one), the
    draw and the aggregation raise instead of running the plain versions."""
    from tf_geometric_tpu_torch.ops import fixed_k as fk
    ints = torch.zeros((2, 3), dtype=torch.int32, device="meta")
    csr = {"row_start": ints[0], "degree": ints[0], "sorted_col": ints[0]}
    with pytest.raises(NotImplementedError, match="draw"):
        fk.draw_fixed_k_from_ints(ints, csr)
    with pytest.raises(NotImplementedError, match="aggregation"):
        fk.fixed_k_aggregate(torch.ones(3, 4, device="meta"), ints,
                             torch.ones(2, 3, device="meta"))


def test_plain_versions_switch_is_scoped():
    """``use_plain_versions`` holds only within its block, also when the
    block raises; on CPU tensors the ops give the same result either way."""
    from tf_geometric_tpu_torch.ops import config
    from tf_geometric_tpu_torch.ops.gat_attention import CsrGatLayout, gat_attention_csr
    layout = CsrGatLayout.build([[0, 1, 1], [1, 0, 1]], 2, device="cpu")
    q = torch.arange(16, dtype=torch.float32).reshape(2, 8) / 16
    want = gat_attention_csr(layout, q, q, q, 2)
    with pytest.raises(KeyError):
        with config.use_plain_versions():
            assert config.plain_versions
            assert torch.equal(gat_attention_csr(layout, q, q, q, 2), want)
            raise KeyError
    assert not config.plain_versions


def test_halo_ops_raise_off_the_cpu():
    """``ell_spmm`` (with and without the value gradient) and
    ``gat_attention_ell`` on a device with no kernel (meta tensors stand in
    for one) raise instead of running the plain versions there."""
    from tf_geometric_tpu_torch.ops import ell
    from tf_geometric_tpu_torch.ops.csr_spmm import CsrAdj
    from tf_geometric_tpu_torch.ops.gat_attention import CsrGatLayout, gat_attention_ell
    adj = CsrAdj.from_coo([[0, 1], [2, 0]], None, (2, 3), device="meta")
    h = torch.ones(3, 4, device="meta")
    with pytest.raises(NotImplementedError):
        ell.ell_spmm(adj, h)
    values = torch.ones(2, device="meta", requires_grad=True)
    with pytest.raises(NotImplementedError):
        ell.ell_spmm(ell.with_edge_values(adj, values), h, diff_values=True)
    layout = CsrGatLayout.build([[0, 1], [2, 0]], 2, device="meta", num_src=3)
    with pytest.raises(NotImplementedError):
        gat_attention_ell(layout, torch.ones(2, 4, device="meta"), h, h, 2)


def test_run_ranks_asks_for_the_card_by_default():
    import inspect
    from tf_geometric_tpu_torch.parallel import run_ranks
    assert inspect.signature(run_ranks).parameters["device"].default == "cuda"


def test_tiled_spmm_wrapper_refuses_cpu_tensors_and_raises_off_the_cpu():
    """``launch_tiled_spmm`` refuses CPU tensors without counting a launch;
    ``tiled_spmm`` on a device with no kernel (meta tensors stand in for
    one) raises instead of running the plain pass there."""
    from tf_geometric_tpu_torch.ops import tiled_spmm as tsp
    from tf_geometric_tpu_torch.utils.profiling import counters
    ts = tsp.build_tiled_spmm([[0, 1], [1, 0]], None, (2, 2), tile=16, device="cpu")
    before = counters()
    with pytest.raises(ValueError, match="CUDA"):
        tsp.launch_tiled_spmm(ts.row_ptr, ts.col_tile, ts.a_tiles, torch.ones(2, 3), 2)
    assert counters() == before
    meta = ts._replace(**{f: getattr(ts, f).to("meta") for f in (
        "row_tile", "col_tile", "a_tiles", "row_ptr", "t_row_tile", "t_col_tile", "t_a_tiles",
        "t_row_ptr")})
    with pytest.raises(NotImplementedError, match="tiled"):
        tsp.tiled_spmm(meta, torch.ones(2, 3, device="meta"))


def test_tiled_ab_and_propagation_layers_ask_for_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    from tf_geometric_tpu_torch import bench, layers
    with pytest.raises(ValueError, match="CUDA"):
        bench.tiled_ab(num_nodes=200, num_edges=600, device="cpu")
    for make in (lambda: layers.SGC(4, 8), lambda: layers.TAGCN(4, 8),
                 lambda: layers.APPNP(4, [8, 2]), lambda: layers.SSGC(4, [8, 2]),
                 lambda: layers.ChebyNet(4, 8), lambda: layers.LEConv(4, 8)):
        with pytest.raises((AssertionError, RuntimeError)):
            make()
    with pytest.raises((AssertionError, RuntimeError)):
        from tf_geometric_tpu_torch.nn import chebynet_norm_edge
        chebynet_norm_edge([[0, 1], [1, 0]], 2)


def _refused_pass(case):
    """Arguments of one ``launch_tiled_spmm`` call the wrapper refuses."""
    from tf_geometric_tpu_torch.ops import tiled_spmm as tsp
    ts = tsp.build_tiled_spmm([[0, 1], [1, 0]], None, (2, 2), tile=16, dtype=torch.bfloat16,
                              device="cpu")
    one = (torch.tensor([0, 1], dtype=torch.int32), torch.zeros(1, dtype=torch.int32))
    h = torch.ones(2, 3)
    return {"cpu": (ts.row_ptr, ts.col_tile, ts.a_tiles, h, 2),
            "non-contiguous": (ts.row_ptr, ts.col_tile, ts.a_tiles, torch.ones(3, 2).t(), 2),
            "t=24": one + (torch.zeros(1, 24, 24, dtype=torch.bfloat16), h, 2),
            "t=272": one + (torch.zeros(1, 272, 272, dtype=torch.bfloat16), h, 2)}[case]


@pytest.mark.parametrize("case,match", [("cpu", "CUDA"), ("non-contiguous", "contiguous"),
                                        ("t=24", "multiple of 16"), ("t=272", "multiple of 16")])
def test_tiled_spmm_wrapper_refusals_count_no_launch(case, match):
    """The bf16-tile wrapper refuses CPU tensors, a non-contiguous operand
    and tiles that are not a multiple of 16 up to 256 before anything runs,
    and counts no launch."""
    from tf_geometric_tpu_torch.ops import tiled_spmm as tsp
    from tf_geometric_tpu_torch.utils.profiling import counters
    args = _refused_pass(case)
    before = counters()
    with pytest.raises(ValueError, match=match):
        tsp.launch_tiled_spmm(*args)
    assert counters() == before


# the accuracy head-to-head's modules (bench twins, harnesses, graph demo twins)
H2H_MODULES = tuple(
    [f"tf_geometric_tpu_torch.benchmarks.node_classification.bench_node_cls_early_stop_{m}"
     for m in ("gcn", "gat", "sgc", "ssgc", "appnp")]
    + ["tf_geometric_tpu_torch.benchmarks.node_classification.head_to_head_port",
       "tf_geometric_tpu_torch.benchmarks.graph_classification.head_to_head_graph_port"]
    + [f"tf_geometric_tpu_torch.demos.demo_{d}"
       for d in ("mean_pool", "gin", "sag_pool_h", "sort_pool", "diff_pool", "min_cut_pool")])


@pytest.mark.parametrize("module", H2H_MODULES)
def test_head_to_head_modules_load_no_jax_sklearn_or_networkx(module):
    """Each module of the head-to-head imports alone without JAX, the JAX
    package, sklearn or networkx: it reads the JAX side's committed results
    as data, never as code."""
    code = textwrap.dedent(f"""
        import sys
        import {module}
        bad = sorted(m for m in sys.modules if m.split(".")[0].startswith("jax")
                     or m.split(".")[0] in {HOST_FORBIDDEN!r})
        print(bad)
        sys.exit(1 if bad else 0)
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_head_to_head_entry_points_raise_without_cuda(tmp_path):
    """A twin's ``run`` and a demo twin's model, called without a device,
    ask for the card and raise here instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    from tf_geometric_tpu_torch.benchmarks.node_classification import (
        bench_node_cls_early_stop_sgc, head_to_head_port)
    from tf_geometric_tpu_torch.demos.demo_gin import GINModel
    data = head_to_head_port.cell_data("sgc", "cora", "cpu")
    with pytest.raises((AssertionError, RuntimeError)):
        bench_node_cls_early_stop_sgc.run(0, dataset="cora", data=data)
    with pytest.raises((AssertionError, RuntimeError)):
        GINModel(4, 2, 32)
    with pytest.raises((AssertionError, RuntimeError)):
        head_to_head_port.main(1, ["sgc_cora"], out_path=tmp_path / "out.json")
    assert not (tmp_path / "out.json").exists()


# the demo twins of ``demo/`` (and the tutorial's) added after the head-to-head's
DEMO_TWIN_MODULES = tuple(
    f"tf_geometric_tpu_torch.demos.{d}"
    for d in ("demo_sgc", "demo_appnp", "demo_ssgc", "demo_tagcn", "demo_chebynet",
              "demo_drop_edge_gcn", "demo_sparse_node_features", "demo_gae", "demo_dgi",
              "demo_device_sampling", "demo_graph_sage", "demo_graph_sage_func",
              "demo_hetero_rgcn", "demo_asap", "demo_set2set", "demo_topk_pool",
              "demo_checkpoint", "demo_save_and_load_model", "demo_sample_neighbors",
              "demo_elegant_api", "tutorial_intro", "demo_model_net_dataset",
              "demo_distributed_gcn", "demo_distributed_mean_pool"))
# the scripts whose twins are still to be written: none
PENDING_DEMOS = ()
# the twins run no module of JAX's libraries (flax, optax and orbax among them)
TWIN_FORBIDDEN = HOST_FORBIDDEN + ("orbax",)
# twins that run on the host only (no card to ask for)
HOST_ONLY_TWINS = ("tf_geometric_tpu_torch.demos.demo_sample_neighbors",)


def test_demo_twin_modules_load_no_jax_sklearn_or_networkx():
    """Each demo twin, imported in turn in one process, brings in no JAX,
    no JAX package, no flax, optax or orbax, no sklearn and no networkx
    (the card's machine has neither of the last two); the first module that
    would is named."""
    code = textwrap.dedent(f"""
        import importlib, sys
        for name in {DEMO_TWIN_MODULES!r}:
            importlib.import_module(name)
            bad = sorted(m for m in sys.modules if m.split(".")[0].startswith("jax")
                         or m.split(".")[0] in {TWIN_FORBIDDEN!r})
            if bad:
                print(name, bad)
                sys.exit(1)
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("module", [m for m in DEMO_TWIN_MODULES if m not in HOST_ONLY_TWINS])
def test_demo_twin_mains_raise_without_cuda(module, tmp_path, monkeypatch):
    """Each twin's ``main``, called without a device, asks for the card and
    raises here instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    import importlib
    monkeypatch.setenv("TFG_TPU_DATA_ROOT", str(tmp_path))
    monkeypatch.setenv("TFG_DEMO_SMOKE_STEPS", "1")
    for var in ("TFG_HARD_PROTOCOL", "BENCH_DATASET", "TFG_HARD_GRAPH_CLS"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises((AssertionError, RuntimeError)):
        importlib.import_module(module).main()


def test_every_demo_script_has_a_twin_or_is_pending():
    """``demo/demo_*.py`` (``demo_utils`` aside) and ``tutorial_intro.py``:
    each script has a twin of the same name under
    ``tf_geometric_tpu_torch/demos/``, and no script is pending
    (``PENDING_DEMOS`` is empty); every twin is a module of the import
    check or one of the head-to-head's."""
    scripts = ({p.stem for p in (REPO / "demo").glob("demo_*.py")} - {"demo_utils"}
               | {p.stem for p in REPO.glob("tutorial_intro.py")})
    twins = {p.stem for p in (PORT / "demos").glob("*.py")} - {"demo_utils", "__init__"}
    assert PENDING_DEMOS == ()
    assert "tutorial_intro" in scripts and len(scripts) == 32
    assert scripts == twins, sorted(scripts ^ twins)
    assert {f"tf_geometric_tpu_torch.demos.{t}" for t in twins} >= set(DEMO_TWIN_MODULES)
