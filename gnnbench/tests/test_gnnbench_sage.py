"""The GraphSAGE configuration's files: each loads by its name, its work
counts equal a hand count on a 6-node graph, and the per-layer readers of
its cell pick out the draw's and the fixed-k aggregation's kernels."""
import json

import pytest
import torch

from gnnbench.harness import check, counts, registry
from gnnbench.harness.profile import Profile
from gnnbench.harness.record import Record

from conftest import BENCH, CHECKOUT

CELL = "sage-2l-256.reddit-full"
BENCHMARK = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
EDGES = torch.tensor([[2, 2, 3, 4, 5, 0, 1],
                      [0, 0, 3, 1, 2, 5, 4]])
N, F, C = 6, 4, 3


def test_the_configuration_and_its_cell_load_by_name():
    cfg = registry.load_json("configs", "sage-2l-256")
    assert cfg["model"] == "sage" and cfg["fanouts"] == [25, 10] and cfg["units"] == 256
    assert cfg["precision"]["tf32"] is False and cfg["draw_seed"] == 0
    cell = registry.load_json("workloads", CELL)
    assert (cell["config"], cell["traffic"]) == ("sage-2l-256", "reddit-full")
    assert set(cell["limits"]) == set(check.NUMBERS)
    for kind in ("models", "reference", "counts"):
        registry.load_module(kind, "sage")
    entry = registry.cell_entry(BENCHMARK, CELL)
    assert entry["chips"] == 1
    config = next(c for c in BENCHMARK["configs"] if c["name"] == "sage-2l-256")
    assert config["reduced"] == [] and config["file"] == "gnnbench/configs/sage-2l-256.json"


@pytest.mark.parametrize("name", ["sampling_ms", "fixed_k_ms", "fixed_k_roofline"])
def test_the_cells_own_metrics_load_and_apply_to_it_alone(name):
    registry.load_module("metrics", name)
    entry = next(m for m in BENCHMARK["per_layer"] if m["name"] == name)
    assert entry["workloads"] == [CELL] and entry["moves"] == "step_ms"
    assert (BENCH / "metrics" / f"{name}.py").is_file()


def test_the_cell_reports_the_whole_step_metrics():
    traced = {m["name"] for m in registry.cell_metrics(BENCHMARK, CELL, True)}
    assert traced == {"host_enqueue_ms", "launches_per_step", "dense_ms", "step_mfu",
                      "idle_share", "sampling_ms", "fixed_k_ms", "fixed_k_roofline"}
    timed = {m["name"] for m in registry.cell_metrics(BENCHMARK, CELL, False)}
    assert timed == {"step_ms", "step_p95_ms", "setup_s"}


def test_sage_counts_by_hand():
    cfg = {"units": 8, "fanouts": [3, 2], "precision": {"aggregation": "float32"}}
    ops = {o["name"]: o for o in registry.load_module("counts", "sage").step_ops(
        cfg, counts.graph_stats(EDGES, N), F, C)}
    # layer 0: F = 4 into halves of 4 (the gather at 4); layer 1: 8 into 4
    assert ops["draw0"]["bytes"] == 16 * 3 * 6 + 8 * 6 and ops["draw0"]["flops"] == 0
    assert ops["draw1"]["bytes"] == 16 * 2 * 6 + 8 * 6
    assert ops["gather0"]["flops"] == 2 * 3 * 6 * 4
    assert ops["gather0"]["bytes"] == 2 * 6 * 4 * 4 + 8 * 3 * 6
    assert ops["gather0_dsrc"] == dict(ops["gather0"], name="gather0_dsrc")
    assert ops["gather1"]["bytes"] == 2 * 6 * 4 * 4 + 8 * 2 * 6
    assert ops["h_ws0"]["flops"] == 2 * 6 * 4 * 4
    assert ops["h_wn1"]["bytes"] == 4 * (6 * 8 + 8 * 4 + 6 * 4)
    assert ops["d_wn1"]["bytes"] == 4 * (8 * 6 + 6 * 4 + 8 * 4)
    assert ops["d_hs1"]["flops"] == 2 * 6 * 4 * 8
    assert "d_hs0" not in ops  # the features need no gradient
    assert ops["h_wd"]["flops"] == 2 * 6 * 8 * 3 and ops["d_hd"]["flops"] == 2 * 6 * 3 * 8
    # self and neighbour kernels 4x4 twice and 8x4 twice, the head 8x3; no bias
    assert ops["adam"]["bytes"] == 28 * (2 * 16 + 2 * 32 + 24)
    assert ops["cross_entropy"]["bytes"] == 4 * 2 * 6 * 3 + 8 * 6
    assert len(ops) == 21
    assert {o["kind"] for o in ops.values()} == {"sampling", "fixed_k", "dense", "loss",
                                                "optimizer"}


def test_the_gather_is_at_the_input_width_where_the_kernel_widens():
    cfg = {"units": 16, "fanouts": [2], "precision": {"aggregation": "float32"}}
    ops = {o["name"]: o for o in registry.load_module("counts", "sage").step_ops(
        cfg, counts.graph_stats(EDGES, N), F, C)}
    assert ops["gather0"]["flops"] == 2 * 2 * 6 * F


RANDINT = ("void at::native::(anonymous namespace)::distribution_elementwise_grid_stride_kernel"
           "<unsigned int, 4, at::native::templates::cuda::random_from_to_kernel"
           "<at::CUDAGeneratorImpl*>(at::TensorIteratorBase&, unsigned long, long, "
           "at::CUDAGeneratorImpl*)::{lambda()#1}::operator()() const>(long, "
           "at::PhiloxCudaState)")
UNIFORM = ("void at::native::(anonymous namespace)::distribution_elementwise_grid_stride_kernel"
           "<float, 4, at::native::templates::cuda::uniform_kernel<at::CUDAGeneratorImpl*>"
           "(at::TensorIteratorBase&, double, double, at::CUDAGeneratorImpl*)>(long)")
FIXED_K = ["void (anonymous namespace)::fixed_k_gather_kernel<float, 4>(float const*, int)",
           "void (anonymous namespace)::fixed_k_radix_count_kernel(SortIn, long long, int)",
           "void (anonymous namespace)::fixed_k_radix_scatter_kernel(SortIn, long long, int)",
           "(anonymous namespace)::fixed_k_scan_tile_sum_kernel(int const*, int, int*)",
           "(anonymous namespace)::fixed_k_scan_tile_offset_kernel(int*, int)",
           "(anonymous namespace)::fixed_k_scan_apply_kernel(int*, int, int const*)",
           "(anonymous namespace)::fixed_k_tile_ptr_kernel(int const*, long long, int)",
           "void (anonymous namespace)::fixed_k_tile_kernel<float, 4>(float const*, int)"]


def test_the_readers_pick_out_the_draw_and_the_fixed_k_kernels():
    """Two steps of a made-up trace, 10 µs an operation: the draw's two
    kernels, the aggregation's eight, a keep mask's ``torch.rand`` and a GEMM."""
    names = ["void (anonymous namespace)::fixed_k_draw_kernel(int const*, int const*)", RANDINT]
    names += FIXED_K + [UNIFORM, "sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize128x128x8"]
    ops = [(n, 20.0 * i + 1000.0 * step, 10.0) for step in range(2)
           for i, n in enumerate(names)]
    rec = Record()
    rec.profile = Profile(ops, [], {}, [None] * len(ops), steps=2)
    rec.cfg = registry.load_json("configs", "sage-2l-256")
    assert rec.read("sampling_ms") == pytest.approx(0.02)
    assert rec.read("fixed_k_ms") == pytest.approx(0.08)
    assert rec.read("fixed_k_roofline") is None  # no graph counts yet
    rec.stats, rec.num_features, rec.num_classes = counts.graph_stats(EDGES, N), F, C
    least = counts.least_seconds([o for o in rec.work() if o["kind"] == "fixed_k"])
    assert rec.read("fixed_k_roofline") == pytest.approx(100 * least * 1e3 / 0.08)
    assert rec.read("dense_ms") == pytest.approx(0.01)
