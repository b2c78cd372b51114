"""The kernel launches of the demo twins' training steps and evaluations,
counted on the CPU (where each wrapper stands in with its plain version),
are the numbers ``chip_smoke.py``'s phase 21 holds the card to
(``DEMO_STEP_LAUNCHES``, ``DEMO_EVAL_LAUNCHES``). Each twin runs through
``chip_smoke.demo_twin_runner``, the phase's own adapter, on small data:
a synthetic citation graph of 300 nodes for the ``load_cora`` twins, the
twins' own synthetic sets for the rest."""
import contextlib

import numpy as np
import pytest
import torch

import chip_smoke
from tests.test_torch_bench_twins import count_launches
from tf_geometric_tpu_torch import bench
from tf_geometric_tpu_torch.datasets.synthetic_citation import synthetic_citation_graph
from tf_geometric_tpu_torch.ops import fixed_k as fk

SMALL = dict(num_nodes=300, num_features=50, num_classes=4, seed=3)
SPLITS = (np.arange(0, 40), np.arange(40, 100), np.arange(100, 300))


@contextlib.contextmanager
def count_all_launches():
    """``count_launches`` (Kernel A, the H-head SpMM and SDDMM) and the
    fixed-k draw, forward and backward (``fixed_k_backward_launches`` a
    backward call)."""
    names = ("draw_fixed_k_plain", "fixed_k_forward_plain", "fixed_k_backward_plain")
    real = {n: getattr(fk, n) for n in names}
    with count_launches() as counts:
        def draw(*args, **kwargs):
            counts["fixed_k_draw"] += 1
            return real["draw_fixed_k_plain"](*args, **kwargs)

        def forward(*args, **kwargs):
            counts["fixed_k_forward"] += 1
            return real["fixed_k_forward_plain"](*args, **kwargs)

        def backward(dy, idx, w, n, *args, **kwargs):
            counts["fixed_k_backward"] += fk.fixed_k_backward_launches(n)
            return real["fixed_k_backward_plain"](dy, idx, w, n, *args, **kwargs)

        fk.draw_fixed_k_plain, fk.fixed_k_forward_plain = draw, forward
        fk.fixed_k_backward_plain = backward
        try:
            yield counts
        finally:
            for n, f in real.items():
                setattr(fk, n, f)


def _data(name):
    if name in chip_smoke.DEMO_GRAPH_TWINS or name in ("graph_sage", "graph_sage_func",
                                                        "hetero_rgcn"):
        return chip_smoke.demo_twin_data(name, "cpu")
    graph = synthetic_citation_graph(**SMALL)
    if name == "gae":
        return bench.gae_problem(graph.x, graph.edge_index, device="cpu")
    graph.convert_data_to_tensor(device="cpu")
    return graph, tuple(torch.as_tensor(s) for s in SPLITS)


@pytest.mark.parametrize("name", chip_smoke.DEMO_TWINS)
def test_launches_a_step_and_an_evaluation_are_chip_smokes(name, tmp_path, monkeypatch):
    monkeypatch.setenv("TFG_TPU_DATA_ROOT", str(tmp_path))
    step, evaluate = chip_smoke.demo_twin_runner(name, _data(name), "cpu")
    gen = torch.Generator().manual_seed(0)
    step(gen)  # caches and layouts are built on the first call
    with count_all_launches() as counts:
        step(gen)
    assert {k: v for k, v in counts.items() if v} == chip_smoke.DEMO_STEP_LAUNCHES[name]
    with count_all_launches() as counts:
        evaluate()
    assert {k: v for k, v in counts.items() if v} == chip_smoke.DEMO_EVAL_LAUNCHES[name]


@contextlib.contextmanager
def card_gat_dispatch():
    """``gat`` without a cache builds a ``CsrGatLayout`` for the call, as it
    does for CUDA tensors, so the fused attention's passes run here (their
    plain versions) and are counted: ``gat_forward``, ``gat_backward_dst``,
    ``gat_backward_src``."""
    import importlib
    from tf_geometric_tpu_torch.ops import gat_attention as ga
    gat_mod = importlib.import_module("tf_geometric_tpu_torch.nn.conv.gat")
    real_cache, real_plain = gat_mod._gat_edge_cache, ga._PLAIN
    counts = {}

    def edge_cache(edge_index, num_nodes, cache, device="cuda"):
        edges, is_sorted, layout = real_cache(edge_index, num_nodes, cache, device)
        if layout is None:
            layout = ga.CsrGatLayout.build(torch.as_tensor(edges).long(), num_nodes,
                                           device=device)
        return edges, is_sorted, layout

    def counted(name, fn):
        def run(*args, **kwargs):
            counts[name] = counts.get(name, 0) + 1
            return fn(*args, **kwargs)
        return run

    gat_mod._gat_edge_cache = edge_cache
    ga._PLAIN = tuple(counted(n, f) for n, f in zip(
        ("gat_forward", "gat_backward_dst", "gat_backward_src"), real_plain))
    try:
        yield counts
    finally:
        gat_mod._gat_edge_cache, ga._PLAIN = real_cache, real_plain


def _demo2_data(name):
    if name == "model_net_dataset":
        return chip_smoke.demo2_data(name, "cpu")
    from tf_geometric_tpu_torch.nn.conv.gcn import gcn_build_cache_for_graph
    graph = synthetic_citation_graph(**SMALL)
    graph.convert_data_to_tensor(device="cpu")
    if name == "tutorial_intro":
        gcn_build_cache_for_graph(graph, device="cpu")
    return graph, tuple(torch.as_tensor(s) for s in SPLITS)


@pytest.mark.parametrize("name", chip_smoke.DEMO2_TRAINED)
def test_phase_22_launches_a_step_and_an_evaluation(name, tmp_path, monkeypatch):
    """Phase 22's trained twins: a step and an evaluation make
    ``DEMO2_STEP_LAUNCHES`` and ``DEMO2_EVAL_LAUNCHES``."""
    monkeypatch.setenv("TFG_TPU_DATA_ROOT", str(tmp_path))
    step, evaluate = chip_smoke.demo_twin_runner(name, _demo2_data(name), "cpu")
    gen = torch.Generator().manual_seed(0)
    step(gen)
    with count_all_launches() as counts:
        step(gen)
    assert {k: v for k, v in counts.items() if v} == chip_smoke.DEMO2_STEP_LAUNCHES[name]
    with count_all_launches() as counts:
        evaluate()
    assert {k: v for k, v in counts.items() if v} == chip_smoke.DEMO2_EVAL_LAUNCHES[name]


@pytest.mark.parametrize("name", list(chip_smoke.DEMO2_TOUR_LAUNCHES))
def test_phase_22_tour_launches(name, monkeypatch):
    """The tours' API calls make ``DEMO2_TOUR_LAUNCHES`` (the tutorial's
    GCN training replaced by no steps): the GCN's Kernel A forwards and
    one fused GAT forward, no backward."""
    from tf_geometric_tpu_torch.demos import tutorial_intro
    if name == "tutorial_intro":
        graph = synthetic_citation_graph(**SMALL)

        def small_cora(device="cuda"):
            from tf_geometric_tpu_torch.nn.conv.gcn import gcn_build_cache_for_graph
            graph.convert_data_to_tensor(device=device)
            gcn_build_cache_for_graph(graph, device=device)
            return graph, tuple(torch.as_tensor(s) for s in SPLITS)
        monkeypatch.setattr(tutorial_intro, "load_cora", small_cora)
    module = chip_smoke._demo_module(name)
    kwargs = {"num_steps": 0} if name == "tutorial_intro" else {}
    with count_all_launches() as counts, card_gat_dispatch() as gat_counts:
        assert module.main(device="cpu", **kwargs)
    counts.update(gat_counts)
    want = dict(chip_smoke.DEMO2_TOUR_LAUNCHES[name])
    if name == "tutorial_intro":  # the final evaluation
        for k, v in chip_smoke.DEMO2_EVAL_LAUNCHES[name].items():
            want[k] = want.get(k, 0) + v
    assert {k: v for k, v in counts.items() if v} == want


def test_phase_22_parallel_gcn_evaluation_launches():
    """The parallel GCN's evaluation (``SparseMatrix.matmul`` twice, in the
    parent) makes ``DEMO2_EVAL_LAUNCHES["distributed_gcn"]``."""
    from tf_geometric_tpu_torch.demos import demo_distributed_gcn
    graph = synthetic_citation_graph(**SMALL)
    graph.convert_data_to_tensor(device="cpu")
    normed, _, _, _, params = demo_distributed_gcn.problem(graph, 2)
    with count_all_launches() as counts:
        demo_distributed_gcn.evaluate(normed, graph.x, params, "cpu")
    assert {k: v for k, v in counts.items() if v} == chip_smoke.DEMO2_EVAL_LAUNCHES[
        "distributed_gcn"]
