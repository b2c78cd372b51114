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
