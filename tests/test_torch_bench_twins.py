"""The five early-stop bench twins
(``tf_geometric_tpu_torch/benchmarks/node_classification``) against the JAX
scripts (``benchmarks/node_classification/bench_node_cls_early_stop_*.py``)
on the CPU.

- Protocol: each twin's constants equal the JAX script's module constants
  under each ``BENCH_DATASET`` (the JAX script is loaded anew per dataset).
- Runs: each twin's ``run`` against the JAX script's ``run`` on hard cora
  (and the GAT on hard pubmed, its other architecture), both capped at 5
  steps (``TFG_DEMO_SMOKE_STEPS``), from the same weights (the flax init
  carried across by ``convert``) and JAX's own dropout masks (recorded from
  its ``jax.random.bernoulli`` calls inside the jitted step and handed to
  the port, the attention masks permuted into the cached layout's edge
  order): each step's loss within rtol 1e-4 / atol 1e-6, and the same
  test@best.
- Launches: the kernel calls a training step and an evaluation make, counted
  on the CPU through the plain versions the wrappers stand in for, are the
  numbers ``chip_smoke.py`` holds the card to (``H2H_STEP_LAUNCHES``).
"""
import collections
import contextlib
import importlib.util
import os
import sys

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from tf_geometric_tpu_torch import convert
from tf_geometric_tpu_torch.benchmarks.node_classification import (
    bench_node_cls_early_stop_appnp, bench_node_cls_early_stop_gat,
    bench_node_cls_early_stop_gcn, bench_node_cls_early_stop_sgc,
    bench_node_cls_early_stop_ssgc, early_stop)
from tf_geometric_tpu_torch.utils.graph_utils import add_self_loop_edge

REPO = os.path.join(os.path.dirname(__file__), "..")
JAX_DIR = os.path.join(REPO, "benchmarks", "node_classification")
sys.path.insert(0, os.path.join(REPO, "demo"))

MODELS = ("gcn", "gat", "sgc", "ssgc", "appnp")
TWINS = {"gcn": bench_node_cls_early_stop_gcn, "gat": bench_node_cls_early_stop_gat,
         "sgc": bench_node_cls_early_stop_sgc, "ssgc": bench_node_cls_early_stop_ssgc,
         "appnp": bench_node_cls_early_stop_appnp}
DATASETS = ("cora", "citeseer", "pubmed", "arxiv")
STEPS = 5
LOSS_TOL = dict(rtol=1e-4, atol=1e-6)


def _load_jax_script(model, monkeypatch, dataset):
    """The JAX script loaded anew with ``BENCH_DATASET=dataset`` (it reads
    its constants at import)."""
    monkeypatch.setenv("BENCH_DATASET", dataset)
    path = os.path.join(JAX_DIR, f"bench_node_cls_early_stop_{model}.py")
    spec = importlib.util.spec_from_file_location(f"_jax_bench_{model}_{dataset}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _jax_protocol(model, module):
    """The JAX script's constants under the twin's ``protocol`` names."""
    if model == "gcn":  # L2 5e-4 is inline in the JAX script's run
        return dict(max_steps=module.MAX_STEPS, eval_every=module.EVAL_EVERY,
                    hidden=module.HIDDEN, l2=5e-4)
    if model == "sgc":
        return dict(max_steps=module.MAX_STEPS, eval_every=module.EVAL_EVERY, l2=module.L2)
    # the other scripts evaluate every step (train_node_classifier's default)
    if model == "gat":
        return dict(max_steps=module.MAX_STEPS, eval_every=1, drop=module.DROP, l2=module.L2,
                    single_head_encoder=module.DATASET == "pubmed")
    return dict(max_steps=module.MAX_STEPS, eval_every=1, l2=module.L2)


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    for var in ("TFG_HARD_PROTOCOL", "TFG_HARD_SEED", "BENCH_DATASET", "TFG_DEMO_SMOKE_STEPS",
                "TFG_ADAM_EPS", "TFG_HARD_MODEL", "TFG_RESULTS_PATH"):
        monkeypatch.delenv(var, raising=False)


@pytest.mark.parametrize("dataset", DATASETS)
@pytest.mark.parametrize("model", MODELS)
def test_protocol_constants_match_the_jax_script(model, dataset, monkeypatch):
    module = _load_jax_script(model, monkeypatch, dataset)
    assert module.PATIENCE == early_stop.PATIENCE
    assert TWINS[model].protocol(dataset) == _jax_protocol(model, module)
    # the default reads BENCH_DATASET, as the JAX script does
    assert TWINS[model].protocol() == _jax_protocol(model, module)


def _jax_source(model):
    with open(os.path.join(JAX_DIR, f"bench_node_cls_early_stop_{model}.py"),
              encoding="utf-8") as f:
        return f.read()


@pytest.mark.parametrize("model,lr", [("gcn", "1e-2"), ("sgc", "0.2"), ("ssgc", "5e-3"),
                                      ("appnp", "5e-3"), ("gat", "5e-3")])
def test_inline_constants_match_the_jax_script(model, lr):
    """The constants the JAX scripts write inline: the learning rate, and
    the propagation models' widths, hops and rates."""
    src = _jax_source(model)
    assert f"learning_rate={lr}" in src
    assert ("eval_every=EVAL_EVERY" in src) == (model in ("gcn", "sgc"))
    if model == "gcn":
        assert "l2_coef=5e-4" in src
    assert TWINS[model].LEARNING_RATE == float(lr)
    if model in ("appnp", "ssgc"):
        app = bench_node_cls_early_stop_appnp
        assert "units_list=[64, self.num_classes], k=10, alpha=0.1" in src
        assert "dense_drop_rate=0.5, edge_drop_rate=0.5" in src
        assert (app.UNITS, app.K, app.ALPHA, app.DROP_RATE) == (64, 10, 0.1, 0.5)
    if model == "sgc":
        assert "SGC(units=self.num_classes, k=2)" in src and TWINS[model].K == 2


# ---------------------------------------------------------------------------
# runs against runs, from the same weights and masks
# ---------------------------------------------------------------------------

class _Recorder:
    """``jax.random.bernoulli`` and ``jax.value_and_grad`` that record, in
    call order, the masks drawn and the losses computed inside the jitted
    training step (through ordered debug callbacks)."""

    def __init__(self):
        self.bernoulli = jax.random.bernoulli
        self.value_and_grad = jax.value_and_grad
        self.masks, self.losses = [], []

    def draw(self, key, p=0.5, shape=None):
        mask = self.bernoulli(key, p, shape)
        jax.debug.callback(lambda m: self.masks.append(np.array(m)), mask, ordered=True)
        return mask

    def grad(self, fn, *args, **kwargs):
        inner = self.value_and_grad(fn, *args, **kwargs)

        def run(*a, **k):
            loss, grads = inner(*a, **k)
            jax.debug.callback(lambda v: self.losses.append(float(v)), loss, ordered=True)
            return loss, grads
        return run


def _flax_params(module, model, graph):
    """The JAX script's initial params, as its ``run(seed=0)`` draws them."""
    import jax.numpy as jnp
    c = int(np.max(np.asarray(graph.y))) + 1
    key = jax.random.PRNGKey(0)
    cls = getattr(module, {"gcn": "GCNModel", "gat": "GATModel", "sgc": "SGCModel",
                           "ssgc": "SSGCModel", "appnp": "APPNPModel"}[model])
    return cls(num_classes=c).init({"params": key, "dropout": key}, graph.x,
                                     jnp.asarray(graph.edge_index),
                                     jnp.asarray(graph.edge_weight))


def _port_masks(model, masks_per_step, graph, drop):
    """JAX's recorded masks, step by step, in the port model's format."""
    n = graph.x.shape[0]
    order = None
    if model == "gat":
        ei_sl, _ = add_self_loop_edge(np.asarray(graph.edge_index), n)
        order = np.argsort(np.asarray(ei_sl)[0], kind="stable")

    def att(m):
        return torch.as_tensor(m.astype(np.float32)[order] / (1.0 - drop))

    out = []
    for ms in masks_per_step:
        t = [torch.as_tensor(m) for m in ms]
        if model == "gat" and ms:
            out.append((t[0], att(ms[1]), t[2], att(ms[3])))
        else:  # gcn (x, h), appnp (edge, dense), ssgc (x, edge, dense), none
            out.append(tuple(t) or None)
    return out


# masks a training step draws on the JAX side, per model (off pubmed)
JAX_MASKS = {"gcn": 2, "gat": 4, "sgc": 0, "ssgc": 3, "appnp": 2}


@pytest.mark.parametrize("model,dataset", [(m, "cora") for m in MODELS] + [("gat", "pubmed")])
def test_run_matches_the_jax_script(model, dataset, monkeypatch):
    monkeypatch.setenv("TFG_HARD_PROTOCOL", "1")
    monkeypatch.setenv("TFG_HARD_SEED", "0")
    monkeypatch.setenv("TFG_HARD_MODEL", model)
    monkeypatch.setenv("TFG_DEMO_SMOKE_STEPS", str(STEPS))
    jmod = _load_jax_script(model, monkeypatch, dataset)
    import demo_utils as jdemo_utils
    jgraph, _ = jdemo_utils.load_cora()
    variables = _flax_params(jmod, model, jgraph)

    rec = _Recorder()
    with monkeypatch.context() as m:
        m.setattr(jax.random, "bernoulli", rec.draw)
        m.setattr(jax, "value_and_grad", rec.grad)
        want = jmod.run(0)
    assert len(rec.losses) == STEPS
    per_step = 0 if (model, dataset) == ("gat", "pubmed") else JAX_MASKS[model]
    assert len(rec.masks) == per_step * STEPS
    masks = [rec.masks[i * per_step:(i + 1) * per_step] for i in range(STEPS)]

    twin = TWINS[model]
    data = early_stop.load_data(dataset, device="cpu")
    drop = twin.protocol(dataset).get("drop", 0.0)
    state = convert.gcn_state_dict_from_flax(variables)
    stats = {}
    got = twin.run(0, device="cpu", dataset=dataset, data=data, state_dict=state,
                   keep_masks=_port_masks(model, masks, jgraph, drop), stats=stats)
    np.testing.assert_allclose(torch.stack(stats["losses"]).numpy(), rec.losses, **LOSS_TOL)
    assert got == pytest.approx(float(want), abs=1e-6)


# ---------------------------------------------------------------------------
# kernel launches, counted on the CPU
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def count_launches():
    """The kernel launches the card would make, counted on the CPU where
    the wrappers run their plain versions: one Kernel A launch per
    ``side_matmul``, ``spmm_heads_launches`` per H-head SpMM and one per
    SDDMM on a view with rows (the wrappers' own rules)."""
    from tf_geometric_tpu_torch.ops import csr_spmm, spmm_heads
    counts = collections.Counter()
    side, spmm, sddmm = (csr_spmm.side_matmul, spmm_heads.spmm_heads_plain,
                         spmm_heads.sddmm_heads_plain)

    def counted_side(s, h, diag):
        counts["csr_spmm"] += 1
        return side(s, h, diag)

    def counted_spmm(view, *args, **kwargs):
        if view.row_ptr.shape[0] > 1:
            counts["spmm_heads"] += spmm_heads.spmm_heads_launches(view.nbr.shape[0])
        return spmm(view, *args, **kwargs)

    def counted_sddmm(view, *args, **kwargs):
        if view.row_ptr.shape[0] > 1:
            counts["sddmm_heads"] += 1
        return sddmm(view, *args, **kwargs)

    csr_spmm.side_matmul = counted_side
    spmm_heads.spmm_heads_plain, spmm_heads.sddmm_heads_plain = counted_spmm, counted_sddmm
    try:
        yield counts
    finally:
        csr_spmm.side_matmul = side
        spmm_heads.spmm_heads_plain, spmm_heads.sddmm_heads_plain = spmm, sddmm


@pytest.mark.parametrize("model,dataset", [(m, "cora") for m in MODELS] + [("gat", "pubmed")])
def test_launches_a_step_are_chip_smokes(model, dataset):
    """A training step and an evaluation of each twin make the launches
    chip_smoke.py's phase 20 holds the card to."""
    from tf_geometric_tpu_torch.benchmarks.node_classification import head_to_head_port
    from tf_geometric_tpu_torch.demos.demo_utils import train_step
    twin = TWINS[model]
    graph, splits = head_to_head_port.cell_data(model, dataset, "cpu")
    net, forward = twin.build(graph, 0, dataset, "cpu")
    opt = torch.optim.Adam(net.parameters(), lr=twin.LEARNING_RATE)
    gen = torch.Generator().manual_seed(0)
    with count_launches() as step:
        train_step(net, opt, lambda training, g: forward(training, g), graph.y.long(),
                   splits[0], twin.protocol(dataset)["l2"], gen)
    net.eval()
    with count_launches() as evaluation, torch.no_grad():
        forward(False, None)
    assert dict(step) == chip_smoke.H2H_STEP_LAUNCHES[model]
    assert dict(evaluation) == chip_smoke.H2H_EVAL_LAUNCHES[model]


def test_evaluations_counted_as_the_loop_runs_them(monkeypatch):
    """``chip_smoke._h2h_evaluations`` against the loop's own evaluations
    (the arxiv protocol evaluates every 2 steps, and logs every 20)."""
    from tf_geometric_tpu_torch.demos import demo_utils
    calls = []
    w, y = torch.randn(30, 3), torch.randint(0, 3, (30,))
    module = torch.nn.Linear(3, 3)
    splits = (torch.arange(10), torch.arange(10, 20), torch.arange(20, 30))

    def forward(training, generator):
        if not training:
            calls.append(1)
        return module(w)

    for steps, every in ((45, 2), (7, 1), (41, 2)):
        calls.clear()
        stats = {}
        demo_utils.train_node_classifier(forward, module, y, splits, num_steps=steps,
                                         patience=1000, eval_every=every, stats=stats)
        assert len(calls) == chip_smoke._h2h_evaluations(stats["steps"], every)
