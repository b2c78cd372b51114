"""The serialization and sampling demo twins (``tf_geometric_tpu_torch/demos``:
``demo_checkpoint``, ``demo_save_and_load_model``, ``demo_sample_neighbors``)
against the JAX scripts (``demo/``) on the CPU.

The checkpoint twin, on the small synthetic citation graph of
``test_torch_demo_twins_node.py`` (``load_cora`` replaced on both sides)
with ``TFG_DEMO_SMOKE_STEPS=3`` (``half`` = 3): from the script's initial
weights (recorded by ``tests/_jax_demo_capture.py``, carried across by
``convert``), the 2·3 losses and the step-1 gradients within
rtol = atol = 1e-4; the resumed run equal to an uninterrupted one bit for
bit; the weights restored without the Adam state giving another step 4;
and the script's own step-3 orbax checkpoint, its Adam state carried
through ``convert.adam_state_from_optax``, continuing to the script's
losses of steps 4-6 within 1e-4. The save/load twin: the round trip exact,
and the flax init carried across giving the script's logits within 1e-5.
The sampling twin: each sampler call's arrays and every printed line equal
the script's, with the native host library and without it.
"""
import os
import sys
import tempfile

import numpy as np
import pytest
import torch

import tf_geometric_tpu.native as jnative
import tf_geometric_tpu_torch.native as tnative
from tests._jax_demo_capture import record_jax, record_port_adam
from tests.test_torch_demo_twins_node import TOL, _graphs, offline  # noqa: F401
from tf_geometric_tpu_torch import convert
from tf_geometric_tpu_torch.demos import (demo_checkpoint, demo_sample_neighbors,
                                          demo_save_and_load_model, demo_utils)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "demo"))

import demo_checkpoint as jdemo_checkpoint  # noqa: E402
import demo_sample_neighbors as jdemo_sample_neighbors  # noqa: E402
import demo_save_and_load_model as jdemo_save_and_load_model  # noqa: E402

HALF = 3


def _gcn_state(params):
    return convert.gcn_state_dict_from_flax({"params": params})


@pytest.fixture(scope="module")
def checkpoint_run(tmp_path_factory):
    """The JAX script's run (3 + 3 steps) with its checkpoint kept, and the
    twin's from the script's initial weights with its file kept."""
    mp = pytest.MonkeyPatch()
    root = tmp_path_factory.mktemp("checkpoint")
    try:
        mp.setenv("TFG_TPU_DATA_ROOT", str(root))
        mp.setenv("TFG_DEMO_SMOKE_STEPS", str(HALF))
        (jdata, pdata) = _graphs()
        rec = record_jax(mp)
        mp.setattr(jdemo_checkpoint, "load_cora", lambda: jdata)
        mp.setattr(tempfile, "mkdtemp", lambda *a, **k: str(root / "jax"))
        jacc = jdemo_checkpoint.main()
        mp.undo()
        mp.setenv("TFG_DEMO_SMOKE_STEPS", str(HALF))
        init = _gcn_state(rec.init_params[0])
        real_build = demo_checkpoint.build_model

        def build(graph, num_classes, seed=0, device="cuda"):
            model, forward = real_build(graph, num_classes, seed, device)
            if seed == 0:
                model.load_state_dict(init)
            return model, forward

        mp.setattr(demo_checkpoint, "build_model", build)
        mp.setattr(demo_checkpoint, "load_cora", lambda device="cuda": pdata)
        adam = record_port_adam(mp)
        stats = {}
        acc = demo_checkpoint.main(device="cpu", stats=stats, directory=str(root / "port"))
        yield dict(rec=rec, jacc=jacc, acc=acc, stats=stats, adam=adam, init=init, pdata=pdata,
                   root=root, build=build)
    finally:
        mp.undo()


def _train(model, forward, optimizer, graph, splits, steps):
    return [demo_utils.train_step(model, optimizer, forward, graph.y.long(), splits[0],
                                  demo_checkpoint.L2_COEF) for _ in range(steps)]


def test_checkpoint_twin_matches_jax_losses_and_gradients(checkpoint_run):
    run = checkpoint_run
    rec, stats = run["rec"], run["stats"]
    assert len(rec.losses) == 2 * HALF
    np.testing.assert_allclose(torch.stack(stats["losses"]).numpy(), rec.losses, **TOL)
    model, _ = demo_checkpoint.build_model(run["pdata"][0], 4, 0, "cpu")
    want = _gcn_state(rec.grads[0])
    got = dict(zip([k for k, _ in model.named_parameters()], run["adam"].grads))
    assert sorted(got) == sorted(want)
    for k, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), **TOL, err_msg=k)
    assert run["acc"] == pytest.approx(run["jacc"], abs=1.0 / 200 + 1e-6)


def test_checkpoint_resume_equals_uninterrupted_run(checkpoint_run):
    """The resumed run ends on the weights of 2·half uninterrupted steps
    from the same initial weights, bit for bit; restoring the weights
    without the Adam state gives another step 4."""
    run = checkpoint_run
    graph, splits = run["pdata"]
    model, forward = run["build"](graph, 4, 0, "cpu")
    opt = torch.optim.Adam(model.parameters(), lr=demo_checkpoint.LEARNING_RATE)
    losses = _train(model, forward, opt, graph, splits, 2 * HALF)
    assert torch.equal(torch.stack(losses), torch.stack(run["stats"]["losses"]))
    for k, v in model.state_dict().items():
        assert torch.equal(v, run["stats"]["state_dict"][k]), k

    saved = torch.load(run["root"] / "port" / "gcn_ckpt" / f"step_{HALF}.pt", weights_only=True)
    assert saved["step"] == HALF
    fresh, forward = demo_checkpoint.build_model(graph, 4, 1, "cpu")
    fresh.load_state_dict(saved["model"])
    opt = torch.optim.Adam(fresh.parameters(), lr=demo_checkpoint.LEARNING_RATE)
    cold = _train(fresh, forward, opt, graph, splits, 2)
    warm = run["stats"]["losses"][HALF:HALF + 2]
    assert torch.equal(cold[0], warm[0])  # the same weights before step 4
    assert abs(float(cold[1]) - float(warm[1])) > 1e-4  # another update at step 4


def test_jax_orbax_checkpoint_continues_through_adam_state_from_optax(checkpoint_run):
    """The script's step-3 checkpoint (params and optax's Adam state, as
    orbax restores them without a target) loaded into the twin's model and
    a ``torch.optim.Adam``: steps 4-6 give the script's losses."""
    import orbax.checkpoint as ocp
    run = checkpoint_run
    graph, splits = run["pdata"]
    restored = ocp.StandardCheckpointer().restore(
        str(run["root"] / "jax" / "gcn_ckpt" / f"step_{HALF}"))
    assert int(restored["step"]) == HALF
    model, forward = demo_checkpoint.build_model(graph, 4, 1, "cpu")
    model.load_state_dict(_gcn_state(restored["params"]))
    opt = torch.optim.Adam(model.parameters(), lr=demo_checkpoint.LEARNING_RATE)
    state = convert.adam_state_from_optax(restored["opt_state"], model,
                                          demo_checkpoint.LEARNING_RATE)
    opt.load_state_dict(state)
    assert all(float(s["step"]) == HALF for s in opt.state_dict()["state"].values())
    losses = _train(model, forward, opt, graph, splits, HALF)
    np.testing.assert_allclose(torch.stack(losses).numpy(), run["rec"].losses[HALF:], **TOL)


def test_save_and_load_twin_round_trip_and_jax_init(tmp_path, monkeypatch):
    import jax
    (jdata, pdata) = _graphs()
    jgraph, _ = jdata
    monkeypatch.setattr(jdemo_save_and_load_model, "load_cora", lambda: jdata)
    monkeypatch.setattr(tempfile, "mkdtemp", lambda *a, **k: str(tmp_path))
    assert jdemo_save_and_load_model.main() is True
    monkeypatch.undo()
    monkeypatch.setattr(demo_save_and_load_model, "load_cora", lambda device="cuda": pdata)
    stats = {}
    assert demo_save_and_load_model.main(device="cpu", stats=stats) is True
    graph = pdata[0]
    # the twin module's own build_model (the module fixture replaces demo_checkpoint's)
    model, forward = demo_save_and_load_model.build_model(graph, 4, 0, "cpu")
    model.eval()
    with torch.no_grad():
        assert torch.equal(stats["logits"], forward(False))

    jmodel = jdemo_save_and_load_model.GCNModel(num_classes=4)
    args = (jgraph.x, jgraph.edge_index, jgraph.edge_weight)
    params = jmodel.init(jax.random.PRNGKey(0), *args)["params"]
    model.load_state_dict(_gcn_state(params))
    with torch.no_grad():
        np.testing.assert_allclose(forward(False).numpy(),
                                   np.asarray(jmodel.apply({"params": params}, *args)),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("branch", ["native", "numpy"])
def test_sample_neighbors_twin_draws_and_prints_as_jax(branch, monkeypatch, capsys):
    from tf_geometric_tpu.utils import graph_utils as jgu
    if branch == "numpy":
        monkeypatch.setattr(jnative, "available", lambda: False)
        monkeypatch.setattr(tnative, "available", lambda: False)
    else:
        assert jnative.available() and tnative.available()
    draws = []
    for cls in (jgu.RandomNeighborSampler, jgu.UniformNeighborSampler):
        real = cls.sample

        def sample(self, *args, _real=real, **kwargs):
            out = _real(self, *args, **kwargs)
            draws.append(out)
            return out
        monkeypatch.setattr(cls, "sample", sample)
    assert jdemo_sample_neighbors.main() is True
    want_lines = capsys.readouterr().out.splitlines()
    stats = {}
    assert demo_sample_neighbors.main(stats=stats) is True
    assert capsys.readouterr().out.splitlines() == want_lines
    assert len(stats["draws"]) == len(draws) == 5
    for (ei, ew), (jei, jew) in zip(stats["draws"], draws):
        assert ei.dtype == np.asarray(jei).dtype and ew.dtype == np.asarray(jew).dtype
        np.testing.assert_array_equal(ei, np.asarray(jei))
        np.testing.assert_array_equal(ew, np.asarray(jew))


def test_adam_state_from_optax_takes_the_live_state_and_orbax_form(checkpoint_run):
    """optax's own state (``(ScaleByAdamState, EmptyState)``) and orbax's
    restore of it (``[{"count", "mu", "nu"}, None]``) convert alike, each
    parameter's ``step`` optax's ``count``."""
    import jax
    import optax
    model, _ = demo_checkpoint.build_model(checkpoint_run["pdata"][0], 4, 1, "cpu")
    params = {"GCN_0": {"kernel": np.ones((50, 16), np.float32), "bias": np.zeros(16, np.float32)},
              "GCN_1": {"kernel": np.ones((16, 4), np.float32), "bias": np.zeros(4, np.float32)}}
    opt = optax.adam(1e-2)
    state = opt.init(params)
    for scale in (1.0, -0.5):
        _, state = opt.update(jax.tree_util.tree_map(lambda p: p * 0 + scale, params), state,
                              params)
    adam = state[0]
    orbax_form = [{"count": np.asarray(adam.count), "mu": adam.mu, "nu": adam.nu}, None]
    live = convert.adam_state_from_optax(state, model, 1e-2)
    restored = convert.adam_state_from_optax(orbax_form, model, 1e-2)
    assert live["param_groups"] == restored["param_groups"]
    for i, name in enumerate(k for k, _ in model.named_parameters()):
        assert float(live["state"][i]["step"]) == 2.0
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(live["state"][i][key], restored["state"][i][key])
    layer, leaf = name.split(".")
    np.testing.assert_array_equal(live["state"][i]["exp_avg"].numpy(), adam.mu[layer][leaf])
