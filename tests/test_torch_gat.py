"""The port's GAT stack (``utils/graph_utils.py``'s edge transforms,
``nn.conv.gat``, ``layers.GAT``, ``convert.gat_state_dict_from_flax``)
against the JAX package and the executed reference's goldens, on the CPU.

Tolerances: float32 formulas summed in another order, rtol = atol = 1e-4
(the fused path recomputes nothing here, but its softmax takes its max and
sum in another order than the segment path's); the goldens use
test_reference_parity.py's own tolerances (rtol 2e-4, atol 1e-5).
"""
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_geometric_tpu.layers.conv.gat import GAT as FlaxGAT
from tf_geometric_tpu.utils import graph_utils as jgu
from tf_geometric_tpu_torch.convert import gat_state_dict_from_flax
from tf_geometric_tpu_torch.layers import GAT as TorchGAT
from tf_geometric_tpu_torch.ops.gat_attention import CsrGatLayout
from tf_geometric_tpu_torch.utils import graph_utils as tgu

jgat = importlib.import_module("tf_geometric_tpu.nn.conv.gat")
tgat = importlib.import_module("tf_geometric_tpu_torch.nn.conv.gat")

TOL = dict(rtol=1e-4, atol=1e-4)
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "fixtures", "golden_reference")
# golden name -> (num_heads, split_value_heads), as in test_reference_parity.py
GOLDENS = {"gat_h1": (1, True), "gat_h2_split": (2, True), "gat_h2_mean": (2, False)}


def _inputs(seed, num_heads, split, equal_widths=True, n=18, e=50, f=8, units=8):
    rng = np.random.default_rng(seed)
    ei = rng.integers(0, n, size=(2, e)).astype(np.int32)
    x = rng.normal(size=(n, f)).astype(np.float32)
    v_units = units if split else units * num_heads
    q_units = v_units if equal_widths else 2 * num_heads
    w = {"wq": rng.normal(size=(f, q_units)), "bq": rng.normal(size=q_units) * 0.1,
         "wk": rng.normal(size=(f, q_units)), "bk": rng.normal(size=q_units) * 0.1,
         "wv": rng.normal(size=(f, v_units)), "b": rng.normal(size=units) * 0.1}
    return x, ei, {k: v.astype(np.float32) for k, v in w.items()}


def _jax_gat(x, ei, w, num_heads, split, cache):
    n = x.shape[0]
    if cache is not None:
        jgat._gat_edge_cache(jnp.asarray(ei), n, cache)  # concrete build before jit

    @jax.jit
    def run(x_, w_):
        return jgat.gat(x_, jnp.asarray(ei), w_["wq"], w_["bq"], jax.nn.relu,
                        w_["wk"], w_["bk"], jax.nn.relu, w_["wv"], bias=w_["b"],
                        activation=jax.nn.relu, num_heads=num_heads,
                        split_value_heads=split, num_nodes=n, cache=cache)

    return np.asarray(run(jnp.asarray(x), {k: jnp.asarray(v) for k, v in w.items()}))


def _port_gat(x, ei, w, num_heads, split, cache, **kwargs):
    t = {k: torch.as_tensor(v) for k, v in w.items()}
    ei = None if ei is None else torch.as_tensor(ei)
    return tgat.gat(torch.as_tensor(x), ei, t["wq"], t["bq"], torch.relu,
                    t["wk"], t["bk"], torch.relu, t["wv"], bias=t["b"], activation=torch.relu,
                    num_heads=num_heads, split_value_heads=split, cache=cache, **kwargs)


@pytest.mark.parametrize("with_cache", [False, True])
@pytest.mark.parametrize("num_heads,split", [(1, True), (2, True), (2, False), (8, True),
                                             (8, False)])
def test_gat_matches_jax(num_heads, split, with_cache):
    x, ei, w = _inputs(num_heads * 10 + split, num_heads, split)
    want = _jax_gat(x, ei, w, num_heads, split, {} if with_cache else None)
    cache = {} if with_cache else None
    got = _port_gat(x, ei, w, num_heads, split, cache)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    if with_cache:
        sorted_ei, is_sorted, layout = cache[f"gat_edges_{x.shape[0]}"]
        assert is_sorted and isinstance(layout, CsrGatLayout)
        assert sorted_ei.shape[1] == ei.shape[1] + x.shape[0]
        assert np.all(np.diff(sorted_ei[0].numpy()) >= 0)
        # the cached layout and list also work passed in explicitly
        again = _port_gat(x, None, w, num_heads, split, None, ell_layout=layout,
                          sorted_edge_index=sorted_ei)
        np.testing.assert_allclose(again.numpy(), got.numpy(), rtol=0, atol=0)


@pytest.mark.parametrize("with_cache", [False, True])
def test_gat_unequal_head_widths_on_cpu(with_cache):
    x, ei, w = _inputs(3, 2, True, equal_widths=False)
    want = _jax_gat(x, ei, w, 2, True, {} if with_cache else None)
    got = _port_gat(x, ei, w, 2, True, {} if with_cache else None)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("with_cache", [False, True])
@pytest.mark.parametrize("name", sorted(GOLDENS))
def test_gat_golden_reference(name, with_cache):
    d = np.load(os.path.join(GOLDEN_DIR, name + ".npz"))
    num_heads, split = GOLDENS[name]
    w = {k: d["in_" + k] for k in ("wq", "bq", "wk", "bk", "wv", "b")}
    got = _port_gat(d["in_x"], d["in_ei"], w, num_heads, split, {} if with_cache else None)
    np.testing.assert_allclose(got.numpy(), d["out_out"], rtol=2e-4, atol=1e-5)


def test_gat_contract():
    x, ei, w = _inputs(4, 2, True)
    with pytest.raises(ValueError, match="together"):
        _port_gat(x, ei, w, 2, True, None, ell_layout=CsrGatLayout.build(ei, 18, device="cpu"))
    with pytest.raises(ValueError, match="generator"):
        _port_gat(x, ei, w, 2, True, {}, edge_drop_rate=0.5, training=True)
    for cache in (None, {}):  # dropout through the segment path and the fused path
        got = _port_gat(x, ei, w, 2, True, cache, edge_drop_rate=0.5, training=True,
                        generator=torch.Generator().manual_seed(0))
        assert got.shape == (18, 8) and torch.isfinite(got).all()


@pytest.mark.parametrize("split", [True, False])
def test_gat_layer_with_flax_weights(split):
    rng = np.random.default_rng(11)
    n, f = 18, 8
    x = rng.normal(size=(n, f)).astype(np.float32)
    ei = rng.integers(0, n, size=(2, 50)).astype(np.int32)
    layer = FlaxGAT(units=8, attention_units=8 if split else 16, num_heads=2,
                    split_value_heads=split, activation=jax.nn.relu)
    variables = layer.init(jax.random.PRNGKey(0), [jnp.asarray(x), jnp.asarray(ei)])
    for with_cache in (False, True):
        want = layer.apply(variables, [jnp.asarray(x), jnp.asarray(ei)],
                           cache={} if with_cache else None)
        tlayer = TorchGAT(f, 8, attention_units=8 if split else 16, num_heads=2,
                          split_value_heads=split, activation=torch.relu, device="cpu")
        tlayer.load_state_dict(gat_state_dict_from_flax(variables))
        got = tlayer([torch.as_tensor(x), torch.as_tensor(ei)],
                     cache={} if with_cache else None)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_gat_layer_init_and_gradients():
    gen = torch.Generator().manual_seed(0)
    layer = TorchGAT(6, 8, num_heads=2, split_value_heads=False, generator=gen,
                     edge_drop_rate=0.3, device="cpu")
    shapes = {k: tuple(v.shape) for k, v in layer.state_dict().items()}
    assert shapes == {"query_kernel": (6, 8), "query_bias": (8,), "key_kernel": (6, 8),
                      "key_bias": (8,), "kernel": (6, 16), "bias": (8,)}
    limit = np.sqrt(6.0 / (6 + 16))
    k = layer.kernel.detach().numpy()
    assert np.abs(k).max() <= limit and np.abs(k).max() > limit / 2
    assert all(torch.equal(getattr(layer, b), torch.zeros(8))
               for b in ("query_bias", "key_bias", "bias"))
    again = TorchGAT(6, 8, num_heads=2, split_value_heads=False, device="cpu",
                     generator=torch.Generator().manual_seed(0))
    assert torch.equal(again.query_kernel, layer.query_kernel)
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.normal(size=(10, 6)).astype(np.float32))
    ei = torch.as_tensor(rng.integers(0, 10, size=(2, 30)))
    with pytest.raises(ValueError):
        layer([x, ei], cache={})  # training with dropout needs a generator or mask
    layer([x, ei], cache={}, generator=torch.Generator().manual_seed(1)).sum().backward()
    assert all(p.grad is not None for p in layer.parameters())
    layer.eval()
    assert layer([x, ei]).shape == (10, 8)


def test_edge_transforms_match_jax():
    rng = np.random.default_rng(5)
    ei = rng.integers(0, 9, size=(2, 40)).astype(np.int32)
    ew = rng.uniform(0.5, 1.5, 40).astype(np.float32)
    feat = rng.normal(size=(40, 3)).astype(np.float32)
    for weight in (None, ew):
        want = jgu.add_self_loop_edge(jnp.asarray(ei), 9, weight, fill_weight=2.0)
        for edge_index in (ei, torch.as_tensor(ei)):
            got = tgu.add_self_loop_edge(edge_index, 9, weight, fill_weight=2.0)
            assert type(got[0]) is type(edge_index)
            np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))
            np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want[1]))
        got = tgu.remove_self_loop_edge(ei, weight)
        want = jgu.remove_self_loop_edge(ei, weight)
        np.testing.assert_array_equal(got[0], want[0])
        if weight is not None:
            np.testing.assert_array_equal(got[1], want[1])
    for modes in (None, "sum", ["mean", "max"], ["min", "first"]):
        props = [ew, feat] if modes is None or not isinstance(modes, str) else [ew]
        got = tgu.convert_edge_to_directed(ei, props, modes)
        want = jgu.convert_edge_to_directed(ei, props, modes)
        np.testing.assert_array_equal(got[0], want[0])
        for g, w_ in zip(got[1], want[1]):
            np.testing.assert_allclose(g, w_, rtol=1e-6)
    got, want = tgu.convert_edge_to_directed(ei), jgu.convert_edge_to_directed(ei)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] is None and want[1] is None


def _check_merged_head_with_layout(x, ei, w, num_heads, dropout):
    """The port's merged-head branch over a layout against the JAX package's
    with a cache: the output and the gradients of x and every weight
    (float32, rtol = atol = 1e-4); under dropout both sides use JAX's mask
    ([H, E] bernoulli from the same key, handed to the port as a scaled
    [E, H] keep mask)."""
    n, rate, key = x.shape[0], 0.3, jax.random.PRNGKey(3)
    cache = {}
    jgat._gat_edge_cache(jnp.asarray(ei), n, cache)
    sorted_ei = np.array(cache[f"gat_edges_{n}"][0])

    def jax_loss(x_, w_):
        out = jgat.gat(x_, jnp.asarray(ei), w_["wq"], w_["bq"], jax.nn.relu, w_["wk"],
                       w_["bk"], jax.nn.relu, w_["wv"], bias=w_["b"], activation=jax.nn.relu,
                       num_heads=num_heads, num_nodes=n, cache=cache, training=dropout,
                       edge_drop_rate=rate if dropout else 0.0,
                       dropout_key=key if dropout else None)
        return jnp.sum(out * jnp.arange(out.size, dtype=jnp.float32).reshape(out.shape) / 100)

    jw = {k: jnp.asarray(v) for k, v in w.items()}
    want, (want_dx, want_dw) = jax.value_and_grad(jax_loss, argnums=(0, 1))(jnp.asarray(x), jw)
    keep = None
    if dropout:
        keep = np.asarray(jax.random.bernoulli(key, 1.0 - rate,
                                               (num_heads, sorted_ei.shape[1]))).T
        keep = torch.as_tensor(keep.astype(np.float32) / (1.0 - rate))
    layout = CsrGatLayout.build(sorted_ei, n, device="cpu")
    tx = torch.tensor(x, requires_grad=True)
    tw = {k: torch.tensor(v, requires_grad=True) for k, v in w.items()}
    out = tgat.gat(tx, None, tw["wq"], tw["bq"], torch.relu, tw["wk"], tw["bk"], torch.relu,
                   tw["wv"], bias=tw["b"], activation=torch.relu, num_heads=num_heads,
                   edge_drop_rate=rate if dropout else 0.0, training=dropout, keep_mask=keep,
                   ell_layout=layout, sorted_edge_index=torch.as_tensor(sorted_ei))
    assert out.shape == (n, w["b"].shape[0])
    loss = (out * torch.arange(out.numel(), dtype=torch.float32).reshape(out.shape) / 100).sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_dx), **TOL)
    for k in w:
        np.testing.assert_allclose(tw[k].grad.numpy(), np.asarray(want_dw[k]), **TOL,
                                   err_msg=k)


@pytest.mark.parametrize("dropout", [False, True])
def test_gat_merged_head_with_layout_matches_jax(dropout):
    """d_q != d_v (2 heads, d_q = 2, d_v = 4) over a layout, with and
    without dropout."""
    _check_merged_head_with_layout(*_inputs(21, 2, True, equal_widths=False), 2, dropout)


def test_gat_merged_head_one_wide_queries_matches_jax():
    """The widths of the repository's GAT with d_q != d_v (8 heads, units 64,
    attention units 8: d_q = 1, d_v = 8; bench workload 5) over a layout."""
    x, ei, w = _inputs(23, 8, True, units=64)
    rng = np.random.default_rng(24)
    w.update({k: rng.normal(size=(x.shape[1], 8)).astype(np.float32) for k in ("wq", "wk")})
    w.update({k: (rng.normal(size=8) * 0.1).astype(np.float32) for k in ("bq", "bk")})
    _check_merged_head_with_layout(x, ei, w, 8, False)
