"""The port's GraphSAGE stack (``ops/fixed_k.py``'s aggregation,
``nn/conv/graph_sage.py``, ``nn/kernel/map_reduce.py``,
``layers/conv/graph_sage.py``, ``convert.sage_state_dict_from_flax``)
against the JAX package and the executed reference's goldens, on the CPU.

Tolerances: the fixed-k functions compute the same float32 sums in another
order (the port sums the slots in float32 and JAX in the source dtype):
rtol = atol = 1e-5 for outputs and gradients; with ``compute_dtype``
bfloat16 both sides round the gathered rows to bfloat16 and JAX also its
running sums, so 2e-2 (for gradients, atol 2e-2 of the largest entry).
The goldens use test_reference_parity.py's own tolerances (rtol 1e-4,
atol 1e-5; ``sage_lstm`` rtol 2e-4); the layers 1e-5.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_geometric_tpu import nn as jnn
from tf_geometric_tpu.layers.conv import graph_sage as jlayers
from tf_geometric_tpu_torch import layers as tlayers
from tf_geometric_tpu_torch import nn as tnn
from tf_geometric_tpu_torch.convert import sage_state_dict_from_flax
from tf_geometric_tpu_torch.ops.fixed_k import (fixed_k_aggregate, fixed_k_backward_launches,
                                                fixed_k_backward_plain, fixed_k_forward_plain,
                                                launch_fixed_k_forward)
from tf_geometric_tpu_torch.utils.profiling import counters

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "fixtures", "golden_reference")
F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)


def _draw(rng, k, n, num_src, isolated=3):
    """A slot-major draw: random ids (a few out of range, which both sides
    clip), real weights, weight-0 self-slots on the last rows."""
    idx = rng.integers(-2, num_src + 2, (k, n)).astype(np.int32)
    w = rng.uniform(0.5, 1.5, (k, n)).astype(np.float32)
    w[:, n - isolated:] = 0.0
    idx[:, n - isolated:] = np.arange(n - isolated, n)
    return idx, w


def _fixed_k_case(seed, f_in, units, k=5, n=40):
    rng = np.random.default_rng(seed)
    x = rng.normal(scale=0.5, size=(n, f_in)).astype(np.float32)
    idx, w = _draw(rng, k, n, n)
    sk = rng.normal(scale=0.1, size=(f_in, units)).astype(np.float32)
    nk = rng.normal(scale=0.1, size=(f_in, units)).astype(np.float32)
    b = rng.normal(scale=0.1, size=(2 * units,)).astype(np.float32)
    return x, idx, w, sk, nk, b, rng


@pytest.mark.parametrize("variant", ["mean", "sum"])
@pytest.mark.parametrize("f_in,units", [(16, 6), (5, 7)])  # matmul-first, gather-first
# bfloat16 runs without normalize: the L2 norm of a small row amplifies
# one bf16 rounding past any fixed tolerance
@pytest.mark.parametrize("concat,normalize,bf16", [(True, False, False), (False, True, False),
                                                   (True, False, True), (False, False, True)])
def test_fixed_k_matches_jax(variant, f_in, units, concat, normalize, bf16):
    x, idx, w, sk, nk, b, rng = _fixed_k_case(f_in * 10 + units, f_in, units)
    if not concat:
        b = b[:units]
    jfn = getattr(jnn, f"{variant}_graph_sage_fixed_k")
    tfn = getattr(tnn, f"{variant}_graph_sage_fixed_k")
    out_units = 2 * units if concat else units
    cot = rng.normal(size=(x.shape[0], out_units)).astype(np.float32)
    jdtype, tdtype = (jnp.bfloat16, torch.bfloat16) if bf16 else (None, None)

    def jloss(x_, sk_, nk_):
        out = jfn(x_, jnp.asarray(idx), jnp.asarray(w), sk_, nk_, bias=jnp.asarray(b),
                  activation=jax.nn.relu, concat=concat, normalize=normalize,
                  compute_dtype=jdtype)
        return jnp.sum(out * cot), out

    (_, want), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x), jnp.asarray(sk), jnp.asarray(nk))
    tx, tsk, tnk = (torch.tensor(a, requires_grad=True) for a in (x, sk, nk))
    out = tfn(tx, torch.as_tensor(idx), torch.as_tensor(w), tsk, tnk, bias=torch.as_tensor(b),
              activation=torch.relu, concat=concat, normalize=normalize, compute_dtype=tdtype)
    (out * torch.as_tensor(cot)).sum().backward()
    tol = BF16 if bf16 else F32
    assert out.dtype == torch.float32 and out.shape == want.shape
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **tol)
    for name, t, g in zip(("x", "self_kernel", "neighbor_kernel"), (tx, tsk, tnk), jgrads):
        g = np.asarray(g)
        # in bfloat16 JAX also sums the source gradient in bfloat16 (its
        # scatter-add runs in the compute dtype), so the error scales with
        # the gradient: atol 2e-2 of the largest entry
        atol = tol["atol"] * (np.abs(g).max() if bf16 else 1.0)
        np.testing.assert_allclose(t.grad.numpy(), g, rtol=tol["rtol"], atol=atol, err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,width", [(4, 1), (3, 41), (6, 128)])
def test_fixed_k_aggregate_plain_versions(dtype, k, width):
    """The forward and backward plain versions against a dense product with
    the [S, n] matrix of the draw (ids clipped to [0, n - 1])."""
    rng = np.random.default_rng(k * width)
    n, S = 30, 20
    idx, w = _draw(rng, k, S, n)
    src = torch.as_tensor(rng.normal(size=(n, width)).astype(np.float32)).to(dtype)
    dense = np.zeros((S, n), np.float64)
    np.add.at(dense, (np.tile(np.arange(S), k), np.clip(idx, 0, n - 1).reshape(-1)),
              w.reshape(-1))
    dense = torch.as_tensor(dense.astype(np.float32))
    tol = F32 if dtype == torch.float32 else BF16
    ti, tw = torch.as_tensor(idx), torch.as_tensor(w)
    out = fixed_k_forward_plain(src, ti, tw)
    assert out.dtype == dtype and out.shape == (S, width)
    np.testing.assert_allclose(out.float().numpy(), (dense @ src.float()).numpy(), **tol)
    dy = torch.as_tensor(rng.normal(size=(S, width)).astype(np.float32)).to(dtype)
    d_src = fixed_k_backward_plain(dy, ti, tw, n)
    assert d_src.dtype == torch.float32 and d_src.shape == (n, width)
    np.testing.assert_allclose(d_src.numpy(), (dense.T @ dy.float()).numpy(), **tol)
    # the autograd function: gradient in src's dtype
    leaf = src.clone().requires_grad_(True)
    fixed_k_aggregate(leaf, ti, tw).backward(dy)
    assert leaf.grad.dtype == dtype
    np.testing.assert_allclose(leaf.grad.float().numpy(), d_src.numpy(), **tol)


def test_fixed_k_weights_are_constants():
    """The sampler's weights are not differentiated: a ``w`` that requires
    grad raises instead of silently getting no gradient, and the CUDA
    wrapper refuses CPU tensors."""
    idx = torch.zeros((2, 3), dtype=torch.int32)
    w = torch.ones((2, 3), requires_grad=True)
    src = torch.ones((3, 4))
    with pytest.raises(ValueError, match="weights"):
        fixed_k_aggregate(src, idx, w)
    before = counters()
    with pytest.raises(ValueError, match="CUDA"):
        launch_fixed_k_forward(src, idx, w.detach())
    assert counters() == before


@pytest.mark.parametrize("num_src,launches", [(1, 6), (512, 6), (513, 6), (232_965, 6),
                                              (2 ** 18 + 1, 6)])
def test_fixed_k_backward_launches(num_src, launches):
    """Kernels per backward call: five per radix pass over the source tiles
    (tiles of at most 512 sources, digits of at most 10 bits: one pass up
    to 1,024 tiles, 524,288 sources), the tiles' run starts after several
    passes, then the tile kernel."""
    assert fixed_k_backward_launches(num_src) == launches


# golden name -> (variant, concat, normalize), as in test_reference_parity.py
SAGE_GOLDENS = {
    "sage_mean_concat": ("mean", True, False),
    "sage_mean_add_norm": ("mean", False, True),
    "sage_sum": ("sum", True, False),
    "sage_mean_pool": ("mean_pool", True, False),
    "sage_max_pool": ("max_pool", True, False),
    "sage_gcn": ("gcn", True, True),
}


def _golden(name):
    data = np.load(os.path.join(GOLDEN_DIR, f"{name}.npz"))
    return ({k[3:]: data[k] for k in data.files if k.startswith("in_")},
            {k[4:]: data[k] for k in data.files if k.startswith("out_")})


@pytest.mark.parametrize("name", sorted(SAGE_GOLDENS))
def test_sage_goldens(name):
    variant, concat, normalize = SAGE_GOLDENS[name]
    inp, want = _golden(name)
    t = {k: torch.as_tensor(v) for k, v in inp.items()}
    args = (t["x"], t["ei"], t["ew"])
    common = dict(activation=torch.relu, normalize=normalize)
    if variant == "gcn":
        out = tnn.gcn_graph_sage(*args, t["w_gcn"], bias=None, **common)
    elif variant in ("mean", "sum"):
        fn = tnn.mean_graph_sage if variant == "mean" else tnn.sum_graph_sage
        out = fn(*args, t["w_self"], t["w_neigh"], bias=t["b"], concat=concat, **common)
    else:
        fn = tnn.mean_pool_graph_sage if variant == "mean_pool" else tnn.max_pool_graph_sage
        out = fn(*args, t["w_self"], t["w_mlp"], t["w_pool_neigh"], neighbor_mlp_bias=t["b_mlp"],
                 bias=t["b"], concat=concat, **common)
    np.testing.assert_allclose(out.numpy(), want["out"], rtol=1e-4, atol=1e-5)


def test_sage_lstm_golden():
    """The reference runs a Keras LSTM (gates i, f, c, o: kernel W [F, 4H],
    recurrent kernel U [H, 4H], bias b); ``torch.nn.LSTM`` takes the same
    gates in the same order, transposed."""
    inp, want = _golden("sage_lstm")
    units = inp["U"].shape[0]
    lstm = torch.nn.LSTM(inp["x"].shape[1], units, batch_first=True)
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(torch.as_tensor(inp["W"].T))
        lstm.weight_hh_l0.copy_(torch.as_tensor(inp["U"].T))
        lstm.bias_ih_l0.copy_(torch.as_tensor(inp["b"]))
        lstm.bias_hh_l0.zero_()
        out = tnn.lstm_graph_sage(torch.as_tensor(inp["x"]), torch.as_tensor(inp["ei"]),
                                  lambda seq: lstm(seq)[0], torch.as_tensor(inp["w_self"]),
                                  torch.as_tensor(inp["w_neigh"]), activation=torch.relu)
    np.testing.assert_allclose(out.numpy(), want["out"], rtol=2e-4, atol=1e-5)


def test_lstm_graph_sage_matches_jax_with_a_cut():
    """``max_neighbors`` below the largest in-degree drops the later
    neighbours on both sides; padded (out-of-range) rows are dropped."""
    rng = np.random.default_rng(7)
    n, f = 12, 4
    ei = rng.integers(0, n, (2, 40)).astype(np.int32)
    ei[0, :3] = n
    x = rng.normal(size=(n, f)).astype(np.float32)
    ws, wn = (rng.normal(size=(f, 3)).astype(np.float32) for _ in range(2))
    scale = rng.normal(size=(f,)).astype(np.float32)

    def seq_fn(seq):  # any [N, K, F] -> [N, K, H]; a cumulative mix
        return jnp.cumsum(seq * scale, axis=1) if isinstance(seq, jax.Array) else \
            torch.cumsum(seq * torch.as_tensor(scale), dim=1)

    want = jnn.lstm_graph_sage(jnp.asarray(x), jnp.asarray(ei), seq_fn, jnp.asarray(ws),
                               jnp.asarray(wn), activation=jax.nn.relu, max_neighbors=3)
    got = tnn.lstm_graph_sage(torch.as_tensor(x), torch.as_tensor(ei), seq_fn,
                              torch.as_tensor(ws), torch.as_tensor(wn), activation=torch.relu,
                              max_neighbors=3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_aggregate_neighbors_golden():
    inp, want = _golden("aggregate_neighbors")
    x, ei, ew = (torch.as_tensor(inp[k]) for k in ("x", "ei", "ew"))
    got = {
        "sum_gcn": tnn.aggregate_neighbors(x, ei, ew, tnn.gcn_mapper, tnn.sum_reducer,
                                           tnn.identity_updater),
        "mean_id": tnn.aggregate_neighbors(x, ei, None, tnn.identity_mapper, tnn.mean_reducer,
                                           tnn.sum_updater),
        "max_id": tnn.aggregate_neighbors(x, ei, None, tnn.identity_mapper, tnn.max_reducer,
                                          tnn.identity_updater),
    }
    for key, value in got.items():
        np.testing.assert_allclose(value.numpy(), want[key], rtol=1e-4, atol=1e-5, err_msg=key)


@pytest.mark.parametrize("reducer", ["sum", "mean", "max", "min"])
@pytest.mark.parametrize("mapper", ["identity", "gcn", "count"])
def test_aggregate_neighbors_matches_jax(reducer, mapper):
    """Every mapper × reducer, with padded edges (row = n) dropped."""
    rng = np.random.default_rng(3)
    n = 15
    ei = rng.integers(0, n, (2, 50)).astype(np.int32)
    ei[0, :4] = n
    ew = rng.uniform(0.5, 1.5, 50).astype(np.float32)
    x = rng.normal(size=(n, 5)).astype(np.float32)
    jm = getattr(jnn, f"{'neighbor_count' if mapper == 'count' else mapper}_mapper")
    tm = getattr(tnn, f"{'neighbor_count' if mapper == 'count' else mapper}_mapper")
    want = jnn.aggregate_neighbors(jnp.asarray(x), jnp.asarray(ei), jnp.asarray(ew), jm,
                                   getattr(jnn, f"{reducer}_reducer"), jnn.sum_updater
                                   if mapper == "identity" else jnn.identity_updater)
    got = tnn.aggregate_neighbors(torch.as_tensor(x), torch.as_tensor(ei), torch.as_tensor(ew),
                                  tm, getattr(tnn, f"{reducer}_reducer"), tnn.sum_updater
                                  if mapper == "identity" else tnn.identity_updater)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


LAYERS = {
    "MeanGraphSage": dict(units=8),
    "SumGraphSage": dict(units=6, concat=False),
    "GCNGraphSage": dict(units=5),
    "MeanPoolGraphSage": dict(units=8),
    "MaxPoolGraphSage": dict(units=4, concat=False),
    "LSTMGraphSage": dict(units=8),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layers_match_flax_through_convert(name):
    """Weight names and shapes of the flax layer, and its output once the
    flax weights are loaded through ``sage_state_dict_from_flax``."""
    rng = np.random.default_rng(11)
    n, f = 14, 6
    x = rng.normal(size=(n, f)).astype(np.float32)
    ei = rng.integers(0, n, (2, 40)).astype(np.int32)
    ew = rng.uniform(0.5, 1.5, 40).astype(np.float32)
    inputs = [jnp.asarray(x), jnp.asarray(ei), jnp.asarray(ew)]
    flax_layer = getattr(jlayers, name)(**LAYERS[name])
    variables = flax_layer.init(jax.random.PRNGKey(0), inputs)
    want = np.asarray(flax_layer.apply(variables, inputs))
    layer = getattr(tlayers, name)(f, **LAYERS[name], generator=torch.Generator().manual_seed(0),
                                   device="cpu")
    state = sage_state_dict_from_flax(variables)
    own = layer.state_dict()
    assert sorted(state) == sorted(own)
    for key, value in state.items():
        assert tuple(own[key].shape) == tuple(value.shape), key
    layer.load_state_dict(state)
    got = layer([torch.as_tensor(x), torch.as_tensor(ei), torch.as_tensor(ew)])
    np.testing.assert_allclose(got.detach().numpy(), want, **F32)


def test_layers_refuse_an_odd_concat_width():
    with pytest.raises(ValueError, match="even"):
        tlayers.MeanGraphSage(4, 5, device="cpu")
