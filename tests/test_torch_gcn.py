"""The port's GCN stack (SparseMatrix, COO spmm, gcn_norm_adj, the cache,
compile_and_dropout, precompute_propagated_features, gcn, the GCN layer)
against the JAX package and the executed reference's goldens, on the CPU.

Tolerances: same float32 formulas on both sides, summed in another order:
rtol = atol = 1e-5. The goldens use test_reference_parity.py's own
tolerances (rtol 1e-4, atol 1e-5).
"""
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_geometric_tpu.layers.conv.gcn import GCN as FlaxGCN
from tf_geometric_tpu.ops.ell_bucketed import BucketedEllAdj
from tf_geometric_tpu.sparse import SparseMatrix as JSparse
from tf_geometric_tpu_torch.convert import gcn_state_dict_from_flax
from tf_geometric_tpu_torch.layers import GCN as TorchGCN
from tf_geometric_tpu_torch.ops.csr_spmm import CsrAdj
from tf_geometric_tpu_torch.ops.spmm import sddmm, spmm
from tf_geometric_tpu_torch.sparse import SparseMatrix as TSparse
from tf_geometric_tpu_torch.sparse import concat as tconcat
from tf_geometric_tpu.sparse import concat as jconcat

# the packages' nn.conv re-export the function ``gcn`` over the module's name
jgcn = importlib.import_module("tf_geometric_tpu.nn.conv.gcn")
tgcn = importlib.import_module("tf_geometric_tpu_torch.nn.conv.gcn")

TOL = dict(rtol=1e-5, atol=1e-5)
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "fixtures", "golden_reference")
KEY = tgcn.compute_cache_key("both", True, True, True, False)

# golden name -> (norm, add_self_loop, sym, renorm, improved, splits), as in
# tests/test_reference_parity.py
GOLDENS = {
    "gcn_both_sl_renorm": ("both", True, True, True, False, None),
    "gcn_both_sl_norenorm": ("both", True, True, False, False, None),
    "gcn_both_sl_renorm_improved": ("both", True, True, True, True, None),
    "gcn_both_nosl": ("both", False, True, True, False, None),
    "gcn_both_asym": ("both", True, False, True, False, None),
    "gcn_left_sl": ("left", True, False, True, False, None),
    "gcn_left_nosl": ("left", False, False, True, False, None),
    "gcn_right_sl": ("right", True, False, True, False, None),
    "gcn_right_nosl": ("right", False, False, True, False, None),
    "gcn_split_matmul": ("both", True, True, True, False, [2, 3]),
}


def _graph(seed, n=25, e=90, f=6):
    rng = np.random.default_rng(seed)
    ei = rng.integers(0, n - 3, size=(2, e)).astype(np.int32)  # last 3 nodes isolated
    ew = rng.uniform(0.5, 1.5, e).astype(np.float32)
    x = rng.normal(size=(n, f)).astype(np.float32)
    return x, ei, ew, rng


def _t(n, ei, ew):
    return TSparse(ei, ew, (n, n), device="cpu")


def _j(n, ei, ew):
    return JSparse(ei, ew, (n, n))


@pytest.mark.parametrize("cfg", sorted(set(c[:5] for c in GOLDENS.values())))
def test_gcn_norm_adj_index_and_value(cfg):
    x, ei, ew, _ = _graph(0)
    n = x.shape[0]
    want = jgcn.gcn_norm_adj(_j(n, ei, ew), *cfg)
    got = tgcn.gcn_norm_adj(_t(n, ei, ew), *cfg)
    np.testing.assert_array_equal(got.index.numpy(), np.asarray(want.index))
    np.testing.assert_allclose(got.value.numpy(), np.asarray(want.value), **TOL)
    assert got.shape == want.shape


def test_cache_rebuild_drops_derived_entries():
    x, ei, ew, _ = _graph(1)
    n = x.shape[0]
    cache = tgcn.gcn_build_cache_by_adj(_t(n, ei, ew))
    assert tgcn.maybe_compile_ell(tgcn.gcn_norm_adj(_t(n, ei, ew), cache=cache),
                                  cache, KEY) is cache[KEY + ":ell"]
    tgcn.precompute_propagated_features(torch.as_tensor(x), _t(n, ei, ew), cache=cache)
    assert isinstance(cache[KEY + ":ell"], CsrAdj) and KEY + ":propagated" in cache
    ew2 = ew * 2.0 + 1.0
    tgcn.gcn_build_cache_by_adj(_t(n, ei, ew2), override=True, cache=cache)
    assert KEY + ":ell" not in cache and KEY + ":propagated" not in cache
    want = jgcn.gcn_norm_adj(_j(n, ei, ew2))
    np.testing.assert_allclose(cache[KEY][1].numpy(), np.asarray(want.value), **TOL)
    # without override the cached entry is served as is
    tgcn.gcn_build_cache_by_adj(_t(n, ei, ew), cache=cache)
    np.testing.assert_allclose(cache[KEY][1].numpy(), np.asarray(want.value), **TOL)


def test_precompute_propagated_features():
    x, ei, ew, _ = _graph(2)
    n = x.shape[0]
    jcache, tcache = {}, {}
    want = jgcn.precompute_propagated_features(jnp.asarray(x), _j(n, ei, ew), cache=jcache)
    got = tgcn.precompute_propagated_features(torch.as_tensor(x), _t(n, ei, ew),
                                              cache=tcache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert tcache[KEY + ":propagated"] is got
    again = tgcn.precompute_propagated_features(torch.as_tensor(x * 0), _t(n, ei, ew),
                                                cache=tcache)
    assert again is got


@pytest.mark.parametrize("with_cache", [True, False])
def test_compile_and_dropout_with_jax_keep_mask(with_cache):
    """The keep mask is drawn by jax.random.bernoulli and handed to the port."""
    x, ei, ew, rng = _graph(3)
    n = x.shape[0]
    rate = 0.4
    key = jax.random.PRNGKey(11)
    jnormed = jgcn.gcn_norm_adj(_j(n, ei, ew))
    tnormed = tgcn.gcn_norm_adj(_t(n, ei, ew))
    keep = np.array(jax.random.bernoulli(key, 1.0 - rate, jnormed.value.shape))
    jadj = jgcn.compile_and_dropout(jnormed, {} if with_cache else None, KEY, rate, key, True)
    tadj = tgcn.compile_and_dropout(tnormed, {} if with_cache else None, KEY, rate, True,
                                    keep_mask=torch.as_tensor(keep))
    assert isinstance(jadj, BucketedEllAdj) == with_cache
    assert isinstance(tadj, CsrAdj) == with_cache
    h = rng.normal(size=(n, 4)).astype(np.float32)
    np.testing.assert_allclose(tadj.matmul(torch.as_tensor(h)).numpy(),
                               np.asarray(jadj.matmul(jnp.asarray(h))), **TOL)
    with pytest.raises(ValueError):
        tgcn.compile_and_dropout(tnormed, {}, KEY, rate, True)
    # inference: no dropout, just the compiled twin
    assert isinstance(tgcn.compile_and_dropout(tnormed, {}, KEY, rate, False), CsrAdj)


def test_generator_dropout_is_reproducible():
    x, ei, ew, _ = _graph(4)
    n = x.shape[0]
    normed = tgcn.gcn_norm_adj(_t(n, ei, ew))
    outs = []
    for _ in range(2):
        adj = tgcn.compile_and_dropout(normed, {}, KEY, 0.5, True,
                                       generator=torch.Generator().manual_seed(3))
        outs.append(adj.matmul(torch.as_tensor(x)))
    assert torch.equal(outs[0], outs[1])
    assert not torch.allclose(outs[0], normed.matmul(torch.as_tensor(x)))


@pytest.mark.parametrize("with_cache", [False, True])
@pytest.mark.parametrize("name", sorted(GOLDENS))
def test_gcn_golden_reference(name, with_cache):
    """The executed TF reference's gcn goldens, through the COO path (no
    cache) and the cached CSR path."""
    d = np.load(os.path.join(GOLDEN_DIR, name + ".npz"))
    norm, add_self_loop, sym, renorm, improved, splits = GOLDENS[name]
    n = d["in_x"].shape[0]
    out = tgcn.gcn(torch.as_tensor(d["in_x"]), _t(n, d["in_ei"], d["in_ew"]),
                   torch.as_tensor(d["in_w"]), torch.as_tensor(d["in_b"]),
                   activation=torch.relu, norm=norm, add_self_loop=add_self_loop,
                   sym=sym, renorm=renorm, improved=improved,
                   num_or_size_splits=splits, cache={} if with_cache else None)
    np.testing.assert_allclose(out.numpy(), d["out_out"], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("with_cache", [False, True])
def test_gcn_layer_with_flax_weights(with_cache):
    x, ei, ew, _ = _graph(5)
    layer = FlaxGCN(units=7, activation=jax.nn.relu)
    variables = layer.init(jax.random.PRNGKey(0), [jnp.asarray(x), jnp.asarray(ei),
                                                   jnp.asarray(ew)])
    want = layer.apply(variables, [jnp.asarray(x), jnp.asarray(ei), jnp.asarray(ew)],
                       cache={} if with_cache else None)
    tlayer = TorchGCN(x.shape[1], 7, activation=torch.relu, device="cpu")
    tlayer.load_state_dict(gcn_state_dict_from_flax(variables))
    got = tlayer([torch.as_tensor(x), torch.as_tensor(ei), torch.as_tensor(ew)],
                 cache={} if with_cache else None)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_gcn_layer_init_and_gradients():
    x, ei, ew, _ = _graph(6)
    gen = torch.Generator().manual_seed(0)
    layer = TorchGCN(6, 9, generator=gen, device="cpu")
    limit = np.sqrt(6.0 / (6 + 9))
    k = layer.kernel.detach().numpy()
    assert k.shape == (6, 9) and np.abs(k).max() <= limit and np.abs(k).max() > limit / 2
    assert torch.equal(layer.bias, torch.zeros(9))
    again = TorchGCN(6, 9, generator=torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(again.kernel, layer.kernel)
    cache = {}
    layer.build_cache_by_adj(_t(x.shape[0], ei, ew), cache=cache)
    layer([torch.as_tensor(x), _t(x.shape[0], ei, ew)], cache=cache).sum().backward()
    assert layer.kernel.grad is not None and layer.bias.grad is not None
    assert KEY + ":ell" in cache
    dropping = TorchGCN(6, 9, edge_drop_rate=0.5, device="cpu")
    with pytest.raises(ValueError):
        dropping([torch.as_tensor(x), torch.as_tensor(ei)], cache={})
    dropping.eval()
    dropping([torch.as_tensor(x), torch.as_tensor(ei)], cache={})


def test_graph_container_and_cache_for_graph():
    from tf_geometric_tpu.data.graph import Graph as JGraph
    from tf_geometric_tpu_torch.data import Graph as TGraph
    x, ei, _, _ = _graph(9)
    jg, tg = JGraph(x=x, edge_index=ei), TGraph(x=x, edge_index=ei)
    assert (tg.num_nodes, tg.num_edges, tg.num_features) == \
        (jg.num_nodes, jg.num_edges, jg.num_features)
    np.testing.assert_array_equal(tg.edge_weight, np.ones(ei.shape[1], np.float32))
    assert TGraph(edge_index=ei).num_nodes == int(ei.max()) + 1
    np.testing.assert_allclose(tg.adj(device="cpu").to_dense().numpy(),
                               np.asarray(jg.adj().to_dense()), **TOL)
    tgcn.gcn_build_cache_for_graph(tg, device="cpu")
    jgcn.gcn_build_cache_for_graph(jg)
    np.testing.assert_allclose(tg.cache[KEY][1].numpy(), np.asarray(jg.cache[KEY][1]), **TOL)
    tg.convert_data_to_tensor(device="cpu")
    assert all(isinstance(getattr(tg, f), torch.Tensor)
               for f in ("x", "edge_index", "edge_weight"))
    assert tg.y is None and tg.num_nodes == x.shape[0]


def test_coo_spmm_grads_match_jax():
    """ops/spmm.py: dh = Aᵀ·dy and dv by SDDMM, with padded edges' dv zeroed."""
    from tf_geometric_tpu.ops import spmm as jspmm
    x, ei, ew, rng = _graph(7)
    n = x.shape[0]
    ei = ei.copy()
    ei[0, :4] = n  # padded edges
    ct = rng.normal(size=(n, x.shape[1])).astype(np.float32)
    want, vjp = jax.vjp(lambda v, h: jspmm.spmm(jnp.asarray(ei), v, h, n),
                        jnp.asarray(ew), jnp.asarray(x))
    want_dv, want_dh = vjp(jnp.asarray(ct))
    tv = torch.tensor(ew, requires_grad=True)
    th = torch.tensor(x, requires_grad=True)
    got = spmm(torch.as_tensor(ei).long(), tv, th, n)
    got_dv, got_dh = torch.autograd.grad(got, (tv, th), torch.as_tensor(ct))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got_dh.numpy(), np.asarray(want_dh), **TOL)
    np.testing.assert_allclose(got_dv.numpy(), np.asarray(want_dv), **TOL)
    assert np.all(got_dv.numpy()[:4] == 0.0)
    np.testing.assert_allclose(
        sddmm(torch.as_tensor(ei), torch.as_tensor(x), torch.as_tensor(ct)).numpy(),
        np.asarray(jspmm.sddmm(jnp.asarray(ei), jnp.asarray(x), jnp.asarray(ct))), **TOL)
    meta = torch.as_tensor(x).to("meta")
    with pytest.raises(NotImplementedError, match="kernel"):
        spmm(torch.as_tensor(ei).long().to("meta"), tv.to("meta"), meta, n)


def test_sparse_matrix_surface_matches_jax():
    x, ei, ew, rng = _graph(8, n=12, e=30)
    n = x.shape[0]
    ei = ei.copy()
    ei[0, 0] = n  # a padded entry stays out of range everywhere
    ta, ja = _t(n, ei, ew), _j(n, ei, ew)
    np.testing.assert_allclose(ta.to_dense().numpy(), np.asarray(ja.to_dense()), **TOL)
    np.testing.assert_allclose(ta.transpose().to_dense().numpy(),
                               np.asarray(ja.transpose().to_dense()), **TOL)
    d_t, d_j = ta.add_diag(0.5), ja.add_diag(0.5)
    np.testing.assert_array_equal(d_t.index.numpy(), np.asarray(d_j.index))
    np.testing.assert_allclose(d_t.value.numpy(), np.asarray(d_j.value), **TOL)
    for axis in (-1, 0):
        for op in ("segment_sum", "segment_max", "segment_mean"):
            np.testing.assert_allclose(getattr(ta, op)(axis).numpy(),
                                       np.asarray(getattr(ja, op)(axis)), **TOL)
    np.testing.assert_allclose(ta.segment_softmax().value.numpy(),
                               np.asarray(ja.segment_softmax().value), **TOL)
    b_ei = rng.integers(0, 5, size=(2, 8)).astype(np.int32)
    b_t, b_j = TSparse(b_ei, None, (5, 7), device="cpu"), JSparse(b_ei, None, (5, 7))
    for axis in (0, 1):
        c_t, c_j = tconcat([ta, b_t], axis=axis), jconcat([ja, b_j], axis=axis)
        assert c_t.shape == c_j.shape
        np.testing.assert_array_equal(c_t.index.numpy(), np.asarray(c_j.index))
        np.testing.assert_allclose(c_t.to_dense().numpy(), np.asarray(c_j.to_dense()), **TOL)
    keep = np.array(jax.random.bernoulli(jax.random.PRNGKey(2), 0.7, (ei.shape[1],)))
    np.testing.assert_allclose(
        ta.dropout(0.3, keep_mask=torch.as_tensor(keep)).value.numpy(),
        np.asarray(ja.dropout(0.3, key=jax.random.PRNGKey(2)).value), **TOL)
    with pytest.raises(ValueError):
        ta.dropout(0.3)
    np.testing.assert_allclose(
        ta.matmul(torch.as_tensor(x), num_or_size_splits=[2, 4]).numpy(),
        np.asarray(ja.matmul(jnp.asarray(x), num_or_size_splits=[2, 4])), **TOL)
