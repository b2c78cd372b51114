"""The port's native host ops (``tf_geometric_tpu_torch/native``) against the
JAX package's (``tf_geometric_tpu/native``), bit for bit: the fixed-k draw,
label propagation, the partition refinement and the numpy CSR build; the
``partition_order`` / ``community_order`` permutations with both native
libraries on (with both off, ``tests/test_torch_parallel.py``); and the
switches that turn the library off (``TFG_TPU_NATIVE=0``, no library)."""
import numpy as np
import pytest

import tf_geometric_tpu.native as jnative
from tf_geometric_tpu.parallel import partition as jpart
from tf_geometric_tpu_torch import native as tnative
from tf_geometric_tpu_torch.parallel import partition as tpart


@pytest.fixture(scope="module", autouse=True)
def both_libraries():
    assert jnative.available(), "the JAX package's native library did not build"
    assert tnative.available(), "the port's native library did not build"


def _csr(seed, n=600, e=5000, isolated=20, weighted=True):
    """A random graph's CSR (the last ``isolated`` nodes have no edges)."""
    rng = np.random.default_rng(seed)
    row = rng.integers(0, n - isolated, e)
    col = rng.integers(0, n, e)
    order = tnative.sort_by_row(row, n)
    w = rng.random(e).astype(np.float32) if weighted else np.ones(e, np.float32)
    return tnative.build_row_ptr(row, n), col[order].astype(np.int32), w[order], n


def _community_graph(seed, n=2000, communities=30, edges=14000):
    rng = np.random.default_rng(seed)
    comm = rng.integers(0, communities, n)
    src = rng.integers(0, n - 10, edges)
    inside = rng.random(edges) < 0.8
    members = [np.nonzero(comm == c)[0] for c in range(communities)]
    dst = np.where(inside, [rng.choice(members[comm[s]]) for s in src],
                   rng.integers(0, n - 10, edges))
    return np.stack([dst, src]).astype(np.int64), n


@pytest.mark.parametrize("rows_seed,num_rows", [(0, 50), (1, 1), (2, 300)])
def test_csr_build_matches_jax_native(rows_seed, num_rows):
    """Stable row order with strays (negative, and past ``num_rows``) last,
    and the row pointers of the in-range rows."""
    rows = np.random.default_rng(rows_seed).integers(-3, num_rows + 4, 4000)
    np.testing.assert_array_equal(tnative.sort_by_row(rows, num_rows),
                                  jnative.sort_by_row(rows, num_rows))
    np.testing.assert_array_equal(tnative.build_row_ptr(rows, num_rows),
                                  jnative.build_row_ptr(rows, num_rows))


@pytest.mark.parametrize("k,seed,weighted", [(1, 0, True), (7, 2 ** 63 - 5, True),
                                             (25, 12345, False), (10, 1, True)])
def test_sample_fixed_k_matches_jax_native(k, seed, weighted):
    row_ptr, col, w, n = _csr(k, weighted=weighted)
    sources = np.random.default_rng(9).permutation(n)[: n // 2]
    sources = np.concatenate([sources, [n - 1, n - 1]])  # an isolated source, twice
    got = tnative.sample_fixed_k(row_ptr, col, w, sources, k, seed)
    want = jnative.sample_fixed_k(row_ptr, col, w, sources, k, seed)
    for g, wnt in zip(got, want):
        assert g.dtype == wnt.dtype and g.shape == (len(sources), k)
        np.testing.assert_array_equal(g, wnt)
    np.testing.assert_array_equal(got[0][-1], n - 1)  # isolated: itself, weight 0
    np.testing.assert_array_equal(got[1][-1], 0.0)


def test_sample_fixed_k_refuses_a_source_outside_the_csr():
    row_ptr, col, w, n = _csr(0)
    with pytest.raises(ValueError, match="outside"):
        tnative.sample_fixed_k(row_ptr, col, w, np.array([n]), 3, 0)


@pytest.mark.parametrize("seed,num_iters", [(0, 8), (1, 1), (2, 30)])
def test_lpa_labels_match_jax_native(seed, num_iters):
    ei, n = _community_graph(seed)
    order = tnative.sort_by_row(ei[0], n)
    row_ptr, col = tnative.build_row_ptr(ei[0], n), ei[1][order].astype(np.int32)
    np.testing.assert_array_equal(tnative.lpa_labels(row_ptr, col, n, num_iters),
                                  jnative.lpa_labels(row_ptr, col, n, num_iters))


@pytest.mark.parametrize("seed,parts,slack", [(0, 4, 8), (1, 3, 0), (2, 7, 20)])
def test_partition_refine_matches_jax_native(seed, parts, slack):
    ei, n = _community_graph(seed)
    row = np.concatenate([ei[0], ei[1]])
    col = np.concatenate([ei[1], ei[0]])
    order = tnative.sort_by_row(row, n)
    row_ptr, col = tnative.build_row_ptr(row, n), col[order].astype(np.int32)
    caps = np.full(parts, n // parts, np.int64)
    caps[-1] += n - caps.sum()
    part = np.random.default_rng(seed).integers(0, parts, n).astype(np.int32)
    want_part = part.copy()
    moves = tnative.partition_refine(row_ptr, col, part, caps, slack, 8)
    assert moves == jnative.partition_refine(row_ptr, col, want_part, caps, slack, 8)
    np.testing.assert_array_equal(part, want_part)
    np.testing.assert_array_equal(np.bincount(part, minlength=parts), caps)


@pytest.mark.parametrize("seed,parts", [(0, 4), (1, 4), (2, 3)])
def test_partition_orders_match_jax_with_both_libraries(seed, parts):
    ei, n = _community_graph(seed)
    np.testing.assert_array_equal(tpart.partition_order(ei, n, parts),
                                  jpart.partition_order(ei, n, parts))
    np.testing.assert_array_equal(tpart.community_order(ei, n, seed=seed),
                                  jpart.community_order(ei, n, seed=seed))


def test_native_and_numpy_partitions_differ_but_are_both_valid(monkeypatch):
    """The two branches give other permutations (so each is held against the
    JAX package's same branch), both a permutation with exact block sizes."""
    ei, n = _community_graph(0)
    native_perm = tpart.partition_order(ei, n, 4)
    monkeypatch.setattr(tnative, "available", lambda: False)
    numpy_perm = tpart.partition_order(ei, n, 4)
    for perm in (native_perm, numpy_perm):
        np.testing.assert_array_equal(np.sort(perm), np.arange(n))
    assert not np.array_equal(native_perm, numpy_perm)


def test_the_switch_and_a_missing_library_turn_the_native_ops_off(monkeypatch):
    """``TFG_TPU_NATIVE=0`` (read at the first use) and a library that cannot
    be built both leave ``available()`` False and each op returning None,
    as JAX's do; the CSR build stays numpy."""
    row_ptr, col, w, n = _csr(0)
    for setup in ("switch", "no compiler"):
        monkeypatch.setattr(tnative, "_tried", False)
        monkeypatch.setattr(tnative, "_lib", None)
        if setup == "switch":
            monkeypatch.setenv("TFG_TPU_NATIVE", "0")
        else:
            monkeypatch.delenv("TFG_TPU_NATIVE", raising=False)
            monkeypatch.setattr(tnative, "_compile", lambda: None)
        assert not tnative.available()
        assert tnative.sample_fixed_k(row_ptr, col, w, np.arange(n), 3, 0) is None
        assert tnative.lpa_labels(row_ptr, col, n) is None
        assert tnative.partition_refine(row_ptr, col, np.zeros(n, np.int32),
                                        np.array([n]), 8, 2) is None
        assert tnative.build_row_ptr(np.array([0, 2, 2]), 3).tolist() == [0, 1, 1, 3]
