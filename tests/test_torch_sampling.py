"""The port's device sampler (``nn/sampling/device_sampler.py``, the numpy
CSR build in ``native.py`` and the draw's plain version in
``ops/fixed_k.py``) against the JAX package's ``DeviceNeighborSampler`` and
``draw_fixed_k``, on the CPU.

The two frameworks draw different random integers from their generators,
so the JAX draw runs with ``jax.random.randint`` replaced by a function that
returns fixed numpy-seeded integers, and the port's draw takes the same
integers: the draws must then be equal exactly (the draw is integer
arithmetic and gathers, nothing is rounded).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import example, given, settings
from hypothesis import strategies as st

from tf_geometric_tpu.nn.sampling.device_sampler import \
    DeviceNeighborSampler as JaxSampler
from tf_geometric_tpu_torch.nn import DeviceNeighborSampler, draw_fixed_k
from tf_geometric_tpu_torch.ops.fixed_k import (draw_fixed_k_from_ints, draw_fixed_k_plain,
                                                reciprocal_remainder, row_divisor)

jds = importlib.import_module("tf_geometric_tpu.nn.sampling.device_sampler")
tds = importlib.import_module("tf_geometric_tpu_torch.nn.sampling.device_sampler")
INT32_MAX = np.iinfo(np.int32).max


def _graph(rng, n=30, e=200, isolated=0, strays=0):
    """Random edges over n nodes; the last ``isolated`` nodes get no
    in-edges; ``strays`` edges get out-of-range rows (padding ids = n and
    negatives)."""
    ei = np.stack([rng.integers(0, n - isolated, e), rng.integers(0, n, e)]).astype(np.int32)
    if strays:
        ei[0, rng.choice(e, strays, replace=False)] = rng.choice([n, n, -1], strays)
    ew = rng.uniform(0.5, 1.5, e).astype(np.float32)
    return ei, ew


def _ints(seed, k, n):
    return np.random.default_rng(seed).integers(0, INT32_MAX, (k, n)).astype(np.int32)


def _jax_draw(monkeypatch, csr, k, r, self_ids=None):
    """JAX's ``draw_fixed_k`` with ``jax.random.randint`` returning ``r``."""
    def fixed_randint(key, shape, minval, maxval, dtype=jnp.int32):
        assert tuple(shape) == r.shape and minval == 0 and maxval == INT32_MAX
        return jnp.asarray(r, dtype)

    monkeypatch.setattr(jax.random, "randint", fixed_randint)
    idx, w = jds.draw_fixed_k(jax.random.PRNGKey(0), csr, k, self_ids=self_ids)
    return np.asarray(idx), np.asarray(w)


def _torch_csr(jax_sampler):
    csr = jax_sampler.csr_pytree()
    return {k: None if v is None else torch.as_tensor(np.array(v)) for k, v in csr.items()}


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("isolated", [0, 4])
@pytest.mark.parametrize("with_self_ids", [False, True])
def test_draw_equals_jax_under_the_same_integers(monkeypatch, weighted, isolated,
                                                 with_self_ids):
    rng = np.random.default_rng(10 * weighted + isolated + with_self_ids)
    n, k = 30, 7
    ei, ew = _graph(rng, n=n, isolated=isolated)
    jsampler = JaxSampler(ei, ew if weighted else None, num_nodes=n)
    self_ids = (rng.permutation(1000)[:n] + 5000).astype(np.int32) if with_self_ids else None
    r = _ints(isolated + 3 * weighted, k, n)
    want_idx, want_w = _jax_draw(monkeypatch, jsampler.csr_pytree(), k, r,
                                 None if self_ids is None else jnp.asarray(self_ids))
    csr = _torch_csr(jsampler)
    sid = None if self_ids is None else torch.as_tensor(self_ids)
    for got_idx, got_w in (
            draw_fixed_k_plain(torch.as_tensor(r), csr["row_start"], csr["degree"],
                               csr["sorted_col"], csr["sorted_weight"], sid),
            draw_fixed_k_from_ints(torch.as_tensor(r), csr, sid)):
        assert got_idx.dtype == torch.int32 and got_w.dtype == torch.float32
        np.testing.assert_array_equal(got_idx.numpy(), want_idx)
        np.testing.assert_array_equal(got_w.numpy(), want_w)
    if isolated:
        assert (want_w[:, n - isolated:] == 0).all()


def test_public_draw_takes_its_integers_from_the_generator(monkeypatch):
    """``draw_fixed_k`` and ``DeviceNeighborSampler.sample`` draw their
    integers through ``_random_ints`` (torch.randint); fed JAX's integers
    they give JAX's draw."""
    rng = np.random.default_rng(5)
    n, k = 25, 6
    ei, ew = _graph(rng, n=n, isolated=3)
    jsampler = JaxSampler(ei, ew, num_nodes=n)
    r = _ints(9, k, n)
    want = _jax_draw(monkeypatch, jsampler.csr_pytree(), k, r)
    seen = []

    def fixed_ints(generator, kk, num_rows, device):
        seen.append((kk, num_rows))
        return torch.as_tensor(r)

    monkeypatch.setattr(tds, "_random_ints", fixed_ints)
    sampler = DeviceNeighborSampler(ei, ew, num_nodes=n, device="cpu")
    for idx, w in (draw_fixed_k(None, sampler.csr(), k), sampler.sample(None, k)):
        np.testing.assert_array_equal(idx.numpy(), want[0])
        np.testing.assert_array_equal(w.numpy(), want[1])
    assert seen == [(k, n), (k, n)]


@pytest.mark.parametrize("strays", [0, 9])
@pytest.mark.parametrize("weighted", [False, True])
def test_csr_build_matches_jax(strays, weighted):
    rng = np.random.default_rng(100 + strays)
    n = 40
    ei, ew = _graph(rng, n=n, e=300, isolated=5, strays=strays)
    jsampler = JaxSampler(ei, ew if weighted else None, num_nodes=n)
    sampler = DeviceNeighborSampler(ei, ew if weighted else None, num_nodes=n, device="cpu")
    want, got = jsampler.csr_pytree(), sampler.csr()
    for key in ("row_start", "degree", "sorted_col"):
        assert got[key].dtype == torch.int32
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    if weighted:
        np.testing.assert_array_equal(got["sorted_weight"].numpy(),
                                      np.asarray(want["sorted_weight"]))
    else:
        assert got["sorted_weight"] is None and want["sorted_weight"] is None
    in_range = (ei[0] >= 0) & (ei[0] < n)
    assert int(got["degree"].sum()) == int(in_range.sum())


def test_draws_are_real_neighbors():
    rng = np.random.default_rng(0)
    ei, ew = _graph(rng, isolated=3)
    sampler = DeviceNeighborSampler(ei, ew, device="cpu")
    gen = torch.Generator().manual_seed(0)
    idx, w = sampler.sample(gen, k=7)
    idx, w = idx.numpy(), w.numpy()
    assert idx.shape == (7, 30) and w.shape == (7, 30)
    weights_of = {}
    for r, c, wt in zip(ei[0], ei[1], ew):
        weights_of.setdefault((r, c), set()).add(np.float32(wt))
    for node in range(30):
        nbrs = set(ei[1][ei[0] == node])
        for slot in range(7):
            if nbrs:
                assert idx[slot, node] in nbrs
                assert w[slot, node] in weights_of[(node, idx[slot, node])]
            else:
                assert idx[slot, node] == node and w[slot, node] == 0.0


def test_unweighted_skips_weight_table():
    rng = np.random.default_rng(1)
    ei, _ = _graph(rng, isolated=2)
    for weights in (None, np.ones(ei.shape[1], np.float32)):
        sampler = DeviceNeighborSampler(ei, weights, device="cpu")
        assert sampler.sorted_weight is None
        _, w = sampler.sample(torch.Generator().manual_seed(1), k=3)
        deg = np.bincount(ei[0], minlength=30)
        np.testing.assert_array_equal(w.numpy(), np.broadcast_to(
            (deg > 0).astype(np.float32), (3, 30)))


def test_deterministic_under_one_generator_seed():
    rng = np.random.default_rng(2)
    ei, ew = _graph(rng)
    sampler = DeviceNeighborSampler(ei, ew, device="cpu")
    i1, w1 = sampler.sample(torch.Generator().manual_seed(42), k=5)
    i2, w2 = sampler.sample(torch.Generator().manual_seed(42), k=5)
    i3, _ = sampler.sample(torch.Generator().manual_seed(43), k=5)
    assert torch.equal(i1, i2) and torch.equal(w1, w2)
    assert (i1 != i3).any()
    gen = torch.Generator().manual_seed(42)
    first, _ = sampler.sample(gen, k=5)
    second, _ = sampler.sample(gen, k=5)
    assert torch.equal(first, i1) and (second != first).any()


def test_uniformity_over_neighbors():
    """Each neighbour of a node is drawn about uniformly, with replacement."""
    ei = np.array([[0] * 4, [1, 2, 3, 4]], np.int32)
    sampler = DeviceNeighborSampler(ei, num_nodes=5, device="cpu")
    idx, _ = sampler.sample(torch.Generator().manual_seed(0), k=4000)
    counts = np.bincount(idx[:, 0].numpy(), minlength=5)
    freq = counts[1:5] / counts.sum()
    assert counts[0] == 0
    assert (np.abs(freq - 0.25) < 0.03).all()
    # nodes 1-4 have no in-edges: they point at themselves with weight 0
    assert (idx[:, 1:].numpy() == np.arange(1, 5)).all()


def test_empty_graph_draws_self_ids():
    sampler = DeviceNeighborSampler(np.zeros((2, 0), np.int32), num_nodes=3, device="cpu")
    idx, w = sampler.sample(torch.Generator().manual_seed(0), k=2)
    np.testing.assert_array_equal(idx.numpy(), [[0, 1, 2], [0, 1, 2]])
    assert (w.numpy() == 0).all()


# ---------------------------------------------------------------------------
# the draw kernel's per-row reciprocal division (csrc/fixed_k.cu row_divisor,
# remainder_by), through its numpy mirror, against torch.remainder
# ---------------------------------------------------------------------------

INT32_MIN = np.iinfo(np.int32).min
EDGE_DEGREES = (1, 2, 3, 4, 7, 8, 2 ** 16, 2 ** 16 + 1, 2 ** 30, 2 ** 30 + 1, INT32_MAX - 1,
                INT32_MAX)
EDGE_INTS = np.array([INT32_MIN, INT32_MIN + 1, -2 ** 30, -3, -2, -1, 0, 1, 2, 3, 2 ** 30,
                      INT32_MAX - 1, INT32_MAX], np.int32)


def _torch_remainder(r, d):
    return torch.remainder(torch.as_tensor(np.asarray(r, np.int32)),
                           torch.as_tensor(np.asarray(d, np.int32))).numpy()


@given(st.lists(st.integers(INT32_MIN, INT32_MAX), min_size=1, max_size=64),
       st.integers(1, INT32_MAX))
@example([INT32_MIN, -1, 0, INT32_MAX], 1)
@example([INT32_MIN, -1, 0, INT32_MAX], INT32_MAX)
@example([INT32_MIN, INT32_MAX - 1, -2 ** 31 + 1], 2 ** 30)
@settings(max_examples=300, deadline=None)
def test_reciprocal_remainder_matches_torch(ints, degree):
    """Any int32 r (negatives too) over any degree 1 .. 2^31 - 1: the
    kernel's reciprocal gives torch.remainder's result exactly."""
    r = np.array(ints, np.int32)
    np.testing.assert_array_equal(reciprocal_remainder(r, degree), _torch_remainder(r, degree))


@pytest.mark.parametrize("degree", sorted(set(EDGE_DEGREES) | {2 ** p for p in range(2, 31, 4)}))
def test_reciprocal_remainder_at_edge_degrees(degree):
    """1, 2, powers of two and INT32_MAX against the int32 extremes and a
    spread of random integers; the reciprocal fits 32 bits."""
    rng = np.random.default_rng(degree % 1000)
    r = np.concatenate([EDGE_INTS, rng.integers(INT32_MIN, INT32_MAX, 4096, dtype=np.int64,
                                                endpoint=True).astype(np.int32)])
    np.testing.assert_array_equal(reciprocal_remainder(r, degree), _torch_remainder(r, degree))
    m, shift = row_divisor(degree)
    assert 0 < int(m) < 2 ** 32 and 31 <= int(shift) <= 62


def test_reciprocal_draw_equals_the_plain_draw():
    """A draw whose picks use the reciprocal remainder (one divisor per row,
    as the kernel) equals ``draw_fixed_k_plain``'s, isolated rows aside."""
    rng = np.random.default_rng(11)
    ei, _ = _graph(rng, n=40, e=400, isolated=5)
    sampler = JaxSampler(ei, num_nodes=40)
    csr = _torch_csr(sampler)
    r = _ints(12, 25, 40)
    idx, _ = draw_fixed_k_plain(torch.as_tensor(r), csr["row_start"], csr["degree"],
                                csr["sorted_col"])
    deg = csr["degree"].numpy()
    live = deg > 0
    pick = csr["row_start"].numpy()[None, :] + reciprocal_remainder(
        r, np.broadcast_to(np.maximum(deg, 1), r.shape))
    want = csr["sorted_col"].numpy()[np.clip(pick, 0, csr["sorted_col"].shape[0] - 1)]
    np.testing.assert_array_equal(idx.numpy()[:, live], want[:, live])
