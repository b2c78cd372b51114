"""The port's segment core against the JAX package's, on the CPU.

Inputs come from numpy with a seed and go through both. Tolerance: both sides
compute in float32 with the same formulas; only the order of summation
differs, so rtol = atol = 1e-6 (a few float32 ulps at these magnitudes).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_geometric_tpu import _segment_core as jseg
from tf_geometric_tpu_torch import _segment_core as tseg

TOL = dict(rtol=1e-6, atol=1e-6)
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "golden_reference",
                       "segment_ops.npz")


def _inputs(seed, n_items=60, num_segments=9, width=None):
    rng = np.random.default_rng(seed)
    shape = (n_items,) if width is None else (n_items, width)
    data = rng.normal(size=shape).astype(np.float32) * 3.0
    # ids: in range, plus padding sentinels (== num_segments) and negatives;
    # segments 2 and 5 stay empty
    ids = rng.integers(0, num_segments, n_items)
    ids[np.isin(ids, (2, 5))] = 0
    ids[rng.random(n_items) < 0.15] = num_segments
    ids[rng.random(n_items) < 0.05] = -1
    return data, ids.astype(np.int32), num_segments


OPS = ["segment_sum", "segment_mean", "segment_max", "segment_min",
       "segment_softmax"]


@pytest.mark.parametrize("width", [None, 4])
@pytest.mark.parametrize("op", OPS)
def test_segment_op_matches_jax(op, width):
    data, ids, n = _inputs(1, width=width)
    want = np.asarray(getattr(jseg, op)(jnp.asarray(data), jnp.asarray(ids), n))
    got = getattr(tseg, op)(torch.as_tensor(data), torch.as_tensor(ids), n).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    if op in ("segment_max", "segment_min", "segment_mean", "segment_sum"):
        # empty segments read exactly 0 on both sides
        assert np.all(got[[2, 5]] == 0.0)
    if op == "segment_softmax":
        # out-of-range entries are hard zeros, not finite garbage
        oob = (ids < 0) | (ids >= n)
        assert np.all(got[oob] == 0.0)


def test_segment_count_and_normalize_match_jax():
    data, ids, n = _inputs(2)
    data = np.abs(data)
    weights = np.random.default_rng(3).uniform(0.5, 2.0, ids.shape).astype(np.float32)
    for w in (None, weights):
        want = jseg.segment_count(jnp.asarray(ids), n,
                                  None if w is None else jnp.asarray(w))
        got = tseg.segment_count(torch.as_tensor(ids), n,
                                 None if w is None else torch.as_tensor(w))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want = jseg.segment_normalize(jnp.asarray(data), jnp.asarray(ids), n)
    got = tseg.segment_normalize(torch.as_tensor(data), torch.as_tensor(ids), n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_segment_softmax_eps_and_single_member():
    """eps=1e-8 in the denominator: a one-member segment gives 1/(1+1e-8),
    and a custom eps moves both sides alike."""
    data = np.array([[50.0], [-3.0], [1.0], [1.0]], np.float32)
    ids = np.array([0, 1, 1, 3], np.int32)
    for eps in (1e-8, 0.5):
        want = np.asarray(jseg.segment_softmax(jnp.asarray(data), jnp.asarray(ids), 3,
                                               eps=eps))
        got = tseg.segment_softmax(torch.as_tensor(data), torch.as_tensor(ids), 3,
                                   eps=eps).numpy()
        np.testing.assert_allclose(got, want, **TOL)
    assert got[3, 0] == 0.0  # id 3 is out of range for 3 segments


def test_segment_softmax_grad_matches_jax():
    data, ids, n = _inputs(4, width=3)
    w = np.random.default_rng(5).normal(size=data.shape).astype(np.float32)
    g_jax = jax.grad(lambda d: jnp.sum(jseg.segment_softmax(d, jnp.asarray(ids), n)
                                       * jnp.asarray(w)))(jnp.asarray(data))
    d = torch.tensor(data, requires_grad=True)
    (tseg.segment_softmax(d, torch.as_tensor(ids), n) * torch.as_tensor(w)).sum().backward()
    np.testing.assert_allclose(d.grad.numpy(), np.asarray(g_jax), rtol=1e-5, atol=1e-6)


def test_segment_op_with_pad_zero_fills():
    data, ids, n = _inputs(6, width=2)
    want = jseg.segment_op_with_pad(jax.ops.segment_max, jnp.asarray(data),
                                    jnp.asarray(ids), n)
    got = tseg.segment_op_with_pad(tseg.segment_max, torch.as_tensor(data),
                                   torch.as_tensor(ids), n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_segment_golden_reference():
    """The executed TF reference's segment_ops golden (the JAX package's
    parity case uses rtol 1e-4, atol 1e-5)."""
    d = np.load(FIXTURE)
    data, seg = torch.as_tensor(d["in_data"]), torch.as_tensor(d["in_seg"])
    np.testing.assert_allclose(tseg.segment_softmax(data, seg, 8).numpy(),
                               d["out_softmax"], rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(tseg.segment_count(seg, 8).numpy().astype(np.int32),
                                  d["out_count"])
    np.testing.assert_allclose(
        tseg.segment_op_with_pad(tseg.segment_max, data, seg, 8).numpy(),
        d["out_pad_max"], rtol=1e-4, atol=1e-5)


def test_nn_kernel_reexports():
    from tf_geometric_tpu_torch.nn.kernel import segment
    for name in segment.__all__:
        assert getattr(segment, name) is getattr(tseg, name)
