"""The port's sorted segment sum (plain version, as a CPU tensor takes it)
against the JAX Pallas kernel ``sorted_segment_sum_mxu`` in interpret mode.

Tolerance rtol = atol = 1e-4, as tests/test_ell.py holds the Pallas kernel to
a numpy oracle: the MXU path sums a 512-row chunk as a one-hot contraction,
the port row by row, so only the order of float32 summation differs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_geometric_tpu.ops.pallas_segment import CHUNK, sorted_segment_sum_mxu
from tf_geometric_tpu_torch.ops.sorted_segment import (segment_sum_csr,
                                                       sorted_segment_sum,
                                                       sorted_segment_sum_plain)

TOL = dict(rtol=1e-4, atol=1e-4)


def _both(msg, rows, n):
    want = np.asarray(sorted_segment_sum_mxu(jnp.asarray(msg), rows, n, interpret=True))
    got = sorted_segment_sum(torch.as_tensor(msg), torch.as_tensor(rows), n)
    return got.numpy(), want


def test_random_sorted_stream(rng):
    n, e, f = 40, 1200, 16
    rows = np.sort(rng.integers(0, n, e)).astype(np.int32)
    msg = rng.normal(size=(e, f)).astype(np.float32)
    got, want = _both(msg, rows, n)
    np.testing.assert_allclose(got, want, **TOL)


def test_row_spanning_more_than_two_chunks(rng):
    """Row 0 spans three 512-edge chunks of the TPU plan; row 3 a fourth."""
    n, f = 5, 8
    e = 3 * CHUNK + 300
    rows = np.concatenate([np.zeros(2 * CHUNK + 200, np.int32),
                           np.full(e - 2 * CHUNK - 200, 3, np.int32)])
    msg = rng.normal(size=(e, f)).astype(np.float32)
    got, want = _both(msg, rows, n)
    np.testing.assert_allclose(got, want, **TOL)
    assert np.all(got[[1, 2, 4]] == 0.0)


def test_sentinel_rows_are_dropped(rng):
    """Rows equal to num_rows (padding, sorted last) contribute nothing."""
    n, e, f = 12, 300, 5
    rows = np.sort(rng.integers(0, n + 1, e)).astype(np.int32)
    assert (rows == n).sum() > 0
    msg = rng.normal(size=(e, f)).astype(np.float32)
    got, want = _both(msg, rows, n)
    np.testing.assert_allclose(got, want, **TOL)
    expected = np.zeros((n, f), np.float32)
    keep = rows < n
    np.add.at(expected, rows[keep], msg[keep])
    np.testing.assert_allclose(got, expected, **TOL)


def test_accumulate_into_out(rng):
    """With ``out`` given the sums are added into it, in place (the merge of
    hub partials into Kernel A's output)."""
    n, e, f = 9, 200, 3
    rows = np.sort(rng.integers(0, n, e)).astype(np.int32)
    msg = rng.normal(size=(e, f)).astype(np.float32)
    base = rng.normal(size=(n, f)).astype(np.float32)
    out = torch.as_tensor(base.copy())
    seg_ptr = torch.as_tensor(np.searchsorted(rows, np.arange(n + 1)).astype(np.int32))
    res = segment_sum_csr(torch.as_tensor(msg), seg_ptr, out)
    assert res is out
    _, want = _both(msg, rows, n)
    np.testing.assert_allclose(out.numpy(), base + want, **TOL)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_plain_version_contract(rng, out_dtype):
    """The kernel's contract on a segment pointer: float32 sums, empty
    segments 0 (fresh) or untouched (accumulate), result in out's dtype."""
    seg_ptr = torch.tensor([0, 3, 3, 7, 8], dtype=torch.int32)
    msg = torch.as_tensor(rng.normal(size=(8, 6)).astype(np.float32))
    fresh = segment_sum_csr(msg, seg_ptr)
    want = torch.stack([msg[0:3].sum(0), torch.zeros(6), msg[3:7].sum(0), msg[7:8].sum(0)])
    np.testing.assert_allclose(fresh.numpy(), want.numpy(), **TOL)
    base = torch.full((4, 6), 0.5, dtype=out_dtype)
    sorted_segment_sum_plain(msg, seg_ptr, base)
    assert base.dtype == out_dtype
    np.testing.assert_allclose(base.float().numpy(), (want + 0.5).to(out_dtype).float().numpy(),
                               rtol=1e-2 if out_dtype == torch.bfloat16 else 1e-4, atol=1e-4)


def test_segments_written_to_listed_rows(rng):
    """With ``rows``, segment s adds into out[rows[s]] and every other row of
    out is left as it was (the merge of hub partials into their owners)."""
    n, f = 50, 7
    rows = np.sort(rng.integers(0, n, 60)).astype(np.int32)
    msg = rng.normal(size=(rows.size, f)).astype(np.float32)
    owners, counts = np.unique(rows, return_counts=True)
    owner_ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    base = rng.normal(size=(n, f)).astype(np.float32)
    out = torch.as_tensor(base.copy())
    res = segment_sum_csr(torch.as_tensor(msg), torch.as_tensor(owner_ptr), out,
                          torch.as_tensor(owners.astype(np.int32)))
    assert res is out
    _, want = _both(msg, rows, n)
    np.testing.assert_allclose(out.numpy(), base + want, **TOL)
    untouched = np.setdiff1d(np.arange(n), owners)
    assert untouched.size and np.array_equal(out.numpy()[untouched], base[untouched])
