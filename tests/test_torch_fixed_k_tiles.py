"""The host-side planning of the fixed-k aggregation kernels
(``ops/fixed_k.py``: ``backward_plan``, ``serial_walks``,
``fixed_k_backward_launches``) and the kernels' summation orders against
JAX's ``mean_graph_sage_fixed_k`` (its output and its gradient in ``x``),
on the CPU: the forward's slot order is ``fixed_k_forward_plain``'s own,
the backward's is emulated by ``fixed_k_backward_order_plain`` and held
against ``fixed_k_backward_plain`` too.

Tolerances: the emulation sums the same float32 terms in the kernel's
order (source tiles cut into chunks, hub sources into 64-slot segments),
the plain versions slot by slot and JAX in its own order: rtol = atol =
1e-5 where a sum has at most k terms, and, for the backward, whose hub sums
run over hundreds of terms, atol 1e-5 times the sum of the terms'
magnitudes (a float32 sum's rounding grows with it).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_geometric_tpu import nn as jnn
from tf_geometric_tpu_torch.ops import fixed_k as fk

F32 = dict(rtol=1e-5, atol=1e-5)


def _hub_draw(rng, k, S, n, hubs=((5, 60), (7, 20))):
    """A slot-major draw whose first rows all draw a few hub sources (so
    they hold more than SPLIT slots), the rest uniform, a few ids out of
    range (clipped by every side)."""
    idx = rng.integers(-2, n + 2, (k, S)).astype(np.int32)
    for source, rows in hubs:
        idx[:, :rows][rng.random((k, rows)) < 0.9] = source
    w = rng.uniform(0.5, 1.5, (k, S)).astype(np.float32)
    return torch.as_tensor(idx), torch.as_tensor(w)


# ---------------------------------------------------------------------------
# planning
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("num_src,tile,tiles,passes,digit_bits", [
    (1, 1, 1, 1, 1),
    (2, 1, 2, 1, 1),
    (924, 1, 924, 1, 10),
    (925, 2, 463, 1, 9),
    (232_965, 253, 921, 1, 10),        # the Reddit-shaped graph
    (2 ** 18 + 1, 284, 924, 1, 10),
    (473_088, 512, 924, 1, 10),        # the most one pass of the tile kernel holds
    (524_289, 512, 1025, 2, 6),        # more than 1,024 tiles: two passes
    (10 ** 7, 512, 19_532, 2, 8),
])
def test_backward_plan_tiles(num_src, tile, tiles, passes, digit_bits):
    """Tiles of at most 512 sources, as many as fill whole waves of 132
    tile blocks within one 10-bit digit; more tiles take more radix passes
    of at most 10 bits, which cover every bit of the tile ids."""
    plan = fk.backward_plan(num_src, 128, 4, 4)
    assert (plan.tile, plan.passes, plan.digit_bits) == (tile, passes, digit_bits)
    assert -(-num_src // plan.tile) == tiles
    assert plan.digit_bits * plan.passes >= (tiles - 1).bit_length()
    assert plan.digit_bits <= fk.MAX_DIGIT_BITS and plan.tile <= fk.MAX_TILE
    assert fk.fixed_k_backward_launches(num_src) == 5 * passes + (passes > 1) + 1


@pytest.mark.parametrize("width,elt,vec,part_groups", [
    (128, 4, 4, 32), (128, 2, 8, 32), (602, 4, 2, 16), (602, 2, 2, 16), (41, 4, 1, 32),
    (1, 4, 1, 1024), (4, 2, 4, 1024),
])
def test_backward_plan_widths(width, elt, vec, part_groups):
    """The tile kernel's shared memory at every width the phases run: the
    counts, pointers, hub partials and carry of the widest row leave room
    for a whole chunk, within the block's budget."""
    plan = fk.backward_plan(232_965, width, elt, vec)
    assert plan.part_groups == part_groups
    assert plan.cap == fk.TILE_CAP and plan.cap % 2 == 0
    assert plan.smem <= fk.TILE_SMEM_BYTES


@pytest.mark.parametrize("num_src", [1, 473_088, 10 ** 7])
@pytest.mark.parametrize("width,elt,vec", [(128, 4, 4), (128, 2, 8), (602, 4, 2)])
def test_backward_plan_fits(num_src, width, elt, vec):
    """At every tile size, from one source to the largest tiles, the tile
    kernel's carving (the chunk's pairs, per-warp counts, row pointers, hub
    segment starts, partials and carry) adds up to the plan's shared bytes
    and fits the block's budget with a whole chunk of slots."""
    plan = fk.backward_plan(num_src, width, elt, vec)
    ll, nv = fk._lanes(width // vec)
    pw = (1 << ll) * nv * vec
    fpad = -(-(width // vec) // ((1 << ll) * nv)) * pw
    carving = (8 * plan.cap + 4 * plan.tile * (fk.TILE_WARPS + 1) + 8 * (plan.tile + 1)
               + 4 * plan.part_groups * pw + 8 * fpad)
    assert plan.smem == carving <= fk.TILE_SMEM_BYTES
    assert plan.cap == fk.TILE_CAP
    assert plan.part_groups * pw <= fk.PART_FLOATS or plan.part_groups == 1


def test_serial_walks():
    """The longest serial walk stops at SPLIT slots; the hub's partials."""
    rng = np.random.default_rng(0)
    idx, _ = _hub_draw(rng, 6, 200, 300)
    most = int(torch.bincount(idx.reshape(-1).long().clamp(0, 299)).max())
    assert most > fk.SPLIT
    assert fk.serial_walks(idx, 300) == (fk.SPLIT, -(-most // fk.SPLIT))
    flat = torch.arange(300, dtype=torch.int32).reshape(3, 100)
    assert fk.serial_walks(flat, 300) == (1, 0)


# ---------------------------------------------------------------------------
# the kernels' summation orders
# ---------------------------------------------------------------------------

def _jax_aggregate(x, idx, w):
    """JAX's mean_graph_sage_fixed_k with a zero self kernel and an identity
    neighbour kernel, times k: the slot sum."""
    f = x.shape[1]
    return np.asarray(jnn.mean_graph_sage_fixed_k(
        jnp.asarray(x), jnp.asarray(idx.numpy()), jnp.asarray(w.numpy()),
        jnp.zeros((f, f)), jnp.eye(f), concat=False)) * idx.shape[0]


def _jax_d_src(x, idx, w, dy):
    """The gradient in x of <mean_graph_sage_fixed_k(x) * k, dy> in JAX."""
    f = x.shape[1]

    def loss(x_):
        out = jnn.mean_graph_sage_fixed_k(x_, jnp.asarray(idx.numpy()), jnp.asarray(w.numpy()),
                                          jnp.zeros((f, f)), jnp.eye(f), concat=False)
        return jnp.sum(out * idx.shape[0] * jnp.asarray(dy))
    return np.asarray(jax.grad(loss)(jnp.asarray(x)))


@pytest.mark.parametrize("width", [64, 41])
@pytest.mark.parametrize("k", [5, 25])
def test_forward_order_plain(width, k):
    """The forward kernel sums each row's slots from zero in slot order,
    which is ``fixed_k_forward_plain``'s order: the plain version against
    JAX, ids out of range clipped."""
    rng = np.random.default_rng(k)
    n = S = 60    # JAX's layer adds each row's own projection: S = n
    idx, w = _hub_draw(rng, k, S, n, hubs=())
    x = rng.normal(size=(n, width)).astype(np.float32)
    got = fk.fixed_k_forward_plain(torch.as_tensor(x), idx, w)
    np.testing.assert_allclose(got.numpy(), _jax_aggregate(x, idx, w), **F32)


def _check_backward_order(dy, x, idx, w, n, plan):
    got = fk.fixed_k_backward_order_plain(torch.as_tensor(dy), idx, w, n, plan)
    scale = fk.fixed_k_backward_plain(torch.as_tensor(np.abs(dy)), idx, w.abs(), n).numpy()
    for want in (fk.fixed_k_backward_plain(torch.as_tensor(dy), idx, w, n).numpy(),
                 _jax_d_src(x, idx, w, dy)):
        assert np.all(np.abs(got.numpy() - want) <= F32["atol"] * (1 + scale))
    return got


@pytest.mark.parametrize("width", [64, 41])
@pytest.mark.parametrize("cap", [64, 400, 8192])
def test_backward_order_plain(width, cap):
    """The backward's emulated order (tiles cut into chunks of ``cap``
    slots, hubs into 64-slot segments, the first chunk's sums stored and
    later chunks' added) against the plain version and JAX's gradient, on a
    draw whose first rows all draw two hub sources."""
    rng = np.random.default_rng(cap + width)
    n = S = 240   # JAX's layer adds each row's own projection: S = n
    k = 6
    idx, w = _hub_draw(rng, k, S, n)
    dy = rng.normal(size=(S, width)).astype(np.float32)
    x = rng.normal(size=(n, width)).astype(np.float32)
    vec = 4 if width % 4 == 0 else 1
    got = _check_backward_order(dy, x, idx, w, n,
                                fk.backward_plan(n, width, 4, vec)._replace(cap=cap))
    # rows of at most SPLIT slots in one chunk sum slot by slot, as the plain
    # version's CPU index_add_ does: the same bits there
    if cap == 8192:
        counts = torch.bincount(idx.reshape(-1).long().clamp(0, n - 1), minlength=n)
        small = counts <= fk.SPLIT
        plain = fk.fixed_k_backward_plain(torch.as_tensor(dy), idx, w, n)
        assert torch.equal(got[small], plain[small])


@pytest.mark.parametrize("sources", [1, 3])
@pytest.mark.parametrize("cap", [64, 8192])
def test_backward_order_few_sources(sources, cap):
    """Every slot drawing one source, or one of three: each such source's
    sum is many 64-slot segments, over several chunks where ``cap`` is
    small (the shapes chip_smoke.py runs off the main path, cut to size)."""
    rng = np.random.default_rng(10 * sources + cap)
    n = S = 100   # JAX's layer adds each row's own projection: S = n
    k, width = 3, 8
    idx = torch.as_tensor(rng.integers(0, sources, (k, S)).astype(np.int32))
    w = torch.as_tensor(rng.uniform(0.5, 1.5, (k, S)).astype(np.float32))
    dy = rng.normal(size=(S, width)).astype(np.float32)
    x = rng.normal(size=(n, width)).astype(np.float32)
    _check_backward_order(dy, x, idx, w, n, fk.backward_plan(n, width, 4, 4)._replace(cap=cap))
