"""Plain reference of the GraphSAGE configuration (GraphSAGE-mean, Hamilton
et al., arXiv:1706.02216, as the configuration runs it): every node a seed,
two layers over the step's fixed-k draws, then the dense head.

Layer l, with the draw ``idx_l`` [k_l, N] (slot-major) and its weights
``w_l``: ``h_l = relu([h Ws_l ‖ (1/k_l) Σ_j w_l[j, v] · (h Wn_l)[idx_l[j, v]]])``;
``logits = h_2 Wd``; no biases. The gather is an edge list (destination
``v``, source ``idx_l[j, v]``, weight ``w_l[j, v] / k_l``) summed in edge
blocks, with the precision's hooks around its input and output
(``sparse_io``) and around every product (``mm``).

The draws are the program's: the model writes each step's into the step's
dict (``draw0``, ``draw1``) and the harness hands that dict here, so they are
checked before they are used (``draw_is_sound``), over the rows with edges:

- each slot is an edge of its row with weight 1, or the row itself with
  weight 0 where the row has no edges;
- the slots are uniform over the row's edge multiset: each slot's rank in
  its row's sorted edges, spread uniformly over the ranks of its edge's
  copies and divided by the degree, is uniform on [0, 1) for a uniform draw;
  a chi-square over ``RANK_BUCKETS`` buckets of every slot's rank;
- the slots are drawn afresh: two slots agree as often as independent
  uniform draws would, both the slot pairs (0, 1), (2, 3), ... of a draw
  and each slot against the same slot of the layer's draws at the earlier
  steps. Row ``v``'s two draws agree with chance ``q_v = Σ_e (m_e / d_v)²``
  (``m_e`` an edge's copies, ``d_v`` the degree), so the count of agreeing
  slots has mean ``Σ q_v`` and variance ``Σ q_v (1 − q_v)`` over the pairs.

A sound draw fails a check with a chance of about ``LEVEL`` (the
chi-square's) or ``AGREE_Z`` standard deviations (the agreements'). A draw
that fails any gives NaN logits, so that it fails the comparison: at the
first step with no gradient (NaN loss and logits gaps), at a later one with
a NaN gradient (a NaN update gap).

Where the dict carries no draw (the calibration's control, which trains this
reference against itself), the reference draws one itself, uniformly over
each row's edges from a generator seeded with ``draw_seed``, and writes it
into the dict, so that the control's run takes the same draws.
"""
from __future__ import annotations

import torch

from gnnbench.reference._common import EdgeSum, Precision

RANK_BUCKETS = 64       # buckets of the slots' ranks in the uniformity check
LEVEL = 1e-9            # the chi-square's level: the chance a uniform draw fails it
AGREE_Z = 6.0           # standard deviations the agreeing slots may stray from their mean
CHECK_SEED = 20_170_602  # seeds the uniforms that spread a rank over an edge's copies


class _Invalid(torch.autograd.Function):
    """NaN in place of the logits; back through them a zero gradient at the
    first step (whose gradient is compared leaf by leaf) and NaN at a later
    one (so that the weights, and the update compared, turn NaN)."""

    @staticmethod
    def forward(ctx, logits, first_step: bool):
        ctx.first_step = first_step
        return torch.full_like(logits, float("nan"))

    @staticmethod
    def backward(ctx, grad):
        return (torch.zeros_like(grad) if ctx.first_step
                else torch.full_like(grad, float("nan"))), None


def _dims(cfg: dict, num_features: int) -> list:
    return [num_features] + [cfg["units"]] * len(cfg["fanouts"])


def param_shapes(cfg: dict, num_features: int, num_classes: int) -> dict:
    dims, half = _dims(cfg, num_features), cfg["units"] // 2
    shapes = {}
    for i, fin in enumerate(dims[:-1]):
        shapes[f"sage{i}.self_kernel"] = (fin, half)
        shapes[f"sage{i}.neighbor_kernel"] = (fin, half)
    shapes["dense.kernel"] = (dims[-1], num_classes)
    return shapes


def initial_values(name: str):
    return None


def dropouts(cfg: dict, num_nodes: int, num_features: int, num_classes: int,
             num_entries: int) -> dict:
    """No dropout: the step's dict carries the draws alone."""
    return {}


def prepare(cfg: dict, edge_index, num_nodes: int) -> dict:
    """The edge list's sorted ``dst·N + src`` keys, each row's degree, start
    in the keys and chance ``q_v`` that two uniform draws agree, the
    generators of the own draws and of the check, and the layers' earlier
    draws (``seen``) and the steps taken, filled step by step."""
    n, device = num_nodes, edge_index.device
    keys = torch.sort(edge_index[0].long() * n + edge_index[1].long()).values
    degree = torch.bincount(edge_index[0].long(), minlength=n)
    distinct, copies = torch.unique_consecutive(keys, return_counts=True)
    agree = torch.zeros(n, dtype=torch.float64, device=device).index_add_(
        0, distinct // n, copies.double() ** 2) / degree.clamp_min(1).double() ** 2
    gen = torch.Generator(device=device)
    gen.manual_seed(int(cfg["draw_seed"]))
    check_gen = torch.Generator(device=device)
    check_gen.manual_seed(CHECK_SEED)
    return {"keys": keys, "degree": degree, "start": torch.cumsum(degree, 0) - degree,
            "agree": agree, "num_nodes": n, "generator": gen, "check_generator": check_gen,
            "seen": {}, "steps": 0}


def draw_is_valid(graph: dict, idx, w) -> bool:
    """Whether every slot of the draw ``idx`` [k, N], ``w`` [k, N] is an edge
    of its row with weight 1, or, for a row without edges, the row itself
    with weight 0."""
    keys, degree, n = graph["keys"], graph["degree"], graph["num_nodes"]
    if idx.dim() != 2 or idx.shape[1] != n or w.shape != idx.shape:
        return False
    src = idx.long()
    rows = torch.arange(n, device=src.device).expand_as(src)
    in_range = (src >= 0) & (src < n)
    key = rows * n + src.clamp(0, n - 1)
    pos = torch.searchsorted(keys, key.reshape(-1)).clamp_max(keys.numel() - 1)
    is_edge = keys[pos].view_as(key) == key
    ok = torch.where(degree[None, :] > 0, is_edge & (w == 1), (src == rows) & (w == 0))
    return bool((ok & in_range).all())


def draw_is_uniform(graph: dict, idx) -> bool:
    """Whether the ranks of a valid draw's slots (rows with edges) pass the
    chi-square at ``LEVEL``."""
    keys, degree, n = graph["keys"], graph["degree"], graph["num_nodes"]
    row = torch.nonzero(degree > 0).squeeze(1)
    if row.numel() == 0:
        return True
    k = idx.shape[0]
    key = (row[None, :] * n + idx[:, row].long()).reshape(-1)
    lo = torch.searchsorted(keys, key)
    hi = torch.searchsorted(keys, key, right=True)
    u = torch.rand(key.shape, generator=graph["check_generator"], dtype=torch.float64,
                   device=key.device)
    rank = (lo - graph["start"][row].repeat(k) + u * (hi - lo)) / degree[row].repeat(k)
    seen = torch.bincount((rank * RANK_BUCKETS).long().clamp(0, RANK_BUCKETS - 1),
                          minlength=RANK_BUCKETS).double()
    expected = key.numel() / RANK_BUCKETS
    chi2 = ((seen - expected) ** 2 / expected).sum()
    dof = torch.tensor((RANK_BUCKETS - 1) / 2, dtype=torch.float64, device=key.device)
    return bool(torch.special.gammaincc(dof, chi2 / 2) >= LEVEL)


def slots_agree_by_chance(graph: dict, a, b) -> bool:
    """Whether slots ``a`` and ``b`` ([j, N] each, every pair independent
    for a sound draw) agree, over the rows with edges, within ``AGREE_Z``
    standard deviations of what independent uniform draws give."""
    has = graph["degree"] > 0
    q = graph["agree"][has]
    same = (a[:, has] == b[:, has]).sum().double()
    mean, var = a.shape[0] * q.sum(), a.shape[0] * (q * (1 - q)).sum()
    return bool((same - mean).abs() <= AGREE_Z * var.sqrt() + 0.5)


def draw_is_sound(graph: dict, layer: int, idx, w) -> bool:
    """Valid, uniform and fresh (module docstring); records the draw among
    the layer's earlier ones."""
    if not draw_is_valid(graph, idx, w):
        return False
    earlier = graph["seen"].setdefault(layer, [])
    pairs = idx.shape[0] // 2 * 2
    sound = (draw_is_uniform(graph, idx)
             and slots_agree_by_chance(graph, idx[0:pairs:2], idx[1:pairs:2])
             and all(slots_agree_by_chance(graph, e, idx) for e in earlier))
    earlier.append(idx)
    return sound


def _own_draw(graph: dict, k: int, device):
    """A uniform with-replacement draw over each row's edges, in plain torch
    (rows without edges: the row itself, weight 0)."""
    keys, degree, n = graph["keys"], graph["degree"], graph["num_nodes"]
    start = graph["start"]
    u = torch.rand((k, n), generator=graph["generator"], device=device, dtype=torch.float64)
    pick = start[None, :] + (u * degree[None, :]).long().clamp_max((degree - 1).clamp_min(0))
    has = degree[None, :] > 0
    src = torch.where(has, keys[pick.clamp_max(keys.numel() - 1)] % n,
                      torch.arange(n, device=device)[None, :])
    return src.int(), has.expand(k, n).float()


def _layer(h, params, i, idx, w, k, prec):
    n = h.shape[0]
    h_self = prec.mm(h, params[f"sage{i}.self_kernel"])
    h_nb = prec.sparse_io(prec.mm(h, params[f"sage{i}.neighbor_kernel"]))
    dst = torch.arange(n, device=h.device).repeat(k)
    weight = w.reshape(-1, 1).to(h.dtype) / k
    agg = prec.sparse_io(EdgeSum.apply(h_nb, weight, dst, idx.reshape(-1).long(), n))
    return torch.relu(torch.cat([h_self, agg], dim=1))


def forward(cfg: dict, graph: dict, x, params: dict, masks: dict, prec: Precision):
    h, valid = x, True
    graph["steps"] += 1
    for i, k in enumerate(cfg["fanouts"]):
        name = f"draw{i}"
        if name not in masks:
            masks[name] = _own_draw(graph, k, x.device)
        idx, w = masks[name]
        valid = draw_is_sound(graph, i, idx, w) and valid
        h = _layer(h, params, i, idx, w, k, prec)
    logits = prec.mm(h, params["dense.kernel"])
    return logits if valid else _Invalid.apply(logits, graph["steps"] == 1)
