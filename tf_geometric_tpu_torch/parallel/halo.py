"""Halo (boundary-row) exchange for the edge-partitioned products (JAX
counterpart: ``tf_geometric_tpu/parallel/halo.py``).

Each rank reads only the source rows its edges reference. The plan, built on
the host:

    send_idx [P, P, cap]  rank i sends its local rows send_idx[i, j] to rank j
    local edges           source row on the same rank
    remote edges          source row received; its address indexes the
                          flat [P·cap, F] receive buffer (owner o's rows at
                          o·cap ..)

and on the device one all-to-all per layer (``halo_exchange``), whose
backward is the reverse all-to-all. ``layout="coo"`` keeps the edge lists
(gather and ``index_add_``, the JAX module's ``jax.ops.segment_sum``);
``layout="ell"`` packs each rank's blocks as ``CsrAdj`` (local ``[npp,
npp]`` with a split diagonal, remote ``[npp, P·cap]``) for ``ell_spmm``,
where the JAX module packs ``EllShard``s. ``build_gat_halo_spec`` gives each
rank one rectangular ``CsrGatLayout`` over ``[npp local ‖ P·cap received]``
for ``gat_attention_ell``.

The specs hold every rank's blocks on the host (CPU tensors);
``rank_halo_plan`` and ``rank_gat_plan`` cut out one rank's part and move
it to that rank's device, so each rank holds only its own shard.

The exchange goes through ``torch.distributed.all_to_all_single``. With the
gloo backend and CUDA tensors, as when several ranks share one card, gloo
stages the buffers through host memory itself.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..ops.csr_spmm import CsrAdj
from ..ops.ell import ell_spmm
from ..ops.gat_attention import CsrGatLayout, gat_attention_ell
from .partition import EdgePartition

__all__ = ["HaloSpec", "HaloSpecEll", "GatHaloSpec", "RankHaloPlan", "RankGatPlan",
           "build_halo_spec", "build_gat_halo_spec", "rank_halo_plan", "rank_gat_plan",
           "halo_exchange", "halo_spmm_split", "halo_spmm_ell", "halo_gat_attention"]


def _halo_fraction(num_parts: int, capacity: int, nodes_per_part: int) -> float:
    """Exchanged rows over the rows a full all-gather would move."""
    return (num_parts * num_parts * capacity) / (num_parts * num_parts * nodes_per_part)


class HaloSpec(NamedTuple):
    """The COO plan, every rank's arrays stacked on a leading [P] axis."""
    send_idx: np.ndarray   # [P, P, cap] int32
    loc_row: np.ndarray    # [P, EL] int32, destination (sentinel npp)
    loc_col: np.ndarray    # [P, EL] int32, local source row
    loc_val: np.ndarray    # [P, EL] float32
    rem_row: np.ndarray    # [P, ER] int32, destination (sentinel npp)
    rem_addr: np.ndarray   # [P, ER] int32, address in the flat receive buffer
    rem_val: np.ndarray    # [P, ER] float32
    nodes_per_part: int
    capacity: int
    num_parts: int

    @property
    def halo_fraction(self) -> float:
        return _halo_fraction(self.num_parts, self.capacity, self.nodes_per_part)


class HaloSpecEll(NamedTuple):
    """The packed plan: per rank a local ``CsrAdj`` [npp, npp] (split
    diagonal) and a remote ``CsrAdj`` [npp, P·cap], on the host."""
    send_idx: np.ndarray     # [P, P, cap] int32
    local: List[CsrAdj]
    remote: List[CsrAdj]
    nodes_per_part: int
    capacity: int
    num_parts: int

    @property
    def halo_fraction(self) -> float:
        return _halo_fraction(self.num_parts, self.capacity, self.nodes_per_part)


class GatHaloSpec(NamedTuple):
    """The fused-GAT plan: per rank a rectangular ``CsrGatLayout`` from
    ``npp + P·cap`` source rows into ``npp`` destination rows whose edge ids
    run over the rank's local edges, then its remote edges, then padding up
    to ``num_edges`` (the rows of a keep mask)."""
    send_idx: np.ndarray     # [P, P, cap] int32
    layouts: List[CsrGatLayout]
    num_edges: int
    nodes_per_part: int
    capacity: int
    num_parts: int

    @property
    def halo_fraction(self) -> float:
        return _halo_fraction(self.num_parts, self.capacity, self.nodes_per_part)


def _pad2d(rows_list, fill, pad_multiple):
    """Stack ragged per-rank 1-D arrays into [P, L], L a multiple of
    ``pad_multiple``."""
    L = max((len(r) for r in rows_list), default=0)
    L = max(int(-(-max(L, 1) // pad_multiple) * pad_multiple), pad_multiple)
    out = np.full((len(rows_list), L), fill, rows_list[0].dtype if len(rows_list) else np.int32)
    for i, r in enumerate(rows_list):
        out[i, :len(r)] = r
    return out


def _split_edges(part: EdgePartition, capacity_multiple: int):
    """Per (owner → reader) the unique remote rows (send lists, receive
    addresses) and per rank the local / remote edge split, unpadded."""
    P, npp = part.num_parts, part.nodes_per_part
    needed = [[np.zeros(0, np.int64) for _ in range(P)] for _ in range(P)]
    valid_masks, owners_of = [], []
    for d in range(P):
        valid = part.local_row[d] < npp
        cols = part.global_col[d].astype(np.int64)
        owners = np.minimum(cols // npp, P - 1)
        valid_masks.append(valid)
        owners_of.append(owners)
        for o in range(P):
            if o != d:
                needed[o][d] = np.unique(cols[valid & (owners == o)])
    cap = max((len(needed[o][d]) for o in range(P) for d in range(P)), default=0)
    cap = max(int(-(-max(cap, 1) // capacity_multiple) * capacity_multiple), capacity_multiple)

    send_idx = np.zeros((P, P, cap), np.int32)
    addr_maps = [np.zeros(part.num_nodes_padded, np.int32) for _ in range(P)]
    for o in range(P):
        for d in range(P):
            rows = needed[o][d]
            send_idx[o, d, :len(rows)] = (rows - o * npp).astype(np.int32)
            addr_maps[d][rows] = o * cap + np.arange(len(rows), dtype=np.int32)

    loc_rows, loc_cols, loc_vals, rem_rows, rem_addrs, rem_vals = [], [], [], [], [], []
    for d in range(P):
        valid, owners = valid_masks[d], owners_of[d]
        g = part.global_col[d].astype(np.int64)
        lsel, rsel = valid & (owners == d), valid & (owners != d)
        loc_rows.append(part.local_row[d][lsel])
        loc_cols.append((g[lsel] - d * npp).astype(np.int32))
        loc_vals.append(part.value[d][lsel])
        rem_rows.append(part.local_row[d][rsel])
        rem_addrs.append(addr_maps[d][g[rsel]])
        rem_vals.append(part.value[d][rsel])
    return send_idx, cap, loc_rows, loc_cols, loc_vals, rem_rows, rem_addrs, rem_vals


def build_halo_spec(part: EdgePartition, capacity_multiple: int = 64,
                    pad_multiple: int = 128, layout: str = "coo"):
    """Host-side plan. ``layout="coo"`` gives a ``HaloSpec``; ``"ell"`` a
    ``HaloSpecEll`` whose blocks are ``CsrAdj``s on the CPU."""
    if layout not in ("coo", "ell"):
        raise ValueError(f"layout must be 'coo' or 'ell', got {layout!r}")
    (send_idx, cap, loc_rows, loc_cols, loc_vals,
     rem_rows, rem_addrs, rem_vals) = _split_edges(part, capacity_multiple)
    P, npp = part.num_parts, part.nodes_per_part
    if layout == "ell":
        local = [CsrAdj.from_coo(np.stack([loc_rows[d], loc_cols[d]]), loc_vals[d], (npp, npp),
                                 split_diag=True, device="cpu") for d in range(P)]
        remote = [CsrAdj.from_coo(np.stack([rem_rows[d], rem_addrs[d]]), rem_vals[d],
                                  (npp, P * cap), device="cpu") for d in range(P)]
        return HaloSpecEll(send_idx, local, remote, npp, cap, P)
    return HaloSpec(
        send_idx=send_idx,
        loc_row=_pad2d(loc_rows, npp, pad_multiple), loc_col=_pad2d(loc_cols, 0, pad_multiple),
        loc_val=_pad2d(loc_vals, 0.0, pad_multiple), rem_row=_pad2d(rem_rows, npp, pad_multiple),
        rem_addr=_pad2d(rem_addrs, 0, pad_multiple), rem_val=_pad2d(rem_vals, 0.0, pad_multiple),
        nodes_per_part=npp, capacity=cap, num_parts=P)


def build_gat_halo_spec(part: EdgePartition, capacity_multiple: int = 64) -> GatHaloSpec:
    """Host-side fused-GAT plan from a partition of the self-looped,
    unweighted attention graph (edge values are ignored). Each rank's edge
    ids: local edges, then remote edges, then padding to the common
    ``num_edges`` (a multiple of 128), as the JAX plan numbers them."""
    (send_idx, cap, loc_rows, loc_cols, _, rem_rows, rem_addrs, _) = _split_edges(
        part, capacity_multiple)
    P, npp = part.num_parts, part.nodes_per_part
    S = npp + P * cap
    rows_d = [np.concatenate([loc_rows[d], rem_rows[d]]).astype(np.int64) for d in range(P)]
    cols_d = [np.concatenate([loc_cols[d].astype(np.int64), npp + rem_addrs[d].astype(np.int64)])
              for d in range(P)]
    e_cap = max(int(-(-max(len(r) for r in rows_d) // 128) * 128), 128)
    layouts = []
    for d in range(P):
        pad = e_cap - len(rows_d[d])
        ei = np.stack([np.concatenate([rows_d[d], np.full(pad, npp, np.int64)]),
                       np.concatenate([cols_d[d], np.zeros(pad, np.int64)])])
        layouts.append(CsrGatLayout.build(ei, npp, device="cpu", num_src=S))
    return GatHaloSpec(send_idx, layouts, e_cap, npp, cap, P)


class RankHaloPlan(NamedTuple):
    """One rank's part of a GCN halo plan on its device: its send lists
    [P, cap] and either its ``CsrAdj`` blocks (``local``, ``remote``) or its
    COO edge arrays (``coo``: loc_row, loc_col, loc_val, rem_row, rem_addr,
    rem_val)."""
    send_idx: torch.Tensor
    local: Optional[CsrAdj]
    remote: Optional[CsrAdj]
    coo: Optional[tuple]
    nodes_per_part: int

    def to(self, device) -> "RankHaloPlan":
        return RankHaloPlan(self.send_idx.to(device),
                            None if self.local is None else self.local.to(device),
                            None if self.remote is None else self.remote.to(device),
                            None if self.coo is None else tuple(t.to(device) for t in self.coo),
                            self.nodes_per_part)


class RankGatPlan(NamedTuple):
    """One rank's part of a fused-GAT plan on its device."""
    send_idx: torch.Tensor     # [P, cap] int64
    layout: CsrGatLayout       # [npp] <- [npp + P·cap]
    num_edges: int
    nodes_per_part: int

    def to(self, device) -> "RankGatPlan":
        return self._replace(send_idx=self.send_idx.to(device), layout=self.layout.to(device))


def rank_halo_plan(spec, rank: int, device) -> RankHaloPlan:
    """Rank ``rank``'s shard of a ``HaloSpec`` or ``HaloSpecEll`` on ``device``."""
    send = torch.as_tensor(spec.send_idx[rank], dtype=torch.long, device=device)
    if isinstance(spec, HaloSpecEll):
        return RankHaloPlan(send, spec.local[rank].to(device), spec.remote[rank].to(device),
                            None, spec.nodes_per_part)
    coo = tuple(torch.as_tensor(getattr(spec, f)[rank], device=device)
                for f in ("loc_row", "loc_col", "loc_val", "rem_row", "rem_addr", "rem_val"))
    return RankHaloPlan(send, None, None, coo, spec.nodes_per_part)


def rank_gat_plan(spec: GatHaloSpec, rank: int, device) -> RankGatPlan:
    """Rank ``rank``'s shard of a ``GatHaloSpec`` on ``device``."""
    return RankGatPlan(torch.as_tensor(spec.send_idx[rank], dtype=torch.long, device=device),
                       spec.layouts[rank].to(device), spec.num_edges, spec.nodes_per_part)


class _AllToAll(torch.autograd.Function):
    """Equal-split all-to-all of a [P·cap, F] buffer along rows: block j
    goes to rank j, block o of the result comes from rank o. Its backward
    is the reverse all-to-all of the incoming gradient."""

    @staticmethod
    def forward(ctx, send, group):
        ctx.group = group
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=group)
        return recv

    @staticmethod
    def backward(ctx, grad):
        out = torch.empty_like(grad)
        dist.all_to_all_single(out, grad.contiguous(), group=ctx.group)
        return out, None


def halo_exchange(h_local, send_idx_local, group=None):
    """Exchange boundary rows with every rank. ``h_local`` [npp, F],
    ``send_idx_local`` [P, cap] (this rank's send lists, clipped to the
    local rows). Returns ``recv`` [P, cap, F]: ``recv[o]`` the rows owner
    ``o`` sent, in plan order."""
    P, cap = send_idx_local.shape
    send = h_local.index_select(0, send_idx_local.reshape(-1).clamp(0, h_local.shape[0] - 1))
    return _AllToAll.apply(send.contiguous(), group).view(P, cap, h_local.shape[1])


def _segment_sum(msg, rows, num_rows: int):
    """``jax.ops.segment_sum`` with out-of-range rows (the sentinel) dropped."""
    out = msg.new_zeros((num_rows + 1, msg.shape[1]))
    return out.index_add(0, rows.long().clamp(0, num_rows), msg)[:num_rows]


def halo_spmm_split(h_local, recv, loc_row, loc_col, loc_val, rem_row, rem_addr, rem_val,
                    nodes_per_part: int):
    """Local plus remote partial aggregation on the COO plan (plain PyTorch
    gathers and ``index_add``, as the JAX function uses XLA's)."""
    local_msg = (h_local.index_select(0, loc_col.long().clamp(0, h_local.shape[0] - 1))
                 * loc_val[:, None])
    out = _segment_sum(local_msg, loc_row, nodes_per_part)
    recv_flat = recv.reshape(-1, h_local.shape[1])
    rem_msg = (recv_flat.index_select(0, rem_addr.long().clamp(0, recv_flat.shape[0] - 1))
               * rem_val[:, None])
    return out + _segment_sum(rem_msg, rem_row, nodes_per_part)


def halo_spmm_ell(h_local, recv, local: CsrAdj, remote: CsrAdj):
    """Local plus remote aggregation on the packed blocks: ``ell_spmm`` on
    the local block (no dependency on ``recv``) and on the remote one."""
    recv_flat = recv.reshape(-1, h_local.shape[1])
    return ell_spmm(local, h_local) + ell_spmm(remote, recv_flat)


def halo_gat_attention(Q, K_src, V_src, plan: RankGatPlan, num_heads: int,
                       edge_drop_rate: float = 0.0, training: bool = False,
                       generator: Optional[torch.Generator] = None, keep_mask=None):
    """Fused attention over the rank's rectangular layout: ``Q`` [npp, H·d]
    (local destination rows), ``K_src``/``V_src`` [npp + P·cap, H·d] (local
    rows, then the received rows)."""
    return gat_attention_ell(plan.layout, Q, K_src, V_src, num_heads,
                             edge_drop_rate=edge_drop_rate, training=training,
                             generator=generator, keep_mask=keep_mask)
