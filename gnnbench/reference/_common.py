"""Plain PyTorch building blocks of the references: edge-list products with
hand-written backwards, computed in blocks of edges so that the Reddit-sized
graphs fit, the reference's precision (and the control's lower one),
dropout by given keep masks, batch normalization, cross entropy with an L2
term, Adam, and the three-step training run that the program is held to.

Nothing here imports the program: the references work again from the edge
list, the features, the labels and the initial weights that the harness made.
"""
from __future__ import annotations

import math
from typing import Callable, Dict

import torch

# elements of one block's gathered rows (512 MiB in float32, 1 GiB in float64)
BLOCK_ELEMENTS = 1 << 27
FP8_MAX = 448.0  # largest float8_e4m3fn


def edge_blocks(num_edges: int, width: int):
    step = max(1, BLOCK_ELEMENTS // max(width, 1))
    for start in range(0, num_edges, step):
        yield slice(start, min(start + step, num_edges))


class EdgeSum(torch.autograd.Function):
    """``out[d, h] = Σ_{e: dst_e = d} w[e, h] · x[src_e, h]``: x [N_src, H·d]
    read as H heads of width d, w [E, H]; gradients for x and for w."""

    @staticmethod
    def forward(ctx, x, w, dst, src, num_rows: int):
        heads = w.shape[1]
        xv = x.view(x.shape[0], heads, -1)
        out = x.new_zeros(num_rows, heads, xv.shape[2])
        for sl in edge_blocks(dst.shape[0], x.shape[1]):
            out.index_add_(0, dst[sl], xv[src[sl]] * w[sl, :, None])
        ctx.save_for_backward(x, w, dst, src)
        return out.view(num_rows, x.shape[1])

    @staticmethod
    def backward(ctx, grad):
        x, w, dst, src = ctx.saved_tensors
        heads = w.shape[1]
        xv = x.view(x.shape[0], heads, -1)
        gv = grad.contiguous().view(grad.shape[0], heads, -1)
        dx = torch.zeros_like(xv) if ctx.needs_input_grad[0] else None
        dw = torch.empty_like(w) if ctx.needs_input_grad[1] else None
        for sl in edge_blocks(dst.shape[0], x.shape[1]):
            g = gv[dst[sl]]
            if dx is not None:
                dx.index_add_(0, src[sl], g * w[sl, :, None])
            if dw is not None:
                dw[sl] = (g * xv[src[sl]]).sum(-1)
        return (None if dx is None else dx.view_as(x)), dw, None, None, None


class EdgeDot(torch.autograd.Function):
    """``s[e, h] = <q[dst_e, h], k[src_e, h]>`` per head: q [N, H·d],
    k [N_src, H·d], s [E, H]."""

    @staticmethod
    def forward(ctx, q, k, dst, src, heads: int):
        qv, kv = q.view(q.shape[0], heads, -1), k.view(k.shape[0], heads, -1)
        s = q.new_empty(dst.shape[0], heads)
        for sl in edge_blocks(dst.shape[0], q.shape[1]):
            s[sl] = (qv[dst[sl]] * kv[src[sl]]).sum(-1)
        ctx.save_for_backward(q, k, dst, src)
        ctx.heads = heads
        return s

    @staticmethod
    def backward(ctx, ds):
        q, k, dst, src = ctx.saved_tensors
        heads = ctx.heads
        qv, kv = q.view(q.shape[0], heads, -1), k.view(k.shape[0], heads, -1)
        dq, dk = torch.zeros_like(qv), torch.zeros_like(kv)
        for sl in edge_blocks(dst.shape[0], q.shape[1]):
            d = ds[sl, :, None]
            dq.index_add_(0, dst[sl], d * kv[src[sl]])
            dk.index_add_(0, src[sl], d * qv[dst[sl]])
        return dq.view_as(q), dk.view_as(k), None, None, None


def segment_softmax(s, dst, num_rows: int):
    """Softmax of s [E, H] over the entries of each destination row. The
    row maximum is subtracted without a gradient (the softmax does not
    depend on it)."""
    with torch.no_grad():
        m = torch.full((num_rows, s.shape[1]), -math.inf, dtype=s.dtype, device=s.device)
        m.scatter_reduce_(0, dst[:, None].expand_as(s), s, reduce="amax")
    e = torch.exp(s - m[dst])
    z = e.new_zeros(num_rows, s.shape[1]).index_add(0, dst, e)
    return e / z[dst]


# --- precision -------------------------------------------------------------

def _round_tf32(t):
    """float32 rounded to TF32's 10-bit mantissa, to nearest even."""
    i = t.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    i = (i + 0xFFF + ((i >> 13) & 1)) & 0xFFFFE000
    i = torch.where(i >= 1 << 31, i - (1 << 32), i)
    return i.to(torch.int32).view(torch.float32).view_as(t)


def _round_bf16(t):
    return t.to(torch.bfloat16).to(t.dtype)


def _round_fp8(t):
    """float8 e4m3 with one scale for the tensor (its largest magnitude at
    448), as a scaled float8 path would compute."""
    amax = t.abs().amax()
    scale = torch.where(amax > 0, amax / FP8_MAX, torch.ones_like(amax))
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale


class _RoundBoth(torch.autograd.Function):
    """Rounds the value going forward and the gradient going back, as a
    cast to a lower precision and the cast back do around a kernel."""

    @staticmethod
    def forward(ctx, t, fn: Callable):
        ctx.fn = fn
        return fn(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.fn(g), None


class _RoundedMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, fn: Callable):
        ctx.save_for_backward(a, b)
        ctx.fn = fn
        return fn(a) @ fn(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        fn, gr = ctx.fn, ctx.fn(g)
        da = gr @ fn(b).T if ctx.needs_input_grad[0] else None
        db = fn(a).T @ gr if ctx.needs_input_grad[1] else None
        return da, db, None


class Precision:
    """The reference computes in float64 (``check.reference_run``). The
    control puts the reference, in float32, in the program's place one
    precision lower than the
    configuration states: dense products in TF32 (for float32 with TF32
    off), and the sparse aggregation's and attention's inputs and outputs,
    both ways, in bfloat16 where the configuration states float32 for them,
    in scaled float8 e4m3 where it states bfloat16."""

    def __init__(self, control: bool = False, aggregation: str = "float32"):
        self.control = control
        self.round_sparse = _round_bf16 if aggregation == "float32" else _round_fp8

    def mm(self, a, b):
        return _RoundedMatmul.apply(a, b, _round_tf32) if self.control else a @ b

    def sparse_io(self, t):
        return _RoundBoth.apply(t, self.round_sparse) if self.control else t


# --- dropout, normalization, loss, optimizer, training --------------------

def dropout(h, keep, rate: float):
    """Inverted dropout by a given keep mask (bool, h's shape)."""
    if keep is None or rate <= 0.0:
        return h
    return torch.where(keep, h / (1.0 - rate), torch.zeros_like(h))


def batch_norm(h, weight, bias, eps: float = 1e-5):
    """Batch normalization in training mode: the batch's mean and biased
    variance over the rows."""
    mean = h.mean(dim=0)
    var = (h - mean).square().mean(dim=0)
    return (h - mean) * torch.rsqrt(var + eps) * weight + bias


def cross_entropy(logits, y):
    return -torch.log_softmax(logits, dim=-1).gather(1, y[:, None]).mean()


def l2_term(params: Dict[str, torch.Tensor], coef: float):
    """``coef`` times 0.5·|w|² summed over the leaves whose name has a dotted
    part containing ``kernel``."""
    if coef == 0.0:
        return 0.0
    return coef * sum(0.5 * p.square().sum() for n, p in params.items()
                      if any("kernel" in part for part in n.split(".")))


def glorot_limit(shape) -> float:
    return math.sqrt(6.0 / (shape[-2] + shape[-1]))


def train(forward: Callable, weights: Dict[str, torch.Tensor], y, optim: dict,
          masks: list, l2_coef: float = 0.0) -> dict:
    """One full-batch step per entry of ``masks`` (each step's keep masks)
    from ``weights`` (not modified): forward, mean cross entropy over all
    nodes plus the L2 term, backward, then Adam written out
    (torch.optim.Adam's update, no weight decay). Returns each step's loss,
    the first step's logits and gradients, and the weights after the last
    step."""
    lr, (b1, b2), eps = optim["lr"], optim["betas"], optim["eps"]
    params = {n: w.detach().clone().requires_grad_(True) for n, w in weights.items()}
    m = {n: torch.zeros_like(w) for n, w in params.items()}
    v = {n: torch.zeros_like(w) for n, w in params.items()}
    out = {"losses": []}
    for t, step_masks in enumerate(masks, start=1):
        logits = forward(params, step_masks)
        loss = cross_entropy(logits, y) + l2_term(params, l2_coef)
        grads = torch.autograd.grad(loss, list(params.values()))
        out["losses"].append(float(loss.detach()))
        if t == 1:
            out["logits"] = logits.detach()
            out["grads"] = {n: g.detach().clone() for n, g in zip(params, grads)}
        del logits, loss
        with torch.no_grad():
            for (n, p), g in zip(params.items(), grads):
                m[n].mul_(b1).add_(g, alpha=1 - b1)
                v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v[n] / (1 - b2 ** t)).sqrt_().add_(eps)
                p.addcdiv_(m[n], denom, value=-lr / (1 - b1 ** t))
        del grads
    out["params"] = {n: p.detach() for n, p in params.items()}
    return out
