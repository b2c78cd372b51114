"""The comparison that decides ``correct``.

After the window the program's state is freed and the plain reference
(``reference/<model>.py``) trains three steps from the same graph, features,
labels, initial weights and keep masks, in float64: a float32 reference's
own sums (atomic adds over hub rows of 24k entries) moved its logits by up
to 2.5e-4 between two runs of one seed, far more than the program's float32
departs from the float64 computation. The numbers compared:

- ``loss_gap``: the relative gap of the first step's loss. The later
  steps' losses carry Adam's first step, which moves every element by the
  learning rate whatever the size of its gradient, so round-off in small
  gradients moves them: on a few seeds they read 30-100 times the first
  step's gap, while the first step's stays at round-off (``PERF.md`` gives
  both readings). The later steps are held by ``update_gap``;
- ``logits_gap``: the widest gap of the first step's logits, over the
  reference's largest logit;
- ``grad_gap``: the first step's gradient as Adam holds it, by the worst
  leaf: the gap between the program's norm and the reference's, over the
  larger of that leaf's reference norm and the median leaf's;
- ``update_gap``: the weights' change over the three steps, the same gap
  for each leaf, and of those the median leaf's; leaves whose reference
  gradient is under a thousandth of the median leaf's are left out
  (round-off alone moves them under Adam: a bias before batch
  normalization), and of the others the median leaf's. ``PERF.md`` gives
  the worst leaf's readings beside it.

Each has a limit in the cell's ``workloads/<cell>.json``; ``PERF.md`` gives
the readings each limit was set from.
"""
from __future__ import annotations

import statistics
from typing import Dict

import torch

from gnnbench.reference._common import Precision, train

NUMBERS = ("loss_gap", "logits_gap", "grad_gap", "update_gap")
QUIET_GRAD = 1e-3  # a leaf's reference gradient under this share of the median's


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(torch.linalg.vector_norm(t.double())) for n, t in tensors.items()}


def reference_run(ref_module, cfg: dict, graph: dict, weights: dict, masks: list,
                  control: bool = False) -> dict:
    """The reference's steps, one per entry of ``masks`` (each step's keep
    masks), in float64; with ``control`` it computes instead one precision
    below the configuration's (``Precision``: float32 with TF32 products and
    bfloat16 sparse inputs and outputs). float32 products run with TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    prepared = ref_module.prepare(cfg, graph["edge_index"], graph["num_nodes"])
    prec = Precision(control, cfg["precision"]["aggregation"])
    dtype = torch.float32 if control else torch.float64
    x = graph["x"].to(dtype)
    start = {n: w.to(dtype) for n, w in weights.items()}
    out = train(lambda p, m: ref_module.forward(cfg, prepared, x, p, m, prec),
                start, graph["y"], cfg["optimizer"], masks, cfg.get("l2_coef", 0.0))
    out["params0"] = weights
    return out


def leaf_gaps(prog: dict, ref: dict) -> Dict[str, Dict[str, float]]:
    """Per leaf: the reference's gradient and change norms, and the gaps of
    the program's norms to them over the larger of the leaf's reference norm
    and the median leaf's (``moving``: whether the update gap counts it)."""
    g_prog, g_ref = _norms(prog["grads"]), _norms(ref["grads"])
    p0 = prog["params0"]
    d_prog = _norms({n: prog["params"][n] - p0[n] for n in p0})
    d_ref = _norms({n: ref["params"][n] - ref["params0"][n] for n in ref["params0"]})
    g_med, d_med = statistics.median(g_ref.values()), statistics.median(d_ref.values())
    return {n: {"grad": g_ref[n], "grad_gap": abs(g_prog[n] - g_ref[n]) / max(g_ref[n], g_med, 1e-30),
                "change": d_ref[n],
                "change_gap": abs(d_prog[n] - d_ref[n]) / max(d_ref[n], d_med, 1e-30),
                "moving": g_ref[n] >= QUIET_GRAD * g_med}
            for n in g_ref}


def compare(prog: dict, ref: dict) -> Dict[str, float]:
    """The numbers compared, from the program's record (``Trainer.first_steps``
    or another ``reference_run``) and the reference's."""
    losses = [float(v) for v in prog["losses"]]
    leaves = leaf_gaps(prog, ref).values()
    return {"loss_gap": abs(losses[0] - ref["losses"][0]) / abs(ref["losses"][0]),
            "logits_gap": float((prog["logits"].double() - ref["logits"]).abs().max()
                                / ref["logits"].abs().max()),
            "grad_gap": max(v["grad_gap"] for v in leaves),
            "update_gap": statistics.median(v["change_gap"] for v in leaves if v["moving"])}


def judge(numbers: Dict[str, float], limits: Dict[str, float]):
    """``correct`` is true when every number is finite and within its limit."""
    ok = all(n in numbers and numbers[n] == numbers[n] and numbers[n] <= limits[n]
             for n in limits)
    table = {n: {"value": numbers[n] if numbers.get(n) == numbers.get(n) else None,
                 "limit": limits[n]} for n in limits}
    return ok, table
