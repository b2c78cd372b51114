"""Metrics (JAX counterpart: ``tf_geometric_tpu/utils/metrics.py``).

``accuracy`` and ``masked_accuracy`` compute on tensors, on their device;
``micro_f1`` and ``binary_auc`` on the host in numpy, as the JAX functions
do; ``Accumulator`` is a streaming weighted mean.
"""
from __future__ import annotations

import numpy as np
import torch

from .union_utils import convert_union_to_numpy

__all__ = ["accuracy", "masked_accuracy", "micro_f1", "binary_auc", "Accumulator"]


def accuracy(preds, labels) -> torch.Tensor:
    """Share of ``preds == labels``, a float32 scalar tensor."""
    preds, labels = torch.as_tensor(preds), torch.as_tensor(labels)
    return (preds == labels.to(preds.device)).float().mean()


def masked_accuracy(preds, labels, mask) -> torch.Tensor:
    """Share of ``preds == labels`` over the entries ``mask`` weights (a
    bool or float mask), ``sum(correct · mask) / max(sum(mask), 1)``."""
    preds = torch.as_tensor(preds)
    correct = (preds == torch.as_tensor(labels).to(preds.device)).float()
    mask = torch.as_tensor(mask).to(device=preds.device, dtype=torch.float32)
    return (correct * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def micro_f1(preds, labels) -> float:
    """Micro-averaged F1 of multi-label {0, 1} arrays (0 when nothing is
    predicted or true)."""
    preds = convert_union_to_numpy(preds).astype(bool)
    labels = convert_union_to_numpy(labels).astype(bool)
    tp = (preds & labels).sum()
    fp = (preds & ~labels).sum()
    fn = (~preds & labels).sum()
    denom = 2 * tp + fp + fn
    return float(2 * tp / denom) if denom else 0.0


def binary_auc(scores, labels) -> float:
    """ROC AUC by the rank statistic, ties sharing their midrank; 0.5 when
    one class is absent."""
    scores = convert_union_to_numpy(scores).astype(np.float64)
    labels = convert_union_to_numpy(labels).astype(bool)
    n_pos = int(labels.sum())
    n_neg = len(labels) - n_pos
    if n_pos == 0 or n_neg == 0:
        return 0.5
    _, inverse, counts = np.unique(scores, return_inverse=True, return_counts=True)
    midranks = np.cumsum(counts).astype(np.float64) - (counts - 1) / 2.0
    pos_rank_sum = midranks[inverse][labels].sum()
    return float((pos_rank_sum - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


class Accumulator:
    """Streaming mean over batches: ``update(value, weight)``, then ``result()``."""

    def __init__(self):
        self.total = 0.0
        self.weight = 0.0

    def update(self, value, weight=1.0):
        self.total += float(value) * float(weight)
        self.weight += float(weight)

    def result(self) -> float:
        return self.total / self.weight if self.weight else 0.0

    def reset(self):
        self.total = self.weight = 0.0
