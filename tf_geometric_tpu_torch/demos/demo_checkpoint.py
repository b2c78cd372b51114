"""Checkpoint save and restore in the middle of training (JAX counterpart:
``demo/demo_checkpoint.py``, an orbax checkpoint of ``(params, opt_state,
step)``): the scripts' two-layer GCN (``GCN(16, relu)``, ``GCN(C)``, no
dropout) on ``load_cora``, the masked loss with L2 5e-4, Adam 1e-2. After
``half`` = 50 steps ``{"model", "optimizer", "step"}`` goes to one file
(``torch.save``); a model drawn from another seed and a new Adam restore it
(``torch.load(..., weights_only=True)``) and train ``half`` more steps.
Returns the test accuracy.

    python -m tf_geometric_tpu_torch.demos.demo_checkpoint            # on the card
    python -m tf_geometric_tpu_torch.demos.demo_checkpoint --cpu

The layers run on the cached normalization, where the script's normalize
each call: the same product. Each step launches Kernel A
(``csrc/csr_spmm.cu``) four times on the card, the forward and ``dh`` of
each layer at F = 16 and F = C; an evaluation twice.
"""
from __future__ import annotations

import contextlib
import os
import sys
import tempfile
import time
from typing import Optional

import torch

from .demo_gcn import GCNModel
from .demo_utils import demo_steps, load_cora, train_step

__all__ = ["build_model", "main", "LEARNING_RATE", "L2_COEF"]

LEARNING_RATE = 1e-2
L2_COEF = 5e-4


def build_model(graph, num_classes: int, seed: int = 0, device="cuda"):
    """The scripts' ``GCNModel`` (``demo_gcn.GCNModel`` without dropout: the
    flax names ``GCN_0``, ``GCN_1``, ``convert.gcn_state_dict_from_flax``;
    glorot kernels from ``seed``) and its ``forward(training, generator)``
    on ``graph``, whose normalization cache is built here."""
    model = GCNModel(graph.num_features, num_classes, drop_rate=0.0,
                     generator=torch.Generator().manual_seed(seed), device=device)
    model.GCN_0.build_cache_for_graph(graph, device=device)
    adj, cache = graph.adj(device=device), graph.cache
    return model, (lambda training, generator=None: model(graph.x, adj, cache))


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def main(device="cuda", stats: Optional[dict] = None, directory: Optional[str] = None):
    """Train ``half`` steps, checkpoint, restore into a fresh model and
    optimizer, train ``half`` more; returns the test accuracy. The file
    goes under ``directory`` (kept), or a temporary directory (removed).
    ``stats``, when given, receives ``losses`` (each step's, tensors),
    ``steps``, ``evals``, ``half``, ``state_dict`` (the final weights),
    ``file_bytes``, ``save_ms`` and ``restore_ms``."""
    graph, (train_index, _, test_index) = load_cora(device=device)
    num_classes = int(graph.y.max()) + 1
    y = graph.y.long()
    model, forward = build_model(graph, num_classes, 0, device)
    optimizer = torch.optim.Adam(model.parameters(), lr=LEARNING_RATE)
    half = demo_steps(50)
    losses = [train_step(model, optimizer, forward, y, train_index, L2_COEF)
              for _ in range(half)]
    keep = contextlib.nullcontext(directory) if directory else tempfile.TemporaryDirectory()
    with keep as root:
        path = os.path.join(root, "gcn_ckpt", f"step_{half}.pt")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        _sync(device)
        t0 = time.perf_counter()
        torch.save({"model": model.state_dict(), "optimizer": optimizer.state_dict(),
                    "step": half}, path)
        save_ms = (time.perf_counter() - t0) * 1e3
        file_bytes = os.path.getsize(path)
        print(f"saved checkpoint at step {half} (loss={float(losses[-1]):.4f})")

        model, forward = build_model(graph, num_classes, 1, device)
        optimizer = torch.optim.Adam(model.parameters(), lr=LEARNING_RATE)
        t0 = time.perf_counter()
        restored = torch.load(path, map_location=y.device, weights_only=True)
        model.load_state_dict(restored["model"])
        optimizer.load_state_dict(restored["optimizer"])
        _sync(device)
        restore_ms = (time.perf_counter() - t0) * 1e3
        print(f"restored checkpoint from step {restored['step']}")

    losses += [train_step(model, optimizer, forward, y, train_index, L2_COEF)
               for _ in range(half, 2 * half)]
    model.eval()
    with torch.no_grad():
        preds = forward(False).argmax(dim=-1)
    acc = float((preds[test_index] == y[test_index]).float().mean())
    print(f"test accuracy after resume: {acc:.4f}")
    if stats is not None:
        stats.update(losses=losses, steps=2 * half, evals=1, half=half,
                     state_dict=model.state_dict(), file_bytes=file_bytes, save_ms=save_ms,
                     restore_ms=restore_ms)
    return acc


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in sys.argv[1:] else "cuda")
