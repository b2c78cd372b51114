"""Single-file weight save and load (JAX counterpart:
``demo/demo_save_and_load_model.py``, the flax params through
``flax.serialization``): the scripts' two-layer GCN
(``demo_checkpoint.build_model``) on ``load_cora``, its ``state_dict``
through one file (``torch.save``, then ``torch.load(...,
weights_only=True)`` into a model drawn from another seed), the logits
before and after held equal (the script's ``rtol=1e-6``). Returns True.

    python -m tf_geometric_tpu_torch.demos.demo_save_and_load_model            # on the card
    python -m tf_geometric_tpu_torch.demos.demo_save_and_load_model --cpu

Each of the two evaluations launches Kernel A (``csrc/csr_spmm.cu``) twice
on the card, at F = 16 and F = C.
"""
from __future__ import annotations

import contextlib
import os
import sys
import tempfile
from typing import Optional

import numpy as np
import torch

from .demo_checkpoint import build_model
from .demo_utils import load_cora

__all__ = ["main"]


def main(device="cuda", stats: Optional[dict] = None, directory: Optional[str] = None):
    """Round-trip the weights; returns True when the logits agree. The file
    goes under ``directory`` (kept), or a temporary directory (removed).
    ``stats``, when given, receives ``logits`` (after loading), ``path``,
    ``file_bytes``, ``steps`` (0) and ``evals`` (2)."""
    graph, _ = load_cora(device=device)
    num_classes = int(graph.y.max()) + 1
    model, forward = build_model(graph, num_classes, 0, device)
    model.eval()
    with torch.no_grad():
        before = forward(False)
    keep = contextlib.nullcontext(directory) if directory else tempfile.TemporaryDirectory()
    with keep as root:
        path = os.path.join(root, "gcn_weights.pt")
        torch.save(model.state_dict(), path)
        print(f"saved weights to {path}")
        file_bytes = os.path.getsize(path)
        fresh, fresh_forward = build_model(graph, num_classes, 42, device)
        fresh.load_state_dict(torch.load(path, map_location=before.device, weights_only=True))
    fresh.eval()
    with torch.no_grad():
        after = fresh_forward(False)
    np.testing.assert_allclose(before.cpu().numpy(), after.cpu().numpy(), rtol=1e-6)
    print("loaded weights reproduce identical outputs")
    if stats is not None:
        stats.update(logits=after, path=path, file_bytes=file_bytes, steps=0, evals=2)
    return True


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in sys.argv[1:] else "cuda")
