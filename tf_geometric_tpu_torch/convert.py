"""Carry weights from the JAX package to the port.

Both take numpy-convertible arrays (numpy, or anything with ``__array__``
such as a JAX array) and never import JAX.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

__all__ = ["bench_params_from_numpy", "gcn_state_dict_from_flax"]

BENCH_PARAM_NAMES = ("w0", "b0", "w1", "b1")


def bench_params_from_numpy(params: Mapping, device="cuda") -> Dict[str, torch.Tensor]:
    """The bench's ``{"w0", "b0", "w1", "b1"}`` dict as float32 leaf tensors
    on ``device`` that require grad (ready for ``torch.optim``)."""
    missing = set(BENCH_PARAM_NAMES) - set(params)
    if missing:
        raise KeyError(f"bench params lack {sorted(missing)}")
    return {k: torch.tensor(np.asarray(params[k], np.float32), device=device,
                            requires_grad=True)
            for k in BENCH_PARAM_NAMES}


def gcn_state_dict_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """A flax ``GCN`` layer's ``{"params": {"kernel", "bias"}}`` as a
    ``state_dict`` for the port's ``layers.GCN``; both keep the kernel
    layout [in, units]."""
    params = variables["params"]
    return {k: torch.tensor(np.asarray(v, np.float32)) for k, v in params.items()}
