"""Carry weights from the JAX package to the port.

Each takes numpy-convertible arrays (numpy, or anything with ``__array__``
such as a JAX array) and never imports JAX.
"""
from __future__ import annotations

from typing import Dict, Mapping, Sequence

import numpy as np
import torch

__all__ = ["bench_params_from_numpy", "gcn_state_dict_from_flax", "gat_state_dict_from_flax",
           "sage_state_dict_from_flax", "gin_classifier_state_dict_from_flax",
           "sharded_params_from_numpy", "propagation_state_dict_from_flax",
           "BENCH_PARAM_NAMES", "GAT_BENCH_PARAM_NAMES", "SAGE_BENCH_PARAM_NAMES"]

BENCH_PARAM_NAMES = ("w0", "b0", "w1", "b1")
GAT_BENCH_PARAM_NAMES = ("wq", "bq", "wk", "bk", "wv", "wd", "bd")
# benchmarks/sage_sampling_throughput.py's params: self and neighbour kernels
# of both layers, then the dense layer to the classes (no biases)
SAGE_BENCH_PARAM_NAMES = ("s0", "n0", "s1", "n1", "wd")
# flax OptimizedLSTMCell gates, in torch.nn.LSTM's row-block order (i, f, g, o)
_LSTM_GATES = ("i", "f", "g", "o")


def bench_params_from_numpy(params: Mapping, device="cuda",
                            names: Sequence[str] = BENCH_PARAM_NAMES) -> Dict[str, torch.Tensor]:
    """A bench parameter dict (the GCN's ``w0 b0 w1 b1`` by default, or
    ``GAT_BENCH_PARAM_NAMES``, ``SAGE_BENCH_PARAM_NAMES``) as float32 leaf tensors on ``device`` that
    require grad (ready for ``torch.optim``), in the order of ``names``."""
    missing = set(names) - set(params)
    if missing:
        raise KeyError(f"bench params lack {sorted(missing)}")
    return {k: torch.tensor(np.asarray(params[k], np.float32), device=device,
                            requires_grad=True)
            for k in names}


def _state_dict_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    return {k: torch.tensor(np.asarray(v, np.float32))
            for k, v in variables["params"].items()}


def gcn_state_dict_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """A flax ``GCN`` layer's ``{"params": {"kernel", "bias"}}`` as a
    ``state_dict`` for the port's ``layers.GCN``; both keep the kernel
    layout [in, units]."""
    return _state_dict_from_flax(variables)


def gat_state_dict_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """A flax ``GAT`` layer's params (``query_kernel``, ``query_bias``,
    ``key_kernel``, ``key_bias``, ``kernel`` and ``bias``) as a
    ``state_dict`` for the port's ``layers.GAT``, whose parameters carry the
    same names and shapes."""
    return _state_dict_from_flax(variables)


def propagation_state_dict_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """A flax ``SGC``, ``TAGCN``, ``APPNP``, ``SSGC``, ``ChebyNet`` or
    ``LEConv`` layer's params (``kernel``/``bias``; ``kernel_i``/``bias_i``;
    ``self_kernel``, ``aggr_self_kernel``, ``aggr_neighbor_kernel`` and their
    biases) as a ``state_dict`` for the port's layer of the same name, whose
    parameters carry the same names and [in, units] layouts."""
    return _state_dict_from_flax(variables)


def sage_state_dict_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """A flax GraphSAGE layer's params as a ``state_dict`` for the port's
    layer of the same name. The kernels and biases keep their names and
    [in, out] layout. ``LSTMGraphSage``'s cell (``OptimizedLSTMCell_0``: input
    kernels ``ii if ig io`` [in, H] without bias, hidden kernels ``hi hf hg
    ho`` [H, H] with bias) becomes ``lstm.weight_ih_l0`` [4H, in],
    ``lstm.weight_hh_l0`` [4H, H], ``lstm.bias_hh_l0`` [4H] and a zero
    ``lstm.bias_ih_l0``."""
    params = variables["params"]
    out = {k: torch.tensor(np.asarray(v, np.float32)) for k, v in params.items()
           if not isinstance(v, Mapping)}
    cells = [v for v in params.values() if isinstance(v, Mapping)]
    if cells:
        cell = cells[0]

        def gates(prefix, leaf):
            blocks = [np.asarray(cell[prefix + g][leaf], np.float32) for g in _LSTM_GATES]
            return np.concatenate([b.T if leaf == "kernel" else b for b in blocks], axis=0)

        bias_hh = gates("h", "bias")
        out.update({"lstm.weight_ih_l0": torch.tensor(gates("i", "kernel")),
                    "lstm.weight_hh_l0": torch.tensor(gates("h", "kernel")),
                    "lstm.bias_ih_l0": torch.zeros(bias_hh.shape[0]),
                    "lstm.bias_hh_l0": torch.tensor(bias_hh)})
    return out


def gin_classifier_state_dict_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """The params of ``benchmarks/graph_classification_throughput.py``'s
    ``GINSum`` and ``GINSort`` (``MLP_i/Dense_0``, ``MLP_i/Dense_1``, the
    trained ``GIN_i/eps`` when present, the head ``Dense_0``) as a
    ``state_dict`` for the port's ``bench.GinClassifier``
    (``gins.i.mlp_model.dense0``, ``dense1``, ``gins.i.eps``, ``head``). A
    flax ``Dense`` kernel [in, out] becomes a ``torch.nn.Linear`` weight
    [out, in]."""
    params = variables["params"]

    def linear(prefix, dense):
        return {f"{prefix}.weight": torch.tensor(np.asarray(dense["kernel"], np.float32).T),
                f"{prefix}.bias": torch.tensor(np.asarray(dense["bias"], np.float32))}

    out = {}
    i = 0
    while f"MLP_{i}" in params:
        for j in (0, 1):
            out.update(linear(f"gins.{i}.mlp_model.dense{j}", params[f"MLP_{i}"][f"Dense_{j}"]))
        if "eps" in params.get(f"GIN_{i}", {}):
            out[f"gins.{i}.eps"] = torch.tensor(np.asarray(params[f"GIN_{i}"]["eps"], np.float32))
        i += 1
    out.update(linear("head", params["Dense_0"]))
    return out


def sharded_params_from_numpy(params, device="cuda"):
    """The parameters of a JAX graph-parallel step (numpy, or JAX arrays
    through ``__array__``) as float32 leaf tensors on ``device`` that require
    grad, in the same nesting, for the port's step of the same name:
    ``make_graph_parallel_gcn_step``'s ``[(w, b), ...]``,
    ``make_graph_parallel_gat_step``'s ``((wq, bq, wk, bk, wv, bias),
    (w_out, b_out))`` and ``make_graph_parallel_gat_fused_step``'s
    ``([(wq, bq, wk, bk, wv, bias), ...], (w_out, b_out))``. Kernels keep
    their [in, out] layout (``h @ w``)."""
    if isinstance(params, (list, tuple)):
        return type(params)(sharded_params_from_numpy(p, device) for p in params)
    return torch.tensor(np.asarray(params, np.float32), device=device, requires_grad=True)
