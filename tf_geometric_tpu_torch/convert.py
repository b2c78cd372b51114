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
           "sharded_params_from_numpy", "sampled_sage_params_from_jax",
           "propagation_state_dict_from_flax", "pool_model_state_dict_from_flax",
           "lstm_cell_state_dict_from_flax", "lstm_cell_state_dict_from_keras",
           "tagcn_model_state_dict_from_flax", "chebynet_state_dict_from_flax",
           "dgi_state_dict_from_flax", "gae_encoder_state_dict_from_flax",
           "topk_pool_model_state_dict_from_flax",
           "numpy_params_state_dict", "adam_state_from_optax",
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


def _flatten_params(params: Mapping, prefix: str = "") -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in params.items():
        if isinstance(v, Mapping):
            out.update(_flatten_params(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = torch.tensor(np.asarray(v, np.float32))
    return out


def _state_dict_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """The params tree flattened to dotted names (``GCN_0/kernel`` becomes
    ``GCN_0.kernel``), each leaf a float32 tensor."""
    return _flatten_params(variables["params"])


def gcn_state_dict_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """A flax ``GCN`` layer's ``{"params": {"kernel", "bias"}}`` as a
    ``state_dict`` for the port's ``layers.GCN``; both keep the kernel
    layout [in, units]. A model's tree of such layers (the demo's
    ``GCN_0``, ``GCN_1``) gives dotted names, for a module whose
    submodules carry the flax names (``demos.demo_gcn.GCNModel``)."""
    return _state_dict_from_flax(variables)


def gat_state_dict_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """A flax ``GAT`` layer's params (``query_kernel``, ``query_bias``,
    ``key_kernel``, ``key_bias``, ``kernel`` and ``bias``) as a
    ``state_dict`` for the port's ``layers.GAT``, whose parameters carry the
    same names and shapes; a model's tree of such layers gives dotted names
    (``demos.demo_gat.GATModel``)."""
    return _state_dict_from_flax(variables)


def propagation_state_dict_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """A flax ``SGC``, ``TAGCN``, ``APPNP``, ``SSGC``, ``ChebyNet`` or
    ``LEConv`` layer's params (``kernel``/``bias``; ``kernel_i``/``bias_i``;
    ``self_kernel``, ``aggr_self_kernel``, ``aggr_neighbor_kernel`` and their
    biases) as a ``state_dict`` for the port's layer of the same name, whose
    parameters carry the same names and [in, units] layouts."""
    return _state_dict_from_flax(variables)


def lstm_cell_state_dict_from_flax(cell: Mapping, prefix: str = "") -> Dict[str, torch.Tensor]:
    """A flax ``OptimizedLSTMCell``'s params (input kernels ``ii if ig io``
    [in, H] without bias, hidden kernels ``hi hf hg ho`` [H, H] with bias) as
    a ``torch.nn.LSTMCell``'s (or an ``nn.LSTM`` layer's, with ``prefix``
    ``"lstm."`` and the ``_l0`` suffix added by the caller) ``weight_ih``
    [4H, in], ``weight_hh`` [4H, H], ``bias_hh`` [4H] and a zero
    ``bias_ih``, keyed ``prefix + name``."""

    def gates(side, leaf):
        blocks = [np.asarray(cell[side + g][leaf], np.float32) for g in _LSTM_GATES]
        return np.concatenate([b.T if leaf == "kernel" else b for b in blocks], axis=0)

    bias_hh = gates("h", "bias")
    return {prefix + "weight_ih": torch.tensor(gates("i", "kernel")),
            prefix + "weight_hh": torch.tensor(gates("h", "kernel")),
            prefix + "bias_ih": torch.zeros(bias_hh.shape[0]),
            prefix + "bias_hh": torch.tensor(bias_hh)}


def lstm_cell_state_dict_from_keras(kernel, recurrent_kernel, bias,
                                    prefix: str = "") -> Dict[str, torch.Tensor]:
    """A Keras ``LSTM``'s ``W`` [in, 4H], ``U`` [H, 4H] and ``b`` [4H] (gate
    blocks i, f, c, o: torch's i, f, g, o) as a ``torch.nn.LSTMCell``'s
    weights, ``bias_hh`` zero, keyed ``prefix + name``."""
    bias = np.asarray(bias, np.float32)
    return {prefix + "weight_ih": torch.tensor(np.asarray(kernel, np.float32).T.copy()),
            prefix + "weight_hh": torch.tensor(np.asarray(recurrent_kernel, np.float32).T.copy()),
            prefix + "bias_ih": torch.tensor(bias),
            prefix + "bias_hh": torch.zeros(bias.shape[0])}


def sage_state_dict_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """A flax GraphSAGE layer's params as a ``state_dict`` for the port's
    layer of the same name. The kernels and biases keep their names and
    [in, out] layout. ``LSTMGraphSage``'s cell (``OptimizedLSTMCell_0``)
    becomes ``lstm.weight_ih_l0``, ``lstm.weight_hh_l0``, ``lstm.bias_hh_l0``
    and a zero ``lstm.bias_ih_l0`` (``lstm_cell_state_dict_from_flax``)."""
    params = variables["params"]
    out = {k: torch.tensor(np.asarray(v, np.float32)) for k, v in params.items()
           if not isinstance(v, Mapping)}
    cells = [v for v in params.values() if isinstance(v, Mapping)]
    if cells:
        out.update({k + "_l0": v
                    for k, v in lstm_cell_state_dict_from_flax(cells[0], "lstm.").items()})
    return out


def pool_model_state_dict_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """The params of the pooling demos' models (``demo/demo_diff_pool.py``,
    ``demo_min_cut_pool.py``, ``demo_sag_pool_h.py``, ``demo_asap.py``,
    ``demo_set2set.py``; also ``demo_graph_sage.py``'s ``SageNet``) as a
    ``state_dict`` for the port's twin in ``bench`` (``POOL_MODELS``) or
    ``demos``, whose submodules carry the flax names: a
    ``Dense_i`` kernel [in, out] becomes a ``torch.nn.Linear`` weight [out,
    in]; a ``Set2Set``'s ``OptimizedLSTMCell_0`` its ``cell``
    (``lstm_cell_state_dict_from_flax``); every other leaf (GCN kernels and
    biases, the pools' biases, ASAP's 12 tensors, the SAGE layers' kernels
    and biases) keeps its name and layout."""
    out = {}
    for name, module in variables["params"].items():
        if name.startswith("Dense_"):
            out[f"{name}.weight"] = torch.tensor(np.asarray(module["kernel"], np.float32).T)
            out[f"{name}.bias"] = torch.tensor(np.asarray(module["bias"], np.float32))
        elif "OptimizedLSTMCell_0" in module:
            out.update(lstm_cell_state_dict_from_flax(module["OptimizedLSTMCell_0"],
                                                      f"{name}.cell."))
        else:
            out.update({f"{name}.{k}": torch.tensor(np.asarray(v, np.float32))
                        for k, v in module.items()})
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
    (w_out, b_out))``, ``make_graph_parallel_gat_fused_step``'s
    ``([(wq, bq, wk, bk, wv, bias), ...], (w_out, b_out))``,
    ``make_graph_parallel_mincut_step``'s ``((w0, b0), (wa, ba), (wc, bc),
    (wo, bo))`` (encoder [F, H], assignment [F, C], coarse GCN [H, H], head
    [2H, classes]) and ``make_batch_2d_step``'s flat ``(w0, b0, wd, bd)``.
    Kernels keep their [in, out] layout (``h @ w``)."""
    if isinstance(params, (list, tuple)):
        return type(params)(sharded_params_from_numpy(p, device) for p in params)
    return torch.tensor(np.asarray(params, np.float32), device=device, requires_grad=True)


def sampled_sage_params_from_jax(params, device="cuda"):
    """The JAX sampled-SAGE step's parameters (``make_sampled_sage_step``'s
    list: per layer ``{"self", "nb", "bias"}``, then ``{"w", "b"}``; numpy
    or JAX arrays) as the port's step takes them: per layer ``(self, nb,
    bias)``, then ``(w, b)``, float32 leaf tensors on ``device`` that
    require grad."""
    *layers, head = params
    return sharded_params_from_numpy(
        [(layer["self"], layer["nb"], layer["bias"]) for layer in layers]
        + [(head["w"], head["b"])], device)


def tagcn_model_state_dict_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """``demo/demo_tagcn.py``'s ``TAGCNModel`` params (``TAGCN_0`` and
    ``TAGCN_1``, each ``kernel`` [(k + 1)·in, units] and ``bias``) as a
    ``state_dict`` for ``demos.demo_tagcn.TAGCNModel``, whose layers carry
    the same names and layouts."""
    return _state_dict_from_flax(variables)


def chebynet_state_dict_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """A flax ``ChebyNet`` layer's params (``kernel_i`` [in, units] per
    order, ``bias``) as a ``state_dict`` for the port's ``ChebyNet``."""
    return _state_dict_from_flax(variables)


def dgi_state_dict_from_flax(enc_params: Mapping, disc_params: Mapping
                             ) -> Dict[str, torch.Tensor]:
    """``demo/demo_dgi.py``'s encoder params (``GCN_0`` kernel and bias,
    ``prelu_alpha`` [1]) and discriminator params (``bilinear`` [64, 64])
    as a ``state_dict`` for ``demos.demo_dgi.DGIModel`` (``enc.*``,
    ``disc.*``: the demo's own keys of its params dict)."""
    return _flatten_params({"enc": enc_params, "disc": disc_params})


def gae_encoder_state_dict_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """``demo/demo_gae.py``'s ``GAEEncoder`` params (``GCN_0``, ``GCN_1``)
    as a ``state_dict`` for ``bench.GaeEncoder`` and the demo twin's
    ``GAEEncoder`` (``gcn0``, ``gcn1``; kernels keep [in, units])."""
    flat = _state_dict_from_flax(variables)
    return {k.replace("GCN_0.", "gcn0.").replace("GCN_1.", "gcn1."): v for k, v in flat.items()}


def topk_pool_model_state_dict_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """``demo/demo_topk_pool.py``'s ``TopKPoolModel`` params (``GCN_0``,
    the score ``GCN_1``, ``Dense_0``) as a ``state_dict`` for
    ``demos.demo_topk_pool.TopKPoolModel``: the ``Dense_0`` kernel [in, out]
    becomes a ``torch.nn.Linear`` weight [out, in]
    (``pool_model_state_dict_from_flax``'s rule)."""
    return pool_model_state_dict_from_flax(variables)


def numpy_params_state_dict(params: Mapping, prefix: str = "") -> Dict[str, torch.Tensor]:
    """A flat dict of arrays (the numpy-initialized demos' params: the
    sparse-feature GCN's ``w0 b0 w1 b1``, the sampling demos' kernels, the
    hetero demo's per-type and per-relation kernels) as float32 tensors
    keyed ``prefix + name`` (``"params."`` for the hetero twin's
    ``ParameterDict``)."""
    return {prefix + k: torch.tensor(np.asarray(v, np.float32)) for k, v in params.items()}


def _adam_leaves(state):
    """``(count, mu, nu)`` of an optax Adam state: a ``ScaleByAdamState``,
    a mapping with those keys (an orbax restore without a target), or a
    sequence holding one (``optax.adam``'s chain state)."""
    if isinstance(state, Mapping) and "mu" in state:
        return state["count"], state["mu"], state["nu"]
    if hasattr(state, "mu"):
        return state.count, state.mu, state.nu
    if isinstance(state, (list, tuple)):
        for item in state:
            found = _adam_leaves(item)
            if found is not None:
                return found
    return None


def adam_state_from_optax(opt_state, module: torch.nn.Module, learning_rate: float) -> dict:
    """An ``optax.adam(learning_rate)`` state (``count``, ``mu``, ``nu``:
    numpy, or anything with ``__array__``; see ``_adam_leaves`` for the
    forms taken) as a ``torch.optim.Adam(module.parameters(),
    lr=learning_rate)`` ``state_dict`` (the same β and ε defaults), ready
    for its ``load_state_dict``. ``mu``
    and ``nu`` are trees of ``module``'s parameters under the flax names
    (``GCN_0/kernel`` is ``GCN_0.kernel``), mapped by name. optax's
    ``count`` is the number of updates made, and each parameter's ``step``
    is the same number: both increment it before the bias correction
    ``1 - β^t``, so a restored run continues with the same step sizes."""
    found = _adam_leaves(opt_state)
    if found is None:
        raise ValueError("no Adam state (count, mu, nu) in opt_state")
    count, mu, nu = found
    mu, nu = _flatten_params(mu), _flatten_params(nu)
    names = [k for k, _ in module.named_parameters()]
    if sorted(names) != sorted(mu) or sorted(mu) != sorted(nu):
        raise KeyError(f"Adam moments {sorted(mu)} do not name the parameters {sorted(names)}")
    step = float(np.asarray(count))
    state = {i: {"step": torch.tensor(step), "exp_avg": mu[k], "exp_avg_sq": nu[k]}
             for i, k in enumerate(names)}
    group = torch.optim.Adam(module.parameters(), lr=learning_rate).state_dict()["param_groups"]
    return {"state": state, "param_groups": group}
