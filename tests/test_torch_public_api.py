"""The public-API check: every public name of every ``tf_geometric_tpu``
module has a counterpart in the port, or an entry in one by-design list
with its reason.

The JAX modules are read by AST, never imported (importing any of them
loads JAX): a module's public names are its ``__all__``, or else its
top-level functions, classes and assignments without a leading
underscore. The port's module of the same path (or the one ``MODULE_MAP``
names) must have an attribute of the same name, or the counterpart
``RENAMED`` gives. The last tests hold the three names mapped for this
check, ``ops.spmm_xla``, ``ops.sddmm_xla`` and ``ops.ell_spmm_multihead``,
against the JAX package (JAX is imported inside those tests only).
"""
import ast
import importlib
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
JAX_PKG = REPO / "tf_geometric_tpu"

# JAX modules whose port counterpart has another path
MODULE_MAP = {
    "ops.ell_bucketed": "ops.csr_spmm",
    "ops.ell_attention": "ops.gat_attention",
    "ops.ell_attention_bucketed": "ops.gat_attention",
    "ops.pallas_segment": "ops.sorted_segment",
    "utils.jax_utils": "utils.torch_utils",
}

# (JAX module, name) -> "port module:attribute" of another name
RENAMED = {
    ("ops", "bucketed_spmm"): "ops.csr_spmm:csr_spmm",
    ("ops.ell_bucketed", "bucketed_spmm"): "ops.csr_spmm:csr_spmm",
    ("ops", "build_gat_layout"): "ops.gat_attention:CsrGatLayout.build",
    ("ops.ell_attention", "build_gat_layout"): "ops.gat_attention:CsrGatLayout.build",
    ("ops", "build_gat_layout_bucketed"): "ops.gat_attention:CsrGatLayout.build",
    ("ops.ell_attention_bucketed", "build_gat_layout_bucketed"):
        "ops.gat_attention:CsrGatLayout.build",
    ("ops", "gat_attention_bucketed"): "ops.gat_attention:gat_attention_csr",
    ("ops.ell_attention_bucketed", "gat_attention_bucketed"):
        "ops.gat_attention:gat_attention_csr",
    ("ops.pallas_segment", "pallas_sorted_segment_sum"): "ops.sorted_segment:sorted_segment_sum",
    ("ops.pallas_segment", "sorted_segment_sum_mxu"): "ops.sorted_segment:sorted_segment_sum",
}

_ELL = "the ELL / degree-bucket layouts were tuned to TPU costs; the port runs CSR (CsrAdj)"
_GAT_ELL = "the ELL attention layouts were tuned to TPU costs; the port runs CsrGatLayout"
_KNOB = "an ops/config.py knob tuned to TPU costs; only ell_compute_dtype is ported"
_HALO = ("packs halo plans for shard_map; the port's ranks take prebuilt per-rank CSR plans "
         "(rank_halo_plan, rank_gat_plan)")

# (JAX module, name) -> why the port has no counterpart
BY_DESIGN = {
    ("ops", "EllAdj"): _ELL,
    ("ops.ell", "EllAdj"): _ELL,
    ("ops", "build_ell_arrays"): _ELL,
    ("ops.ell", "build_ell_arrays"): _ELL,
    ("ops", "BucketedEllAdj"): _ELL,
    ("ops.ell_bucketed", "BucketedEllAdj"): _ELL,
    ("ops.ell_bucketed", "SLOT_NS"): _ELL + " (a bucket packing's name space)",
    ("ops.ell_bucketed", "TAIL_NS"): _ELL + " (a bucket packing's name space)",
    ("ops.ell_bucketed", "UNPERM_NS"): _ELL + " (a bucket packing's name space)",
    ("ops", "GatEllLayout"): _GAT_ELL,
    ("ops.ell_attention", "GatEllLayout"): _GAT_ELL,
    ("ops", "BucketedGatLayout"): _GAT_ELL,
    ("ops.ell_attention_bucketed", "BucketedGatLayout"): _GAT_ELL,
    ("ops.pallas_segment", "plan_sorted_segments"):
        "the Pallas kernel's chunk plan; Kernel B takes a segment pointer instead",
    **{("ops.config", name): _KNOB for name in (
        "ell_attention_unroll_transpose", "set_ell_attention_unroll_transpose",
        "ell_attention_unroll_all", "set_ell_attention_unroll_all",
        "ell_attention_recompute_transpose", "set_ell_attention_recompute_transpose",
        "ell_attention_transpose_scatter", "set_ell_attention_transpose_scatter",
        "ell_layout", "set_ell_layout", "ell_attention_save_lanes",
        "set_ell_attention_save_lanes")},
    **{("parallel.halo", name): _HALO for name in (
        "EllShard", "GatHaloSpecEll", "ell_plan_arrays", "ell_plan_specs", "gat_plan_arrays",
        "gat_plan_specs")},
    ("layers.base", "zeros_init"): "a flax initializer; torch modules zero their biases",
    ("native", "ell_pack"): "the host ELL packer; the port builds CSR with sort_by_row",
    ("utils.union_utils", "is_jax_array"): "there are no JAX arrays in the port",
}


def _module_name(path: Path) -> str:
    parts = list(path.relative_to(JAX_PKG).with_suffix("").parts)
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def _public_names(path: Path):
    """``__all__``, or the top-level public functions, classes and
    assignments, of a source file, read by AST."""
    tree = ast.parse(path.read_text(encoding="utf-8"))
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets):
            return [ast.literal_eval(e) for e in node.value.elts]
    names = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.append(node.name)
        elif isinstance(node, ast.Assign):
            names += [t.id for t in node.targets if isinstance(t, ast.Name)]
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.append(node.target.id)
    return [n for n in names if not n.startswith("_")]


def _jax_public_api():
    return {(_module_name(p), name) for p in sorted(JAX_PKG.rglob("*.py"))
            for name in _public_names(p)}


def _port_attr(spec: str):
    module, _, attr = spec.partition(":")
    obj = importlib.import_module(f"tf_geometric_tpu_torch{'.' + module if module else ''}")
    for part in attr.split("."):
        obj = getattr(obj, part)
    return obj


def _has_counterpart(module: str, name: str) -> bool:
    """Whether the port has an object for (JAX module, name) (a module
    constant that is None counts)."""
    try:
        _port_attr(RENAMED.get((module, name), f"{MODULE_MAP.get(module, module)}:{name}"))
    except (ImportError, AttributeError):
        return False
    return True


def test_every_public_jax_name_has_a_counterpart_or_a_reason():
    missing = sorted(f"{m}.{n}" for m, n in _jax_public_api()
                     if (m, n) not in BY_DESIGN and not _has_counterpart(m, n))
    assert not missing, f"no torch counterpart and no by-design entry: {missing}"


def test_the_lists_hold_only_what_the_walk_needs():
    api = _jax_public_api()
    assert not set(BY_DESIGN) - api, sorted(set(BY_DESIGN) - api)
    assert not set(RENAMED) - api, sorted(set(RENAMED) - api)
    # a by-design name the port does have under the same name belongs nowhere
    same_name = sorted(f"{m}.{n}" for m, n in BY_DESIGN if _has_counterpart(m, n))
    assert not same_name, same_name
    assert all(isinstance(r, str) and r for r in BY_DESIGN.values())
    for key, spec in RENAMED.items():
        assert callable(_port_attr(spec)), key


def test_the_walk_reads_all_and_modules_without_it():
    api = _jax_public_api()
    assert ("ops.spmm", "spmm_xla") in api and ("nn.conv.gcn", "gcn") in api
    assert ("ops.config", "ell_layout") in api  # a module without __all__
    assert ("ops.config", "_DEFAULT") not in api and len(api) > 300


def _coo(seed=0, n=9, e=30, f=5):
    rng = np.random.default_rng(seed)
    index = rng.integers(0, n, (2, e)).astype(np.int32)
    index[0, -3:] = n          # padded edges: out-of-range rows drop out
    index[1, -2:] = n + 4      # out-of-range columns read the clamped row
    value = rng.normal(size=e).astype(np.float32)
    h = rng.normal(size=(n, f)).astype(np.float32)
    return index, value, h


def test_spmm_xla_matches_jax():
    import jax
    import jax.numpy as jnp
    from tf_geometric_tpu.ops.spmm import spmm_xla as jspmm_xla
    from tf_geometric_tpu_torch.ops import spmm_xla
    index, value, h = _coo()
    dy = np.random.default_rng(1).normal(size=(9, 5)).astype(np.float32)
    want, vjp = jax.vjp(lambda v, x: jspmm_xla(jnp.asarray(index), v, x, 9),
                        jnp.asarray(value), jnp.asarray(h))
    dv, dh = vjp(jnp.asarray(dy))
    tv, th = (torch.tensor(a, requires_grad=True) for a in (value, h))
    got = spmm_xla(torch.as_tensor(index), tv, th, 9)
    got.backward(torch.as_tensor(dy))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tv.grad.numpy(), np.asarray(dv), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(dh), rtol=1e-5, atol=1e-6)


def test_sddmm_xla_matches_jax():
    import jax.numpy as jnp
    from tf_geometric_tpu.ops.spmm import sddmm_xla as jsddmm_xla
    from tf_geometric_tpu_torch.ops import sddmm_xla
    index, _, a = _coo(2)
    b = np.random.default_rng(3).normal(size=a.shape).astype(np.float32)
    want = jsddmm_xla(jnp.asarray(index), jnp.asarray(a), jnp.asarray(b))
    got = sddmm_xla(torch.as_tensor(index), torch.as_tensor(a), torch.as_tensor(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("heads,d", [(1, 3), (8, 2)])
def test_ell_spmm_multihead_is_the_multihead_spmm(heads, d):
    from tf_geometric_tpu_torch import ops
    from tf_geometric_tpu_torch.ops.gat_attention import CsrGatLayout
    from tf_geometric_tpu_torch.ops.spmm_heads import spmm_multihead
    assert ops.ell_spmm_multihead is ops.ell.ell_spmm_multihead is spmm_multihead
    rng = np.random.default_rng(heads)
    n, e = 12, 40
    ei = np.stack([np.sort(rng.integers(0, n, e)), rng.integers(0, n, e)]).astype(np.int64)
    layout = CsrGatLayout.build(ei, n, device="cpu")
    att = torch.as_tensor(rng.random((e, heads)).astype(np.float32))
    v = torch.as_tensor(rng.normal(size=(n, heads * d)).astype(np.float32))
    got = ops.ell_spmm_multihead(layout, att, v, d)
    want = torch.zeros(n, heads, d).index_add_(
        0, torch.as_tensor(ei[0]),
        att[:, :, None] * v.reshape(n, heads, d)[torch.as_tensor(ei[1])])
    torch.testing.assert_close(got, want.reshape(n, heads * d), rtol=1e-5, atol=1e-6)
