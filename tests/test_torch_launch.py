"""The launch seam of the port's kernels (``ops/_launch.py``), on the CPU.

Every op chooses between its kernel and its plain version by one rule
(``use_kernel``): a CPU tensor takes the plain version, a device with no
kernel raises, and inside ``use_plain_versions()`` the plain version runs
on any device (meta tensors stand in for such a device). Each op reads the
flag once a call, so a backward follows its forward's choice. Launches are
counted only by ``_launch.launch``, under the families of
``LAUNCH_FAMILIES``; the rest of ``ops/`` holds no dtype-code table, stream
or ``cudaError`` check of its own."""
import ast
import contextlib
import ctypes
import re
import types
from pathlib import Path

import pytest
import torch

from tf_geometric_tpu_torch.ops import _launch
from tf_geometric_tpu_torch.ops import config
from tf_geometric_tpu_torch.ops import csr_spmm as cs
from tf_geometric_tpu_torch.ops import ell
from tf_geometric_tpu_torch.ops import fixed_k as fk
from tf_geometric_tpu_torch.ops import gat_attention as ga
from tf_geometric_tpu_torch.ops import sorted_segment as ss
from tf_geometric_tpu_torch.ops import spmm as tspmm
from tf_geometric_tpu_torch.ops import spmm_heads as sh
from tf_geometric_tpu_torch.ops import tiled_spmm as tsp
from tf_geometric_tpu_torch.utils.profiling import counters

PACKAGE = Path(__file__).resolve().parent.parent / "tf_geometric_tpu_torch"
EDGES = [[0, 1, 1, 2], [1, 0, 2, 1]]


class ReachedPlain(Exception):
    """Raised by a stand-in plain version: the op chose it."""


class ReachedKernel(Exception):
    """Raised by a stand-in kernel wrapper: the op chose it."""


def _raise(exc):
    def stand_in(*args, **kwargs):
        raise exc
    return stand_in


def _csr(device):
    return cs.CsrAdj.from_coo(EDGES, None, (3, 3), device=device)


def _csr_spmm(device):
    return cs.csr_spmm(_csr(device), torch.ones(3, 4, device=device))


def _ell_spmm(device):
    values = torch.ones(4, device=device, requires_grad=True)
    return ell.ell_spmm(ell.with_edge_values(_csr(device), values),
                        torch.ones(3, 4, device=device), diff_values=True)


def _gat(device):
    layout = ga.CsrGatLayout.build(EDGES, 3, device=device)
    q = torch.ones(3, 8, device=device)
    return ga.gat_attention_csr(layout, q, q, q, 2)


def _draw_csr(device):
    ints = torch.zeros(3, dtype=torch.int32, device=device)
    return {"row_start": ints, "degree": ints + 1, "sorted_col": ints}


def _draw(device):
    return fk.draw_fixed_k_from_ints(torch.zeros((2, 3), dtype=torch.int32, device=device),
                                     _draw_csr(device))


def _aggregate(device):
    return fk.fixed_k_aggregate(torch.ones(3, 4, device=device),
                                torch.zeros((2, 3), dtype=torch.int32, device=device),
                                torch.ones(2, 3, device=device))


def _multihead(device):
    layout = ga.CsrGatLayout.build(EDGES, 3, device=device)
    return sh.spmm_multihead(layout, torch.ones(layout.num_edges, 2, device=device),
                             torch.ones(3, 8, device=device), 4)


def _coo_spmm(device):
    return tspmm.spmm(torch.tensor(EDGES, device=device), torch.ones(4, device=device),
                      torch.ones(3, 4, device=device), 3)


def _sddmm(device):
    x = torch.ones(3, 4, device=device)
    return tspmm.sddmm(torch.tensor(EDGES, device=device), x, x)


def _tiled_packing(device):
    ts = tsp.build_tiled_spmm(EDGES, None, (3, 3), tile=16, device="cpu")
    return ts._replace(**{f: getattr(ts, f).to(device) for f in (
        "row_tile", "col_tile", "a_tiles", "row_ptr", "t_row_tile", "t_col_tile", "t_a_tiles",
        "t_row_ptr")})


def _tiled(device):
    return tsp.tiled_spmm(_tiled_packing(device), torch.ones(3, 4, device=device))


def _segment(device):
    return ss.segment_sum_csr(torch.ones(4, 3, device=device),
                              torch.tensor([0, 1, 4], dtype=torch.int32, device=device))


# op: (call, its error's words, (module, kernel wrapper), (module, plain version))
OPS = {
    "csr_spmm": (_csr_spmm, "CSR SpMM", (cs, "launch_csr_spmm"), (cs, "side_matmul_plain")),
    "ell_spmm": (_ell_spmm, "CSR SpMM", (cs, "launch_csr_spmm"), (cs, "side_matmul_plain")),
    "gat_attention": (_gat, "GAT attention", None, None),
    "fixed_k_draw": (_draw, "fixed-k draw", (fk, "launch_draw_fixed_k"),
                     (fk, "draw_fixed_k_plain")),
    "fixed_k_aggregate": (_aggregate, "fixed-k aggregation", (fk, "launch_fixed_k_forward"),
                          (fk, "fixed_k_forward_plain")),
    "spmm_multihead": (_multihead, "H-head SpMM", (sh, "launch_spmm_heads"),
                       (sh, "spmm_heads_plain")),
    "coo_spmm": (_coo_spmm, "H-head SpMM", (sh, "launch_spmm_heads"), (sh, "spmm_heads_plain")),
    "sddmm": (_sddmm, "H-head SDDMM", (sh, "launch_sddmm_heads"), (sh, "sddmm_heads_plain")),
    "tiled_spmm": (_tiled, "tiled SpMM", (tsp, "launch_tiled_spmm"), (tsp, "tiled_spmm_plain")),
    "segment_sum_csr": (_segment, "sorted segment sum", (ss, "launch_sorted_segment_sum"),
                        (ss, "sorted_segment_sum_plain")),
}


@contextlib.contextmanager
def stand_ins(monkeypatch, op):
    """Replace ``op``'s kernel wrapper and plain version by functions that
    raise ``ReachedKernel`` / ``ReachedPlain``."""
    _, _, kernel, plain = OPS[op]
    if op == "gat_attention":
        monkeypatch.setattr(ga, "_KERNELS", (_raise(ReachedKernel),) * 3)
        monkeypatch.setattr(ga, "_PLAIN", (_raise(ReachedPlain),) * 3)
    else:
        monkeypatch.setattr(*kernel, _raise(ReachedKernel))
        monkeypatch.setattr(*plain, _raise(ReachedPlain))
    yield


@pytest.mark.parametrize("op", sorted(OPS))
def test_cpu_tensors_take_the_plain_version(op, monkeypatch):
    before = counters()
    with stand_ins(monkeypatch, op), pytest.raises(ReachedPlain):
        OPS[op][0]("cpu")
    assert _launch.kernel_launch_counts() == {
        k: before.get(f"launches.{k}", 0) for k in _launch.LAUNCH_FAMILIES}


@pytest.mark.parametrize("op", sorted(OPS))
def test_a_device_without_a_kernel_raises_naming_the_op(op, monkeypatch):
    with stand_ins(monkeypatch, op), pytest.raises(NotImplementedError,
                                                   match=f"no {OPS[op][1]} kernel for device meta"):
        OPS[op][0]("meta")


@pytest.mark.parametrize("op", sorted(OPS))
def test_plain_versions_run_on_any_device(op, monkeypatch):
    with stand_ins(monkeypatch, op), config.use_plain_versions(), pytest.raises(ReachedPlain):
        OPS[op][0]("meta")


def test_use_kernel_is_one_rule():
    cuda = types.SimpleNamespace(is_cuda=True, device=torch.device("cuda"))
    cpu, meta = torch.ones(1), torch.ones(1, device="meta")
    assert _launch.use_kernel(cuda, False, "x")
    assert not _launch.use_kernel(cuda, True, "x")
    assert not _launch.use_kernel(cpu, False, "x") and not _launch.use_kernel(cpu, True, "x")
    assert not _launch.use_kernel(meta, True, "x")
    with pytest.raises(NotImplementedError, match="no some op kernel for device meta"):
        _launch.use_kernel(meta, False, "some op")


def test_tiled_backward_follows_its_forwards_plain_choice(monkeypatch):
    """The forward runs inside ``use_plain_versions()`` on meta tensors and
    the backward after the block: both passes take the plain version."""
    real, passes = tsp.tiled_spmm_plain, []

    def recorded(*args):
        passes.append(args[3].shape)
        return real(*args)

    monkeypatch.setattr(tsp, "tiled_spmm_plain", recorded)
    h = torch.ones(3, 4, device="meta", requires_grad=True)
    with config.use_plain_versions():
        out = tsp.tiled_spmm(_tiled_packing("meta"), h)
    out.sum().backward()
    assert passes == [(3, 4), (3, 4)] and h.grad.shape == (3, 4)


def test_launch_refuses_a_family_outside_the_registry():
    with pytest.raises(ValueError, match="not in LAUNCH_FAMILIES"):
        _launch.launch("csr_spmm.cu", "tfg_csr_spmm", [], (), torch.device("cpu"), "nobody")
    assert len(_launch.LAUNCH_FAMILIES) == 11


@pytest.fixture
def fake_card(monkeypatch):
    """``launch`` on the CPU: no device guard, a stream handle of 7, and C
    entries that record their arguments and return ``fake_card.rc``."""
    card = types.SimpleNamespace(rc=0, calls=[], lookups=[])

    def kernel_function(source, symbol, argtypes, restype=ctypes.c_int):
        card.lookups.append((source, symbol, list(argtypes), restype))
        return lambda *args: card.calls.append((symbol, args)) or card.rc

    monkeypatch.setattr(_launch, "_entries", {})
    monkeypatch.setattr(_launch._build, "kernel_function", kernel_function)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(cuda_stream=7))
    return card


def test_launch_appends_the_stream_and_counts_its_family(fake_card):
    before = _launch.kernel_launch_counts()
    for _ in range(3):
        _launch.launch("fixed_k.cu", "tfg_x", [ctypes.c_int], (5,), "cpu", "fixed_k_draw")
    _launch.launch("fixed_k.cu", "tfg_y", [], (), "cpu", "spmm_heads", 2)
    assert fake_card.calls == [("tfg_x", (5, 7))] * 3 + [("tfg_y", (7,))]
    after = _launch.kernel_launch_counts()
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == {
        "fixed_k_draw": 3, "spmm_heads": 2}
    # each entry is looked up and typed once, the stream's type appended
    assert fake_card.lookups == [
        ("fixed_k.cu", "tfg_x", [ctypes.c_int, ctypes.c_void_p], ctypes.c_int),
        ("fixed_k.cu", "tfg_y", [ctypes.c_void_p], ctypes.c_int)]


def test_launch_counts_what_the_entry_reports_after_the_call(fake_card, monkeypatch):
    launched = ctypes.c_int(0)

    def kernel_function(source, symbol, argtypes, restype=ctypes.c_int):
        def fn(*args):
            launched.value = 6
            return 0
        return fn

    monkeypatch.setattr(_launch._build, "kernel_function", kernel_function)
    before = _launch.kernel_launch_counts()["fixed_k_backward"]
    _launch.launch("fixed_k.cu", "tfg_w", [], (), "cpu", "fixed_k_backward",
                   lambda: launched.value)
    assert _launch.kernel_launch_counts()["fixed_k_backward"] - before == 6


def test_a_failed_launch_raises_and_counts_nothing(fake_card):
    fake_card.rc = 2
    before = _launch.kernel_launch_counts()
    with pytest.raises(RuntimeError, match=r"tfg_v kernel launch failed: cudaError 2"):
        _launch.launch("csr_spmm.cu", "tfg_v", [], (), "cpu", "csr_spmm")
    with pytest.raises(RuntimeError, match=r"tfg_info failed: cudaError 2"):
        _launch.query("csr_spmm.cu", "tfg_info", [], ())
    assert _launch.kernel_launch_counts() == before


def _at_offset(dtype, elements, offset):
    """A tensor of ``elements`` whose base address is ``offset`` elements
    past a 512-byte aligned allocation."""
    return torch.zeros(elements + offset, dtype=dtype)[offset:]


@pytest.mark.parametrize("width,loaded,stored,want", [
    (256, (torch.float32, 0), (torch.float32, 0), 4),
    (41, (torch.float32, 0), (torch.float32, 0), 1),
    (6, (torch.float32, 0), (torch.float32, 0), 2),
    (256, (torch.bfloat16, 0), (torch.bfloat16, 0), 8),
    (256, (torch.float32, 1), (torch.float32, 0), 1),
    (256, (torch.float32, 2), (torch.float32, 0), 2),
    # a bfloat16 input and its float32 output (the fixed-k backward's d_src,
    # Kernel A's partials): the float32 vector of 8 is stored in 16-byte
    # pieces, so 16-byte alignment is enough
    (256, (torch.bfloat16, 0), (torch.float32, 4), 8),
    (256, (torch.bfloat16, 0), (torch.float32, 2), 2),
])
def test_lane_vector(width, loaded, stored, want):
    src = _at_offset(loaded[0], 4096, loaded[1])
    out = _at_offset(stored[0], 4096, stored[1])
    assert _launch.vec_elements(width, [src], [out]) == want


def test_max_vec_bytes():
    assert _launch.max_vec_bytes([torch.zeros(64)]) == 16
    assert _launch.max_vec_bytes([torch.zeros(64), _at_offset(torch.float32, 64, 2)]) == 8
    assert _launch.max_vec_bytes([_at_offset(torch.bfloat16, 64, 1)]) == 2


# ---------------------------------------------------------------------------
# the seam, read from the sources
# ---------------------------------------------------------------------------

def _ops_sources():
    return {p.name: p.read_text() for p in sorted((PACKAGE / "ops").glob("*.py"))}


@pytest.mark.parametrize("pattern,owners", [
    (r"torch\.cuda\.current_stream", ["_launch.py"]),
    (r"cudaError \{", ["_launch.py"]),
    (r"\bcount\(\s*f?[\"']launches\.", ["_launch.py"]),
    (r"torch\.float32\s*:\s*0", ["_launch.py"]),
    (r"LAUNCH_FAMILIES\s*=", ["_launch.py"]),
    (r"kernel_function\(", ["_build.py", "_launch.py"])])
def test_only_the_launch_module_holds(pattern, owners):
    """Under ``ops/``, only ``_launch.py`` takes the stream, checks a
    ``cudaError``, counts a launch, holds a dtype-code table or the
    registry, or looks up a C entry (``_build.py`` defines the lookup);
    the registry is defined nowhere else in the package."""
    found = [name for name, text in _ops_sources().items() if re.search(pattern, text)]
    assert found == owners
    if pattern.startswith("LAUNCH"):
        assert [p.name for p in PACKAGE.rglob("*.py") if re.search(pattern, p.read_text())] == [
            "_launch.py"]


def _families_launched(tree):
    """The family of every ``launch(...)`` call in a module: a string, or a
    parameter of the calling function resolved through the module's calls
    of that function."""
    parent = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parent[child] = node
    funcs = {f.name: f for f in ast.walk(tree) if isinstance(f, ast.FunctionDef)}

    def enclosing(node):
        while node in parent and not isinstance(node, ast.FunctionDef):
            node = parent[node]
        return node if isinstance(node, ast.FunctionDef) else None

    def calls(name):
        return [c for c in ast.walk(tree) if isinstance(c, ast.Call)
                and isinstance(c.func, ast.Name) and c.func.id == name]

    def argument(call, func, param):
        names = [a.arg for a in func.args.args]
        i = names.index(param)
        for kw in call.keywords:
            if kw.arg == param:
                return kw.value
        if i < len(call.args):
            return call.args[i]
        defaults = func.args.defaults
        return defaults[i - (len(names) - len(defaults))]

    def resolve(node, where):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            return [node.value]
        assert isinstance(node, ast.Name) and where is not None, ast.dump(node)
        return [v for call in calls(where.name)
                for v in resolve(argument(call, where, node.id), enclosing(call))]

    launch_def = ast.parse(Path(_launch.__file__).read_text())
    launch_fn = next(f for f in ast.walk(launch_def)
                     if isinstance(f, ast.FunctionDef) and f.name == "launch")
    found = []
    for call in calls("launch"):
        found += resolve(argument(call, launch_fn, "family"), enclosing(call))
    return found


def test_every_family_launched_is_in_the_registry():
    seen = set()
    for name, text in _ops_sources().items():
        if name == "_launch.py":
            continue
        families = _families_launched(ast.parse(text))
        assert set(families) <= set(_launch.LAUNCH_FAMILIES), (name, families)
        seen |= set(families)
    assert seen == set(_launch.LAUNCH_FAMILIES)
