"""Build the CUDA sources under ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/*.cu`` file is compiled on its own into a shared library with a
plain C interface (``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
-Xcompiler -fPIC``); the sources never include PyTorch's headers, so a build
takes seconds. All sources are compiled at once, one nvcc process each, at
the first use of any kernel. The libraries go to ``_build/<hash>/`` inside
the package (listed in ``.gitignore``), keyed by a hash of the sources and
flags, so an edited source is rebuilt and an unchanged one is reused.

A failed build raises ``RuntimeError`` with nvcc's output. Nothing here
falls back to another implementation.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence

__all__ = ["SOURCES", "build_all", "kernel_function", "header_constant"]

_PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = _PACKAGE_DIR / "csrc"
BUILD_ROOT = _PACKAGE_DIR / "_build"

SOURCES = ("csr_spmm.cu", "sorted_segment.cu", "gat_attention.cu", "fixed_k.cu",
           "spmm_heads.cu", "tiled_spmm.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
_BUILD_TIMEOUT_S = 600

_lock = threading.Lock()
_libraries: Dict[str, ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    candidates = []
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    for path in candidates:
        if os.path.isfile(path):
            return path
    raise RuntimeError("nvcc not found (neither under CUDA_HOME nor on PATH): "
                       "the CUDA kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC_DIR.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _library_name(source: str) -> str:
    return "lib" + Path(source).stem + ".so"


def build_all() -> Dict[str, Path]:
    """Compile every source that has no library for the current hash yet,
    all nvcc processes at once; return {source: library path}."""
    with _lock:
        out_dir = BUILD_ROOT / _digest()
        paths = {src: out_dir / _library_name(src) for src in SOURCES}
        missing = [src for src in SOURCES if not paths[src].exists()]
        if not missing:
            return paths
        out_dir.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        jobs = []
        for src in missing:
            tmp = paths[src].with_name(f"{paths[src].name}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(tmp),
                   str(CSRC_DIR / src)]
            jobs.append((src, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failures = []
        for src, tmp, proc in jobs:
            try:
                log, _ = proc.communicate(timeout=_BUILD_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                proc.kill()
                log, _ = proc.communicate()
                failures.append(f"{src}: nvcc timed out after {_BUILD_TIMEOUT_S} s\n{log}")
                continue
            build_logs[src] = log
            if proc.returncode != 0:
                failures.append(f"{src}: nvcc exited {proc.returncode}\n{log}")
            else:
                os.replace(tmp, paths[src])
        if failures:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
        return paths


def header_constant(header: str, name: str) -> int:
    """The value of ``constexpr int <name> = <value>;`` in ``csrc/<header>``:
    a number the kernels and the host code must agree on, kept in one place
    (read on any machine, no build needed)."""
    text = (CSRC_DIR / header).read_text()
    found = re.findall(rf"constexpr int {name} = (\d+);", text)
    if len(found) != 1:
        raise RuntimeError(f"csrc/{header} must define constexpr int {name} once")
    return int(found[0])


def kernel_function(source: str, symbol: str, argtypes: Sequence, restype=ctypes.c_int):
    """The C entry ``symbol`` of ``source``'s library, with argtypes set
    (pointers and the stream as ``c_void_p``, so none is cut to 32 bits)
    and, by default, an int return (the ``cudaError_t`` of the launch)."""
    lib = _libraries.get(source)
    if lib is None:
        lib = ctypes.CDLL(str(build_all()[source]))
        _libraries[source] = lib
    fn = getattr(lib, symbol)
    fn.argtypes = list(argtypes)
    fn.restype = restype
    return fn
