"""Accuracy head-to-head of the port against the JAX package on the
hard-mode citation sets (JAX counterparts:
``benchmarks/node_classification/head_to_head_hard.py`` and
``head_to_head_arxiv.py``).

Cells: the 15 of {gcn, gat, appnp, sgc, ssgc} × {cora, citeseer, pubmed}
and ``gcn_arxiv``, ``sgc_arxiv``. Each cell trains the port's early-stop
twin on a fixed graph, ``HardCitationDataset(shape, seed=0, model=model)``
(built once per (model, shape) where ``_MODEL_DIFFICULTY`` has the key, per
shape otherwise, as the JAX harness keys it), for seeds 0..n-1 in this one
process. The JAX side is not rerun: its per-seed results are read, as data,
from ``benchmarks/node_classification/results_<cell>_hard.txt`` (the repo's
committed runs of the JAX scripts on the same sets). n defaults to that
file's seed count.

Output: ``head_to_head_port.json`` beside this file, per cell ``jax``,
``port``, both means and stds, ``delta``, the gate's bounds and verdict,
``device`` and the card (name and power limit as ``nvidia-smi`` prints
them). A rerun resumes from the seeds already in the file.

    python -m tf_geometric_tpu_torch.benchmarks.node_classification.head_to_head_port \
        [num_seeds] [cell ...] [--device cuda|cpu] [--out PATH]

``gate(jax, port)`` holds the port's mean to
``jax_mean - max(0.02, 2·SEM) <= port_mean <= jax_mean + max(0.02, 3·SEM)``
(SEM over both lists: ``tests/test_head_to_head_hard.py``'s rule and a
bound above, since a port far ahead of JAX computes something else) and
``port_mean >= 0.35`` (no collapse).
"""
from __future__ import annotations

import importlib
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence

import numpy as np

__all__ = ["MODELS", "SHAPES", "CELLS", "JAX_RESULTS_DIR", "OUT_PATH", "FLAT_TOL",
           "COLLAPSE", "read_results", "jax_results", "gate", "card_label", "cell_data", "twin",
           "load_json", "result_entry", "run_harness", "parse_command_line", "main"]

MODELS = ("gcn", "gat", "appnp", "sgc", "ssgc")
SHAPES = ("cora", "citeseer", "pubmed")
CELLS = tuple(f"{m}_{s}" for s in SHAPES for m in MODELS) + ("gcn_arxiv", "sgc_arxiv")
JAX_RESULTS_DIR = Path(__file__).resolve().parents[3] / "benchmarks" / "node_classification"
OUT_PATH = Path(__file__).resolve().parent / "head_to_head_port.json"
FLAT_TOL = 0.02
COLLAPSE = 0.35


def read_results(path) -> list:
    """The accuracies of a results file, one float a line (blank lines
    skipped), as the JAX harness reads them."""
    with open(path, encoding="utf-8") as f:
        return [float(v) for v in f.read().split()]


def jax_results(cell: str) -> list:
    """JAX's committed per-seed test@best of ``cell``."""
    return read_results(JAX_RESULTS_DIR / f"results_{cell}_hard.txt")


def gate(jax: Sequence[float], port: Sequence[float], flat: float = FLAT_TOL) -> dict:
    """The port's mean against JAX's: below by at most ``max(flat, 2·SEM)``,
    above by at most ``max(flat, 3·SEM)``, and at least ``COLLAPSE``. SEM is
    sqrt(var_jax/n_jax + var_port/n_port) (population variances). Returns
    the means, SEM, the two bounds, ``ok`` and the failed conditions."""
    jax, port = np.asarray(jax, np.float64), np.asarray(port, np.float64)
    if jax.size == 0 or port.size == 0:
        raise ValueError("gate needs at least one accuracy on each side")
    jax_mean, port_mean = float(jax.mean()), float(port.mean())
    sem = float(np.sqrt(jax.var() / jax.size + port.var() / port.size))
    lower = jax_mean - max(flat, 2.0 * sem)
    upper = jax_mean + max(flat, 3.0 * sem)
    failed = []
    if port_mean < lower:
        failed.append(f"port mean {port_mean:.4f} below {lower:.4f}")
    if port_mean > upper:
        failed.append(f"port mean {port_mean:.4f} above {upper:.4f}")
    if port_mean < COLLAPSE:
        failed.append(f"port mean {port_mean:.4f} below the collapse floor {COLLAPSE}")
    return dict(jax_mean=jax_mean, port_mean=port_mean, sem=sem, lower=lower, upper=upper,
                ok=not failed, failed=failed)


def card_label(device) -> str:
    """``nvidia-smi``'s name and power limit of the card (CUDA), else the
    device type."""
    if str(device).startswith("cuda"):
        try:
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                capture_output=True, text=True, timeout=60, check=True).stdout
            return out.strip().splitlines()[0]
        except (OSError, subprocess.SubprocessError):
            import torch
            return f"{torch.cuda.get_device_name(0)}, power limit not read"
    return str(device)


def cell_data(model: str, shape: str, device="cuda", cache: Optional[dict] = None):
    """``(graph, splits)`` of the cell's fixed hard graph on ``device``,
    memoized in ``cache`` by (model, shape) where the model has its own
    difficulty, by shape otherwise."""
    import torch
    from ...datasets.synthetic_citation import HardCitationDataset
    key = (model, shape) if (model, shape) in HardCitationDataset._MODEL_DIFFICULTY else shape
    if cache is not None and key in cache:
        return cache[key]
    graph, splits = HardCitationDataset(shape, seed=0, model=model).load_data()
    graph.convert_data_to_tensor(device=device)
    data = graph, tuple(torch.as_tensor(np.asarray(s, np.int64), device=device)
                        for s in splits)
    if cache is not None:
        cache[key] = data
    return data


def twin(model: str):
    """The early-stop twin module of ``model``."""
    return importlib.import_module(f"{__package__}.bench_node_cls_early_stop_{model}")


def load_json(path: Path) -> dict:
    """The harness's JSON at ``path``, or {} where there is none."""
    if path.exists():
        with open(path, encoding="utf-8") as f:
            return json.load(f)
    return {}


def result_entry(jax, port, device, card, seconds, flat: float = FLAT_TOL) -> dict:
    """A cell's record: both lists, their means and stds, the delta, the
    gate's bounds and verdict, the device, the card and a seed's seconds."""
    g = gate(jax, port, flat)
    return {"jax": list(jax), "port": list(port),
            "jax_mean": g["jax_mean"], "jax_std": float(np.std(jax)),
            "port_mean": g["port_mean"], "port_std": float(np.std(port)),
            "delta": g["port_mean"] - g["jax_mean"], "sem": g["sem"],
            "tolerance": {"lower": g["lower"], "upper": g["upper"], "flat": flat,
                          "collapse": COLLAPSE},
            "gate_ok": g["ok"], "device": str(device).split(":")[0], "card": card,
            "seconds_per_seed": seconds}


def run_harness(names: Sequence[str], jax_of: Callable, run_seed: Callable,
                num_seeds: Optional[int], device, out_path: Path,
                flat: float = FLAT_TOL) -> Dict[str, dict]:
    """For each name, run ``run_seed(name, seed) -> accuracy`` for the
    seeds ``out_path`` lacks up to ``num_seeds`` (default: JAX's count,
    ``len(jax_of(name))``), writing ``out_path`` after every seed; returns
    the entries. Seeds already in the file stay (a resume); a file whose
    seeds ran on another device is refused."""
    out = load_json(out_path)
    card = card_label(device)
    for name in names:
        jax = jax_of(name)
        n = num_seeds or len(jax)
        prev = out.get(name, {})
        if prev and prev.get("device") != str(device).split(":")[0]:
            raise RuntimeError(f"{name}: the file's seeds ran on {prev.get('device')}, "
                               f"not {device}; move {out_path} aside to start over")
        port = list(prev.get("port", []))[:n]
        seconds = prev.get("seconds_per_seed")
        for seed in range(len(port), n):
            t0 = time.perf_counter()
            port.append(float(run_seed(name, seed)))
            seconds = time.perf_counter() - t0
            out[name] = result_entry(jax, port, device, card, seconds, flat)
            with open(out_path, "w", encoding="utf-8") as f:
                json.dump(out, f, indent=1)
            print(f"{name} seed {seed}: {port[-1]:.4f} ({seconds:.1f} s)", flush=True)
        if port:
            out[name] = e = result_entry(jax, port, device, card, seconds, flat)
            print(f"{name}: jax {e['jax_mean']:.4f}±{e['jax_std']:.4f} (n={len(jax)}) "
                  f"port {e['port_mean']:.4f}±{e['port_std']:.4f} (n={len(port)}) "
                  f"delta {e['delta']:+.4f} in [{e['tolerance']['lower'] - e['jax_mean']:+.4f}, "
                  f"{e['tolerance']['upper'] - e['jax_mean']:+.4f}] "
                  f"{'ok' if e['gate_ok'] else 'FAILS'} on {card}", flush=True)
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump(out, f, indent=1)
    return out


def main(num_seeds: Optional[int] = None, cells: Optional[Sequence[str]] = None,
         device="cuda", out_path: Path = OUT_PATH) -> Dict[str, dict]:
    """Run the missing seeds of each cell (``run_harness``); each cell's
    graph is built once and shared by the cells of its key."""
    cells = list(cells or CELLS)
    unknown = [c for c in cells if c not in CELLS]
    if unknown:
        raise ValueError(f"unknown cells {unknown}; cells are {CELLS}")
    data_cache: dict = {}

    def run_seed(cell, seed):
        model, shape = cell.rsplit("_", 1)
        return twin(model).run(seed, device=device, dataset=shape,
                               data=cell_data(model, shape, device, data_cache))

    return run_harness(cells, jax_results, run_seed, num_seeds, device, out_path)


def parse_command_line(argv, out_path: Path = OUT_PATH):
    """``(num_seeds, names, options)`` of a harness's command line; the
    options are ``--device`` (default cuda) and ``--out`` (default
    ``out_path``)."""
    argv, options = list(argv), {"device": "cuda", "out_path": out_path}
    for flag, name in (("--device", "device"), ("--out", "out_path")):
        if flag in argv:
            i = argv.index(flag)
            options[name] = argv[i + 1]
            del argv[i:i + 2]
    options["out_path"] = Path(options["out_path"])
    num_seeds = int(argv[0]) if argv and argv[0].isdigit() else None
    cells = argv[1:] if num_seeds is not None else argv
    return num_seeds, cells or None, options


if __name__ == "__main__":
    n, only, opts = parse_command_line(sys.argv[1:])
    res = main(n, only, **opts)
    sys.exit(0 if all(e["gate_ok"] for c, e in res.items() if only is None or c in only) else 1)
