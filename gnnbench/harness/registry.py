"""Everything that belongs to one configuration, traffic mix, cell, model or
metric is a file of its own, found here by its name:

    configs/<config>.json      the configuration as it is run
    traffic/<traffic>.json     the graph's generator and its parameters
    graphs/<generator>.py      ``make(params, generator, device)``
    workloads/<cell>.json      the cell's config, traffic and correctness limits
    models/<model>.py          the port-side builder, ``build(cfg, graph, weights)``
    reference/<model>.py       the plain PyTorch reference of the model
    counts/<model>.py          the step's operations, bytes and flops
    metrics/<metric>.py        ``read(record)``: the number, or None

Names may hold ``-`` and ``.``, so modules are loaded from their paths, not
imported by dotted name. Adding a cell, a model or a metric adds files and
``BENCHMARK.json`` entries; it edits none of these.
"""
from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path
from types import ModuleType

BENCH_DIR = Path(__file__).resolve().parent.parent
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def check_name(name: str) -> str:
    if not isinstance(name, str) or not NAME_RE.match(name):
        raise ValueError(f"not a valid name: {name!r}")
    return name


def _path(kind: str, name: str, suffix: str, root: Path) -> Path:
    path = root / kind / (check_name(name) + suffix)
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
    return path


def load_json(kind: str, name: str, root: Path = BENCH_DIR) -> dict:
    with open(_path(kind, name, ".json", root)) as f:
        return json.load(f)


def load_module(kind: str, name: str, root: Path = BENCH_DIR) -> ModuleType:
    """The module ``<root>/<kind>/<name>.py``, loaded once per process."""
    path = _path(kind, name, ".py", root)
    key = f"gnnbench_{kind}_{name}_{abs(hash(str(path)))}".replace("-", "_").replace(".", "_")
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[key] = module
    try:
        spec.loader.exec_module(module)
    except BaseException:
        del sys.modules[key]
        raise
    return module


def load_benchmark(root: Path = BENCH_DIR) -> dict:
    """``BENCHMARK.json`` at the checkout's root, beside this folder."""
    path = root.parent / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"no BENCHMARK.json beside {root}")
    with open(path) as f:
        return json.load(f)


def cell_metrics(bench: dict, cell: str, trace: bool) -> list:
    """The metric entries that this cell reports: its end-to-end metrics in
    a timed run, its per-layer metrics in a traced one. An entry without a
    ``workloads`` key applies to every cell."""
    entries = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in entries if "workloads" not in m or cell in m["workloads"]]


def cell_entry(bench: dict, cell: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == cell:
            return w
    raise KeyError(f"BENCHMARK.json has no workload {cell!r}")
