"""Fixtures of the benchmark's own tests (``python3 -m pytest gnnbench/tests``).

They run on the CPU at tiny sizes, on the port's plain path. The one test
that needs a card is marked ``card`` and decides inside itself whether to
skip (the ``cuda`` fixture).
"""
import json
import shutil
import sys
from pathlib import Path

import pytest

CHECKOUT = Path(__file__).resolve().parents[2]
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))

BENCH = CHECKOUT / "gnnbench"
TINY_TRAFFIC = {"generator": "squared_uniform", "num_nodes": 300, "num_edges": 1200,
                "symmetric": True, "num_features": 24, "num_classes": 5}
# The tiny cells' limits, set as the chip cells' are (PERF.md §2) from CPU
# readings at this size against the float64 reference: the largest of 14
# sound seeds (lower), the smallest of 5 control seeds (upper).
# GCN: loss (first step) 1.38e-7 / 2.53e-5; logits 3.58e-7 / 2.61e-3; grad
# 5.61e-7 / 1.07e-3; update 2.97e-7 / 5.26e-4.
# GAT: loss (first step) 1.27e-7 / 6.12e-5; logits 2.16e-6 / 5.57e-3; grad
# 7.01e-7 / 2.87e-3; update 4.36e-8 / 2.86e-4.
TINY_CELLS = {
    "gcn-3l-256.tiny": ("gcn-3l-256", {"loss_gap": 4e-6, "logits_gap": 1e-4,
                                       "grad_gap": 1e-4, "update_gap": 5e-5}),
    "gat-8h-8.tiny": ("gat-8h-8", {"loss_gap": 5e-6, "logits_gap": 2e-4,
                                   "grad_gap": 2e-4, "update_gap": 1e-5}),
}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skips without one")


def copy_benchmark(dest: Path) -> Path:
    """A copy of ``gnnbench/`` and ``BENCHMARK.json`` under ``dest``; returns
    the copy's ``gnnbench`` folder."""
    shutil.copytree(BENCH, dest / "gnnbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(CHECKOUT / "BENCHMARK.json", dest / "BENCHMARK.json")
    return dest / "gnnbench"


def add_cell(root: Path, name: str, config: str, traffic: str, limits: dict,
             all_metrics: bool = True):
    """Adds a workload file and its ``BENCHMARK.json`` entry to a copy."""
    (root / "workloads" / f"{name}.json").write_text(
        json.dumps({"config": config, "traffic": traffic, "limits": limits}))
    path = root.parent / "BENCHMARK.json"
    bench = json.loads(path.read_text())
    bench["workloads"].append({"name": name, "config": config, "traffic": traffic,
                               "chips": 1, "why": "a test cell"})
    if all_metrics:
        for m in bench["per_layer"]:
            m.setdefault("workloads", []).append(name)
    path.write_text(json.dumps(bench))


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    """A copy of the benchmark with a tiny traffic mix and one tiny cell per
    configuration."""
    root = copy_benchmark(tmp_path_factory.mktemp("bench"))
    (root / "traffic" / "tiny.json").write_text(json.dumps(TINY_TRAFFIC))
    for name, (config, limits) in TINY_CELLS.items():
        add_cell(root, name, config, "tiny", limits)
    return root


@pytest.fixture
def cuda():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
