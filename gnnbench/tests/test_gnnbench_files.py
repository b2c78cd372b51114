"""Every data file of the benchmark loads, every name and unit is well formed,
and ``BENCHMARK.json`` agrees with the files it names."""
import json
import re

import pytest

from gnnbench.harness import check, registry

from conftest import BENCH, CHECKOUT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCHMARK = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def _stems(kind, suffix):
    return sorted(p.stem for p in (BENCH / kind).glob(f"*{suffix}"))


def test_benchmark_keys_and_limits():
    assert set(BENCHMARK) == KEYS
    assert BENCHMARK["command"][:2] == ["python3", "gnnbench/run.py"]
    assert BENCHMARK["paths"] == ["gnnbench"]
    assert 1 <= BENCHMARK["run_seconds"] <= 51
    assert len((CHECKOUT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    for m in BENCHMARK["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in BENCHMARK["end_to_end"])


@pytest.mark.parametrize("entry", [m for k in ("end_to_end", "per_layer") for m in BENCHMARK[k]],
                         ids=lambda m: m["name"])
def test_metric_entry(entry):
    assert NAME.match(entry["name"]) and UNIT.match(entry["unit"])
    assert entry["better"] in ("lower", "higher")
    registry.load_module("metrics", entry["name"])
    cells = {w["name"] for w in BENCHMARK["workloads"]}
    assert set(entry.get("workloads", cells)) <= cells
    if "layer" in entry:
        assert entry["moves"] in {m["name"] for m in BENCHMARK["end_to_end"]}


@pytest.mark.parametrize("name", _stems("configs", ".json"))
def test_config_file(name):
    cfg = registry.load_json("configs", name)
    entry = next(c for c in BENCHMARK["configs"] if c["name"] == name)
    assert entry["file"] == f"gnnbench/configs/{name}.json"
    for key in entry["reduced"]:
        assert NAME.match(key) and key in cfg
    for kind in ("models", "reference", "counts"):
        registry.load_module(kind, cfg["model"])
    assert cfg["precision"]["tf32"] is False


@pytest.mark.parametrize("name", _stems("traffic", ".json"))
def test_traffic_file(name):
    traffic = registry.load_json("traffic", name)
    registry.load_module("graphs", traffic["generator"])
    assert all(traffic[k] > 0 for k in ("num_nodes", "num_edges", "num_features", "num_classes"))


@pytest.mark.parametrize("name", _stems("workloads", ".json"))
def test_workload_file(name):
    """Every cell's file loads; a file may wait for its ``BENCHMARK.json``
    entry (``PERF.md`` §7 says which and why)."""
    cell = registry.load_json("workloads", name)
    assert set(cell["limits"]) == set(check.NUMBERS)
    registry.load_json("configs", cell["config"])
    registry.load_json("traffic", cell["traffic"])


@pytest.mark.parametrize("entry", BENCHMARK["workloads"], ids=lambda w: w["name"])
def test_benchmark_cell_has_its_file(entry):
    cell = registry.load_json("workloads", entry["name"])
    assert (entry["config"], entry["traffic"]) == (cell["config"], cell["traffic"])
    assert entry["chips"] == 1 and 1 <= len(entry["why"]) <= 200


def test_every_name_and_file_is_well_formed():
    names = [c["name"] for c in BENCHMARK["configs"]] + [w["name"] for w in BENCHMARK["workloads"]]
    names += [w[k] for w in BENCHMARK["workloads"] for k in ("config", "traffic")]
    assert all(NAME.match(n) for n in names)
    for path in BENCH.rglob("*"):
        if "__pycache__" not in path.parts:
            assert re.match(r"^[A-Za-z0-9_./-]+$", str(path.relative_to(CHECKOUT))), path
