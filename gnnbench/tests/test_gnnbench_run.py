"""A whole run, with the look for a card skipped: the result line's shape,
the faults that must turn ``correct`` false, the control, and a cell, a
configuration and a metric added by files alone."""
import io
import json

import pytest
import torch

from gnnbench import run
from gnnbench.harness import check, registry, training
from gnnbench.harness.faults import FAULTS, planted

from conftest import TINY_CELLS, add_cell, copy_benchmark

SEED = 2 ** 31 + 77


def _run(root, cell, trace=0, seconds=0.3, seed=SEED):
    return run.run_cell(cell, seed, seconds, bool(trace), torch.device("cpu"), root,
                        log=io.StringIO())


@pytest.mark.parametrize("cell", sorted(TINY_CELLS))
@pytest.mark.parametrize("trace", [0, 1])
def test_run_prints_the_contract_line(tiny_root, cell, trace, capsys):
    rc = run.main(["--workload", cell, "--seed", str(SEED), "--seconds", "1.0",
                   "--trace", str(trace)], root=tiny_root, device="cpu")
    out, err = capsys.readouterr()
    assert rc == 0
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks" and line["correct"] is True
    assert line["attempted"] > 0 and line["failed"] == 0
    assert err.strip().splitlines()[-1].startswith("check update_gap ")
    names = set(line["metrics"])
    if trace:  # the CPU trace has no device time: only the host's metric reads
        assert names == {"host_enqueue_ms"}
    else:
        # a p95 needs 20 steps, which a loaded CPU may not finish in the window
        p95 = {"step_p95_ms"} if line["attempted"] >= 20 else set()
        assert names == {"step_ms", "setup_s"} | p95
        assert all(m["value"] > 0 for m in line["metrics"].values())


def test_run_refuses_without_a_card(tiny_root, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "gcn-3l-256.tiny", "--seed", "1", "--seconds", "1"],
                  root=tiny_root)
    out, err = capsys.readouterr()
    assert rc == 2 and out == "" and "no CUDA device" in err


@pytest.mark.parametrize("cell", sorted(TINY_CELLS))
@pytest.mark.parametrize("fault", FAULTS)
def test_a_planted_fault_turns_correct_false(tiny_root, cell, fault):
    with planted(fault):
        assert _run(tiny_root, cell)["correct"] is False


@pytest.mark.parametrize("cell", sorted(TINY_CELLS))
@pytest.mark.parametrize("seed", [11, 12, 13])
def test_the_control_is_not_correct(tiny_root, cell, seed):
    """The reference one precision lower than the configuration states, in
    the program's place, fails the cell's limits."""
    cell_spec = registry.load_json("workloads", cell, tiny_root)
    data = training.make_data(cell_spec, seed, torch.device("cpu"), tiny_root)
    module = registry.load_module("reference", data["cfg"]["model"], tiny_root)
    masks = [training.draw_masks(data["dropouts"], data["generator"], torch.device("cpu"))
             for _ in range(run.FIRST_STEPS)]
    args = (module, data["cfg"], data["graph"], data["weights"], masks)
    numbers = check.compare(check.reference_run(*args, control=True), check.reference_run(*args))
    assert check.judge(numbers, cell_spec["limits"])[0] is False, numbers


def test_files_alone_add_a_cell_a_configuration_and_a_metric(tmp_path):
    """A throwaway traffic mix, configuration, cell and metric are found by
    their names; no file of the benchmark is edited."""
    root = copy_benchmark(tmp_path)
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    (root / "traffic" / "throwaway.json").write_text(json.dumps(
        {"generator": "squared_uniform", "num_nodes": 50, "num_edges": 300,
         "num_features": 8, "num_classes": 3}))
    cfg = registry.load_json("configs", "gcn-3l-256", root)
    cfg["hidden"] = 16
    (root / "configs" / "throwaway-gcn.json").write_text(json.dumps(cfg))
    (root / "metrics" / "throwaway_steps.py").write_text(
        "def read(rec):\n    return float(rec.steps)\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["end_to_end"].append({"name": "throwaway_steps", "unit": "steps", "better": "higher",
                                "bound": 0.25, "source": "host_clock",
                                "workloads": ["throwaway-gcn.throwaway"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    add_cell(root, "throwaway-gcn.throwaway", "throwaway-gcn", "throwaway",
             {"loss_gap": 1.0, "logits_gap": 1.0, "grad_gap": 1.0, "update_gap": 1.0})
    line = _run(root, "throwaway-gcn.throwaway")
    assert line["metrics"]["throwaway_steps"]["value"] == line["attempted"]
    assert all(p.read_bytes() == data for p, data in before.items()
               if p.name != "BENCHMARK.json")


@pytest.mark.card
def test_a_cell_on_the_card(cuda):
    line = run.run_cell("gcn-3l-256.reddit-full", SEED, 2.0, True, cuda,
                        log=io.StringIO())
    assert line["correct"] and line["device"]["busy_s"] > 0
    assert 0 < line["metrics"]["step_mfu"]["value"] <= 100
    assert 0 < line["metrics"]["spmm_roofline"]["value"] <= 100
