"""The port's accuracy head-to-head harnesses
(``tf_geometric_tpu_torch/benchmarks/node_classification/head_to_head_port.py``,
``.../graph_classification/head_to_head_graph_port.py``) and the results
they committed from the H100.

- ``gate`` on constructed lists, at the edges of both bounds and of the
  collapse floor, flat and SEM-dominated.
- The results-file reader against the JAX harness's reading, and each JAX
  results file against the ``repo`` lists of JAX's committed JSONs.
- The committed JSONs: all 17 node cells and 6 graph models present; each
  ``jax`` list equals its source; the port has at least as many seeds as
  JAX; every entry's stored numbers are its lists'; every cell passes the
  gate; each ran on the card (``device`` cuda, an H100 with its power
  limit).
"""
import json
from pathlib import Path

import numpy as np
import pytest

from tf_geometric_tpu_torch.benchmarks.graph_classification import head_to_head_graph_port as gh2h
from tf_geometric_tpu_torch.benchmarks.node_classification import head_to_head_port as h2h

REPO = Path(__file__).resolve().parent.parent
JAX_NODE = REPO / "benchmarks" / "node_classification"


def test_gate_flat_bounds_at_their_edges():
    jax = [0.8] * 10
    assert h2h.gate(jax, [0.7801] * 10)["ok"]
    assert h2h.gate(jax, [0.8199] * 10)["ok"]
    low, high = h2h.gate(jax, [0.7799] * 10), h2h.gate(jax, [0.8201] * 10)
    assert not low["ok"] and "below" in low["failed"][0]
    assert not high["ok"] and "above" in high["failed"][0]
    g = h2h.gate(jax, [0.8] * 3)
    assert g["sem"] == pytest.approx(0.0, abs=1e-12)
    assert g["lower"] == pytest.approx(0.78) and g["upper"] == pytest.approx(0.82)


def test_gate_sem_bounds_at_their_edges():
    jax, port = [0.5, 0.7] * 5, [0.5, 0.7] * 5
    sem = float(np.sqrt(0.01 / 10 + 0.01 / 10))
    g = h2h.gate(jax, port)
    assert g["sem"] == pytest.approx(sem)
    assert g["lower"] == pytest.approx(0.6 - 2 * sem) and g["upper"] == pytest.approx(0.6 + 3 * sem)
    # shifting every port seed moves the mean and keeps the SEM
    assert h2h.gate(jax, [v - 2 * sem + 1e-6 for v in port])["ok"]
    assert not h2h.gate(jax, [v - 2 * sem - 1e-6 for v in port])["ok"]
    assert h2h.gate(jax, [v + 3 * sem - 1e-6 for v in port])["ok"]
    assert not h2h.gate(jax, [v + 3 * sem + 1e-6 for v in port])["ok"]


def test_gate_collapse_floor_and_flat_term():
    assert h2h.gate([0.35] * 5, [0.3501] * 5)["ok"]
    g = h2h.gate([0.35] * 5, [0.3499] * 5)
    assert not g["ok"] and g["failed"] == ["port mean 0.3499 below the collapse floor 0.35"]
    # the graph harness's flat term 0.05
    assert h2h.gate([0.8] * 6, [0.751] * 6, flat=gh2h.FLAT_TOL)["ok"]
    assert not h2h.gate([0.8] * 6, [0.749] * 6, flat=gh2h.FLAT_TOL)["ok"]
    with pytest.raises(ValueError):
        h2h.gate([], [0.5])


def test_gate_is_the_jax_tests_rule_below():
    """The lower bound is ``tests/test_head_to_head_hard.py``'s
    ``max(DELTA_TOL, 2·SEM)`` over population variances."""
    rng = np.random.default_rng(0)
    for _ in range(20):
        jax, port = rng.uniform(0.4, 0.9, 12), rng.uniform(0.4, 0.9, 7)
        sem = float(np.sqrt(np.var(jax) / len(jax) + np.var(port) / len(port)))
        g = h2h.gate(list(jax), list(port))
        assert g["lower"] == pytest.approx(float(np.mean(jax)) - max(0.02, 2 * sem))
        assert g["ok"] == (np.mean(jax) - max(0.02, 2 * sem) <= np.mean(port)
                           <= np.mean(jax) + max(0.02, 3 * sem) and np.mean(port) >= 0.35)


def test_read_results_matches_the_jax_harness(tmp_path):
    path = tmp_path / "r.txt"
    path.write_text("0.5\n0.75\n\n0.8125\n")
    assert h2h.read_results(path) == [0.5, 0.75, 0.8125]
    # as head_to_head_hard.run_repo_side reads a results file
    with open(path, encoding="utf-8") as f:
        assert h2h.read_results(path) == [float(v) for v in f.read().split()]


def test_jax_results_continue_from_the_extra_seeds_only_past_the_committed_list():
    """appnp_pubmed: JAX's 10 committed seeds, then its seeds 10-39 from
    ``jax_extra_seeds`` (a header, then one accuracy a line) where 40 are
    asked for; the committed list alone otherwise."""
    committed = h2h.jax_results("appnp_pubmed")
    assert len(committed) == 10
    assert h2h.jax_results("appnp_pubmed", 10) == committed
    assert h2h.jax_results("appnp_pubmed", 5) == committed
    extra = h2h.read_results(h2h.JAX_EXTRA_DIR / "results_appnp_pubmed_hard.txt")
    assert len(extra) == 30
    assert h2h.jax_results("appnp_pubmed", 40) == committed + extra
    assert h2h.jax_results("appnp_pubmed", 12) == committed + extra[:2]
    # a cell without extra seeds keeps its committed list
    assert h2h.jax_results("gcn_cora", 40) == h2h.jax_results("gcn_cora")


def test_read_results_skips_a_header(tmp_path):
    path = tmp_path / "r.txt"
    path.write_text("# made by\n#   a command\n0.5\n\n0.25\n")
    assert h2h.read_results(path) == [0.5, 0.25]


@pytest.mark.parametrize("cell", h2h.CELLS)
def test_jax_results_files_are_the_committed_repo_lists(cell):
    src = JAX_NODE / ("head_to_head_arxiv.json" if cell.endswith("arxiv")
                      else "head_to_head_hard.json")
    with open(src, encoding="utf-8") as f:
        repo = json.load(f)[cell]["repo"]
    assert h2h.jax_results(cell) == pytest.approx(repo, abs=0)


def _committed(path):
    assert path.exists(), f"{path.name} is not committed"
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _check_entry(entry, jax, flat):
    assert entry["jax"] == jax
    assert entry.get("jax_seeds", len(jax)) == len(jax)
    assert len(entry["port"]) >= len(jax)
    g = h2h.gate(entry["jax"], entry["port"], flat=flat)
    assert entry["port_mean"] == pytest.approx(float(np.mean(entry["port"])))
    assert entry["jax_mean"] == pytest.approx(float(np.mean(jax)))
    assert entry["delta"] == pytest.approx(g["port_mean"] - g["jax_mean"])
    assert entry["tolerance"]["lower"] == pytest.approx(g["lower"])
    assert entry["tolerance"]["upper"] == pytest.approx(g["upper"])
    assert entry["gate_ok"] == g["ok"], g["failed"]
    assert g["ok"], g["failed"]
    assert entry["device"] == "cuda"
    assert "H100" in entry["card"] and entry["card"].rstrip().endswith("W")


@pytest.mark.parametrize("cell", h2h.CELLS)
def test_committed_node_cell_passes_the_gate_on_the_card(cell):
    out = _committed(h2h.OUT_PATH)
    assert set(out) == set(h2h.CELLS)
    # JAX's list as long as the port's where JAX's later seeds are committed
    # beside the harness (jax_extra_seeds/), as the harness reads it
    _check_entry(out[cell], h2h.jax_results(cell, len(out[cell]["port"])), h2h.FLAT_TOL)


@pytest.mark.parametrize("model", gh2h.MODELS)
def test_committed_graph_model_passes_the_gate_on_the_card(model):
    out = _committed(gh2h.OUT_PATH)
    assert set(out) == set(gh2h.MODELS)
    with open(gh2h.JAX_JSON, encoding="utf-8") as f:
        assert gh2h.jax_results(model) == json.load(f)[model]["repo"]
    _check_entry(out[model], gh2h.jax_results(model), gh2h.FLAT_TOL)


def test_command_line():
    n, cells, opts = h2h.parse_command_line(["5", "gcn_cora", "--device", "cpu", "--out", "x"])
    assert (n, cells, opts["device"], str(opts["out_path"])) == (5, ["gcn_cora"], "cpu", "x")
    n, cells, opts = h2h.parse_command_line([], gh2h.OUT_PATH)
    assert (n, cells, opts["device"], opts["out_path"]) == (None, None, "cuda", gh2h.OUT_PATH)
    with pytest.raises(ValueError):
        h2h.main(1, ["gcn_nowhere"], "cpu", Path("/nonexistent/never_written.json"))


def test_cell_data_is_keyed_as_the_jax_harness(monkeypatch):
    monkeypatch.setenv("TFG_HARD_MODEL", "gat")  # read by the dataset when model is None
    cache = {}
    a = h2h.cell_data("gcn", "citeseer", "cpu", cache)
    assert h2h.cell_data("sgc", "citeseer", "cpu", cache) is a
    b = h2h.cell_data("gat", "citeseer", "cpu", cache)  # an override of its own
    assert b is not a and set(cache) == {"citeseer", ("gat", "citeseer")}
    from tf_geometric_tpu_torch.datasets.synthetic_citation import HardCitationDataset
    want, _ = HardCitationDataset("citeseer", seed=0, model="gcn").load_data()
    np.testing.assert_array_equal(a[0].edge_index.numpy(), np.asarray(want.edge_index))


def test_run_harness_resumes_and_refuses_another_device(tmp_path, capsys):
    path, calls = tmp_path / "out.json", []

    def run_seed(name, seed):
        calls.append((name, seed))
        return 0.5 + 0.01 * seed

    jax = {"a": [0.5, 0.52, 0.51], "b": [0.9]}
    out = h2h.run_harness(["a", "b"], jax.get, run_seed, None, "cpu", path)
    assert calls == [("a", 0), ("a", 1), ("a", 2), ("b", 0)]
    assert out["a"]["port"] == [0.5, 0.51, 0.52] and out["b"]["gate_ok"] is False
    assert json.loads(path.read_text()) == out
    calls.clear()
    out = h2h.run_harness(["a"], jax.get, run_seed, 5, "cpu", path)
    assert calls == [("a", 3), ("a", 4)] and len(out["a"]["port"]) == 5 and "b" in out
    assert "a: jax 0.5100" in capsys.readouterr().out
    data = json.loads(path.read_text())
    data["a"]["device"] = "cuda"
    path.write_text(json.dumps(data))
    with pytest.raises(RuntimeError, match="ran on cuda"):
        h2h.run_harness(["a"], jax.get, run_seed, 6, "cpu", path)
