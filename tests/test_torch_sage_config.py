"""The sampled GraphSAGE on the port's layer path, on the CPU: ``layers.MeanGraphSage``
and ``SumGraphSage`` fed a ``FixedKDraw`` from ``nn.sampling.DeviceNeighborSampler``
against the fixed-k functions and the edge-list path, the draw's uniformity, the
spans and counters of the draw and the layers, and the benchmark's
``sage-2l-256`` model (``gnnbench/models/sage.py``) against its plain reference
(``gnnbench/reference/sage.py``) at a tiny size."""
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy import stats

from tf_geometric_tpu_torch import layers
from tf_geometric_tpu_torch.nn import conv
from tf_geometric_tpu_torch.nn.sampling import DeviceNeighborSampler, FixedKDraw
from tf_geometric_tpu_torch.ops.fixed_k import draw_fixed_k_plain
from tf_geometric_tpu_torch.utils import profiling
from tf_geometric_tpu_torch.utils.profiling import counters, spans, tracing

CHECKOUT = Path(__file__).resolve().parent.parent
TINY_TRAFFIC = {"generator": "squared_uniform", "num_nodes": 300, "num_edges": 1200,
                "symmetric": True, "num_features": 24, "num_classes": 5}
SEED = 2_719_599_378


@pytest.fixture(autouse=True)
def fresh():
    profiling.reset()
    yield
    profiling.reset()


def _graph(n=40, e=160, isolated=3, seed=0):
    """Random edges over ``n`` nodes, the last ``isolated`` rows without edges."""
    g = torch.Generator().manual_seed(seed)
    dst = torch.randint(0, n - isolated, (e,), generator=g)
    src = torch.randint(0, n, (e,), generator=g)
    return torch.stack([dst, src])


def _draw(ei, n, k, seed=1):
    return DeviceNeighborSampler(ei, num_nodes=n, device="cpu").sample(
        torch.Generator().manual_seed(seed), k)


@pytest.mark.parametrize("cls, fn, fixed_k", [
    (layers.MeanGraphSage, conv.mean_graph_sage, conv.mean_graph_sage_fixed_k),
    (layers.SumGraphSage, conv.sum_graph_sage, conv.sum_graph_sage_fixed_k)])
@pytest.mark.parametrize("f_in, units", [(12, 8), (6, 16)])
def test_layer_on_a_draw_is_the_fixed_k_function(cls, fn, fixed_k, f_in, units):
    """Bit for bit the fixed-k function (matmul-first where the kernel
    narrows, gather-first where it does not); within 1e-6 of the edge-list
    path on the flattened draw, forward and gradients."""
    n, k = 40, 5
    ei = _graph(n)
    draw = _draw(ei, n, k)
    assert isinstance(draw, FixedKDraw) and draw.idx.shape == (k, n)
    layer = cls(f_in, units, use_bias=True, device="cpu")
    with torch.no_grad():
        layer.bias.uniform_(-0.5, 0.5, generator=torch.Generator().manual_seed(2))
    x = torch.randn(n, f_in, generator=torch.Generator().manual_seed(3), requires_grad=True)

    out = layer([x, draw])
    want = fixed_k(x, draw.idx, draw.weight, layer.self_kernel, layer.neighbor_kernel,
                   bias=layer.bias, activation=torch.relu)
    assert torch.equal(out, want)

    flat = torch.stack([torch.arange(n).repeat(k), draw.idx.reshape(-1).long()])
    ref = layer([x, flat, draw.weight.reshape(-1)])
    params = [x, layer.self_kernel, layer.neighbor_kernel, layer.bias]
    g_out = torch.autograd.grad(out.square().sum(), params)
    g_ref = torch.autograd.grad(ref.square().sum(), params)
    for a, b in zip((out.detach(),) + g_out, (ref.detach(),) + g_ref):
        assert (a - b).abs().max() <= 1e-6 * max(1.0, float(b.abs().max()))


def test_an_edge_list_takes_the_segment_path(monkeypatch):
    """``[x, edge_index]`` (a tensor or an array) and ``[x, edge_index, weight]`` call the
    edge-list function as before, never the fixed-k one."""
    import tf_geometric_tpu_torch.layers.conv.graph_sage as sage_layers
    n = 40
    ei = _graph(n)
    w = torch.rand(ei.shape[1], generator=torch.Generator().manual_seed(4))
    layer = layers.MeanGraphSage(7, 8, device="cpu")
    x = torch.randn(n, 7, generator=torch.Generator().manual_seed(5))
    want = conv.mean_graph_sage(x, ei, None, layer.self_kernel, layer.neighbor_kernel,
                                bias=layer.bias, activation=torch.relu)
    want_w = conv.mean_graph_sage(x, ei, w, layer.self_kernel, layer.neighbor_kernel,
                                  bias=layer.bias, activation=torch.relu)

    def refuse(*args, **kwargs):
        raise AssertionError("an edge list took the fixed-k path")
    monkeypatch.setattr(sage_layers.MeanGraphSage, "_fixed_k_op", staticmethod(refuse))
    assert torch.equal(layer([x, ei]), want)
    assert torch.equal(layer([x, ei.numpy()]), want)
    assert torch.equal(layer([x, ei, w]), want_w)


@pytest.mark.parametrize("cls", [layers.MeanGraphSage, layers.SumGraphSage])
def test_a_draw_of_another_row_count_is_refused(cls):
    n = 40
    draw = _draw(_graph(n), n, 4)
    layer = cls(6, 8, device="cpu")
    with pytest.raises(ValueError, match="the draw has 40 rows, x has 39"):
        layer([torch.randn(n - 1, 6), draw])
    cut = FixedKDraw(draw.idx[:, :30], draw.weight[:, :30])
    with pytest.raises(ValueError, match="the draw has 30 rows"):
        layer([torch.randn(n, 6), cut])


@pytest.mark.parametrize("cls, args", [
    (layers.GCNGraphSage, {}), (layers.MeanPoolGraphSage, {}), (layers.MaxPoolGraphSage, {}),
    (layers.LSTMGraphSage, {"max_neighbors": 4})])
def test_the_edge_list_layers_refuse_a_draw(cls, args):
    """Only the mean and sum layers take a ``FixedKDraw``; the others would
    read its two tensors as an edge list."""
    n = 40
    draw = _draw(_graph(n), n, 4)
    layer = cls(6, 8, device="cpu", **args)
    with pytest.raises(TypeError, match=f"{cls.__name__} takes an edge list, not a FixedKDraw"):
        layer([torch.randn(n, 6), draw])


def test_the_draw_is_uniform_over_a_nodes_edge_multiset():
    """A chi-square test at a fixed seed on the draw's CPU path
    (``draw_fixed_k_plain``): node 0's edges list node 1 twice, 2 once, 3
    three times and 4 once, so the draw picks them 2 : 1 : 3 : 1."""
    ei = np.array([[0] * 7 + [1, 2], [1, 1, 2, 3, 3, 3, 4, 0, 0]], np.int64)
    sampler = DeviceNeighborSampler(ei, num_nodes=5, device="cpu")
    k = 7000
    idx, w = sampler.sample(torch.Generator().manual_seed(11), k)
    r = torch.randint(0, 2 ** 31 - 1, (k, 5), generator=torch.Generator().manual_seed(11),
                      dtype=torch.int32)
    plain = draw_fixed_k_plain(r, sampler.row_start, sampler.degree, sampler.sorted_col)
    assert torch.equal(idx, plain[0]) and torch.equal(w, plain[1])
    seen = np.bincount(idx[:, 0].numpy(), minlength=5)
    assert seen[0] == 0
    expected = k * np.array([2, 1, 3, 1]) / 7
    assert stats.chisquare(seen[1:], expected).pvalue > 1e-3
    assert (idx[:, 3:].numpy() == np.arange(3, 5)).all() and (w[:, 3:] == 0).all()
    assert (w[:, :3] == 1).all()


def test_spans_and_counters_of_the_draw_and_the_layers():
    """With the tracer on: the CSR build once, a draw span per draw, a layer
    span per layer call with the fixed-k function's span inside it. With it
    off no span is recorded; the counters count either way."""
    n, k = 40, 3
    ei = _graph(n)
    with tracing():
        sampler = DeviceNeighborSampler(ei, num_nodes=n, device="cpu")
    assert [s.name for s in spans()] == ["tfg.setup.sampler_csr"]
    assert counters() == {"sampling.csr_rows": n, "sampling.csr_entries": ei.shape[1]}
    mean, total = layers.MeanGraphSage(6, 8, device="cpu"), layers.SumGraphSage(6, 8, device="cpu")
    x = torch.randn(n, 6)
    gen = torch.Generator().manual_seed(0)

    def step():
        d0 = sampler.sample(gen, k)
        d1 = sampler.sample(gen, k + 1)
        return mean([x, d0]) + total([x, d1])

    profiling.reset()
    step()
    off = counters()
    assert spans() == []
    assert off == {"sampling.draws": 2, "sampling.slots": (2 * k + 1) * n}
    profiling.reset()
    with tracing():
        step()
    assert counters() == off
    recorded = spans()
    names = [s.name for s in recorded]
    assert names.count("tfg.nn.sampling.draw") == 2
    assert names.count("tfg.layers.MeanGraphSage") == 1
    assert names.count("tfg.layers.SumGraphSage") == 1
    inner = [s for s in recorded if s.name == "tfg.nn.conv.graph_sage"]
    assert sorted(recorded[s.parent].name for s in inner) == [
        "tfg.layers.MeanGraphSage", "tfg.layers.SumGraphSage"]
    profiling.reset()
    with tracing():
        mean([x, ei])  # the edge-list path: the layer's span only
    assert [s.name for s in spans()] == ["tfg.layers.MeanGraphSage"]


# --- the benchmark's configuration against its plain reference ---------------------

@pytest.fixture(scope="module")
def bench_root(tmp_path_factory):
    """A copy of the benchmark with a tiny traffic mix and a tiny cell of
    ``sage-2l-256``."""
    dest = tmp_path_factory.mktemp("bench")
    shutil.copytree(CHECKOUT / "gnnbench", dest / "gnnbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(CHECKOUT / "BENCHMARK.json", dest / "BENCHMARK.json")
    root = dest / "gnnbench"
    (root / "traffic" / "tiny.json").write_text(json.dumps(TINY_TRAFFIC))
    (root / "workloads" / "sage-2l-256.tiny.json").write_text(json.dumps(
        {"config": "sage-2l-256", "traffic": "tiny", "limits": {}}))
    return root


def _smallest_limits():
    limits = [json.loads(p.read_text())["limits"]
              for p in (CHECKOUT / "gnnbench" / "workloads").glob("*.json")]
    return {name: min(lim[name] for lim in limits) for name in limits[0]}


def _first_and_reference(root, seed=SEED):
    from gnnbench.harness import check, registry, training
    cell = registry.load_json("workloads", "sage-2l-256.tiny", root)
    data = training.make_data(cell, seed, torch.device("cpu"), root)
    first = training.Trainer(data, root).first_steps(3)
    ref_module = registry.load_module("reference", "sage", root)
    return data, first, ref_module, check


@pytest.mark.parametrize("seed", [SEED, 3_101_411_558])
def test_model_against_its_reference_under_the_smallest_limits(bench_root, seed):
    data, first, ref_module, check = _first_and_reference(bench_root, seed)
    for masks in first["masks"]:
        assert set(masks) == {"draw0", "draw1"}
        assert isinstance(masks["draw0"], FixedKDraw)
        assert masks["draw0"].idx.shape == (25, 300) and masks["draw1"].idx.shape == (10, 300)
    assert not torch.equal(first["masks"][0]["draw0"].idx, first["masks"][1]["draw0"].idx)
    ref = check.reference_run(ref_module, data["cfg"], data["graph"], data["weights"],
                              first["masks"])
    numbers = check.compare(first, ref)
    limits = _smallest_limits()
    assert all(numbers[name] < limits[name] for name in limits), (numbers, limits)


def test_the_reference_gives_nan_logits_for_an_invalid_slot(bench_root):
    data, first, ref_module, check = _first_and_reference(bench_root)
    graph, cfg = data["graph"], data["cfg"]
    prepared = ref_module.prepare(cfg, graph["edge_index"], graph["num_nodes"])
    idx, w = first["masks"][0]["draw0"]
    assert ref_module.draw_is_valid(prepared, idx, w)
    # a node that is no edge of row 0's
    sources = set(graph["edge_index"][1][graph["edge_index"][0] == 0].tolist())
    stranger = next(v for v in range(graph["num_nodes"]) if v not in sources)
    bad_idx = idx.clone()
    bad_idx[3, 0] = stranger
    bad_w = w.clone()
    bad_w[0, 5] = 0.0
    for planted in ((bad_idx, w), (idx, bad_w)):
        assert not ref_module.draw_is_valid(prepared, *planted)
        masks = [dict(first["masks"][0], draw0=FixedKDraw(*planted))]
        ref = check.reference_run(ref_module, cfg, graph, data["weights"], masks)
        assert torch.isnan(ref["logits"]).all()
        numbers = check.compare(dict(first, losses=first["losses"][:1]), ref)
        assert not check.judge(numbers, _smallest_limits())[0]


def _planted_draws(sampler_draw, degree, row_start, sorted_col):
    """Draws that are valid edge for edge but not fresh uniform draws: each
    row's first edge in every slot, one slot's pick in every slot, and a
    pick skewed to the row's first 4 edges."""
    k, n = sampler_draw.idx.shape
    has = degree[None, :] > 0
    first = torch.where(has, sorted_col[row_start.long()][None, :].int(), sampler_draw.idx)
    r = torch.randint(0, 2 ** 31 - 1, (k, n), generator=torch.Generator().manual_seed(9))
    pick = (row_start.long() + r % degree.long().clamp(1, 4)).clamp_max(sorted_col.numel() - 1)
    skewed = torch.where(has, sorted_col[pick].int(), sampler_draw.idx)
    return {"first_edge": first, "one_pick_a_row": sampler_draw.idx[:1].expand(k, n).clone(),
            "skewed": skewed}


@pytest.mark.parametrize("planted", ["first_edge", "one_pick_a_row", "skewed", "same_as_step_1"])
def test_the_reference_gives_nan_logits_for_a_draw_that_is_not_fresh_and_uniform(
        bench_root, planted):
    """Every slot an edge of its row, yet not a fresh uniform draw: the
    reference's rank chi-square or its agreement count refuses it, and the
    comparison fails. The program's own draws pass both."""
    data, first, ref_module, check = _first_and_reference(bench_root)
    graph, cfg = data["graph"], data["cfg"]
    prepared = ref_module.prepare(cfg, graph["edge_index"], graph["num_nodes"])
    for step in first["masks"]:
        for layer in (0, 1):
            assert ref_module.draw_is_sound(prepared, layer, *step[f"draw{layer}"])
    sampler = DeviceNeighborSampler(graph["edge_index"], num_nodes=graph["num_nodes"],
                                    device="cpu")
    draw0 = first["masks"][0]["draw0"]
    steps = [dict(m) for m in first["masks"]]
    if planted == "same_as_step_1":
        steps[1]["draw0"] = FixedKDraw(draw0.idx.clone(), draw0.weight)
    else:
        bad = _planted_draws(draw0, sampler.degree, sampler.row_start,
                             sampler.sorted_col)[planted]
        steps[0]["draw0"] = FixedKDraw(bad, draw0.weight)
        assert ref_module.draw_is_valid(prepared, bad, draw0.weight)
    ref = check.reference_run(ref_module, cfg, graph, data["weights"], steps)
    numbers = check.compare(first, ref)
    if planted == "same_as_step_1":
        assert np.isfinite(ref["losses"][0]) and np.isnan(ref["losses"][1])
        assert np.isnan(numbers["update_gap"])
    else:
        assert np.isnan(ref["losses"][0]) and torch.isnan(ref["logits"]).all()
    assert not check.judge(numbers, _smallest_limits())[0]
