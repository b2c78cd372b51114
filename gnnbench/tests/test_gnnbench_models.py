"""Each model, built from the port's public API on its plain (CPU) path,
against its plain reference at a tiny size: with every dropout off they
agree to float32 round-off; as configured (float32, dropout by the step's
keep masks), within the cell's limits."""
import json

import pytest
import torch

from gnnbench.harness import check, registry, training

from conftest import TINY_CELLS

SEED = 3_000_000_021


@pytest.fixture(scope="module")
def float32_root(tiny_root):
    """The tiny cells again, each with a copy of its configuration in float32
    with every dropout off."""
    for name, (config, _) in TINY_CELLS.items():
        cfg = registry.load_json("configs", config, tiny_root)
        cfg["precision"]["aggregation"] = "float32"
        for key in ("input_dropout", "dropout", "edge_dropout"):
            cfg[key] = 0.0
        (tiny_root / "configs" / f"{config}-f32.json").write_text(json.dumps(cfg))
        (tiny_root / "workloads" / f"{name}-f32.json").write_text(json.dumps(
            {"config": f"{config}-f32", "traffic": "tiny", "limits": {}}))
    return tiny_root


def _numbers(root, cell_name, seed=SEED):
    cell = registry.load_json("workloads", cell_name, root)
    data = training.make_data(cell, seed, torch.device("cpu"), root)
    first = training.Trainer(data, root).first_steps(3)
    ref = check.reference_run(registry.load_module("reference", data["cfg"]["model"], root),
                              data["cfg"], data["graph"], data["weights"], first["masks"])
    return check.compare(first, ref)


@pytest.mark.parametrize("cell", sorted(TINY_CELLS))
def test_model_matches_reference_in_float32(float32_root, cell):
    numbers = _numbers(float32_root, f"{cell}-f32")
    assert numbers["loss_gap"] < 1e-6
    assert numbers["logits_gap"] < 1e-5
    assert numbers["grad_gap"] < 1e-5
    assert numbers["update_gap"] < 1e-4


@pytest.mark.parametrize("cell", sorted(TINY_CELLS))
def test_model_in_its_configured_precision_is_within_the_limits(tiny_root, cell):
    limits = registry.load_json("workloads", cell, tiny_root)["limits"]
    correct, table = check.judge(_numbers(tiny_root, cell), limits)
    assert correct, table


def test_edge_products_match_dense_products():
    from gnnbench.reference._common import EdgeDot, EdgeSum, segment_softmax
    torch.manual_seed(0)
    n, heads, width = 7, 2, 3
    dst = torch.tensor([0, 0, 1, 2, 2, 2, 6, 3])
    src = torch.tensor([1, 1, 2, 0, 5, 6, 6, 4])
    x = torch.randn(n, heads * width, dtype=torch.float64, requires_grad=True)
    q = torch.randn(n, heads * width, dtype=torch.float64, requires_grad=True)
    w = torch.randn(dst.shape[0], heads, dtype=torch.float64, requires_grad=True)
    torch.autograd.gradcheck(lambda a, b: EdgeSum.apply(a, b, dst, src, n), (x, w))
    torch.autograd.gradcheck(lambda a, b: EdgeDot.apply(a, b, dst, src, heads), (q, x))
    dense = torch.zeros(heads, n, n, dtype=torch.float64)
    for e in range(dst.shape[0]):
        dense[:, dst[e], src[e]] += w[e].detach()
    want = torch.einsum("hij,jhd->ihd", dense, x.detach().view(n, heads, width))
    got = EdgeSum.apply(x.detach(), w.detach(), dst, src, n)
    assert torch.allclose(got, want.reshape(n, -1))
    s = torch.randn(dst.shape[0], heads, dtype=torch.float64)
    a = segment_softmax(s, dst, n)
    for r in dst.unique():
        assert torch.allclose(a[dst == r], torch.softmax(s[dst == r], dim=0))
