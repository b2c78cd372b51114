"""Set-up and the training step of a cell.

One ``Trainer`` holds the model, its optimizer state and the full batch. Its
``step`` is the window's call: the step's dropout keep masks drawn on the
device, forward, mean cross entropy over all nodes (plus the configuration's
L2 term), backward, ``torch.optim.Adam``. It never synchronizes the host;
the loss stays on the device. ``first_steps`` drives that same object
through its first steps at set-up and keeps what the correctness check
compares, the keep masks that the reference is handed among them.
"""
from __future__ import annotations

import contextlib
from typing import Dict

import torch
import torch.nn.functional as F

from tf_geometric_tpu_torch.layers import l2_loss

from gnnbench.harness import registry
from gnnbench.reference._common import glorot_limit

_NO_SPAN = contextlib.nullcontext


def make_data(cell: dict, seed: int, device, root=registry.BENCH_DIR) -> dict:
    """The cell's graph from ``--seed``, then the initial weights from the
    same generator: kernels glorot-uniform, biases zero (or the reference's
    ``initial_values``), all drawn in one call on ``device``. The generator
    goes on to draw the steps' keep masks (``draw_masks``)."""
    traffic = registry.load_json("traffic", cell["traffic"], root)
    cfg = registry.load_json("configs", cell["config"], root)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    graph = registry.load_module("graphs", traffic["generator"], root).make(traffic, gen, device)
    ref = registry.load_module("reference", cfg["model"], root)
    shapes = ref.param_shapes(cfg, graph["x"].shape[1], graph["num_classes"])
    kernels = {n: s for n, s in shapes.items() if len(s) == 2}
    flat = torch.rand(sum(a * b for a, b in kernels.values()), generator=gen, device=device)
    weights, at = {}, 0
    for name, shape in shapes.items():
        if name in kernels:
            size = shape[0] * shape[1]
            weights[name] = (flat[at:at + size].view(shape) * 2 - 1) * glorot_limit(shape)
            at += size
        else:
            fill = ref.initial_values(name)
            weights[name] = torch.full(shape, 0.0 if fill is None else fill, device=device)
    n, f, c = graph["num_nodes"], graph["x"].shape[1], graph["num_classes"]
    dropouts = ref.dropouts(cfg, n, f, c, graph["edge_index"].shape[1] + n)
    return {"cfg": cfg, "traffic": traffic, "graph": graph, "weights": weights,
            "generator": gen, "dropouts": dropouts}


def draw_masks(dropouts: dict, generator: torch.Generator, device) -> dict:
    """One step's keep masks (bool), each kept with probability 1 - rate."""
    return {name: torch.rand(shape, generator=generator, device=device) < (1.0 - rate)
            for name, (shape, rate) in dropouts.items()}


class Trainer:
    def __init__(self, data: dict, root=registry.BENCH_DIR):
        cfg, graph = data["cfg"], data["graph"]
        builder = registry.load_module("models", cfg["model"], root)
        self.model, self.leaves = builder.build(cfg, graph, data["weights"])
        self.x, self.y = graph["x"], graph["y"]
        self.l2_coef = cfg.get("l2_coef", 0.0)
        self.generator, self.dropouts = data["generator"], data["dropouts"]
        opt = cfg["optimizer"]
        self.betas = tuple(opt["betas"])
        self.opt = torch.optim.Adam(self.model.parameters(), lr=opt["lr"], betas=self.betas,
                                    eps=opt["eps"], weight_decay=opt["weight_decay"])

    # The step's parts are methods, so that a test can break one of them.
    def forward(self, masks):
        return self.model(self.x, masks)

    def loss(self, logits, y):
        ce = F.cross_entropy(logits, y)
        return ce + l2_loss(self.leaves, self.l2_coef) if self.l2_coef else ce

    def optimizer_step(self):
        self.opt.step()
        self.opt.zero_grad(set_to_none=True)

    def step(self, span=_NO_SPAN):
        with span("forward"):
            masks = draw_masks(self.dropouts, self.generator, self.x.device)
            logits = self.forward(masks)
        with span("loss"):
            loss = self.loss(logits, self.y)
        with span("backward"):
            loss.backward()
        with span("optimizer"):
            self.optimizer_step()
        return loss.detach(), logits.detach(), masks

    def first_steps(self, steps: int) -> dict:
        """Runs the first ``steps`` steps through ``step`` and keeps each
        loss and keep masks, the first logits, the first gradient as Adam
        holds it after one step (``exp_avg / (1 - beta1)``), and the weights
        before the first step and after the last (before the next step
        changes them)."""
        leaves: Dict[str, torch.Tensor] = self.leaves
        rec = {"params0": {n: p.detach().clone() for n, p in leaves.items()}, "losses": [],
               "masks": []}
        for t in range(1, steps + 1):
            loss, logits, masks = self.step()
            rec["losses"].append(loss)
            rec["masks"].append(masks)
            if t == 1:
                rec["logits"] = logits
                # a leaf the optimizer never got a gradient for has no state
                rec["grads"] = {n: self.opt.state[p].get("exp_avg", torch.zeros_like(p))
                                / (1 - self.betas[0]) for n, p in leaves.items()}
        rec["params"] = {n: p.detach().clone() for n, p in leaves.items()}
        return rec
