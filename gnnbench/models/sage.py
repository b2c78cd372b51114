"""The port's GraphSAGE configuration, built from its public API: an
``nn.sampling.DeviceNeighborSampler`` over the graph's edge list (its CSR
built at set-up), then ``layers.MeanGraphSage`` layers (ReLU, no bias, self
and neighbour halves concatenated), each fed a fresh
draw of the configuration's fanout per node from the model's own generator
(seeded with ``draw_seed``), then the dense head. Each forward writes its
draws into the step's dict as ``draw0``, ``draw1``, ..., beside where keep
masks would be, so that the reference trains on the same draws."""
from __future__ import annotations

import torch
from torch import nn

from tf_geometric_tpu_torch import layers
from tf_geometric_tpu_torch.nn.sampling import DeviceNeighborSampler, FixedKDraw


class Sage(nn.Module):
    def __init__(self, cfg: dict, graph: dict):
        super().__init__()
        x, n = graph["x"], graph["num_nodes"]
        dev = x.device
        self.fanouts = list(cfg["fanouts"])
        dims = [x.shape[1]] + [cfg["units"]] * len(self.fanouts)
        self.convs = nn.ModuleList(
            layers.MeanGraphSage(a, b, activation=torch.relu, use_bias=False, device=dev)
            for a, b in zip(dims, dims[1:]))
        self.dense_kernel = nn.Parameter(torch.zeros(dims[-1], graph["num_classes"], device=dev))
        self.sampler = DeviceNeighborSampler(graph["edge_index"], num_nodes=n, device=dev)
        self.generator = torch.Generator(device=dev)
        self.generator.manual_seed(int(cfg["draw_seed"]))

    def forward(self, x, masks):
        h = x
        for i, (conv, k) in enumerate(zip(self.convs, self.fanouts)):
            draw: FixedKDraw = self.sampler.sample(self.generator, k)
            masks[f"draw{i}"] = draw
            h = conv([h, draw])
        return h @ self.dense_kernel


def build(cfg: dict, graph: dict, weights: dict):
    """The model with ``weights`` loaded, and its parameters by the
    reference's names."""
    model = Sage(cfg, graph)
    leaves = {f"sage{i}.{name}": getattr(conv, name)
              for i, conv in enumerate(model.convs)
              for name in ("self_kernel", "neighbor_kernel")}
    leaves["dense.kernel"] = model.dense_kernel
    with torch.no_grad():
        for name, p in leaves.items():
            p.copy_(weights[name])
    return model, leaves
