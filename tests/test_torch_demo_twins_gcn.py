"""The GCN-variant demo twins (``tf_geometric_tpu_torch/demos``:
``demo_drop_edge_gcn``, ``demo_sparse_node_features``) against the JAX
scripts (``demo/``) on the CPU, by ``test_torch_demo_twins_node.py``'s
check: each JAX script's ``main`` three steps on the small synthetic graph,
recorded (the DropEdge mask and the seven dropout masks of each step), then
the twin's ``main`` from the script's weights with those masks: the
eval-mode logits, the three losses and the step-1 gradients within
rtol = atol = 1e-4, the test accuracy within one node. Also the DropEdge
graph's normalization (the dropped edges pointing at the sink row) against
JAX's.
"""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_demo_twins_node import TOL, _graphs, check_twin, offline  # noqa: F401
from tf_geometric_tpu_torch import convert
from tf_geometric_tpu_torch.demos import demo_drop_edge_gcn, demo_sparse_node_features

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "demo"))

import demo_drop_edge_gcn as jdemo_drop_edge_gcn  # noqa: E402
import demo_sparse_node_features as jdemo_sparse_node_features  # noqa: E402

GCN_TWINS = {
    "drop_edge_gcn": (jdemo_drop_edge_gcn, demo_drop_edge_gcn,
                      lambda params: convert.gcn_state_dict_from_flax({"params": params}), 8,
                      lambda m: (torch.as_tensor(m[0]), [torch.as_tensor(k) for k in m[1:]])),
    "sparse_node_features": (jdemo_sparse_node_features, demo_sparse_node_features,
                             convert.numpy_params_state_dict, 0, None),
}


@pytest.mark.parametrize("name", list(GCN_TWINS))
def test_gcn_twin_matches_jax_script(name, monkeypatch):
    check_twin(GCN_TWINS[name], monkeypatch)


def test_drop_edge_sink_normalizes_as_jax():
    """The DropEdge graph as the deep GCN's layers see it: the dropped edges
    at the sink row ``num_nodes`` (index and zero weight as JAX's), and the
    GCN normalization of that graph (self-loops, degrees, values) equal to
    JAX's, the sink entries falling out of the product alike."""
    from tf_geometric_tpu.nn.conv.gcn import gcn_norm_adj as jgcn_norm_adj
    from tf_geometric_tpu.nn.sampling.drop_edge import drop_edge as jdrop_edge
    from tf_geometric_tpu.sparse.matrix import SparseMatrix as JSparseMatrix
    import jax
    from tf_geometric_tpu_torch.nn.conv.gcn import gcn_norm_adj
    from tf_geometric_tpu_torch.nn.sampling.drop_edge import drop_edge
    from tf_geometric_tpu_torch.sparse import SparseMatrix
    (jgraph, _), (pgraph, _) = _graphs()
    n = pgraph.num_nodes
    key = jax.random.PRNGKey(5)
    jei, jew = jdrop_edge([jnp.asarray(jgraph.edge_index), jnp.asarray(jgraph.edge_weight)],
                          rate=0.5, training=True, key=key, num_nodes=n)
    keep = np.asarray(jei[0]) < n
    assert 0 < keep.sum() < keep.size
    ei, ew = drop_edge([pgraph.edge_index, pgraph.edge_weight], rate=0.5, training=True,
                       num_nodes=n, keep_mask=torch.as_tensor(keep))
    np.testing.assert_array_equal(ei.numpy(), np.asarray(jei))
    np.testing.assert_array_equal(ew.numpy(), np.asarray(jew))
    want = jgcn_norm_adj(JSparseMatrix(jei, jew, (n, n)))
    got = gcn_norm_adj(SparseMatrix(ei, ew, (n, n), device="cpu"))
    np.testing.assert_array_equal(got.index.numpy(), np.asarray(want.index))
    np.testing.assert_allclose(got.value.numpy(), np.asarray(want.value), rtol=1e-6, atol=1e-7)
    h = np.random.default_rng(0).normal(size=(n, 8)).astype(np.float32)
    np.testing.assert_allclose((got @ torch.as_tensor(h)).numpy(),
                               np.asarray(want @ jnp.asarray(h)), **TOL)
