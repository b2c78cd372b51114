"""The personalized-PageRank demo twins (``tf_geometric_tpu_torch/demos``:
``demo_appnp``, ``demo_ssgc``) against the JAX scripts (``demo/``) on the
CPU, by ``test_torch_demo_twins_node.py``'s check (its own file: JAX's
ten-hop steps take the longest to compile of the node twins).
"""
import pytest

from tests.test_torch_demo_twins_node import NODE_TWINS, check_twin, offline  # noqa: F401


@pytest.mark.parametrize("name", ["appnp", "ssgc"])
def test_ppr_twin_matches_jax_script(name, monkeypatch):
    check_twin(NODE_TWINS[name], monkeypatch)
