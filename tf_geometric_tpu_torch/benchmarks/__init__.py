"""Twins of the JAX package's accuracy benchmarks (``benchmarks/``): the
five early-stop node-classification scripts with their head-to-head harness
(``node_classification``) and the graph-classification harness
(``graph_classification``). They read the JAX side's committed per-seed
results as data and import nothing of the JAX package."""
