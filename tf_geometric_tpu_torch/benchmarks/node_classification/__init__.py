"""The early-stop node-classification bench twins
(``bench_node_cls_early_stop_{gcn,gat,sgc,ssgc,appnp}``, JAX counterparts
under ``benchmarks/node_classification/``), their shared loop
(``early_stop``) and the port-side head-to-head harness
(``head_to_head_port``)."""
