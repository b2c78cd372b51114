"""Twins of the JAX package's demo scripts (``demo/``), runnable as
``python -m tf_geometric_tpu_torch.demos.<name>``: ``demo_utils`` (the
loaders, the masked loss, the training loops, the graph-classification
models' base); node classification: ``demo_gcn``, ``demo_gat``, the
propagation family ``demo_sgc``, ``demo_appnp``, ``demo_ssgc``,
``demo_tagcn``, ``demo_chebynet``, the GCN variants
``demo_drop_edge_gcn`` and ``demo_sparse_node_features``; unsupervised
and link prediction: ``demo_gae``, ``demo_dgi``; sampling:
``demo_device_sampling`` (draws on the device), ``demo_graph_sage`` and
``demo_graph_sage_func`` (host draws); heterogeneous graphs:
``demo_hetero_rgcn``; graph classification: ``demo_mean_pool``,
``demo_gin``, ``demo_sag_pool_h``, ``demo_sort_pool``, ``demo_diff_pool``,
``demo_min_cut_pool``, ``demo_asap``, ``demo_set2set``,
``demo_topk_pool``, ``demo_model_net_dataset``; serialization:
``demo_checkpoint``, ``demo_save_and_load_model``; the host sampling
walkthrough ``demo_sample_neighbors``; the API tours ``demo_elegant_api``
and ``tutorial_intro`` (the repository root's tutorial); parallel training
on ``torch.distributed`` ranks: ``demo_distributed_gcn`` (graph-parallel),
``demo_distributed_mean_pool`` (data-parallel). Each ``main`` runs on the
card unless it is given ``device="cpu"`` (``--cpu`` on the command line;
the parallel twins take the rank count after it)."""
