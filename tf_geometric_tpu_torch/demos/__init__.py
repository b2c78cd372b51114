"""Twins of the JAX package's demo scripts (``demo/``), runnable as
``python -m tf_geometric_tpu_torch.demos.<name>``: ``demo_utils`` (the
loaders, the masked loss, the training loops, the graph-classification
models' base), ``demo_gcn`` and ``demo_gat`` (node classification), and
``demo_mean_pool``, ``demo_gin``, ``demo_sag_pool_h``, ``demo_sort_pool``,
``demo_diff_pool``, ``demo_min_cut_pool`` (graph classification). Each
``main`` runs on the card unless it is given ``device="cpu"``."""
