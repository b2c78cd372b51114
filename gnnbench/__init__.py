"""The benchmark of ``tf_geometric_tpu_torch``: full-batch GNN training steps
on one card, driven by the data files of this folder (see ``run.py``)."""
