"""Twins of the JAX package's demo scripts (``demo/``), runnable as
``python -m tf_geometric_tpu_torch.demos.<name>``: ``demo_utils`` (the
loaders, the masked loss and the training loops), ``demo_gcn`` and
``demo_gat``. Each ``main`` runs on the card unless it is given
``device="cpu"``."""
