from .dataset import Dataset, DownloadableDataset, default_dataset_root
from .graph import BatchGraph, Graph, HeteroBatchGraph, HeteroGraph
from .padding import (PaddingSpec, batch_padding_spec, bucket_size, pad_batch_graph, pad_graph,
                      padded_batch_generator)

__all__ = ["Graph", "BatchGraph", "HeteroGraph", "HeteroBatchGraph", "Dataset",
           "DownloadableDataset", "default_dataset_root", "PaddingSpec", "bucket_size",
           "pad_graph", "pad_batch_graph", "batch_padding_spec", "padded_batch_generator"]
