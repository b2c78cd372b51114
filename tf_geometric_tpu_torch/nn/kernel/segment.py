"""Segment reduction primitives, re-exported from the package-root core
module (``tf_geometric_tpu_torch/_segment_core.py``) so that ``sparse`` can
use them without importing the ``nn`` package."""
from ..._segment_core import (segment_sum, segment_mean, segment_max, segment_min,
                              segment_softmax, segment_count, segment_normalize,
                              segment_op_with_pad)

__all__ = ["segment_sum", "segment_mean", "segment_max", "segment_min",
           "segment_softmax", "segment_count", "segment_normalize",
           "segment_op_with_pad"]
