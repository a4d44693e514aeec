"""SPMD scale-out layer: device meshes, sharded merge steps, ring
collectives, and multi-host bootstrap — the replacement for the
reference's BiocParallel/DelayedArray concurrency (SURVEY.md §2.3, §5)."""

from .mesh import (
    make_cells_mesh,
    cells_sharding,
    replicated_sharding,
    pad_to_multiple,
)
from .distributed import (
    DistributedMergeOutput,
    distributed_merge_step,
    distributed_multi_batch_pca,
)
from .driver import distributed_fast_mnn
from .multihost import initialize_multihost, make_multihost_cells_mesh
from .ring import (
    ring_query_knn_local,
    ring_membership,
    ring_segment_reduce,
    ring_weighted_gather,
)

__all__ = [
    "make_cells_mesh",
    "cells_sharding",
    "replicated_sharding",
    "pad_to_multiple",
    "DistributedMergeOutput",
    "distributed_merge_step",
    "distributed_multi_batch_pca",
    "distributed_fast_mnn",
    "initialize_multihost",
    "make_multihost_cells_mesh",
    "ring_query_knn_local",
    "ring_membership",
    "ring_segment_reduce",
    "ring_weighted_gather",
]
