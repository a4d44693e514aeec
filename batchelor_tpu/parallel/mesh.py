"""Device mesh construction and sharding helpers.

The replacement for the reference's BiocParallel worker-pool
plumbing (reference R/fastMNN.R:301-304, SURVEY.md L10): concurrency is a
declared 1-D "cells" mesh; per-cell arrays are sharded over it, small state
(rotations, batch vectors, pair masks) is replicated, and cross-device
reductions are explicit psums emitted by shard_map.
"""
from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_cells_mesh", "cells_sharding", "replicated_sharding", "pad_to_multiple"]

CELLS_AXIS = "cells"


def make_cells_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """1-D mesh with a single ``cells`` axis over the first n devices of
    the default platform (or of ``devices``). Asking for more devices than
    there are raises; nothing falls back to another platform. The cards of
    one host reach each other all to all, so the mesh follows the algorithm
    alone: one axis over the cells.
    """
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(
                f"requested {n_devices} devices but only {len(devices)} available"
            )
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (CELLS_AXIS,))


def cells_sharding(mesh: Mesh) -> NamedSharding:
    """Rows (cells) sharded, feature columns replicated."""
    return NamedSharding(mesh, P(CELLS_AXIS, None))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def pad_to_multiple(x, multiple: int, axis: int = 0):
    """Pad ``x`` with zeros along ``axis`` to a multiple; returns (padded, n)."""
    import jax.numpy as jnp

    n = x.shape[axis]
    target = -(-n // multiple) * multiple
    if target == n:
        return x, n
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, target - n)
    return jnp.pad(x, widths), n
