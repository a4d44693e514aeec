"""Multi-host initialization and host x local-device mesh construction.

The communication backend replacing the reference's BiocParallel worker
pools (SURVEY.md §5 "Distributed communication backend"): jax.distributed
for process bootstrap, then a hybrid mesh whose outer axis spans hosts
(the network between machines) and inner axis spans each host's local
devices (their own interconnect). For the 1-D cell-sharding layout used by
this framework the two axes are flattened into the single "cells" axis —
collectives between co-located devices stay on the host's interconnect and
only the host-boundary segments cross the network.
"""
from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh

from .mesh import CELLS_AXIS

__all__ = ["initialize_multihost", "make_multihost_cells_mesh"]


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    initialization_timeout: Optional[float] = None,
) -> None:
    """jax.distributed.initialize wrapper; no-op when single-process or when
    already initialized. On clusters whose environment JAX recognises, all
    arguments are auto-detected; elsewhere pass them.

    Failure policy: only the fully-auto-detected case (no arguments) may
    silently degrade to single-process — that is the ordinary laptop/single
    -host run. When any coordination argument IS given, the caller asked for
    a pod; errors surface loudly instead of silently running 1/N of the job.
    """
    if jax.process_count() > 1:
        return  # already initialized
    explicit = any(
        v is not None for v in (coordinator_address, num_processes, process_id)
    )
    kwargs = {}
    if initialization_timeout is not None:
        kwargs["initialization_timeout"] = initialization_timeout
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
            **kwargs,
        )
    except (ValueError, RuntimeError):
        if explicit:
            raise
        # auto-detect found no coordinator: single-process run, fine.
        pass


def make_multihost_cells_mesh() -> Mesh:
    """1-D cells mesh over all global devices, ordered host-major so that
    contiguous shard ranges stay on one host and the host-boundary
    collectives are the only cross-machine traffic."""
    devices = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    return Mesh(np.array(devices), (CELLS_AXIS,))
