"""Fused, fully-jittable fastMNN merge step (the performance path).

The host-orchestrated engine in fast_mnn.py is the reference-parity path:
it materializes pair lists per step for diagnostics. This module is the
performance path: one jit-compiled function per merge that never syncs
with the host — static shapes throughout, variable-size MNN pair sets
carried as masks over the dense (N1 x k2) candidate array, segment
reductions over full-size right-cell arrays.

The per-step math is the shared ops/merge_math.merge_step_body — the same
implementation the SPMD driver runs (with its collectives disabled), so the
fused path is equivalent to the host engine (reference R/fastMNN.R:436-562)
including the degenerate fewer-MNN-involved-cells-than-k case, where the
tricube bandwidth's middle index shrinks with the valid neighbour count
(see ops.merge_math.tricube_weights). tests/test_fused.py pins the
fused == host equivalence.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..ops.merge_math import merge_step_body

__all__ = ["fused_merge_step", "FusedMergeOutput"]


class FusedMergeOutput(NamedTuple):
    left: jnp.ndarray          # corrected left coordinates
    right: jnp.ndarray         # corrected right coordinates
    overall: jnp.ndarray       # average batch vector (d,)
    batch_size: jnp.ndarray    # scalar relative batch-effect magnitude
    n_pairs: jnp.ndarray       # scalar number of MNN pairs
    pair_mask: jnp.ndarray     # (N1, k2) bool: which candidates are MNN pairs
    pair_targets: jnp.ndarray  # (N1, k2) right-cell index per candidate


@functools.partial(
    jax.jit, static_argnames=("k1", "k2", "tricube_k", "ndist", "knn_method")
)
def fused_merge_step(
    left: jnp.ndarray,
    right: jnp.ndarray,
    k1: int,
    k2: int,
    tricube_k: int = 20,
    ndist: float = 3.0,
    min_batch_skip: float = 0.0,
    knn_method: str = "exact",
) -> FusedMergeOutput:
    """One fastMNN merge: MNN detection, orthogonalization, tricube apply.

    left: (N1, d) reference set; right: (N2, d) set being corrected.
    k1/k2: neighbours searched in left/right respectively. ``knn_method``
    selects the kNN backend ("auto" | "exact" | "chunked" | "bf16"; see
    ops.knn.query_knn), the analog of the reference's BNPARAM.
    """
    n1 = left.shape[0]
    n2 = right.shape[0]
    ones_l = jnp.ones((n1,), dtype=bool)
    ones_r = jnp.ones((n2,), dtype=bool)

    left_c, right_out, overall, magnitude, n_pairs, mutual, l2r = (
        merge_step_body(
            left, right, ones_l, ones_r, ones_l, ones_r,
            k1=k1, k2=k2, tricube_k=tricube_k, ndist=ndist,
            min_batch_skip=min_batch_skip, knn_method=knn_method,
            axis=None, with_var=False,
        )
    )

    return FusedMergeOutput(
        left=left_c,
        right=right_out,
        overall=overall,
        batch_size=magnitude,
        n_pairs=n_pairs,
        pair_mask=mutual,
        pair_targets=l2r,
    )
