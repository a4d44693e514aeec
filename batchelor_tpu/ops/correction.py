"""fastMNN correction math: averaging, orthogonalization, tricube apply.

Equivalents of the reference's correction helpers
(R/fastMNN.R:567-658) and the tricube kernel (R/utils_tricube.R:1-27).
All functions take cells-in-rows arrays; pair lists are 0-based.

Variable-size MNN pair sets are handled by padding pair arrays to bucketed
lengths (static shapes under jit) with an overflow segment that is dropped,
so merge steps with different pair counts reuse compiled kernels.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .knn import query_knn

__all__ = [
    "average_correction",
    "batch_magnitude",
    "center_along_batch_vector",
    "orthogonalize_other",
    "pair_segment_sums",
    "per_batch_var",
    "tricube_average",
    "tricube_weights",
    "tricube_weighted_correction",
]


def tricube_weights(dist: jnp.ndarray, ndist: float = 3.0) -> jnp.ndarray:
    """Row-normalized tricube weights from ascending neighbour distances —
    THE tricube implementation, shared by the host engine, the fused step
    and the SPMD driver (via ops/merge_math.py).

    Bandwidth = ndist x the middle (ceiling(n/2)-th) neighbour distance,
    floored at 1e-8; relative distances clamp to 1 so farther neighbours get
    zero weight (reference R/utils_tricube.R:1-27). Rows may contain +inf
    distances (mask-excluded neighbours when fewer than k cells are
    MNN-involved): they get weight zero and the middle index shrinks to the
    valid count — matching the reference's k-shrinking
    (R/fastMNN.R:599-608 via min(k, nrow(data))).
    """
    finite = jnp.isfinite(dist)
    nv = jnp.sum(finite.astype(jnp.int32), axis=1)
    middle = jnp.maximum(-(-nv // 2) - 1, 0)  # 0-based ceil(nv/2), R/utils_tricube.R:6
    bw = jnp.take_along_axis(dist, middle[:, None], axis=1)[:, 0] * ndist
    bw = jnp.maximum(bw, 1e-8)
    rel = jnp.minimum(dist / bw[:, None], 1.0)
    tri = jnp.where(finite, (1.0 - rel**3) ** 3, 0.0)
    denom = jnp.sum(tri, axis=1, keepdims=True)
    return tri / jnp.maximum(denom, jnp.finfo(tri.dtype).tiny)


def pair_segment_sums(l_rows, l2r, mutual, n_segments: int, *, lo=0):
    """(sum of paired left rows, pair count) per right-cell segment.

    For each mutual pair (i, j = l2r[i, p]) accumulates l_rows[i] into
    segment j and 1 into its count, one neighbour position at a time via
    lax.scan — no (N1, k2, d) intermediate (OOMs at the 10^6-cell scale)
    and no unrolled per-position HLO (a Python loop over k2=20 positions
    costs minutes of XLA compile time at large N; the scan compiles once).

    ``lo``: only l2r values in [lo, lo + n_segments) contribute, shifted by
    -lo — the windowed form the ring reduce-scatter uses. Returns
    (lsums (n_segments, d), counts (n_segments,)).
    """
    from jax import lax as _lax

    dt = l_rows.dtype
    d = l_rows.shape[1]

    def body(carry, inp):
        lsums, counts = carry
        col, mut = inp                      # (N1,), (N1,) bool
        inr = mut & (col >= lo) & (col < lo + n_segments)
        seg = jnp.where(inr, col - lo, n_segments)
        w = inr.astype(dt)
        lsums = lsums + jax.ops.segment_sum(
            l_rows * w[:, None], seg, num_segments=n_segments + 1
        )
        counts = counts + jax.ops.segment_sum(
            w, seg, num_segments=n_segments + 1
        )
        return (lsums, counts), None

    init = (
        jnp.zeros((n_segments + 1, d), dt),
        jnp.zeros((n_segments + 1,), dt),
    )
    (lsums, counts), _ = _lax.scan(body, init, (l2r.T, mutual.T))
    return lsums[:n_segments], counts[:n_segments]


def _bucket(n: int, minimum: int = 256) -> int:
    """Next power-of-two bucket >= n (caps jit recompiles across steps)."""
    b = minimum
    while b < n:
        b <<= 1
    return b


@functools.partial(jax.jit, static_argnames=("n_segments",))
def _segment_average(diffs: jnp.ndarray, seg: jnp.ndarray, n_segments: int):
    sums = jax.ops.segment_sum(diffs, seg, num_segments=n_segments + 1)
    counts = jax.ops.segment_sum(
        jnp.ones((seg.shape[0],), diffs.dtype), seg, num_segments=n_segments + 1
    )
    sums = sums[:n_segments]
    counts = counts[:n_segments]
    avg = sums / jnp.maximum(counts, 1.0)[:, None]
    return avg, counts


def average_correction(
    refdata: jnp.ndarray,
    mnn1: np.ndarray,
    curdata: jnp.ndarray,
    mnn2: np.ndarray,
) -> Tuple[jnp.ndarray, np.ndarray]:
    """Per-MNN correction vectors averaged per involved right cell.

    Mirrors .average_correction (reference R/fastMNN.R:567-580): the
    correction for right cell j is mean over its pairs of (ref[i] - cur[j]).
    Returns (averaged, second): ``averaged`` has one row per MNN-involved
    right cell, rows ordered by ascending right-cell index (R rowsum group
    order); ``second`` lists those right-cell indices.
    """
    n_right = curdata.shape[0]
    npairs = int(np.asarray(mnn1).shape[0])
    bucket = _bucket(npairs)
    pad = bucket - npairs
    m1 = jnp.asarray(np.pad(np.asarray(mnn1), (0, pad)), dtype=jnp.int32)
    # padded entries go to the overflow segment n_right (dropped)
    m2 = jnp.asarray(
        np.pad(np.asarray(mnn2), (0, pad), constant_values=n_right), dtype=jnp.int32
    )
    diffs = refdata[m1] - curdata[jnp.minimum(m2, n_right - 1)]
    diffs = jnp.where((m2 < n_right)[:, None], diffs, 0.0)
    avg_full, counts = _segment_average(diffs, m2, n_right)
    second = np.unique(np.asarray(mnn2))
    return avg_full[jnp.asarray(second)], second


@jax.jit
def batch_magnitude(correction: jnp.ndarray) -> jnp.ndarray:
    """Relative magnitude of the average batch vector.

    sqrt(||mean(correction)||^2 / sum(colMeans(correction^2))); 0 when the
    denominator vanishes. Mirrors .get_batch_magnitude
    (reference R/fastMNN.R:582-595).
    """
    ave = jnp.mean(correction, axis=0)
    denom = jnp.sum(jnp.mean(jnp.square(correction), axis=0))
    num = jnp.sum(jnp.square(ave))
    return jnp.where(denom == 0, 0.0, jnp.sqrt(num / jnp.where(denom == 0, 1.0, denom)))


@jax.jit
def _center_along(mat: jnp.ndarray, batch_vec: jnp.ndarray, restrict_mask: jnp.ndarray):
    vec = batch_vec / jnp.sqrt(jnp.sum(jnp.square(batch_vec)))
    loc = jnp.matmul(mat, vec, precision=jax.lax.Precision.HIGHEST)
    w = restrict_mask.astype(mat.dtype)
    central = jnp.sum(loc * w) / jnp.sum(w)
    return mat + jnp.outer(central - loc, vec)


def center_along_batch_vector(
    mat: jnp.ndarray,
    batch_vec: jnp.ndarray,
    restrict: Optional[np.ndarray] = None,
) -> jnp.ndarray:
    """Remove variation along ``batch_vec`` within one matrix.

    Projects cells onto the normalized batch vector and shifts every cell to
    the (restricted) mean position along it. Mirrors
    .center_along_batch_vector (reference R/fastMNN.R:626-640).
    """
    n = mat.shape[0]
    if restrict is None:
        mask = jnp.ones((n,), dtype=bool)
    else:
        m = np.zeros(n, dtype=bool)
        m[np.asarray(restrict)] = True
        mask = jnp.asarray(m)
    return _center_along(mat, jnp.asarray(batch_vec, mat.dtype), mask)


def orthogonalize_other(
    data: jnp.ndarray,
    restrict: Optional[np.ndarray],
    vectors: Sequence[jnp.ndarray],
) -> jnp.ndarray:
    """Replay prior merge steps' batch vectors on a new batch.

    Mirrors .orthogonalize_other (reference R/fastMNN.R:642-647)."""
    for vec in vectors:
        data = center_along_batch_vector(data, vec, restrict)
    return data


@functools.partial(jax.jit, static_argnames=("nseg",))
def _per_batch_var_segments(data, labels, counts, nseg: int):
    # shift by the global per-dim mean before squaring: the sum-of-squares
    # minus n*mu^2 identity cancels catastrophically in fp32 when the
    # within-batch variance is small against the batch offset.
    acc = jnp.promote_types(data.dtype, jnp.float32)
    x = data.astype(acc) - jnp.mean(data.astype(acc), axis=0)[None, :]
    sums = jax.ops.segment_sum(x, labels, num_segments=nseg)
    sqs = jax.ops.segment_sum(jnp.square(x), labels, num_segments=nseg)
    cnt = counts[:, None].astype(acc)
    safe = jnp.maximum(cnt, 1.0)
    ssd = jnp.sum(sqs - jnp.square(sums) / safe, axis=1)
    return jnp.where(counts >= 2, ssd / jnp.maximum(counts - 1.0, 1.0), 0.0)


def per_batch_var(data: jnp.ndarray, index: Sequence[int], origin: np.ndarray) -> np.ndarray:
    """Sum of per-dimension sample variances within each original batch.

    Mirrors .compute_perbatch_var (reference R/fastMNN.R:651-658); the
    variance uses the n-1 denominator like R's colVars. One fused
    segment-sum pass + ONE host fetch (the previous per-batch Python loop
    cost a device round-trip per original batch per call — dozens of
    pipeline stalls per merge step late in a many-batch atlas).
    """
    origin = np.asarray(origin)
    index = list(index)
    mapping = np.zeros(int(max(index)) + 1, dtype=np.int32)
    mapping[np.asarray(index, dtype=np.int64)] = np.arange(len(index), dtype=np.int32)
    labels = mapping[origin]
    counts = np.bincount(labels, minlength=len(index)).astype(np.float64)
    out = _per_batch_var_segments(
        data, jnp.asarray(labels), jnp.asarray(counts, jnp.float64), len(index)
    )
    return np.asarray(out, dtype=np.float64)


@functools.partial(jax.jit, static_argnames=("ndist",))
def _tricube_from_knn(
    vals: jnp.ndarray, indices: jnp.ndarray, distances: jnp.ndarray, ndist: float
):
    w = tricube_weights(distances, ndist)
    return jnp.einsum("nk,nkd->nd", w, vals[indices],
                      precision=jax.lax.Precision.HIGHEST)


def tricube_average(
    vals: jnp.ndarray,
    indices: jnp.ndarray,
    distances: jnp.ndarray,
    ndist: float = 3.0,
    bandwidth: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """Tricube-weighted average of neighbour values.

    Bandwidth defaults to ndist x the middle (ceiling(k/2)-th) neighbour
    distance, floored at 1e-8; relative distances clamp to 1 so neighbours
    beyond the bandwidth get zero weight. Mirrors .compute_tricube_average
    (reference R/utils_tricube.R:1-27).
    """
    if bandwidth is not None:
        bw = jnp.maximum(jnp.asarray(bandwidth), 1e-8)
        rel = jnp.minimum(distances / bw[:, None], 1.0)
        tri = (1.0 - rel**3) ** 3
        w = tri / jnp.sum(tri, axis=1, keepdims=True)
        return jnp.einsum("nk,nkd->nd", w, vals[indices],
                          precision=jax.lax.Precision.HIGHEST)
    return _tricube_from_knn(vals, jnp.asarray(indices), jnp.asarray(distances), float(ndist))


def tricube_weighted_correction(
    curdata: jnp.ndarray,
    correction: jnp.ndarray,
    in_mnn: np.ndarray,
    k: int = 20,
    ndist: float = 3.0,
) -> jnp.ndarray:
    """Apply per-cell corrections smoothed from MNN-involved cells.

    Each right cell queries its nearest MNN-involved right cells and takes
    the tricube-weighted average of their averaged correction vectors.
    Mirrors .tricube_weighted_correction (reference R/fastMNN.R:599-608).
    """
    uniq = curdata[jnp.asarray(in_mnn)]
    safe_k = min(k, uniq.shape[0])
    closest = query_knn(curdata, uniq, safe_k)
    weighted = _tricube_from_knn(correction, closest.indices, closest.distances, float(ndist))
    return curdata + weighted
