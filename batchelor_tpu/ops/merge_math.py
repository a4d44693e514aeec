"""The one implementation of the fastMNN merge-step math.

Every execution mode — the single-device fused step (correct/fused.py), the
SPMD gather-mode driver step and the constant-memory ring step
(parallel/driver.py) — shares these bodies; a mode differs only in which
collectives it threads through (``axis=None`` means single-device: psum and
all_gather become identities). This mirrors the reference, which has exactly
one .fast_mnn_core (R/fastMNN.R:436-562) regardless of the BPPARAM backend.

Semantics per helper:
  * center_along       — .center_along_batch_vector (R/fastMNN.R:626-640)
  * replay_extras      — .orthogonalize_other (R/fastMNN.R:642-647)
  * batch_vector_stats — .average_correction colMeans + .get_batch_magnitude
                         (R/fastMNN.R:567-595)
  * tricube_weights    — .compute_tricube_average (R/utils_tricube.R:1-27),
                         with the reference's k-shrinking for fewer
                         MNN-involved cells than k expressed dynamically
                         (rows with non-finite distances drop out and the
                         bandwidth's middle index shrinks with them)
  * perbatch_var       — .compute_perbatch_var (R/fastMNN.R:651-658)
  * merge_step_body    — .fast_mnn_core's per-step sequence
                         (R/fastMNN.R:448-525)
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax

from .correction import pair_segment_sums, tricube_weights
from .knn import query_knn
from .mutual_nn import membership_rows

__all__ = [
    "pmaybe",
    "gmaybe",
    "center_along",
    "replay_extras",
    "batch_vector_stats",
    "tricube_weights",
    "perbatch_var",
    "merge_step_body",
    "merge_step_search",
    "merge_step_correct",
]


def pmaybe(x, axis: Optional[str]):
    """psum over the mesh axis, or identity when single-device."""
    return x if axis is None else lax.psum(x, axis)


def gmaybe(x, axis: Optional[str]):
    """Tiled all_gather over the mesh axis, or identity when single-device."""
    return x if axis is None else lax.all_gather(x, axis, tiled=True)


def along(shard, v):
    """Each row's position along ``v``, with fp32 products (a TF32 default
    would put ~1e-4 relative error into every centring)."""
    return jnp.matmul(shard, v, precision=lax.Precision.HIGHEST)


def center_along(shard, stat_mask, v, axis: Optional[str] = None):
    """Shift every cell to the masked mean position along unit vector ``v``
    (the "kissing"-protection orthogonalization). Returns (centered, mean)."""
    dt = shard.dtype
    loc = along(shard, v)
    total = pmaybe(jnp.sum(jnp.where(stat_mask, loc, 0.0)), axis)
    cnt = pmaybe(jnp.sum(stat_mask.astype(dt)), axis)
    mean = total / cnt
    return shard + jnp.outer(mean - loc, v), mean


def replay_extras(shard, stat_mask, extras, axis: Optional[str] = None):
    """Orthogonalization replay of prior batch vectors, as a scan over a
    padded vector table; zero rows are skipped (so one compiled step serves
    every merge depth)."""

    def body(sh, vec):
        nrm = jnp.sum(jnp.square(vec))
        v = vec / jnp.sqrt(jnp.where(nrm > 0, nrm, 1.0))
        cand, _ = center_along(sh, stat_mask, v, axis)
        return jnp.where(nrm > 0, cand, sh), None

    shard, _ = lax.scan(body, shard, extras)
    return shard


def batch_vector_stats(avg, involved, axis: Optional[str] = None):
    """(overall batch vector, relative magnitude) from the per-right-cell
    averaged-correction table. Pass ``axis`` when the table is sharded
    (ring mode); a replicated table reduces locally."""
    n_involved = jnp.maximum(pmaybe(jnp.sum(involved), axis), 1)
    overall = (
        pmaybe(jnp.sum(jnp.where(involved[:, None], avg, 0.0), axis=0), axis)
        / n_involved
    )
    denom = (
        pmaybe(jnp.sum(jnp.sum(jnp.square(avg), axis=1) * involved), axis)
        / n_involved
    )
    num = jnp.sum(jnp.square(overall))
    magnitude = jnp.where(
        denom == 0, 0.0, jnp.sqrt(num / jnp.where(denom == 0, 1.0, denom))
    )
    return overall, magnitude


def perbatch_var(shard, origin, valid, nb: int, axis: Optional[str] = None):
    """Sum of per-dimension sample variances per global batch id (n-1
    denominator like R's colVars), reduced over the mesh. Two-pass (mean,
    then squared deviations) for accuracy. Pad rows must carry origin in
    [0, nb)."""
    dt = shard.dtype
    w = valid.astype(dt)
    cnt = pmaybe(jax.ops.segment_sum(w, origin, num_segments=nb), axis)
    sums = pmaybe(
        jax.ops.segment_sum(shard * w[:, None], origin, num_segments=nb), axis
    )
    mu = sums / jnp.maximum(cnt, 1.0)[:, None]
    dev = shard - mu[origin]
    sq = pmaybe(
        jax.ops.segment_sum(
            jnp.sum(jnp.square(dev), axis=1) * w, origin, num_segments=nb
        ),
        axis,
    )
    return jnp.where(cnt >= 2, sq / jnp.maximum(cnt - 1.0, 1.0), 0.0)


def _mutual_mask(lshard, rshard, lvalid, rvalid, lres, rres, k1, k2,
                 knn_method, axis: Optional[str]):
    """MNN membership mask via (possibly all-gathered) opposing sets.
    Returns (mutual, l2r, full_right, full_left, full_rvalid)."""
    my = 0 if axis is None else lax.axis_index(axis)
    nsl = lshard.shape[0]
    full_right = gmaybe(rshard, axis)
    full_left = gmaybe(lshard, axis)
    frv = gmaybe(rvalid & rres, axis)
    flv = gmaybe(lvalid & lres, axis)
    l2r, _ = query_knn(lshard, full_right, k2, data_mask=frv, method=knn_method)
    r2l, _ = query_knn(rshard, full_left, k1, data_mask=flv, method=knn_method)
    r2l_full = gmaybe(r2l, axis)
    my_ids = my * nsl + jnp.arange(nsl, dtype=l2r.dtype)
    mutual = membership_rows(l2r, r2l_full, my_ids)
    mutual = mutual & (lres & lvalid)[:, None]
    full_rvalid = gmaybe(rvalid, axis)
    return mutual, l2r, full_right, full_left, full_rvalid


def merge_step_search(
    lshard, rshard, lvalid, rvalid, lres, rres,
    lorigin=None, rorigin=None, lextras=None, rextras=None,
    *,
    k1: int, k2: int, knn_method: str = "exact", nb: int = 2,
    axis: Optional[str] = None, with_var: bool = True,
):
    """Phase 1 of a merge step: pre-merge variances, orthogonalization
    replay, the two kNN searches and the mutual membership test.

    Split out so the driver can execute a large step as two jits, bounding
    each program's size and memory plan (parallel/driver.py
    SPLIT_PAD_ROWS); phase intermediates stay on device either way.

    Returns (lshard_replayed, rshard_replayed, mutual, l2r, n_pairs,
    var_old-or-None).
    """
    var_old = None
    if with_var:
        # pre-merge per-batch variance, before replay (host-engine order:
        # per_batch_var precedes orthogonalize_other, reference R/fastMNN.R:467)
        var_old = (
            perbatch_var(lshard, lorigin, lvalid, nb, axis)
            + perbatch_var(rshard, rorigin, rvalid, nb, axis)
        )
    if lextras is not None:
        rshard = replay_extras(rshard, rres & rvalid, lextras, axis)
    if rextras is not None:
        lshard = replay_extras(lshard, lres & lvalid, rextras, axis)
    mutual, l2r, _fr, _fl, _frv = _mutual_mask(
        lshard, rshard, lvalid, rvalid, lres, rres, k1, k2, knn_method, axis
    )
    n_pairs = pmaybe(jnp.sum(mutual), axis)
    return lshard, rshard, mutual, l2r, n_pairs, var_old


def merge_step_correct(
    lshard, rshard, lvalid, rvalid, lres, rres, mutual, l2r,
    lorigin=None, rorigin=None,
    *,
    tricube_k: int, ndist: float, min_batch_skip: float,
    knn_method: str = "exact", nb: int = 2,
    axis: Optional[str] = None, with_var: bool = True,
):
    """Phase 2 of a merge step: segment-averaged correction vectors,
    batch-vector stats, orthogonalization of both sides, post variances,
    recomputed averages and the tricube apply. Inputs are phase-1 outputs
    (replayed shards + mutual mask + l2r)."""
    full_right = gmaybe(rshard, axis)
    full_rvalid = gmaybe(rvalid, axis)
    n2 = full_right.shape[0]

    def averaged(l_rows, right_full):
        # sum over pairs of (left_i - right_j) per segment j equals
        # (sum of paired left rows) - count_j * right_j; scan over
        # neighbour positions (pair_segment_sums) so no (N1, k2, d) tensor
        # materializes and no unrolled per-position HLO inflates compile.
        lsums, counts = pair_segment_sums(l_rows, l2r, mutual, n2)
        lsums = pmaybe(lsums, axis)
        counts = pmaybe(counts, axis)
        sums = lsums - right_full * counts[:, None]
        return sums / jnp.maximum(counts, 1.0)[:, None], counts > 0

    var_new = None
    avg, involved = averaged(lshard, full_right)
    overall, magnitude = batch_vector_stats(avg, involved)
    do_correct = magnitude >= min_batch_skip

    v = overall / jnp.sqrt(jnp.sum(jnp.square(overall)))
    lshard_c, _ = center_along(lshard, lres & lvalid, v, axis)
    rshard_c, mean_r = center_along(rshard, rres & rvalid, v, axis)
    lshard_c = jnp.where(do_correct, lshard_c, lshard)
    rshard_c = jnp.where(do_correct, rshard_c, rshard)

    if with_var:
        # post-centering per-batch variance -> lost.var (R/fastMNN.R:500-501)
        var_new = (
            perbatch_var(lshard_c, lorigin, lvalid, nb, axis)
            + perbatch_var(rshard_c, rorigin, rvalid, nb, axis)
        )

    # centered full right (same global mean; recomputed locally)
    loc_fr = along(full_right, v)
    full_right_c = jnp.where(
        do_correct, full_right + jnp.outer(mean_r - loc_fr, v), full_right
    )

    avg2, _ = averaged(lshard_c, full_right_c)

    # tricube apply: local right rows query the involved cells globally
    idx, dist = query_knn(
        rshard_c, full_right_c, tricube_k, data_mask=involved & full_rvalid,
        method=knn_method,
    )
    w = tricube_weights(dist, ndist)

    # scan over neighbour positions: avg2[idx] as one gather would be an
    # (N2, k, d) tensor — 20 GB at a 5M x 5M merge step (observed
    # RESOURCE_EXHAUSTED); k gathers of (N2, d) keep memory O(N2 d)
    def tric_pos(acc, args):
        idx_k, w_k = args                     # (N2,), (N2,)
        return acc + w_k[:, None] * avg2[idx_k], None

    correction, _ = lax.scan(
        tric_pos,
        jnp.zeros_like(rshard_c),
        (idx.T, w.T),
    )
    right_out = jnp.where(do_correct, rshard_c + correction, rshard_c)

    return lshard_c, right_out, overall, magnitude, var_new


def merge_step_body(
    lshard, rshard, lvalid, rvalid, lres, rres,
    lorigin=None, rorigin=None, lextras=None, rextras=None,
    *,
    k1: int, k2: int, tricube_k: int, ndist: float, min_batch_skip: float,
    knn_method: str = "exact", nb: int = 2,
    axis: Optional[str] = None, with_var: bool = True,
):
    """One fastMNN merge step (reference .fast_mnn_core body,
    R/fastMNN.R:448-525): MNN detection, batch-vector estimation,
    orthogonalization of both sides, recomputed averages, tricube apply —
    merge_step_search + merge_step_correct composed in one trace (the
    fused/SPMD paths; the single-chip driver may run the two phases as
    separate jits instead, same math).

    Single-device when ``axis is None`` (the fused path); the per-device
    body of the gather-mode SPMD step otherwise. ``lextras``/``rextras``:
    optional padded (E, d) batch-vector tables replayed on the opposite
    side before the search (zero rows skipped). ``with_var`` adds the
    pre/post per-batch variance pair feeding lost.var.

    Returns (left_c, right_out, overall, magnitude, n_pairs, mutual, l2r
             [, var_old, var_new]).
    """
    lshard, rshard, mutual, l2r, n_pairs, var_old = merge_step_search(
        lshard, rshard, lvalid, rvalid, lres, rres, lorigin, rorigin,
        lextras, rextras,
        k1=k1, k2=k2, knn_method=knn_method, nb=nb, axis=axis,
        with_var=with_var,
    )
    lshard_c, right_out, overall, magnitude, var_new = merge_step_correct(
        lshard, rshard, lvalid, rvalid, lres, rres, mutual, l2r,
        lorigin, rorigin,
        tricube_k=tricube_k, ndist=ndist, min_batch_skip=min_batch_skip,
        knn_method=knn_method, nb=nb, axis=axis, with_var=with_var,
    )
    out = (lshard_c, right_out, overall, magnitude, n_pairs, mutual, l2r)
    if with_var:
        out = out + (var_old, var_new)
    return out
