"""Distributed fastMNN: full merge-tree runs over the cells mesh.

Host-side merge orchestration (same tree semantics as correct/fast_mnn.py)
where every step executes as one shard_map-compiled SPMD program:
all-gathers of the opposing set over the mesh, psum reductions for means/
variances/segment averages, replicated small state. Restriction masks and
orthogonalization replay (extras) are carried as device arrays.

This is the scale-out path for BASELINE configs 4/5 (1M/10M cells); it has
full engine parity with the host path: lost-variance diagnostics
(reference R/fastMNN.R:500-501 computes lost.var unconditionally),
auto-merge ordering (R/MNN_tree.R:154-226), and per-merge-step
checkpoint/resume.
"""
from __future__ import annotations

import functools
import time as _time
from dataclasses import dataclass
from typing import List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..correct.fast_mnn import MergeStepInfo, MNNResult, _pick_best_merge
from ..ops.merge_math import (
    batch_vector_stats,
    center_along,
    merge_step_body,
    merge_step_correct,
    merge_step_search,
    perbatch_var,
    pmaybe,
    replay_extras,
    tricube_weights,
    _mutual_mask,
)
from ..ops.correction import pair_segment_sums
from ..ops.knn import query_knn
from ..ops.knn_pallas import default_mt_budget
from ..ops.mutual_nn import choose_k, membership_rows
from ..utils.batching import reindex_pairings, restore_original_order
from ..utils.telemetry import trace_span
from ..utils.trees import MergeNode, binarize_tree
from .mesh import CELLS_AXIS, cells_sharding, pad_to_multiple
from .ring import (
    ring_membership,
    ring_query_knn_local,
    ring_segment_reduce,
    ring_weighted_gather,
)

shard_map = jax.shard_map

__all__ = ["distributed_fast_mnn"]


def _psum(x):
    return pmaybe(x, CELLS_AXIS)


def _mutual_mask_ring(lshard, rshard, lvalid, rvalid, lres, rres,
                      k1, k2, knn_method, ndev):
    """MNN membership mask with constant per-device memory (ring rotation).
    Returns (mutual, l2r)."""
    my = lax.axis_index(CELLS_AXIS)
    nsl = lshard.shape[0]
    s2 = rshard.shape[0]
    l2r, _ = ring_query_knn_local(
        lshard, rshard, rvalid & rres, k2, ndev, method=knn_method)
    r2l, _ = ring_query_knn_local(
        rshard, lshard, lvalid & lres, k1, ndev, method=knn_method)
    my_ids = my * nsl + jnp.arange(nsl, dtype=l2r.dtype)
    mutual = ring_membership(l2r, r2l, my_ids, s2, ndev)
    mutual = mutual & (lres & lvalid)[:, None]
    return mutual, l2r


# Pad-row threshold above which a gather-mode merge step executes as two
# programs (search | correct) even on a multi-device mesh, and above which a
# 1-device gather step runs fully PHASED: replay/membership/correction as
# small jits and each kNN search as its own program, with the step's pair
# list fetched before the tricube search. Splitting bounds the size and the
# peak memory plan of every program at atlas-scale steps. Both thresholds
# were set on the system's former accelerator and are unmeasured on the
# H100; whether the composed step runs there at (5M, 5M) decides whether
# the split and phased paths stay.
SPLIT_PAD_ROWS = 2_000_000
PHASED_PAD_ROWS = SPLIT_PAD_ROWS


def _replay_phase(ldata, rdata, lvalid, rvalid, lres, rres, lorig, rorig,
                  lex, rex, *, nb: int):
    """Phased step 1/5: pre-merge variances + orthogonalization replay
    (host-engine order: per_batch_var precedes replay, R/fastMNN.R:467)."""
    var_old = (
        perbatch_var(ldata, lorig, lvalid, nb, None)
        + perbatch_var(rdata, rorig, rvalid, nb, None)
    )
    rs = replay_extras(rdata, rres & rvalid, lex, None)
    ls = replay_extras(ldata, lres & lvalid, rex, None)
    return ls, rs, var_old


def _membership_phase(l2r, r2l, lvalid, lres):
    """Phased step 3/5: mutual membership mask + pair count (1-device:
    gathered tables are the local tables)."""
    my_ids = jnp.arange(l2r.shape[0], dtype=l2r.dtype)
    mutual = membership_rows(l2r, r2l, my_ids)
    mutual = mutual & (lres & lvalid)[:, None]
    return mutual, jnp.sum(mutual)


def _correct_a_phase(ls, rs, lvalid, rvalid, lres, rres, mutual, l2r,
                     lorig, rorig, *, min_batch_skip: float, nb: int):
    """Phased step 4/5: segment-averaged corrections, batch-vector stats,
    centering of both sides, post variances — the merge_step_correct body
    up to (but excluding) the tricube kNN. The recomputed averages (avg2)
    are deliberately NOT produced here: at a (5M, 5M) step they are a 1 GB
    array that would sit live through the tricube kNN's pass-1 scan;
    _avg2_phase recomputes them after the search."""
    n2 = rs.shape[0]

    def averaged(l_rows, r_rows):
        lsums, counts = pair_segment_sums(l_rows, l2r, mutual, n2)
        sums = lsums - r_rows * counts[:, None]
        return sums / jnp.maximum(counts, 1.0)[:, None], counts > 0

    avg, involved = averaged(ls, rs)
    overall, magnitude = batch_vector_stats(avg, involved)
    do_correct = magnitude >= min_batch_skip

    v = overall / jnp.sqrt(jnp.sum(jnp.square(overall)))
    lc, _ = center_along(ls, lres & lvalid, v, None)
    rc, _ = center_along(rs, rres & rvalid, v, None)
    lc = jnp.where(do_correct, lc, ls)
    rc = jnp.where(do_correct, rc, rs)

    var_new = (
        perbatch_var(lc, lorig, lvalid, nb, None)
        + perbatch_var(rc, rorig, rvalid, nb, None)
    )
    return lc, rc, involved, overall, magnitude, var_new


def _avg2_phase(lc, rc, mutual, l2r):
    """Phased step 4b/5: recompute the segment-averaged corrections from the
    centered coordinates (merge_step_correct's avg2), deferred until after
    the tricube kNN so the (N2, d) average array never coexists with the
    search's pass-1 buffers."""
    n2 = rc.shape[0]
    lsums, counts = pair_segment_sums(lc, l2r, mutual, n2)
    sums = lsums - rc * counts[:, None]
    return sums / jnp.maximum(counts, 1.0)[:, None]


def _correct_b_phase(rc, idx, sq, avg2, magnitude, *, ndist: float,
                     min_batch_skip: float):
    """Phased step 5/5: tricube-weighted apply of the averaged corrections
    (scan over neighbour positions, O(N2 d) memory like merge_step_correct).
    Takes SQUARED tricube-kNN distances (query_knn squared=True) and roots
    them here, inside the jit: a separate (N2, k) fp32 sqrt output buffer
    is 2.56 GB tiled at a 5M-row step."""
    do_correct = magnitude >= min_batch_skip
    w = tricube_weights(jnp.sqrt(sq), ndist)

    def tric_pos(acc, args):
        idx_k, w_k = args
        return acc + w_k[:, None] * avg2[idx_k], None

    correction, _ = lax.scan(
        tric_pos, jnp.zeros_like(rc), (idx.T, w.T)
    )
    return jnp.where(do_correct, rc + correction, rc)


@functools.lru_cache(maxsize=64)
def _jitted_step(mesh: Mesh, k1: int, k2: int, tricube_k: int, ndist: float,
                 min_batch_skip: float, knn_method: str, memory: str, nb: int,
                 split=False):
    """One compiled step per (mesh, k, ..., split) combo: reusing the jitted
    callable lets XLA's jit cache hit across merge steps with equal
    shapes (a fresh closure per step would never cache).

    ``split`` (shape-gated by the caller: 1-device gather always, any
    gather mesh above SPLIT_PAD_ROWS padded rows) executes the step as TWO
    jit programs — merge_step_search then merge_step_correct — with the
    intermediates (replayed shards, mutual mask, l2r) staying on device,
    sharded on multi-device meshes.
    """
    spec_data = P(CELLS_AXIS, None)
    spec_mask = P(CELLS_AXIS)
    ndev = int(mesh.devices.size)
    if memory == "gather" and split == "phases" and ndev == 1:
        rep = jax.jit(
            functools.partial(_replay_phase, nb=nb), donate_argnums=(0, 1)
        )
        mem = jax.jit(_membership_phase)
        corr_a = jax.jit(
            functools.partial(
                _correct_a_phase, min_batch_skip=min_batch_skip, nb=nb
            ),
            donate_argnums=(0, 1),
        )
        corr_b = jax.jit(
            functools.partial(
                _correct_b_phase, ndist=ndist, min_batch_skip=min_batch_skip
            ),
            donate_argnums=(0,),
        )
        mask_and = jax.jit(lambda a, b: a & b)
        avg2_jit = jax.jit(_avg2_phase)

        def stepped(ldata, rdata, lvalid, rvalid, lres, rres,
                    lorig, rorig, lex, rex, pair_meta=None):
            # half the default pass-1 budget: these searches run with the
            # step's long-lived state (shards, masks, pair tables) resident.
            # Each phase ends in a barrier, so its buffers are dead before
            # the next phase allocates and a failure surfaces where it
            # happened.
            mt_budget = default_mt_budget() // 2
            ls, rs, var_old = rep(
                ldata, rdata, lvalid, rvalid, lres, rres, lorig, rorig,
                lex, rex,
            )
            jax.block_until_ready(ls)
            # each kNN runs as its own program(s)
            rmask = mask_and(rvalid, rres)
            lmask = mask_and(lvalid, lres)
            # indices_only: the MNN membership test never reads distances
            l2r, _ = query_knn(ls, rs, k2, data_mask=rmask, method=knn_method,
                               indices_only=True, mt_budget=mt_budget)
            jax.block_until_ready(l2r)
            r2l, _ = query_knn(rs, ls, k1, data_mask=lmask, method=knn_method,
                               indices_only=True, mt_budget=mt_budget)
            jax.block_until_ready(r2l)
            del rmask, lmask
            mutual, n_pairs = mem(l2r, r2l, lvalid, lres)
            jax.block_until_ready(n_pairs)
            del r2l
            lc, rc, involved, overall, mag, var_new = corr_a(
                ls, rs, lvalid, rvalid, lres, rres, mutual, l2r,
                lorig, rorig,
            )
            jax.block_until_ready(mag)
            avg2 = avg2_jit(lc, rc, mutual, l2r)
            jax.block_until_ready(avg2)
            # compact + fetch the pair list NOW and drop mutual/l2r: the
            # tricube search that follows is the step's memory peak (the
            # driver normally fetches pairs after the step)
            pairs = None
            if pair_meta is not None:
                with trace_span("driver/pairs"):
                    pairs = _collect_pairs_dev(mesh, mutual, l2r, *pair_meta)
            del mutual, l2r
            tmask = mask_and(involved, rvalid)
            idx, sq = query_knn(rc, rc, tricube_k, data_mask=tmask,
                                method=knn_method, squared=True,
                                mt_budget=mt_budget)
            jax.block_until_ready(idx)
            del tmask, involved
            right_out = corr_b(rc, idx, sq, avg2, mag)
            jax.block_until_ready(right_out)
            return (lc, right_out, overall, mag, n_pairs, pairs, None,
                    var_old, var_new)

        return stepped
    if memory == "gather" and split:
        search_body = functools.partial(
            merge_step_search, k1=k1, k2=k2, knn_method=knn_method, nb=nb,
            axis=None if ndev == 1 else CELLS_AXIS, with_var=True,
        )
        correct_body = functools.partial(
            merge_step_correct, tricube_k=tricube_k, ndist=ndist,
            min_batch_skip=min_batch_skip, knn_method=knn_method, nb=nb,
            axis=None if ndev == 1 else CELLS_AXIS, with_var=True,
        )
        # Donate the (lshard, rshard) input buffers: each phase's data
        # inputs are dead afterwards (search's raw shards are replaced by
        # the replayed ones it returns; correct's replayed shards by the
        # corrected outputs), and at a (5M, 5M) step each pair is 2 GB.
        # Leaf buffers are driver-owned (_make_dev_batch copies), so
        # donation never invalidates caller arrays.
        if ndev == 1:
            search = jax.jit(search_body, donate_argnums=(0, 1))
            correct = jax.jit(correct_body, donate_argnums=(0, 1))
        else:
            search = jax.jit(shard_map(
                search_body, mesh=mesh,
                in_specs=(
                    spec_data, spec_data, spec_mask, spec_mask, spec_mask,
                    spec_mask, spec_mask, spec_mask, P(), P(),
                ),
                out_specs=(
                    spec_data, spec_data, P(CELLS_AXIS, None),
                    P(CELLS_AXIS, None), P(), P(),
                ),
                check_vma=False,
            ), donate_argnums=(0, 1))
            correct = jax.jit(shard_map(
                correct_body, mesh=mesh,
                in_specs=(
                    spec_data, spec_data, spec_mask, spec_mask, spec_mask,
                    spec_mask, P(CELLS_AXIS, None), P(CELLS_AXIS, None),
                    spec_mask, spec_mask,
                ),
                out_specs=(spec_data, spec_data, P(), P(), P()),
                check_vma=False,
            ), donate_argnums=(0, 1))

        def stepped(ldata, rdata, lvalid, rvalid, lres, rres,
                    lorig, rorig, lex, rex):
            ls, rs, mutual, l2r, n_pairs, var_old = search(
                ldata, rdata, lvalid, rvalid, lres, rres, lorig, rorig,
                lex, rex,
            )
            lc, rc, overall, mag, var_new = correct(
                ls, rs, lvalid, rvalid, lres, rres, mutual, l2r,
                lorig, rorig,
            )
            return (lc, rc, overall, mag, n_pairs, mutual, l2r,
                    var_old, var_new)

        return stepped
    if memory == "gather":
        body = functools.partial(
            _step_local,
            k1=k1, k2=k2, tricube_k=tricube_k, ndist=ndist,
            min_batch_skip=min_batch_skip, knn_method=knn_method, nb=nb,
        )
    elif memory == "ring":
        body = functools.partial(
            _step_local_ring,
            k1=k1, k2=k2, tricube_k=tricube_k, ndist=ndist,
            min_batch_skip=min_batch_skip, knn_method=knn_method, nb=nb,
            ndev=int(mesh.devices.size),
        )
    else:
        raise ValueError(f"unknown memory mode {memory!r}")
    fn = shard_map(
        body,
        mesh=mesh,
        in_specs=(
            spec_data, spec_data, spec_mask, spec_mask, spec_mask, spec_mask,
            spec_mask, spec_mask, P(), P(),
        ),
        out_specs=(
            spec_data, spec_data, P(), P(), P(),
            P(CELLS_AXIS, None), P(CELLS_AXIS, None), P(), P(),
        ),
        check_vma=False,
    )
    return jax.jit(fn)


@functools.lru_cache(maxsize=8)
def _jitted_shard_pair_counts(mesh: Mesh):
    """Per-device MNN pair counts (ndev,) — sizes the compacted fetch."""
    def body(mut):
        return jnp.sum(mut, dtype=jnp.int32)[None]

    fn = shard_map(
        body, mesh=mesh, in_specs=(P(CELLS_AXIS, None),),
        out_specs=P(CELLS_AXIS), check_vma=False,
    )
    return jax.jit(fn)


@functools.lru_cache(maxsize=64)
def _jitted_pair_fetch(mesh: Mesh, cap: int):
    """Device-compacted pair extraction per shard (the _compact_pairs
    pattern, ops/mutual_nn.py, under shard_map): each device nonzero-walks
    its own (nsl, k2) mutual block row-major — concatenating shards in
    device order IS the reference emission order (left cell, then distance
    rank, src/find_mutual_nns.cpp:30-38). Called with cap = nsl*k2 (the
    step's own padded shape) so the heavy nonzero program compiles once
    per pad bucket rather than once per pair-count bucket (VERDICT r4 #4);
    the link transfer is bounded separately by _jitted_pair_prefix."""
    def body(mut, idx):
        nsl = mut.shape[0]
        rows, cols = jnp.nonzero(mut, size=cap, fill_value=nsl)
        second = idx[jnp.minimum(rows, nsl - 1), cols]
        return rows[None].astype(jnp.int32), second[None].astype(jnp.int32)

    fn = shard_map(
        body, mesh=mesh,
        in_specs=(P(CELLS_AXIS, None), P(CELLS_AXIS, None)),
        out_specs=(P(CELLS_AXIS, None), P(CELLS_AXIS, None)),
        check_vma=False,
    )
    return jax.jit(fn)


@functools.lru_cache(maxsize=64)
def _jitted_pair_prefix(cap_out: int):
    """Trivial (ndev, cap) -> (ndev, cap_out) prefix slice: its compile is
    sub-second, so power-of-two bucketing the ACTUAL pair count here keeps
    the fetched bytes proportional to real pairs without ever recompiling
    the nonzero program above."""
    return jax.jit(lambda rows, second: (rows[:, :cap_out], second[:, :cap_out]))


def _collect_pairs_dev(mesh, mutual, l2r, left_n: int, right_n: int) -> np.ndarray:
    """Fetch the MNN pair list via on-device compaction (VERDICT r3 #2).

    Relies on the compaction invariant (valid rows are the leading [0, n)
    prefix of every padded node, see _concat_dev) so padded row ids ARE
    compact ids; asserted below. Pair order matches np.nonzero on the full
    gathered mask (row-major over global rows)."""
    ndev = int(mesh.devices.size)
    nsl = mutual.shape[0] // ndev
    counts = np.asarray(_jitted_shard_pair_counts(mesh)(mutual))
    cmax = int(counts.max()) if counts.size else 0
    if cmax == 0:
        return np.empty((0, 2), dtype=np.int64)
    cap = nsl * mutual.shape[1]
    rows_d, second_d = _jitted_pair_fetch(mesh, cap)(mutual, l2r)
    cap_out = min(1 << (cmax - 1).bit_length(), cap)
    if cap_out < cap:
        rows_d, second_d = _jitted_pair_prefix(cap_out)(rows_d, second_d)
    rows_s = np.asarray(rows_d)
    second_s = np.asarray(second_d)
    parts = []
    for s in range(ndev):
        c = int(counts[s])
        if c:
            parts.append(
                np.stack(
                    [rows_s[s, :c].astype(np.int64) + s * nsl,
                     second_s[s, :c].astype(np.int64)],
                    axis=1,
                )
            )
    pairs = np.concatenate(parts, axis=0)
    assert int(pairs[:, 0].max()) < left_n and int(pairs[:, 1].max()) < right_n, (
        "padded-prefix invariant violated in pair compaction"
    )
    return pairs


@functools.lru_cache(maxsize=64)
def _jitted_count(mesh: Mesh, k1: int, k2: int, knn_method: str, memory: str):
    """Compiled MNN pair counter for auto-merge search (the SPMD analog of
    .count_mnn_pairs, reference R/MNN_tree.R:160-167), with
    orthogonalization replay like .initialize_auto_search."""
    spec_data = P(CELLS_AXIS, None)
    spec_mask = P(CELLS_AXIS)
    ndev = int(mesh.devices.size)

    def body(lshard, rshard, lvalid, rvalid, lres, rres, lextras, rextras):
        rshard = replay_extras(rshard, rres & rvalid, lextras, CELLS_AXIS)
        lshard = replay_extras(lshard, lres & lvalid, rextras, CELLS_AXIS)
        if memory == "gather":
            mutual = _mutual_mask(
                lshard, rshard, lvalid, rvalid, lres, rres, k1, k2,
                knn_method, CELLS_AXIS,
            )[0]
        else:
            mutual, _ = _mutual_mask_ring(
                lshard, rshard, lvalid, rvalid, lres, rres, k1, k2,
                knn_method, ndev,
            )
        return _psum(jnp.sum(mutual))

    fn = shard_map(
        body,
        mesh=mesh,
        in_specs=(
            spec_data, spec_data, spec_mask, spec_mask, spec_mask, spec_mask,
            P(), P(),
        ),
        out_specs=P(),
        check_vma=False,
    )
    return jax.jit(fn)


def _step_local(
    lshard, rshard, lvalid, rvalid, lres, rres, lorigin, rorigin,
    lextras, rextras,
    k1: int, k2: int, tricube_k: int, ndist: float, min_batch_skip: float,
    knn_method: str = "exact", nb: int = 2, axis=CELLS_AXIS,
):
    """Per-device body of one merge step: the shared merge_step_body
    (ops/merge_math.py — the same implementation the single-device fused
    path runs) with the mesh axis threaded through its collectives
    (``axis=None`` on a 1-device mesh: collectives are identities)."""
    (lshard_c, right_out, overall, magnitude, n_pairs, mutual, l2r,
     var_old, var_new) = merge_step_body(
        lshard, rshard, lvalid, rvalid, lres, rres, lorigin, rorigin,
        lextras, rextras,
        k1=k1, k2=k2, tricube_k=tricube_k, ndist=ndist,
        min_batch_skip=min_batch_skip, knn_method=knn_method, nb=nb,
        axis=axis, with_var=True,
    )
    return (lshard_c, right_out, overall, magnitude, n_pairs, mutual, l2r,
            var_old, var_new)


def _step_local_ring(
    lshard, rshard, lvalid, rvalid, lres, rres, lorigin, rorigin,
    lextras, rextras,
    k1: int, k2: int, tricube_k: int, ndist: float, min_batch_skip: float,
    knn_method: str = "exact", nb: int = 2, ndev: int = 1,
):
    """Constant-memory merge step: no array of global length is ever
    materialized per device. The opposing batch rotates around the ring for
    the kNN searches (ring.ring_query_knn_local), the MNN membership test
    walks the sharded neighbour table (ring.ring_membership), the
    per-right-cell correction table is built by a ring reduce-scatter
    (ring.ring_segment_reduce, so the (N2, d) avg stays sharded), and the
    tricube apply gathers from the sharded table (ring.ring_weighted_gather).
    Per-device memory is O(shard), independent of the global cell count —
    the 100M-cell regime (SURVEY.md §5 "long-context analog").

    Same semantics as _step_local up to floating-point reduction order and
    kNN tie-breaking on equal distances.
    """
    s2 = rshard.shape[0]
    ax = CELLS_AXIS

    var_old = (
        perbatch_var(lshard, lorigin, lvalid, nb, ax)
        + perbatch_var(rshard, rorigin, rvalid, nb, ax)
    )

    rshard = replay_extras(rshard, rres & rvalid, lextras, ax)
    lshard = replay_extras(lshard, lres & lvalid, rextras, ax)

    mutual, l2r = _mutual_mask_ring(
        lshard, rshard, lvalid, rvalid, lres, rres, k1, k2, knn_method, ndev
    )
    n_pairs = _psum(jnp.sum(mutual))

    def averaged(l_rows, r_rows):
        lsums, counts = ring_segment_reduce(l_rows, l2r, mutual, s2, ndev)
        sums = lsums - r_rows * counts[:, None]
        return sums / jnp.maximum(counts, 1.0)[:, None], counts > 0

    avg, involved = averaged(lshard, rshard)
    # the averaged-correction table stays sharded -> stats reduce over the mesh
    overall, magnitude = batch_vector_stats(avg, involved, ax)
    do_correct = magnitude >= min_batch_skip

    v = overall / jnp.sqrt(jnp.sum(jnp.square(overall)))
    lshard_c, _ = center_along(lshard, lres & lvalid, v, ax)
    rshard_c, _ = center_along(rshard, rres & rvalid, v, ax)
    lshard_c = jnp.where(do_correct, lshard_c, lshard)
    rshard_c = jnp.where(do_correct, rshard_c, rshard)

    var_new = (
        perbatch_var(lshard_c, lorigin, lvalid, nb, ax)
        + perbatch_var(rshard_c, rorigin, rvalid, nb, ax)
    )

    avg2, _ = averaged(lshard_c, rshard_c)

    idx, dist = ring_query_knn_local(
        rshard_c, rshard_c, involved & rvalid, tricube_k, ndev,
        method=knn_method)
    w = tricube_weights(dist, ndist)
    correction = ring_weighted_gather(idx, w, avg2, s2, ndev)
    right_out = jnp.where(do_correct, rshard_c + correction, rshard_c)

    return (lshard_c, right_out, overall, magnitude, n_pairs, mutual, l2r,
            var_old, var_new)


@dataclass
class _DevBatch:
    """Sharded per-node state: padded data + masks, host-side bookkeeping."""

    data: jnp.ndarray          # (N_pad, d) sharded
    valid: jnp.ndarray         # (N_pad,) sharded padding mask
    res: jnp.ndarray           # (N_pad,) sharded restriction mask
    origin_dev: jnp.ndarray    # (N_pad,) sharded global batch id (pad -> 0)
    n: int                     # valid cells
    origin: np.ndarray         # (n,) batch id per valid cell
    index: list
    extras: list               # list of (d,) replicated batch vectors


def _make_dev_batch(mesh, x, i, restrict):
    ndev = mesh.devices.size
    xpad, n = pad_to_multiple(jnp.asarray(x), ndev)
    # own the leaf buffer: when no padding is needed, pad_to_multiple
    # returns the caller's array unchanged and device_put may alias it —
    # the split step DONATES its input buffers (dead after the search
    # phase), which must never invalidate an array the caller still holds
    if isinstance(x, jnp.ndarray) and xpad.shape == x.shape:
        xpad = jnp.array(xpad, copy=True)
    valid = jnp.arange(xpad.shape[0]) < n
    if restrict is None:
        res = valid
    else:
        m = np.zeros(xpad.shape[0], dtype=bool)
        m[np.asarray(restrict)] = True
        res = jnp.asarray(m)
    sh = cells_sharding(mesh)
    msk = NamedSharding(mesh, P(CELLS_AXIS))
    origin = np.full(n, i, dtype=np.int64)
    odev = np.zeros(xpad.shape[0], dtype=np.int32)
    odev[:n] = i
    return _DevBatch(
        data=jax.device_put(xpad, sh),
        valid=jax.device_put(valid, msk),
        res=jax.device_put(res, msk),
        origin_dev=jax.device_put(jnp.asarray(odev), msk),
        n=n,
        origin=origin,
        index=[i],
        extras=[],
    )


def _int_tree(nb: int, merge_order):
    """Binary int-leaf merge tree (same semantics as create_tree_predefined
    without node filling)."""
    if merge_order is None:
        merge_order = list(range(nb))
    if not isinstance(merge_order, list) or not any(
        isinstance(x, (list, tuple)) for x in merge_order
    ):
        mo = list(merge_order)
        tree = [mo[0], mo[1]] if len(mo) > 1 else mo[0]
        for nxt in mo[2:]:
            tree = [tree, nxt]
    else:
        tree = list(merge_order)
    tree = binarize_tree(tree)

    def leaves(t):
        return [t] if not isinstance(t, list) else leaves(t[0]) + leaves(t[1])

    if sorted(leaves(tree)) != list(range(nb)):
        raise ValueError("invalid leaf nodes specified in 'merge_order'")
    return tree


def _tree_next(tree):
    path = []
    cur = tree
    while True:
        l_int = isinstance(cur[0], list)
        r_int = isinstance(cur[1], list)
        if not l_int and not r_int:
            return cur[0], cur[1], path
        if r_int:
            path.append(1)
            cur = cur[1]
        else:
            path.append(0)
            cur = cur[0]


def _tree_update(tree, path, node):
    if not path:
        return node
    tree = list(tree)
    tree[path[0]] = _tree_update(tree[path[0]], path[1:], node)
    return tree


def _bucket_size(n: int, ndev: int, buckets: bool) -> int:
    """Round up to a device multiple; with ``buckets``, to 1/2/2.5/5 x 10^k
    sizes so merge steps reuse compiled shapes. The 2.5 rung matters at
    atlas scale: without it a 2.5M-row merged node pads to 5M and every
    kNN in that step does 4x the needed score work (padded sizes multiply);
    it is skipped when 2.5 x 10^k is not integral."""
    base = -(-n // ndev) * ndev
    if not buckets:
        return base
    target = 1
    while True:
        for num, den in ((1, 1), (2, 1), (5, 2), (5, 1)):
            cand = target * num // den
            if cand * den == target * num and cand >= base:
                return -(-cand // ndev) * ndev
        target *= 10


def _repad_dev(mesh, data, res_mask, origin, index, extras, buckets: bool):
    """Build a _DevBatch from compact host/device state (valid rows only),
    padded to the (bucketed) device-multiple target."""
    sh = cells_sharding(mesh)
    msk = NamedSharding(mesh, P(CELLS_AXIS))
    n = data.shape[0]
    ndev = mesh.devices.size
    pad_to = _bucket_size(n, ndev, buckets)
    if pad_to != n:
        extra = pad_to - n
        data = jnp.concatenate([data, jnp.zeros((extra, data.shape[1]), data.dtype)])
        res_mask = np.concatenate([np.asarray(res_mask), np.zeros(extra, bool)])
    valid = jnp.arange(pad_to) < n
    odev = np.zeros(pad_to, dtype=np.int32)
    odev[:n] = origin
    return _DevBatch(
        data=jax.device_put(data, sh),
        valid=jax.device_put(valid, msk),
        res=jax.device_put(jnp.asarray(np.asarray(res_mask)), msk),
        origin_dev=jax.device_put(jnp.asarray(odev), msk),
        n=n,
        origin=np.asarray(origin),
        index=list(index),
        extras=list(extras),
    )


def _concat_dev(mesh, left: _DevBatch, right: _DevBatch, lc, rc, overall, skipped,
                buckets: bool = False):
    """Merge two sharded padded blocks: compact each side to its valid
    prefix, concat, re-pad to the (bucketed) target. Compacting prevents
    padding from cascading across merges (invariant: valid rows are always
    the leading [0, n) prefix)."""
    data = jnp.concatenate([lc[: left.n], rc[: right.n]], axis=0)
    res = np.concatenate(
        [np.asarray(left.res)[: left.n], np.asarray(right.res)[: right.n]]
    )
    extras = list(left.extras) + list(right.extras)
    if not skipped:
        extras = extras + [overall]
    return _repad_dev(
        mesh,
        data,
        res,
        np.concatenate([left.origin, right.origin]),
        list(left.index) + list(right.index),
        extras,
        buckets,
    )


def _padded_extras(extras, emax, d, dt):
    out = jnp.zeros((emax, d), dt)
    if extras:
        out = out.at[: len(extras)].set(jnp.stack(extras))
    return out


def _count_pairs_dev(mesh, left: _DevBatch, right: _DevBatch, k, prop_k,
                     knn_method, memory, emax, d, dt) -> int:
    """MNN pair count between two sharded nodes with orthogonalization
    replay (SPMD analog of _count_pairs in correct/fast_mnn.py)."""
    k1 = choose_k(k, prop_k, left.n)
    k2 = choose_k(k, prop_k, right.n)
    count = _jitted_count(mesh, k1, k2, knn_method, memory)
    lex = _padded_extras(left.extras, emax, d, dt)
    rex = _padded_extras(right.extras, emax, d, dt)
    n = count(
        left.data, right.data, left.valid, right.valid, left.res, right.res,
        lex, rex,
    )
    return int(n)


def _node_record(node: _DevBatch) -> MergeNode:
    """Compact record of a _DevBatch for checkpointing. ``data`` stays a
    device array (the valid prefix); MergeCheckpointer streams it to disk
    in bounded chunks rather than fetching the multi-GB node in one
    np.asarray (VERDICT r4 #8)."""
    data = node.data[: node.n]
    res_mask = np.asarray(node.res)[: node.n]
    restrict = None
    if not bool(res_mask.all()):
        restrict = np.nonzero(res_mask)[0].astype(np.int64)
    return MergeNode(
        index=list(node.index),
        data=data,
        restrict=restrict,
        origin=np.asarray(node.origin),
        extras=[np.asarray(e) for e in node.extras],
    )


def _record_to_dev(mesh, rec: MergeNode, buckets: bool) -> _DevBatch:
    n = rec.data.shape[0]
    res_mask = np.ones(n, dtype=bool)
    if rec.restrict is not None:
        res_mask[:] = False
        res_mask[np.asarray(rec.restrict)] = True
    return _repad_dev(
        mesh,
        jnp.asarray(rec.data),
        res_mask,
        np.asarray(rec.origin),
        list(rec.index),
        [jnp.asarray(e) for e in rec.extras],
        buckets,
    )


def distributed_fast_mnn(
    batches: Sequence[jnp.ndarray],
    mesh: Mesh,
    *,
    k: int = 20,
    prop_k: Optional[float] = None,
    ndist: float = 3.0,
    merge_order=None,
    auto_merge: bool = False,
    min_batch_skip: float = 0.0,
    restrict: Optional[Sequence[Optional[np.ndarray]]] = None,
    collect_pairs: bool = True,
    knn_method: str = "exact",
    pad_buckets: bool = False,
    memory: str = "gather",
    checkpoint_dir: Optional[str] = None,
    progress: bool = False,
) -> MNNResult:
    """Full fastMNN correction on precomputed coordinates, cells sharded
    over ``mesh``. Engine parity with reduced_mnn: predefined merge orders
    AND auto_merge (reference R/MNN_tree.R:154-226), restriction,
    min_batch_skip, per-step lost-variance diagnostics
    (reference R/fastMNN.R:500-501), and checkpoint/resume via
    ``checkpoint_dir`` (same store as the host engine).

    ``memory``: "gather" all-gathers the opposing batch per step (fastest
    while (N, d) fits per-device HBM); "ring" keeps every global-length
    array sharded and rotates blocks over the ring (constant per-device
    memory — the >HBM regime; see _step_local_ring).
    """
    nb = len(batches)
    if nb < 2:
        raise ValueError("at least two batches must be specified")
    if restrict is None:
        restrict = [None] * nb
    d = int(batches[0].shape[1])
    # consume the input list: each source array is dropped right after its
    # padded sharded copy exists, so a caller passing a throwaway list
    # (quick_correct_csr) doesn't hold a second full-atlas copy in HBM
    batches = list(batches)
    nodes = []
    for i in range(nb):
        b, batches[i] = batches[i], None
        nodes.append(_make_dev_batch(mesh, b, i, restrict[i]))
        del b
    dt = nodes[0].data.dtype
    emax = nb - 1

    checkpointer = None
    if checkpoint_dir is not None:
        from ..io.checkpoint import MergeCheckpointer

        checkpointer = MergeCheckpointer(checkpoint_dir)

    if not auto_merge:
        tree = _int_tree(nb, merge_order)

        def fill(t):
            return nodes[t] if not isinstance(t, list) else [fill(t[0]), fill(t[1])]

        tree = fill(tree)
        remainders = None
        stats = None
    else:
        if merge_order is not None:
            raise ValueError("cannot specify both 'merge_order' and 'auto_merge'")
        tree = None
        remainders = list(nodes)
        stats = None  # filled lazily (skipped entirely on full resume)

    nmerges = nb - 1
    infos: List[MergeStepInfo] = []
    step_meta = []
    var_kept = np.ones((nmerges, nb), dtype=np.float64)
    final = None

    for mdx in range(nmerges):
        # Resume path: replay a completed step from the checkpoint store.
        if checkpointer is not None and mdx < checkpointer.completed_steps:
            tree_path, chosen, rec, diag = checkpointer.load_step(mdx)
            merged = _record_to_dev(mesh, rec, pad_buckets)
            infos.append(
                MergeStepInfo(
                    left=diag["left_set"],
                    right=diag["right_set"],
                    pairs=diag["pairs"],
                    batch_size=diag["batch_size"],
                    skipped=diag["skipped"],
                    lost_var=diag["lost_var"],
                )
            )
            var_kept[mdx] = 1.0 - diag["lost_var"]
            step_meta.append((diag["left_set"], diag["right_set"]))
            if not auto_merge:
                cur_left, cur_right, expect_path = _tree_next(tree)
                if (
                    expect_path != tree_path
                    or list(cur_left.index) != list(diag["left_set"])
                    or list(cur_right.index) != list(diag["right_set"])
                ):
                    raise ValueError("checkpoint does not match this merge tree")
                tree = _tree_update(tree, tree_path, merged)
                if not isinstance(tree, list):
                    final = tree
            else:
                li, ri = chosen
                remainders = [
                    x for t, x in enumerate(remainders) if t not in (li, ri)
                ] + [merged]
                stats = diag["stats"]
                if len(remainders) == 1:
                    final = merged
            continue

        if not auto_merge:
            left, right, path = _tree_next(tree)
            li = ri = None
        else:
            if stats is None:
                # O(B^2) pairwise MNN counts (reference R/MNN_tree.R:160-167)
                m = len(remainders)
                stats = np.zeros((m, m), dtype=np.int64)
                for i in range(m):
                    for j in range(i):
                        stats[i, j] = _count_pairs_dev(
                            mesh, remainders[i], remainders[j], k, prop_k,
                            knn_method, memory, emax, d, dt,
                        )
            li, ri = _pick_best_merge(stats)
            left, right = remainders[li], remainders[ri]
            path = None

        k1 = choose_k(k, prop_k, left.n)
        k2 = choose_k(k, prop_k, right.n)
        tric_k = min(choose_k(k, prop_k, right.n), right.n)

        pad_rows = int(left.data.shape[0]) + int(right.data.shape[0])
        split = memory == "gather" and (
            int(mesh.devices.size) == 1 or pad_rows >= SPLIT_PAD_ROWS
        )
        if (
            split
            and pad_rows >= PHASED_PAD_ROWS
            and int(mesh.devices.size) == 1
        ):
            split = "phases"
        step = _jitted_step(
            mesh, k1, k2, tric_k, ndist, min_batch_skip, knn_method, memory,
            nb, split,
        )
        # pad replay vectors to a fixed count (nb-1) for compile reuse
        lex = _padded_extras(left.extras, emax, d, dt)
        rex = _padded_extras(right.extras, emax, d, dt)
        t0 = _time.perf_counter() if progress else 0.0
        with trace_span("driver/step", step=mdx):
            kw = {}
            if split == "phases":
                # the phased step compacts + fetches pairs ITSELF, before
                # its tricube search (so the 3.2 GB mutual/l2r tables are
                # freed ahead of the step's HBM peak), and returns the
                # host pair array in the mutual slot
                kw["pair_meta"] = (
                    (left.n, right.n) if collect_pairs else None
                )
            lc, rc, overall, mag, n_pairs, mutual, l2r, var_old, var_new = step(
                left.data, right.data, left.valid, right.valid, left.res,
                right.res, left.origin_dev, right.origin_dev, lex, rex,
                **kw,
            )
            mag_f = float(mag)
        if progress:
            print(
                f"[distributed_fast_mnn] step {mdx}: "
                f"L={left.data.shape[0]} R={right.data.shape[0]} "
                f"{_time.perf_counter() - t0:.2f}s (incl. any compile)",
                flush=True,
            )
        skipped = mag_f < min_batch_skip
        pairs = np.empty((0, 2), dtype=np.int64)
        if collect_pairs:
            if split == "phases":
                pairs = mutual            # host array from the step
            else:
                with trace_span("driver/pairs", step=mdx):
                    pairs = _collect_pairs_dev(
                        mesh, mutual, l2r, left.n, right.n
                    )
        # free step HBM before the concat/re-pad allocates the merged node
        # (mutual+l2r are ~1 GB at 10M-pad steps; the source node data is
        # not read by _concat_dev — it slices the corrected lc/rc)
        del mutual, l2r
        left.data = right.data = None

        # lost.var per input batch (reference R/fastMNN.R:500-501): only
        # batches on the merged sides change; others keep ratio 1.
        vo = np.asarray(var_old, dtype=np.float64)
        vn = np.asarray(var_new, dtype=np.float64)
        involved_batches = list(left.index) + list(right.index)
        with np.errstate(invalid="ignore", divide="ignore"):
            ratio = vn / vo
        for b in involved_batches:
            var_kept[mdx, b] = ratio[b]

        infos.append(
            MergeStepInfo(
                left=list(left.index),
                right=list(right.index),
                pairs=pairs,
                batch_size=mag_f,
                skipped=skipped,
                lost_var=1.0 - var_kept[mdx],
            )
        )
        step_meta.append((list(left.index), list(right.index)))

        merged = _concat_dev(
            mesh, left, right, lc, rc, overall, skipped, buckets=pad_buckets
        )
        if not auto_merge:
            tree = _tree_update(tree, path, merged)
            if not isinstance(tree, list):
                final = tree
        else:
            keep = [x for t, x in enumerate(remainders) if t not in (li, ri)]
            kept_idx = [t for t in range(len(remainders)) if t not in (li, ri)]
            old = stats[np.ix_(kept_idx, kept_idx)]
            new_counts = [
                _count_pairs_dev(
                    mesh, merged, other, k, prop_k, knn_method, memory,
                    emax, d, dt,
                )
                for other in keep
            ]
            n_new = len(keep) + 1
            stats = np.zeros((n_new, n_new), dtype=np.int64)
            stats[: len(keep), : len(keep)] = old
            stats[len(keep), : len(keep)] = np.asarray(new_counts, dtype=np.int64)
            remainders = keep + [merged]
            if len(remainders) == 1:
                final = merged

        if checkpointer is not None:
            checkpointer.save_step(
                mdx,
                path if not auto_merge else None,
                None if not auto_merge else [li, ri],
                _node_record(merged),
                {
                    "pairs": pairs,
                    "lost_var": 1.0 - var_kept[mdx],
                    "left_set": list(left.index),
                    "right_set": list(right.index),
                    "batch_size": mag_f,
                    "skipped": bool(skipped),
                    "stats": stats if auto_merge else None,
                },
            )

    assert final is not None
    fd = np.asarray(final.data)
    fv = np.asarray(final.valid)
    full_data = fd[fv]
    origin = final.origin
    full_order = final.index

    # pair offsets: each node's compact cells are contiguous in the final
    # data, starting at its first batch's block (host-engine convention)
    offset_map = {}
    pos = 0
    for b in full_order:
        offset_map[b] = pos
        pos += int(np.sum(origin == b))
    for info, (lset, rset) in zip(infos, step_meta):
        if info.pairs.size:
            p = info.pairs.copy()
            p[:, 0] += offset_map[lset[0]]
            p[:, 1] += offset_map[rset[0]]
            info.pairs = p

    if any(full_order[i] > full_order[i + 1] for i in range(len(full_order) - 1)):
        ncells = np.bincount(origin, minlength=nb)
        ordering = restore_original_order(full_order, ncells)
        full_data = full_data[ordering]
        origin = origin[ordering]
        new_pairs = reindex_pairings([i.pairs for i in infos], ordering)
        for info, p in zip(infos, new_pairs):
            info.pairs = p

    return MNNResult(
        corrected=jnp.asarray(full_data),
        batch=origin,
        merge_info=infos,
    )
