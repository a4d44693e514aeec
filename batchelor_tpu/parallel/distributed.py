"""Distributed fastMNN: cells sharded over the mesh, explicit collectives.

SPMD design (SURVEY.md §2.3/§5): each device holds a row shard of both
batches; the opposing set is all-gathered over the mesh for the cross-batch
distance tiles (d <= ~50, so an (N x d) gather is cheap); MNN membership,
segment-averaged corrections, projection means and variance reductions are
psums; small state (the averaged-correction table, batch vectors) is
replicated. All collectives are emitted inside shard_map on a declared
mesh — the analog of the reference's "injected, never ambient"
parallelism discipline (reference tests/testthat/setup.R:1-13).
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

shard_map = jax.shard_map

from ..ops.merge_math import merge_step_body
from ..ops.pca import matmul_f32
from .mesh import CELLS_AXIS, cells_sharding, make_cells_mesh, pad_to_multiple

__all__ = ["distributed_merge_step", "distributed_multi_batch_pca", "DistributedMergeOutput"]


class DistributedMergeOutput(NamedTuple):
    left: jnp.ndarray
    right: jnp.ndarray
    overall: jnp.ndarray
    batch_size: jnp.ndarray
    n_pairs: jnp.ndarray


def _psum(x):
    return lax.psum(x, CELLS_AXIS)


def _merge_step_local(
    lshard, rshard, lmask, rmask, k1: int, k2: int, tricube_k: int, ndist: float,
    min_batch_skip: float,
):
    """Per-device body: the shared merge_step_body (ops/merge_math.py) with
    the mesh axis threaded through its collectives; padding masks double as
    restriction masks (this standalone step has no restriction)."""
    out = merge_step_body(
        lshard, rshard, lmask, rmask, lmask, rmask,
        k1=k1, k2=k2, tricube_k=tricube_k, ndist=ndist,
        min_batch_skip=min_batch_skip, axis=CELLS_AXIS, with_var=False,
    )
    lshard_c, right_out, overall, magnitude, n_pairs = out[:5]
    return lshard_c, right_out, overall, magnitude, n_pairs


def distributed_merge_step(
    left: jnp.ndarray,
    right: jnp.ndarray,
    mesh: Mesh,
    *,
    k1: int = 20,
    k2: int = 20,
    tricube_k: int = 20,
    ndist: float = 3.0,
    min_batch_skip: float = 0.0,
) -> DistributedMergeOutput:
    """One fastMNN merge step with cells sharded over ``mesh``.

    Pads both sets to a device-count multiple with masked rows; returns
    unpadded corrected coordinates plus replicated diagnostics.
    """
    ndev = mesh.devices.size
    left = jnp.asarray(left)
    right = jnp.asarray(right)
    lpad, n1 = pad_to_multiple(left, ndev)
    rpad, n2 = pad_to_multiple(right, ndev)
    lmask = jnp.arange(lpad.shape[0]) < n1
    rmask = jnp.arange(rpad.shape[0]) < n2

    fn = shard_map(
        functools.partial(
            _merge_step_local,
            k1=k1,
            k2=k2,
            tricube_k=tricube_k,
            ndist=ndist,
            min_batch_skip=min_batch_skip,
        ),
        mesh=mesh,
        in_specs=(P(CELLS_AXIS, None), P(CELLS_AXIS, None), P(CELLS_AXIS), P(CELLS_AXIS)),
        out_specs=(P(CELLS_AXIS, None), P(CELLS_AXIS, None), P(), P(), P()),
        check_vma=False,
    )
    shard = cells_sharding(mesh)
    lpad = jax.device_put(lpad, shard)
    rpad = jax.device_put(rpad, shard)
    lc, rc, overall, mag, n_pairs = jax.jit(fn)(lpad, rpad, lmask, rmask)
    return DistributedMergeOutput(
        left=lc[:n1], right=rc[:n2], overall=overall, batch_size=mag, n_pairs=n_pairs
    )


# ---------------------------------------------------------------------------
# Distributed multi-batch PCA: per-shard Gram accumulation + replicated eigh.


def _weighted_stats(xs_shards, masks, weights):
    """(centers, counts): weighted grand mean of per-batch means
    (reference R/multiBatchPCA.R:270-282) via psum'd masked sums."""
    dt = xs_shards[0].dtype
    means, counts = [], []
    for x, m in zip(xs_shards, masks):
        s = _psum(jnp.sum(jnp.where(m[:, None], x, 0.0), axis=0))
        c = _psum(jnp.sum(m.astype(dt)))
        means.append(s / c)
        counts.append(c)
    wsum = sum(weights)
    centers = sum(mu * w for mu, w in zip(means, weights)) / wsum
    return centers, counts


def _weighted_gram(xs_shards, masks, weights, counts, centers):
    """G x G cross-product of the scaled centered concat: each batch's
    contribution is divided by N_b / w_b (reference R/multiBatchPCA.R:293-318)."""
    g = xs_shards[0].shape[1]
    gram = jnp.zeros((g, g), xs_shards[0].dtype)
    for x, m, w, c in zip(xs_shards, masks, weights, counts):
        xc = jnp.where(m[:, None], x - centers[None, :], 0.0)
        gram = gram + matmul_f32(xc.T, xc) * (w / c)
    return _psum(gram)


def _gram_local(xs_shards, masks, left_shards, weights, get_variance: bool):
    """Per-device body, phase 1: weighted grand-mean centering + Gram psum
    (plus the optional leftover cross-Gram and total-variance scalar). The
    eigendecomposition does NOT happen here — it runs once on the
    replicated G x G Gram between the two shard_maps."""
    dt = xs_shards[0].dtype
    centers, counts = _weighted_stats(xs_shards, masks, weights)
    gram = _weighted_gram(xs_shards, masks, weights, counts, centers)
    outs = [centers, gram]
    if left_shards is not None:
        left_centers, _ = _weighted_stats(left_shards, masks, weights)
        gl = left_shards[0].shape[1]
        cross = jnp.zeros((gl, xs_shards[0].shape[1]), dt)
        for lx, x, m, w, c in zip(left_shards, xs_shards, masks, weights, counts):
            lc = jnp.where(m[:, None], lx - left_centers[None, :], 0.0)
            xc = jnp.where(m[:, None], x - centers[None, :], 0.0)
            cross = cross + matmul_f32(lc.T, xc) * (w / c)
        outs += [_psum(cross), left_centers]
    if get_variance:
        total = jnp.zeros((), dt)
        for x, m, w, c in zip(xs_shards, masks, weights, counts):
            xc = jnp.where(m[:, None], x - centers[None, :], 0.0)
            total = total + jnp.sum(jnp.square(xc)) * (w / c)
        outs += [_psum(total)]
    return tuple(outs)


def _project_local(xs_shards, masks, v, centers):
    """Per-device body, phase 2: project the (unscaled) centered shards
    onto the replicated rotation (the distributed form of
    R/multiBatchPCA.R:236-239)."""
    return tuple(
        matmul_f32(jnp.where(m[:, None], x - centers[None, :], 0.0), v)
        for x, m in zip(xs_shards, masks)
    )


@functools.partial(jax.jit, static_argnames=("d",))
def _eigh_post(evals, evecs, d: int):
    """(v, s, ev) from an ascending eigh."""
    ev = jnp.maximum(evals[::-1][:d], 0.0)
    v = evecs[:, ::-1][:, :d]
    return v, jnp.sqrt(ev), ev


@jax.jit
def _leftover_rows(cross, v, ev):
    """leftover_u = (cross @ v) / ev  (u = scaled v / s; leftover_u =
    left_scaled^T u / s = cross v / s^2; R/multiBatchPCA.R:396-414)."""
    safe = jnp.maximum(ev, jnp.finfo(cross.dtype).tiny)
    return matmul_f32(cross, v.astype(cross.dtype)) / safe[None, :]


def _passthrough_local(xs_shards, masks, weights, get_variance: bool):
    """d=None passthrough: centered matrices only (reference
    R/multiBatchPCA.R:245-255); variance computed on the scaled concat."""
    dt = xs_shards[0].dtype
    centers, counts = _weighted_stats(xs_shards, masks, weights)
    comps = [
        jnp.where(m[:, None], x - centers[None, :], 0.0)
        for x, m in zip(xs_shards, masks)
    ]
    outs = list(comps)
    if get_variance:
        # per-gene variance of the scaled concat rows (host path computes
        # var over scaled with its own mean, n-1 denominator)
        n_tot = jnp.zeros((), dt)
        ssum = jnp.zeros((xs_shards[0].shape[1],), dt)
        for x, m, w, c in zip(xs_shards, masks, weights, counts):
            sc = 1.0 / jnp.sqrt(c / w)
            xc = jnp.where(m[:, None], x - centers[None, :], 0.0) * sc
            ssum = ssum + _psum(jnp.sum(xc, axis=0))
            n_tot = n_tot + c
        mu = ssum / n_tot
        sq = jnp.zeros((xs_shards[0].shape[1],), dt)
        for x, m, w, c in zip(xs_shards, masks, weights, counts):
            sc = 1.0 / jnp.sqrt(c / w)
            xc = (jnp.where(m[:, None], x - centers[None, :], 0.0)) * sc
            dev = jnp.where(m[:, None], xc - mu[None, :], 0.0)
            sq = sq + _psum(jnp.sum(jnp.square(dev), axis=0))
        outs += [sq / (n_tot - 1.0)]
    return tuple(outs)


def distributed_multi_batch_pca(
    batches,
    mesh: Mesh,
    d: Optional[int] = 50,
    weights=None,
    *,
    subset_row=None,
    get_all_genes: bool = False,
    get_variance: bool = False,
    batch_names=None,
):
    """Weighted multi-batch PCA with cells sharded over the mesh — full
    option parity with ops.pca.multi_batch_pca (weight vectors/trees,
    subset_row, get_all_genes extrapolation, get_variance, d=None).

    The G x G weighted cross-product is accumulated per shard and psummed;
    the eigendecomposition runs replicated on every device
    (SURVEY.md §2.2 "Truncated SVD" replacement). Returns a
    MultiBatchPCAResult like the host implementation.
    """
    from ..ops.pca import MultiBatchPCAResult, construct_weight_vector

    ndev = mesh.devices.size
    batches = [jnp.asarray(b) for b in batches]
    nb = len(batches)
    w = construct_weight_vector(
        [b.shape[0] for b in batches], weights, batch_names
    )
    weights_f = tuple(float(x) for x in w)

    g_all = batches[0].shape[1]
    if subset_row is not None:
        subset_row = np.asarray(subset_row)
        sub = [b[:, jnp.asarray(subset_row)] for b in batches]
    else:
        sub = list(batches)

    leftover_idx = None
    lefts = None
    if get_all_genes and subset_row is not None and d is not None:
        keep = np.zeros(g_all, dtype=bool)
        keep[subset_row] = True
        leftover_idx = np.nonzero(~keep)[0]
        lefts = [b[:, jnp.asarray(leftover_idx)] for b in batches]

    padded, ns, masks = [], [], []
    for b in sub:
        p, n = pad_to_multiple(b, ndev)
        padded.append(p)
        ns.append(n)
        masks.append(jnp.arange(p.shape[0]) < n)
    lpadded = None
    if lefts is not None:
        lpadded = [pad_to_multiple(b, ndev)[0] for b in lefts]

    shardng = cells_sharding(mesh)
    batch_names_l = list(batch_names) if batch_names is not None else None

    if d is None:
        in_specs = tuple([P(CELLS_AXIS, None)] * nb + [P(CELLS_AXIS)] * nb)
        out_specs = tuple(
            [P(CELLS_AXIS, None)] * nb + ([P()] if get_variance else [])
        )

        def body(*args):
            return _passthrough_local(
                list(args[:nb]), list(args[nb:]), weights_f, get_variance
            )

        fn = shard_map(body, mesh=mesh, in_specs=in_specs,
                       out_specs=out_specs, check_vma=False)
        out = jax.jit(fn)(*[jax.device_put(p, shardng) for p in padded], *masks)
        comps = [c[:n] for c, n in zip(out[:nb], ns)]
        g_sub = sub[0].shape[1]
        if get_all_genes and subset_row is not None:
            rotation = jnp.zeros((g_all, g_sub), padded[0].dtype)
            rotation = rotation.at[
                jnp.asarray(subset_row), jnp.arange(g_sub)
            ].set(1.0)
            out_centers = jnp.zeros((g_all,), padded[0].dtype)
        else:
            rotation = jnp.eye(g_sub, dtype=padded[0].dtype)
            out_centers = jnp.zeros((g_sub,), padded[0].dtype)
        res = MultiBatchPCAResult(
            components=comps, rotation=rotation, centers=out_centers,
            batch_names=batch_names_l,
        )
        if get_variance:
            var = np.asarray(out[nb])
            res.var_explained = var
            res.var_total = float(var.sum())
        return res

    sum_n = sum(ns)
    d_eff = int(min(d, sum_n, sub[0].shape[1]))
    nl = len(lpadded) if lpadded is not None else 0
    in_specs = tuple(
        [P(CELLS_AXIS, None)] * nb + [P(CELLS_AXIS)] * nb
        + [P(CELLS_AXIS, None)] * nl
    )
    gram_out = [P(), P()] + ([P(), P()] if nl else []) + (
        [P()] if get_variance else []
    )

    def gram_body(*args):
        xs = list(args[:nb])
        ms = list(args[nb : 2 * nb])
        ls = list(args[2 * nb :]) if nl else None
        return _gram_local(xs, ms, ls, weights_f, get_variance)

    args = [jax.device_put(p, shardng) for p in padded] + list(masks)
    if lpadded is not None:
        args += [jax.device_put(p, shardng) for p in lpadded]
    out = jax.jit(
        shard_map(gram_body, mesh=mesh, in_specs=in_specs,
                  out_specs=tuple(gram_out), check_vma=False)
    )(*args)
    centers, gram = out[0], out[1]
    pos = 2
    cross = left_centers = None
    if nl:
        cross, left_centers = out[2], out[3]
        pos = 4
    total = out[pos] if get_variance else None

    # one eigendecomposition of the replicated Gram between the SPMD phases
    evals, evecs = jnp.linalg.eigh(gram)
    v, s, ev = _eigh_post(evals, evecs, d_eff)

    def proj_body(*pargs):
        xs = list(pargs[:nb])
        ms = list(pargs[nb : 2 * nb])
        return _project_local(xs, ms, pargs[2 * nb], pargs[2 * nb + 1])

    proj = jax.jit(
        shard_map(
            proj_body, mesh=mesh,
            in_specs=tuple([P(CELLS_AXIS, None)] * nb + [P(CELLS_AXIS)] * nb
                           + [P(), P()]),
            out_specs=tuple([P(CELLS_AXIS, None)] * nb),
            check_vma=False,
        )
    )(*([jax.device_put(p, shardng) for p in padded] + list(masks)
        + [v.astype(padded[0].dtype), centers]))
    comps = [c[:n] for c, n in zip(proj, ns)]

    if lpadded is not None:
        leftover_u = _leftover_rows(cross, v, ev)
        rotation = jnp.zeros((g_all, d_eff), v.dtype)
        rotation = rotation.at[jnp.asarray(subset_row)].set(v)
        rotation = rotation.at[jnp.asarray(leftover_idx)].set(leftover_u)
        all_centers = jnp.zeros((g_all,), v.dtype)
        all_centers = all_centers.at[jnp.asarray(subset_row)].set(centers)
        all_centers = all_centers.at[jnp.asarray(leftover_idx)].set(left_centers)
    else:
        rotation = v
        all_centers = centers
    res = MultiBatchPCAResult(
        components=comps, rotation=rotation, centers=all_centers,
        batch_names=batch_names_l,
    )
    if get_variance:
        res.var_explained = np.asarray(ev) / nb
        res.var_total = float(total) / nb
    return res
