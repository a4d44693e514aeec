"""clusterMNN: cluster-level MNN correction with per-cell propagation.

Rebuild of clusterMNN (reference R/clusterMNN.R:101-312):
per-batch cluster centroids -> full-rank multi-batch PCA of centroids ->
reducedMNN with k=1 on the centroids -> per-cell propagation via a
variable-bandwidth Gaussian kernel -> meta-clusters as connected components
of the centroid MNN-pair graph.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.cosine_norm import apply_cosine_norm, cosine_norm
from ..ops.knn import query_knn
from ..ops.pca import MultiBatchPCAResult, matmul_f32, multi_batch_pca
from ..utils.batching import check_batch_consistency, check_restrictions, divide_into_batches
from .fast_mnn import MNNResult, reduced_mnn

__all__ = ["cluster_mnn", "cluster_mnn_csr", "kmeans_clusters", "ClusterMNNResult"]


import functools as _functools


@_functools.partial(jax.jit, static_argnames=("n_clusters", "n_iter", "seed"))
def _kmeans_jit(x: jnp.ndarray, n_clusters: int, n_iter: int, seed: int):
    key = jax.random.PRNGKey(seed)
    n = x.shape[0]
    xsq = jnp.sum(jnp.square(x), axis=1)

    # k-means++ seeding, fully traced
    idx0 = jax.random.randint(key, (), 0, n)
    centers0 = jnp.zeros((n_clusters, x.shape[1]), x.dtype).at[0].set(x[idx0])

    def seed_body(i, carry):
        centers, key = carry
        csq = jnp.sum(jnp.square(centers), axis=1)
        d2 = xsq[:, None] - 2 * x @ centers.T + csq[None, :]
        mask = jnp.arange(n_clusters) < i
        d2 = jnp.min(jnp.where(mask[None, :], d2, jnp.inf), axis=1)
        d2 = jnp.maximum(d2, 0.0)
        key, sub = jax.random.split(key)
        pick = jax.random.categorical(sub, jnp.log(d2 / jnp.sum(d2) + 1e-30))
        return centers.at[i].set(x[pick]), key

    centers, _ = jax.lax.fori_loop(1, n_clusters, seed_body, (centers0, key))

    def step(c, _):
        d2 = xsq[:, None] - 2 * x @ c.T + jnp.sum(jnp.square(c), axis=1)[None, :]
        assign = jnp.argmin(d2, axis=1)
        sums = jax.ops.segment_sum(x, assign, num_segments=n_clusters)
        counts = jax.ops.segment_sum(
            jnp.ones(n, x.dtype), assign, num_segments=n_clusters
        )
        newc = jnp.where(counts[:, None] > 0, sums / jnp.maximum(counts, 1)[:, None], c)
        return newc, None

    c, _ = jax.lax.scan(step, centers, None, length=n_iter)
    d2 = xsq[:, None] - 2 * x @ c.T + jnp.sum(jnp.square(c), axis=1)[None, :]
    return jnp.argmin(d2, axis=1)


def kmeans_clusters(x: jnp.ndarray, n_clusters: int, n_iter: int = 50, seed: int = 0):
    """Deterministic k-means (k-means++ init), one jit call, for the
    auto-clustering path (reference's BlusterParam option,
    R/clusterMNN.R:200-218)."""
    return np.asarray(_kmeans_jit(jnp.asarray(x), n_clusters, n_iter, seed))


def _union_find(n: int, edges: np.ndarray) -> np.ndarray:
    """Connected components; mirrors igraph::components usage at
    reference R/clusterMNN.R:162-165. Dispatches to the native C++ runtime
    when available."""
    from ..native import bindings as nat

    if nat.get_lib() is not None:
        return nat.union_find(n, np.asarray(edges))
    return _union_find_py(n, edges)


def _union_find_py(n: int, edges: np.ndarray) -> np.ndarray:
    parent = np.arange(n)

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for u, v in edges:
        ru, rv = find(int(u)), find(int(v))
        if ru != rv:
            parent[max(ru, rv)] = min(ru, rv)
    roots = np.array([find(i) for i in range(n)])
    # relabel components in first-appearance order (igraph membership style)
    labels = {}
    out = np.empty(n, dtype=np.int64)
    for i, r in enumerate(roots):
        if r not in labels:
            labels[r] = len(labels)
        out[i] = labels[r]
    return out


@dataclass
class ClusterMNNResult:
    """clusterMNN outputs.

    corrected: (N_total, d) per-cell corrected coordinates (input order).
    batch: per-cell batch label; cluster: per-cell cluster label.
    cluster_meta: per-centroid table (cluster label, batch, meta component).
    centroid_result: the underlying reducedMNN result on centroids.
    rotation/centers: PCA metadata for low-rank reconstruction.
    """

    corrected: jnp.ndarray
    batch: np.ndarray
    cluster: np.ndarray
    cluster_meta: dict
    centroid_result: MNNResult
    rotation: Optional[jnp.ndarray] = None
    centers: Optional[jnp.ndarray] = None

    def reconstructed(self):
        """Lazy low-rank per-gene values (cf. MNNResult.reconstructed)."""
        from ..ops.lowrank import LowRankOp

        return LowRankOp(self.rotation, self.corrected)


def _compute_centroids(batches, clusters, restrict):
    """Per-batch, per-cluster mean profiles over restricted cells
    (reference .compute_centroids, R/clusterMNN.R:228-242).
    Returns (centers list [(C_b, G)], level lists)."""
    centers, levels = [], []
    for i, (b, cl) in enumerate(zip(batches, clusters)):
        cl = np.asarray(cl)
        bsel = b
        if restrict is not None and restrict[i] is not None:
            ridx = np.asarray(restrict[i])
            cl = cl[ridx]
            bsel = b[jnp.asarray(ridx)]
        lv = sorted(set(cl.tolist()))
        lookup = {v: j for j, v in enumerate(lv)}
        assign = np.array([lookup[v] for v in cl.tolist()])
        sums = jax.ops.segment_sum(bsel, jnp.asarray(assign), num_segments=len(lv))
        counts = np.bincount(assign, minlength=len(lv)).astype(np.float64)
        centers.append(sums / jnp.asarray(counts)[:, None])
        levels.append(lv)
    return centers, levels


def _csr_l2_norms(csr, subset=None) -> np.ndarray:
    """Per-cell L2 norms of a CSRCells store over ``subset`` genes, O(nnz)
    on the host (the out-of-core analog of cosine_norm(mode='l2norm'))."""
    s = csr if subset is None else csr.select_genes(np.asarray(subset))
    sq = np.zeros(s.n_cells, np.float64)
    counts = np.diff(s.indptr)
    nz = counts > 0
    if nz.any():
        sq[nz] = np.add.reduceat(
            s.data.astype(np.float64) ** 2, s.indptr[:-1][nz]
        )
    return np.sqrt(sq)


def _csr_cluster_means(
    csr, assign: np.ndarray, n_clusters: int, row_scale: np.ndarray,
    nnz_chunk: int = 1 << 26,
) -> np.ndarray:
    """(n_clusters, G) means of scaled CSR rows, streamed over nnz chunks
    on the host (one bincount pass; no densify). ``assign`` may contain -1
    for excluded (non-restricted) rows. The out-of-core analog of the
    reference's sumCountsAcrossCells centroids (R/clusterMNN.R:228-242)."""
    g = csr.n_genes
    counts = np.diff(csr.indptr)
    assign_nnz = np.repeat(assign, counts)
    scale_nnz = np.repeat(row_scale, counts)
    sums = np.zeros(n_clusters * g, np.float64)
    nnz = csr.data.shape[0]
    for lo in range(0, nnz, nnz_chunk):
        hi = min(lo + nnz_chunk, nnz)
        a = assign_nnz[lo:hi]
        keep = a >= 0
        flat = a[keep].astype(np.int64) * g + csr.indices[lo:hi][keep]
        w = csr.data[lo:hi][keep].astype(np.float64) * scale_nnz[lo:hi][keep]
        sums += np.bincount(flat, weights=w, minlength=n_clusters * g)
    ncells = np.bincount(assign[assign >= 0], minlength=n_clusters).astype(np.float64)
    return (sums.reshape(n_clusters, g) / np.maximum(ncells, 1.0)[:, None]).astype(
        np.float32
    )


@jax.jit
def _proj_block(block, l2, rotation, adj, valid):
    """Cosine-normalize rows like apply_cosine_norm (same fp32 division),
    project onto the centroid rotation, and return per-row squared distance
    to the nearest centroid-projection is deferred (proj only)."""
    safe = jnp.maximum(jnp.asarray(1e-8, block.dtype), l2.astype(block.dtype))
    b = jnp.where(valid[:, None], block / safe[:, None], 0.0)
    return matmul_f32(b, rotation) - adj[None, :]


@jax.jit
def _min_cent_dist(proj, cent):
    d2 = (
        jnp.sum(jnp.square(proj), axis=1)[:, None]
        - 2 * jnp.matmul(proj, cent.T, precision=jax.lax.Precision.HIGHEST)
        + jnp.sum(jnp.square(cent), axis=1)[None, :]
    )
    return jnp.sqrt(jnp.maximum(jnp.min(d2, axis=1), 0.0))


@jax.jit
def _propagate_block(proj, cent, delta, sigma):
    """Softmax-weighted centroid deltas (the reference's
    .smooth_gaussian_from_centroids, R/clusterMNN.R:289-312)."""
    d2 = (
        jnp.sum(jnp.square(proj), axis=1)[:, None]
        - 2 * jnp.matmul(proj, cent.T, precision=jax.lax.Precision.HIGHEST)
        + jnp.sum(jnp.square(cent), axis=1)[None, :]
    )
    w = jax.nn.softmax(-d2 / jnp.square(sigma), axis=1)
    return proj + matmul_f32(w, delta)


def cluster_mnn_csr(
    batches: Sequence,
    *,
    clusters,
    restrict=None,
    cos_norm: bool = True,
    merge_order=None,
    auto_merge: bool = False,
    min_batch_skip: Optional[float] = 0.0,
    subset_row: Optional[np.ndarray] = None,
    correct_all: bool = False,
    batch_names: Optional[Sequence[str]] = None,
    block_rows: int = 16384,
) -> ClusterMNNResult:
    """Out-of-core clusterMNN over CSRCells stores.

    Matches :func:`cluster_mnn` on the densified inputs, but the expression
    matrices never densify beyond one (block_rows, G_sub) device block:
    centroids are streamed host-side segment means over the CSR nnz
    (O(nnz), no device transfer of the expression at all), and the
    per-cell projection + Gaussian propagation stream subset-gene blocks
    through the device via the sparse-transfer auto streamer. The
    reference runs this entry point on file-backed matrices through
    block-processed cosineNorm (R/cosineNorm.R:59-61) and streamed
    centroids (R/clusterMNN.R:228-242); this is the device-side analog.

    ``clusters``: list of per-batch label vectors, or an int K to
    auto-cluster each batch (k-means on its top-50 streamed PCs).
    """
    from ..io.csr import CSRCells, auto_blocks
    from ..ops.pca_outofcore import multi_batch_pca_csr

    if not isinstance(batches, (list, tuple)) or not all(
        isinstance(b, CSRCells) for b in batches
    ):
        raise ValueError("cluster_mnn_csr expects a list of CSRCells stores")
    nb = len(batches)
    if nb < 2:
        raise ValueError("at least two batches must be specified")
    g = batches[0].n_genes
    if any(b.n_genes != g for b in batches):
        raise ValueError("all batches must have the same genes")
    if restrict is None:
        restrict = [None] * nb

    sub = None if subset_row is None else np.asarray(subset_row)

    if isinstance(clusters, int):
        kk = clusters
        clusters = []
        for b in batches:
            s = b if sub is None else b.select_genes(sub)
            pcs = multi_batch_pca_csr(
                [s], d=min(50, s.n_cells - 1, s.n_genes), block_rows=block_rows
            ).components[0]
            clusters.append(kmeans_clusters(pcs, kk))
    if len(clusters) != nb:
        raise ValueError("'clusters' should have one entry per batch")

    # cosine-norm scales per cell (l2 over subset genes, applied everywhere
    # — same semantics as the dense path / reference R/clusterMNN.R:138-141)
    if cos_norm:
        l2s = [_csr_l2_norms(b, sub) for b in batches]
    else:
        l2s = [np.full(b.n_cells, 1.0) for b in batches]
    scales = [1.0 / np.maximum(l2, 1e-8) for l2 in l2s]

    # streamed centroids over restricted cells
    centers, levels = [], []
    for i, (b, cl) in enumerate(zip(batches, clusters)):
        cl = np.asarray(cl)
        if restrict[i] is not None:
            keep = np.zeros(b.n_cells, bool)
            keep[np.asarray(restrict[i])] = True
        else:
            keep = np.ones(b.n_cells, bool)
        lv = sorted(set(cl[keep].tolist()))
        lookup = {v: j for j, v in enumerate(lv)}
        assign = np.full(b.n_cells, -1, dtype=np.int64)
        for r in np.nonzero(keep)[0]:
            assign[r] = lookup.get(cl[r], -1)
        centers.append(
            jnp.asarray(_csr_cluster_means(b, assign, len(lv), scales[i]))
        )
        levels.append(lv)

    total_centroids = sum(c.shape[0] for c in centers)
    pca = multi_batch_pca(
        centers,
        d=total_centroids - 1,
        subset_row=sub,
        get_all_genes=correct_all and sub is not None,
        method="gram",
        batch_names=batch_names,
    )
    merge_out = reduced_mnn(
        [jnp.asarray(c) for c in pca.components],
        k=1,
        merge_order=merge_order,
        auto_merge=auto_merge,
        min_batch_skip=min_batch_skip,
        batch_names=batch_names,
    )

    rotation = pca.rotation
    centers_vec = pca.centers
    if correct_all and sub is not None:
        s_dev = jnp.asarray(sub)
        rotation = rotation[s_dev]
        centers_vec = centers_vec[s_dev]
    adj = matmul_f32(centers_vec, rotation)

    corrected_blocks = []
    cluster_labels = []
    last = 0
    merged_corrected = merge_out.corrected
    for i in range(nb):
        store = batches[i] if sub is None else batches[i].select_genes(sub)
        cent = pca.components[i]
        ncent = cent.shape[0]
        idx = jnp.arange(last, last + ncent)
        last += ncent
        corrected_cent = merged_corrected[idx]
        delta = corrected_cent - cent

        # pass 1: streamed projection (kept on device, (N_b, d) only)
        projs = []
        row0 = 0
        for block, n_valid in auto_blocks(store, block_rows=block_rows):
            l2b = jnp.asarray(
                np.pad(l2s[i][row0 : row0 + n_valid].astype(np.float32),
                       (0, block.shape[0] - n_valid), constant_values=1.0)
            )
            valid = jnp.arange(block.shape[0]) < n_valid
            projs.append(
                _proj_block(jnp.asarray(block), l2b, rotation, adj, valid)[:n_valid]
            )
            row0 += n_valid
        proj = jnp.concatenate(projs, axis=0)

        # sigma: median distance of restricted cells to nearest centroid
        q = proj
        if restrict[i] is not None:
            q = proj[jnp.asarray(np.asarray(restrict[i]))]
        sigma = jnp.median(_min_cent_dist(q, cent))

        corrected_blocks.append(_propagate_block(proj, cent, delta, sigma))
        cluster_labels.append(np.asarray(clusters[i]))

    corrected = jnp.concatenate(corrected_blocks, axis=0)
    cluster = np.concatenate(cluster_labels)
    origin = np.repeat(np.arange(nb), [b.n_cells for b in batches])
    labels = (
        np.asarray(batch_names)[origin] if batch_names is not None else origin
    )

    all_pairs = np.concatenate(
        [info.pairs for info in merge_out.merge_info]
    ) if merge_out.merge_info else np.empty((0, 2), dtype=np.int64)
    meta = _union_find(total_centroids, all_pairs)
    centroid_batches = np.repeat(np.arange(nb), [len(lv) for lv in levels])
    cluster_meta = {
        "cluster": np.concatenate([np.asarray(lv) for lv in levels]),
        "batch": (
            np.asarray(batch_names)[centroid_batches]
            if batch_names is not None
            else centroid_batches
        ),
        "meta": meta,
    }

    return ClusterMNNResult(
        corrected=corrected,
        batch=labels,
        cluster=cluster,
        cluster_meta=cluster_meta,
        centroid_result=merge_out,
        rotation=pca.rotation,
        centers=pca.centers,
    )


def cluster_mnn(
    batches_or_single,
    batch: Optional[Sequence] = None,
    *,
    clusters,
    restrict=None,
    cos_norm: bool = True,
    merge_order=None,
    auto_merge: bool = False,
    min_batch_skip: Optional[float] = 0.0,
    subset_row: Optional[np.ndarray] = None,
    correct_all: bool = False,
    batch_names: Optional[Sequence[str]] = None,
) -> ClusterMNNResult:
    """Cluster-level MNN correction (reference clusterMNN, R/clusterMNN.R:101-176).

    ``clusters``: list of per-batch cluster label vectors (or a single vector
    for single-matrix input), or an int K to auto-cluster each batch with
    k-means on its top-50 PCs.
    """
    single = not isinstance(batches_or_single, (list, tuple))
    if single:
        x = jnp.asarray(batches_or_single)
        if batch is None:
            raise ValueError("'batch' must be specified for a single input matrix")
        divided = divide_into_batches(
            np.arange(x.shape[0]), batch, cells_in_rows=True, restrict=restrict
        )
        batches = [x[jnp.asarray(idx)] for idx in divided.batches]
        restrict = divided.restricted
        if batch_names is None:
            batch_names = [str(n) for n in divided.names]
        if not isinstance(clusters, int):
            cl = np.asarray(clusters)
            clusters = [cl[idx] for idx in divided.batches]
    else:
        batches = [jnp.asarray(b) for b in batches_or_single]
        check_batch_consistency(batches, cells_in_rows=True)
        restrict = check_restrictions(batches, restrict, cells_in_rows=True)

    nb = len(batches)
    if isinstance(clusters, int):
        kk = clusters
        clusters = []
        for b in batches:
            sub = b if subset_row is None else b[:, jnp.asarray(np.asarray(subset_row))]
            pcs = multi_batch_pca([sub], d=min(50, sub.shape[0] - 1, sub.shape[1])).components[0]
            clusters.append(kmeans_clusters(pcs, kk))
    if len(clusters) != nb:
        raise ValueError("'clusters' should have one entry per batch")

    if cos_norm:
        l2s = [cosine_norm(b, mode="l2norm", subset_row=subset_row) for b in batches]
        batches_n = [apply_cosine_norm(b, l2) for b, l2 in zip(batches, l2s)]
    else:
        batches_n = batches

    centers, levels = _compute_centroids(batches_n, clusters, restrict)

    # full-rank PCA of the centroids (reference .full_rank_pca,
    # R/clusterMNN.R:174-184): d = total#centroids - 1, exact.
    total_centroids = sum(c.shape[0] for c in centers)
    # "gram" picks the smaller-side cross-product: with few centroids this
    # is a tiny (n_centroids x n_centroids) eigh.
    pca = multi_batch_pca(
        centers,
        d=total_centroids - 1,
        subset_row=subset_row,
        get_all_genes=correct_all and subset_row is not None,
        method="gram",
        batch_names=batch_names,
    )

    merge_out = reduced_mnn(
        [jnp.asarray(c) for c in pca.components],
        k=1,
        merge_order=merge_order,
        auto_merge=auto_merge,
        min_batch_skip=min_batch_skip,
        batch_names=batch_names,
    )

    # Per-cell propagation (reference .propagate_to_cells,
    # R/clusterMNN.R:250-312).
    rotation = pca.rotation
    centers_vec = pca.centers
    if correct_all and subset_row is not None:
        s = jnp.asarray(np.asarray(subset_row))
        rotation = rotation[s]
        centers_vec = centers_vec[s]
    adj = matmul_f32(centers_vec, rotation)

    corrected_blocks = []
    cluster_labels = []
    last = 0
    merged_corrected = merge_out.corrected
    for i in range(nb):
        b = batches_n[i]
        sub = b if subset_row is None else b[:, jnp.asarray(np.asarray(subset_row))]
        proj = matmul_f32(sub, rotation) - adj[None, :]
        cent = pca.components[i]
        ncent = cent.shape[0]
        idx = jnp.arange(last, last + ncent)
        last += ncent
        corrected_cent = merged_corrected[idx]
        delta = corrected_cent - cent
        # sigma: median distance of (restricted) cells to nearest centroid
        q = proj
        if restrict is not None and restrict[i] is not None:
            q = proj[jnp.asarray(np.asarray(restrict[i]))]
        _, dist = query_knn(q, cent, 1)
        sigma = jnp.median(dist[:, 0])
        # softmax-weighted delta (reference .smooth_gaussian_from_centroids);
        # distance matmul at HIGHEST (a TF32 or bf16 default is too coarse)
        d2 = (
            jnp.sum(jnp.square(proj), axis=1)[:, None]
            - 2 * jnp.matmul(proj, cent.T, precision=jax.lax.Precision.HIGHEST)
            + jnp.sum(jnp.square(cent), axis=1)[None, :]
        )
        w = jax.nn.softmax(-d2 / jnp.square(sigma), axis=1)
        corrected_blocks.append(proj + matmul_f32(w, delta))
        cluster_labels.append(np.asarray(clusters[i]))

    corrected = jnp.concatenate(corrected_blocks, axis=0)
    cluster = np.concatenate(cluster_labels)
    origin = np.repeat(np.arange(nb), [b.shape[0] for b in batches])
    labels = (
        np.asarray(batch_names)[origin] if batch_names is not None else origin
    )

    # Meta-clusters: connected components of the centroid pair graph
    # (reference R/clusterMNN.R:162-165).
    all_pairs = np.concatenate(
        [info.pairs for info in merge_out.merge_info]
    ) if merge_out.merge_info else np.empty((0, 2), dtype=np.int64)
    meta = _union_find(total_centroids, all_pairs)
    centroid_batches = np.repeat(np.arange(nb), [len(lv) for lv in levels])
    cluster_meta = {
        "cluster": np.concatenate([np.asarray(lv) for lv in levels]),
        "batch": (
            np.asarray(batch_names)[centroid_batches]
            if batch_names is not None
            else centroid_batches
        ),
        "meta": meta,
    }

    if single:
        reo = divided.reorder
        corrected = corrected[jnp.asarray(reo)]
        labels = labels[reo]
        cluster = cluster[reo]

    return ClusterMNNResult(
        corrected=corrected,
        batch=labels,
        cluster=cluster,
        cluster_meta=cluster_meta,
        centroid_result=merge_out,
        rotation=pca.rotation,
        centers=pca.centers,
    )
