"""Out-of-core multi-batch PCA over CSR-backed batches.

The sparse-preserving analog of the reference's deferred ScaledMatrix PCA
(reference R/multiBatchPCA.R:76-78, 288-301): centering never materializes.
The weighted Gram matrix is accumulated from streamed dense blocks with the
centering expanded algebraically,

    sum_b w_b/N_b (X_b - 1 c^T)^T (X_b - 1 c^T)
      = sum_b w_b/N_b [ X_b^T X_b - s_b c^T - c s_b^T + N_b c c^T ],

where s_b = X_b^T 1 (per-gene sums). Only G x G accumulators and one dense
block at a time live in memory, so batches far larger than HBM stream
through; projections are emitted block-by-block the same way.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Union

import jax
import jax.numpy as jnp
import numpy as np

from ..io.csr import CSRCells, auto_blocks, dense_blocks, device_dense_blocks
from .pca import (
    MultiBatchPCAResult,
    _randomized_psd_eigh,
    construct_weight_vector,
)

__all__ = ["multi_batch_pca_csr"]


@jax.jit
def _block_gram(block: jnp.ndarray, mask: jnp.ndarray):
    b = jnp.where(mask[:, None], block, 0.0)
    return (
        b.T @ b,
        jnp.sum(b, axis=0),
    )


def multi_batch_pca_csr(
    batches: Sequence[CSRCells],
    d: int = 50,
    *,
    weights: Union[None, bool, Sequence[float], list] = None,
    subset_row: Optional[np.ndarray] = None,
    block_rows: int = 8192,
    eig_method: str = "auto",
    batch_names: Optional[Sequence[str]] = None,
    mesh=None,
    transfer: str = "auto",
) -> MultiBatchPCAResult:
    """Weighted multi-batch PCA streaming CSR batches block-by-block.

    Numerically equivalent to multi_batch_pca on the densified inputs
    (same grand-mean centering and per-batch 1/sqrt(N_b/w_b) scaling), but
    the input is never densified at once.

    With ``mesh``, each streamed block is row-sharded over the mesh and the
    G x G accumulation / projection matmuls run SPMD (GSPMD inserts the
    reduction collectives) — the bridge between the out-of-core store and
    the distributed engine (the analog of the reference feeding
    DelayedArray blocks to BPPARAM-parallel PCA, R/multiBatchPCA.R:217-219).

    ``transfer`` picks how blocks reach the device: "dense" ships densified
    fp32 blocks, "sparse" ships nnz (index, value) pairs and densifies on
    device (io.csr.device_dense_blocks; bit-identical result, ~6x fewer
    link bytes at 10% density), "auto" uses sparse per batch for matrices
    under 25% density. Sparse composes with ``mesh``: each device receives
    only its own rows' nnz pairs and the scatter runs sharded.
    """
    if transfer not in ("auto", "dense", "sparse"):
        raise ValueError(f"unknown transfer mode {transfer!r}")
    if subset_row is not None:
        batches = [c.select_genes(subset_row) for c in batches]
    g = batches[0].n_genes
    ns = [c.n_cells for c in batches]
    w = construct_weight_vector(ns, weights, batch_names)

    put = jnp.asarray
    if mesh is not None:
        from ..parallel.mesh import cells_sharding

        _shard = cells_sharding(mesh)
        ndev = mesh.devices.size
        if block_rows % ndev:
            block_rows = -(-block_rows // ndev) * ndev

        def put(x):  # noqa: F811 — sharded device_put for streamed blocks
            return jax.device_put(jnp.asarray(x), _shard)

    def blocks(csr, block_rows):
        """Per-batch streamer choice (one dense batch no longer forces host
        densify on its sparse siblings, and vice versa)."""
        if transfer == "sparse":
            return device_dense_blocks(csr, block_rows=block_rows, mesh=mesh)
        if transfer == "dense":
            return dense_blocks(csr, block_rows=block_rows)
        return auto_blocks(csr, block_rows=block_rows, mesh=mesh)

    # pass 1: per-batch gene sums + raw Gram accumulators
    grams = []
    sums = []
    for csr in batches:
        acc_g = jnp.zeros((g, g), jnp.float32)
        acc_s = jnp.zeros((g,), jnp.float32)
        for block, n_valid in blocks(csr, block_rows=block_rows):
            mask = jnp.arange(block.shape[0]) < n_valid
            bg, bs = _block_gram(put(block), mask)
            acc_g = acc_g + bg
            acc_s = acc_s + bs
        grams.append(acc_g)
        sums.append(acc_s)

    means = [s / n for s, n in zip(sums, ns)]
    wsum = float(np.sum(w))
    centers = sum(mu * float(wi) for mu, wi in zip(means, w)) / wsum

    gram = jnp.zeros((g, g), jnp.float32)
    for gb, sb, n, wi in zip(grams, sums, ns, w):
        scale = float(wi) / n
        centered = (
            gb
            - jnp.outer(sb, centers)
            - jnp.outer(centers, sb)
            + n * jnp.outer(centers, centers)
        )
        gram = gram + scale * centered
    gram = (gram + gram.T) / 2

    if eig_method == "randomized" or (eig_method == "auto" and g > 1024):
        evals, v = _randomized_psd_eigh(gram, int(min(d, g)))
    else:
        ev, evec = jnp.linalg.eigh(gram)
        evals = ev[::-1][: int(min(d, g))]
        v = evec[:, ::-1][:, : int(min(d, g))]

    # pass 2: project each block of the (unscaled) centered batches.
    # Components stay HOST-side numpy: at atlas scale they are the largest
    # long-lived arrays (10M x 50 = 2 GB) and holding device copies here
    # starves the merge engine's HBM; consumers upload (sharded) when used.
    components: List[np.ndarray] = []
    for csr in batches:
        outs = []
        for block, n_valid in blocks(csr, block_rows=block_rows):
            proj = (put(block) - centers[None, :]) @ v
            outs.append(np.asarray(proj[:n_valid]))
        components.append(np.concatenate(outs, axis=0))

    return MultiBatchPCAResult(
        components=components,
        rotation=v,
        centers=centers,
        batch_names=list(batch_names) if batch_names is not None else None,
    )
