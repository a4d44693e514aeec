"""Weighted multi-batch PCA as a distributed Gram-matrix eigendecomposition.

Rebuild of multiBatchPCA (reference R/multiBatchPCA.R:139-557).
Instead of IRLBA on a deferred-scaled matrix, we accumulate the G x G
weighted cross-product (G = number of genes after subsetting) across
batches — a chain of matmuls plus a psum on a device mesh — and take an
exact eigendecomposition. Deterministic, no iterative solver.

Semantics preserved from the reference:
  * the centering vector is the weighted grand mean of per-batch gene means
    (R/multiBatchPCA.R:270-282),
  * each batch's covariance contribution is divided by N_b / w_b
    (R/multiBatchPCA.R:293-318), equalizing batches by default,
  * per-batch outputs are the *unscaled* centered matrices projected onto
    the rotation (R/multiBatchPCA.R:236-239),
  * rotation extrapolation to unselected genes when get_all_genes
    (R/multiBatchPCA.R:396-435), variance reporting, and the d=None
    passthrough mode (R/multiBatchPCA.R:245-255, 439-461).

Orientation: cells in rows (N_b x G), the transpose of the reference.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Union

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.trees import tree_weights

# fp32 products for PCA Grams and projections: at JAX's default precision an
# fp32 matmul may run as TF32 on the GPU, which put ~1e-3 relative error into
# the Gram and the components (chip_smoke.py phase (a)), amplified by 1/s
# along weak components (phase (d)).
matmul_f32 = functools.partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)

__all__ = ["multi_batch_pca", "construct_weight_vector", "MultiBatchPCAResult"]


def construct_weight_vector(
    ncells: Sequence[int],
    weights: Union[None, bool, Sequence[float], list],
    names: Optional[Sequence[str]] = None,
) -> np.ndarray:
    """Per-batch weights (reference .construct_weight_vector).

    None/True -> 1 per batch (equal batch contributions); False -> N_b (no
    reweighting); a numeric vector is used directly; a nested list is a
    weight tree (equal split at each level, R/multiBatchPCA.R:329-381).
    """
    ncells = np.asarray(ncells, dtype=np.float64)
    nb = ncells.shape[0]
    if weights is None or weights is True:
        return np.ones(nb)
    if weights is False:
        return ncells.copy()
    if isinstance(weights, list) and any(isinstance(w, (list, tuple)) for w in weights):
        return tree_weights(weights, nb, names)
    w = np.asarray(weights, dtype=np.float64)
    if w.shape[0] != nb:
        raise ValueError("'weights' should have one entry per batch")
    return w


@dataclass
class MultiBatchPCAResult:
    """Outputs of :func:`multi_batch_pca`.

    components: per-batch (N_b, d) PC coordinates.
    rotation: (G, d) rotation matrix (G = reported genes).
    centers: (G,) centering vector.
    var_explained / var_total: weighted variance metadata (if requested).
    """

    components: List[jnp.ndarray]
    rotation: jnp.ndarray
    centers: jnp.ndarray
    var_explained: Optional[np.ndarray] = None
    var_total: Optional[float] = None
    batch_names: Optional[list] = None


def _randomized_psd_eigh(gram: jnp.ndarray, d: int, iters: int = 8, oversample: int = 16):
    """Top-d eigenpairs of a PSD matrix by subspace iteration.

    Matmul-only (no O(G^3) eigh of the Gram): power iterations with
    CholeskyQR re-orthonormalization, then a small Rayleigh-Ritz eigh. The
    analog of the reference's RandomParam/rsvd BSPARAM option
    (R/multiBatchPCA.R:72-74). Deterministic: fixed seed.
    """
    g = gram.shape[0]
    p = min(d + oversample, g)
    key = jax.random.PRNGKey(0)
    q = jax.random.normal(key, (g, p), gram.dtype)

    def chol_qr(y):
        r = jnp.linalg.cholesky(y.T @ y + 1e-30 * jnp.eye(p, dtype=y.dtype))
        return jax.scipy.linalg.solve_triangular(r, y.T, lower=True).T

    def body(q, _):
        return chol_qr(gram @ q), None

    q, _ = jax.lax.scan(body, chol_qr(q), None, length=iters)
    b = q.T @ (gram @ q)
    b = (b + b.T) / 2
    w, u = jnp.linalg.eigh(b)
    w = w[::-1][:d]
    v = (q @ u[:, ::-1])[:, :d]
    return w, v


@functools.partial(jax.jit, static_argnames=("d",))
def _svd_direct(scaled: jnp.ndarray, d: int):
    u, s, vt = jnp.linalg.svd(scaled, full_matrices=False)
    return vt[:d].T, s[:d], u[:, :d]


@functools.partial(jax.jit, static_argnames=("d", "transpose"))
def _svd_randomized(scaled: jnp.ndarray, d: int, transpose: bool):
    if transpose:
        gram = scaled.T @ scaled
        evals, v = _randomized_psd_eigh(gram, d)
        s = jnp.sqrt(jnp.maximum(evals, 0.0))
        u = (scaled @ v) / jnp.maximum(s, jnp.finfo(scaled.dtype).tiny)[None, :]
        return v, s, u
    gram = scaled @ scaled.T
    evals, u = _randomized_psd_eigh(gram, d)
    s = jnp.sqrt(jnp.maximum(evals, 0.0))
    v = (scaled.T @ u) / jnp.maximum(s, jnp.finfo(scaled.dtype).tiny)[None, :]
    return v, s, u


@functools.partial(jax.jit, static_argnames=("transpose",))
def _gram_of(scaled: jnp.ndarray, transpose: bool):
    if transpose:
        return matmul_f32(scaled.T, scaled)
    return matmul_f32(scaled, scaled.T)


@functools.partial(jax.jit, static_argnames=("d", "transpose"))
def _gram_project(scaled, evals, evecs, d: int, transpose: bool):
    """Top-d (V, s, U) from an ascending eigh of the smaller-side Gram."""
    ev = evals[::-1][:d]
    vec = evecs[:, ::-1][:, :d]
    s = jnp.sqrt(jnp.maximum(ev, 0.0))
    safe = jnp.maximum(s, jnp.finfo(scaled.dtype).tiny)[None, :]
    if transpose:                                     # Gram was (G, G)
        u = matmul_f32(scaled, vec) / safe
        return vec, s, u
    v = matmul_f32(scaled.T, vec) / safe              # Gram was (sumN, sumN)
    return v, s, vec


def _scaled_svd(scaled: jnp.ndarray, d: int, method: str):
    """Top-d right singular vectors of ``scaled`` (sum-N x G).

    Returns (V (G, d), singvals (d,), U (sumN, d)). ``method``:
    "gram" uses the exact eigendecomposition (``jnp.linalg.eigh``) of the
    smaller-side cross-product; "randomized" uses matmul-only subspace
    iteration on the Gram (accurate for d << G); "direct" uses a full SVD
    (most accurate, most FLOPs).
    """
    n, g = scaled.shape
    if method == "direct":
        return _svd_direct(scaled, d)
    if method == "randomized":
        return _svd_randomized(scaled, d, g <= n)
    transpose = g <= n
    gram = _gram_of(scaled, transpose)
    evals, evecs = jnp.linalg.eigh(gram)
    return _gram_project(scaled, evals, evecs, d, transpose)


def _center_and_scale(
    mats: Sequence[jnp.ndarray], weights: np.ndarray
):
    """Grand-mean centering + per-batch 1/sqrt(N_b/w_b) scaling.

    Returns (centered list, scaled concat (sumN, G), centers (G,))."""
    means = [jnp.mean(m, axis=0) for m in mats]
    wsum = float(np.sum(weights))
    centers = sum(mu * float(w) for mu, w in zip(means, weights)) / wsum
    centered = [m - centers[None, :] for m in mats]
    scaled = jnp.concatenate(
        [c / np.sqrt(m.shape[0] / w) for c, m, w in zip(centered, mats, weights)],
        axis=0,
    )
    return centered, scaled, centers


def multi_batch_pca(
    batches: Sequence[jnp.ndarray],
    d: Optional[int] = 50,
    *,
    weights: Union[None, bool, Sequence[float], list] = None,
    subset_row: Optional[np.ndarray] = None,
    get_all_genes: bool = False,
    get_variance: bool = False,
    method: str = "gram",
    batch_names: Optional[Sequence[str]] = None,
) -> MultiBatchPCAResult:
    """Weighted PCA across batches projecting all cells to a common space.

    ``batches``: list of (N_b, G) matrices (cells in rows). ``subset_row``
    selects feature columns used for the PCA; with ``get_all_genes`` the
    rotation/centers are extrapolated back to all G features
    (reference R/multiBatchPCA.R:396-435). ``d=None`` skips the PCA and
    returns centered matrices with an identity rotation
    (reference R/multiBatchPCA.R:245-255).
    """
    batches = [jnp.asarray(b) for b in batches]
    nb = len(batches)
    if nb == 0:
        raise ValueError("at least one batch must be specified")
    w = construct_weight_vector([b.shape[0] for b in batches], weights, batch_names)

    g_all = batches[0].shape[1]
    if subset_row is not None:
        subset_row = np.asarray(subset_row)
        sub = [b[:, jnp.asarray(subset_row)] for b in batches]
    else:
        sub = list(batches)

    centered, scaled, centers = _center_and_scale(sub, w)

    if d is None:
        # Passthrough mode: centered data, identity/injection rotation,
        # zero centers (reference .make_fake_metadata R/multiBatchPCA.R:439-461).
        g_sub = sub[0].shape[1]
        if get_all_genes and subset_row is not None:
            rotation = jnp.zeros((g_all, g_sub), scaled.dtype)
            rotation = rotation.at[jnp.asarray(subset_row), jnp.arange(g_sub)].set(1.0)
            out_centers = jnp.zeros((g_all,), scaled.dtype)
        else:
            rotation = jnp.eye(g_sub, dtype=scaled.dtype)
            out_centers = jnp.zeros((g_sub,), scaled.dtype)
        res = MultiBatchPCAResult(
            components=centered,
            rotation=rotation,
            centers=out_centers,
            batch_names=list(batch_names) if batch_names is not None else None,
        )
        if get_variance:
            n = scaled.shape[0]
            mu = jnp.mean(scaled, axis=0)
            var = jnp.sum(jnp.square(scaled - mu[None, :]), axis=0) / (n - 1)
            res.var_explained = np.asarray(var)
            res.var_total = float(jnp.sum(var))
        return res

    d_eff = int(min(d, scaled.shape[0], scaled.shape[1]))
    v, s, u = _scaled_svd(scaled, d_eff, method)

    components = [matmul_f32(c, v) for c in centered]

    if get_all_genes and subset_row is not None:
        keep = np.zeros(g_all, dtype=bool)
        keep[subset_row] = True
        leftover_idx = np.nonzero(~keep)[0]
        left = [b[:, jnp.asarray(leftover_idx)] for b in batches]
        _, left_scaled, left_centers = _center_and_scale(left, w)
        # leftover rotation rows: project unused genes into the cell space
        # (reference R/multiBatchPCA.R:396-414): u_left = scaled_left^T U / s.
        safe_s = jnp.maximum(s, jnp.finfo(scaled.dtype).tiny)
        leftover_u = matmul_f32(left_scaled.T, u) / safe_s[None, :]
        rotation = jnp.zeros((g_all, d_eff), scaled.dtype)
        rotation = rotation.at[jnp.asarray(subset_row)].set(v)
        rotation = rotation.at[jnp.asarray(leftover_idx)].set(leftover_u)
        all_centers = jnp.zeros((g_all,), scaled.dtype)
        all_centers = all_centers.at[jnp.asarray(subset_row)].set(centers)
        all_centers = all_centers.at[jnp.asarray(leftover_idx)].set(left_centers)
    else:
        rotation = v
        all_centers = centers

    res = MultiBatchPCAResult(
        components=components,
        rotation=rotation,
        centers=all_centers,
        batch_names=list(batch_names) if batch_names is not None else None,
    )
    if get_variance:
        res.var_explained = np.asarray(jnp.square(s)) / nb
        res.var_total = float(jnp.sum(jnp.square(scaled))) / nb
    return res
