"""Gaussian-kernel smoothing of per-MNN correction vectors.

Replacement for the reference's C++ kernel
(src/smooth_gaussian_kernel.cpp:10-118). The C++ manages log-space underflow
with a per-entry running-max trick; here the whole computation is a
log-softmax over a dense (n_mnn x n_cells) logit matrix — two matmuls
plus standard max-subtraction, numerically equivalent.

Weight of MNN group i at cell c:
    w[i, c] = exp(-d2(i, c)/sigma2) / density_i,    normalized over i,
    density_i = sum_j exp(-d2(i, j)/sigma2) over MNN cell locations j
(the density division stops high-density regions dominating the smoothing).
Output for cell c = sum_i w[i, c] * averaged[i].
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

__all__ = ["smooth_gaussian_kernel"]


@jax.jit
def _sq_dists(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """(n_a, n_b) squared Euclidean distances as a matmul."""
    acc = jnp.promote_types(a.dtype, jnp.float32)
    an = jnp.sum(jnp.square(a.astype(acc)), axis=1)
    bn = jnp.sum(jnp.square(b.astype(acc)), axis=1)
    prod = jnp.dot(a.astype(acc), b.astype(acc).T, preferred_element_type=acc)
    return jnp.maximum(an[:, None] + bn[None, :] - 2.0 * prod, 0.0)


@jax.jit
def _smooth(averaged: jnp.ndarray, mnn_pos: jnp.ndarray, data: jnp.ndarray, sigma2: jnp.ndarray):
    d2 = _sq_dists(mnn_pos, data)                      # (M, N)
    logw = -d2 / sigma2
    # density over the MNN locations themselves (columns at `index`);
    # distances mnn->mnn are symmetric so reuse the mnn block.
    d2_mm = _sq_dists(mnn_pos, mnn_pos)
    dens = jax.scipy.special.logsumexp(-d2_mm / sigma2, axis=1)
    logw = logw - dens[:, None]
    # normalized weights over MNN groups (log-softmax over axis 0)
    w = jax.nn.softmax(logw, axis=0)
    return w.T @ averaged                              # (N, G)


def smooth_gaussian_kernel(averaged, index, data, sigma2: float):
    """Smooth per-MNN-group vectors over all cells.

    averaged: (M, G) per-group averaged correction vectors (group order =
      ascending involved-cell index, see average_correction).
    index: (M,) row positions of the MNN-involved cells within ``data``.
    data: (N, Gd) coordinates used for distances (may differ from the value
      space, reference R/mnnCorrect.R:297-304).
    sigma2: bandwidth; the reference passes its ``sigma`` parameter straight
      through as the squared bandwidth (src/smooth_gaussian_kernel.cpp:51).

    Returns (N, G) smoothed correction vectors.
    """
    averaged = jnp.asarray(averaged)
    data = jnp.asarray(data)
    mnn_pos = data[jnp.asarray(index)]
    return _smooth(averaged, mnn_pos, data, jnp.asarray(sigma2, data.dtype))
