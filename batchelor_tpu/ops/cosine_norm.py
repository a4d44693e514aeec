"""Cosine (L2) normalization of per-cell expression vectors.

Equivalent of cosineNorm (reference R/cosineNorm.R:53-82).
Cells are rows here; the reference normalizes columns.
"""
from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

__all__ = ["cosine_norm", "l2_norms", "apply_cosine_norm"]

_L2_FLOOR = 1e-8  # zero-norm guard, reference R/cosineNorm.R:80


@jax.jit
def l2_norms(x: jnp.ndarray) -> jnp.ndarray:
    """Per-cell (row) L2 norms: sqrt(sum_g x[c, g]^2)."""
    return jnp.sqrt(jnp.sum(jnp.square(x), axis=1))


@jax.jit
def apply_cosine_norm(x: jnp.ndarray, l2: jnp.ndarray) -> jnp.ndarray:
    """Divide each row by max(l2, 1e-8) (reference .apply_cosine_norm)."""
    safe = jnp.maximum(jnp.asarray(_L2_FLOOR, x.dtype), l2.astype(x.dtype))
    return x / safe[:, None]


def cosine_norm(
    x: jnp.ndarray,
    mode: str = "matrix",
    subset_row: Optional[jnp.ndarray] = None,
):
    """Cosine-normalize cells (rows) of ``x``.

    mode="matrix" returns the normalized matrix; "l2norm" the norms;
    "all" a (matrix, l2norm) tuple. ``subset_row`` restricts the features
    used to compute the norms (columns here), mirroring the reference's
    subset.row; normalization is then applied to the subsetted matrix,
    exactly as the reference subsets before normalizing.
    """
    if subset_row is not None:
        x = x[:, jnp.asarray(subset_row)]
    l2 = l2_norms(x)
    if mode == "l2norm":
        return l2
    mat = apply_cosine_norm(x, l2)
    if mode == "matrix":
        return mat
    if mode == "all":
        return mat, l2
    raise ValueError(f"unknown mode {mode!r}")
