"""Exact SVD helpers: biological-subspace estimation and removal.

Equivalents of the reference's bio-span machinery
(.get_bio_span / .subtract_bio, R/mnnCorrect.R:487-538), using an exact
eigendecomposition instead of BiocSingular's IRLBA.
"""
from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["get_bio_span", "subtract_bio"]


@functools.partial(jax.jit, static_argnames=("transpose",))
def _centered_gram(x: jnp.ndarray, transpose: bool):
    centered = x - jnp.mean(x, axis=0, keepdims=True)
    gram = centered.T @ centered if transpose else centered @ centered.T
    return centered, gram


@functools.partial(jax.jit, static_argnames=("ndim", "transpose"))
def _span_project(centered, evals, evecs, ndim: int, transpose: bool):
    tiny = jnp.finfo(centered.dtype).tiny
    s = jnp.sqrt(jnp.maximum(evals[::-1][:ndim], 0.0))
    vec = evecs[:, ::-1][:, :ndim]
    if transpose:
        u = (centered @ vec) / jnp.maximum(s, tiny)[None, :]
        return vec, s, u
    v = (centered.T @ vec) / jnp.maximum(s, tiny)[None, :]
    return v, s, vec


def get_bio_span(
    x: jnp.ndarray,
    ndim: int,
    subset_row: Optional[np.ndarray] = None,
) -> jnp.ndarray:
    """Gene-space basis of the biological subspace of ``x`` (cells x genes).

    Columns are centred per gene; the top ``ndim`` right singular vectors
    span the "biology". With ``subset_row``, the SVD runs on the subset and
    the basis rows for leftover genes are back-projected
    (reference .get_bio_span, R/mnnCorrect.R:487-521). The singular vectors
    come from an exact ``jnp.linalg.eigh`` of the smaller-side Gram.
    """
    x = jnp.asarray(x)
    g_all = x.shape[1]
    sub = x if subset_row is None else x[:, jnp.asarray(np.asarray(subset_row))]
    ndim = int(min(ndim, sub.shape[0], sub.shape[1]))
    transpose = sub.shape[0] > sub.shape[1]
    centered, gram = _centered_gram(sub, transpose)
    evals, evecs = jnp.linalg.eigh(gram)
    v, s, u = _span_project(centered, evals, evecs, ndim, transpose)
    if subset_row is None:
        return v
    subset_row = np.asarray(subset_row)
    keep = np.zeros(g_all, dtype=bool)
    keep[subset_row] = True
    leftover_idx = np.nonzero(~keep)[0]
    # leftover rows: project unused genes into the same cell space
    left = x[:, jnp.asarray(leftover_idx)]
    left_centered = left - jnp.mean(left, axis=0, keepdims=True)
    safe_s = jnp.maximum(s, jnp.finfo(x.dtype).tiny)
    left_v = (left_centered.T @ u) / safe_s[None, :]
    out = jnp.zeros((g_all, ndim), x.dtype)
    out = out.at[jnp.asarray(subset_row)].set(v)
    out = out.at[jnp.asarray(leftover_idx)].set(left_v)
    return out


def subtract_bio(
    correction: jnp.ndarray,
    span1: jnp.ndarray,
    span2: jnp.ndarray,
    subset_row: Optional[np.ndarray] = None,
) -> jnp.ndarray:
    """Remove the components of ``correction`` parallel to two bio bases.

    Sequentially projects out span1 then span2 (order irrelevant per the
    reference comment). With ``subset_row``, magnitudes are computed on the
    subset only (reference .subtract_bio, R/mnnCorrect.R:523-538).
    """
    correction = jnp.asarray(correction)
    for span in (span1, span2):
        span = jnp.asarray(span)
        if subset_row is None:
            mag = correction @ span
        else:
            s = jnp.asarray(np.asarray(subset_row))
            mag = correction[:, s] @ span[s]
        correction = correction - mag @ span.T
    return correction
