"""Per-gene variance modelling and HVG selection.

Stand-ins for the scran machinery that quickCorrect leans on
(reference R/quickCorrect.R:88-114): modelGeneVar -> combineVar ->
getTopHVGs. Means/variances are device reductions; the mean-variance trend
reuses the loess-style smoother from diagnostics.fit_trend_var.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import jax.numpy as jnp
import numpy as np

from ..correct.diagnostics import fit_trend_var

__all__ = ["model_gene_var", "combine_var", "get_top_hvgs", "GeneVarResult"]


@dataclass
class GeneVarResult:
    """Per-gene variance decomposition (scran::modelGeneVar analog)."""

    mean: np.ndarray
    total: np.ndarray
    tech: np.ndarray
    bio: np.ndarray


def model_gene_var(
    x: jnp.ndarray,
    block: Optional[Sequence] = None,
    span: float = 0.3,
) -> GeneVarResult:
    """Decompose per-gene variance of log-expression into a fitted
    mean-variance trend ("technical") and the residual ("biological").

    ``x``: (N, G) log-expression, cells in rows. ``block``: optional batch
    vector — statistics are computed per block and averaged, mirroring
    modelGeneVar's block= handling.
    """
    x = jnp.asarray(x)
    if block is None:
        blocks = [np.arange(x.shape[0])]
    else:
        block = np.asarray(block)
        blocks = [np.nonzero(block == b)[0] for b in sorted(set(block.tolist()))]

    results = []
    for idx in blocks:
        sub = x[jnp.asarray(idx)]
        mean = np.asarray(jnp.mean(sub, axis=0))
        total = np.asarray(jnp.var(sub, axis=0, ddof=1))
        trend = fit_trend_var(mean, total, span=span)
        tech = trend(mean)
        results.append(GeneVarResult(mean=mean, total=total, tech=tech, bio=total - tech))
    return combine_var(results)


def combine_var(results: Sequence[GeneVarResult]) -> GeneVarResult:
    """Average variance decompositions across blocks/batches
    (scran::combineVar analog, equal weights)."""
    n = len(results)
    return GeneVarResult(
        mean=sum(r.mean for r in results) / n,
        total=sum(r.total for r in results) / n,
        tech=sum(r.tech for r in results) / n,
        bio=sum(r.bio for r in results) / n,
    )


def get_top_hvgs(
    stats: GeneVarResult,
    n: int = 5000,
    prop: Optional[float] = None,
    var_threshold: float = 0.0,
) -> np.ndarray:
    """Indices of the top highly-variable genes by biological variance
    (scran::getTopHVGs analog): genes with bio > var_threshold, ranked
    descending, top n (or top prop fraction)."""
    bio = np.asarray(stats.bio)
    order = np.argsort(-bio, kind="stable")
    keep = order[bio[order] > var_threshold]
    if prop is not None:
        n = max(int(np.ceil(prop * bio.shape[0])), 1)
    return keep[:n]
