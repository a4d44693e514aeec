"""Lazy linear-model residuals (ResidualMatrix equivalent).

Analog of the ResidualMatrix used by regressBatches
(reference R/regressBatches.R:148). The residual operator
R = X - D (D'D)^-1 D' X is kept in factored form so it can be fused into
downstream matmuls (e.g. the PCA cross-product) without materializing a
dense residual matrix; ``materialize`` realizes it when per-gene values are
wanted.

Semantics preserved:
  * ``keep``: columns of the design whose fitted contribution is retained
    (not subtracted);
  * ``restrict``: coefficients are estimated from a subset of cells and the
    correction extrapolated to all cells.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["ResidualOp", "one_hot_design"]


def one_hot_design(batch: Sequence, levels=None) -> jnp.ndarray:
    """model.matrix(~0 + factor(batch)) equivalent: (N, n_levels) one-hot."""
    batch = np.asarray(batch)
    if levels is None:
        levels = sorted(set(batch.tolist()))
    lookup = {lv: i for i, lv in enumerate(levels)}
    idx = np.array([lookup[b] for b in batch.tolist()], dtype=np.int64)
    return jnp.asarray(np.eye(len(levels))[idx])


@dataclass(frozen=True)
class ResidualOp:
    """Factored residual operator over a (N, G) matrix.

    residuals = x - design[:, drop] @ beta[drop]  with
    beta = lstsq(design[restrict], x[restrict]).
    """

    x: jnp.ndarray            # (N, G)
    design: jnp.ndarray       # (N, P)
    beta: jnp.ndarray         # (P, G)
    drop: np.ndarray          # coefficient indices subtracted

    @staticmethod
    def fit(
        x: jnp.ndarray,
        design: jnp.ndarray,
        keep: Optional[Sequence[int]] = None,
        restrict: Optional[np.ndarray] = None,
    ) -> "ResidualOp":
        x = jnp.asarray(x)
        design = jnp.asarray(design, x.dtype)
        if restrict is not None:
            ridx = jnp.asarray(np.asarray(restrict))
            dfit, xfit = design[ridx], x[ridx]
        else:
            dfit, xfit = design, x
        # normal equations via pinv for rank safety (matches lm residuals)
        beta = jnp.linalg.pinv(dfit.T @ dfit) @ (dfit.T @ xfit)
        p = design.shape[1]
        if keep is None:
            drop = np.arange(p)
        else:
            drop = np.setdiff1d(np.arange(p), np.asarray(keep))
        return ResidualOp(x=x, design=design, beta=beta, drop=drop)

    @property
    def shape(self):
        return self.x.shape

    def materialize(self) -> jnp.ndarray:
        d = self.design[:, jnp.asarray(self.drop)]
        b = self.beta[jnp.asarray(self.drop)]
        return self.x - d @ b

    def matmul(self, other: jnp.ndarray) -> jnp.ndarray:
        """(residuals @ other) without materializing: X v - D_drop (B_drop v)."""
        d = self.design[:, jnp.asarray(self.drop)]
        b = self.beta[jnp.asarray(self.drop)]
        return self.x @ other - d @ (b @ other)

    def rmatmul(self, other: jnp.ndarray) -> jnp.ndarray:
        """(other @ residuals) = other X - (other D_drop) B_drop."""
        d = self.design[:, jnp.asarray(self.drop)]
        b = self.beta[jnp.asarray(self.drop)]
        return other @ self.x - (other @ d) @ b
