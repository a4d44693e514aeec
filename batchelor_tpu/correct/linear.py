"""Linear baselines: rescaleBatches, regressBatches, noCorrect.

Rebuilds of the reference's linear correction methods
(R/rescaleBatches.R:63-182, R/regressBatches.R:93-158, R/noCorrect.R:45-76).
Cells in rows; outputs are per-gene matrices in input cell order.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import jax.numpy as jnp
import numpy as np

from ..ops.pca import multi_batch_pca
from ..ops.residual import ResidualOp, one_hot_design
from ..utils.batching import (
    check_batch_consistency,
    check_restrictions,
    divide_into_batches,
)

__all__ = ["rescale_batches", "regress_batches", "no_correct", "LinearCorrectionResult"]


@dataclass
class LinearCorrectionResult:
    corrected: jnp.ndarray          # (N_total, G)
    batch: np.ndarray               # per-cell batch label
    corrected_pcs: Optional[jnp.ndarray] = None  # regress_batches with d set
    residual_op: Optional[ResidualOp] = None
    cell_names: Optional[np.ndarray] = None      # per output cell
    gene_names: Optional[np.ndarray] = None      # per output gene


def _output_names(cell_names, gene_names, batches, reorder, subset_row, correct_all):
    """Resolve output dimnames (reference .rename_output,
    R/utils_multibatch.R:3-33): cell names concatenate per batch (single
    input passes through, since output is input order); gene names follow
    the output gene subset."""
    from ..utils.batching import generate_cell_names

    cn = None
    if cell_names is not None:
        if reorder is not None:  # single-matrix input: names in input order
            cn = np.asarray(cell_names, dtype=object)
        else:
            cn = generate_cell_names(cell_names, [b.shape[0] for b in batches])
    gn = None
    if gene_names is not None:
        gn = np.asarray(gene_names, dtype=object)
        if subset_row is not None and not correct_all:
            gn = gn[np.asarray(subset_row)]
    return cn, gn


def _normalize_inputs(batches_or_single, batch, restrict, batch_names):
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
        reorder = divided.reorder
    else:
        batches = [jnp.asarray(b) for b in batches_or_single]
        check_batch_consistency(batches, cells_in_rows=True)
        restrict = check_restrictions(batches, restrict, cells_in_rows=True)
        reorder = None
    return batches, restrict, batch_names, reorder


def _batch_labels(batches, batch_names):
    sizes = [b.shape[0] for b in batches]
    origin = np.repeat(np.arange(len(batches)), sizes)
    if batch_names is not None:
        if len(set(batch_names)) != len(batch_names):
            raise ValueError("names of batches should be unique")
        return np.asarray(batch_names)[origin]
    return origin


def rescale_batches(
    batches_or_single,
    batch: Optional[Sequence] = None,
    *,
    restrict=None,
    log_base: float = 2.0,
    pseudo_count: float = 1.0,
    subset_row: Optional[np.ndarray] = None,
    correct_all: bool = False,
    batch_names: Optional[Sequence[str]] = None,
    cell_names=None,
    gene_names=None,
) -> LinearCorrectionResult:
    """Scale each gene so every batch matches the lowest per-batch average,
    in count space (reference .rescale_batches, R/rescaleBatches.R:102-148).

    Restricted cells define the averages; the scaling applies to all cells.
    """
    batches, restrict, batch_names, reorder = _normalize_inputs(
        batches_or_single, batch, restrict, batch_names
    )
    if len(batches) < 2:
        raise ValueError("at least two batches must be specified")
    if correct_all:
        subset_row = None
    if subset_row is not None:
        s = jnp.asarray(np.asarray(subset_row))
        batches = [b[:, s] for b in batches]

    unlogged = [jnp.power(log_base, b) - pseudo_count for b in batches]
    averages = []
    for i, u in enumerate(unlogged):
        cur = u
        if restrict is not None and restrict[i] is not None:
            cur = u[jnp.asarray(restrict[i])]
        averages.append(jnp.mean(cur, axis=0))

    reference = averages[0]
    for a in averages[1:]:
        reference = jnp.minimum(reference, a)

    corrected = []
    for u, a in zip(unlogged, averages):
        scale = reference / a
        scale = jnp.where(jnp.isfinite(scale), scale, 0.0)
        corrected.append(jnp.log(u * scale[None, :] + pseudo_count) / jnp.log(
            jnp.asarray(log_base, u.dtype)
        ))

    out = jnp.concatenate(corrected, axis=0)
    labels = _batch_labels(batches, batch_names)
    if reorder is not None:
        out = out[jnp.asarray(reorder)]
        labels = labels[reorder]
    cn, gn = _output_names(
        cell_names, gene_names, batches, reorder, subset_row, correct_all
    )
    return LinearCorrectionResult(
        corrected=out, batch=labels, cell_names=cn, gene_names=gn
    )


def regress_batches(
    batches_or_single,
    batch: Optional[Sequence] = None,
    *,
    design: Optional[jnp.ndarray] = None,
    keep: Optional[Sequence[int]] = None,
    restrict=None,
    subset_row: Optional[np.ndarray] = None,
    correct_all: bool = False,
    d: Optional[int] = None,
    batch_names: Optional[Sequence[str]] = None,
    cell_names=None,
    gene_names=None,
) -> LinearCorrectionResult:
    """Linear-model residual correction (reference regressBatches,
    R/regressBatches.R:93-158). The residual operator is kept factored
    (ResidualOp) and only materialized for the output matrix; with ``d`` a
    multi_batch_pca runs on the residuals."""
    batches, restrict, batch_names, reorder = _normalize_inputs(
        batches_or_single, batch, restrict, batch_names
    )
    cn, gn = _output_names(
        cell_names, gene_names, batches, reorder, subset_row, correct_all
    )
    sizes = [b.shape[0] for b in batches]
    combined = jnp.concatenate(batches, axis=0)
    origin = np.repeat(np.arange(len(batches)), sizes)
    labels = _batch_labels(batches, batch_names)

    if restrict is not None:
        flat = []
        off = 0
        for r, n in zip(restrict, sizes):
            if r is None:
                flat.append(np.arange(n) + off)
            else:
                flat.append(np.asarray(r) + off)
            off += n
        flat_restrict = np.concatenate(flat)
    else:
        flat_restrict = None

    if not correct_all and subset_row is not None:
        combined = combined[:, jnp.asarray(np.asarray(subset_row))]
        subset_row = None

    if design is None:
        design = one_hot_design(origin)
    else:
        design = jnp.asarray(design)
        if design.shape[0] != combined.shape[0]:
            raise ValueError("'design' should have one row per cell")

    op = ResidualOp.fit(combined, design, keep=keep, restrict=flat_restrict)
    corrected = op.materialize()

    pcs = None
    if d is not None:
        per_batch = []
        off = 0
        for n in sizes:
            per_batch.append(corrected[off : off + n])
            off += n
        pca = multi_batch_pca(per_batch, d=d, subset_row=subset_row)
        pcs = jnp.concatenate(pca.components, axis=0)

    if reorder is not None:
        corrected = corrected[jnp.asarray(reorder)]
        labels = labels[reorder]
        if pcs is not None:
            pcs = pcs[jnp.asarray(reorder)]
    return LinearCorrectionResult(
        corrected=corrected, batch=labels, corrected_pcs=pcs, residual_op=op,
        cell_names=cn, gene_names=gn,
    )


def no_correct(
    batches_or_single,
    batch: Optional[Sequence] = None,
    *,
    subset_row: Optional[np.ndarray] = None,
    correct_all: bool = False,
    batch_names: Optional[Sequence[str]] = None,
    cell_names=None,
    gene_names=None,
) -> LinearCorrectionResult:
    """cbind-only negative control (reference noCorrect, R/noCorrect.R:45-76)."""
    batches, _, batch_names, reorder = _normalize_inputs(
        batches_or_single, batch, None, batch_names
    )
    cn, gn = _output_names(
        cell_names, gene_names, batches, reorder, subset_row, correct_all
    )
    if subset_row is not None and not correct_all:
        s = jnp.asarray(np.asarray(subset_row))
        batches = [b[:, s] for b in batches]
    out = jnp.concatenate(batches, axis=0)
    labels = _batch_labels(batches, batch_names)
    if reorder is not None:
        out = out[jnp.asarray(reorder)]
        labels = labels[reorder]
    return LinearCorrectionResult(
        corrected=out, batch=labels, cell_names=cn, gene_names=gn
    )
