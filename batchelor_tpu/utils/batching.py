"""Batch plumbing: splitting, reordering and index bookkeeping.

Rebuild of the reference's batch plumbing layer
(reference: R/divideIntoBatches.R:36-100, R/utils_reorder.R:1-36,
R/utils_subset.R:2-18, R/checkInputs.R:42-120, R/intersectRows.R:53-80).

Conventions (deliberately different from the reference):
  * cells are ALWAYS rows of every matrix handed to the core engine
    (the reference flips between genes x cells at the API boundary and
    cells x dims internally; we pick one orientation once),
  * all indices are 0-based,
  * restriction is carried as integer index arrays (like the reference's
    normalized ``restrict``), converted to boolean masks on demand.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Mapping, Optional, Sequence, Union

import numpy as np

__all__ = [
    "check_batch_consistency",
    "check_restrictions",
    "divide_into_batches",
    "restore_original_order",
    "reindex_pairings",
    "combine_restrict",
    "generate_cell_names",
    "subset_to_index",
    "intersect_rows",
    "DividedBatches",
]

IndexLike = Union[Sequence[int], Sequence[bool], Sequence[str], np.ndarray, None]


def _n_cells(x, cells_in_rows: bool) -> int:
    return x.shape[0] if cells_in_rows else x.shape[1]


def _n_features(x, cells_in_rows: bool) -> int:
    return x.shape[1] if cells_in_rows else x.shape[0]


def check_batch_consistency(
    batches: Sequence[Any],
    *,
    cells_in_rows: bool = True,
    feature_names: Optional[Sequence[Optional[Sequence[str]]]] = None,
) -> None:
    """Verify all batches share the feature dimension (and names, if given).

    Mirrors checkBatchConsistency (reference R/checkInputs.R:42-76): the
    non-cell dimension must be identical across batches, as must feature
    names when supplied.
    """
    if len(batches) == 0:
        return
    ref_n = _n_features(batches[0], cells_in_rows)
    for b, cur in enumerate(batches[1:], start=1):
        if _n_features(cur, cells_in_rows) != ref_n:
            raise ValueError(
                f"number of features is not the same across batches (see batch {b})"
            )
    if feature_names is not None:
        ref_names = feature_names[0]
        for b, cur in enumerate(feature_names[1:], start=1):
            if (cur is None) != (ref_names is None) or (
                cur is not None and list(cur) != list(ref_names)
            ):
                raise ValueError(
                    f"feature names are not the same across batches (see batch {b})"
                )


def subset_to_index(index: IndexLike, n: int, names: Optional[Sequence[str]] = None) -> np.ndarray:
    """Normalize a subsetting vector to a 0-based integer index array.

    Accepts integer indices, boolean masks, or names (when ``names`` given).
    Mirrors .row_subset_to_index / .col_subset_to_index
    (reference R/utils_subset.R:2-18).
    """
    if index is None:
        return np.arange(n, dtype=np.int64)
    arr = np.asarray(index)
    if arr.dtype == bool:
        if arr.shape[0] != n:
            raise ValueError("boolean subset vector has the wrong length")
        return np.nonzero(arr)[0].astype(np.int64)
    if arr.dtype.kind in "US" or (arr.dtype == object and arr.size and isinstance(arr.flat[0], str)):
        if names is None:
            raise ValueError("character subsetting requires names")
        lookup = {nm: i for i, nm in enumerate(names)}
        try:
            return np.array([lookup[str(v)] for v in arr], dtype=np.int64)
        except KeyError as e:
            raise ValueError(f"subset name {e} not found") from None
    out = arr.astype(np.int64)
    if out.size and (out.min() < 0 or out.max() >= n):
        raise ValueError("subset indices out of range")
    return out


def check_restrictions(
    batches: Sequence[Any],
    restrictions: Optional[Sequence[IndexLike]],
    *,
    cells_in_rows: bool = True,
    cell_names: Optional[Sequence[Optional[Sequence[str]]]] = None,
) -> Optional[list]:
    """Normalize per-batch restriction vectors to 0-based index arrays.

    Mirrors checkRestrictions (reference R/checkInputs.R:92-120): one entry
    per batch, each either None or a non-empty subset of that batch's cells.
    """
    if restrictions is None:
        return None
    if len(batches) != len(restrictions):
        raise ValueError("'restrictions' must be of length equal to the number of batches")
    out = []
    for b, (bat, res) in enumerate(zip(batches, restrictions)):
        if res is None:
            out.append(None)
            continue
        n = _n_cells(bat, cells_in_rows)
        nm = cell_names[b] if cell_names is not None else None
        idx = subset_to_index(res, n, nm)
        if idx.size == 0:
            raise ValueError("no cells remaining in a batch after restriction")
        out.append(idx)
    return out


@dataclass
class DividedBatches:
    """Result of :func:`divide_into_batches`.

    Attributes:
      batches: list of per-batch matrices (cells from each level of ``batch``).
      reorder: permutation such that ``concat(batches)[reorder]`` restores the
        input cell order (reference R/divideIntoBatches.R contract).
      restricted: per-batch restriction indices (or None).
      names: the level names, in level order.
    """

    batches: list
    reorder: np.ndarray
    restricted: Optional[list]
    names: list = field(default_factory=list)


def _factor_levels(batch: np.ndarray) -> list:
    """Levels of a batch vector, following R's factor(): sorted unique values."""
    return sorted(set(batch.tolist()))


def divide_into_batches(
    x,
    batch: Sequence,
    *,
    cells_in_rows: bool = True,
    restrict: IndexLike = None,
) -> DividedBatches:
    """Split a single matrix into per-batch matrices by a batch factor.

    Mirrors divideIntoBatches (reference R/divideIntoBatches.R:36-100):
    levels are the sorted unique batch values, ``reorder`` recovers the input
    order after concatenating the per-batch blocks, and restriction indices
    are re-expressed within each batch.
    """
    batch = np.asarray(batch)
    n = _n_cells(x, cells_in_rows)
    if batch.shape[0] != n:
        raise ValueError("'batch' should have length equal to the number of cells")

    levels = _factor_levels(batch)
    restrict_mask = None
    if restrict is not None:
        idx = subset_to_index(restrict, n)
        restrict_mask = np.zeros(n, dtype=bool)
        restrict_mask[idx] = True

    batches, restricted, names = [], [], []
    reorder = np.empty(n, dtype=np.int64)
    last = 0
    for lv in levels:
        keep = batch == lv
        kidx = np.nonzero(keep)[0]
        cur = x[kidx] if cells_in_rows else x[:, kidx]
        batches.append(cur)
        names.append(lv)
        if restrict_mask is not None:
            cur_res = np.nonzero(restrict_mask[kidx])[0]
            if cur_res.size == 0:
                raise ValueError("no cells remaining in a batch after restriction")
            restricted.append(cur_res)
        reorder[kidx] = last + np.arange(kidx.size)
        last += kidx.size

    return DividedBatches(
        batches=batches,
        reorder=reorder,
        restricted=restricted if restrict_mask is not None else None,
        names=names,
    )


def restore_original_order(batch_ordering: Sequence[int], ncells_per_batch: Sequence[int]) -> np.ndarray:
    """Permutation recovering input batch order after a merge-order permutation.

    ``batch_ordering`` lists (0-based) batch ids in their merged order;
    within-batch cell order is preserved. Mirrors .restore_original_order
    (reference R/utils_reorder.R:1-18).
    """
    batch_ordering = list(batch_ordering)
    ncells = np.asarray(ncells_per_batch, dtype=np.int64)
    if len(batch_ordering) != ncells.shape[0]:
        raise ValueError("length of batch information vectors are not equal")
    chunks: list = [None] * len(batch_ordering)
    last = 0
    for idx in batch_ordering:
        cnt = int(ncells[idx])
        chunks[idx] = last + np.arange(cnt, dtype=np.int64)
        last += cnt
    return np.concatenate(chunks) if chunks else np.empty(0, dtype=np.int64)


def reindex_pairings(pairings: Sequence[np.ndarray], new_order: np.ndarray) -> list:
    """Remap MNN pair indices after cells are permuted by ``new_order``.

    ``new_order`` is a permutation applied to the merged matrix (i.e.
    output = merged[new_order]); pair indices referring to merged positions
    are rewritten to output positions. Mirrors .reindex_pairings
    (reference R/utils_reorder.R:20-36). Each pairing is a (P, 2) array.
    """
    new_order = np.asarray(new_order)
    rev = np.empty(new_order.shape[0], dtype=np.int64)
    rev[new_order] = np.arange(new_order.shape[0], dtype=np.int64)
    out = []
    for p in pairings:
        p = np.asarray(p)
        out.append(rev[p] if p.size else p.reshape(0, 2).astype(np.int64))
    return out


def generate_cell_names(
    name_lists: Sequence[Optional[Sequence[str]]],
    counts: Sequence[int],
) -> Optional[np.ndarray]:
    """Concatenate per-batch cell-name vectors for output dimnaming.

    Mirrors GENERATE_NAMES inside .rename_output (reference
    R/utils_multibatch.R:8-16): if some batches are named and others are
    not, the unnamed batches contribute empty strings; if none are named,
    the result is None.
    """
    if name_lists is None or all(nm is None for nm in name_lists):
        return None
    parts = []
    for nm, n in zip(name_lists, counts):
        if nm is None:
            parts.append(np.full(int(n), "", dtype=object))
        else:
            arr = np.asarray(nm, dtype=object)
            if arr.shape[0] != int(n):
                raise ValueError("cell names do not match the number of cells")
            parts.append(arr)
    return np.concatenate(parts) if parts else None


def combine_restrict(
    n_left: int,
    left_restrict: Optional[np.ndarray],
    n_right: int,
    right_restrict: Optional[np.ndarray],
) -> Optional[np.ndarray]:
    """Merge two restriction index sets after stacking left above right.

    Mirrors .combine_restrict (reference R/fastMNN.R:610-622): None only if
    both are None; otherwise missing sides default to "all cells".
    """
    if left_restrict is None and right_restrict is None:
        return None
    lr = np.arange(n_left, dtype=np.int64) if left_restrict is None else np.asarray(left_restrict)
    rr = np.arange(n_right, dtype=np.int64) if right_restrict is None else np.asarray(right_restrict)
    return np.concatenate([lr, rr + n_left])


def intersect_rows(
    batches: Sequence[Any],
    feature_names: Sequence[Sequence[str]],
    *,
    subset: Optional[Sequence[str]] = None,
    keep_all: bool = False,
    cells_in_rows: bool = True,
):
    """Subset all batches to their common feature universe.

    Mirrors intersectRows (reference R/intersectRows.R:53-80): the universe is
    the ordered intersection of feature-name lists; ``subset`` (names) may
    further subset unless ``keep_all``.

    Returns (new_batches, universe_names).
    """
    sets = [set(fn) for fn in feature_names]
    universe = [nm for nm in feature_names[0] if all(nm in s for s in sets[1:])]
    if len(universe) == 0:
        raise ValueError("no genes remaining in the intersection")

    out = []
    for x, fn in zip(batches, feature_names):
        lookup = {nm: i for i, nm in enumerate(fn)}
        idx = np.array([lookup[nm] for nm in universe], dtype=np.int64)
        if list(fn) != universe:
            x = x[:, idx] if cells_in_rows else x[idx]
        out.append(x)

    names = list(universe)
    if subset is not None and not keep_all:
        lookup = {nm: i for i, nm in enumerate(names)}
        idx = np.array([lookup[str(nm)] for nm in subset], dtype=np.int64)
        out = [(x[:, idx] if cells_in_rows else x[idx]) for x in out]
        names = [names[i] for i in idx]
    return out, names
