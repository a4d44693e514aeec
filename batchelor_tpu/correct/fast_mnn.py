"""fastMNN: PC-space mutual-nearest-neighbour batch correction.

Rebuild of the reference's flagship algorithm
(R/fastMNN.R:283-658, R/reducedMNN.R:61-95). The merge-tree walk is
host-side Python; every numeric step (kNN/MNN, averaging, orthogonalization,
tricube apply) runs as jit-compiled XLA/Pallas work on device.

Pipeline: cosine-norm -> multi_batch_pca -> merge loop over a binary merge
tree, where each step finds MNN pairs between the left/right sets, removes
variation along the average batch vector ("kissing" protection,
R/fastMNN.R:84-88), then applies tricube-smoothed per-cell corrections.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Optional, Sequence, Union

import jax.numpy as jnp
import numpy as np

from ..ops.correction import (
    average_correction,
    batch_magnitude,
    center_along_batch_vector,
    orthogonalize_other,
    per_batch_var,
    tricube_weighted_correction,
)
from ..ops.cosine_norm import apply_cosine_norm, cosine_norm
from ..ops.mutual_nn import choose_k, restricted_mnn
from ..ops.pca import MultiBatchPCAResult, multi_batch_pca
from ..utils.batching import (
    check_batch_consistency,
    check_restrictions,
    combine_restrict,
    divide_into_batches,
    generate_cell_names,
    reindex_pairings,
    restore_original_order,
)
from ..utils.telemetry import get_recorder, trace_span
from ..utils.trees import MergeNode, create_tree_predefined, get_next_merge, update_tree

__all__ = ["fast_mnn", "reduced_mnn", "MNNResult", "MergeStepInfo"]


@dataclass
class MergeStepInfo:
    """Diagnostics for one merge step (reference merge.info, R/fastMNN.R:549-561).

    ``pairs`` holds 0-based cell indices into the *output* ordering;
    ``lost_var`` is per input batch (nan for batches not yet merged).
    """

    left: list
    right: list
    pairs: np.ndarray
    batch_size: float
    skipped: bool
    lost_var: np.ndarray


@dataclass
class MNNResult:
    """Corrected coordinates plus diagnostics.

    corrected: (N_total, d) corrected coordinates, input cell order.
    batch: per-cell batch label (int index or name).
    merge_info: one MergeStepInfo per merge step.
    rotation/centers: PCA metadata when fast_mnn ran the PCA itself; the
      ``reconstructed`` low-rank per-gene matrix is rotation @ corrected.T.
    """

    corrected: jnp.ndarray
    batch: np.ndarray
    merge_info: List[MergeStepInfo]
    rotation: Optional[jnp.ndarray] = None
    centers: Optional[jnp.ndarray] = None
    var_explained: Optional[np.ndarray] = None
    var_total: Optional[float] = None
    batch_names: Optional[list] = None
    cell_names: Optional[np.ndarray] = None   # per output cell (input order)
    gene_names: Optional[np.ndarray] = None   # rows of ``rotation``

    def reconstructed(self, rows=None, cols=None):
        """Low-rank per-gene corrected values (genes x cells) as a lazy
        operator (reference LowRankMatrix, R/convertPCsToSCE.R:50-72).

        Returns a :class:`~batchelor_tpu.ops.lowrank.LowRankOp`; index with
        ``rows``/``cols`` to materialize one block in O(block) memory, or
        call ``.materialize()`` for the dense matrix.
        """
        if self.rotation is None:
            raise ValueError("no rotation available (d=None or reduced input)")
        from ..ops.lowrank import LowRankOp

        op = LowRankOp(self.rotation, self.corrected)
        if rows is not None or cols is not None:
            return op.block(rows, cols)
        return op


# --------------------------------------------------------------------------
# auto.merge machinery (reference R/MNN_tree.R:154-226)


def _count_pairs(left: MergeNode, right: MergeNode, k, prop_k, orthogonalize) -> int:
    ld, rd = left.data, right.data
    if orthogonalize:
        rd = orthogonalize_other(rd, right.restrict, left.extras)
        ld = orthogonalize_other(ld, left.restrict, right.extras)
    pairs = restricted_mnn(ld, left.restrict, rd, right.restrict, k=k, prop_k=prop_k)
    return int(pairs.first.shape[0])


def _init_auto_search(nodes: List[MergeNode], k, prop_k, orthogonalize):
    n = len(nodes)
    stats = np.zeros((n, n), dtype=np.int64)
    for i in range(n):
        for j in range(i):
            stats[i, j] = _count_pairs(nodes[i], nodes[j], k, prop_k, orthogonalize)
    return stats


def _pick_best_merge(stats: np.ndarray):
    """First maximal entry in column-major order (R which(..., arr.ind) order)."""
    mx = stats.max()
    cols, rows = np.nonzero(stats.T == mx)
    return int(rows[0]), int(cols[0])


# --------------------------------------------------------------------------
# core merge loop (reference .fast_mnn_core, R/fastMNN.R:436-562)


def _fast_mnn_core(
    batches: Sequence[jnp.ndarray],
    restrict: Optional[Sequence[Optional[np.ndarray]]],
    *,
    k: int = 20,
    prop_k: Optional[float] = None,
    ndist: float = 3.0,
    merge_order=None,
    auto_merge: bool = False,
    min_batch_skip: Optional[float] = 0.0,
    batch_names: Optional[Sequence[str]] = None,
    checkpoint_dir: Optional[str] = None,
    knn_method: str = "exact",
):
    checkpointer = None
    if checkpoint_dir is not None:
        from ..io.checkpoint import MergeCheckpointer

        checkpointer = MergeCheckpointer(checkpoint_dir)
    nbatches = len(batches)
    nmerges = nbatches - 1
    diags: List[Optional[MergeStepInfo]] = [None] * nmerges
    left_sets: List[list] = [None] * nmerges
    raw_pairs: List[np.ndarray] = [None] * nmerges
    var_kept = np.ones((nmerges, nbatches), dtype=np.float64)
    # per-step batch.size: device scalars until the end of the loop (the
    # host only needs the value when min_batch_skip > 0 gates the step)
    batch_size: list = [np.nan] * nmerges
    skipped = np.zeros(nmerges, dtype=bool)
    right_sets: List[list] = [None] * nmerges

    if restrict is None:
        restrict = [None] * nbatches

    if not auto_merge:
        tree = create_tree_predefined(batches, restrict, merge_order, batch_names)
        remainders = None
        stats = None
    else:
        remainders = [MergeNode.leaf(i, batches[i], restrict[i]) for i in range(nbatches)]
        stats = _init_auto_search(remainders, k, prop_k, orthogonalize=True)
        tree = None

    final_node: Optional[MergeNode] = None

    for mdx in range(nmerges):
        # Resume path: replay a completed step from the checkpoint store
        # without recomputation.
        if checkpointer is not None and mdx < checkpointer.completed_steps:
            tree_path, chosen, merged, diag = checkpointer.load_step(mdx)
            left_sets[mdx] = diag["left_set"]
            right_sets[mdx] = diag["right_set"]
            raw_pairs[mdx] = diag["pairs"]
            batch_size[mdx] = diag["batch_size"]
            skipped[mdx] = diag["skipped"]
            var_kept[mdx] = 1.0 - diag["lost_var"]
            if not auto_merge:
                # consistency: the DFS must address the same subtree AND the
                # same batch sets as when the checkpoint was written
                cur_left, cur_right, expect_path = get_next_merge(tree)
                if (
                    expect_path != tree_path
                    or list(cur_left.index) != list(diag["left_set"])
                    or list(cur_right.index) != list(diag["right_set"])
                ):
                    raise ValueError("checkpoint does not match this merge tree")
                tree = update_tree(tree, tree_path, merged)
                if not isinstance(tree, list):
                    final_node = tree
            else:
                li, ri = chosen
                keep = [x for t, x in enumerate(remainders) if t not in (li, ri)]
                remainders = keep + [merged]
                stats = diag["stats"]
                if len(remainders) == 1:
                    final_node = merged
            continue

        if not auto_merge:
            left, right, path = get_next_merge(tree)
        else:
            li, ri = _pick_best_merge(stats)
            left, right = remainders[li], remainders[ri]

        left_old = per_batch_var(left.data, left.index, left.origin)
        right_old = per_batch_var(right.data, right.index, right.origin)
        left_sets[mdx] = list(left.index)
        right_sets[mdx] = list(right.index)

        # Replay earlier batch vectors on the opposite side before MNN search
        # (reference R/fastMNN.R:472-474).
        with trace_span("fastmnn/orthogonalize", step=mdx):
            right_data = orthogonalize_other(right.data, right.restrict, left.extras)
            left_data = orthogonalize_other(left.data, left.restrict, right.extras)

        with trace_span("fastmnn/mnn_search", step=mdx):
            pairs = restricted_mnn(
                left_data, left.restrict, right_data, right.restrict,
                k=k, prop_k=prop_k, method=knn_method,
            )
        if pairs.first.shape[0] == 0:
            raise ValueError(
                f"no MNN pairs found at merge step {mdx}; increase k or check inputs"
            )

        averaged, _second = average_correction(left_data, pairs.first, right_data, pairs.second)
        overall = jnp.mean(averaged, axis=0)

        # batch.size is always reported (reference R/fastMNN.R:484-492 computes
        # it unconditionally; min.batch.skip only gates the skip decision).
        # The scalar only crosses to the host when the skip gate can fire
        # (min_batch_skip > 0) — otherwise the fetch would stall the
        # dispatch pipeline once per merge step for nothing.
        mag_dev = batch_magnitude(averaged)
        do_correct = True
        if min_batch_skip is not None and min_batch_skip > 0.0:
            mag = float(mag_dev)
            batch_size[mdx] = mag
            if mag < min_batch_skip:
                do_correct = False
                skipped[mdx] = True
        else:
            batch_size[mdx] = mag_dev

        if do_correct:
            with trace_span("fastmnn/correct", step=mdx):
                left_data = center_along_batch_vector(left_data, overall, left.restrict)
                right_data = center_along_batch_vector(right_data, overall, right.restrict)
                left_new = per_batch_var(left_data, left.index, left.origin)
                right_new = per_batch_var(right_data, right.index, right.origin)
                to_add = [overall]
                re_avg, second = average_correction(
                    left_data, pairs.first, right_data, pairs.second
                )
                right_data = tricube_weighted_correction(
                    right_data,
                    re_avg,
                    second,
                    k=choose_k(k, prop_k, right_data.shape[0]),
                    ndist=ndist,
                )
        else:
            to_add = []
            left_new = per_batch_var(left_data, left.index, left.origin)
            right_new = per_batch_var(right_data, right.index, right.origin)

        with np.errstate(invalid="ignore", divide="ignore"):
            var_kept[mdx, left.index] = left_new / left_old
            var_kept[mdx, right.index] = right_new / right_old
        raw_pairs[mdx] = np.stack([pairs.first, pairs.second], axis=1)
        rec = get_recorder()
        if rec is not None:
            rec.add("merge_steps")
            rec.add("mnn_pairs", float(pairs.first.shape[0]))
            rec.add("cells_merged", float(left.data.shape[0] + right.data.shape[0]))

        merged = MergeNode(
            index=list(left.index) + list(right.index),
            data=jnp.concatenate([left_data, right_data], axis=0),
            restrict=combine_restrict(
                left_data.shape[0], left.restrict, right_data.shape[0], right.restrict
            ),
            origin=np.concatenate([left.origin, right.origin]),
            extras=list(left.extras) + list(right.extras) + to_add,
        )

        if not auto_merge:
            tree = update_tree(tree, path, merged)
            if not isinstance(tree, list):
                final_node = tree
        else:
            keep = [x for t, x in enumerate(remainders) if t not in (li, ri)]
            kept_idx = [t for t in range(len(remainders)) if t not in (li, ri)]
            old = stats[np.ix_(kept_idx, kept_idx)]
            new_counts = [
                _count_pairs(merged, other, k, prop_k, orthogonalize=True) for other in keep
            ]
            n_new = len(keep) + 1
            stats = np.zeros((n_new, n_new), dtype=np.int64)
            stats[: len(keep), : len(keep)] = old
            stats[len(keep), : len(keep)] = np.asarray(new_counts, dtype=np.int64)
            remainders = keep + [merged]
            if len(remainders) == 1:
                final_node = merged

        if checkpointer is not None:
            checkpointer.save_step(
                mdx,
                path if not auto_merge else None,
                None if not auto_merge else [li, ri],
                merged,
                {
                    "pairs": raw_pairs[mdx],
                    "lost_var": 1.0 - var_kept[mdx],
                    "left_set": left_sets[mdx],
                    "right_set": right_sets[mdx],
                    "batch_size": float(batch_size[mdx]),
                    "skipped": bool(skipped[mdx]),
                    "stats": stats if auto_merge else None,
                },
            )

    assert final_node is not None
    full_data = final_node.data
    full_order = final_node.index
    full_origin = final_node.origin

    # Re-index pairs into final concatenated positions (reference
    # R/fastMNN.R:532-538): offset by the first cell of each side's block.
    pairings = []
    origin_list = full_origin.tolist()
    for mdx in range(nmerges):
        p = raw_pairs[mdx].copy()
        bonus1 = origin_list.index(left_sets[mdx][0])
        bonus2 = origin_list.index(right_sets[mdx][0])
        p[:, 0] += bonus1
        p[:, 1] += bonus2
        pairings.append(p)

    # Restore input batch order (reference R/fastMNN.R:540-547).
    if any(full_order[i] > full_order[i + 1] for i in range(len(full_order) - 1)):
        ncells = np.bincount(full_origin, minlength=nbatches)
        ordering = restore_original_order(full_order, ncells)
        full_data = full_data[jnp.asarray(ordering)]
        full_origin = full_origin[ordering]
        pairings = reindex_pairings(pairings, ordering)

    merge_info = [
        MergeStepInfo(
            left=left_sets[m],
            right=right_sets[m],
            pairs=pairings[m],
            batch_size=float(batch_size[m]),
            skipped=bool(skipped[m]),
            lost_var=1.0 - var_kept[m],
        )
        for m in range(nmerges)
    ]

    batch_labels = full_origin
    if batch_names is not None:
        names = np.asarray(batch_names)
        if len(set(batch_names)) != len(batch_names):
            raise ValueError("names of batches should be unique")
        batch_labels = names[full_origin]
        for info in merge_info:
            info.left = [batch_names[i] for i in info.left]
            info.right = [batch_names[i] for i in info.right]

    return MNNResult(
        corrected=full_data,
        batch=batch_labels,
        merge_info=merge_info,
        batch_names=list(batch_names) if batch_names is not None else None,
    )


# --------------------------------------------------------------------------
# public entry points


def reduced_mnn(
    batches_or_single,
    batch: Optional[Sequence] = None,
    *,
    k: int = 20,
    prop_k: Optional[float] = None,
    restrict=None,
    ndist: float = 3.0,
    merge_order=None,
    auto_merge: bool = False,
    min_batch_skip: Optional[float] = 0.0,
    batch_names: Optional[Sequence[str]] = None,
    checkpoint_dir: Optional[str] = None,
    knn_method: str = "exact",
    cell_names=None,
) -> MNNResult:
    """MNN correction on precomputed low-dimensional coordinates.

    Equivalent of reducedMNN (reference R/reducedMNN.R:61-95): either a list
    of (N_b, d) matrices, or a single (N, d) matrix plus a ``batch`` vector.
    ``cell_names``: per-batch name vectors (list input) or one input-order
    vector (single input); carried to the output like the reference's
    .rename_output (R/utils_multibatch.R:3-33).
    """
    if isinstance(batches_or_single, (list, tuple)):
        batches = [jnp.asarray(b) for b in batches_or_single]
        check_batch_consistency(batches, cells_in_rows=True)
        restrict = check_restrictions(batches, restrict, cells_in_rows=True)
        out = _fast_mnn_core(
            batches,
            restrict,
            k=k,
            prop_k=prop_k,
            ndist=ndist,
            merge_order=merge_order,
            auto_merge=auto_merge,
            min_batch_skip=min_batch_skip,
            batch_names=batch_names,
            checkpoint_dir=checkpoint_dir,
            knn_method=knn_method,
        )
        if cell_names is not None:
            out.cell_names = generate_cell_names(
                cell_names, [b.shape[0] for b in batches]
            )
        return out

    x = jnp.asarray(batches_or_single)
    divided = divide_into_batches(
        np.asarray(x), batch, cells_in_rows=True, restrict=restrict
    )
    names = [str(n) for n in divided.names]
    out = _fast_mnn_core(
        [jnp.asarray(b) for b in divided.batches],
        divided.restricted,
        k=k,
        prop_k=prop_k,
        ndist=ndist,
        merge_order=merge_order,
        auto_merge=auto_merge,
        min_batch_skip=min_batch_skip,
        batch_names=names,
        checkpoint_dir=checkpoint_dir,
        knn_method=knn_method,
    )
    reo = divided.reorder
    out.corrected = out.corrected[jnp.asarray(reo)]
    out.batch = out.batch[reo]
    new_pairs = reindex_pairings([i.pairs for i in out.merge_info], reo)
    for info, p in zip(out.merge_info, new_pairs):
        info.pairs = p
    if cell_names is not None:
        # single input: output is input cell order, names pass through
        out.cell_names = np.asarray(cell_names, dtype=object)
    return out


def fast_mnn(
    batches_or_single,
    batch: Optional[Sequence] = None,
    *,
    k: int = 20,
    prop_k: Optional[float] = None,
    restrict=None,
    cos_norm: bool = True,
    ndist: float = 3.0,
    d: Optional[int] = 50,
    weights=None,
    get_variance: bool = False,
    merge_order=None,
    auto_merge: bool = False,
    min_batch_skip: Optional[float] = 0.0,
    subset_row: Optional[np.ndarray] = None,
    correct_all: bool = False,
    svd_method: str = "gram",
    batch_names: Optional[Sequence[str]] = None,
    checkpoint_dir: Optional[str] = None,
    knn_method: str = "exact",
    cell_names=None,
    gene_names=None,
) -> MNNResult:
    """Fast MNN batch correction (reference fastMNN, R/fastMNN.R:283-331).

    Accepts a list of (N_b, G) matrices (cells in rows) or a single matrix
    plus ``batch``. Output cells are always in input order.
    ``cell_names``/``gene_names`` are carried onto the result like the
    reference's .rename_output (R/utils_multibatch.R:3-33); gene names
    follow the rotation rows (subset by ``subset_row`` unless
    ``correct_all``).
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
    else:
        batches = [jnp.asarray(b) for b in batches_or_single]
        if len(batches) < 2:
            raise ValueError("at least two batches must be specified")
        check_batch_consistency(batches, cells_in_rows=True)
        restrict = check_restrictions(batches, restrict, cells_in_rows=True)

    # Cosine norm: L2 computed on the gene subset, applied to the full
    # matrix; PCA handles subsetting (reference R/fastMNN.R:348-354, 371-377).
    if cos_norm:
        l2s = [cosine_norm(b, mode="l2norm", subset_row=subset_row) for b in batches]
        batches = [apply_cosine_norm(b, l2) for b, l2 in zip(batches, l2s)]

    pca = multi_batch_pca(
        batches,
        d=d,
        weights=weights,
        subset_row=subset_row,
        get_all_genes=correct_all and subset_row is not None,
        get_variance=get_variance,
        method=svd_method,
        batch_names=batch_names,
    )
    out = _fast_mnn_core(
        pca.components,
        restrict,
        k=k,
        prop_k=prop_k,
        ndist=ndist,
        merge_order=merge_order,
        auto_merge=auto_merge,
        min_batch_skip=min_batch_skip,
        batch_names=batch_names,
        checkpoint_dir=checkpoint_dir,
        knn_method=knn_method,
    )
    if single:
        reo = divided.reorder
        out.corrected = out.corrected[jnp.asarray(reo)]
        out.batch = out.batch[reo]
        new_pairs = reindex_pairings([i.pairs for i in out.merge_info], reo)
        for info, p in zip(out.merge_info, new_pairs):
            info.pairs = p

    out.rotation = pca.rotation
    out.centers = pca.centers
    out.var_explained = pca.var_explained
    out.var_total = pca.var_total
    if cell_names is not None:
        if single:
            out.cell_names = np.asarray(cell_names, dtype=object)
        else:
            out.cell_names = generate_cell_names(
                cell_names, [b.shape[0] for b in batches]
            )
    if gene_names is not None:
        gn = np.asarray(gene_names, dtype=object)
        if subset_row is not None and not correct_all:
            gn = gn[np.asarray(subset_row)]
        out.gene_names = gn
    return out
