"""Mutual nearest-neighbour detection between two batches.

Replacement for BiocNeighbors::findMutualNN; the in-repo
authoritative statement of the algorithm is the reference's vestigial kernel
src/find_mutual_nns.cpp:7-41 (sort + binary-search membership test). Here the
membership test is a vectorized gather+compare on device.

Semantics (as used at reference R/MNN_tree.R:113-146):
  * ``k1`` = neighbours searched *in the left batch* (for each right cell),
    scaled by prop.k against the left batch size;
  * ``k2`` = neighbours searched *in the right batch* (for each left cell);
  * pair (i, j) is mutual iff j is one of i's k2 NNs in right AND i is one
    of j's k1 NNs in left;
  * pairs are emitted ordered by left cell, then by the distance rank of
    the right neighbour (the C++ iteration order).
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .knn import query_knn

__all__ = ["mutual_nn_masks", "find_mutual_nn", "choose_k", "MNNPairs"]


class MNNPairs(NamedTuple):
    """MNN pair lists: ``first`` indexes left cells, ``second`` right cells."""

    first: np.ndarray
    second: np.ndarray


def choose_k(k: int, prop_k: Optional[float], n: int) -> int:
    """Adapt k to the batch size via prop.k (reference R/MNN_tree.R:140-146).

    Uses banker's rounding like R's round()."""
    if prop_k is None:
        return k
    return int(min(n, max(k, round(prop_k * n))))


@functools.partial(jax.jit, static_argnames=("chunk",))
def _membership(l2r: jnp.ndarray, r2l: jnp.ndarray, chunk: int):
    """mask[i, pos] = i in r2l[l2r[i, pos]], computed in row chunks."""
    n1, k2 = l2r.shape

    def block(args):
        rows, row_ids = args               # (C, k2), (C, 1)
        gathered = r2l[rows]               # (C, k2, k1)
        return jnp.any(gathered == row_ids[:, :, None], axis=-1)

    ids = jnp.arange(n1, dtype=jnp.int32)[:, None]
    pad = -(-n1 // chunk) * chunk - n1
    l2r_p = jnp.pad(l2r, ((0, pad), (0, 0)))
    ids_p = jnp.pad(ids, ((0, pad), (0, 0)), constant_values=-1)
    nblk = l2r_p.shape[0] // chunk
    mask = jax.lax.map(
        block,
        (l2r_p.reshape(nblk, chunk, k2), ids_p.reshape(nblk, chunk, 1)),
    ).reshape(-1, k2)[:n1]
    return mask


def membership_rows(l2r: jnp.ndarray, r2l: jnp.ndarray, row_ids: jnp.ndarray,
                    chunk: int = 1 << 16) -> jnp.ndarray:
    """mask[i, p] = row_ids[i] in r2l[l2r[i, p]], computed in row blocks so
    the (N1, k2, k1) gather never materializes at once (jit-traceable;
    used inside the fused/distributed merge steps at large N).

    The lax.map carrier and per-block outputs are laid out (nblk, k2,
    chunk)."""
    nsl, k2 = l2r.shape
    chunk = min(chunk, max(nsl, 1))
    nblk = -(-nsl // chunk)
    pad = nblk * chunk - nsl
    l2r_t = jnp.swapaxes(
        jnp.pad(l2r, ((0, pad), (0, 0))).T.reshape(k2, nblk, chunk), 0, 1
    )                                         # (nblk, k2, C)
    ids_p = jnp.pad(row_ids, (0, pad), constant_values=-1)

    def blk(args):
        rows_t, ids = args                    # (k2, C), (C,)
        return jnp.any(
            r2l[rows_t.T] == ids[:, None, None], axis=-1
        ).T                                   # (k2, C)

    mask_t = jax.lax.map(
        blk, (l2r_t, ids_p.reshape(nblk, chunk))
    )                                         # (nblk, k2, C)
    return jnp.swapaxes(mask_t, 0, 1).reshape(k2, -1)[:, :nsl].T


def mutual_nn_masks(left, right, k1: int, k2: int, method: str = "exact"):
    """Device-side MNN detection.

    Returns (mutual_mask (N1, k2) bool, left_to_right_indices (N1, k2),
    left_to_right_distances). The two kNN searches and the membership test
    are separately jitted so their compilations cache independently across
    merge steps.
    """
    left = jnp.asarray(left)
    right = jnp.asarray(right)
    nn_l2r = query_knn(left, right, k2, method=method)  # left's k2 NNs in right
    nn_r2l = query_knn(right, left, k1, method=method)  # right's k1 NNs in left
    n1 = left.shape[0]
    chunk = max(1, min(n1, (1 << 22) // max(1, k1 * k2)))
    mask = _membership(nn_l2r.indices, nn_r2l.indices, chunk)
    return mask, nn_l2r.indices, nn_l2r.distances


@functools.partial(jax.jit, static_argnames=("cap",))
def _compact_pairs(mask: jnp.ndarray, l2r: jnp.ndarray, cap: int):
    """(first, second) pair lists padded to a static ``cap``, on device.

    nonzero() walks the mask row-major, which IS the reference emission
    order (left cell, then distance rank — src/find_mutual_nns.cpp:30-38).
    Only 3*cap scalars ever cross to the host, instead of the full (N1, k2)
    mask + index matrices (10 MB at 100k cells vs ~100 KB)."""
    rows, cols = jnp.nonzero(mask, size=cap, fill_value=mask.shape[0])
    safe_rows = jnp.minimum(rows, mask.shape[0] - 1)
    second = l2r[safe_rows, cols]
    return rows, second


def find_mutual_nn(left, right, k1: int, k2: int, method: str = "exact") -> MNNPairs:
    """Materialized MNN pair lists (host numpy), in the reference's order."""
    mask, l2r, _ = mutual_nn_masks(left, right, k1, k2, method=method)
    count = int(jnp.sum(mask))             # scalar sync: sizes the fetch
    if count == 0:
        return MNNPairs(
            first=np.zeros(0, dtype=np.int64), second=np.zeros(0, dtype=np.int64)
        )
    # power-of-two cap buckets the compiled shapes (one compile per bucket)
    cap = min(1 << (count - 1).bit_length(), mask.size)
    rows, second = _compact_pairs(mask, l2r, cap)
    first = np.asarray(rows)[:count].astype(np.int64)
    second = np.asarray(second)[:count].astype(np.int64)
    return MNNPairs(first=first, second=second)


def restricted_mnn(
    left_data,
    left_restrict: Optional[np.ndarray],
    right_data,
    right_restrict: Optional[np.ndarray],
    k: int,
    prop_k: Optional[float] = None,
    method: str = "exact",
) -> MNNPairs:
    """MNN search on restricted subsets, mapped back to full-batch indices.

    Mirrors .restricted_mnn (reference R/MNN_tree.R:113-138)."""
    ld = left_data if left_restrict is None else left_data[np.asarray(left_restrict)]
    rd = right_data if right_restrict is None else right_data[np.asarray(right_restrict)]
    k1 = choose_k(k, prop_k, ld.shape[0])
    k2 = choose_k(k, prop_k, rd.shape[0])
    pairs = find_mutual_nn(ld, rd, k1, k2, method=method)
    first, second = pairs.first, pairs.second
    if left_restrict is not None:
        first = np.asarray(left_restrict)[first]
    if right_restrict is not None:
        second = np.asarray(right_restrict)[second]
    return MNNPairs(first=first, second=second)
