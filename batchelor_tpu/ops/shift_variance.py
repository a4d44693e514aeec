"""Quantile-matching variance adjustment of correction vectors.

Replacement for the reference's C++ kernel
(src/adjust_shift_variance.cpp:29-164), the anti-"kissing" scaling of
classic mnnCorrect. The per-cell loop with inner O(N) passes becomes a set
of dense matmuls over (N2 x N2) and (N2 x N1) blocks plus a sorted
log-space cumulative sum (associative scan).

For each cell c of batch 2 with correction vector v_c:
  * project every batch-2 cell onto g_c = v_c/||v_c||; weight each by a
    Gaussian kernel on its squared distance to the line through c along g_c;
  * the cell's within-batch quantile = weighted fraction of (restricted)
    batch-2 cells with projection <= its own;
  * find the matching weighted quantile among (restricted) batch-1 cells'
    projections; the scaling is (ref_quantile - own_projection)/||v_c||.
Scaling is clamped to >= 1 by the caller (reference R/mnnCorrect.R:479).
"""
from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["adjust_shift_variance"]


_CHUNK = 1024  # query cells per block (memory ~ chunk x (N1 + N2))

# The exact sort is the default at every N: on the system's former
# accelerator the radix descent and the per-chunk (C, N1) lax.sort timed
# the same, the kernel being bound by the O(N^2 G) weight-matrix
# construction rather than the quantile search. Neither has been timed on
# the H100. The radix path (resolution 2^-24 of the row range) stays
# available via quantile_method="radix".
_RADIX_BITS = 24  # quantization resolution (2^-24 of the per-row range)


def _ref_quantile_radix(proj, w, valid, target, bits: int = _RADIX_BITS):
    """Weighted-quantile crossing value per row by bitwise radix descent.

    For each row c, returns (approximately) the smallest projection p among
    valid cells with  sum_{proj[c,k] <= p} w[c,k] >= target[c]  — the value
    the sorted-cumsum path reads at the first crossing (reference
    src/adjust_shift_variance.cpp:120-141). Projections are quantized to
    ``bits`` bits of the per-row [min, max] range and the quantile bin is
    found by descending one bit at a time: at each bit, one masked row
    reduction computes the weight in the left half of the current prefix.
    Cost: ``bits`` passes of compare+multiply+row-sum over (C, N1) — no
    sort. Deviations vs the sort path: the crossing cell is resolved at
    2^-bits of the row range (distinct values closer than that may pick
    the smaller), and partial-sum rounding differs from the sorted cumsum
    at exact-boundary targets. Both are below fp32 noise for the classic
    pipeline's O(1)-scale cosine data; the exact sort path remains in use
    below _RADIX_MIN_N1.

    ``w`` must already be 0 at invalid cells. No-crossing rows (target
    beyond the total weight) fall back to the max valid projection, like
    the sort path's last_valid.
    """
    acc = proj.dtype
    neg_inf = jnp.asarray(-jnp.inf, acc)
    pos_inf = jnp.asarray(jnp.inf, acc)
    lo = jnp.min(jnp.where(valid, proj, pos_inf), axis=1)     # (C,)
    hi = jnp.max(jnp.where(valid, proj, neg_inf), axis=1)
    span = jnp.maximum(hi - lo, jnp.finfo(acc).tiny)
    nbins = jnp.asarray(2.0**bits, acc)
    idx = jnp.clip(
        jnp.floor((proj - lo[:, None]) / span[:, None] * nbins),
        0.0, nbins - 1.0,
    ).astype(jnp.int32)                                        # (C, N1)

    def bit_step(carry, k):
        pref, c0 = carry                                       # (C,) each
        # weight in the left half of the current prefix at bit k
        match_left = (idx >> k) == (pref << 1)[:, None]
        s_left = jnp.sum(jnp.where(match_left, w, 0.0), axis=1)
        go_left = c0 + s_left >= target
        pref = (pref << 1) | jnp.where(go_left, 0, 1)
        c0 = jnp.where(go_left, c0, c0 + s_left)
        return (pref, c0), None

    zero = jnp.zeros(proj.shape[0], jnp.int32)
    (bin_id, _), _ = jax.lax.scan(
        bit_step,
        (zero, jnp.zeros(proj.shape[0], acc)),
        jnp.arange(bits - 1, -1, -1),
    )

    in_bin = valid & (idx == bin_id[:, None])
    q = jnp.min(jnp.where(in_bin, proj, pos_inf), axis=1)
    # fp safety nets: empty bin -> smallest value at/above the bin floor;
    # no crossing at all -> max valid projection (sort path's last_valid)
    bin_lo = lo + bin_id.astype(acc) / nbins * span
    above = valid & (proj >= bin_lo[:, None])
    q_above = jnp.min(jnp.where(above, proj, pos_inf), axis=1)
    q = jnp.where(jnp.isfinite(q), q, q_above)
    crossed = jnp.sum(w, axis=1) >= target
    return jnp.where(crossed & jnp.isfinite(q), q, hi)


@functools.partial(jax.jit, static_argnames=("use_radix",))
def _adjust(
    data1: jnp.ndarray,       # (N1, G)
    data2: jnp.ndarray,       # (N2, G)
    correction: jnp.ndarray,  # (N2, G)
    sigma2: jnp.ndarray,
    mask1: jnp.ndarray,       # (N1,) bool: restrict1
    mask2: jnp.ndarray,       # (N2,) bool: restrict2
    use_radix: bool = False,
):
    acc = jnp.promote_types(data1.dtype, jnp.float32)
    d1 = data1.astype(acc)
    d2 = data2.astype(acc)
    corr = correction.astype(acc)

    l2 = jnp.sqrt(jnp.sum(jnp.square(corr), axis=1))           # (N2,)
    grads = jnp.where(l2[:, None] > 0, corr / jnp.where(l2 == 0, 1.0, l2)[:, None], corr)

    sq2 = jnp.sum(jnp.square(d2), axis=1)
    sq1 = jnp.sum(jnp.square(d1), axis=1)
    n1 = d1.shape[0]
    n2 = d2.shape[0]
    neg_inf = jnp.asarray(-jnp.inf, acc)
    n_valid = jnp.sum(mask1).astype(jnp.int32)
    col2 = jnp.arange(n2)

    hi = jax.lax.Precision.HIGHEST  # bf16 distances would corrupt the kernel

    def block(args):
        """One chunk of query cells c: all matrices are (C, N1/N2) — the
        kernel is inherently O(N^2 G) (the reference's non-scaling part,
        src/adjust_shift_variance.cpp:51-161) but memory stays O(chunk N).

        Weights are Gaussian log-probs shifted by the row max and
        exponentiated ONCE (w = exp(lp - max lp)): every ratio/threshold
        below compares weight *sums* scaled by the same per-row constant, so
        the quantile search is exact while costing one transcendental per
        element instead of logsumexp/logaddexp chains, and the sorted
        crossing scan is a plain additive cumsum. Unlike raw exp(-d/s2)
        (what the C++ accumulates in double) the shifted form cannot
        underflow to an all-zero row at small sigma.
        """
        gch, d2ch, sq2ch, l2ch, rows = args            # (C, G) ... (C,)
        P2 = jnp.matmul(gch, d2.T, precision=hi)       # (C, N2)
        # own projection read from the SAME matmul row: duplicated cells then
        # compare bitwise-equal to their twins, reproducing the C++'s exact
        # `sameproj > curproj` tie behavior (inner_product on identical data)
        # — an elementwise dot here differs by ~1 ulp and flips the tie.
        curproj = jnp.take_along_axis(
            P2, jnp.clip(rows, 0, n2 - 1)[:, None], axis=1
        )[:, 0]                                        # (C,)
        G22 = jnp.matmul(d2ch, d2.T, precision=hi)
        diff_par = curproj[:, None] - P2
        dist2 = sq2ch[:, None] + sq2[None, :] - 2.0 * G22 - jnp.square(diff_par)
        lp2 = -jnp.maximum(dist2, 0.0) / sigma2
        eye = rows[:, None] == col2[None, :]
        lp2 = jnp.where(eye, 0.0, lp2)                 # self: log-prob 0
        add_mask = (P2 <= curproj[:, None]) | eye
        lp2_all = jnp.where(mask2[None, :], lp2, neg_inf)
        m2 = jnp.max(lp2_all, axis=1, keepdims=True)
        m2 = jnp.where(jnp.isfinite(m2), m2, 0.0)
        w2 = jnp.exp(lp2_all - m2)                     # (C, N2), in [0, 1]
        den2 = jnp.sum(w2, axis=1)
        num2 = jnp.sum(jnp.where(add_mask, w2, 0.0), axis=1)
        # empty numerator (cell outside restrict2 with no admissible cells):
        # the C++ leaves the accumulator at log-prob 0 (weight 1 unscaled)
        num2 = jnp.where(num2 == 0.0, jnp.exp(-m2[:, 0]), num2)
        prob2 = num2 / den2                            # scale cancels

        P1 = jnp.matmul(gch, d1.T, precision=hi)       # (C, N1)
        C12 = jnp.matmul(d2ch, d1.T, precision=hi)
        diff_par1 = curproj[:, None] - P1
        dist1 = sq2ch[:, None] + sq1[None, :] - 2.0 * C12 - jnp.square(diff_par1)
        lw1 = jnp.where(mask1[None, :], -jnp.maximum(dist1, 0.0) / sigma2, neg_inf)
        m1 = jnp.max(lw1, axis=1, keepdims=True)
        m1 = jnp.where(jnp.isfinite(m1), m1, 0.0)
        w1 = jnp.exp(lw1 - m1)                         # shared exp(-m1) scale
        target = prob2 * jnp.sum(w1, axis=1)

        if use_radix:
            # sort-free weighted quantile (measured speed-equal to the
            # sort at 100k-400k; opt-in, see module constants)
            valid1 = jnp.broadcast_to(mask1[None, :], P1.shape)
            ref_quan = _ref_quantile_radix(P1, w1, valid1, target)
            return (ref_quan - curproj) / l2ch
        proj_sort_key = jnp.where(mask1[None, :], P1, jnp.inf)
        # one multi-operand sort instead of argsort + two gathers (the
        # gathers cost more than the sort itself at N1 ~ 10^5)
        proj_sorted, w_sorted = jax.lax.sort(
            (proj_sort_key, w1), dimension=1, num_keys=1
        )
        cum = jnp.cumsum(w_sorted, axis=1)
        crossed = cum >= target[:, None]
        any_crossed = jnp.any(crossed, axis=1)
        first = jnp.argmax(crossed, axis=1)
        last_valid = jnp.take_along_axis(
            proj_sorted, jnp.full((rows.shape[0], 1), n_valid - 1, jnp.int32), axis=1
        )[:, 0]
        ref_quan = jnp.where(
            any_crossed,
            jnp.take_along_axis(proj_sorted, first[:, None], axis=1)[:, 0],
            last_valid,
        )
        return (ref_quan - curproj) / l2ch

    chunk = min(_CHUNK, n2)
    npad = -(-n2 // chunk) * chunk
    pad = npad - n2

    def padc(x, value=0.0):
        widths = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
        return jnp.pad(x, widths, constant_values=value)

    nblk = npad // chunk
    scaling = jax.lax.map(
        block,
        (
            padc(grads).reshape(nblk, chunk, -1),
            padc(d2).reshape(nblk, chunk, -1),
            padc(sq2).reshape(nblk, chunk),
            padc(l2, value=1.0).reshape(nblk, chunk),
            padc(col2, value=-1).reshape(nblk, chunk),
        ),
    ).reshape(-1)[:n2]
    return scaling


def adjust_shift_variance(
    data1,
    data2,
    correction,
    sigma2: float,
    restrict1: Optional[np.ndarray] = None,
    restrict2: Optional[np.ndarray] = None,
    subset_row: Optional[np.ndarray] = None,
    quantile_method: str = "sort",
):
    """Per-cell scaled correction vectors (reference .adjust_shift_variance,
    R/mnnCorrect.R:462-481).

    data1/data2: (N1, G)/(N2, G) cell-row matrices; correction: (N2, G).
    With ``subset_row``, locations are computed on the gene subset while the
    returned scaling applies to the full correction. Scaling is clamped to
    >= 1. Zero-norm correction vectors are left unscaled (scale 1; the C++
    produces NaN there, which R's pmax then propagates — we instead define
    the no-op).

    ``quantile_method``: "sort" (default; exact sorted-cumsum crossing) or
    "radix" (sort-free 24-bit descent, _ref_quantile_radix). The kernel is
    bound by its O(N^2 G) weight construction, so the exact sort is the
    default at every N. In fp32 the radix partial sums round differently from the
    sorted cumsum, so knife-edge ECDF crossings may flip by one element
    (exact in fp64).
    """
    if subset_row is not None:
        # subset BEFORE any device conversion: host (np) inputs slice on
        # host, so the full-gene out-matrices of the out_on_host classic
        # path never materialize in HBM (only their subset columns and the
        # correction do). Device inputs slice on device as before.
        s = np.asarray(subset_row)

        def _loc(x):
            if isinstance(x, np.ndarray):
                return jnp.asarray(x[:, s])
            return jnp.asarray(x)[:, jnp.asarray(s)]

        loc1, loc2 = _loc(data1), _loc(data2)
        correction = jnp.asarray(correction)
        corr_loc = correction[:, jnp.asarray(s)]
    else:
        data1 = jnp.asarray(data1)
        data2 = jnp.asarray(data2)
        correction = jnp.asarray(correction)
        loc1, loc2, corr_loc = data1, data2, correction

    n1, n2 = loc1.shape[0], loc2.shape[0]
    m1 = np.zeros(n1, dtype=bool)
    m2 = np.zeros(n2, dtype=bool)
    if restrict1 is None:
        m1[:] = True
    else:
        m1[np.asarray(restrict1)] = True
    if restrict2 is None:
        m2[:] = True
    else:
        m2[np.asarray(restrict2)] = True

    if quantile_method not in ("sort", "radix"):
        raise ValueError(f"unknown quantile_method {quantile_method!r}")
    scaling = _adjust(
        loc1, loc2, corr_loc, jnp.asarray(sigma2, loc1.dtype),
        jnp.asarray(m1), jnp.asarray(m2),
        use_radix=quantile_method == "radix",
    )
    scaling = jnp.where(jnp.isfinite(scaling), scaling, 1.0)
    scaling = jnp.maximum(scaling, 1.0)
    return scaling[:, None] * correction
