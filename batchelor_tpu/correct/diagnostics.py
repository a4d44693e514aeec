"""Diagnostics: mnnDeltaVariance and cluster-abundance checks.

Rebuilds of the reference's diagnostic layer
(R/mnnDeltaVariance.R:95-201, R/diagnostics-cluster.R:57-83).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.cosine_norm import apply_cosine_norm, cosine_norm

__all__ = [
    "fit_trend_var",
    "mnn_delta_variance",
    "mnn_delta_variance_blocked",
    "cluster_abundance_test",
    "cluster_abundance_var",
    "MnnDeltaVarianceResult",
]


def _fit_parametric_curve(x: np.ndarray, y: np.ndarray):
    """Least-squares fit of y ~ a*x / (x^n + b) in log space.

    The parametric component of scran::fitTrendVar (its parametric=TRUE
    default): the curve captures the Poisson-driven rise and saturation of
    log-expression variance against the mean. Fit by a coarse (n, b) grid
    with closed-form ``a`` per point, then one refinement pass around the
    winner. Returns (curve callable, sse) or None when unfittable.
    """
    if x.size < 4:
        return None
    lx, ly = np.log(x), np.log(y)
    med = float(np.median(x))

    def solve(n_grid, b_grid):
        best = None
        for n_ in n_grid:
            xn = np.power(x, n_)
            for b_ in b_grid:
                pen = np.log(xn + b_)
                la = np.mean(ly - lx + pen)
                sse = float(np.sum((ly - (la + lx - pen)) ** 2))
                if best is None or sse < best[0]:
                    best = (sse, float(np.exp(la)), b_, n_)
        return best

    n_grid = np.linspace(0.5, 4.0, 15)
    b_grid = (med ** n_grid.mean()) * np.exp(np.linspace(-7.0, 7.0, 29))
    sse, a, b, n_ = solve(n_grid, b_grid)
    n_grid2 = np.linspace(max(n_ - 0.3, 0.1), n_ + 0.3, 9)
    b_grid2 = b * np.exp(np.linspace(-0.7, 0.7, 9))
    sse, a, b, n_ = solve(n_grid2, b_grid2)
    if not np.isfinite(sse):
        return None

    def curve(q):
        q = np.asarray(q, dtype=np.float64)
        qq = np.maximum(q, 0.0)
        return a * qq / (np.power(qq, n_) + b)

    return curve


def fit_trend_var(
    means: np.ndarray,
    variances: np.ndarray,
    span: float = 0.3,
    parametric: bool = True,
) -> Callable[[np.ndarray], np.ndarray]:
    """Mean-variance trend fit (scran::fitTrendVar equivalent).

    The reference delegates to scran's trend (R/mnnDeltaVariance.R:158),
    whose default is a parametric curve y = a*x/(x^n + b) fit by nls,
    multiplied by a loess smooth of the log-ratio residuals. Here:
    the same parametric curve (log-space grid+refine least squares), then a
    tricube-weighted local linear regression (loess degree 1) on the
    log-ratio. ``parametric=False`` falls back to smoothing the raw
    (mean, variance) pairs directly.
    """
    means = np.asarray(means, dtype=np.float64)
    variances = np.asarray(variances, dtype=np.float64)
    ok = np.isfinite(means) & np.isfinite(variances)
    x, y = means[ok], variances[ok]
    if x.size < 2:
        const = float(np.nanmean(y)) if y.size else 0.0
        return lambda q: np.full(np.asarray(q).shape, const)

    curve = None
    if parametric:
        pos = (x > 0) & (y > 0)
        if pos.sum() >= 4:
            curve = _fit_parametric_curve(x[pos], y[pos])
    if curve is not None:
        # smooth the log-ratio residuals, like scran's loess on the ratio
        pos = (x > 0) & (y > 0)
        ratio_trend = fit_trend_var(
            x[pos], np.log(y[pos] / curve(x[pos])), span=span,
            parametric=False,
        )

        def trend_parametric(q):
            q = np.atleast_1d(np.asarray(q, dtype=np.float64))
            out = curve(q) * np.exp(ratio_trend(q))
            return np.maximum(np.where(np.isfinite(out), out, 0.0), 0.0)

        return trend_parametric

    order = np.argsort(x)
    xs, ys = x[order], y[order]
    n = xs.size
    window = max(int(np.ceil(span * n)), 2)

    def trend(q):
        """Tricube-weighted local linear fit, vectorized over query points
        in chunks (the windowed gather is (chunk, window); 30k genes at
        span 0.3 stays ~40 MB instead of a 30k-iteration Python loop)."""
        q = np.atleast_1d(np.asarray(q, dtype=np.float64))
        out = np.empty(q.shape)
        step = max(1, (1 << 22) // max(window, 1))
        offs = np.arange(window)
        for c0 in range(0, q.size, step):
            qi = q[c0 : c0 + step]                       # (C,)
            pos = np.searchsorted(xs, qi)
            lo = np.clip(pos - window // 2, 0, n - window)
            idx = lo[:, None] + offs                     # (C, W)
            xw, yw = xs[idx], ys[idx]
            dist = np.abs(xw - qi[:, None])
            h = np.maximum(dist.max(axis=1, keepdims=True), 1e-12)
            w = (1 - np.minimum(dist / h, 1.0) ** 3) ** 3
            sw = w.sum(axis=1)
            sw_safe = np.maximum(sw, 1e-300)
            xm = (w * xw).sum(axis=1) / sw_safe
            ym = (w * yw).sum(axis=1) / sw_safe
            dx = xw - xm[:, None]
            den = (w * dx**2).sum(axis=1)
            num = (w * dx * (yw - ym[:, None])).sum(axis=1)
            slope = np.where(den > 1e-12, num / np.maximum(den, 1e-12), 0.0)
            fit = ym + slope * (qi - xm)
            out[c0 : c0 + step] = np.where(sw > 0, fit, yw.mean(axis=1))
        return np.maximum(out, 0.0)

    return trend


@dataclass
class MnnDeltaVarianceResult:
    """Per-gene delta-variance table (reference mnnDeltaVariance output).

    mean/total/trend/adjusted: combined (pair-count-weighted) across steps;
    per_step: list of per-merge-step dicts with the same fields.
    """

    mean: np.ndarray
    total: np.ndarray
    trend: np.ndarray
    adjusted: np.ndarray
    per_step: List[dict]


def mnn_delta_variance(
    batches: Sequence[jnp.ndarray],
    pairs: Sequence[np.ndarray],
    *,
    cos_norm: bool = False,
    subset_row: Optional[np.ndarray] = None,
    compute_all: bool = False,
    trend_span: float = 0.3,
) -> MnnDeltaVarianceResult:
    """Variance of per-gene differences across MNN pairs, trend-adjusted.

    ``batches``: per-batch (N_b, G) matrices, concatenated in input order to
    interpret the 0-based pair indices (as produced by fast_mnn merge_info).
    ``pairs``: list of (P, 2) arrays, one per merge step.
    Mirrors mnnDeltaVariance (reference R/mnnDeltaVariance.R:95-201); the
    trend uses :func:`fit_trend_var`.
    """
    mats = [jnp.asarray(b) for b in batches]
    if cos_norm:
        l2 = [cosine_norm(m, mode="l2norm", subset_row=subset_row) for m in mats]
        ml2 = float(np.mean([float(jnp.mean(v)) for v in l2]))
        mats = [apply_cosine_norm(m, v / ml2) for m, v in zip(mats, l2)]
    x = jnp.concatenate(mats, axis=0)
    if subset_row is not None and not compute_all:
        x = x[:, jnp.asarray(np.asarray(subset_row))]
        subset_row = None

    per_step = []
    npairs = []
    for p in pairs:
        p = np.asarray(p)
        b1 = x[jnp.asarray(p[:, 0])]
        b2 = x[jnp.asarray(p[:, 1])]
        delta = b1 - b2
        n = p.shape[0]
        var = (
            np.asarray(jnp.var(delta, axis=0, ddof=1))
            if n >= 2
            else np.full(x.shape[1], np.nan)
        )
        mean = np.asarray((jnp.mean(b1, axis=0) + jnp.mean(b2, axis=0)) / 2)
        sel_mean, sel_var = mean, var
        if subset_row is not None:
            s = np.asarray(subset_row)
            sel_mean, sel_var = mean[s], var[s]
        trend_fn = fit_trend_var(sel_mean, sel_var, span=trend_span)
        trend = trend_fn(mean)
        per_step.append(
            {"mean": mean, "total": var, "trend": trend, "adjusted": var - trend}
        )
        npairs.append(n)

    return _combine_steps(per_step, npairs)


def _combine_steps(per_step, npairs) -> MnnDeltaVarianceResult:
    # combine across steps, weighting by RAW pair count, steps with >=2
    # pairs: the reference passes weights=npairs / valid=npairs>=2L
    # explicitly to scran::combineBlocks (R/mnnDeltaVariance.R:168-173),
    # overriding combineBlocks' default d.f. weighting — so raw counts ARE
    # the parity behavior, not a deviation.
    w = np.asarray(npairs, dtype=np.float64)
    valid = w >= 2
    if not valid.any():
        raise ValueError("no merge step has >= 2 MNN pairs")
    wv = w * valid
    wv = wv / wv.sum()

    def comb(field):
        return sum(wi * ps[field] for wi, ps in zip(wv, per_step))

    return MnnDeltaVarianceResult(
        mean=comb("mean"),
        total=comb("total"),
        trend=comb("trend"),
        adjusted=comb("adjusted"),
        per_step=per_step,
    )


@jax.jit
def _chunk_moments(a, b, valid):
    """Per-gene partial sums for one pair chunk: (sum a, sum b, sum delta,
    sum delta^2), pad rows masked."""
    m = valid[:, None]
    a = jnp.where(m, a, 0.0)
    b = jnp.where(m, b, 0.0)
    d = a - b
    return (
        jnp.sum(a, axis=0),
        jnp.sum(b, axis=0),
        jnp.sum(d, axis=0),
        jnp.sum(jnp.square(d), axis=0),
    )


def mnn_delta_variance_blocked(
    batches: Sequence,
    pairs: Sequence[np.ndarray],
    *,
    cos_norm: bool = False,
    subset_row: Optional[np.ndarray] = None,
    compute_all: bool = False,
    trend_span: float = 0.3,
    chunk_pairs: int = 2048,
    device=None,
) -> MnnDeltaVarianceResult:
    """Block-processed mnn_delta_variance for host-resident batches.

    ``batches``: per-batch host numpy arrays OR CSRCells stores (cells in
    rows) — nothing densifies beyond one (chunk_pairs, G) block, so the
    full-gene-space diagnostic runs at atlas scale (the reference streams
    the same computation over row blocks via blockApply,
    R/mnnDeltaVariance.R:145). Matches :func:`mnn_delta_variance` on dense
    inputs: per-step variances are accumulated as fp64 moment sums over
    device-reduced pair chunks.

    ``device``: optional ``jax.Device`` the chunk reductions are committed
    to (e.g. ``jax.local_devices(backend="cpu")[0]``). The reduction is
    memory-bound, so when host→accelerator transfer is the bottleneck the
    host CPU backend is the faster substrate.
    """
    from ..io.csr import CSRCells

    sizes = []
    for b in batches:
        sizes.append(b.n_cells if isinstance(b, CSRCells) else b.shape[0])
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    g = (
        batches[0].n_genes
        if isinstance(batches[0], CSRCells)
        else batches[0].shape[1]
    )

    # cosine-norm row scales (reference R/mnnDeltaVariance.R:137-143 via
    # cosineNorm; the dense path scales by l2 / mean-of-batch-mean-l2)
    row_scale = None
    if cos_norm:
        sub = None if subset_row is None else np.asarray(subset_row)
        l2s = []
        for b in batches:
            if isinstance(b, CSRCells):
                s = b if sub is None else b.select_genes(sub)
                sq = np.zeros(s.n_cells, np.float64)
                counts = np.diff(s.indptr)
                nz = counts > 0
                if nz.any():
                    sq[nz] = np.add.reduceat(
                        s.data.astype(np.float64) ** 2, s.indptr[:-1][nz]
                    )
                l2s.append(np.sqrt(sq))
            else:
                x = np.asarray(b, dtype=np.float64)
                if sub is not None:
                    x = x[:, sub]
                l2s.append(np.sqrt(np.sum(x * x, axis=1)))
        ml2 = float(np.mean([v.mean() for v in l2s]))
        row_scale = np.concatenate(
            [ml2 / np.maximum(v, 1e-8) for v in l2s]
        ).astype(np.float32)

    keep = None
    if subset_row is not None and not compute_all:
        keep = np.asarray(subset_row)
        g_out = keep.size
        subset_after = None
    else:
        g_out = g
        subset_after = None if subset_row is None else np.asarray(subset_row)

    def gather(rows: np.ndarray) -> np.ndarray:
        """(len(rows), g_out) float32 rows of the virtual concat."""
        out = np.empty((rows.size, g_out), np.float32)
        which = np.searchsorted(offsets, rows, side="right") - 1
        for bi in np.unique(which):
            sel = np.nonzero(which == bi)[0]
            local = rows[sel] - offsets[bi]
            b = batches[bi]
            if isinstance(b, CSRCells):
                dense = b.select_cells(local).to_dense()
            else:
                dense = np.asarray(b)[local]
            if keep is not None:
                dense = dense[:, keep]
            out[sel] = dense
        if row_scale is not None:
            out *= row_scale[rows][:, None]
        return out

    per_step, npairs = [], []
    for p in pairs:
        p = np.asarray(p)
        n = p.shape[0]
        s1 = np.zeros(g_out, np.float64)
        s2 = np.zeros(g_out, np.float64)
        sd = np.zeros(g_out, np.float64)
        sdd = np.zeros(g_out, np.float64)
        for lo in range(0, n, chunk_pairs):
            hi = min(lo + chunk_pairs, n)
            c = hi - lo
            a = gather(p[lo:hi, 0])
            b = gather(p[lo:hi, 1])
            if c < chunk_pairs:  # pad for a single compiled chunk shape
                pad = chunk_pairs - c
                a = np.vstack([a, np.zeros((pad, g_out), np.float32)])
                b = np.vstack([b, np.zeros((pad, g_out), np.float32)])
            if device is not None:
                a = jax.device_put(a, device)
                b = jax.device_put(b, device)
                valid = jax.device_put(np.arange(chunk_pairs) < c, device)
            else:
                valid = jnp.arange(chunk_pairs) < c
            ca, cb, cd, cdd = _chunk_moments(
                jnp.asarray(a), jnp.asarray(b), valid
            )
            s1 += np.asarray(ca, np.float64)
            s2 += np.asarray(cb, np.float64)
            sd += np.asarray(cd, np.float64)
            sdd += np.asarray(cdd, np.float64)
        mean = (s1 / n + s2 / n) / 2.0
        if n >= 2:
            var = np.maximum(sdd - n * (sd / n) ** 2, 0.0) / (n - 1)
        else:
            var = np.full(g_out, np.nan)
        sel_mean, sel_var = mean, var
        if subset_after is not None:
            sel_mean, sel_var = mean[subset_after], var[subset_after]
        trend_fn = fit_trend_var(sel_mean, sel_var, span=trend_span)
        trend = trend_fn(mean)
        per_step.append(
            {"mean": mean, "total": var, "trend": trend, "adjusted": var - trend}
        )
        npairs.append(n)

    return _combine_steps(per_step, npairs)


def _abundance_table(x, batch=None) -> np.ndarray:
    """Cluster-by-batch contingency table (reference ._create_abundance_table)."""
    if batch is None:
        return np.asarray(x, dtype=np.float64)
    x = np.asarray(x)
    batch = np.asarray(batch)
    rows = sorted(set(x.tolist()))
    cols = sorted(set(batch.tolist()))
    tab = np.zeros((len(rows), len(cols)))
    ri = {v: i for i, v in enumerate(rows)}
    ci = {v: i for i, v in enumerate(cols)}
    for a, b in zip(x.tolist(), batch.tolist()):
        tab[ri[a], ci[b]] += 1
    return tab


def cluster_abundance_test(x, batch=None) -> np.ndarray:
    """Chi-squared test of within-cluster batch abundances against overall
    batch proportions; one p-value per cluster
    (reference clusterAbundanceTest, R/diagnostics-cluster.R:57-63)."""
    import jax.scipy.special as jss

    tab = _abundance_table(x, batch)
    props = tab.sum(axis=0) / tab.sum()
    out = np.empty(tab.shape[0])
    df = tab.shape[1] - 1
    for i, row in enumerate(tab):
        exp = row.sum() * props
        stat = float(np.sum((row - exp) ** 2 / exp))
        out[i] = float(jss.gammaincc(df / 2.0, stat / 2.0))
    return out


def cluster_abundance_var(x, batch=None, pseudo_count: float = 10.0) -> np.ndarray:
    """Variance of log-normalized abundances across batches per cluster
    (reference clusterAbundanceVar, R/diagnostics-cluster.R:73-83)."""
    tab = _abundance_table(x, batch)
    libs = tab.sum(axis=0)
    sf = libs / libs.mean()
    norm = np.log2(tab / sf[None, :] + pseudo_count)
    return norm.var(axis=1, ddof=1)
