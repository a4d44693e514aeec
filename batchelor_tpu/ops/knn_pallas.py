"""Two-pass exact kNN: fused score + sub-chunk max, then an exact rescore.

The tiled path in knn.py writes every (query, data) score and merges a
running top-k per data tile. At 100k x 100k with d=50 that is ~40 GB of
scores written and read back per search. This module splits the search:

Pass 1: for each block of queries and data rows, compute the scores
  2 q.x - ||x||^2 and reduce each run of SUB=32 consecutive data rows to its
  max before anything leaves the block. Only the (N_q, N_d/32) sub-chunk-max
  matrix reaches device memory: 1/32 of the score matrix. On the GPU this is
  a Pallas kernel through Triton (``subchunk_max_kernel``); on the CPU the
  same arithmetic runs as plain XLA (``subchunk_max_plain``), which is also
  the kernel's reference.

Pass 2 (XLA): exact selection + fine-grained rescore.
  1. Sub-maxes are maxed in groups of CHUNK/SUB = 4 to get 128-row chunk
     maxima.
  2. Top-k 128-chunks per query: the k-th largest chunk-max is a *lower
     bound* on the k-th best score (the k chunk maxima are themselves k
     distinct scores), so the top-k chunks contain every true top-k
     neighbour.
  3. Within those k chunks' 4k sub-chunks, top-k sub-chunks by sub-max:
     again the k selected sub-maxes are k distinct scores, so the k-th
     largest bounds the k-th best overall from below, and every true
     neighbour's sub-chunk clears it. (``lax.top_k`` returns k distinct
     positions even under ties, which the argument needs.)
  4. Gather the k sub-chunks as whole (32, d) blocks and rescore in fp32.

Exact up to tie-breaking: equal-score neighbours may resolve to different
indices than the tiled path (which is index-stable), and pass-1 candidate
selection carries the error of its precision mode (see ``_split_dot``), so
neighbours within that resolution of the k-th best count as ties. Reported
distances are always full-fp32 rescores.

Masking: invalid data rows get a huge ||x||^2 (score ~ -1e30) in pass 1 and
+inf in the rescore, so restriction masks are free.
"""
from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

__all__ = [
    "query_knn_two_pass", "subchunk_max_kernel", "subchunk_max_plain",
    "pass1_impl", "default_mt_budget",
]

CHUNK = 128          # selection chunk (exactness granularity of step 2)
SUB = 32             # data rows per sub-chunk (gather/rescore granularity)
RATIO = CHUNK // SUB
# query x data rows per kernel block: 64 x 256 was the fastest of five
# shapes at 100k x 100k on an H100 (400 W limit); 128 x 256 and 64 x 512
# were ~4x slower
BQ = 64
BD = 256
RESCORE_TILE = 512   # query rows per rescore block
SINGLE_LEVEL_MAX = 8192   # C32 up to which selection is one flat top-k
MODES = ("split3", "f32", "bf16")


def _bf16_hi(a):
    """fp32 ``a`` rounded to its nearest bf16 value (ties away from zero),
    kept in fp32: a - hi is exact and hi converts to bf16 exactly. Done on
    the bits, not as a bf16 round trip, because XLA:GPU may drop a
    float->bf16->float round trip as excess precision."""
    bits = lax.bitcast_convert_type(a, jnp.uint32)
    bits = (bits + jnp.uint32(0x8000)) & jnp.uint32(0xFFFF0000)
    return lax.bitcast_convert_type(bits, jnp.float32)


def _split_dot(q, x, mode: str):
    """(m, D) . (n, D)^T in fp32 accumulation at the precision ``mode``.

    "split3": three bf16 products of a hand-written hi/lo split
    (hi = bf16(a), lo = bf16(a - hi); a.b ~= hi.hi + hi.lo + lo.hi). Each
    operand keeps ~16 significant bits, so a score carries a relative error
    of ~2^-16 of its magnitude (2|q.x|, ||x||^2). Selection only prunes:
    pass 2 rescores in full fp32, so a deviation needs a true neighbour
    within that resolution of the k-th sub-chunk max. "f32": one IEEE fp32
    product, for raw-scale inputs whose score magnitudes dwarf neighbour
    gaps (query_knn(exact_selection=True)). "bf16": one bf16 product
    (~2^-8 relative), the fast candidate-selection mode.
    """
    dims = (((1,), (1,)), ((), ()))

    def dot(a, b, precision=None):
        return lax.dot_general(a, b, dims, precision=precision,
                               preferred_element_type=jnp.float32)

    if mode == "bf16":
        return dot(q.astype(jnp.bfloat16), x.astype(jnp.bfloat16))
    if mode == "f32":
        return dot(q, x, lax.DotAlgorithmPreset.F32_F32_F32)
    if mode != "split3":
        raise ValueError(f"unknown pass-1 precision mode {mode!r}")
    q_hi, x_hi = _bf16_hi(q), _bf16_hi(x)
    qh, xh = q_hi.astype(jnp.bfloat16), x_hi.astype(jnp.bfloat16)
    ql = (q - q_hi).astype(jnp.bfloat16)
    xl = (x - x_hi).astype(jnp.bfloat16)
    return (dot(qh, xl) + dot(ql, xh)) + dot(qh, xh)


def _subchunk_max(s):
    """(m, n) scores -> (m, n/SUB) max over each run of SUB columns."""
    return jnp.max(s.reshape(s.shape[0], s.shape[1] // SUB, SUB), axis=2)


def _subchunk_max_block(q_ref, x_ref, o_ref, *, mode: str):
    o_ref[...] = 2.0 * _subchunk_max(_split_dot(q_ref[...], x_ref[...], mode))


@functools.partial(jax.jit, static_argnames=("mode", "interpret"))
def subchunk_max_kernel(q, x, mode: str = "split3", interpret: bool = False):
    """(N_q, N_d/SUB) sub-chunk maxima of 2 q.x, as a Pallas-Triton kernel.

    ``q``/``x`` come from ``_fold_query``/``_fold_data``: rows padded to the block, features to a
    power of two, with the data norms folded into two feature columns so
    that 2 q.x is the score 2 q.x - ||x||^2 directly. Each program scores a
    (BQ, BD) block in registers and writes only its (BQ, BD/SUB) maxima.
    """
    nq, dp = q.shape
    nd = x.shape[0]
    return pl.pallas_call(
        functools.partial(_subchunk_max_block, mode=mode),
        grid=(nq // BQ, nd // BD),
        in_specs=[
            pl.BlockSpec((BQ, dp), lambda i, j: (i, 0)),
            pl.BlockSpec((BD, dp), lambda i, j: (j, 0)),
        ],
        out_specs=pl.BlockSpec((BQ, BD // SUB), lambda i, j: (i, j)),
        out_shape=jax.ShapeDtypeStruct((nq, nd // SUB), jnp.float32),
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="knn_subchunk_max",
    )(q, x)


@functools.partial(jax.jit, static_argnames=("mode",))
def subchunk_max_plain(q, x, mode: str = "split3"):
    """Plain-XLA pass 1: the same products as the kernel, then a reshape-max.
    The CPU implementation and the kernel's reference."""
    return 2.0 * _subchunk_max(_split_dot(q, x, mode))


def pass1_impl(platform: str) -> str:
    """Pass-1 implementation for a platform: the kernel on the GPU, plain
    XLA on the CPU. Any other platform is refused rather than guessed."""
    if platform == "gpu":
        return "kernel"
    if platform == "cpu":
        return "plain"
    raise ValueError(f"no two-pass kNN implementation for platform {platform!r}")


def target_platform() -> str:
    """Platform the next computation runs on: the ``jax.default_device``
    in effect, else the default backend."""
    dev = jax.config.jax_default_device
    if dev is None:
        return jax.default_backend()
    return dev if isinstance(dev, str) else dev.platform


def default_mt_budget() -> int:
    """Bytes allowed for one pass-1 buffer: an eighth of the device memory
    JAX may use, or 2 GiB where the device reports none (the CPU)."""
    stats = jax.devices()[0].memory_stats() or {}
    limit = stats.get("bytes_limit")
    return int(limit) // 8 if limit else 2 << 30


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _pad_axis(x, multiple, axis, value=0.0):
    n = x.shape[axis]
    target = _round_up(n, multiple)
    if target == n:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, target - n)
    return jnp.pad(x, widths, constant_values=value)


def _feature_pad(d0: int) -> int:
    """Power-of-two feature width with room for the two folded norm
    columns (Triton blocks are powers of two; 64 covers d <= 62)."""
    return max(64, 1 << (d0 + 1).bit_length())


def _fold_data(data, data_valid, dp: int, mode: str):
    """Rows padded to BD, features to ``dp``; ||x||^2 folded in as two
    feature columns (dn_hi, dn_lo) that the query meets with (-0.5, -0.5),
    so q.x accumulates raw_q.raw_x - dn/2 and no (N, 1) side input exists.
    dn_hi is bf16-exact by construction, so every split mode reproduces it;
    only dn_lo, itself ~2^-8 of dn, is subject to further rounding."""
    acc = jnp.float32
    x = _pad_axis(_pad_axis(data.astype(acc), BD, 0), dp, 1)
    dn = jnp.sum(jnp.square(x), axis=1)
    valid = _pad_axis(data_valid, BD, 0, value=False)
    # finite sentinel, not inf: the hi/lo bf16 split of inf is inf + NaN
    dn = jnp.where(valid, dn, jnp.asarray(1e30, acc))
    dn_hi = _bf16_hi(dn)
    x = x.at[:, dp - 2].set(dn_hi).at[:, dp - 1].set(dn - dn_hi)
    return x.astype(jnp.bfloat16) if mode == "bf16" else x


def _fold_query(query, dp: int, mode: str):
    q = _pad_axis(query.astype(jnp.float32), dp, 1)
    q = q.at[:, dp - 2].set(-0.5).at[:, dp - 1].set(-0.5)
    return q.astype(jnp.bfloat16) if mode == "bf16" else q


def _select_subchunks(m, k: int):
    """Exact selection: (rows, C32) sub-maxes -> (rows, ks) top sub-chunk
    ids (ks = min(k, candidate count)).

    C32 <= SINGLE_LEVEL_MAX: one flat top-k over the sub-maxes (the k
    selected maxima are k distinct true scores, so the k-th bounds the k-th
    best from below). Larger C32: the 128-chunk -> sub-chunk hierarchy,
    whose first top-k runs over a RATIO-fold narrower input."""
    rows, c32 = m.shape
    c128 = c32 // RATIO
    kc = min(k, c128)
    ks = min(k, RATIO * kc)
    if c32 <= SINGLE_LEVEL_MAX:
        return lax.top_k(m, ks)[1]
    m3 = m.reshape(rows, c128, RATIO)
    _, top_chunks = lax.top_k(jnp.max(m3, axis=2), kc)       # (rows, kc)
    sub = jnp.take_along_axis(m3, top_chunks[:, :, None], axis=1)
    sub_ids = (
        top_chunks[:, :, None] * RATIO
        + jnp.arange(RATIO, dtype=jnp.int32)[None, None, :]
    ).reshape(rows, RATIO * kc)
    _, pos = lax.top_k(sub.reshape(rows, RATIO * kc), ks)
    return jnp.take_along_axis(sub_ids, pos, axis=1)


def _chunked_view(data, data_valid, dp: int):
    """Padded data as (C32, SUB, dp) blocks + per-sub-chunk norms."""
    x = _pad_axis(_pad_axis(data.astype(jnp.float32), BD, 0), dp, 1)
    dn = jnp.sum(jnp.square(x), axis=1)
    valid = _pad_axis(data_valid, BD, 0, value=False)
    dn = jnp.where(valid, dn, jnp.inf)
    return x.reshape(-1, SUB, dp), dn.reshape(-1, SUB)


def _rescore_chunks(query, data3, dn2, top_sub, k: int, with_scores: bool):
    """Gather the selected sub-chunks as whole (SUB, dp) blocks and rescore
    in fp32, RESCORE_TILE queries at a time. ``with_scores=False`` skips the
    squared distances, which the MNN membership test never reads."""
    acc = jnp.float32
    nq = query.shape[0]
    dp = data3.shape[2]
    ks = top_sub.shape[1]
    q = _pad_axis(query.astype(acc), dp, 1)
    qn = jnp.sum(jnp.square(q), axis=1)
    ntiles = -(-nq // RESCORE_TILE)
    qt = _pad_axis(q, RESCORE_TILE, 0).reshape(ntiles, RESCORE_TILE, dp)
    ct = _pad_axis(top_sub, RESCORE_TILE, 0).reshape(ntiles, RESCORE_TILE, ks)
    offs = jnp.arange(SUB, dtype=jnp.int32)

    def rescore(args):
        qi, ci = args                               # (T, dp), (T, ks)
        s = 2.0 * jnp.einsum(
            "td,tkcd->tkc", qi, data3[ci], preferred_element_type=acc,
            precision=lax.Precision.HIGHEST,
        ) - dn2[ci]
        s = s.reshape(RESCORE_TILE, ks * SUB)
        cols = (ci[:, :, None] * SUB + offs).reshape(RESCORE_TILE, ks * SUB)
        vals, pos = lax.top_k(s, k)
        return jnp.take_along_axis(cols, pos, axis=1), vals

    idx, vals = lax.map(rescore, (qt, ct))
    idx = idx.reshape(-1, k)[:nq]
    if not with_scores:
        return idx, None
    vals = vals.reshape(-1, k)[:nq]
    return idx, jnp.maximum(qn[:, None] - vals, 0.0)


def piece_rows(nq: int, nd: int, impl: str, mt_budget: int) -> int:
    """Query rows per pass-1 piece so that one piece's pass-1 buffers stay
    under ``mt_budget`` bytes. The kernel writes 4 * N_d / SUB bytes per
    query row; the plain version materialises up to four fp32 score rows
    (three split products and their sum) first."""
    ndp = _round_up(nd, BD)
    row_bytes = 4 * ndp // SUB if impl == "kernel" else 16 * ndp
    rows = max(BQ, (mt_budget // row_bytes) // BQ * BQ)
    npieces = -(-nq // rows)
    return _round_up(-(-nq // npieces), BQ)


@functools.partial(
    jax.jit, static_argnames=("k", "impl", "mode", "qchunk", "with_scores")
)
def _knn_two_pass(query, data, data_valid, k: int, impl: str, mode: str,
                  qchunk: int, with_scores: bool):
    """Pass 1 + selection over equal query pieces of ``qchunk`` rows (one
    pass-1 buffer live at a time, and one piece body in the trace), then
    the rescore."""
    nq, d0 = query.shape
    dp = _feature_pad(d0)
    x = _fold_data(data, data_valid, dp, mode)
    pass1 = subchunk_max_kernel if impl == "kernel" else subchunk_max_plain

    def piece(qp):
        return _select_subchunks(pass1(_fold_query(qp, dp, mode), x, mode), k)

    npieces = -(-nq // qchunk)
    qpad = _pad_axis(query, npieces * qchunk, 0)
    if npieces == 1:
        top = piece(qpad)
    else:
        top = lax.map(piece, qpad.reshape(npieces, qchunk, d0))
        top = top.reshape(npieces * qchunk, -1)
    data3, dn2 = _chunked_view(data, data_valid, dp)
    return _rescore_chunks(query, data3, dn2, top[:nq], k, with_scores)


def query_knn_two_pass(
    query: jnp.ndarray,
    data: jnp.ndarray,
    k: int,
    *,
    n_data_valid: Optional[int] = None,
    data_mask: Optional[jnp.ndarray] = None,
    squared: bool = False,
    bf16: bool = False,
    exact_selection: bool = False,
    indices_only: bool = False,
    mt_budget: Optional[int] = None,
):
    """Exact kNN via the fused sub-chunk-max pass + hierarchical rescore.

    Same contract as knn.query_knn. ``bf16`` selects candidate chunks with
    a bf16 product (recall slightly below 1 near score ties; reported
    distances stay exact fp32). ``exact_selection`` selects with IEEE fp32
    products instead of the 3-product bf16 split. ``mt_budget`` bounds one
    pass-1 buffer in bytes (default: ``default_mt_budget()``); queries are
    processed in pieces to stay under it.
    """
    from .knn import KNNResult

    query = jnp.asarray(query)
    data = jnp.asarray(data)
    nd = data.shape[0]
    if data_mask is not None:
        valid = jnp.asarray(data_mask, dtype=bool)
    elif n_data_valid is not None:
        valid = jnp.arange(nd) < n_data_valid
    else:
        valid = jnp.ones((nd,), dtype=bool)
    impl = pass1_impl(target_platform())
    mode = "bf16" if bf16 else ("f32" if exact_selection else "split3")
    budget = default_mt_budget() if mt_budget is None else int(mt_budget)
    qchunk = piece_rows(query.shape[0], nd, impl, budget)
    idx, sq = _knn_two_pass(query, data, valid, k, impl, mode, qchunk,
                            not indices_only)
    if indices_only:
        return KNNResult(idx, None)
    dist = sq if squared else jnp.sqrt(sq)
    return KNNResult(idx, dist)
