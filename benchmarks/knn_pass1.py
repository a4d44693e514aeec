"""Pass 1 of the two-pass kNN on the GPU: the Pallas-Triton kernel against
the plain-XLA version, alone, inside the whole search, and end to end.

    python benchmarks/knn_pass1.py

Prints the card's name and power limit, then for d=50, k=20:
  * pass 1 alone and the whole "chunked" search at 100k x 100k (bench.py
    config 1's shape) and 1M x 1M, with each implementation;
  * chip_smoke.py phase (b) (reduced_mnn on 2 x 100k cells of 50 PCs, MNN
    pairs fetched) with each implementation.
Each time is the median of three calls after a compiling one (one call at
1M x 1M); at 100k and in phase (b) the two implementations run in the order
kernel, plain, plain, kernel so that both see the same card state.
"""
import functools
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

from batchelor_tpu.ops import knn_pallas as kp  # noqa: E402
from batchelor_tpu.utils.cache import use_compile_cache  # noqa: E402

K = 20
D = 50
IMPLS = ("kernel", "plain")


def median_time(fn, reps=3):
    jax.block_until_ready(fn())
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


@functools.partial(jax.jit, static_argnames=("impl", "qchunk"))
def pass1_only(query, data, impl: str, qchunk: int):
    """Pass 1 over equal query pieces, as _knn_two_pass runs it; each
    piece's maxima are reduced to one per row, as the selection would."""
    dp = kp._feature_pad(query.shape[1])
    x = kp._fold_data(data, jnp.ones((data.shape[0],), bool), dp, "split3")
    fn = kp.subchunk_max_kernel if impl == "kernel" else kp.subchunk_max_plain
    npieces = -(-query.shape[0] // qchunk)
    q = kp._pad_axis(query, npieces * qchunk, 0)
    return lax.map(
        lambda qp: jnp.max(fn(kp._fold_query(qp, dp, "split3"), x), axis=1),
        q.reshape(npieces, qchunk, -1))


def search(query, data, impl):
    qchunk = kp.piece_rows(query.shape[0], data.shape[0], impl,
                           kp.default_mt_budget())
    valid = jnp.ones((data.shape[0],), bool)
    return kp._knn_two_pass(query, data, valid, K, impl, "split3", qchunk,
                            True)


def main():
    if jax.default_backend() != "gpu":
        print("knn_pass1: JAX found no GPU", file=sys.stderr)
        return 2
    use_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    for n in (100_000, 1_000_000):
        kq, kd = jax.random.split(jax.random.key(n))
        query = jax.random.normal(kq, (n, D))
        data = jax.random.normal(kd, (n, D))
        big = n > 100_000
        for impl in IMPLS if big else IMPLS + IMPLS[::-1]:
            qchunk = kp.piece_rows(n, n, impl, kp.default_mt_budget())
            reps = 1 if big else 3
            t1 = median_time(lambda: pass1_only(query, data, impl, qchunk),
                             reps)
            t2 = median_time(lambda: search(query, data, impl), reps)
            print(f"{n} x {n}: {impl}: pass 1 {t1 * 1e3:.1f} ms, whole "
                  f"search {t2 * 1e3:.1f} ms", flush=True)
        del query, data

    sys.path.insert(0, os.path.join(HERE, "tests"))
    import batchelor_tpu as bt
    from chip_smoke import SEED, pc_batches

    b1, b2 = pc_batches(SEED + 2, (100_000, 100_000))

    def phase_b():
        res = bt.reduced_mnn([b1, b2], k=K, knn_method="auto")
        return res.corrected, res.merge_info[0].pairs

    chosen = kp.pass1_impl
    try:
        for impl in IMPLS + IMPLS[::-1]:
            kp.pass1_impl = lambda platform, impl=impl: impl
            t = median_time(phase_b)
            print(f"phase (b) 2 x 100000 reduced_mnn with pairs: {impl}: "
                  f"{t:.3f} s", flush=True)
    finally:
        kp.pass1_impl = chosen
    return 0


if __name__ == "__main__":
    sys.exit(main())
