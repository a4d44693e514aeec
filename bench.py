"""Benchmark harness for batchelor_tpu on one device.

Prints ONE JSON line: {"metric", "value", "unit"}.

Configs (BENCH_CONFIG env, default 1):
  1  HEADLINE: two-batch fastMNN merge at SCALE — 2 x 100k cells (override
     with BENCH_CELLS), d=50, k=20, driven through the verified host engine
     (reduced_mnn) end-to-end including MNN pair-list collection, with the
     production "auto" kNN dispatch.
  2  classic mnnCorrect in gene space, 2k genes, 2 batches
  3  multiBatchPCA + hierarchical 4-batch merge tree with restrict + prop.k
  4  clusterMNN on an 8-batch atlas (BENCH_CELLS per batch)
  6  two-batch fastMNN from gene space through the fused merge step,
     2 x 5k cells, 2000 genes

The reference publishes no numbers (BASELINE.md). Each run is one process
on one device; run configs one after another, never side by side, since a
second JAX process on the same card fails for want of memory and two that
compute at once spoil each other's times. Timing waits for a device-side
scalar and keeps the best of BENCH_REPEATS runs after one warm-up call.
"""
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

CONFIG = int(os.environ.get("BENCH_CONFIG", 1))
_DEFAULT_CELLS = 100_000 if CONFIG == 1 else 5000
N_PER_BATCH = int(os.environ.get("BENCH_CELLS", _DEFAULT_CELLS))
N_GENES = int(os.environ.get("BENCH_GENES", 2000))
D = 50
K = 20
REPEATS = int(os.environ.get("BENCH_REPEATS", 5))


def _simulate(rng, n, g, shift=0.0, n_types=4, noise=0.5):
    means = rng.normal(size=(n_types, g)).astype(np.float32)
    assign = rng.integers(0, n_types, n)
    x = means[assign] + rng.normal(size=(n, g)).astype(np.float32) * noise
    if shift:
        x = x + (rng.normal(size=(1, g)) * shift).astype(np.float32)
    return x.astype(np.float32), assign


def _time(fn, *args):
    import jax.numpy as jnp

    _ = float(fn(*args))  # warmup/compile
    best = float("inf")
    for _i in range(REPEATS):
        t0 = time.perf_counter()
        _ = float(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def bench_fastmnn(n, genes, knn_method="exact"):
    import jax
    import jax.numpy as jnp

    from batchelor_tpu.correct.fused import fused_merge_step
    from batchelor_tpu.ops.cosine_norm import apply_cosine_norm, l2_norms
    from batchelor_tpu.ops.pca import multi_batch_pca

    rng = np.random.default_rng(42)
    b1, _ = _simulate(rng, n, genes)
    b2, _ = _simulate(rng, n, genes, shift=0.8)
    db1 = jax.device_put(jnp.asarray(b1))
    db2 = jax.device_put(jnp.asarray(b2))

    @jax.jit
    def pipeline(x1, x2):
        n1 = apply_cosine_norm(x1, l2_norms(x1))
        n2 = apply_cosine_norm(x2, l2_norms(x2))
        pca = multi_batch_pca([n1, n2], d=D, method="randomized")
        out = fused_merge_step(
            pca.components[0], pca.components[1], K, K, knn_method=knn_method
        )
        return jnp.sum(out.right) + out.n_pairs.astype(jnp.float32)

    elapsed = _time(pipeline, db1, db2)
    return 2 * n / elapsed, f"cells/s/chip (2x{n} cells, {genes} genes, d={D}, k={K})"


def bench_reduced_scale(n, knn_method="auto"):
    """The verified host engine (reduced_mnn) on 2 x n cells of d=50
    coordinates: full merge incl. orthogonalization, lost-var diagnostics
    and pair-list collection to the host. The same code path every parity
    test verifies."""
    import jax
    import jax.numpy as jnp

    from batchelor_tpu import reduced_mnn

    rng = np.random.default_rng(42)
    b1, _ = _simulate(rng, n, D)
    b2, _ = _simulate(rng, n, D, shift=0.8)
    db1 = jax.device_put(jnp.asarray(b1))
    db2 = jax.device_put(jnp.asarray(b2))

    def run():
        res = reduced_mnn([db1, db2], k=K, knn_method=knn_method)
        return float(jnp.sum(res.corrected)) + res.merge_info[0].pairs.shape[0]

    _ = run()  # warmup/compile
    best = float("inf")
    for _i in range(REPEATS):
        t0 = time.perf_counter()
        _ = run()
        best = min(best, time.perf_counter() - t0)
    return 2 * n / best, (
        f"cells/s/chip (host-engine reduced_mnn, 2x{n} cells, d={D}, k={K}, "
        f"knn={knn_method})"
    )


def bench_classic():
    import jax
    import jax.numpy as jnp

    from batchelor_tpu import mnn_correct

    rng = np.random.default_rng(42)
    n = min(N_PER_BATCH, 2000)  # quadratic kernels; keep the config honest
    b1, _ = _simulate(rng, n, N_GENES)
    b2, _ = _simulate(rng, n, N_GENES, shift=0.8)
    m1 = jnp.asarray(np.log1p(np.abs(b1)))
    m2 = jnp.asarray(np.log1p(np.abs(b2)))

    def run():
        res = mnn_correct([m1, m2], sigma=0.1, var_adj=True)
        return float(jnp.sum(res.corrected))

    _ = run()
    best = float("inf")
    for _i in range(max(REPEATS // 2, 1)):
        t0 = time.perf_counter()
        _ = run()
        best = min(best, time.perf_counter() - t0)
    return 2 * n / best, f"cells/s/chip (classic mnnCorrect, 2x{n} cells, {N_GENES} genes)"


def bench_pca_tree():
    import jax.numpy as jnp

    from batchelor_tpu import fast_mnn

    rng = np.random.default_rng(42)
    n = N_PER_BATCH
    mats = [jnp.asarray(_simulate(rng, n, N_GENES, shift=0.3 * i)[0]) for i in range(4)]
    restrict = [np.arange(0, n, 2), None, None, np.arange(0, n, 3)]

    def run():
        res = fast_mnn(
            mats, d=D, prop_k=0.005, merge_order=[[0, 1], [2, 3]],
            restrict=restrict, svd_method="randomized",
        )
        return float(jnp.sum(res.corrected))

    _ = run()
    best = float("inf")
    for _i in range(max(REPEATS // 2, 1)):
        t0 = time.perf_counter()
        _ = run()
        best = min(best, time.perf_counter() - t0)
    return 4 * n / best, f"cells/s/chip (4-batch tree merge + restrict + prop.k, 4x{n} cells)"


def bench_cluster():
    import jax.numpy as jnp

    from batchelor_tpu import cluster_mnn

    rng = np.random.default_rng(42)
    n = N_PER_BATCH
    mats, clusters = [], []
    for i in range(8):
        x, assign = _simulate(rng, n, min(N_GENES, 500), shift=0.3 * i)
        mats.append(jnp.asarray(np.log1p(np.abs(x))))
        clusters.append(assign)

    def run():
        res = cluster_mnn(mats, clusters=clusters)
        return float(jnp.sum(res.corrected))

    _ = run()
    best = float("inf")
    for _i in range(max(REPEATS // 2, 1)):
        t0 = time.perf_counter()
        _ = run()
        best = min(best, time.perf_counter() - t0)
    return 8 * n / best, f"cells/s/chip (clusterMNN, 8x{n} cells)"


def main():
    from batchelor_tpu.utils.cache import use_compile_cache

    use_compile_cache()
    if CONFIG == 1:
        value, unit = bench_reduced_scale(N_PER_BATCH)
        metric = "fastmnn_scale_cells_per_sec_per_chip"
    elif CONFIG == 6:
        value, unit = bench_fastmnn(N_PER_BATCH, N_GENES)
        metric = "fastmnn_cells_per_sec_per_chip"
    elif CONFIG == 2:
        value, unit = bench_classic()
        metric = "mnncorrect_cells_per_sec_per_chip"
    elif CONFIG == 3:
        value, unit = bench_pca_tree()
        metric = "fastmnn_tree_cells_per_sec_per_chip"
    elif CONFIG == 4:
        value, unit = bench_cluster()
        metric = "clustermnn_cells_per_sec_per_chip"
    else:
        raise SystemExit(f"unknown BENCH_CONFIG={CONFIG}")
    print(
        json.dumps(
            {
                "metric": metric,
                "value": round(value, 1),
                "unit": unit,
            }
        )
    )


if __name__ == "__main__":
    main()
