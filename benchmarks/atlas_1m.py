"""1M-cell atlas demonstration: 8 batches x 125k cells on one chip.

Single-chip scale demo for BASELINE config 4: distributed_fast_mnn on a
1-device mesh with shape-bucketed padding (compile reuse across the 7 merge
steps). Prints per-step diagnostics, one machine-readable JSON line per
stage (bench.py style), and the end-to-end wall time.

Usage: python benchmarks/atlas_1m.py [knn_method] [cells_per_batch] [flags...]
(defaults: auto, 125000). Flags (any order after the first two args):
  diag        run the full BASELINE config-4 workload: merge with pair
              collection, out-of-core clusterMNN over a G-gene CSR
              expression space (cluster_mnn_csr), then block-processed
              mnnDeltaVariance over the collected pairs;
  ring        memory="ring" merge steps (constant per-device memory; the
              >HBM regime fallback) instead of the default gather mode,
              for a gather-vs-ring comparison at one shape;
  checkpoint  per-merge-step checkpointing (streamed node records,
              io/checkpoint.py), to compare against the uncheckpointed
              run.
Timing waits for a device-side scalar.
"""
import json
import sys
import time

import numpy as np

sys.path.insert(0, ".")

import jax

jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)

from batchelor_tpu.utils.cache import use_compile_cache  # noqa: E402

use_compile_cache()

import jax.numpy as jnp

from batchelor_tpu.parallel.driver import distributed_fast_mnn
from batchelor_tpu.parallel.mesh import make_cells_mesh

STAGES = []


def emit(metric: str, value: float, unit: str, **extra):
    line = {"metric": metric, "value": round(float(value), 3), "unit": unit}
    line.update(extra)
    STAGES.append(line)
    print(json.dumps(line), flush=True)


def main():
    method = sys.argv[1] if len(sys.argv) > 1 else "auto"
    n = int(sys.argv[2]) if len(sys.argv) > 2 else 125_000
    flags = set(sys.argv[3:])
    diag = "diag" in flags
    memory = "ring" if "ring" in flags else "gather"
    ckpt_dir = None
    if "checkpoint" in flags:
        import shutil
        import tempfile

        ckpt_dir = tempfile.mkdtemp(prefix="atlas1m_ckpt_")
    nb = 8
    d = 50
    rng = np.random.default_rng(0)
    print(f"backend={jax.default_backend()} {nb}x{n} cells, d={d}, "
          f"knn_method={method} diagnostics={diag} memory={memory} "
          f"checkpoint={ckpt_dir is not None}", flush=True)

    # clustered toy atlas: shared cell types + per-batch shift
    means = rng.normal(size=(10, d)).astype(np.float32) * 2.0
    batches, assigns = [], []
    for b in range(nb):
        assign = rng.integers(0, 10, n)
        x = means[assign] + rng.normal(size=(n, d)).astype(np.float32) * 0.6
        x += rng.normal(size=(1, d)).astype(np.float32) * 0.5
        batches.append(jnp.asarray(x))
        assigns.append(assign)

    mesh = make_cells_mesh(1)
    t0 = time.perf_counter()
    res = distributed_fast_mnn(
        batches, mesh, k=20, knn_method=method, pad_buckets=True,
        collect_pairs=diag, progress=True, memory=memory,
        checkpoint_dir=ckpt_dir,
    )
    # force: device-side scalar
    _ = float(jnp.sum(jnp.asarray(res.corrected[:1, :1])))
    elapsed = time.perf_counter() - t0
    for i, info in enumerate(res.merge_info):
        print(f"step {i}: left={info.left} right={info.right} "
              f"batch_size={info.batch_size:.3f} skipped={info.skipped}",
              flush=True)
    total = nb * n
    suffix = "" if memory == "gather" else f"_{memory}"
    if ckpt_dir is not None:
        suffix += "_ckpt"
    emit(f"atlas1m_merge{suffix}", elapsed, "s", cells=total,
         knn_method=method)
    emit(f"atlas1m_merge_throughput{suffix}", total / elapsed / 1e3,
         "kcells/s/chip")
    if ckpt_dir is not None:
        import shutil

        resumed = distributed_fast_mnn(
            batches, mesh, k=20, knn_method=method, pad_buckets=True,
            collect_pairs=diag, progress=False, memory=memory,
            checkpoint_dir=ckpt_dir,
        )
        bit = bool(np.array_equal(np.asarray(resumed.corrected),
                                  np.asarray(res.corrected)))
        emit("atlas1m_resume_bit_identical", 1.0 if bit else 0.0, "bool")
        shutil.rmtree(ckpt_dir, ignore_errors=True)

    if diag:
        _diagnostics(rng, assigns, res, n, nb)
    out = {"metric": "atlas1m_total", "value": round(
        sum(s["value"] for s in STAGES if s["unit"] == "s"), 3), "unit": "s",
        "stages": STAGES}
    print(json.dumps(out), flush=True)


def _diagnostics(rng, assigns, res, n, nb):
    """BASELINE config 4: clusterMNN + blocked mnnDeltaVariance at 1M cells.

    The expression space is a sparse G-gene view of the same cell types
    (~10% density CSR stores, the realistic single-cell regime); clusterMNN
    runs fully out-of-core (cluster_mnn_csr), mnnDeltaVariance streams the
    stores in pair chunks.
    """
    from batchelor_tpu.correct.cluster_mnn import cluster_mnn_csr
    from batchelor_tpu.correct.diagnostics import mnn_delta_variance_blocked
    from batchelor_tpu.io.csr import CSRCells

    g = 1000
    density = 0.10
    gmeans = rng.normal(size=(10, g)).astype(np.float32) * 1.5
    stores = []
    t0 = time.perf_counter()
    for b in range(nb):
        x = gmeans[assigns[b]] + rng.normal(size=(n, g)).astype(np.float32) * 0.4
        x += rng.normal(size=(1, g)).astype(np.float32) * 0.3
        np.maximum(x, 0.0, out=x)
        x *= rng.random(size=(n, g)) < density      # sparse single-cell view
        stores.append(CSRCells.from_dense(x))
        del x
    nnz = sum(int(s.data.shape[0]) for s in stores)
    print(f"gene space: {nb}x{n} x {g} genes, {nnz/1e6:.0f}M nnz CSR "
          f"({nnz * 8 / 2**30:.2f} GiB host; generated in "
          f"{time.perf_counter() - t0:.0f} s)", flush=True)

    t0 = time.perf_counter()
    cm = cluster_mnn_csr(
        stores,
        clusters=[a for a in assigns],
        cos_norm=True,
        block_rows=32768,
    )
    _ = float(jnp.sum(jnp.asarray(cm.corrected[:1, :1])))
    elapsed = time.perf_counter() - t0
    emit("atlas1m_cluster_mnn", elapsed, "s",
         dims=int(cm.corrected.shape[1]),
         meta_clusters=len(set(cm.cluster_meta["meta"].tolist())))

    pairs = [i.pairs for i in res.merge_info if i.pairs.size]
    npairs = sum(p.shape[0] for p in pairs)
    t0 = time.perf_counter()
    dv = mnn_delta_variance_blocked(stores, pairs, cos_norm=True)
    elapsed = time.perf_counter() - t0
    emit("atlas1m_delta_variance", elapsed, "s", pairs=npairs,
         kpairs_per_s=round(npairs / elapsed / 1e3, 1))
    print(f"top adjusted var {float(np.max(dv.adjusted)):.4f}", flush=True)


if __name__ == "__main__":
    main()
