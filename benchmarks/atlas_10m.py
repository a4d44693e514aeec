"""BASELINE config 5: 10M cells / 16 batches, end-to-end on one chip.

The full out-of-core route: on-disk CSR stores (counts, ~5% density) ->
quick_correct_csr(mesh=...) = O(nnz) host gene stats -> median-ratio
rescale + HVG selection -> threaded sparse log/cosine transform -> streamed
sparse-transfer Gram PCA -> distributed_fast_mnn with pad_buckets (15 merge
steps, "auto" kNN). Emits one JSON line per stage (bench.py style) plus a
final summary line with per-merge-step times.

Usage:
  python benchmarks/atlas_10m.py [knn_method] [cells_per_batch] [checkpoint]

Defaults: auto, 625000 (x16 batches = 10M cells), no checkpointing.
Pass a third arg ``checkpoint`` to exercise per-merge-step checkpoint
writes (each late-step checkpoint fetches a multi-GB node to the host).
Data is generated once into $ATLAS10M_DATA (default ``.atlas10m_data`` in
the repository, ~8 GiB) and reused.
"""
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, ".")

import jax

jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)

from batchelor_tpu.utils.cache import use_compile_cache  # noqa: E402

use_compile_cache()

import jax.numpy as jnp

from batchelor_tpu import quick_correct_csr
from batchelor_tpu.io.csr import CSRCells
from batchelor_tpu.parallel.mesh import make_cells_mesh
from batchelor_tpu.utils.telemetry import MetricsRecorder, set_recorder

DATA_DIR = os.environ.get(
    "ATLAS10M_DATA",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                 ".atlas10m_data"),
)
G = 2000
NNZ_ROW = 100          # ~5% density
N_TYPES = 12
STAGES = []


def emit(metric, value, unit, **extra):
    line = {"metric": metric, "value": round(float(value), 3), "unit": unit}
    line.update(extra)
    STAGES.append(line)
    print(json.dumps(line), flush=True)


def _gen_batch(rng, n, g, batch_id):
    """Clustered sparse counts: every cell draws NNZ_ROW distinct genes
    (stride-coprime comb around a per-type window) with Poisson values from
    a per-type expression profile times a per-batch multiplier — real
    cluster structure in value space, batch effect in both support shift
    and magnitude."""
    assign = rng.integers(0, N_TYPES, n)
    profile = _gen_batch.profile
    bprof = np.exp(0.25 * rng.standard_normal(g)).astype(np.float32)
    start = (assign * 197 + batch_id * 13 + rng.integers(0, 23, n)) % g
    offs = (np.arange(NNZ_ROW, dtype=np.int64) * 37) % g
    idx = (start[:, None] + offs[None, :]) % g                # distinct/row
    lam = profile[assign[:, None], idx] * bprof[idx]
    vals = rng.poisson(lam).astype(np.float32) + 1.0          # keep nnz real
    indptr = np.arange(n + 1, dtype=np.int64) * NNZ_ROW
    return (
        CSRCells(vals.reshape(-1), idx.astype(np.int32).reshape(-1),
                 indptr, g),
        assign,
    )


def _ensure_data(nb, n):
    os.makedirs(DATA_DIR, exist_ok=True)
    marker = os.path.join(DATA_DIR, f"ready_{nb}x{n}")
    if os.path.exists(marker):
        return 0.0
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    _gen_batch.profile = rng.gamma(2.0, 1.5, size=(N_TYPES, G)).astype(
        np.float32
    )
    for b in range(nb):
        csr, _ = _gen_batch(rng, n, G, b)
        csr.save(os.path.join(DATA_DIR, f"batch_{nb}x{n}_{b}"))
        del csr
        print(f"generated batch {b + 1}/{nb}", flush=True)
    open(marker, "w").close()
    return time.perf_counter() - t0


def main():
    method = sys.argv[1] if len(sys.argv) > 1 else "auto"
    n = int(sys.argv[2]) if len(sys.argv) > 2 else 625_000
    ckpt = len(sys.argv) > 3 and sys.argv[3] == "checkpoint"
    nb = 16
    total_cells = nb * n
    print(f"backend={jax.default_backend()} config5: {nb}x{n} cells, "
          f"G={G}, nnz/cell={NNZ_ROW}, knn_method={method}, "
          f"checkpoint={ckpt}", flush=True)

    gen_s = _ensure_data(nb, n)
    if gen_s:
        emit("atlas10m_generate", gen_s, "s", note="one-time, excluded from total")
    stores = [
        CSRCells.load(os.path.join(DATA_DIR, f"batch_{nb}x{n}_{b}"))
        for b in range(nb)
    ]
    nnz = sum(int(s.data.shape[0]) for s in stores)
    print(f"{nnz / 1e9:.2f}G nnz on disk ({nnz * 8 / 2**30:.1f} GiB)",
          flush=True)

    ckpt_dir = None
    if ckpt:
        ckpt_dir = os.path.join(DATA_DIR, "ckpt")
        import shutil

        shutil.rmtree(ckpt_dir, ignore_errors=True)

    # balanced merge tree: the multi-host-shaped plan. Peak per-step HBM
    # halves vs the sequential default (final step is N/2 x N/2 instead of
    # (N-b) x b) and each tree level shares one compiled step shape
    # (4 compiles for 16 batches instead of one per distinct left size).
    def balanced(lo, hi):
        if hi - lo == 1:
            return lo
        mid = (lo + hi) // 2
        return [balanced(lo, mid), balanced(mid, hi)]

    rec = MetricsRecorder()
    set_recorder(rec)
    t0 = time.perf_counter()
    qc = quick_correct_csr(
        stores,
        hvg_n=1000, d=50, k=20,
        knn_method=method,
        mesh=make_cells_mesh(1),
        pad_buckets=True,
        merge_order=balanced(0, nb),
        checkpoint_dir=ckpt_dir,
        pca_cache_dir=os.path.join(DATA_DIR, f"pca_cache_{nb}x{n}_{method}"),
        block_rows=65536,
        progress=True,
        # ~5% density counts: per-gene grand averages sit around 0.15, so
        # the min.mean=1 default (tuned for dense log-counts) would filter
        # every gene out of the median-ratio step.
        min_mean=0.05,
    )
    _ = float(jnp.sum(jnp.asarray(qc.corrected.corrected[:1, :1])))
    total_s = time.perf_counter() - t0
    set_recorder(None)

    for span in ("quickcsr/stats", "quickcsr/rescale", "quickcsr/restats",
                 "quickcsr/hvg", "quickcsr/transform", "quickcsr/pca",
                 "quickcsr/merge"):
        times = rec.spans.get(span, [])
        emit(span.split("/")[1], sum(times), "s")
    steps = rec.spans.get("driver/step", [])
    pair_fetch = rec.spans.get("driver/pairs", [])
    for i, info in enumerate(qc.corrected.merge_info):
        print(f"step {i}: left={info.left} right={info.right} "
              f"pairs={info.pairs.shape[0]} "
              f"batch_size={info.batch_size:.3f}", flush=True)
    emit("atlas10m_total", total_s, "s", cells=total_cells)
    emit("atlas10m_throughput", total_cells / total_s / 1e3, "kcells/s/chip")
    summary = {
        "metric": "atlas10m_summary", "unit": "s",
        "value": round(total_s, 1),
        "cells": total_cells, "batches": nb, "knn_method": method,
        "checkpoint": ckpt,
        "per_merge_step_s": [round(t, 2) for t in steps],
        "pair_fetch_s": [round(t, 2) for t in pair_fetch],
        "stages": STAGES,
    }
    print(json.dumps(summary), flush=True)
    out_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "BENCH_atlas10m.json")
    with open(out_path, "w") as fh:
        fh.write(json.dumps(summary) + "\n")
    print(f"wrote {out_path}", flush=True)


if __name__ == "__main__":
    main()
