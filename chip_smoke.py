"""Smoke run of batchelor_tpu on an NVIDIA GPU.

Drives the main path once through the public entry points at sizes users
run, with data simulated from a seed, and checks every result against a
plain reference: float64 numpy oracles (tests/oracle.py) and the same entry
point run on the CPU backend in this process. Each phase prints its compile
time (first call) and run time (second call), each comparison prints its
value, tolerance, matmul precision and verdict, and the last line of
standard output is one JSON object naming the device.

    python chip_smoke.py             # the gpu-marked test, (p), (a)-(e)
    python chip_smoke.py --cards 4   # only the 4-card sharded merge

It exits non-zero, without the JSON line, when JAX finds no GPU, when any
phase raises, or when any comparison misses its tolerance. One process
drives every card it uses.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "tests"))

SEED = 0
K = 20
D = 50
# JAX's default fp32 matmul precision on this card may use TF32 tensor
# cores; sites that need more set it themselves.
PRECISION = "fp32 data, default matmul precision (TF32 where the code sets none)"
# Two runs of a merge (card vs CPU, four cards vs one) sum in different
# orders, and MNN pair sets flip at near-ties under input perturbations as
# small as 1e-7 (on the CPU such a perturbation moved phase (d)'s
# reconstruction by 5e-4); each flipped pair moves its cells' corrections.
# So corrected coordinates must agree to 2e-3 of their norm after one merge
# step and 5e-3 after a merge tree, and pair sets to a Jaccard index of
# 0.999 on a step's shared inputs, 0.98 on later steps of a tree, whose
# inputs already differ by the earlier steps' flips. A sharded merge that
# skips the orthogonalisation replay reads 0.55-0.71 on later steps and
# 4.4e-2 in coordinates (CPU mesh, 4 x 8,000 cells). These limits do not
# see TF32 products; phase (p) checks every pinned product on its own.
COORD_TOL_STEP = 2e-3
COORD_TOL_TREE = 5e-3
PAIRS_TOL_LATER = 0.98


class Verdicts:
    """Collects comparison verdicts; a failed one fails the run."""

    def __init__(self):
        self.failed = []

    def check(self, name, value, limit, ok, note=""):
        verdict = "PASS" if ok else "FAIL"
        print(f"  [{verdict}] {name}: {value:.6g} (tolerance {limit}; "
              f"{note or PRECISION})", flush=True)
        if not ok:
            self.failed.append(name)


def _block(x):
    import jax

    return jax.block_until_ready(x)


def timed(label, fn, ready):
    """Runs ``fn`` twice: the first call compiles, the second is timed.
    ``ready`` maps the result to the arrays to wait for."""
    t0 = time.perf_counter()
    _block(ready(fn()))
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = fn()
    _block(ready(out))
    second = time.perf_counter() - t0
    print(f"  {label}: compile (first call) {first:.2f} s, "
          f"run (second call) {second:.2f} s", flush=True)
    return out


def peak_memory(label):
    import jax

    for dev in jax.local_devices():
        stats = dev.memory_stats() or {}
        print(f"  peak memory after {label} on {dev}: "
              f"{stats.get('peak_bytes_in_use', 0) / 2**30:.2f} GiB", flush=True)


# ---------------------------------------------------------------- data


def gene_batches(seed, sizes, g, latent):
    """Log-expression-like batches (cells x genes) on the device.

    Cells of 8 types live in a ``latent``-dim subspace with distinct,
    decaying scales; each batch moves every type's mean a little (so that
    merged cluster centroids stay distinct points), each batch but the
    first adds its own shift in gene space, and all genes get small
    isotropic noise. ``latent`` plus the
    number of shifts is the signal rank, so with it equal to the PCA's d the
    top-d subspace is well separated from the noise and two devices' PCAs
    agree up to a rotation inside it."""
    import jax
    import jax.numpy as jnp

    key = jax.random.key(seed)
    kw, km, ks, kc, ko = jax.random.split(key, 5)
    scales = 2.0 * 0.97 ** jnp.arange(latent, dtype=jnp.float32)
    w = jax.random.normal(kw, (latent, g)) / np.sqrt(g) * scales[:, None]
    means = jax.random.normal(km, (8, latent))
    shifts = 2.0 * jax.random.normal(ks, (len(sizes), g)) / np.sqrt(g)
    offsets = 0.3 * jax.random.normal(ko, (len(sizes), 8, latent))
    out, types = [], []
    for b, (n, kb) in enumerate(zip(sizes, jax.random.split(kc, len(sizes)))):
        ka, kz, ke = jax.random.split(kb, 3)
        t = jax.random.randint(ka, (n,), 0, 8)
        z = means[t] + offsets[b, t] + 0.3 * jax.random.normal(kz, (n, latent))
        x = jnp.matmul(z, w, precision="highest")
        x = x + 0.05 * jax.random.normal(ke, (n, g))
        if b:
            x = x + shifts[b][None, :]
        out.append(x)
        types.append(np.asarray(t))
    return out, types


def pc_batches(seed, sizes):
    """Two or more batches of 50-dim PC-like coordinates with 8 cell types
    and a per-batch shift (the input of reduced_mnn)."""
    out, _ = gene_batches(seed, sizes, D, D)
    return out


def sparse_counts(seed, sizes, g):
    """Sparse UMI-like counts as CSRCells stores, ~10% nonzero: Poisson
    counts whose rates depend on cell type and batch."""
    import jax
    import jax.numpy as jnp

    from batchelor_tpu.io.csr import CSRCells

    key = jax.random.key(seed)
    kb, kt, kx = jax.random.split(key, 3)
    base = 0.06 * jnp.exp(jax.random.normal(kb, (g,)))
    type_fx = jnp.exp(0.8 * jax.random.normal(kt, (8, g)))
    stores = []
    for b, (n, k) in enumerate(zip(sizes, jax.random.split(kx, len(sizes)))):
        ka, kp, kf = jax.random.split(k, 3)
        t = jax.random.randint(ka, (n,), 0, 8)
        batch_fx = jnp.exp(0.3 * jax.random.normal(kf, (g,))) if b else 1.0
        rate = base[None, :] * type_fx[t] * batch_fx
        counts = np.array(jax.random.poisson(kp, rate, dtype=jnp.int32))
        counts[:, 0] += 1  # every cell keeps a positive library size
        stores.append(CSRCells.from_dense(counts.astype(np.float32)))
    return stores


# ------------------------------------------------------------ references


def blocked_oracle_knn(oracle_knn, block=16, workers=os.cpu_count()):
    """tests/oracle.py's knn over blocks of queries, in threads: the
    oracle itself builds an (Nq, Nd, d) float64 array."""

    def knn(query, data, k):
        query = np.asarray(query, np.float64)
        data = np.asarray(data, np.float64)
        starts = range(0, query.shape[0], block)
        with ThreadPoolExecutor(workers) as pool:
            parts = list(pool.map(
                lambda s: oracle_knn(query[s:s + block], data, k), starts))
        return (np.concatenate([p[0] for p in parts]),
                np.concatenate([p[1] for p in parts]))

    return knn


def _pair_keys(pairs):
    pairs = np.asarray(pairs, np.int64).reshape(-1, 2)
    return np.unique(pairs[:, 0] * (1 << 32) + pairs[:, 1])


def jaccard(a, b):
    """|A & B| / |A | B| of two (n, 2) pair lists."""
    a, b = _pair_keys(a), _pair_keys(b)
    both = np.intersect1d(a, b, assume_unique=True).size
    return both / max(a.size + b.size - both, 1)


def rel_fro(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def knn_check(v, label, query, data, n_sample=4096):
    """The full search through query_knn(method="auto"), then 4,096 sampled
    query rows against the float64 oracle."""
    import oracle

    from batchelor_tpu.ops.knn import _auto_method, query_knn

    method = _auto_method(query, data, K)
    t0 = time.perf_counter()
    idx, dist = _block(tuple(query_knn(query, data, K, method="auto")))
    print(f"  {label} kNN {query.shape[0]} x {data.shape[0]} (auto -> {method}): "
          f"{time.perf_counter() - t0:.2f} s incl. compile", flush=True)
    n_sample = min(n_sample, query.shape[0])
    rows = np.random.default_rng(SEED).choice(query.shape[0], n_sample,
                                              replace=False)
    q64 = np.asarray(query, np.float64)[rows]
    oidx, odist = blocked_oracle_knn(oracle.knn)(q64, np.asarray(data), K)
    gidx = np.asarray(idx)[rows]
    gdist = np.asarray(dist)[rows]
    hits, errs = 0, []
    for r in range(n_sample):
        ref = dict(zip(oidx[r].tolist(), odist[r].tolist()))
        for j, dj in zip(gidx[r].tolist(), gdist[r].tolist()):
            if j in ref:
                hits += 1
                errs.append(abs(dj - ref[j]) / max(ref[j], 1e-12))
    recall = hits / (n_sample * K)
    v.check(f"{label} kNN recall vs oracle.knn (fp64), {n_sample} rows",
            recall, ">= 0.999", recall >= 0.999,
            f"{method} search, fp32 distances rescored at HIGHEST")
    err = max(errs) if errs else 0.0
    v.check(f"{label} kNN max rel distance error on agreeing neighbours",
            err, "<= 1e-4", err <= 1e-4, "fp32 rescore at HIGHEST")


def oracle_pairs(left, right):
    """oracle.find_mutual_nn, with the right batch's ids offset by the left
    batch's size as in MergeStepInfo.pairs."""
    import oracle

    orig = oracle.knn
    oracle.knn = blocked_oracle_knn(orig)
    try:
        first, second = oracle.find_mutual_nn(
            np.asarray(left, np.float64), np.asarray(right, np.float64), K, K)
    finally:
        oracle.knn = orig
    return np.stack([first, second + left.shape[0]], axis=1)


def on_cpu(fn):
    import jax

    with jax.default_device(jax.devices("cpu")[0]):
        return fn()


# --------------------------------------------------------------- phases


def phase_a(v, n=100_000, g=2000, n_cmp=20_000):
    """fast_mnn from gene space: cosine norm, Gram PCA with eigh, three
    kNN searches, MNN, orthogonalised tricube correction."""
    import jax.numpy as jnp

    import batchelor_tpu as bt
    from batchelor_tpu.ops.pca import _center_and_scale, _gram_of

    print(f"(a) fast_mnn: 2 x {n} cells x {g} genes, d={D}, k={K}, knn auto",
          flush=True)
    (b1, b2), _ = gene_batches(SEED + 1, (n, n), g, D - 1)
    res = timed("(a) fast_mnn", lambda: bt.fast_mnn(
        [b1, b2], d=D, k=K, knn_method="auto"), lambda r: r.corrected)
    corrected = np.asarray(res.corrected)
    assert corrected.shape == (2 * n, D), corrected.shape
    v.check("(a) corrected values finite", float(np.isfinite(corrected).mean()),
            "== 1", bool(np.isfinite(corrected).all()))
    print(f"  (a) MNN pairs: {res.merge_info[0].pairs.shape[0]}", flush=True)

    # the G x G Gram and its eigh, as the pipeline computes them
    normed = [bt.apply_cosine_norm(b, bt.cosine_norm(b, mode="l2norm"))
              for b in (b1, b2)]
    _, scaled, _ = _center_and_scale(normed, np.ones(2))
    gram = _gram_of(scaled, True)
    evals, evecs = jnp.linalg.eigh(gram)
    s64 = np.asarray(scaled, np.float64)
    g64 = s64.T @ s64
    del s64
    gerr = float(np.abs(np.asarray(gram, np.float64) - g64).max()
                 / np.abs(g64).max())
    v.check("(a) Gram S^T S vs float64 numpy, max abs err / max |G|", gerr,
            "<= 1e-4", gerr <= 1e-4, "fp32 accumulation (TF32 would read ~1e-3)")
    w64 = np.linalg.eigvalsh(g64)
    scale = np.abs(w64).max()
    werr = float(np.abs(np.asarray(evals, np.float64) - w64).max() / scale)
    v.check(f"(a) eigh eigenvalues (G={g}) vs float64 LAPACK, / max |lambda|",
            werr, "<= 1e-4", werr <= 1e-4, "jnp.linalg.eigh in fp32")
    top = np.asarray(evecs, np.float64)[:, -D:]
    lam = np.asarray(evals, np.float64)[-D:]
    resid = float(np.linalg.norm(g64 @ top - top * lam[None, :], axis=0).max()
                  / scale)
    v.check(f"(a) eigh residual ||G v - lambda v|| / ||G|| (top {D})", resid,
            "<= 1e-4", resid <= 1e-4, "jnp.linalg.eigh in fp32")

    pcs = bt.multi_batch_pca(normed, d=D).components
    knn_check(v, "(a)", pcs[1], pcs[0])

    compare_fast_mnn(v, b1[:n_cmp], b2[:n_cmp])
    peak_memory("(a)")


def compare_fast_mnn(v, b1, b2):
    import batchelor_tpu as bt

    n = b1.shape[0]
    gpu = bt.fast_mnn([b1, b2], d=D, k=K, knn_method="auto")
    h1, h2 = np.asarray(b1), np.asarray(b2)
    cpu = on_cpu(lambda: bt.fast_mnn([h1, h2], d=D, k=K, knn_method="auto"))
    # the corrected coordinates are defined up to a rotation of the PC
    # basis, so compare the gene-space reconstruction corrected @ rotation^T
    rg = np.asarray(gpu.corrected) @ np.asarray(gpu.rotation).T
    rc = np.asarray(cpu.corrected) @ np.asarray(cpu.rotation).T
    err = rel_fro(rg, rc)
    v.check(f"(a) 2 x {n}: reconstruction GPU vs CPU, rel Frobenius", err,
            f"<= {COORD_TOL_STEP}", err <= COORD_TOL_STEP)
    jac = jaccard(gpu.merge_info[0].pairs, cpu.merge_info[0].pairs)
    v.check(f"(a) 2 x {n}: MNN pairs GPU vs CPU, Jaccard", jac, ">= 0.999",
            jac >= 0.999)
    normed = [bt.apply_cosine_norm(b, bt.cosine_norm(b, mode="l2norm"))
              for b in (b1, b2)]
    pcs = bt.multi_batch_pca(normed, d=D).components
    jac = jaccard(gpu.merge_info[0].pairs, oracle_pairs(pcs[0], pcs[1]))
    v.check(f"(a) 2 x {n}: MNN pairs vs oracle.find_mutual_nn (fp64)", jac,
            ">= 0.999", jac >= 0.999)


def phase_b(v, n=100_000, n_cmp=20_000):
    """reduced_mnn on 50-dim coordinates with MNN pair lists fetched."""
    import batchelor_tpu as bt

    print(f"(b) reduced_mnn: 2 x {n} cells x {D} PCs, k={K}, knn auto",
          flush=True)
    b1, b2 = pc_batches(SEED + 2, (n, n))

    def run():
        res = bt.reduced_mnn([b1, b2], k=K, knn_method="auto")
        return res, res.merge_info[0].pairs
    res, pairs = timed("(b) reduced_mnn", run, lambda r: r[0].corrected)
    corrected = np.asarray(res.corrected)
    assert corrected.shape == (2 * n, D), corrected.shape
    v.check("(b) corrected values finite", float(np.isfinite(corrected).mean()),
            "== 1", bool(np.isfinite(corrected).all()))
    print(f"  (b) MNN pairs: {pairs.shape[0]}", flush=True)
    knn_check(v, "(b)", b2, b1)

    c1, c2 = b1[:n_cmp], b2[:n_cmp]
    gpu = bt.reduced_mnn([c1, c2], k=K, knn_method="auto")
    h1, h2 = np.asarray(c1), np.asarray(c2)
    cpu = on_cpu(lambda: bt.reduced_mnn([h1, h2], k=K, knn_method="auto"))
    err = rel_fro(gpu.corrected, cpu.corrected)
    v.check(f"(b) 2 x {n_cmp}: corrected GPU vs CPU, rel Frobenius", err,
            f"<= {COORD_TOL_STEP}", err <= COORD_TOL_STEP)
    jac = jaccard(gpu.merge_info[0].pairs, cpu.merge_info[0].pairs)
    v.check(f"(b) 2 x {n_cmp}: MNN pairs GPU vs CPU, Jaccard", jac,
            ">= 0.999", jac >= 0.999)
    jac = jaccard(gpu.merge_info[0].pairs, oracle_pairs(h1, h2))
    v.check(f"(b) 2 x {n_cmp}: MNN pairs vs oracle.find_mutual_nn (fp64)",
            jac, ">= 0.999", jac >= 0.999)
    peak_memory("(b)")


def phase_c(v, n=10_000, g=100):
    """Classic mnn_correct with var_adj on gene-space data."""
    import batchelor_tpu as bt

    print(f"(c) mnn_correct var_adj=True: 2 x {n} cells x {g} genes", flush=True)
    (b1, b2), _ = gene_batches(SEED + 3, (n, n), g, 20)
    res = timed("(c) mnn_correct", lambda: bt.mnn_correct(
        [b1, b2], k=K, sigma=0.1, var_adj=True), lambda r: r.corrected)
    h1, h2 = np.asarray(b1), np.asarray(b2)
    cpu = on_cpu(lambda: bt.mnn_correct([h1, h2], k=K, sigma=0.1,
                                        var_adj=True))
    out = np.asarray(res.corrected)
    v.check("(c) corrected values finite", float(np.isfinite(out).mean()),
            "== 1", bool(np.isfinite(out).all()))
    err = rel_fro(out, cpu.corrected)
    v.check(f"(c) 2 x {n}: corrected GPU vs CPU, rel Frobenius", err,
            f"<= {COORD_TOL_STEP}", err <= COORD_TOL_STEP)
    jac = jaccard(res.merge_info[0].pairs, cpu.merge_info[0].pairs)
    v.check(f"(c) 2 x {n}: MNN pairs GPU vs CPU, Jaccard", jac, ">= 0.999",
            jac >= 0.999)
    peak_memory("(c)")


def phase_d(v, n=5000, g=500, nb=8):
    """cluster_mnn on an 8-batch atlas with known cluster labels."""
    import batchelor_tpu as bt

    print(f"(d) cluster_mnn: {nb} x {n} cells x {g} genes", flush=True)
    mats, types = gene_batches(SEED + 4, (n,) * nb, g, D - nb + 1)
    res = timed("(d) cluster_mnn", lambda: bt.cluster_mnn(
        mats, clusters=types), lambda r: r.corrected)
    host = [np.asarray(m) for m in mats]
    cpu = on_cpu(lambda: bt.cluster_mnn(host, clusters=types))
    out = np.asarray(res.corrected)
    v.check("(d) corrected values finite", float(np.isfinite(out).mean()),
            "== 1", bool(np.isfinite(out).all()))
    rg = out @ np.asarray(res.rotation).T
    rc = np.asarray(cpu.corrected) @ np.asarray(cpu.rotation).T
    err = rel_fro(rg, rc)
    v.check(f"(d) {nb} x {n}: reconstruction GPU vs CPU, rel Frobenius", err,
            f"<= {COORD_TOL_TREE}", err <= COORD_TOL_TREE)
    peak_memory("(d)")


def phase_e(v, n=25_000, g=5000, hvg_n=2000):
    """quick_correct_csr on a 2-batch sparse store: native C++ host
    transforms, streamed PCA, merge."""
    import batchelor_tpu as bt
    from batchelor_tpu.io.checkpoint import load_pca_stage
    from batchelor_tpu.native import bindings

    print(f"(e) quick_correct_csr: 2 x {n} cells x {g} genes (sparse), "
          f"{hvg_n} HVGs", flush=True)
    stores = sparse_counts(SEED + 5, (n, n), g)
    nnz = sum(int(s.data.shape[0]) for s in stores)
    print(f"  (e) nnz {nnz} ({nnz / (2 * n * g):.3f} dense); native library "
          f"loaded: {bindings.get_lib() is not None}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        cache = os.path.join(tmp, "pca")
        # the timed second call computes the PCA and saves it for the CPU run
        calls = iter([None, cache])
        out = timed("(e) quick_correct_csr", lambda: bt.quick_correct_csr(
            stores, hvg_n=hvg_n, d=D, k=K, pca_cache_dir=next(calls)),
            lambda r: r.corrected.corrected)
        # the CPU run reuses the card's PCA stage, so both merge the same PCs
        cpu = on_cpu(lambda: bt.quick_correct_csr(
            stores, hvg_n=hvg_n, d=D, k=K, pca_cache_dir=cache))
        comps = load_pca_stage(cache)[0]
    res = out.corrected
    got = np.asarray(res.corrected)
    v.check("(e) corrected values finite", float(np.isfinite(got).mean()),
            "== 1", bool(np.isfinite(got).all()))
    same = bool(np.array_equal(np.asarray(out.hvgs), np.asarray(cpu.hvgs)))
    v.check("(e) HVGs GPU vs CPU identical", float(same), "== 1", same,
            "host statistics")
    err = rel_fro(got, cpu.corrected.corrected)
    v.check(f"(e) 2 x {n}: corrected GPU vs CPU on the same PCs, rel "
            f"Frobenius", err, f"<= {COORD_TOL_STEP}", err <= COORD_TOL_STEP)
    jac = jaccard(res.merge_info[0].pairs, cpu.corrected.merge_info[0].pairs)
    v.check(f"(e) 2 x {n}: MNN pairs GPU vs CPU, Jaccard", jac, ">= 0.999",
            jac >= 0.999)
    jac = jaccard(res.merge_info[0].pairs, oracle_pairs(comps[0], comps[1]))
    v.check(f"(e) 2 x {n}: MNN pairs vs oracle.find_mutual_nn (fp64)", jac,
            ">= 0.999", jac >= 0.999)
    peak_memory("(e)")


def phase_kernel_test():
    """The gpu-marked test of the compiled pass-1 kernel."""
    import jax

    from test_knn_backends import test_pass1_kernel_compiled_matches_plain

    print("(t) tests/test_knn_backends.py::test_pass1_kernel_compiled_"
          "matches_plain", flush=True)
    t0 = time.perf_counter()
    test_pass1_kernel_compiled_matches_plain(jax.devices()[0])
    print(f"  (t) passed in {time.perf_counter() - t0:.2f} s", flush=True)


def phase_p(v, n=100_000, g=2000, k=K):
    """Every fp32 product pinned to Precision.HIGHEST, called at a real
    width and compared with float64 numpy. Beside each, the same product
    at JAX's default precision (TF32 on this card) is printed as the
    control: the 1e-5 tolerance sits between the two, so a check fails if
    its pin is lost."""
    import jax
    import jax.numpy as jnp

    from batchelor_tpu.ops.correction import (
        _center_along, _tricube_from_knn, tricube_average, tricube_weights)
    from batchelor_tpu.ops.merge_math import center_along
    from batchelor_tpu.ops.pca import matmul_f32

    print(f"(p) pinned fp32 products: {n} cells, {g} genes, d={D}, k={k}",
          flush=True)
    kx, kw, kv, ki, kd = jax.random.split(jax.random.key(SEED + 7), 5)
    tol = 1e-5

    def report(name, got, control, ref):
        err, ctl = rel_fro(got, ref), rel_fro(control, ref)
        print(f"  (p) {name}: control at default precision {ctl:.3g}",
              flush=True)
        v.check(f"(p) {name} vs float64, rel Frobenius", err, f"<= {tol}",
                err <= tol, "Precision.HIGHEST")

    # PCA projection (ops/pca.py matmul_f32; also the Grams, parallel/
    # distributed.py and correct/cluster_mnn.py)
    f32 = jnp.float32
    x = jax.random.normal(kx, (n, g), f32) + 0.5
    w = jax.random.normal(kw, (g, D), f32) / np.sqrt(g)
    ref = np.asarray(x, np.float64) @ np.asarray(w, np.float64)
    report("pca.matmul_f32 (n x G) @ (G x d)", matmul_f32(x, w),
           jnp.matmul(x, w), ref)
    del x, ref

    # centring along a batch vector: the displacement of every cell
    pcs = jax.random.normal(kx, (2 * n, D), f32) * 3.0 + 1.0
    vec = jax.random.normal(kv, (D,), f32)
    unit = vec / jnp.linalg.norm(vec)
    mask = jnp.arange(2 * n) % 3 > 0
    p64, u64 = np.asarray(pcs, np.float64), np.asarray(unit, np.float64)
    loc64 = p64 @ u64
    ref = np.outer(loc64[np.asarray(mask)].mean() - loc64, u64)
    loc = pcs @ unit
    control = jnp.outer(jnp.sum(jnp.where(mask, loc, 0.0)) / jnp.sum(mask)
                        - loc, unit)
    got, _ = center_along(pcs, mask, unit)
    report("merge_math.center_along displacement", got - pcs, control, ref)
    ref = np.outer(loc64[np.asarray(mask)].mean() - loc64,
                   np.asarray(vec / jnp.sqrt(jnp.sum(jnp.square(vec))),
                              np.float64))
    got = _center_along(pcs, vec, mask)
    report("correction._center_along displacement", got - pcs, control, ref)
    del p64, loc64

    # tricube-weighted averages of neighbour values
    idx = jax.random.randint(ki, (n, k), 0, 2 * n)
    dist = jnp.sort(jax.random.uniform(kd, (n, k), f32) + 0.1, axis=1)
    wts = tricube_weights(dist, 3.0)
    gathered = np.asarray(pcs, np.float64)[np.asarray(idx)]
    ref = np.einsum("nk,nkd->nd", np.asarray(wts, np.float64), gathered)
    control = jnp.einsum("nk,nkd->nd", wts, pcs[idx])
    report("correction._tricube_from_knn", _tricube_from_knn(
        pcs, idx, dist, 3.0), control, ref)
    bw = 3.0 * dist[:, k // 2]
    rel = np.minimum(np.asarray(dist, np.float64)
                     / np.asarray(bw, np.float64)[:, None], 1.0)
    tri = (1.0 - rel ** 3) ** 3
    ref = np.einsum("nk,nkd->nd", tri / tri.sum(1, keepdims=True), gathered)
    wb = jnp.asarray(tri / tri.sum(1, keepdims=True), jnp.float32)
    control = jnp.einsum("nk,nkd->nd", wb, pcs[idx])
    report("correction.tricube_average(bandwidth=...)", tricube_average(
        pcs, idx, dist, bandwidth=bw), control, ref)
    peak_memory("(p)")


def phase_four_cards(v, n=250_000, g=2000, nb=4):
    """Sharded PCA and both sharded merge modes on a 4-card mesh, each
    compared with one-card reduced_mnn on the same PCs.

    "auto" runs the two-pass search on every card. Gather mode searches
    the gathered batch as one card does, so it is held to one card's
    "auto" run. Ring mode selects k sub-chunks in each of the four blocks
    it visits, four times the candidates, so it keeps neighbours that the
    one-card selection prunes at near-ties of its ~2^-16 resolution: it is
    held to one card's "exact" run. (CPU mesh, 4 x 30,000 cells: ring vs
    one-device exact 1.8e-4 in coordinates and pairs >= 0.99992 at every
    step; one-device chunked vs exact 2.6e-3 and 0.9933.)"""
    import jax

    import batchelor_tpu as bt
    from batchelor_tpu.parallel import (
        distributed_fast_mnn, distributed_multi_batch_pca, make_cells_mesh)

    mesh = make_cells_mesh(4)
    devs = {d.id for d in mesh.devices.flat}
    assert len(devs) == 4, f"mesh spans {devs}"
    print(f"(4) {nb} batches x {n} cells x {g} genes on a 4-card cells mesh",
          flush=True)
    mats, _ = gene_batches(SEED + 6, (n,) * nb, g, D - nb + 1)
    pca = timed("(4) distributed_multi_batch_pca", lambda:
                distributed_multi_batch_pca(mats, mesh, d=D),
                lambda p: p.components)
    del mats
    held = {d.id for c in pca.components for d in c.sharding.device_set}
    v.check("(4) PCA components held on distinct cards", float(len(held)),
            "== 4", len(held) == 4, "sharding")
    pcs = [np.asarray(c) for c in pca.components]
    dev0 = jax.devices()[0]
    on_dev0 = [jax.device_put(p, dev0) for p in pcs]
    ref = {}
    for method in ("auto", "exact"):
        t0 = time.perf_counter()
        ref[method] = bt.reduced_mnn(on_dev0, k=K, knn_method=method)
        print(f"  (4) one-card reduced_mnn knn {method}: "
              f"{time.perf_counter() - t0:.2f} s incl. compile", flush=True)
    del on_dev0
    print("  (4) one-card auto vs exact (the chunked selection's misses): "
          + compare_merges(ref["auto"], ref["exact"]), flush=True)
    for memory, method in (("gather", "auto"), ("ring", "exact")):
        res = timed(f"(4) distributed_fast_mnn memory={memory}",
                    lambda: distributed_fast_mnn(pcs, mesh, k=K,
                                                 knn_method="auto",
                                                 memory=memory),
                    lambda r: r.corrected)
        other = "exact" if method == "auto" else "auto"
        print(f"  (4) {memory} vs one-card {other}: "
              + compare_merges(res, ref[other]), flush=True)
        base = ref[method]
        err = rel_fro(res.corrected, base.corrected)
        v.check(f"(4) {memory}: corrected vs one-card reduced_mnn (knn "
                f"{method}), rel Frobenius", err, f"<= {COORD_TOL_TREE}",
                err <= COORD_TOL_TREE)
        for step, (a, b) in enumerate(zip(res.merge_info, base.merge_info)):
            jac = jaccard(a.pairs, b.pairs)
            lim = 0.999 if step == 0 else PAIRS_TOL_LATER
            v.check(f"(4) {memory}: step {step} MNN pairs vs one-card (knn "
                    f"{method}), Jaccard", jac, f">= {lim}", jac >= lim)
    busy = [(d.memory_stats() or {}).get("peak_bytes_in_use", 0)
            for d in mesh.devices.flat]
    low = min(busy[1:]) / max(busy[0], 1)
    v.check("(4) peak memory of cards 1-3 / card 0", low, ">= 0.1",
            low >= 0.1, "work landed on every card")
    peak_memory("(4)")


def compare_merges(a, b):
    """Relative coordinate difference and per-step pair Jaccards of two
    merges of the same batches, as one line."""
    jac = ", ".join(f"{jaccard(x.pairs, y.pairs):.6g}"
                    for x, y in zip(a.merge_info, b.merge_info))
    return (f"coordinates {rel_fro(a.corrected, b.corrected):.6g}, pairs "
            f"Jaccard by step [{jac}]")


# ----------------------------------------------------------------- main


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return "; ".join(line.strip() for line in out.splitlines())


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cards", type=int, choices=(1, 4), default=1,
                   help="4: run only the sharded merge on a 4-card mesh")
    args = p.parse_args(argv)

    import jax

    if jax.default_backend() != "gpu":
        print(f"chip_smoke: JAX found no GPU (default backend "
              f"{jax.default_backend()!r})", file=sys.stderr)
        return 2
    if len(jax.devices()) < args.cards:
        print(f"chip_smoke: {args.cards} cards requested, JAX sees "
              f"{len(jax.devices())}", file=sys.stderr)
        return 2

    import batchelor_tpu  # noqa: F401  (fails here outside the repo)
    from batchelor_tpu.utils.cache import use_compile_cache

    print(f"compile cache: {use_compile_cache()}", flush=True)
    print(f"card: {card_line()}", flush=True)
    print(f"jax {jax.__version__}, devices: {jax.devices()}", flush=True)

    v = Verdicts()
    t0 = time.perf_counter()
    if args.cards == 4:
        phases = [phase_four_cards]
    else:
        phases = [phase_kernel_test, phase_p, phase_a, phase_b, phase_c,
                  phase_d, phase_e]
    for phase in phases:
        t1 = time.perf_counter()
        phase() if phase is phase_kernel_test else phase(v)
        print(f"  {phase.__name__} wall time incl. references: "
              f"{time.perf_counter() - t1:.1f} s", flush=True)
    print(f"total {time.perf_counter() - t0:.1f} s", flush=True)
    if v.failed:
        print(f"chip_smoke: {len(v.failed)} comparison(s) missed their "
              f"tolerance: {v.failed}", file=sys.stderr)
        return 1
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
