"""Command-line interface: batch correction over on-disk CSR stores.

The reference is a library with no CLI; production deployments want a
driveable entry point. Usage:

    python -m batchelor_tpu correct --input A_dir B_dir --output out_dir \
        --method fastmnn --d 50 --k 20 [--subset-hvgs 2000] [--knn auto]

    python -m batchelor_tpu import-dense counts.npy store_dir
    python -m batchelor_tpu info store_dir

Inputs are CSRCells stores (io/csr.py); `import-dense` converts a .npy
(cells x genes) matrix. Outputs: corrected.npy (+ rotation/centers for
fastmnn), batch.npy, merge_info.json, metrics.json.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def _cmd_import_dense(args):
    from .io.csr import CSRCells

    x = np.load(args.src)
    names = None
    if args.gene_names:
        with open(args.gene_names) as fh:
            names = [ln.strip() for ln in fh if ln.strip()]
    CSRCells.from_dense(x, gene_names=names).save(args.dest)
    print(f"wrote {args.dest}: {x.shape[0]} cells x {x.shape[1]} genes")


def _cmd_info(args):
    from .io.csr import CSRCells

    csr = CSRCells.load(args.store)
    nnz = int(csr.data.shape[0])
    print(
        json.dumps(
            {
                "cells": csr.n_cells,
                "genes": csr.n_genes,
                "nnz": nnz,
                "density": round(nnz / (csr.n_cells * csr.n_genes), 4),
                "named_genes": csr.gene_names is not None,
            }
        )
    )


def _cmd_correct(args):
    import jax.numpy as jnp

    from .correct.dispatch import (
        ClassicMNNParams,
        FastMNNParams,
        NoCorrectParams,
        RegressParams,
        RescaleParams,
        batch_correct,
    )
    from .correct.fast_mnn import MNNResult
    from .io.csr import CSRCells
    from .ops.stats import get_top_hvgs, model_gene_var
    from .utils.telemetry import MetricsRecorder

    stores = [CSRCells.load(p) for p in args.input]
    mats = [jnp.asarray(s.to_dense()) for s in stores]

    subset = None
    if args.subset_hvgs:
        stacked = jnp.concatenate(mats, axis=0)
        block = np.repeat(np.arange(len(mats)), [m.shape[0] for m in mats])
        dec = model_gene_var(stacked, block=block)
        subset = get_top_hvgs(dec, n=args.subset_hvgs)

    if args.method == "fastmnn":
        params = FastMNNParams(
            k=args.k, d=args.d, knn_method=args.knn, svd_method=args.svd,
        )
    elif args.method == "classic":
        params = ClassicMNNParams(k=args.k, sigma=args.sigma, knn_method=args.knn)
    elif args.method == "rescale":
        params = RescaleParams()
    elif args.method == "regress":
        params = RegressParams()
    elif args.method == "none":
        params = NoCorrectParams()
    else:
        raise SystemExit(f"unknown method {args.method}")

    rec = MetricsRecorder()
    with rec.activate():
        res = batch_correct(
            mats, subset_row=subset, correct_all=args.correct_all, params=params
        )

    os.makedirs(args.output, exist_ok=True)
    np.save(os.path.join(args.output, "corrected.npy"), np.asarray(res.corrected))
    np.save(os.path.join(args.output, "batch.npy"), np.asarray(res.batch))
    if isinstance(res, MNNResult):
        if res.rotation is not None:
            np.save(os.path.join(args.output, "rotation.npy"), np.asarray(res.rotation))
            np.save(os.path.join(args.output, "centers.npy"), np.asarray(res.centers))
        info = [
            {
                "left": [int(x) for x in i.left],
                "right": [int(x) for x in i.right],
                "n_pairs": int(i.pairs.shape[0]),
                "batch_size": None if np.isnan(i.batch_size) else float(i.batch_size),
                "skipped": bool(i.skipped),
                "lost_var": [None if np.isnan(v) else float(v) for v in i.lost_var],
            }
            for i in res.merge_info
        ]
        with open(os.path.join(args.output, "merge_info.json"), "w") as fh:
            json.dump(info, fh, indent=1)
    with open(os.path.join(args.output, "metrics.json"), "w") as fh:
        fh.write(rec.dump_json())
    print(f"corrected {res.corrected.shape} -> {args.output}")


def _cmd_quick_correct(args):
    from .correct.outofcore import quick_correct_csr
    from .io.csr import CSRCells
    from .utils.telemetry import MetricsRecorder

    stores = [CSRCells.load(p) for p in args.input]
    rec = MetricsRecorder()
    with rec.activate():
        out = quick_correct_csr(
            stores, hvg_n=args.hvgs, d=args.d, k=args.k,
            knn_method=args.knn, block_rows=args.block_rows,
        )
    res = out.corrected
    os.makedirs(args.output, exist_ok=True)
    np.save(os.path.join(args.output, "corrected.npy"), np.asarray(res.corrected))
    np.save(os.path.join(args.output, "batch.npy"), np.asarray(res.batch))
    np.save(os.path.join(args.output, "hvgs.npy"), np.asarray(out.hvgs))
    np.save(os.path.join(args.output, "rotation.npy"), np.asarray(res.rotation))
    np.save(os.path.join(args.output, "centers.npy"), np.asarray(res.centers))
    info = [
        {
            "left": [int(x) for x in i.left],
            "right": [int(x) for x in i.right],
            "n_pairs": int(i.pairs.shape[0]),
            "batch_size": None if np.isnan(i.batch_size) else float(i.batch_size),
            "skipped": bool(i.skipped),
        }
        for i in res.merge_info
    ]
    with open(os.path.join(args.output, "merge_info.json"), "w") as fh:
        json.dump(info, fh, indent=1)
    with open(os.path.join(args.output, "metrics.json"), "w") as fh:
        fh.write(rec.dump_json())
    print(f"corrected {res.corrected.shape} ({out.hvgs.shape[0]} HVGs) -> {args.output}")


def main(argv=None):
    p = argparse.ArgumentParser(prog="batchelor_tpu")
    sub = p.add_subparsers(dest="cmd", required=True)

    imp = sub.add_parser("import-dense", help="convert a .npy matrix to a CSR store")
    imp.add_argument("src")
    imp.add_argument("dest")
    imp.add_argument("--gene-names", help="text file, one gene name per line")
    imp.set_defaults(fn=_cmd_import_dense)

    info = sub.add_parser("info", help="describe a CSR store")
    info.add_argument("store")
    info.set_defaults(fn=_cmd_info)

    cor = sub.add_parser("correct", help="batch-correct CSR stores")
    cor.add_argument("--input", nargs="+", required=True, help="per-batch store dirs")
    cor.add_argument("--output", required=True)
    cor.add_argument(
        "--method", default="fastmnn",
        choices=["fastmnn", "classic", "rescale", "regress", "none"],
    )
    cor.add_argument("--d", type=int, default=50)
    cor.add_argument("--k", type=int, default=20)
    cor.add_argument("--sigma", type=float, default=0.1)
    cor.add_argument(
        "--knn", default="auto",
        choices=["auto", "exact", "chunked", "bf16"],
    )
    cor.add_argument("--svd", default="gram", choices=["gram", "randomized", "direct"])
    cor.add_argument("--subset-hvgs", type=int, default=0)
    cor.add_argument("--correct-all", action="store_true")
    cor.set_defaults(fn=_cmd_correct)

    qc = sub.add_parser(
        "quick-correct",
        help="out-of-core quickCorrect over CSR stores (never densifies)",
    )
    qc.add_argument("--input", nargs="+", required=True, help="per-batch store dirs")
    qc.add_argument("--output", required=True)
    qc.add_argument("--hvgs", type=int, default=5000)
    qc.add_argument("--d", type=int, default=50)
    qc.add_argument("--k", type=int, default=20)
    qc.add_argument(
        "--knn", default="auto",
        choices=["auto", "exact", "chunked", "bf16"],
    )
    qc.add_argument("--block-rows", type=int, default=8192)
    qc.set_defaults(fn=_cmd_quick_correct)

    args = p.parse_args(argv)
    from .utils.cache import use_compile_cache

    use_compile_cache()
    args.fn(args)


if __name__ == "__main__":
    main()
