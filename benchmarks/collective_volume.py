"""Per-merge-step collective volumes of the sharded merge, counted from HLO.

Counts every cross-replica op (all-gather, all-reduce, reduce-scatter,
collective-permute, all-to-all) in the compiled module of one
distributed_fast_mnn step — gather and ring memory modes — on a virtual
8-device CPU mesh, and prints the bytes as a JSON summary. These are
counts from the program, not timings: how long the collectives take over
NVLink is only measured on the cards.

Run: JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
     python benchmarks/collective_volume.py [N1] [N2] [d] [k]
"""
import json
import os
import re
import sys

sys.path.insert(0, ".")

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import numpy as np
import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp

from batchelor_tpu.parallel.driver import _jitted_step
from batchelor_tpu.parallel.mesh import make_cells_mesh

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "bf16": 2, "f16": 2,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1,
}

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter",
                "collective-permute", "all-to-all")


def _shape_bytes(shape_str: str) -> int:
    """bytes of one HLO shape literal like 'f32[1024,50]' or a tuple."""
    total = 0
    for m in re.finditer(r"(\w+)\[([\d,]*)\]", shape_str):
        dt, dims = m.group(1), m.group(2)
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def collective_bytes(compiled) -> dict:
    """Per-op-kind (count, output bytes) from optimized HLO text."""
    out = {k: {"count": 0, "bytes": 0} for k in _COLLECTIVES}
    for mod in compiled.runtime_executable().hlo_modules():
        for line in mod.to_string().splitlines():
            line = line.strip()
            m = re.match(r"(?:ROOT )?\S+ = (\S+) (all-gather|all-reduce|"
                         r"reduce-scatter|collective-permute|all-to-all)",
                         line)
            if m is None:
                continue
            kind = m.group(2)
            out[kind]["count"] += 1
            out[kind]["bytes"] += _shape_bytes(m.group(1))
    return out


def measure(memory: str, n1: int, n2: int, d: int, k: int, mesh):
    ndev = mesh.devices.size
    n1 = -(-n1 // ndev) * ndev
    n2 = -(-n2 // ndev) * ndev
    step = _jitted_step(mesh, k, k, k, 3.0, 0.0, "exact", memory, 2)
    args = (
        jnp.zeros((n1, d), jnp.float32), jnp.zeros((n2, d), jnp.float32),
        jnp.ones(n1, bool), jnp.ones(n2, bool),
        jnp.ones(n1, bool), jnp.ones(n2, bool),
        jnp.zeros(n1, jnp.int32), jnp.ones(n2, jnp.int32),
        jnp.zeros((1, d), jnp.float32), jnp.zeros((1, d), jnp.float32),
    )
    compiled = step.lower(*args).compile()
    return collective_bytes(compiled)


def main():
    n1 = int(sys.argv[1]) if len(sys.argv) > 1 else 40960
    n2 = int(sys.argv[2]) if len(sys.argv) > 2 else 40960
    d = int(sys.argv[3]) if len(sys.argv) > 3 else 50
    k = int(sys.argv[4]) if len(sys.argv) > 4 else 20
    mesh = make_cells_mesh(8)
    report = {"n1": n1, "n2": n2, "d": d, "k": k, "ndev": 8}
    for memory in ("gather", "ring"):
        stats = measure(memory, n1, n2, d, k, mesh)
        total = sum(v["bytes"] for v in stats.values())
        report[memory] = {
            "per_op": {k_: v for k_, v in stats.items() if v["count"]},
            "total_bytes": total,
            "bytes_per_cell": round(total / max(n1 + n2, 1), 1),
        }
    print(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
