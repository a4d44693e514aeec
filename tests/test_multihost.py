"""Multi-host bootstrap on a simulated mesh (SURVEY.md §4.6c).

Single-process here, so these cover the degenerate-but-required behaviors:
initialize is a safe no-op, the host-major mesh spans all devices, and the
mesh drives the distributed engine end-to-end.
"""
import jax
import numpy as np
import pytest

from batchelor_tpu.parallel import (
    distributed_fast_mnn,
    initialize_multihost,
    make_multihost_cells_mesh,
)
from batchelor_tpu.parallel.mesh import CELLS_AXIS


def test_initialize_multihost_single_process_noop():
    initialize_multihost()  # must not raise without a coordinator
    assert jax.process_count() == 1


def test_initialize_multihost_explicit_config_fails_loudly():
    # A requested-but-broken pod bootstrap must surface, not silently run
    # 1/N of the job (VERDICT r1 item 10): only the fully-auto-detected
    # no-argument case may degrade to single-process.
    with pytest.raises((RuntimeError, ValueError)):
        initialize_multihost(
            coordinator_address="256.256.256.256:65500",
            num_processes=2,
            process_id=1,
            initialization_timeout=3,
        )


def test_multihost_mesh_spans_all_devices_host_major():
    mesh = make_multihost_cells_mesh()
    assert mesh.axis_names == (CELLS_AXIS,)
    assert mesh.devices.size == len(jax.devices()) == 8
    order = [(d.process_index, d.id) for d in mesh.devices.flat]
    assert order == sorted(order)  # host-major: each host's shards contiguous


def test_multihost_mesh_drives_distributed_fast_mnn(rng):
    mesh = make_multihost_cells_mesh()
    b1 = rng.normal(size=(96, 8)).astype(np.float32)
    b2 = rng.normal(size=(80, 8)).astype(np.float32) + 0.5
    res = distributed_fast_mnn([b1, b2], mesh, k=5)
    assert res.corrected.shape == (176, 8)
    assert np.isfinite(np.asarray(res.corrected)).all()
    assert len(res.merge_info) == 1 and res.merge_info[0].pairs.shape[0] > 0
