"""Sharding-equivalence tests on the virtual 8-device CPU mesh.

The analog of the reference's distribution-discipline fixture
(SURVEY.md §4.1/§4.6): 1-device and 8-device meshes must produce identical
MNN pair counts and corrected coordinates; all collectives occur on the
declared mesh only.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from batchelor_tpu.correct.fused import fused_merge_step
from batchelor_tpu.ops.pca import multi_batch_pca
from batchelor_tpu.parallel.distributed import (
    distributed_merge_step,
    distributed_multi_batch_pca,
)
from batchelor_tpu.parallel.mesh import make_cells_mesh


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    return make_cells_mesh(8)


@pytest.fixture(scope="module")
def mesh1():
    return make_cells_mesh(1)


def test_merge_step_sharding_equivalence(rng, mesh8, mesh1):
    b1 = rng.normal(size=(120, 16))
    b2 = rng.normal(size=(200, 16)) + 1
    out8 = distributed_merge_step(jnp.asarray(b1), jnp.asarray(b2), mesh8)
    out1 = distributed_merge_step(jnp.asarray(b1), jnp.asarray(b2), mesh1)
    assert int(out8.n_pairs) == int(out1.n_pairs)
    assert np.allclose(np.asarray(out8.left), np.asarray(out1.left), atol=1e-10)
    assert np.allclose(np.asarray(out8.right), np.asarray(out1.right), atol=1e-10)
    assert np.isclose(float(out8.batch_size), float(out1.batch_size), atol=1e-12)


def test_merge_step_matches_fused_single_device(rng, mesh8):
    b1 = rng.normal(size=(150, 12))
    b2 = rng.normal(size=(130, 12)) + 0.5
    dist = distributed_merge_step(jnp.asarray(b1), jnp.asarray(b2), mesh8)
    ref = fused_merge_step(jnp.asarray(b1), jnp.asarray(b2), 20, 20)
    assert int(dist.n_pairs) == int(ref.n_pairs)
    assert np.allclose(np.asarray(dist.left), np.asarray(ref.left), atol=1e-8)
    assert np.allclose(np.asarray(dist.right), np.asarray(ref.right), atol=1e-8)


def _assert_comps_match_to_sign(comps, ref_comps, atol=1e-6):
    for mine, theirs in zip(comps, ref_comps):
        mine, theirs = np.asarray(mine), np.asarray(theirs)
        for j in range(mine.shape[1]):
            assert np.allclose(mine[:, j], theirs[:, j], atol=atol) or np.allclose(
                mine[:, j], -theirs[:, j], atol=atol
            )


def test_distributed_pca_matches_local(rng, mesh8):
    mats = [rng.normal(size=(90, 20)), rng.normal(size=(110, 20)) + 1]
    out = distributed_multi_batch_pca(
        [jnp.asarray(m) for m in mats], mesh8, d=6
    )
    ref = multi_batch_pca([jnp.asarray(m) for m in mats], d=6)
    assert np.allclose(np.asarray(out.centers), np.asarray(ref.centers), atol=1e-10)
    _assert_comps_match_to_sign(out.components, ref.components)


def test_distributed_pca_full_options(rng, mesh8):
    """Option parity with the host PCA (VERDICT r1 item 7): weight trees,
    subset_row + get_all_genes extrapolation, get_variance."""
    mats = [
        rng.normal(size=(90, 24)),
        rng.normal(size=(110, 24)) + 1,
        rng.normal(size=(70, 24)) + 2,
    ]
    jm = [jnp.asarray(m) for m in mats]
    sub = np.arange(0, 24, 2)
    out = distributed_multi_batch_pca(
        jm, mesh8, d=5, weights=[[0, 1], 2], subset_row=sub,
        get_all_genes=True, get_variance=True,
    )
    ref = multi_batch_pca(
        jm, d=5, weights=[[0, 1], 2], subset_row=sub,
        get_all_genes=True, get_variance=True,
    )
    assert out.rotation.shape == (24, 5)
    assert np.allclose(np.asarray(out.centers), np.asarray(ref.centers), atol=1e-9)
    _assert_comps_match_to_sign(out.components, ref.components)
    # rotation rows match up to per-component sign
    mine, theirs = np.asarray(out.rotation), np.asarray(ref.rotation)
    for j in range(5):
        assert np.allclose(mine[:, j], theirs[:, j], atol=1e-6) or np.allclose(
            mine[:, j], -theirs[:, j], atol=1e-6
        )
    assert np.allclose(out.var_explained, ref.var_explained, atol=1e-8)
    assert np.isclose(out.var_total, ref.var_total, atol=1e-6)


def test_distributed_pca_d_none_passthrough(rng, mesh8):
    mats = [rng.normal(size=(50, 12)), rng.normal(size=(60, 12)) + 1]
    jm = [jnp.asarray(m) for m in mats]
    out = distributed_multi_batch_pca(jm, mesh8, d=None, get_variance=True)
    ref = multi_batch_pca(jm, d=None, get_variance=True)
    for mine, theirs in zip(out.components, ref.components):
        assert np.allclose(np.asarray(mine), np.asarray(theirs), atol=1e-10)
    assert np.allclose(np.asarray(out.rotation), np.asarray(ref.rotation))
    assert np.allclose(out.var_explained, ref.var_explained, atol=1e-8)
    assert np.isclose(out.var_total, ref.var_total, atol=1e-6)


def test_uneven_padding(rng, mesh8):
    # sizes not divisible by 8 exercise the mask path
    b1 = rng.normal(size=(101, 8))
    b2 = rng.normal(size=(77, 8)) + 1
    out = distributed_merge_step(jnp.asarray(b1), jnp.asarray(b2), mesh8)
    assert out.left.shape == (101, 8)
    assert out.right.shape == (77, 8)
    ref = fused_merge_step(jnp.asarray(b1), jnp.asarray(b2), 20, 20)
    assert np.allclose(np.asarray(out.right), np.asarray(ref.right), atol=1e-8)


def test_make_cells_mesh_refuses_too_many_devices():
    """Asking for more devices than the platform has raises; there is no
    fallback to another platform's devices."""
    n = len(jax.devices())
    assert make_cells_mesh(n).devices.size == n
    with pytest.raises(ValueError, match="requested"):
        make_cells_mesh(n + 1)
    with pytest.raises(ValueError, match="requested"):
        make_cells_mesh(3, devices=jax.devices()[:2])
