"""Pluggable kNN backend tests: the two-pass search runs its plain-XLA pass 1
on the CPU; the Pallas pass-1 kernel is checked here in interpret mode."""
import numpy as np
import jax.numpy as jnp
import pytest

from batchelor_tpu.ops.knn import query_knn


def test_chunked_matches_exact_small(rng):
    # keep sizes tiny (one padded block)
    q = rng.normal(size=(40, 10))
    x = rng.normal(size=(300, 10))
    ref = query_knn(jnp.asarray(q), jnp.asarray(x), 5, method="exact")
    out = query_knn(jnp.asarray(q), jnp.asarray(x), 5, method="chunked")
    assert np.array_equal(np.asarray(ref.indices), np.asarray(out.indices))
    assert np.allclose(np.asarray(ref.distances), np.asarray(out.distances), atol=1e-5)


def test_chunked_respects_mask(rng):
    q = rng.normal(size=(16, 6))
    x = rng.normal(size=(256, 6))
    mask = np.zeros(256, dtype=bool)
    mask[:150] = True
    ref = query_knn(jnp.asarray(q), jnp.asarray(x[:150]), 4, method="exact")
    out = query_knn(jnp.asarray(q), jnp.asarray(x), 4, data_mask=jnp.asarray(mask),
                    method="chunked")
    assert np.array_equal(np.asarray(ref.indices), np.asarray(out.indices))


def test_chunked_hierarchical_exact(rng):
    """Recall-1.0 vs the exact XLA oracle with enough data for the full
    hierarchical selection (C128 > k: real chunk top-k + sub-chunk top-k).

    The SUB=32 exactness argument (knn_pallas.py module docstring) promises
    the candidate set always contains every true neighbour; indices must
    therefore match the oracle exactly away from ties."""
    q = jnp.asarray(rng.normal(size=(300, 24)))
    x = jnp.asarray(rng.normal(size=(4000, 24)))
    ref = query_knn(q, x, 20, method="exact")
    out = query_knn(q, x, 20, method="chunked")
    assert np.array_equal(np.asarray(ref.indices), np.asarray(out.indices))
    assert np.allclose(np.asarray(ref.distances), np.asarray(out.distances),
                       atol=1e-5)


def test_chunked_fewer_chunks_than_k(rng):
    """Degenerate kc < k: fewer 128-chunks than k — all chunks become
    candidates and the sub-chunk top-k still covers every true neighbour."""
    q = jnp.asarray(rng.normal(size=(64, 8)))
    x = jnp.asarray(rng.normal(size=(1200, 8)))
    ref = query_knn(q, x, 20, method="exact")
    out = query_knn(q, x, 20, method="chunked")
    assert np.array_equal(np.asarray(ref.indices), np.asarray(out.indices))


def test_bf16_high_recall(rng):
    """bf16 candidate selection: near-perfect recall, exact fp32 distances
    for the neighbours it does return."""
    q = rng.normal(size=(64, 8)).astype(np.float32)
    x = rng.normal(size=(2048, 8)).astype(np.float32)
    ref = query_knn(jnp.asarray(q), jnp.asarray(x), 8, method="exact")
    out = query_knn(jnp.asarray(q), jnp.asarray(x), 8, method="bf16")
    ref_i = np.asarray(ref.indices)
    out_i = np.asarray(out.indices)
    recall = np.mean([
        len(set(a) & set(b)) / 8 for a, b in zip(ref_i.tolist(), out_i.tolist())
    ])
    assert recall > 0.9
    # where the selection agrees, distances must agree to fp32 exactness
    agree = ref_i == out_i
    assert np.allclose(
        np.asarray(ref.distances)[agree], np.asarray(out.distances)[agree],
        atol=1e-5,
    )


def test_auto_dispatch(rng):
    """'auto' picks exact for small problems (index-stable result)."""
    q = rng.normal(size=(50, 6))
    x = rng.normal(size=(300, 6))
    ref = query_knn(jnp.asarray(q), jnp.asarray(x), 5, method="exact")
    out = query_knn(jnp.asarray(q), jnp.asarray(x), 5, method="auto")
    assert np.array_equal(np.asarray(ref.indices), np.asarray(out.indices))


def test_chunked_selection_precision(rng):
    """Adversarial near-tie geometry pinning the 3-pass bf16 split.

    Data rows sit on a ray at radii 10 + i*1e-3 with the query at radius 9:
    squared-score gaps between rank-adjacent neighbours are ~2e-3 while the
    score magnitude is ~100, so a single-pass bf16 selection (abs error
    ~100 * 2^-8 ~ 0.4) scrambles the ranking but the chunked path's 3-pass
    hi/lo split (knn_pallas._split_dot) must still match the exact
    oracle."""
    d = 8
    u = rng.normal(size=d)
    u /= np.linalg.norm(u)
    radii = 10.0 + 1e-3 * rng.permutation(1024)
    x = (radii[:, None] * u[None, :]).astype(np.float32)
    q = np.tile((9.0 * u).astype(np.float32), (16, 1))
    ref = query_knn(jnp.asarray(q), jnp.asarray(x), 4, method="exact")
    out = query_knn(jnp.asarray(q), jnp.asarray(x), 4, method="chunked")
    assert np.array_equal(np.asarray(ref.indices), np.asarray(out.indices))
    assert np.allclose(np.asarray(ref.distances), np.asarray(out.distances),
                       atol=1e-5)


def test_chunked_exact_selection_six_pass(rng):
    """query_knn(exact_selection=True) routes the chunked path through IEEE
    fp32 products (knn_pallas._split_dot "f32") and still matches the exact
    oracle on the adversarial near-tie geometry — the opt-in for raw-scale standalone queries whose score
    magnitudes dwarf neighbour gaps."""
    d = 8
    u = rng.normal(size=d)
    u /= np.linalg.norm(u)
    radii = 10.0 + 1e-3 * rng.permutation(1024)
    x = (radii[:, None] * u[None, :]).astype(np.float32)
    q = np.tile((9.0 * u).astype(np.float32), (16, 1))
    ref = query_knn(jnp.asarray(q), jnp.asarray(x), 4, method="exact")
    out = query_knn(jnp.asarray(q), jnp.asarray(x), 4, method="chunked",
                    exact_selection=True)
    assert np.array_equal(np.asarray(ref.indices), np.asarray(out.indices))
    assert np.allclose(np.asarray(ref.distances), np.asarray(out.distances),
                       atol=1e-5)


def test_chunked_query_piecing_scan(rng):
    """The mt_budget query-piecing path (lax.map over equal pieces) is
    exact vs the single-piece path."""
    from batchelor_tpu.ops import knn_pallas as kp

    q = rng.normal(size=(1200, 8)).astype(np.float32)
    x = rng.normal(size=(2600, 8)).astype(np.float32)
    ref = query_knn(jnp.asarray(q), jnp.asarray(x), 5, method="chunked")
    # the plain CPU pass 1 holds 16 * 2816 bytes per query row: ~4 pieces
    budget = 400 * 16 * 2816
    assert -(-1200 // kp.piece_rows(1200, 2600, "plain", budget)) == 4
    out = query_knn(jnp.asarray(q), jnp.asarray(x), 5, method="chunked",
                    mt_budget=budget)
    assert np.array_equal(np.asarray(ref.indices), np.asarray(out.indices))
    assert np.allclose(np.asarray(ref.distances), np.asarray(out.distances))


def test_membership_rows_chunked_matches_flat(rng):
    """membership_rows' transposed block-map (the 2^31-byte-safe carrier
    layout) matches a flat numpy membership oracle across block splits."""
    from batchelor_tpu.ops.mutual_nn import membership_rows

    n1, n2, k1, k2 = 337, 251, 4, 5
    l2r = rng.integers(0, n2, size=(n1, k2)).astype(np.int32)
    r2l = rng.integers(0, n1, size=(n2, k1)).astype(np.int32)
    ids = np.arange(n1, dtype=np.int32)
    want = np.zeros((n1, k2), dtype=bool)
    for i in range(n1):
        for p in range(k2):
            want[i, p] = i in r2l[l2r[i, p]]
    for chunk in (64, 128, n1):
        got = np.asarray(membership_rows(
            jnp.asarray(l2r), jnp.asarray(r2l), jnp.asarray(ids),
            chunk=chunk,
        ))
        assert np.array_equal(got, want)


@pytest.mark.parametrize("mode", ["split3", "f32", "bf16"])
@pytest.mark.parametrize("d0", [8, 50, 62])
@pytest.mark.parametrize("nq,nd", [(128, 512), (100, 300)])
def test_pass1_kernel_interpret_matches_plain(rng, nq, nd, d0, mode):
    """The Pallas pass-1 kernel (interpret mode) equals the plain-XLA
    version on block-aligned and padded shapes, each precision mode."""
    from batchelor_tpu.ops import knn_pallas as kp

    q = jnp.asarray(rng.normal(size=(nq, d0)).astype(np.float32))
    x = jnp.asarray(rng.normal(size=(nd, d0)).astype(np.float32))
    valid = jnp.asarray(np.arange(nd) < nd - 7)
    dp = kp._feature_pad(d0)
    xf = kp._fold_data(x, valid, dp, mode)
    qf = kp._fold_query(kp._pad_axis(q, kp.BQ, 0), dp, mode)
    got = kp.subchunk_max_kernel(qf, xf, mode, interpret=True)
    want = kp.subchunk_max_plain(qf, xf, mode)
    assert got.shape == (qf.shape[0], xf.shape[0] // kp.SUB)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-6, atol=1e-5)
    # each sub-chunk max is 2 q.x - ||x||^2 of its best valid row
    s = 2.0 * np.asarray(q, np.float64) @ np.asarray(x, np.float64).T
    s -= np.sum(np.square(np.asarray(x, np.float64)), axis=1)[None, :]
    s[:, nd - 7:] = -np.inf
    s = np.pad(s, ((0, 0), (0, xf.shape[0] - nd)), constant_values=-np.inf)
    ref = s.reshape(nq, -1, kp.SUB).max(axis=2)
    live = np.isfinite(ref)
    tol = 0.05 if mode == "bf16" else 1e-3
    np.testing.assert_allclose(np.asarray(got)[:nq][live], ref[live],
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("platform,impl", [("gpu", "kernel"), ("cpu", "plain")])
def test_pass1_dispatch_by_platform(platform, impl):
    from batchelor_tpu.ops import knn_pallas as kp

    assert kp.pass1_impl(platform) == impl


@pytest.mark.parametrize("platform", ["rocm", "METAL", "neuron"])
def test_pass1_dispatch_rejects_other_platforms(platform):
    from batchelor_tpu.ops import knn_pallas as kp

    with pytest.raises(ValueError, match="no two-pass kNN"):
        kp.pass1_impl(platform)


def test_auto_is_exact_on_cpu():
    """Here the default device is a CPU, so even a search far above the
    two-pass threshold resolves "auto" to the tiled path, and the two-pass
    search runs its plain pass 1."""
    import jax

    from batchelor_tpu.ops import knn, knn_pallas as kp

    big = jax.ShapeDtypeStruct((200_000, 50), jnp.float32)
    assert kp.target_platform() == "cpu"
    assert knn._auto_method(big, big, 20) == "exact"
    with jax.default_device(jax.devices("cpu")[0]):
        assert kp.target_platform() == "cpu"


@pytest.mark.parametrize("impl,row_bytes", [("kernel", 4 * 100_096 // 32),
                                            ("plain", 16 * 100_096)])
def test_piece_rows_bounds_pass1_buffer(impl, row_bytes):
    """Pieces are equal, BQ-aligned, cover every query, and keep one
    pass-1 buffer under the budget (or at the one-block minimum)."""
    from batchelor_tpu.ops import knn_pallas as kp

    nq, nd = 100_000, 100_000
    for budget in (1 << 20, 256 << 20, 8 << 30):
        rows = kp.piece_rows(nq, nd, impl, budget)
        assert rows % kp.BQ == 0
        assert rows * -(-nq // rows) >= nq
        assert rows * row_bytes <= max(budget, kp.BQ * row_bytes)
    assert kp.piece_rows(nq, nd, impl, 1 << 40) == -(-nq // kp.BQ) * kp.BQ


@pytest.mark.gpu
def test_pass1_kernel_compiled_matches_plain(gpu_device):
    """The compiled Triton kernel against the plain version on the card,
    at the widths a merge step uses (d=50, 100k data rows)."""
    from batchelor_tpu.ops import knn_pallas as kp

    rng = np.random.default_rng(0)
    q = jnp.asarray(rng.normal(size=(4096, 50)).astype(np.float32))
    x = jnp.asarray(rng.normal(size=(100_000, 50)).astype(np.float32))
    valid = jnp.ones((100_000,), bool)
    dp = kp._feature_pad(50)
    exact = None
    for mode in ("f32", "split3", "bf16"):
        xf = kp._fold_data(x, valid, dp, mode)
        qf = kp._fold_query(q, dp, mode)
        got = np.asarray(kp.subchunk_max_kernel(qf, xf, mode))
        want = np.asarray(kp.subchunk_max_plain(qf, xf, mode))
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)
        exact = got if exact is None else exact
        # the split keeps ~16 bits; one bf16 product keeps ~8
        err = np.abs(got - exact).max() / np.abs(exact).max()
        assert err <= {"f32": 0.0, "split3": 2.0**-14, "bf16": 2.0**-6}[mode]
