"""Multi-device SpMV on the 8-way CPU mesh (the reference has no
distribution; this is the framework's scaling dimension)."""

import numpy as np
import pytest

from spmv_tpu import synth
from spmv_tpu.dist.mesh import make_mesh
from spmv_tpu.dist.sharded import ColShardedSpmv, RowShardedSpmv
from spmv_tpu.oracle import check_result, golden_spmv


@pytest.fixture(scope="module")
def mesh():
    import jax

    assert len(jax.devices()) >= 8, "conftest must force 8 CPU devices"
    return make_mesh(8)


def _data(n=700, seed=4):
    info, r, c, v = synth.synthetic_cant(n=n, avg_nnz_per_row=10,
                                         bandwidth=50, seed=seed)
    rng = np.random.default_rng(seed + 1)
    x = rng.standard_normal(info.ncols).astype(np.float32)
    return info, r, c, v, x


@pytest.mark.parametrize("fmt", ["csr", "coo", "cmrs", "ell", "sell", "hyb"])
@pytest.mark.parametrize("gather_x", [True, False])
def test_row_sharded(mesh, fmt, gather_x):
    info, r, c, v, x = _data()
    a = RowShardedSpmv(fmt, info.nrows, info.ncols, r, c, v, mesh,
                       gather_x=gather_x)
    y = np.asarray(a.matvec(x))
    rep = check_result(golden_spmv(info.nrows, r, c, v, x), y,
                       tol_abs=1e-4, tol_rel=1e-4,
                       scale=golden_spmv(info.nrows, r, c, np.abs(v), np.abs(x)))
    assert rep.ok, f"{fmt} gather_x={gather_x}: {rep}"


@pytest.mark.parametrize("fmt", ["csr", "ell", "sell", "hyb"])
def test_col_sharded(mesh, fmt):
    info, r, c, v, x = _data(n=900, seed=6)
    a = ColShardedSpmv(fmt, info.nrows, info.ncols, r, c, v, mesh)
    y = np.asarray(a.matvec(x))
    rep = check_result(golden_spmv(info.nrows, r, c, v, x), y,
                       tol_abs=1e-4, tol_rel=1e-4,
                       scale=golden_spmv(info.nrows, r, c, np.abs(v), np.abs(x)))
    assert rep.ok, f"{fmt}: {rep}"


def test_row_sharded_matches_single_chip(mesh):
    import spmv_tpu

    info, r, c, v, x = _data(n=500, seed=8)
    single = spmv_tpu.from_coo("csr", info.nrows, info.ncols, r, c, v)
    multi = RowShardedSpmv("csr", info.nrows, info.ncols, r, c, v, mesh)
    np.testing.assert_allclose(
        np.asarray(single.matvec(x)), np.asarray(multi.matvec(x)),
        atol=1e-4, rtol=1e-4)


def test_mesh_smaller_than_devices(mesh):
    info, r, c, v, x = _data(n=300, seed=2)
    m2 = make_mesh(2)
    a = RowShardedSpmv("cmrs", info.nrows, info.ncols, r, c, v, m2)
    rep = check_result(golden_spmv(info.nrows, r, c, v, x),
                       np.asarray(a.matvec(x)), tol_abs=1e-4, tol_rel=1e-4,
                       scale=golden_spmv(info.nrows, r, c, np.abs(v), np.abs(x)))
    assert rep.ok, str(rep)


def test_weak_scaling_harness(mesh):
    # Structure/plumbing test on the CPU mesh; the report names the device.
    from spmv_tpu.bench.scaling import weak_scaling_report

    rep = weak_scaling_report(format="cmrs", rows_per_device=256,
                              avg_nnz_per_row=6, bandwidth=30,
                              device_counts=[1, 2], iters=2, repeats=1)
    assert rep["device"]["platform"] == "cpu"
    assert [p["devices"] for p in rep["points"]] == [1, 2]
    assert rep["points"][0]["efficiency"] == 1.0
    assert rep["points"][1]["nrows"] == 2 * rep["points"][0]["nrows"]
    assert all(p["ms_per_spmv"] > 0 for p in rep["points"])


@pytest.mark.parametrize("fmt", ["csr", "cmrs", "ell", "sell", "hyb"])
def test_ring_sharded(mesh, fmt):
    from spmv_tpu.dist.ring import RingShardedSpmv

    info, r, c, v, x = _data(n=900, seed=12)
    a = RingShardedSpmv(fmt, info.nrows, info.ncols, r, c, v, mesh)
    y = np.asarray(a.matvec(x))
    rep = check_result(golden_spmv(info.nrows, r, c, v, x), y,
                       tol_abs=1e-4, tol_rel=1e-4,
                       scale=golden_spmv(info.nrows, r, c, np.abs(v), np.abs(x)))
    assert rep.ok, f"ring {fmt}: {rep}"


def test_sharded_unsupported_rejected(mesh):
    """Column/ring BSR (a dense-Y collective per step) gets the intended
    NotImplementedError instead of a late AttributeError crash; row BSR
    is supported (test_row_sharded_bsr_spmm)."""
    from spmv_tpu.dist.ring import RingShardedSpmv

    info, r, c, v, x = _data(n=300, seed=1)
    for wrapper in (ColShardedSpmv, RingShardedSpmv):
        with pytest.raises(NotImplementedError):
            wrapper("bsr", info.nrows, info.ncols, r, c, v, mesh)


@pytest.mark.parametrize("gather_x", [True, False])
def test_row_sharded_bsr_spmm(mesh, gather_x):
    """Row-sharded BSR (round-3 verdict item 8): block rows shard
    trivially; per-shard batched tile matmul + segment-sum, X replicated
    or all-gathered.  Ragged rows (nrows % D != 0) and matvec parity."""
    info, r, c, v, x = _data(n=1100, seed=5)  # 1100 % 8 != 0
    a = RowShardedSpmv("bsr", info.nrows, info.ncols, r, c, v, mesh,
                       gather_x=gather_x)
    rng = np.random.default_rng(11)
    X = rng.standard_normal((info.ncols, 5)).astype(np.float32)
    Y = np.asarray(a.spmm(X))
    assert Y.shape == (info.nrows, 5)
    for j in range(5):
        exp = golden_spmv(info.nrows, r, c, v, X[:, j])
        sc = golden_spmv(info.nrows, r, c, np.abs(v), np.abs(X[:, j]))
        rep = check_result(exp, Y[:, j], tol_abs=1e-4, tol_rel=1e-4,
                           scale=sc)
        assert rep.ok, f"bsr col {j}: {rep}"
    y = np.asarray(a.matvec(x))
    exp = golden_spmv(info.nrows, r, c, v, x)
    sc = golden_spmv(info.nrows, r, c, np.abs(v), np.abs(x))
    rep = check_result(exp, y, tol_abs=1e-4, tol_rel=1e-4, scale=sc)
    assert rep.ok, f"bsr matvec: {rep}"


def test_row_sharded_spmm(mesh):
    """Row-sharded multi-RHS: per-shard matmat, each column sharded like
    matvec."""
    info, r, c, v, x = _data(n=500, seed=9)
    rng = np.random.default_rng(10)
    X = rng.standard_normal((info.ncols, 3)).astype(np.float32)
    a = RowShardedSpmv("csr", info.nrows, info.ncols, r, c, v, mesh)
    Y = np.asarray(a.spmm(X))
    assert Y.shape == (info.nrows, 3)
    for j in range(3):
        rep = check_result(golden_spmv(info.nrows, r, c, v, X[:, j]),
                           Y[:, j], tol_abs=1e-4, tol_rel=1e-4,
                           scale=golden_spmv(info.nrows, r, c, np.abs(v),
                                             np.abs(X[:, j])))
        assert rep.ok, f"column {j}: {rep}"


def _x2_data(n=700, seed=21):
    """fp64-only mantissa content so an f32 cast cannot match the oracle."""
    info, r, c, v = synth.synthetic_cant(n=n, avg_nnz_per_row=10,
                                         bandwidth=50, seed=seed)
    v = np.asarray(v, np.float64) * (1 + 1e-9 * np.arange(v.size))
    x = np.random.default_rng(seed + 1).standard_normal(info.ncols)
    A = np.zeros((info.nrows, info.ncols))
    A[r, c] = v
    return info, r, c, v, x, A @ x


@pytest.mark.parametrize("fmt", ["csr", "cmrs", "ell", "sell"])
@pytest.mark.parametrize("gather_x", [True, False])
def test_row_sharded_x2(mesh, fmt, gather_x):
    """Row-sharded f32x2 matches the fp64 oracle far beyond the
    reference's abs 1e-6 EPSILON (row partition: no cross-shard sums, so
    accuracy equals the single-device X2Matrix)."""
    info, r, c, v, x, yref = _x2_data()
    a = RowShardedSpmv(fmt, info.nrows, info.ncols, r, c, v, mesh,
                       gather_x=gather_x, dtype="f32x2")
    err = np.abs(np.asarray(a.matvec(x)) - yref).max()
    assert err < 1e-8, f"{fmt} gather_x={gather_x}: abs err {err:.3e}"


@pytest.mark.parametrize("fmt", ["csr", "coo", "ell", "sell"])
def test_col_sharded_x2(mesh, fmt):
    """Column-sharded f32x2: the partial ys are fp64 and the cross-shard
    psum adds them in fp64, so the result stays fp64 grade."""
    info, r, c, v, x, yref = _x2_data(n=900, seed=23)
    a = ColShardedSpmv(fmt, info.nrows, info.ncols, r, c, v, mesh,
                       dtype="f32x2")
    err = np.abs(np.asarray(a.matvec(x)) - yref).max()
    assert err < 1e-8, f"{fmt}: abs err {err:.3e}"


def test_sharded_x2_rejects_bad_dtype(mesh):
    info, r, c, v, x, _ = _x2_data(n=300, seed=2)
    with pytest.raises(ValueError):
        RowShardedSpmv("csr", info.nrows, info.ncols, r, c, v, mesh,
                       dtype="f64")
    with pytest.raises(NotImplementedError):
        RowShardedSpmv("bsr", info.nrows, info.ncols, r, c, v, mesh,
                       dtype="f32x2")


def test_row_sharded_sell_sigma_padded_shards(mesh):
    """Regression: 1536 rows/shard with σ=1024 pads each shard's sort to
    2048 rows; every real row must come back from the unpermute gather
    (an earlier layout corrupted every row ≥ 1024 within each shard)."""
    info, r, c, v = synth.synthetic_cant(n=12288, avg_nnz_per_row=8,
                                         bandwidth=60, seed=3)
    x = np.random.default_rng(1).standard_normal(info.ncols).astype(np.float32)
    yref = golden_spmv(info.nrows, r, c, v, x)
    a = RowShardedSpmv("sell", info.nrows, info.ncols, r, c, v, mesh)
    rep = check_result(yref, np.asarray(a.matvec(x)), tol_abs=1e-4,
                       tol_rel=1e-4,
                       scale=golden_spmv(info.nrows, r, c, np.abs(v),
                                         np.abs(x)))
    assert rep.ok, str(rep)
    # and the f32x2 path at the same shape
    v64 = np.asarray(v, np.float64) * (1 + 1e-9 * np.arange(v.size))
    yref64 = golden_spmv(info.nrows, r, c, v64, x.astype(np.float64))
    a2 = RowShardedSpmv("sell", info.nrows, info.ncols, r, c, v64, mesh,
                        dtype="f32x2")
    err = np.abs(np.asarray(a2.matvec(x.astype(np.float64))) - yref64).max()
    assert err < 1e-6, f"x2 abs err {err:.3e}"


@pytest.mark.parametrize("fmt", ["csr", "sell", "hyb"])
def test_row_sharded_fused_spmm(mesh, fmt):
    """Row-sharded SpMM: ONE x all-gather and one per-shard pass serve
    all R columns, for small and large R alike."""
    from spmv_tpu import synth

    info, r, c, v = synth.power_law(n=1024, avg_nnz_per_row=10,
                                    bandwidth=256, seed=5)
    A = np.zeros((info.nrows, info.ncols))
    A[r, c] = v
    a = RowShardedSpmv(fmt, info.nrows, info.ncols, r, c, v, mesh,
                       gather_x=True)
    for R in (3, 9):
        X = np.random.default_rng(R).standard_normal(
            (info.ncols, R)).astype(np.float32)
        Y = np.asarray(a.spmm(X))
        ref = A @ X
        assert Y.shape == ref.shape
        err = np.abs(Y - ref).max() / max(np.abs(ref).max(), 1.0)
        assert err < 2e-3, (fmt, R, err)


@pytest.mark.parametrize("fmt", ["csr", "sell", "hyb"])
def test_col_sharded_fused_spmm(mesh, fmt):
    """Column-sharded SpMM: one per-shard pass + ONE psum for all R
    columns."""
    from spmv_tpu import synth

    info, r, c, v = synth.power_law(n=1024, avg_nnz_per_row=10,
                                    bandwidth=256, seed=6)
    A = np.zeros((info.nrows, info.ncols))
    A[r, c] = v
    a = ColShardedSpmv(fmt, info.nrows, info.ncols, r, c, v, mesh)
    X = np.random.default_rng(1).standard_normal(
        (info.ncols, 3)).astype(np.float32)
    Y = np.asarray(a.spmm(X))
    ref = A @ X
    assert Y.shape == ref.shape
    err = np.abs(Y - ref).max() / max(np.abs(ref).max(), 1.0)
    assert err < 2e-3, (fmt, err)


@pytest.mark.parametrize("fmt", ["csr", "sell", "hyb"])
def test_ring_sharded_fused_spmm(mesh, fmt):
    """Ring-sharded SpMM: all R columns' x blocks rotate as ONE ring
    carry — D ppermutes instead of R·D."""
    from spmv_tpu import synth
    from spmv_tpu.dist.ring import RingShardedSpmv

    info, r, c, v = synth.power_law(n=1024, avg_nnz_per_row=10,
                                    bandwidth=256, seed=7)
    A = np.zeros((info.nrows, info.ncols))
    A[r, c] = v
    a = RingShardedSpmv(fmt, info.nrows, info.ncols, r, c, v, mesh)
    X = np.random.default_rng(2).standard_normal(
        (info.ncols, 3)).astype(np.float32)
    Y = np.asarray(a.spmm(X))
    ref = A @ X
    assert Y.shape == ref.shape
    err = np.abs(Y - ref).max() / max(np.abs(ref).max(), 1.0)
    assert err < 2e-3, (fmt, err)


@pytest.mark.parametrize("fmt", ["csr", "cmrs", "ell", "sell", "hyb"])
def test_chunked_gather_overlap(mesh, fmt):
    """The chunked-gather overlapped form of the row partition — C
    per-chunk all-gathers interleaved with per-chunk compute — must
    match the oracle like the monolithic-gather form."""
    from spmv_tpu.dist.overlap import ChunkedRowSpmv

    info, r, c, v, x = _data(n=900, seed=17)
    a = ChunkedRowSpmv(fmt, info.nrows, info.ncols, r, c, v, mesh,
                       chunks=2)
    y = np.asarray(a.matvec(x))
    rep = check_result(golden_spmv(info.nrows, r, c, v, x), y,
                       tol_abs=1e-4, tol_rel=1e-4,
                       scale=golden_spmv(info.nrows, r, c, np.abs(v),
                                         np.abs(x)))
    assert rep.ok, f"{fmt}: {rep}"


def test_chunked_gather_matches_row_sharded(mesh):
    from spmv_tpu.dist.overlap import ChunkedRowSpmv

    info, r, c, v, x = _data(n=500, seed=19)
    base = RowShardedSpmv("csr", info.nrows, info.ncols, r, c, v, mesh)
    ovl = ChunkedRowSpmv("csr", info.nrows, info.ncols, r, c, v, mesh,
                         chunks=4)
    np.testing.assert_allclose(
        np.asarray(base.matvec(x)), np.asarray(ovl.matvec(x)),
        atol=1e-4, rtol=1e-4)
