"""BSR block-dense SpMM vs dense ground truth (CPU)."""

import numpy as np
import pytest

import spmv_tpu
from spmv_tpu.formats.bsr import BSRMatrix


def _mat(nrows=300, ncols=260, nnz=6000, seed=2):
    rng = np.random.default_rng(seed)
    r = rng.integers(0, nrows, nnz)
    c = rng.integers(0, ncols, nnz)
    v = rng.standard_normal(nnz)
    A = np.zeros((nrows, ncols))
    np.add.at(A, (r, c), v)  # duplicates sum, like the format
    return r, c, v, A


def test_matmat_matches_dense():
    r, c, v, A = _mat()
    a = spmv_tpu.from_coo("bsr", *A.shape, r, c, v)
    X = np.random.default_rng(1).standard_normal((A.shape[1], 16)).astype(np.float32)
    Y = np.asarray(a.matmat(X))
    np.testing.assert_allclose(Y, A @ X, rtol=2e-4, atol=2e-4)


def test_matvec_and_operator():
    r, c, v, A = _mat(nnz=4000)
    a = spmv_tpu.from_coo("bsr", *A.shape, r, c, v)
    x = np.random.default_rng(3).standard_normal(A.shape[1]).astype(np.float32)
    np.testing.assert_allclose(np.asarray(a.matvec(x)), A @ x,
                               rtol=2e-4, atol=2e-4)
    Y = np.asarray(a @ x.reshape(-1, 1))
    assert Y.shape == (A.shape[0], 1)


def test_fill_guard():
    # hypersparse at material scale: one nnz per diagonal tile
    n = 128 * 300  # 300 tiles -> ~1.9 GB dense if admitted
    diag = np.arange(0, n, 128)
    with pytest.raises(ValueError, match="block density"):
        BSRMatrix.from_coo(n, n, diag, diag, np.ones(diag.size),
                           max_fill=64.0)
    # tiny matrices are admitted regardless of fill (dense bytes immaterial)
    a = BSRMatrix.from_coo(1000, 1000, [0, 400, 900], [0, 400, 900],
                           [1.0, 1.0, 1.0])
    x = np.ones(1000, np.float32)
    y = np.asarray(a.matvec(x))
    assert y[0] == 1.0 and y[400] == 1.0 and y[900] == 1.0


def test_empty():
    a = BSRMatrix.from_coo(10, 10, [], [], [])
    assert np.asarray(a.matvec(np.ones(10, np.float32))).shape == (10,)


def test_spmm_helper_all_formats():
    r, c, v, A = _mat(nrows=400, ncols=300, nnz=3500, seed=4)
    X = np.random.default_rng(1).standard_normal((A.shape[1], 5)).astype(np.float32)
    for fmt in ("ell", "csr", "bsr"):
        a = spmv_tpu.from_coo(fmt, A.shape[0], A.shape[1], r, c, v)
        Y = np.asarray(spmv_tpu.spmm(a, X))
        assert Y.shape == (A.shape[0], 5)
        np.testing.assert_allclose(Y, A @ X, rtol=2e-4, atol=2e-4)


def test_spmm_fused_multi_rhs_all_formats():
    """One device pass gathers whole rows of X for every format;
    power-law forces the interesting container shapes (HYB panel + spill,
    SELL's σ-sort undone per column)."""
    from spmv_tpu import synth

    info, r, c, v = synth.power_law(n=2048, avg_nnz_per_row=12,
                                    bandwidth=256, seed=2)
    A = np.zeros((info.nrows, info.ncols))
    A[r, c] = v
    cases = [(2, ("csr", "coo", "cmrs", "ell", "sell", "hyb")),
             (8, ("csr", "ell"))]
    for R, fmts in cases:
        X = np.random.default_rng(R).standard_normal(
            (info.ncols, R)).astype(np.float32)
        for fmt in fmts:
            a = spmv_tpu.from_coo(fmt, info.nrows, info.ncols, r, c, v)
            Y = np.asarray(spmv_tpu.spmm(a, X))
            assert Y.shape == (info.nrows, R), (fmt, Y.shape)
            ref = A @ X
            err = np.abs(Y - ref).max() / max(np.abs(ref).max(), 1.0)
            assert err < 2e-3, (fmt, R, err)


def test_spmm_beyond_multi_rhs_max_falls_back():
    """R = 17 — past the old fused-kernel limit of 8 — runs the same
    single pass and matches the dense product."""
    r, c, v, A = _mat(nrows=350, ncols=280, nnz=2500, seed=6)
    a = spmv_tpu.from_coo("csr", A.shape[0], A.shape[1], r, c, v)
    X = np.random.default_rng(0).standard_normal(
        (A.shape[1], 17)).astype(np.float32)
    Y = np.asarray(spmv_tpu.spmm(a, X))
    assert Y.shape == (A.shape[0], 17)
    np.testing.assert_allclose(Y, A @ X, rtol=2e-4, atol=2e-4)
