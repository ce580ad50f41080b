"""Symmetric triangle storage (spmv_tpu/sym.py): y = (L+D)x + L^T x must
match the oracle of the EXPANDED operator (round-5 verdict item 6)."""

import numpy as np
import pytest

import spmv_tpu
from spmv_tpu import synth
from spmv_tpu.oracle import check_result, fp32_rel_tol, golden_spmv
from spmv_tpu.sym import SymmetricMatrix


def _sym_triangle(n=900, seed=3):
    """Lower triangle of a symmetrized FEM-proxy matrix."""
    info, r, c, v = synth.synthetic_cant(n=n, avg_nnz_per_row=12,
                                         bandwidth=60, seed=seed)
    keep = r >= c
    return n, r[keep], c[keep], v[keep]


def _expand(r, c, v):
    s = r > c
    return (np.concatenate([r, c[s]]), np.concatenate([c, r[s]]),
            np.concatenate([v, v[s]]))


def test_sym_matches_expanded_oracle():
    n, r, c, v = _sym_triangle()
    a = SymmetricMatrix.from_coo(n, n, r, c, v)
    x = np.random.default_rng(0).standard_normal(n).astype(np.float32)
    er, ec, ev = _expand(r, c, v)
    expected = golden_spmv(n, er, ec, ev, x)
    scale = golden_spmv(n, er, ec, np.abs(ev), np.abs(x))
    rep = check_result(expected, np.asarray(a.matvec(x)), tol_abs=1e-5,
                       scale=scale, tol_rel=fp32_rel_tol(
                           int(np.bincount(er, minlength=n).max())))
    assert rep.ok, str(rep)
    assert a.nnz == er.size
    assert a.stored_nnz == r.size


def test_sym_via_api_and_upper_fold():
    n, r, c, v = _sym_triangle(n=500, seed=5)
    # pass the UPPER triangle — from_coo folds it onto the lower
    a = spmv_tpu.from_coo("sym", n, n, c, r, v)
    x = np.random.default_rng(1).standard_normal(n).astype(np.float32)
    er, ec, ev = _expand(r, c, v)
    expected = golden_spmv(n, er, ec, ev, x)
    assert np.abs(np.asarray(a.matvec(x)) - expected).max() < 1e-2


def test_sym_to_coo_expands():
    n, r, c, v = _sym_triangle(n=300, seed=7)
    a = SymmetricMatrix.from_coo(n, n, r, c, v)
    rr, cc, vv = a.to_coo()
    er, ec, ev = _expand(r, c, v)
    A = np.zeros((n, n))
    A[er, ec] = ev
    B = np.zeros((n, n))
    B[rr, cc] = vv
    np.testing.assert_allclose(A, B)
    assert (B == B.T).all()


def test_sym_diag_only_and_empty():
    n = 40
    d = np.arange(n)
    a = SymmetricMatrix.from_coo(n, n, d, d, np.linspace(1, 2, n))
    x = np.random.default_rng(2).standard_normal(n).astype(np.float32)
    np.testing.assert_allclose(np.asarray(a.matvec(x)),
                               np.linspace(1, 2, n) * x, rtol=1e-5)
    e = SymmetricMatrix.from_coo(5, 5, [], [], [])
    assert (np.asarray(e.matvec(np.ones(5))) == 0).all()


def test_sym_rejects_rectangular():
    with pytest.raises(ValueError):
        SymmetricMatrix.from_coo(4, 6, [0], [0], [1.0])


def test_sym_spmm_fused():
    n, r, c, v = _sym_triangle(n=400, seed=9)
    a = SymmetricMatrix.from_coo(n, n, r, c, v)
    X = np.random.default_rng(3).standard_normal((n, 4)).astype(np.float32)
    er, ec, ev = _expand(r, c, v)
    A = np.zeros((n, n))
    A[er, ec] = ev
    Y = np.asarray(spmv_tpu.spmm(a, X))
    assert np.abs(Y - A @ X).max() < 1e-2
