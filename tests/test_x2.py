"""Extended-precision (f32x2) containers vs the fp64 oracle at the
reference's abs 1e-6 EPSILON (``inc/helper_functions.h:11``) — the
precision class the all-fp64 reference computes in (``coo.c:39-42``),
which plain fp32 device compute misses by orders of magnitude."""

import numpy as np
import pytest

from spmv_tpu import synth
from spmv_tpu.x2 import X2_FORMATS, X2Matrix


def _case(n=1024, seed=5):
    info, r, c, v = synth.synthetic_cant(n=n, avg_nnz_per_row=16,
                                         bandwidth=60, seed=seed)
    # values with fp64-only mantissa content — f32 casting must not win
    v = np.asarray(v, np.float64) * (1 + 1e-9 * np.arange(v.size))
    x = np.random.default_rng(seed + 1).standard_normal(info.ncols)
    A = np.zeros((info.nrows, info.ncols))
    A[r, c] = v
    return info, r, c, v, x, A @ x


@pytest.mark.parametrize("fmt", sorted(set(X2_FORMATS) - {"sell_c_sigma"}))
def test_x2_matvec_epsilon(fmt):
    info, r, c, v, x, yref = _case()
    a = X2Matrix.from_coo(fmt, info.nrows, info.ncols, r, c, v)
    y = a.matvec(x)
    err = np.abs(y - yref).max()
    assert err < 1e-6, f"{fmt}: abs err {err:.3e} over the reference EPSILON"
    # and genuinely beyond fp32: the fp32 formats land ~1e-4 here
    assert err < 1e-8, f"{fmt}: abs err {err:.3e} not fp64 grade"


def test_x2_beats_f32():
    import spmv_tpu

    info, r, c, v, x, yref = _case(seed=9)
    a32 = spmv_tpu.from_coo("csr", info.nrows, info.ncols, r, c, v)
    ax2 = X2Matrix.from_coo("csr", info.nrows, info.ncols, r, c, v)
    e32 = np.abs(np.asarray(a32.matvec(x.astype(np.float32)),
                            np.float64) - yref).max()
    ex2 = np.abs(ax2.matvec(x) - yref).max()
    assert ex2 < e32 / 100, (ex2, e32)


def test_x2_scattered_and_sell_epilogue():
    info, r, c, v = synth.power_law(n=2048, avg_nnz_per_row=10,
                                    bandwidth=600, seed=3)
    v = np.asarray(v, np.float64) * (1 + 1e-10 * np.arange(v.size))
    x = np.random.default_rng(4).standard_normal(info.ncols)
    A = np.zeros((info.nrows, info.ncols))
    A[r, c] = v
    yref = A @ x
    for fmt in ("csr", "sell"):
        a = X2Matrix.from_coo(fmt, info.nrows, info.ncols, r, c, v)
        err = np.abs(a.matvec(x) - yref).max()
        assert err < 1e-6, f"{fmt}: {err:.3e}"


def test_x2_rejects_bsr():
    # BSR stays fp32-only (its point is dense-tile matrix-unit throughput)
    with pytest.raises(ValueError):
        X2Matrix.from_coo("bsr", 8, 8, [0], [0], [1.0])


def test_x2_hyb_two_part():
    """f32x2 HYB with a genuine panel + spill partition: both parts carry
    (hi, lo) planes and the sum stays fp64 grade."""
    info, r, c, v = synth.power_law(n=8192, avg_nnz_per_row=12,
                                    bandwidth=256, seed=3)
    v = np.asarray(v, np.float64) * (1 + 1e-9 * np.arange(v.size))
    from spmv_tpu.formats.hyb import HybMatrix

    h = HybMatrix.from_coo(info.nrows, info.ncols, r, c, v)
    assert h.panel_nnz > 0 and h.spill_nnz > 0, "no two-part split"
    a = X2Matrix.from_coo("hyb", info.nrows, info.ncols, r, c, v)
    x = np.random.default_rng(11).standard_normal(info.ncols)
    A = np.zeros((info.nrows, info.ncols))
    A[r, c] = v
    err = np.abs(a.matvec(x) - A @ x).max()
    assert err < 1e-8, f"two-part x2 hyb abs err {err:.3e}"
