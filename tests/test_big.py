"""Slab x panel tiled container on one device."""

import numpy as np
import pytest

import spmv_tpu
from spmv_tpu import synth
from spmv_tpu.big import TiledSpmv
from spmv_tpu.oracle import check_result, golden_spmv


def _data(n=3000, seed=2):
    info, r, c, v = synth.synthetic_cant(n=n, avg_nnz_per_row=9,
                                         bandwidth=50, seed=seed)
    x = np.random.default_rng(seed + 1).standard_normal(
        info.ncols).astype(np.float32)
    return info, r, c, v, x


@pytest.mark.parametrize("fmt", ["csr", "coo", "cmrs", "ell", "sell", "hyb"])
def test_tiled_matches_oracle(fmt):
    info, r, c, v, x = _data()
    a = TiledSpmv(fmt, info.nrows, info.ncols, r, c, v,
                  slab_rows=1024, panel_cols=1024)
    assert a.DR == 3 and a.DC == 3
    rep = check_result(golden_spmv(info.nrows, r, c, v, x),
                       a.matvec(x), tol_abs=1e-4, tol_rel=1e-4,
                       scale=golden_spmv(info.nrows, r, c, np.abs(v),
                                         np.abs(x)))
    assert rep.ok, f"{fmt}: {rep}"


def test_tiled_matches_single_kernel():
    info, r, c, v, x = _data(n=1500, seed=7)
    single = spmv_tpu.from_coo("csr", info.nrows, info.ncols, r, c, v)
    tiled = TiledSpmv("csr", info.nrows, info.ncols, r, c, v,
                      slab_rows=512, panel_cols=512)
    np.testing.assert_allclose(np.asarray(single.matvec(x)),
                               tiled.matvec(x), atol=1e-4, rtol=1e-4)


def test_tiled_skips_empty_tiles():
    """Block-diagonal matrix: off-diagonal tiles must not exist (no plan
    arrays, no dispatches) — a 4Mx4M band matrix would otherwise spend
    most of its time on empty off-band tiles."""
    info, r, c, v, x = _data(n=3072, seed=5)
    # band 50 around the diagonal: with 1024-square tiles, only the
    # diagonal (and corner-adjacent) tiles are occupied
    a = TiledSpmv("csr", info.nrows, info.ncols, r, c, v,
                  slab_rows=1024, panel_cols=1024)
    assert a.DR == 3 and a.DC == 3
    # the band only touches tiles adjacent to the diagonal (7 of 9);
    # the 2 far corners must not exist
    assert a.n_tiles <= 7 < a.DR * a.DC
    assert int(a.nvalid.sum()) == a.n_tiles
    rep = check_result(golden_spmv(info.nrows, r, c, v, x),
                       a.matvec(x), tol_abs=1e-4, tol_rel=1e-4,
                       scale=golden_spmv(info.nrows, r, c, np.abs(v),
                                         np.abs(x)))
    assert rep.ok, str(rep)


def test_tiled_chained_loop_and_traffic():
    """The bench hooks: the tiled container's chained product loop keeps
    y = A·x, and the traffic model counts every nonempty tile's arrays
    exactly once."""
    from spmv_tpu.bench.runner import _chained_loop, traffic_model
    from spmv_tpu.device import nbytes

    info, r, c, v, x = _data(n=2048, seed=8)
    a = TiledSpmv("csr", info.nrows, info.ncols, r, c, v,
                  slab_rows=1024, panel_cols=1024)
    out, y = _chained_loop(a.dev, 2)(x)
    # only x[0] moves, by ~1e-38·y[0]; the whole last product comes back
    np.testing.assert_array_equal(np.asarray(out)[1:], x[1:])
    np.testing.assert_allclose(np.asarray(y), np.asarray(a.matvec(x)),
                               rtol=1e-5, atol=1e-5)
    Y = np.asarray(a.matmat(np.stack([x, 2 * x], axis=1)))
    np.testing.assert_allclose(Y[:, 1], 2 * np.asarray(a.matvec(x)),
                               rtol=1e-5, atol=1e-5)
    slots, total = traffic_model(a)
    assert slots == a.nnz  # CSR tiles carry no padding
    assert total == sum(nbytes(t) for t in a.dev.tiles) + 4 * (
        a.nrows + a.ncols)
