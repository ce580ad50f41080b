"""Every format's device product vs the golden oracle — the reference's
check_result discipline (helper_functions.h:184-236) plus the edge cases
where the reference harbors latent bugs (SURVEY.md §2.2)."""

import numpy as np
import pytest

import spmv_tpu
from spmv_tpu import synth
from spmv_tpu.oracle import check_result, fp32_check, fp32_rel_tol, golden_spmv

FORMATS = ["coo", "csr", "ell", "sell", "cmrs", "hyb"]
EDGES = sorted(synth.EDGE_CASES)


def run_format(fmt, info, r, c, v, x=None):
    rng = np.random.default_rng(99)
    if x is None:
        x = rng.standard_normal(info.ncols)
    a = spmv_tpu.from_coo(fmt, info.nrows, info.ncols, r, c, v)
    y = np.asarray(a.matvec(x.astype(np.float32)))
    assert y.shape == (info.nrows,)
    rep = fp32_check(info.nrows, r, c, v, x.astype(np.float32), y)
    assert rep.ok, f"{fmt}: {rep}"
    return a


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("edge", EDGES)
def test_edge_cases(fmt, edge):
    info, r, c, v = synth.edge_case(edge)
    run_format(fmt, info, r, c, v)


@pytest.mark.parametrize("fmt", FORMATS)
def test_random_medium(fmt):
    info, r, c, v = synth.random_coo(500, 300, 4000, seed=3)
    run_format(fmt, info, r, c, v)


@pytest.mark.parametrize("fmt", FORMATS)
def test_band_matrix(fmt):
    info, r, c, v = synth.synthetic_cant(n=1024, avg_nnz_per_row=16,
                                         bandwidth=60, seed=5)
    run_format(fmt, info, r, c, v)


@pytest.mark.parametrize("fmt", FORMATS)
def test_reference_x_vector(fmt):
    # The reference uses x[i] = i (coo.c:88-92).
    info, r, c, v = synth.random_coo(200, 200, 1500, seed=11)
    x = spmv_tpu.default_x(info.ncols)
    run_format(fmt, info, r, c, v, x=x)


def test_coo_duplicates_sum():
    r = np.array([1, 1, 0])
    c = np.array([2, 2, 0])
    v = np.array([3.0, 4.0, 1.0])
    a = spmv_tpu.from_coo("coo", 3, 3, r, c, v)
    y = np.asarray(a.matvec(np.array([1.0, 1.0, 2.0], np.float32)))
    np.testing.assert_allclose(y, [1.0, 14.0, 0.0], atol=1e-5)


def test_coo_unsorted_input():
    rng = np.random.default_rng(0)
    n, nnz = 100, 600
    r = rng.integers(0, n, nnz)
    c = rng.integers(0, n, nnz)
    v = rng.standard_normal(nnz)
    x = rng.standard_normal(n).astype(np.float32)
    a = spmv_tpu.from_coo("coo", n, n, r, c, v)
    rep = check_result(golden_spmv(n, r, c, v, x), np.asarray(a.matvec(x)),
                       tol_abs=1e-4, tol_rel=1e-4)
    assert rep.ok, str(rep)


def test_csr_from_csr_roundtrip():
    info, r, c, v = synth.edge_case("empty_rows")
    a = spmv_tpu.CSRMatrix.from_coo(info.nrows, info.ncols, r, c, v)
    # ptr correct also for empty rows (reference bug: csr.c:72-91)
    lengths = np.bincount(r, minlength=info.nrows)
    np.testing.assert_array_equal(np.diff(a.ptr), lengths)
    b = spmv_tpu.CSRMatrix.from_csr(info.nrows, info.ncols, a.ptr, a.cols, a.vals)
    x = np.arange(info.ncols, dtype=np.float32)
    np.testing.assert_allclose(np.asarray(a.matvec(x)), np.asarray(b.matvec(x)))


def test_ell_stats_include_last_row():
    # Reference bug: final row's length never flushed (ell.c:89-100).
    info, r, c, v = synth.edge_case("empty_rows")  # row 9 (last) is longest
    a = spmv_tpu.EllMatrix.from_coo(info.nrows, info.ncols, r, c, v)
    assert a.K == 5
    assert a.row_length_stats["longest"] == 5
    assert a.row_length_stats["shortest"] == 0


def test_cmrs_format_arrays():
    info, r, c, v = synth.edge_case("ragged")  # nrows=13, 13 % 8 != 0
    a = spmv_tpu.CMRSMatrix.from_coo(info.nrows, info.ncols, r, c, v)
    assert a.nstrips == 2
    assert a.strip_ptr[-1] == info.nnz
    assert (a.row_in_strip < a.height).all()
    # from_cmrs path gives the same result
    b = spmv_tpu.CMRSMatrix.from_cmrs(
        info.nrows, info.ncols, a.strip_ptr, a.row_in_strip, a.cols, a.vals
    )
    x = np.random.default_rng(1).standard_normal(info.ncols).astype(np.float32)
    np.testing.assert_allclose(np.asarray(a.matvec(x)), np.asarray(b.matvec(x)),
                               atol=1e-5)


def test_sell_sigma_variants():
    info, r, c, v = synth.synthetic_cant(n=700, avg_nnz_per_row=12,
                                         bandwidth=40, seed=9)
    x = np.random.default_rng(2).standard_normal(info.ncols).astype(np.float32)
    expected = golden_spmv(info.nrows, r, c, v, x)
    scale = golden_spmv(info.nrows, r, c, np.abs(v), np.abs(x))
    for sigma in (128, 256, 1024):
        a = spmv_tpu.SellMatrix.from_coo(info.nrows, info.ncols, r, c, v,
                                         sigma=sigma)
        rep = check_result(expected, np.asarray(a.matvec(x)),
                           tol_abs=1e-5, tol_rel=fp32_rel_tol(12),
                           scale=scale)
        assert rep.ok, f"sigma={sigma}: {rep}"


def test_sell_padding_beats_ell_on_skewed():
    info, r, c, v = synth.edge_case("ragged")
    ell = spmv_tpu.EllMatrix.from_coo(info.nrows, info.ncols, r, c, v)
    sell = spmv_tpu.SellMatrix.from_coo(info.nrows, info.ncols, r, c, v,
                                        sigma=128)
    assert sell.padded_slots <= ell.padded_slots


@pytest.mark.parametrize("fmt", FORMATS)
def test_wide_rectangular(fmt):
    # ncols >> nrows: many x stripes per block, exercises window clamping
    info, r, c, v = synth.random_coo(100, 5000, 2500, seed=13)
    run_format(fmt, info, r, c, v)


@pytest.mark.parametrize("fmt", FORMATS)
def test_tall_rectangular(fmt):
    # nrows >> ncols: S floors at 8 table rows
    info, r, c, v = synth.random_coo(5000, 100, 2500, seed=14)
    run_format(fmt, info, r, c, v)


@pytest.mark.parametrize("fmt", ["csr", "coo", "cmrs"])
def test_heterogeneous_row_magnitudes(fmt):
    """Rows whose magnitudes differ by 1e4, in short alternating runs: each
    row's sum rounds at its own magnitude (the device reduces every row
    separately), so the per-row scale Σ|v·x| of ``oracle.fp32_check``
    bounds the error of small rows next to large ones."""
    info, r, c, v = synth.synthetic_cant(n=600, avg_nnz_per_row=12,
                                         bandwidth=60, seed=21)
    row_scale = 10.0 ** (2.0 * np.where((r // 3) % 2 == 0, 1.0, -1.0))
    v = (v * row_scale).astype(np.float64)
    x = np.random.default_rng(5).standard_normal(info.ncols).astype(np.float32)
    a = spmv_tpu.from_coo(fmt, info.nrows, info.ncols, r, c, v)
    rep = fp32_check(info.nrows, r, c, v, x, np.asarray(a.matvec(x)))
    assert rep.ok, f"{fmt}: {rep}"
    # the small rows are checked at their own scale, not the large rows'
    small = (np.arange(info.nrows) // 3) % 2 == 1
    row_abs = golden_spmv(info.nrows, r, c, np.abs(v), np.abs(x))
    assert row_abs[small].max() < 1e-2 * row_abs[~small].max()


def test_ell_format_arrays_roundtrip_and_cpu():
    """ELL's classical row-major (rows, K) arrays (ell.c:121-158): the
    format-native ingest round-trips, and an independent host recompute
    from those arrays matches the oracle — the cross-implementation
    redundancy the reference runs as compute_using_cpu (ell.c:357-383)."""
    info, r, c, v = synth.synthetic_cant(n=700, avg_nnz_per_row=9,
                                         bandwidth=70, seed=31)
    a = spmv_tpu.from_coo("ell", info.nrows, info.ncols, r, c, v)
    data, cols = a.ell_arrays()
    assert data.shape == (info.nrows, a.K) == cols.shape
    assert np.count_nonzero(data) == a.nnz

    rng = np.random.default_rng(8)
    x = rng.standard_normal(info.ncols)
    y_cpu = spmv_tpu.EllMatrix.cpu_spmv(data, cols, x)
    np.testing.assert_allclose(y_cpu, golden_spmv(info.nrows, r, c, v, x),
                               rtol=1e-12, atol=1e-12)

    b = spmv_tpu.EllMatrix.from_ell(info.nrows, info.ncols, data, cols)
    assert b.nnz == a.nnz and b.K == a.K
    np.testing.assert_allclose(np.asarray(b.matvec(x.astype(np.float32))),
                               np.asarray(a.matvec(x.astype(np.float32))),
                               rtol=1e-6, atol=1e-6)


def test_sell_format_arrays_roundtrip_and_cpu():
    """SELL-C-σ's classical sliced column-major arrays (sigma_c.c:156-202)
    + the independent host recompute the reference LACKS for this format
    (sigma_c.c has no compute_using_cpu, SURVEY.md §2.2)."""
    # skewed row lengths so the σ-sort actually applies (perm != identity)
    info, r, c, v = synth.synthetic_cant(n=700, avg_nnz_per_row=6,
                                         bandwidth=700, seed=33)
    heavy = (r % 97) == 0
    r = np.concatenate([r, np.repeat(r[heavy], 5)])
    c = np.concatenate([c, (np.arange(heavy.sum() * 5) * 13) % info.ncols])
    v = np.concatenate([v, np.full(heavy.sum() * 5, 0.5)])
    # dedupe (duplicates would sum in-kernel but break nnz accounting here)
    u = np.unique(r * info.ncols + c, return_index=True)[1]
    r, c, v = r[u], c[u], v[u]

    a = spmv_tpu.from_coo("sell", info.nrows, info.ncols, r, c, v)
    slice_ptr, data, cols = a.sell_arrays()
    assert slice_ptr[-1] == data.size == cols.size
    assert np.count_nonzero(data) == a.nnz

    rng = np.random.default_rng(9)
    x = rng.standard_normal(info.ncols)
    y_cpu = spmv_tpu.SellMatrix.cpu_spmv(slice_ptr, data, cols, a.perm, x,
                                         info.nrows)
    np.testing.assert_allclose(y_cpu, golden_spmv(info.nrows, r, c, v, x),
                               rtol=1e-12, atol=1e-12)

    b = spmv_tpu.SellMatrix.from_sell(info.nrows, info.ncols, slice_ptr,
                                      data, cols, a.perm)
    assert b.nnz == a.nnz
    np.testing.assert_allclose(np.asarray(b.matvec(x.astype(np.float32))),
                               np.asarray(a.matvec(x.astype(np.float32))),
                               rtol=1e-5, atol=1e-5)


def test_sell_wins_on_banded_power_law():
    """The matrix class where the σ-sort earns its place (round-1 verdict
    item 3): scale-free row lengths + column locality.  SELL must sort,
    hold strictly fewer device bytes than ELL, and stay correct."""
    info, r, c, v = synth.power_law(n=4096, avg_nnz_per_row=16,
                                    bandwidth=256, seed=2)
    ell = spmv_tpu.EllMatrix.from_coo(info.nrows, info.ncols, r, c, v)
    sell = spmv_tpu.SellMatrix.from_coo(info.nrows, info.ncols, r, c, v)
    assert sell.sorted_rows
    assert sell.padded_bytes < 0.75 * ell.padded_bytes
    run_format("sell", info, r, c, v)
    run_format("ell", info, r, c, v)


def test_hyb_shape_choice_depends_on_matrix_class():
    """HYB's panel width follows Bell & Garland's rule (the largest K that
    at least max(4096, nrows/3) rows fill): uniform rows go wholly to the
    panel, a power-law tail spills, and a matrix below the row floor is
    all spill — correct either way."""
    from spmv_tpu.formats.hyb import HybMatrix

    # uniform rows of 16: K = 16, nothing spills
    n = 8192
    rows = np.repeat(np.arange(n), 16)
    cols = (rows + np.tile(np.arange(16), n)) % n
    vals = np.random.default_rng(0).standard_normal(rows.size)
    a = HybMatrix.from_coo(n, n, rows, cols, vals)
    assert a.K == 16 and a.spill_nnz == 0 and a.panel_nnz == a.nnz
    x = np.random.default_rng(1).standard_normal(n).astype(np.float32)
    assert fp32_check(n, rows, cols, vals, x, np.asarray(a.matvec(x))).ok

    # power law: a short panel and a real spill
    info, r, c, v = synth.power_law(n=16384, avg_nnz_per_row=12,
                                    bandwidth=256, seed=4)
    b = HybMatrix.from_coo(info.nrows, info.ncols, r, c, v)
    lengths = np.bincount(r, minlength=info.nrows)
    assert 0 < b.K < lengths.max() and b.spill_nnz > 0
    assert (lengths >= b.K).sum() >= max(4096, info.nrows / 3)
    assert (lengths >= b.K + 1).sum() < max(4096, info.nrows / 3)
    run_format("hyb", info, r, c, v)

    # below the 4096-row floor: all spill
    info, r, c, v = synth.synthetic_cant(n=2048, avg_nnz_per_row=16,
                                         bandwidth=100, seed=0)
    d = HybMatrix.from_coo(info.nrows, info.ncols, r, c, v)
    assert d.K == 0 and d.panel_nnz == 0 and d.spill_nnz == d.nnz
    run_format("hyb", info, r, c, v)


# ---------------------------------------------------------------- to_coo

ALL_FORMATS = FORMATS + ["bsr"]


def _dense_from_triplets(nrows, ncols, r, c, v):
    d = np.zeros((nrows, ncols), np.float64)
    np.add.at(d, (r, c), v)
    return d


@pytest.mark.parametrize("fmt", ALL_FORMATS)
def test_to_coo_roundtrip(fmt):
    """from_coo -> to_coo -> dense equals the input dense operator, for
    every format (the shared accessor surface — round-4 advisor item).
    BSR stores f32 tiles, so its values round-trip at f32 precision."""
    info, r, c, v = synth.random_coo(300, 260, 2500, seed=17)
    a = spmv_tpu.from_coo(fmt, info.nrows, info.ncols, r, c, v)
    r2, c2, v2 = a.to_coo()
    atol = 1e-6 if fmt == "bsr" else 1e-12
    np.testing.assert_allclose(
        _dense_from_triplets(info.nrows, info.ncols, r2, c2, v2),
        _dense_from_triplets(info.nrows, info.ncols, r, c, v),
        rtol=0, atol=atol)


@pytest.mark.parametrize("fmt", ALL_FORMATS)
def test_to_coo_roundtrip_duplicates(fmt):
    """Duplicate COO input entries: the reconstructed operator must match
    the duplicate-summed dense (BSR/intermediate plans sum them)."""
    info, r, c, v = synth.random_coo(64, 64, 500, seed=23,
                                     allow_duplicates=True)
    a = spmv_tpu.from_coo(fmt, info.nrows, info.ncols, r, c, v)
    r2, c2, v2 = a.to_coo()
    atol = 1e-6 if fmt == "bsr" else 1e-12
    np.testing.assert_allclose(
        _dense_from_triplets(info.nrows, info.ncols, r2, c2, v2),
        _dense_from_triplets(info.nrows, info.ncols, r, c, v),
        rtol=0, atol=atol)


def test_to_coo_from_cmrs_ingest():
    """to_coo round-trips through the classical CMRS ingest path too."""
    from spmv_tpu.formats.cmrs import CMRSMatrix

    info, r, c, v = synth.random_coo(40, 40, 300, seed=5)
    a = spmv_tpu.from_coo("cmrs", info.nrows, info.ncols, r, c, v)
    b = CMRSMatrix.from_cmrs(info.nrows, info.ncols, a.strip_ptr,
                             a.row_in_strip, a.cols, a.vals,
                             height=a.height)
    r2, c2, v2 = b.to_coo()
    np.testing.assert_allclose(
        _dense_from_triplets(info.nrows, info.ncols, r2, c2, v2),
        _dense_from_triplets(info.nrows, info.ncols, r, c, v),
        rtol=0, atol=1e-12)


def test_to_coo_returns_copies():
    """Mutating the returned triplets must not desync the container's
    host state from the device plan (round-4 advisor item)."""
    info, r, c, v = synth.random_coo(50, 50, 200, seed=2)
    for fmt in ALL_FORMATS:
        a = spmv_tpu.from_coo(fmt, info.nrows, info.ncols, r, c, v)
        r2, c2, v2 = a.to_coo()
        before = (r2.copy(), c2.copy(), v2.copy())
        r2[:] = 0
        c2[:] = 0
        v2[:] = 0.0
        r3, c3, v3 = a.to_coo()
        assert np.array_equal(r3, before[0]), fmt
        assert np.array_equal(c3, before[1]), fmt
        assert np.array_equal(v3, before[2]), fmt
