"""Bench-harness plumbing on the CPU backend (the times measure XLA's CPU
backend and mean nothing for the GPU; these tests pin the protocol's
structure: chained loop, interleaved rounds, probe, traffic accounting,
the device named in every result)."""

import numpy as np
import pytest

import spmv_tpu
from spmv_tpu import synth
from spmv_tpu.bench.runner import (
    bench_format,
    bench_formats_interleaved,
    bench_spmm,
    bytes_per_slot,
    traffic_model,
)
from spmv_tpu.device import nbytes

BW = 1e11  # a stand-in roofline denominator: the CPU has no table entry


@pytest.fixture(scope="module")
def small():
    info, r, c, v = synth.synthetic_cant(n=600, avg_nnz_per_row=8,
                                         bandwidth=40, seed=7)
    return info, r, c, v


def test_bench_format_structure(small):
    info, r, c, v = small
    a = spmv_tpu.from_coo("csr", info.nrows, info.ncols, r, c, v)
    res = bench_format(a, "csr", repeats=2, iters=2, hbm_bw=BW, adapt=False)
    d = res.to_dict()
    assert d["format"] == "csr" and d["nnz"] == r.size
    assert d["device"]["platform"] == "cpu"
    assert d["ms_per_spmv"] > 0 and d["gnnz_per_s"] > 0
    assert d["padded_slots"] >= d["nnz"]
    # reference-compat formulas (helper_functions.h:167-182) hold exactly
    ms = d["ms_per_spmv"]
    assert d["gflops"] == pytest.approx(2 * d["nnz"] / ms * 1e-6)
    assert d["gbps_lower"] == pytest.approx(d["nnz"] * 8 / ms * 1e-6)
    assert d["gbps_upper"] == pytest.approx(2 * d["nnz"] * 8 / ms * 1e-6)
    assert d["hbm_bw_gbps"] == pytest.approx(BW / 1e9)


def test_traffic_model_exact_bytes(small):
    info, r, c, v = small
    for fmt in ("csr", "ell"):
        a = spmv_tpu.from_coo(fmt, info.nrows, info.ncols, r, c, v)
        slots, total = traffic_model(a)
        assert slots == a.padded_slots
        assert total == nbytes(a.dev) + 4 * (a.nrows + a.ncols)
        assert bytes_per_slot(a) == pytest.approx(total / slots)
    # csr: an int32 row pointer per row (plus one), then an int32 column
    # and an f32 value per nonzero
    a = spmv_tpu.from_coo("csr", info.nrows, info.ncols, r, c, v)
    assert nbytes(a.dev) == 4 * (info.nrows + 1) + 8 * r.size


def test_traffic_model_counts_split_spill_and_sell_epilogue():
    """HYB's bytes are its panel's plus its spill's; SELL's include the
    slabs and the unpermute index."""
    info, r, c, v = synth.power_law(n=8192, avg_nnz_per_row=16,
                                    bandwidth=128, seed=3)
    sell = spmv_tpu.from_coo("sell", info.nrows, info.ncols, r, c, v)
    assert sell.sorted_rows
    _, total = traffic_model(sell)
    slabs = sum(nbytes(p) for p in sell.dev.parts)
    assert total == slabs + 4 * info.nrows + 4 * (info.nrows + info.ncols)
    hyb = spmv_tpu.from_coo("hyb", info.nrows, info.ncols, r, c, v)
    assert hyb.panel_nnz > 0 and hyb.spill_nnz > 0
    _, total_h = traffic_model(hyb)
    assert total_h == (nbytes(hyb.dev.parts[0]) + nbytes(hyb.dev.parts[1])
                       + 4 * (info.nrows + info.ncols))


def test_interleaved_with_probe_returns_ceiling(small):
    info, r, c, v = small
    objs = {f: spmv_tpu.from_coo(f, info.nrows, info.ncols, r, c, v)
            for f in ("csr", "ell")}
    results, bw = bench_formats_interleaved(objs, repeats=2, iters=2,
                                            probe=True, probe_mb=4,
                                            adapt=False)
    assert set(results) == {"csr", "ell"}
    assert bw > 0
    for res in results.values():
        assert res.ms_per_spmv > 0 and len(res.samples_ms) == 2
        assert res.hbm_bw_gbps == pytest.approx(bw / 1e9)


def test_bench_spmm_structure(small):
    info, r, c, v = small
    a = spmv_tpu.from_coo("bsr", info.nrows, info.ncols, r, c, v)
    d = bench_spmm(a, "bsr", 4, repeats=2, iters=2)
    assert d["rhs"] == 4 and d["gnnzvec_per_s"] > 0
    assert d["device"]["platform"] == "cpu"
    assert d["gflops"] == pytest.approx(
        2 * d["nnz"] * 4 / d["ms_per_spmm"] * 1e-6)
