#!/usr/bin/env python
"""Driver benchmark: prints ONE JSON line with the best cant-scale format
throughput and one entry per suite, and writes per-format details to
``bench_results.json``.

Suites: all six matvec formats on the cant-scale synthetic band matrix
(the bundled SuiteSparse cant.mtx is a git-LFS pointer; ``SPMV_MATRIX``
names a real file to use instead), the power-law matrices at 32k and 524k
rows, f32x2, symmetric storage, SpMM at R = 4, BSR at R = 32, a 4.2M-row
band matrix, and a weak-scaling sweep over the visible devices.  Each
suite's output is checked against the fp64 oracle.  A suite that fails
is recorded and the script exits non-zero.  Every number names the
device it ran on.
"""

import hashlib
import json
import os
import sys
import traceback

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# Generator version of the bench matrix: bump whenever synth.synthetic_cant
# (or the parameters below) changes meaningfully, so a generator change can
# never masquerade as a performance change.
GENERATOR_VERSION = "fem-beam-v2"


def matrix_fingerprint(info, rows, cols, vals, params: dict) -> dict:
    """Content hash + provenance of the bench matrix."""
    h = hashlib.blake2b(digest_size=8)
    h.update(np.ascontiguousarray(rows, np.int64).tobytes())
    h.update(np.ascontiguousarray(cols, np.int64).tobytes())
    h.update(np.ascontiguousarray(vals, np.float64).tobytes())
    return {
        "generator": GENERATOR_VERSION,
        "params": params,
        "nrows": int(info.nrows),
        "ncols": int(info.ncols),
        "nnz": int(rows.size),
        "triplet_hash": h.hexdigest(),
    }


def _checked(a, info, rows, cols, vals, name):
    """Run one product at the timed size and hold it to the fp32 oracle
    tolerance (``oracle.fp32_check``)."""
    from spmv_tpu.oracle import fp32_check

    x = np.random.default_rng(7).standard_normal(info.ncols)
    rep = fp32_check(info.nrows, rows, cols, vals, x,
                     np.asarray(a.matvec(x)))
    if not rep.ok:
        raise AssertionError(f"{name}: {rep}")


def _line(name, r) -> str:
    return (f"{name}: {r.ms_per_spmv:8.4f} ms  {r.gnnz_per_s:7.2f} Gnnz/s  "
            f"{r.effective_gbps:7.1f} GB/s ({r.roofline_pct:5.1f}% of "
            f"{r.hbm_bw_gbps:.0f} GB/s, pad "
            f"{r.padded_slots / max(r.nnz, 1):.2f}x)")


def main() -> int:
    from spmv_tpu.cache import setup_compile_cache

    setup_compile_cache()

    import spmv_tpu
    from spmv_tpu import synth
    from spmv_tpu.bench.runner import (bench_format,
                                       bench_formats_interleaved,
                                       bench_spmm, device_label)
    from spmv_tpu.io.mmio import is_real_mtx, read_path_or_synthesize

    device = device_label()
    print(f"device: {device}", file=sys.stderr)
    path = os.environ.get("SPMV_MATRIX", "databases/cant.mtx")
    params = dict(n=62464, avg_nnz_per_row=64, bandwidth=350, seed=0)
    info, rows, cols, vals = read_path_or_synthesize(path, **params)
    synthetic = not is_real_mtx(path)
    fp = matrix_fingerprint(info, rows, cols, vals,
                            params if synthetic else {"path": path})
    print(f"matrix: {info.nrows}x{info.ncols} nnz={rows.size}"
          f"{' (synthetic cant-scale band)' if synthetic else ''}",
          file=sys.stderr)

    results = {"__device__": device, "__matrix_fingerprint__": fp}
    summary = {}
    failed = []

    def suite(name):
        def wrap(fn):
            try:
                summary[name] = fn()
            except Exception as e:  # recorded; makes the exit code non-zero
                traceback.print_exc()
                print(f"{name} suite: FAILED {type(e).__name__}: {e}",
                      file=sys.stderr)
                failed.append(name)
            return fn
        return wrap

    def run_set(key, objs, matrix, **kw):
        for name, a in objs.items():
            _checked(a, *matrix, name)
        res = bench_formats_interleaved(objs, **kw)
        results[key] = {k: r.to_dict() for k, r in res.items()}
        for k, r in res.items():
            print(_line(f"{key} {k}", r), file=sys.stderr)
        return res

    @suite("cant")
    def _cant():
        objs = {f: spmv_tpu.from_coo(f, info.nrows, info.ncols, rows, cols,
                                     vals)
                for f in ["csr", "coo", "ell", "sell", "cmrs", "hyb"]}
        res = run_set("cant", objs, (info, rows, cols, vals), repeats=15)
        best = max(res.values(), key=lambda r: r.gnnz_per_s)
        return {"best_format": best.format,
                "best_gnnz_per_s": round(best.gnnz_per_s, 3),
                "ms_per_spmv": {k: r.ms_per_spmv for k, r in res.items()}}

    @suite("power_law")
    def _pl():
        pm = synth.power_law(n=32768, avg_nnz_per_row=24, bandwidth=512,
                             seed=0)
        objs = {f: spmv_tpu.from_coo(f, pm[0].nrows, pm[0].ncols, *pm[1:])
                for f in ["ell", "sell", "csr", "coo", "cmrs", "hyb"]}
        res = run_set("power_law", objs, pm, repeats=15)
        return {k: round(r.gnnz_per_s, 3) for k, r in res.items()}

    @suite("power_law_big")
    def _plb():
        pm = synth.power_law(n=524288, avg_nnz_per_row=24, bandwidth=512,
                             seed=0)
        objs = {f: spmv_tpu.from_coo(f, pm[0].nrows, pm[0].ncols, *pm[1:])
                for f in ["csr", "sell", "hyb"]}
        res = run_set("power_law_big", objs, pm, repeats=9)
        return {k: round(r.gnnz_per_s, 3) for k, r in res.items()}

    @suite("x2_csr")
    def _x2():
        from spmv_tpu.oracle import EPSILON, golden_spmv
        from spmv_tpu.x2 import X2Matrix

        a = X2Matrix.from_coo("csr", info.nrows, info.ncols, rows, cols,
                              vals)
        x64 = np.random.default_rng(3).standard_normal(info.ncols)
        err = float(np.abs(a.matvec(x64) - golden_spmv(
            info.nrows, rows, cols, vals, x64)).max())
        if err > EPSILON:
            raise AssertionError(f"f32x2 abs err {err:.3e} > {EPSILON}")
        r = bench_format(a, "csr_x2", repeats=9)
        results["x2_csr"] = dict(r.to_dict(), max_abs_err_vs_fp64=err)
        print(_line("x2 csr", r) + f"  max|err| {err:.2e}", file=sys.stderr)
        return {"gnnz_per_s": round(r.gnnz_per_s, 3),
                "max_abs_err_vs_fp64": err}

    @suite("symmetric")
    def _sym():
        keep = rows >= cols
        tr, tc, tv = rows[keep], cols[keep], vals[keep]
        s = tr > tc
        er, ec = np.concatenate([tr, tc[s]]), np.concatenate([tc, tr[s]])
        ev = np.concatenate([tv, tv[s]])
        sym = spmv_tpu.from_coo("sym", info.nrows, info.ncols, tr, tc, tv)
        exp = spmv_tpu.from_coo("csr", info.nrows, info.ncols, er, ec, ev)
        res = run_set("symmetric", {"sym_tri": sym, "sym_expanded_csr": exp},
                      (info, er, ec, ev), repeats=9)
        return {k: round(r.gnnz_per_s, 3) for k, r in res.items()}

    @suite("spmm_csr_r4")
    def _spmm():
        a = spmv_tpu.from_coo("csr", info.nrows, info.ncols, rows, cols, vals)
        r = bench_spmm(a, "csr", 4, repeats=9)
        results["spmm_csr_r4"] = r
        print(f"spmm csr R=4: {r['ms_per_spmm']:8.4f} ms "
              f"{r['gnnzvec_per_s']:7.2f} Gnnz·vec/s", file=sys.stderr)
        return round(r["gnnzvec_per_s"], 3)

    @suite("bsr_spmm_r32")
    def _bsr():
        a = spmv_tpu.from_coo("bsr", info.nrows, info.ncols, rows, cols, vals)
        _checked(a, info, rows, cols, vals, "bsr")
        r = bench_spmm(a, "bsr", 32, repeats=9)
        results["bsr_spmm_r32"] = r
        print(f"bsr spmm R=32: {r['ms_per_spmm']:8.4f} ms "
              f"{r['gnnzvec_per_s']:7.2f} Gnnz·vec/s (fill {a.fill:.1f}x)",
              file=sys.stderr)
        return {"gnnzvec_per_s": round(r["gnnzvec_per_s"], 3),
                "fill": round(float(a.fill), 2)}

    @suite("big_4.2M")
    def _big():
        bm = synth.synthetic_cant(n=4_200_000, avg_nnz_per_row=8,
                                  bandwidth=300, seed=0)
        a = spmv_tpu.from_coo("csr", bm[0].nrows, bm[0].ncols, *bm[1:])
        res = run_set("big_4.2M", {"csr": a}, bm, repeats=9)
        return round(res["csr"].gnnz_per_s, 3)

    @suite("weak_scaling")
    def _ws():
        from spmv_tpu.bench.scaling import weak_scaling_report

        rep = weak_scaling_report(format="cmrs", rows_per_device=16384,
                                  avg_nnz_per_row=32, bandwidth=256)
        results["weak_scaling"] = rep
        return {str(p["devices"]): round(p["efficiency"], 4)
                for p in rep["points"]}

    with open("bench_results.json", "w") as f:
        json.dump(results, f, indent=2)
    cant = summary.get("cant") or {}
    print(json.dumps({
        "metric": "spmv_best_gnnz_per_s",
        "value": cant.get("best_gnnz_per_s", 0.0),
        "unit": "Gnnz/s",
        "device": device,
        "synthetic_matrix": synthetic,
        "suites": summary,
        "failed_suites": failed,
    }))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
