"""Command-line interface.

The reference ships five executables whose argv is explicitly discarded
(``coo.c:18-19``) and whose matrix path, work sizes and tuning constants
are compile-time constants (SURVEY.md §5 config row).  Here everything is
a flag.

    python -m spmv_tpu run   --format csr --matrix databases/cant.mtx
    python -m spmv_tpu bench --matrix databases/cant.mtx --formats all
    python -m spmv_tpu info  --matrix m.mtx

``run`` mirrors one reference driver end-to-end: load → convert → SpMV on
device → golden validation → metrics print, with the reference's
``x[i] = i`` input (``coo.c:88-92``) by default.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from spmv_tpu.errors import ReturnCode

ALL_FORMATS = ["coo", "csr", "ell", "sell", "cmrs", "hyb"]
# matvec suite + the multi-RHS block format; `run/bench --format bsr`
# (optionally with --rhs R) reaches the SpMM engine class
CLI_FORMATS = ALL_FORMATS + ["bsr"]


def _load(args):
    import os

    from spmv_tpu.io import mmio

    if getattr(args, "cache_dir", ""):
        from spmv_tpu import cache
        if os.path.exists(args.matrix):
            key = cache.cache_key(args.matrix, "coo-triplets", {})
            hit = cache.load_plan(args.cache_dir, key)
            if hit is not None:
                meta, arrays = hit
                info = mmio.MMInfo("matrix", "coordinate", "real", "general",
                                   meta["nrows"], meta["ncols"],
                                   arrays["rows"].size)
                return info, arrays["rows"], arrays["cols"], arrays["vals"]

    synth_kwargs = {}
    if args.synth_n:
        synth_kwargs = dict(n=args.synth_n)
    out = mmio.read_path_or_synthesize(args.matrix, **synth_kwargs)
    if getattr(args, "cache_dir", "") and os.path.exists(args.matrix):
        info, rows, cols, vals = out
        from spmv_tpu import cache
        cache.save_plan(args.cache_dir,
                        cache.cache_key(args.matrix, "coo-triplets", {}),
                        {"nrows": info.nrows, "ncols": info.ncols},
                        {"rows": rows, "cols": cols, "vals": vals})
    return out


def _make_x(mode: str, ncols: int, seed: int = 0) -> np.ndarray:
    if mode == "index":  # the reference's vector (coo.c:88-92)
        return np.arange(ncols, dtype=np.float32)
    rng = np.random.default_rng(seed)
    return rng.standard_normal(ncols).astype(np.float32)


def _validate(info, rows, cols, vals, x, y) -> tuple[bool, str]:
    from spmv_tpu.oracle import fp32_check

    rep = fp32_check(info.nrows, rows, cols, vals, x, y)
    return rep.ok, str(rep)


def _cpu_comparison(info, rows, cols, vals, x, a) -> None:
    """Timed host-CPU SpMV next to the device verdict — reference parity
    with ``compute_using_cpu`` + its GFLOP/s print (``coo.c:280-300``,
    ``helper_functions.h:167-173``): an independent host implementation,
    timed and validated against the same oracle."""
    import time

    def host_spmv():
        y = np.zeros(info.nrows, dtype=np.float64)
        np.add.at(y, np.asarray(rows, dtype=np.int64),
                  np.asarray(vals, np.float64) * np.asarray(x, np.float64)[cols])
        return y

    host_spmv()  # warm caches / lazy imports, like the device warm-up
    t0 = time.perf_counter()
    y_cpu = host_spmv()
    ms = max((time.perf_counter() - t0) * 1e3, 1e-6)
    from spmv_tpu.oracle import check_result, golden_spmv

    rep = check_result(golden_spmv(info.nrows, rows, cols, vals, x), y_cpu)
    nnz = rows.size
    print(f"CPU: {ms:.3f} ms  {2 * nnz / ms * 1e-6:.2f} GFLOP/s  "
          f"({'ok' if rep.ok else 'WRONG'})")


def _run_x2(args, info, rows, cols, vals) -> int:
    """run --dtype f32x2: double-single device SpMV validated at the
    reference's fp64 tolerance (abs 1e-6, ``helper_functions.h:11``) —
    the precision class the all-fp64 reference drivers compute in
    (``coo.c:39-42``)."""
    from spmv_tpu.oracle import check_result, golden_spmv
    from spmv_tpu.x2 import X2Matrix

    rhs = max(int(getattr(args, "rhs", 1)), 1)
    try:
        a = X2Matrix.from_coo(args.format, info.nrows, info.ncols,
                              rows, cols, vals)
        if rhs > 1:
            X = np.stack([_make_x(args.x, info.ncols, args.seed + j)
                          .astype(np.float64) for j in range(rhs)], axis=1)
            Y = a.matmat(X)
        else:
            x = _make_x(args.x, info.ncols, args.seed).astype(np.float64)
            y = a.matvec(x)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return ReturnCode.PROGRAM_ERROR

    def verdict_x2(xj, yj):
        expected = golden_spmv(info.nrows, rows, cols, vals, xj)
        scale = golden_spmv(info.nrows, rows, cols, np.abs(vals), np.abs(xj))
        # fp64 device sums: rounding ~k·2⁻⁵³ ≪ row_abs·1e-9; abs floor =
        # the reference's EPSILON
        return check_result(expected, yj, tol_abs=1e-6, tol_rel=1e-9,
                            scale=scale)

    if rhs > 1:
        reps = [verdict_x2(X[:, j], Y[:, j]) for j in range(rhs)]
        bad = next((j for j, r in enumerate(reps) if not r.ok), None)
        if bad is not None:
            print(f"{reps[bad]}  [f32x2, column {bad} of {rhs} "
                  "right-hand sides]")
        else:
            print(f"{reps[-1]}  [f32x2, {rhs} right-hand sides]")
        ok = bad is None
    else:
        rep = verdict_x2(x, y)
        print(f"{rep}  [f32x2]")
        _cpu_comparison(info, rows, cols, vals, x, a)
        ok = rep.ok

    if args.bench:
        from spmv_tpu.bench.runner import bench_format
        r = bench_format(a, f"{args.format}/x2")
        print(f"{r.ms_per_spmv:.3f} ms/SpMV  {r.gnnz_per_s:.2f} Gnnz/s  "
              f"{r.gflops:.1f} GFLOP/s  {r.effective_gbps:.0f} GB/s "
              f"effective ({r.roofline_pct:.1f}% of roofline)")
        if args.json:
            with open(args.json, "w") as f:
                json.dump(r.to_dict(), f, indent=2)
    return ReturnCode.SUCCESS if ok else ReturnCode.VALIDATION_FAILED


def cmd_run(args) -> int:
    import spmv_tpu

    try:
        info, rows, cols, vals = _load(args)
    except Exception as e:
        print(f"error reading {args.matrix}: {e}", file=sys.stderr)
        return ReturnCode.FILE_ERROR

    if getattr(args, "dtype", "f32") == "f32x2":
        return _run_x2(args, info, rows, cols, vals)

    rhs = max(int(getattr(args, "rhs", 1)), 1)
    try:
        a = spmv_tpu.from_coo(args.format, info.nrows, info.ncols,
                              rows, cols, vals)
        if rhs > 1:
            X = np.stack([_make_x(args.x, info.ncols, args.seed + j)
                          for j in range(rhs)], axis=1)
            Y = np.asarray(spmv_tpu.spmm(a, X))
        else:
            x = _make_x(args.x, info.ncols, args.seed)
            y = np.asarray(a.matvec(x))
    except Exception as e:
        print(f"kernel error: {type(e).__name__}: {e}", file=sys.stderr)
        return ReturnCode.PROGRAM_ERROR

    if args.format == "ell":
        st = a.row_length_stats  # parity with ell.c:103-104
        print(f"row length: average {st['average']:.2f}, "
              f"shortest {st['shortest']}, longest {st['longest']}")

    if rhs > 1:
        ok = True
        first_bad = None
        for j in range(rhs):
            okj, verdict = _validate(info, rows, cols, vals, X[:, j], Y[:, j])
            if not okj and first_bad is None:
                first_bad = (j, verdict)
            ok = ok and okj
        if first_bad is not None:
            # report the first FAILING column, not whichever came last
            print(f"{first_bad[1]}  [column {first_bad[0]} of {rhs} "
                  "right-hand sides]")
        else:
            print(f"{verdict}  [{rhs} right-hand sides]")
    else:
        ok, verdict = _validate(info, rows, cols, vals, x, y)
        print(verdict)
        _cpu_comparison(info, rows, cols, vals, x, a)

    if args.bench:
        if rhs > 1:
            from spmv_tpu.bench.runner import bench_spmm
            r = bench_spmm(a, args.format, rhs)
            print(f"{r['ms_per_spmm']:.3f} ms/SpMM  "
                  f"{r['gnnzvec_per_s']:.2f} Gnnz·vec/s  "
                  f"{r['gflops']:.1f} GFLOP/s (R={rhs})")
            if args.json:
                with open(args.json, "w") as f:
                    json.dump(r, f, indent=2)
        else:
            from spmv_tpu.bench.runner import bench_format
            r = bench_format(a, args.format)
            print(f"{r.ms_per_spmv:.3f} ms/SpMV  {r.gnnz_per_s:.2f} Gnnz/s  "
                  f"{r.gflops:.1f} GFLOP/s  {r.effective_gbps:.0f} GB/s effective "
                  f"({r.roofline_pct:.1f}% of roofline)")
            if args.json:
                with open(args.json, "w") as f:
                    json.dump(r.to_dict(), f, indent=2)

    return ReturnCode.SUCCESS if ok else ReturnCode.VALIDATION_FAILED


def cmd_bench(args) -> int:
    import spmv_tpu
    from spmv_tpu.bench.runner import bench_format, measure_hbm_bw, peak_hbm_bw

    if args.scaling:
        from spmv_tpu.bench.scaling import weak_scaling_report

        rep = weak_scaling_report(
            format=args.formats if args.formats != "all" else "cmrs",
            rows_per_device=args.rows_per_device)
        print(f"device: {rep['device']}")
        for pt in rep["points"]:
            print(f"D={pt['devices']:3d}: {pt['ms_per_spmv']:7.3f} ms  "
                  f"{pt['gnnz_per_s']:6.2f} Gnnz/s  "
                  f"eff {pt['efficiency']:.2f}")
        if args.json:
            with open(args.json, "w") as f:
                json.dump(rep, f, indent=2)
        return ReturnCode.SUCCESS

    try:
        info, rows, cols, vals = _load(args)
    except Exception as e:
        print(f"error reading {args.matrix}: {e}", file=sys.stderr)
        return ReturnCode.FILE_ERROR

    formats = ALL_FORMATS if args.formats == "all" else args.formats.split(",")
    bw = measure_hbm_bw() if args.probe_bw else peak_hbm_bw()
    rhs = max(int(args.rhs), 1)
    results = {}
    import contextlib

    prof = contextlib.nullcontext()
    if args.profile:
        import jax
        prof = jax.profiler.trace(args.profile)
        print(f"writing profiler trace to {args.profile}", file=sys.stderr)
    x2 = getattr(args, "dtype", "f32") == "f32x2"
    if x2:
        from spmv_tpu.x2 import X2_FORMATS, X2Matrix

        formats = [f for f in formats if f in X2_FORMATS]
    with prof:
        for fmt in formats:
            if x2:
                a = X2Matrix.from_coo(fmt, info.nrows, info.ncols,
                                      rows, cols, vals)
                r = bench_format(a, f"{fmt}/x2", hbm_bw=bw)
                results[f"{fmt}/x2"] = r.to_dict()
                print(f"{fmt}/x2: {r.ms_per_spmv:7.3f} ms  "
                      f"{r.gnnz_per_s:6.2f} Gnnz/s "
                      f"{r.gflops:8.1f} GFLOP/s  {r.roofline_pct:4.1f}% "
                      f"roofline (pad {r.padded_slots / max(r.nnz, 1):.2f}x)")
                continue
            a = spmv_tpu.from_coo(fmt, info.nrows, info.ncols, rows, cols, vals)
            if rhs > 1 or fmt == "bsr":
                from spmv_tpu.bench.runner import bench_spmm
                r = bench_spmm(a, fmt, rhs if rhs > 1 else 128)
                results[fmt] = r
                print(f"{fmt:5s}: {r['ms_per_spmm']:7.3f} ms  "
                      f"{r['gnnzvec_per_s']:6.2f} Gnnz·vec/s "
                      f"{r['gflops']:8.1f} GFLOP/s  (R={r['rhs']})")
                continue
            r = bench_format(a, fmt, hbm_bw=bw)
            results[fmt] = r.to_dict()
            print(f"{fmt:5s}: {r.ms_per_spmv:7.3f} ms  {r.gnnz_per_s:6.2f} Gnnz/s "
                  f"{r.gflops:8.1f} GFLOP/s  {r.roofline_pct:4.1f}% roofline "
                  f"(pad {r.padded_slots / max(r.nnz, 1):.2f}x)")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=2)
    return ReturnCode.SUCCESS


def cmd_devices(args) -> int:
    """Enumerate accelerators — the analog of the reference's
    ``get_device_ids`` platform/device walk (helper_functions.h:76-129)."""
    import jax

    try:
        devs = jax.devices()
    except Exception as e:
        print(f"no usable accelerator: {e}", file=sys.stderr)
        return ReturnCode.DEVICE_ERROR
    print(f"backend: {jax.default_backend()}  ({len(devs)} device(s))")
    for d in devs:
        print(f"  [{d.id}] {d.device_kind} (process {d.process_index}, "
              f"platform {d.platform})")
    return ReturnCode.SUCCESS


def cmd_solve(args) -> int:
    """Iterative solve / eigen driver — the production-use layer the
    reference lacks entirely (its drivers run one SpMV and exit,
    ``coo.c:193-199``).  The whole Krylov loop compiles as ONE device
    program around the format's SpMV kernel (``spmv_tpu.solve``)."""
    import spmv_tpu
    from spmv_tpu import solve

    try:
        info, rows, cols, vals = _load(args)
    except Exception as e:
        print(f"error reading {args.matrix}: {e}", file=sys.stderr)
        return ReturnCode.FILE_ERROR
    if info.nrows != info.ncols:
        print(f"solve requires a square matrix, got "
              f"{info.nrows}x{info.ncols}", file=sys.stderr)
        return ReturnCode.OTHER_ERROR
    try:
        a = spmv_tpu.from_coo(args.format, info.nrows, info.ncols,
                              rows, cols, vals)
    except Exception as e:
        print(f"{args.format}: {type(e).__name__}: {e}", file=sys.stderr)
        return ReturnCode.PROGRAM_ERROR

    import time

    if args.solver == "power":
        t0 = time.perf_counter()
        lam, v = solve.power_iteration(a, iters=args.maxiter)
        dt = time.perf_counter() - t0
        print(f"power iteration: |lambda_max| ~= {lam:.6e} "
              f"({args.maxiter} iterations, {dt*1e3:.1f} ms)")
        return ReturnCode.SUCCESS

    b = _make_x(args.b, info.nrows, args.seed)
    fn = solve.cg if args.solver == "cg" else solve.bicgstab
    t0 = time.perf_counter()
    x, iters, res = fn(a, b, tol=args.tol, maxiter=args.maxiter)
    dt = time.perf_counter() - t0
    # residual recomputed independently in fp64 (host oracle)
    from spmv_tpu.oracle import golden_spmv

    r64 = golden_spmv(info.nrows, rows, cols, vals,
                      np.asarray(x, np.float64))
    rel = float(np.linalg.norm(r64 - b) / max(np.linalg.norm(b), 1e-30))
    converged = iters < args.maxiter or rel <= args.tol * 10
    print(f"{args.solver}: {iters} iterations, {dt*1e3:.1f} ms, "
          f"device residual {res:.3e}, fp64 relative residual {rel:.3e}"
          f" ({'converged' if converged else 'NOT converged'})")
    return (ReturnCode.SUCCESS if converged
            else ReturnCode.VALIDATION_FAILED)


def cmd_info(args) -> int:
    try:
        info, rows, cols, vals = _load(args)
    except Exception as e:
        print(f"error reading {args.matrix}: {e}", file=sys.stderr)
        return ReturnCode.FILE_ERROR
    lengths = np.bincount(rows, minlength=max(info.nrows, 1)) if rows.size else np.zeros(1, np.int64)
    print(f"{info.nrows} x {info.ncols}, nnz {rows.size} "
          f"({info.field} {info.symmetry})")
    print(f"row length: average {lengths.mean():.2f}, "
          f"shortest {int(lengths.min())}, longest {int(lengths.max())}")
    return ReturnCode.SUCCESS


def main(argv=None) -> int:
    from spmv_tpu.cache import setup_compile_cache

    setup_compile_cache()
    p = argparse.ArgumentParser(prog="spmv",
                                description="sparse matrix-vector "
                                            "multiplication on JAX")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--matrix", default="databases/cant.mtx",
                        help=".mtx path (LFS pointers / missing files are "
                             "synthesized)")
        sp.add_argument("--synth-n", type=int, default=0,
                        help="synthesis size when the matrix file is absent")
        sp.add_argument("--cache-dir", default="",
                        help="npz cache for parsed triplets (reference "
                             "parity gap: it re-parses the 60MB file 3x "
                             "per run)")

    r = sub.add_parser("run", help="one format end-to-end with validation")
    common(r)
    r.add_argument("--format", default="csr", choices=CLI_FORMATS)
    r.add_argument("--x", default="index", choices=["index", "random"],
                   help="input vector: reference x[i]=i or random")
    r.add_argument("--rhs", type=int, default=1,
                   help="right-hand sides: >1 runs SpMM (Y = A @ X) — the "
                        "natural mode for --format bsr")
    r.add_argument("--seed", type=int, default=0)
    r.add_argument("--dtype", default="f32", choices=["f32", "f32x2"],
                   help="f32x2 = fp64 device compute over (hi, lo) f32 "
                        "value planes, validated at the reference's abs "
                        "1e-6 EPSILON (fp64 parity)")
    r.add_argument("--bench", action="store_true")
    r.add_argument("--json", default="")
    r.set_defaults(fn=cmd_run)

    b = sub.add_parser("bench", help="benchmark formats")
    common(b)
    b.add_argument("--formats", default="all")
    b.add_argument("--probe-bw", action="store_true",
                   help="measure the copy bandwidth for the roofline "
                        "(default: the device's published peak)")
    b.add_argument("--scaling", action="store_true",
                   help="weak-scaling sweep over the available device mesh "
                        "(--formats picks ONE format, default cmrs)")
    b.add_argument("--rows-per-device", type=int, default=16384)
    b.add_argument("--rhs", type=int, default=1,
                   help="right-hand sides: >1 benches SpMM instead of SpMV "
                        "(bsr defaults to R=128 even without this flag)")
    b.add_argument("--dtype", default="f32", choices=["f32", "f32x2"],
                   help="f32x2 benches the fp64 (hi, lo) value planes "
                        "(csr/coo/cmrs/ell/sell/hyb)")
    b.add_argument("--profile", default="",
                   help="directory for a jax.profiler trace of the bench")
    b.add_argument("--json", default="")
    b.set_defaults(fn=cmd_bench)

    s = sub.add_parser("solve", help="iterative solve (CG/BiCGSTAB) or "
                                     "power iteration around the SpMV "
                                     "kernel")
    common(s)
    # BSR's block-dense container is SpMM-shaped and has no device
    # product for the Krylov loop — every other format solves
    s.add_argument("--format", default="csr", choices=ALL_FORMATS)
    s.add_argument("--solver", default="bicgstab",
                   choices=["cg", "bicgstab", "power"],
                   help="cg assumes SPD; bicgstab handles general square")
    s.add_argument("--b", default="random", choices=["index", "random"],
                   help="right-hand side")
    s.add_argument("--tol", type=float, default=1e-5)
    s.add_argument("--maxiter", type=int, default=1000)
    s.add_argument("--seed", type=int, default=0)
    s.set_defaults(fn=cmd_solve)

    i = sub.add_parser("info", help="matrix statistics")
    common(i)
    i.set_defaults(fn=cmd_info)

    d = sub.add_parser("devices", help="enumerate accelerators")
    d.set_defaults(fn=cmd_devices)

    args = p.parse_args(argv)
    return int(args.fn(args))


if __name__ == "__main__":
    sys.exit(main())
