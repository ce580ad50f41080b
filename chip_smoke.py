#!/usr/bin/env python
"""Quickest proof that the system runs compiled on the GPU.

Drives the library's main path through its normal entry points
(``from_coo`` → ``matvec`` / ``spmm``, ``solve.cg``, the CLI) at the size
of the benchmark matrices and checks every output against the fp64 oracle
(``spmv_tpu.oracle``):

1. device check — JAX's first device is a GPU the peak table knows;
2. every format on the cant-scale FEM band matrix (~62k rows, ~4.0M nnz):
   coo, csr, ell, sell, cmrs, hyb and sym through ``matvec``, bsr through
   ``spmm`` at R = 32, and csr ``spmm`` at R = 4 and R = 100;
3. the 524k-row power-law matrix (~4.9M nnz) through csr, sell and hyb,
   then the tests marked ``gpu`` (``tests/test_gpu.py``: every product
   compiles for the card, and the compiled Triton CSR kernel matches the
   oracle);
4. a 4.2M-row band matrix (~36.5M nnz, ~440 MB as CSR) through csr;
5. f32x2 csr against the fp64 oracle at the reference's EPSILON;
6. ``solve.cg`` on an SPD cant-scale matrix (fp64 host residual), and
   ``cli.main(["run", "--format", "sell", ...])``;
7. host-clock ms per SpMV of each cant-scale format, for information.

Tolerances: fp32 results use ``oracle.fp32_check`` — an absolute 1e-5
floor plus 32·eps·sqrt(k) of each row's Σ|v·x| (k = longest row), a bound
that holds for any summation order: the row-block CSR kernel and XLA's
reductions sum in another order than the oracle, and COO's
``segment_sum`` adds with atomics in an order that changes from run to
run.  fp64 (f32x2) results use the reference's absolute EPSILON = 1e-6.

``--four-cards`` runs only the multi-device path on four GPUs: row
sharding with and without the x all-gather, column sharding, the ring,
the chunked gather and a CG through ``RowShardedSpmv``, each at cant scale
against the oracle.

Prints the card's name and power limit and each phase's time and result;
the last line is one JSON object naming the device.  Exits non-zero, with
no JSON line, when no GPU is found or any phase fails.

    python chip_smoke.py [--four-cards]
"""

import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def _cant():
    from spmv_tpu import synth

    return synth.synthetic_cant(n=62464, avg_nnz_per_row=64, bandwidth=350,
                                seed=0)


def _spd(info, r, c, v):
    """(A + Aᵀ)/2 plus a diagonal that makes it strictly diagonally
    dominant: symmetric positive definite, as triplets (duplicates sum)."""
    n = info.nrows
    rowabs = np.bincount(r, weights=np.abs(v), minlength=n)
    colabs = np.bincount(c, weights=np.abs(v), minlength=n)
    d = np.arange(n)
    return (np.concatenate([r, c, d]), np.concatenate([c, r, d]),
            np.concatenate([v / 2, v / 2, (rowabs + colabs) / 2 + 1.0]))


def _check(name, nrows, r, c, v, x, y):
    from spmv_tpu.oracle import fp32_check

    rep = fp32_check(nrows, r, c, v, x, np.asarray(y))
    limit = rep.tol_abs + rep.tol_rel
    print(f"  {name}: max abs err {rep.max_abs_err:.3e}, limit "
          f"{rep.tol_abs:.0e} + {rep.tol_rel:.2e}·Σ|v·x| "
          f"({'ok' if rep.ok else 'WRONG'})", flush=True)
    if not rep.ok:
        raise AssertionError(f"{name}: {rep} (limit {limit:.3e})")


def phase_device():
    import jax

    from spmv_tpu.bench.runner import peak_hbm_bw

    d = jax.devices()[0]
    print(f"  {len(jax.devices())} x {d.device_kind}; published peak "
          f"{peak_hbm_bw(d) / 1e12:.2f} TB/s")


def phase_gpu_tests():
    """The tests marked ``gpu`` (they skip under the CPU test config)."""
    import importlib.util

    import jax

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tests", "test_gpu.py")
    spec = importlib.util.spec_from_file_location("test_gpu", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    names = [n for n in dir(mod) if n.startswith("test_")]
    for name in names:
        getattr(mod, name)(jax.devices()[0])
        print(f"  {name}: ok")


def phase_formats(state):
    import spmv_tpu

    info, r, c, v = state["cant"]
    n = info.nrows
    x = np.random.default_rng(1).standard_normal(n)
    objs = {}
    for fmt in ["coo", "csr", "ell", "sell", "cmrs", "hyb"]:
        a = objs[fmt] = spmv_tpu.from_coo(fmt, n, n, r, c, v)
        print(f"  {fmt}: {a.padded_bytes / 1e6:.1f} MB on device "
              f"({a.padded_slots / r.size:.2f} slots/nnz)")
        _check(fmt, n, r, c, v, x, a.matvec(x))
    sr, sc, sv = state["spd"]
    low = sr >= sc
    a = objs["sym"] = spmv_tpu.from_coo("sym", n, n, sr[low], sc[low],
                                        sv[low])
    print(f"  sym: {a.padded_bytes / 1e6:.1f} MB on device")
    _check("sym", n, sr, sc, sv, x, a.matvec(x))
    b = spmv_tpu.from_coo("bsr", n, n, r, c, v)
    print(f"  bsr: {b.padded_bytes / 1e6:.1f} MB on device "
          f"(fill {b.fill:.1f}x)")
    rng = np.random.default_rng(2)
    X = rng.standard_normal((n, 32))
    _check("bsr spmm R=32", n, r, c, v, X, spmv_tpu.spmm(b, X))
    for R in (4, 100):
        X = rng.standard_normal((n, R))
        _check(f"csr spmm R={R}", n, r, c, v, X, spmv_tpu.spmm(objs["csr"], X))
    state["objs"] = objs


def phase_power_law():
    import spmv_tpu
    from spmv_tpu import synth

    info, r, c, v = synth.power_law(n=524288, avg_nnz_per_row=24,
                                    bandwidth=512, seed=0)
    print(f"  {info.nrows} rows, {r.size} nnz")
    x = np.random.default_rng(3).standard_normal(info.ncols)
    for fmt in ["csr", "sell", "hyb"]:
        a = spmv_tpu.from_coo(fmt, info.nrows, info.ncols, r, c, v)
        print(f"  {fmt}: {a.padded_bytes / 1e6:.1f} MB on device")
        _check(fmt, info.nrows, r, c, v, x, a.matvec(x))


def phase_past_l2():
    import spmv_tpu
    from spmv_tpu import synth

    t0 = time.perf_counter()
    info, r, c, v = synth.synthetic_cant(n=4_200_000, avg_nnz_per_row=8,
                                         bandwidth=300, seed=0)
    a = spmv_tpu.from_coo("csr", info.nrows, info.ncols, r, c, v)
    print(f"  {info.nrows} rows, {r.size} nnz, {a.padded_bytes / 1e6:.0f} MB "
          f"on device (host build {time.perf_counter() - t0:.1f} s)")
    x = np.random.default_rng(4).standard_normal(info.ncols)
    _check("csr", info.nrows, r, c, v, x, a.matvec(x))


def phase_x2(state):
    from spmv_tpu.oracle import EPSILON, golden_spmv
    from spmv_tpu.x2 import X2Matrix

    info, r, c, v = state["cant"]
    a = X2Matrix.from_coo("csr", info.nrows, info.ncols, r, c, v)
    x = np.random.default_rng(5).standard_normal(info.ncols)
    y = a.matvec(x)
    if y.dtype != np.float64:
        raise AssertionError(f"f32x2 returned {y.dtype}, not float64")
    err = float(np.abs(y - golden_spmv(info.nrows, r, c, v, x)).max())
    print(f"  f32x2 csr: max abs err {err:.3e}, limit EPSILON {EPSILON:g} "
          f"({'ok' if err <= EPSILON else 'WRONG'})")
    if err > EPSILON:
        raise AssertionError(f"f32x2 abs err {err:.3e} > {EPSILON}")


def _cg_check(name, a, n, spd, b, tol=1e-5):
    from spmv_tpu import solve
    from spmv_tpu.oracle import golden_spmv

    xs, iters, res = solve.cg(a, b, tol=tol, maxiter=1000)
    r64 = golden_spmv(n, *spd, np.asarray(xs, np.float64))
    rel = float(np.linalg.norm(r64 - b) / np.linalg.norm(b))
    print(f"  {name}: {iters} iterations, fp64 relative residual {rel:.3e} "
          f"(limit {10 * tol:g})")
    if iters >= 1000 or rel > 10 * tol:
        raise AssertionError(f"{name} did not converge: {rel:.3e}")


def phase_solve(state, tmpdir):
    import spmv_tpu
    from spmv_tpu.cli import main as cli_main

    info = state["cant"][0]
    n = info.nrows
    spd = state["spd"]
    a = spmv_tpu.from_coo("csr", n, n, *spd)
    b = np.random.default_rng(6).standard_normal(n)
    _cg_check("cg csr", a, n, spd, b)
    rc = cli_main(["run", "--format", "sell", "--matrix",
                   os.path.join(tmpdir, "absent.mtx"), "--synth-n",
                   str(n)])
    print(f"  cli run --format sell: rc {rc}")
    if rc != 0:
        raise AssertionError(f"cli run returned {rc}")


def phase_times(state, card):
    from spmv_tpu.bench.runner import bench_formats_interleaved

    res = bench_formats_interleaved(state["objs"], repeats=7)
    for fmt, r in res.items():
        print(f"  {fmt}: {r.ms_per_spmv:.4f} ms/SpMV, "
              f"{r.gnnz_per_s:.1f} Gnnz/s, {r.effective_gbps:.0f} GB/s "
              f"({card}; bring-up reading, not a benchmark)")


def phase_four_cards(state):
    import jax

    from spmv_tpu.dist.mesh import make_mesh
    from spmv_tpu.dist.overlap import ChunkedRowSpmv
    from spmv_tpu.dist.ring import RingShardedSpmv
    from spmv_tpu.dist.sharded import ColShardedSpmv, RowShardedSpmv

    if len(jax.devices()) < 4:
        raise AssertionError(f"need 4 GPUs, have {len(jax.devices())}")
    mesh = make_mesh(4)
    info, r, c, v = state["cant"]
    n = info.nrows
    x = np.random.default_rng(7).standard_normal(n)
    cases = [("row gather_x=True", RowShardedSpmv, {"gather_x": True}),
             ("row gather_x=False", RowShardedSpmv, {"gather_x": False}),
             ("col", ColShardedSpmv, {}),
             ("ring", RingShardedSpmv, {}),
             ("chunked gather", ChunkedRowSpmv, {"chunks": 4})]
    for name, cls, kw in cases:
        for fmt in ("csr", "sell"):
            a = cls(fmt, n, n, r, c, v, mesh, **kw)
            _check(f"{name} {fmt}", n, r, c, v, x, a.matvec(x))
    spd = state["spd"]
    a = RowShardedSpmv("csr", n, n, *spd, mesh, gather_x=True)
    b = np.random.default_rng(8).standard_normal(n)
    _cg_check("cg over RowShardedSpmv", a, n, spd, b)


def main(argv) -> int:
    import tempfile

    import jax

    from spmv_tpu.cache import setup_compile_cache

    setup_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"no GPU: JAX's first device is {dev.platform} "
              f"({dev.device_kind})", file=sys.stderr)
        return 2
    cards = _card()
    print(cards)  # one "name, power limit" line per card
    card = cards.splitlines()[0]
    print(f"jax {jax.__version__}")
    four = "--four-cards" in argv

    state = {}
    failed = []

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        print(f"[{name}]", flush=True)
        try:
            fn(*args)
            verdict = "ok"
        except Exception as e:  # recorded; any failure fails the run
            traceback.print_exc()
            failed.append(name)
            verdict = f"FAILED {type(e).__name__}: {e}"
        print(f"[{name}] {time.perf_counter() - t0:.1f} s: {verdict}",
              flush=True)

    state["cant"] = _cant()
    state["spd"] = _spd(*state["cant"])
    phase("device", phase_device)
    if four:
        phase("four cards", phase_four_cards, state)
    else:
        with tempfile.TemporaryDirectory() as tmp:
            phase("formats at cant scale", phase_formats, state)
            phase("power law 524k", phase_power_law)
            phase("gpu tests", phase_gpu_tests)
            phase("past L2: 4.2M rows", phase_past_l2)
            phase("f32x2", phase_x2, state)
            phase("solve", phase_solve, state, tmp)
        if "formats at cant scale" not in failed:
            phase("times", phase_times, state, card)
    if failed:
        print(f"failed phases: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
