"""Benchmark harness.

Replaces the reference's per-driver timing block (single run, no warm-up,
``clock_gettime`` around one kernel enqueue, ``coo.c:193-199``) with:

* ``iters`` chained products inside ONE jitted ``lax.fori_loop`` (the
  device arrays ride as jit arguments; a ~1-element slice update of x from
  y keeps each iteration live), so one dispatch covers many products;
* host-clock time around each call, ended by ``block_until_ready``;
  compilation and one warm-up call happen first and are not timed;
* the median over ``repeats`` calls; several formats interleave their
  rounds round-robin so they sample the same device conditions.

Reports the reference-compatible metrics (GFLOP/s = 2·nnz/ms·1e-6 and the
GB/s bounds of ``helper_functions.h:167-182``) and bandwidth ones: bytes
actually moved per product (every device array of the format, padding
included, plus one read of x and one write of y) over time, against the
device's published peak (``PEAKS``) or a measured copy rate.  Every result
names the device it ran on.
"""

from __future__ import annotations

import time
from dataclasses import asdict, dataclass

import jax
import jax.numpy as jnp
import numpy as np

from spmv_tpu.device import nbytes, slots

__all__ = ["BenchResult", "PEAKS", "bench_format",
           "bench_formats_interleaved", "bench_spmm", "bytes_per_slot",
           "device_label", "measure_hbm_bw", "peak_hbm_bw", "traffic_model"]

# Published device-memory bandwidth (bytes/s) keyed by JAX's device_kind.
# Source: NVIDIA H100 Tensor Core GPU data sheet (SXM5 80 GB: 3.35 TB/s
# HBM3; PCIe 80 GB: 2.0 TB/s HBM2e).  A device not listed is an error.
PEAKS = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
    "NVIDIA H100 PCIe": 2.0e12,
}


def peak_hbm_bw(device=None) -> float:
    """Published peak bytes/s of ``device`` (default: the first device)."""
    kind = (device or jax.devices()[0]).device_kind
    if kind not in PEAKS:
        raise ValueError(f"no published memory bandwidth for device kind "
                         f"{kind!r}; known: {sorted(PEAKS)}")
    return PEAKS[kind]


def device_label() -> dict:
    """The device a result was measured on, as JAX reports it."""
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


@dataclass
class BenchResult:
    format: str
    device: dict
    nrows: int
    ncols: int
    nnz: int
    padded_slots: int
    ms_per_spmv: float
    gnnz_per_s: float  # true nnz / time
    gflops: float  # reference formula: 2·nnz/ms·1e-6 (helper_functions.h:167)
    gbps_lower: float  # nnz·8B/ms·1e-6 (helper_functions.h:175-181 exactly)
    gbps_upper: float  # 2·nnz·8B/ms·1e-6 (helper_functions.h:182)
    effective_gbps: float  # bytes actually moved (padding + indices + x, y)
    roofline_pct: float  # effective_gbps / hbm_bw_gbps
    true_eff_pct: float  # gnnz_per_s / (HBM bw / bytes-per-slot):
    #   speed-of-light efficiency on TRUE nonzeros — padding cannot buy score
    hbm_bw_gbps: float
    bytes_per_nnz: float
    samples_ms: list | None = None  # per-call ms per product

    def to_dict(self):
        return asdict(self)


def traffic_model(a) -> tuple[int, float]:
    """(padded element slots, bytes moved) per product: every device array
    of the container once, plus one read of x and one write of y (fp64
    vectors for f32x2 containers)."""
    vec = 8 if getattr(a, "x2", False) else 4
    return slots(a.dev), float(nbytes(a.dev) + vec * (a.nrows + a.ncols))


def bytes_per_slot(a) -> float:
    padded, total = traffic_model(a)
    return total / max(padded, 1)


def _chained_loop(dev, iters: int):
    """One jitted function running ``iters`` chained products of ``dev``
    (a jit argument).  Each iteration writes ~1e-38·y[0] into x[0], so no
    iteration is loop-invariant and XLA cannot hoist the product.  The
    whole y rides in the loop carry and is returned: were only y[0] live,
    XLA's GPU compiler would shrink a ``segment_sum`` to that one row."""

    @jax.jit
    def loop(x, dev):
        def body(i, carry):
            y = dev(carry[0])
            return carry[0].at[0].add(y[0] * 1e-38), y

        y0 = jnp.zeros(jax.eval_shape(dev, x).shape, x.dtype)
        return jax.lax.fori_loop(0, iters, body, (x, y0))

    return lambda x: loop(x, dev)


class _Prepared:
    """A container readied for timing: its chained loop compiled and
    warmed, with ``iters`` scaled so one call takes ≳ 20 ms."""

    def __init__(self, a, format_name, iters, x0=None, adapt=True):
        self.a, self.format = a, format_name
        # f32x2 containers compute in fp64 (spmv_tpu.x2)
        self.x2 = bool(getattr(a, "x2", False))
        if x0 is None:
            x0 = np.random.default_rng(0).standard_normal(a.ncols)
        with jax.enable_x64(self.x2):
            self.x = jnp.asarray(x0, jnp.float64 if self.x2 else jnp.float32)
        t = self._call(iters)
        while adapt and t < 0.020 and iters < 1 << 16:
            iters *= 4
            t = self._call(iters)
        self.iters = iters
        self.samples: list[float] = []

    def _call(self, iters):
        self.fn = _chained_loop(self.a.dev, iters)
        self._once()  # compile + warm
        return self._once()

    def _once(self) -> float:
        with jax.enable_x64(self.x2):
            t0 = time.perf_counter()
            jax.block_until_ready(self.fn(self.x))
            return time.perf_counter() - t0

    def time_round(self) -> None:
        self.samples.append(self._once() / self.iters)

    def result(self, hbm_bw: float) -> BenchResult:
        a = self.a
        t = float(np.median(self.samples))
        ms = t * 1e3
        nnz = a.nnz
        padded, total_bytes = traffic_model(a)
        eff_gbps = total_bytes / t / 1e9
        return BenchResult(
            format=self.format,
            device=device_label(),
            nrows=a.nrows,
            ncols=a.ncols,
            nnz=nnz,
            padded_slots=padded,
            ms_per_spmv=ms,
            gnnz_per_s=nnz / t / 1e9,
            gflops=2 * nnz / ms * 1e-6,
            gbps_lower=nnz * 8 / ms * 1e-6,
            gbps_upper=2 * nnz * 8 / ms * 1e-6,
            effective_gbps=eff_gbps,
            roofline_pct=100.0 * eff_gbps * 1e9 / hbm_bw,
            true_eff_pct=100.0 * (nnz / t) / (hbm_bw / bytes_per_slot(a)),
            hbm_bw_gbps=hbm_bw / 1e9,
            bytes_per_nnz=total_bytes / max(nnz, 1),
            samples_ms=[s * 1e3 for s in self.samples],
        )


def bench_format(a, format_name: str, *, iters: int = 50, repeats: int = 9,
                 hbm_bw: float | None = None, x0=None,
                 adapt: bool = True) -> BenchResult:
    """Time one container; ``hbm_bw`` defaults to the device's peak."""
    prep = _Prepared(a, format_name, iters, x0, adapt=adapt)
    for _ in range(repeats):
        prep.time_round()
    return prep.result(hbm_bw or peak_hbm_bw())


def bench_formats_interleaved(objs: dict, *, iters: int = 50,
                              repeats: int = 9, hbm_bw: float | None = None,
                              probe: bool = False, probe_mb: int = 512,
                              adapt: bool = True):
    """Bench several containers with their timing rounds interleaved
    round-robin (rotated order), so every one samples the same device
    conditions.  With ``probe=True`` the copy-bandwidth probe is measured
    too and the return value is ``(results, bw)`` with every result
    denominated against it."""
    preps = {name: _Prepared(a, name, iters, adapt=adapt)
             for name, a in objs.items()}
    members = list(preps.values())
    for rep in range(repeats):
        for j in range(len(members)):
            members[(j + rep) % len(members)].time_round()
    if probe:
        bw = measure_hbm_bw(mb=probe_mb)
        return {n: p.result(bw) for n, p in preps.items()}, bw
    bw = hbm_bw or peak_hbm_bw()
    return {name: prep.result(bw) for name, prep in preps.items()}


def bench_spmm(a, format_name: str, rhs: int, *, iters: int = 20,
               repeats: int = 5) -> dict:
    """Multi-RHS benchmark: Y = A @ X with X (ncols, R), same chained-loop
    protocol as ``bench_format``."""
    X = np.random.default_rng(0).standard_normal((a.ncols, rhs))
    prep = _Prepared(a, format_name, iters, X)
    for _ in range(repeats):
        prep.time_round()
    t = float(np.median(prep.samples))
    out = {
        "format": format_name,
        "device": device_label(),
        "rhs": rhs,
        "nnz": a.nnz,
        "ms_per_spmm": t * 1e3,
        "gnnzvec_per_s": a.nnz * rhs / t / 1e9,
        "gflops": 2 * a.nnz * rhs / (t * 1e3) * 1e-6,  # reference formula × R
    }
    if hasattr(a, "fill"):
        out["fill"] = a.fill
    return out


def measure_hbm_bw(mb: int = 512, iters: int = 20) -> float:
    """Copy-bandwidth probe → bytes/s: a chained elementwise read+write
    pass over an ``mb``-MiB float32 array (well past the 50 MB L2 at the
    default size), timed like the products."""
    n = mb * 1024 * 1024 // 4
    a = jnp.ones((n,), jnp.float32)

    @jax.jit
    def loop(a):
        return jax.lax.fori_loop(0, iters, lambda i, a: a * 1.0000001, a)

    loop(a).block_until_ready()
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        loop(a).block_until_ready()
        best = min(best, time.perf_counter() - t0)
    return 2 * n * 4 * iters / best
