"""Weak-scaling benchmark for the distributed SpMV layer.

Weak scaling keeps per-device work constant: every device owns
``rows_per_device`` matrix rows at fixed nnz/row, so a D-device run works
a D× larger matrix; ideal scaling keeps the time flat and efficiency is
``t(1)/t(D)``.  The sweep runs on whatever mesh is available and every
report names the device it ran on.  Timing follows ``bench.runner``:
chained products inside one jitted ``fori_loop``, host clock around
``block_until_ready``, median over repeats.
"""

from __future__ import annotations

import time
from dataclasses import asdict, dataclass

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["ScalePoint", "time_sharded", "weak_scaling",
           "weak_scaling_report"]


@dataclass
class ScalePoint:
    devices: int
    nrows: int
    nnz: int
    ms_per_spmv: float
    gnnz_per_s: float
    efficiency: float  # t(1)/t(D); 1.0 = ideal weak scaling

    def to_dict(self):
        return asdict(self)


def time_sharded(sh, x: np.ndarray, *, iters: int = 50,
                 repeats: int = 5) -> float:
    """Seconds per product of a dist container (median over repeats of
    ``iters`` chained products in one jitted loop; x ← y/|y| keeps every
    iteration live)."""

    @jax.jit
    def loop(x, arrays):
        def body(i, x):
            y = sh._matvec_traced(x, arrays)
            return y * jax.lax.rsqrt(jnp.vdot(y, y) + 1e-30)

        return jax.lax.fori_loop(0, iters, body, x)

    xf = jnp.asarray(x, jnp.float32)
    loop(xf, sh.arrays).block_until_ready()  # compile + warm
    samples = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        loop(xf, sh.arrays).block_until_ready()
        samples.append((time.perf_counter() - t0) / iters)
    return float(np.median(samples))


def weak_scaling(format: str = "cmrs", *, rows_per_device: int = 16384,
                 avg_nnz_per_row: int = 32, bandwidth: int = 256,
                 device_counts=None, gather_x: bool = True, seed: int = 0,
                 iters: int = 50, repeats: int = 5) -> list[ScalePoint]:
    """Run the weak-scaling sweep; returns one point per device count.
    Needs a square matrix (the timing loop feeds y back as x)."""
    from spmv_tpu.dist.mesh import make_mesh
    from spmv_tpu.dist.sharded import RowShardedSpmv
    from spmv_tpu.synth import synthetic_cant

    ndev = len(jax.devices())
    if device_counts is None:
        device_counts = [d for d in (1, 2, 4, 8) if d <= ndev]

    points: list[ScalePoint] = []
    t1 = None
    for d in device_counts:
        info, rows, cols, vals = synthetic_cant(
            n=rows_per_device * d, avg_nnz_per_row=avg_nnz_per_row,
            bandwidth=bandwidth, seed=seed)
        sh = RowShardedSpmv(format, info.nrows, info.ncols, rows, cols, vals,
                            make_mesh(d), gather_x=gather_x)
        x = np.random.default_rng(seed).standard_normal(info.ncols)
        t = time_sharded(sh, x, iters=iters, repeats=repeats)
        t1 = t if t1 is None else t1
        points.append(ScalePoint(
            devices=d, nrows=info.nrows, nnz=rows.size,
            ms_per_spmv=t * 1e3, gnnz_per_s=rows.size / t / 1e9,
            efficiency=t1 / t))
    return points


def weak_scaling_report(**kwargs) -> dict:
    """JSON-able report: the sweep plus the device it ran on."""
    from spmv_tpu.bench.runner import device_label

    points = weak_scaling(**kwargs)
    return {
        "config": {"format": kwargs.get("format", "cmrs"),
                   "gather_x": kwargs.get("gather_x", True)},
        "device": device_label(),
        "points": [p.to_dict() for p in points],
        "max_devices_efficiency": points[-1].efficiency if points else None,
    }
