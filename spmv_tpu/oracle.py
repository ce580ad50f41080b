"""Golden SpMV oracle + result checker.

The analog of the reference's ``check_result``
(``/root/reference/inc/helper_functions.h:184-236``): recompute
``y[r] += v * x[c]`` from raw COO triplets with a trivially-correct scalar
algorithm (here: fp64 ``np.add.at``, which is bit-identical to the
reference's sequential file-order accumulation only up to reassociation —
hence the tolerance model below) and compare elementwise.

Unlike the reference — which re-parses the 60 MB .mtx text file once per
check, three full parses per run (SURVEY.md §3.5) — the oracle takes the
already-loaded triplets.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["golden_spmv", "check_result", "CheckReport", "default_x",
           "EPSILON", "fp32_rel_tol", "fp32_check"]

# Which tolerance each check uses, and why:
#
# * fp64 device results (f32x2 / ``spmv_tpu.x2``) — the reference's own
#   absolute EPSILON (helper_functions.h:11); its drivers compute in fp64.
# * fp32 device results — an absolute floor plus ``fp32_rel_tol(k)`` times
#   the row's magnitude Σ|v·x| (``fp32_check``).  The device sums each
#   row in an order the oracle does not share: the CSR kernel in steps of
#   its block, XLA's reductions in trees, and COO's ``segment_sum`` with
#   atomics whose order changes from run to run (so COO results are not
#   bitwise reproducible).  The bound must hold for any order.
# * Reference matmuls (dense NumPy in the tests) run in fp64 on the host;
#   any device matmul used as a reference sets ``precision="highest"``
#   (the GPU's default fp32 matmul rounds operands to TF32).
EPSILON = 1e-6


def golden_spmv(
    nrows: int,
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    x: np.ndarray,
) -> np.ndarray:
    """fp64 scatter-accumulate SpMV from COO triplets (duplicates sum).
    ``x`` may be a vector or an (ncols, R) block (then y is (nrows, R))."""
    x = np.asarray(x, dtype=np.float64)
    v = np.asarray(vals, dtype=np.float64).reshape((-1,) + (1,) * (x.ndim - 1))
    y = np.zeros((nrows,) + x.shape[1:], dtype=np.float64)
    np.add.at(y, np.asarray(rows, dtype=np.int64), v * x[cols])
    return y


def default_x(ncols: int, dtype=np.float64) -> np.ndarray:
    """The reference's input vector: ``x[i] = i`` (``coo.c:88-92``)."""
    return np.arange(ncols, dtype=dtype)


@dataclass
class CheckReport:
    ok: bool
    max_abs_err: float
    max_rel_err: float
    first_bad: int | None
    tol_abs: float
    tol_rel: float

    def __bool__(self) -> bool:  # truthy like the reference's bool return
        return self.ok

    def __str__(self) -> str:
        verdict = "result is ok" if self.ok else "result is wrong"
        return (
            f"{verdict} (max_abs_err={self.max_abs_err:.3e}, "
            f"max_rel_err={self.max_rel_err:.3e}, "
            f"tol_abs={self.tol_abs:.1e}, tol_rel={self.tol_rel:.1e})"
        )


def check_result(
    expected: np.ndarray,
    actual: np.ndarray,
    *,
    tol_abs: float = EPSILON,
    tol_rel: float = 0.0,
    scale: np.ndarray | None = None,
) -> CheckReport:
    """Elementwise ``|expected - actual| <= tol_abs + tol_rel * scale``.

    ``scale`` defaults to ``|expected|``.  For a numerically honest fp32
    check pass ``scale = golden_spmv(|vals|, |x|)`` (the per-row Σ|v·x|):
    an ill-conditioned row (large Σ|v·x|, tiny Σv·x) cannot beat κ·eps in
    any summation order.  With defaults this is exactly the reference
    criterion (``helper_functions.h:221-230``); fp32 kernel outputs should
    pass ``tol_rel=fp32_rel_tol(max_row_nnz)``.
    """
    expected = np.asarray(expected, dtype=np.float64)
    actual = np.asarray(actual, dtype=np.float64)
    if expected.shape != actual.shape:
        raise ValueError(f"shape mismatch: {expected.shape} vs {actual.shape}")
    err = np.abs(expected - actual)
    s = np.abs(expected) if scale is None else np.asarray(scale, dtype=np.float64)
    bound = tol_abs + tol_rel * s
    bad = err > bound
    denom = np.maximum(np.abs(expected), 1e-300)
    rel = err / denom
    first_bad = int(np.argmax(bad)) if bad.any() else None
    return CheckReport(
        ok=not bad.any(),
        max_abs_err=float(err.max()) if err.size else 0.0,
        max_rel_err=float(rel.max()) if rel.size else 0.0,
        first_bad=first_bad,
        tol_abs=tol_abs,
        tol_rel=tol_rel,
    )


def fp32_rel_tol(max_row_nnz: int) -> float:
    """Relative tolerance model for an fp32 device sum vs the fp64 oracle:
    accumulated rounding grows ~sqrt(k)·eps for k-term sums (random
    signs, any summation order); a 32× headroom bounds the tail."""
    k = max(int(max_row_nnz), 1)
    return 32.0 * np.finfo(np.float32).eps * np.sqrt(k)


def fp32_check(nrows: int, rows, cols, vals, x, y, *,
               tol_abs: float = 1e-5) -> CheckReport:
    """Check an fp32 device SpMV result ``y`` against the fp64 oracle,
    with the per-row scale Σ|v·x| and ``fp32_rel_tol`` of the longest
    row (see the tolerance notes at the top of this module)."""
    rows = np.asarray(rows, np.int64)
    x = np.asarray(x)
    lengths = np.bincount(rows, minlength=max(nrows, 1))
    return check_result(
        golden_spmv(nrows, rows, cols, vals, x), y, tol_abs=tol_abs,
        tol_rel=fp32_rel_tol(int(lengths.max(initial=1))),
        scale=golden_spmv(nrows, rows, cols, np.abs(vals), np.abs(x)))
