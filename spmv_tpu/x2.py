"""Extended-precision (f32x2) SpMV containers.

``X2Matrix.from_coo(format, ...)`` keeps each fp64 input value as two
float32 planes, ``hi = f32(v)`` and ``lo = f32(v - hi)``, laid out by the
format exactly like its float32 values (the layouts depend only on the
sparsity pattern, so the two planes agree slot for slot).  ``matvec``
takes an fp64 x and returns an fp64 y; the product runs in fp64
arithmetic on the device over ``hi + lo`` (which restores each value to
~2⁻⁴⁸ relative), traced inside a scoped ``jax.enable_x64``.  That is the
precision class of the all-fp64 reference (``coo.c:39-42``), validated at
its absolute 1e-6 EPSILON (``inc/helper_functions.h:11``).

Covers the five reference formats plus HYB.  BSR stays fp32-only: its
point is dense-tile matrix-unit throughput at large R.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from spmv_tpu.device import apply, nbytes, split_x2, with_lo

__all__ = ["X2Matrix", "X2_FORMATS", "x2_apply"]

X2_FORMATS = ("csr", "coo", "cmrs", "ell", "sell", "sell_c_sigma", "hyb")


def x2_build(format: str, nrows: int, ncols: int, rows, cols, vals):
    """Device container of ``format`` carrying (hi, lo) value planes."""
    from spmv_tpu.api import FORMATS

    format = format.lower()
    if format not in X2_FORMATS:
        raise ValueError(
            f"f32x2 supports {sorted(set(X2_FORMATS))}, not {format!r}")
    hi, lo = split_x2(vals)
    cls = FORMATS[format]
    return with_lo(cls.from_coo(nrows, ncols, rows, cols, hi).dev,
                   cls.from_coo(nrows, ncols, rows, cols, lo).dev)


def x2_apply(fn, *args):
    """Run ``fn(*args)`` with fp64 enabled: fp64 host arrays in ``args``
    reach the device as fp64, and the result comes back as NumPy."""
    with jax.enable_x64(True):
        args = [jnp.asarray(a) if isinstance(a, np.ndarray) else a
                for a in args]
        return np.asarray(fn(*args))


@dataclass
class X2Matrix:
    x2 = True  # fp64 x in, fp64 y out
    format: str
    nrows: int
    ncols: int
    nnz: int
    dev: object = field(repr=False)  # device container with vals_lo

    @classmethod
    def from_coo(cls, format: str, nrows: int, ncols: int, rows, cols,
                 vals) -> "X2Matrix":
        return cls(format=format.lower(), nrows=nrows, ncols=ncols,
                   nnz=int(np.asarray(rows).size),
                   dev=x2_build(format, nrows, ncols, rows, cols, vals))

    def matvec(self, x) -> np.ndarray:
        """y = A·x in fp64: fp64 x in, fp64 y out."""
        x = np.asarray(x, np.float64)
        if x.ndim != 1 or x.shape[0] != self.ncols:
            raise ValueError(f"x has {x.size} entries, matrix has "
                             f"{self.ncols} columns")
        return x2_apply(apply, self.dev, x)

    def matmat(self, X) -> np.ndarray:
        """Y = A·X in fp64 for X of shape (ncols, R)."""
        X = np.asarray(X, np.float64)
        if X.ndim != 2 or X.shape[0] != self.ncols:
            raise ValueError(f"X must be ({self.ncols}, R), got {X.shape}")
        return x2_apply(apply, self.dev, X)

    __matmul__ = matvec

    @property
    def padded_bytes(self) -> int:
        return nbytes(self.dev)
