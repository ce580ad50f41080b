"""CSR — compressed sparse row.

Reference: ``/root/reference/csr.c`` + ``kernels/Csr.cl`` (scalar CSR: one
lane per row with a sequential inner loop, ``Csr.cl:5-16``).  On the
device the arrays stay CSR and the product is the row-block kernel of
``spmv_tpu.csr_kernel`` (``spmv_tpu.device.Csr``).

The reference's streaming ptr construction assumes rows appear contiguously
ascending with no empty rows (``csr.c:72-91``, SURVEY.md §2.2) — here ptr is
built with bincount+cumsum, so empty rows and any input order are correct by
construction (regression-tested).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from spmv_tpu.device import Csr, DeviceOperator, csr

__all__ = ["CSRMatrix"]


@dataclass
class CSRMatrix(DeviceOperator):
    nrows: int
    ncols: int
    ptr: np.ndarray  # (nrows+1,) int64
    cols: np.ndarray  # (nnz,) int32, row-major
    vals: np.ndarray  # (nnz,)
    dev: Csr = field(repr=False)

    @classmethod
    def from_coo(cls, nrows: int, ncols: int, rows: np.ndarray,
                 cols: np.ndarray, vals: np.ndarray) -> "CSRMatrix":
        rows = np.asarray(rows, dtype=np.int64)
        order = np.lexsort((cols, rows))
        rows_s, cols_s, vals_s = rows[order], np.asarray(cols)[order], np.asarray(vals)[order]
        ptr = np.zeros(nrows + 1, dtype=np.int64)
        np.cumsum(np.bincount(rows_s, minlength=nrows), out=ptr[1:])
        return cls.from_csr(nrows, ncols, ptr, cols_s, vals_s)

    @classmethod
    def from_csr(cls, nrows: int, ncols: int, ptr: np.ndarray,
                 cols: np.ndarray, vals: np.ndarray) -> "CSRMatrix":
        ptr = np.asarray(ptr, dtype=np.int64)
        rows = np.repeat(np.arange(nrows, dtype=np.int64), np.diff(ptr))
        return cls(nrows=nrows, ncols=ncols, ptr=ptr,
                   cols=np.asarray(cols, dtype=np.int32),
                   vals=np.asarray(vals),
                   dev=csr(rows, cols, vals, nrows))

    @property
    def nnz(self) -> int:
        return self.cols.size

    def to_coo(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``(rows, cols, vals)`` triplets in CSR (row-major) order.
        Fresh copies — mutating them cannot desync the device arrays."""
        rows = np.repeat(np.arange(self.nrows, dtype=np.int64),
                         np.diff(self.ptr))
        return (rows, np.array(self.cols, np.int64, copy=True),
                np.array(self.vals, copy=True))
