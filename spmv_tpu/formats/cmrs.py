"""CMRS — compressed multi-row storage (Koza et al., arXiv:1203.2946).

Reference: ``/root/reference/cmrs.c`` + ``kernels/Cmrs.cl``.  Strips of
``height`` consecutive rows (height=8, ``cmrs.c:46``); nnz stay in CSR
order; per-strip nnz ranges in ``strip_ptr`` and a per-nnz 3-bit
``row_in_strip`` id.  The reference kernel accumulates into uninitialized
local memory (``Cmrs.cl:18``) and writes out of bounds when
``rows % height != 0`` (``Cmrs.cl:38-41`` vs ``cmrs.c:152``) — both fixed
here by construction.

On the device the global row ``strip·height + row_in_strip`` of each
nonzero is materialized once into row pointers, and the product is the
row-block kernel (``spmv_tpu.device.Csr``), the same as CSR.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from spmv_tpu.device import Csr, DeviceOperator, csr
from spmv_tpu.formats.base import cdiv

__all__ = ["CMRSMatrix", "DEFAULT_HEIGHT"]

DEFAULT_HEIGHT = 8  # cmrs.c:46


@dataclass
class CMRSMatrix(DeviceOperator):
    nrows: int
    ncols: int
    height: int
    strip_ptr: np.ndarray  # (nstrips+1,) int64 — nnz offset per strip
    row_in_strip: np.ndarray  # (nnz,) int8 — row id within strip
    cols: np.ndarray  # (nnz,) int32, CSR order
    vals: np.ndarray  # (nnz,)
    dev: Csr = field(repr=False)

    @classmethod
    def from_coo(cls, nrows: int, ncols: int, rows: np.ndarray,
                 cols: np.ndarray, vals: np.ndarray, *,
                 height: int = DEFAULT_HEIGHT) -> "CMRSMatrix":
        if not 0 < height <= 128:
            raise ValueError("height must be in 1..128 (int8 row ids)")
        rows = np.asarray(rows, dtype=np.int64)
        order = np.lexsort((np.asarray(cols), rows))
        rows_s = rows[order]
        nstrips = cdiv(max(nrows, 1), height)
        strip_ptr = np.zeros(nstrips + 1, dtype=np.int64)
        np.cumsum(np.bincount(rows_s // height, minlength=nstrips),
                  out=strip_ptr[1:])
        return cls.from_cmrs(nrows, ncols, strip_ptr,
                             (rows_s % height).astype(np.int8),
                             np.asarray(cols)[order], np.asarray(vals)[order],
                             height=height)

    @classmethod
    def from_cmrs(cls, nrows: int, ncols: int, strip_ptr: np.ndarray,
                  row_in_strip: np.ndarray, cols: np.ndarray,
                  vals: np.ndarray, *,
                  height: int = DEFAULT_HEIGHT) -> "CMRSMatrix":
        """Build from the format's own arrays (the honest CMRS ingest path:
        reconstructs global rows = strip·height + ris and re-sorts within
        strips so the device rows are sorted)."""
        strip_ptr = np.asarray(strip_ptr, dtype=np.int64)
        ris = np.asarray(row_in_strip, dtype=np.int64)
        strip_of = np.repeat(np.arange(strip_ptr.size - 1, dtype=np.int64),
                             np.diff(strip_ptr))
        rows = strip_of * height + ris
        order = np.lexsort((np.asarray(cols), rows))  # CSR order in strips
        return cls(
            nrows=nrows, ncols=ncols, height=height, strip_ptr=strip_ptr,
            row_in_strip=np.asarray(row_in_strip, dtype=np.int8),
            cols=np.asarray(cols, dtype=np.int32), vals=np.asarray(vals),
            dev=csr(rows[order], np.asarray(cols)[order],
                    np.asarray(vals)[order], nrows))

    @property
    def nnz(self) -> int:
        return self.cols.size

    @property
    def nstrips(self) -> int:
        return self.strip_ptr.size - 1

    def to_coo(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``(rows, cols, vals)`` with global rows reconstructed from the
        strip arrays (``rows = strip·height + row_in_strip``)."""
        strip_of = np.repeat(np.arange(self.nstrips, dtype=np.int64),
                             np.diff(self.strip_ptr))
        rows = strip_of * self.height + self.row_in_strip.astype(np.int64)
        return (rows, np.array(self.cols, np.int64, copy=True),
                np.array(self.vals, copy=True))
