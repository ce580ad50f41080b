"""COO — coordinate format.

Reference: ``/root/reference/coo.c`` + ``kernels/Coo.cl``.  The reference
kernel scatter-adds one lane per nonzero with a hand-rolled CAS
double-precision ``atomic_add`` (``Coo.cl:4-22``).  The device product
here is the same scatter: an unsorted ``segment_sum`` over the triplets in
file order, which XLA lowers to atomic adds on the GPU.

Duplicate (row, col) entries sum, matching raw MatrixMarket semantics and
the reference's accumulate behavior (``helper_functions.h:218``).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from spmv_tpu.device import DeviceOperator, Seg, seg

__all__ = ["COOMatrix"]


@dataclass
class COOMatrix(DeviceOperator):
    """Host container: raw (possibly unsorted) triplets + device arrays."""

    nrows: int
    ncols: int
    rows: np.ndarray  # original order, 0-based
    cols: np.ndarray
    vals: np.ndarray
    dev: Seg = field(repr=False)

    @classmethod
    def from_coo(cls, nrows: int, ncols: int, rows: np.ndarray,
                 cols: np.ndarray, vals: np.ndarray) -> "COOMatrix":
        rows = np.asarray(rows)
        cols = np.asarray(cols)
        vals = np.asarray(vals)
        return cls(nrows=nrows, ncols=ncols, rows=rows, cols=cols, vals=vals,
                   dev=seg(rows, cols, vals, nrows))

    @property
    def nnz(self) -> int:
        return self.rows.size

    def to_coo(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``(rows, cols, vals)`` triplets in the original input order
        (duplicates preserved — the device product sums them, so the
        triplets and the operator agree).  Always fresh copies: a caller
        mutating them cannot desync the host triplets from the device."""
        return (np.array(self.rows, np.int64, copy=True),
                np.array(self.cols, np.int64, copy=True),
                np.array(self.vals, copy=True))
