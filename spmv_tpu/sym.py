"""Symmetric-storage SpMV: y = A·x with A kept as its lower triangle.

The reference benchmarks Boeing/cant — a symmetric FEM matrix — but its
files ship pre-expanded to general form and the loaders parse them as
such (``helper_functions.h:151-156`` rejects complex only; ``coo.c:81``
reads raw triplets).  ``io.mmio.read_coo`` expands symmetric *storage*
by default, doubling the host triplets.  This container instead keeps
the stored triangle and computes

    y = (L + D)·x  +  Lᵀ·x

as two row-block kernel passes (``spmv_tpu.device.SumOf`` of two
``Csr``), where the transpose pass is the strict triangle with rows and
columns swapped, re-sorted by its new rows.
The host triplets halve; the device holds both passes' index and value
arrays, so it streams as many elements as the expanded matrix.

Accepted input: the stored triangle (MatrixMarket symmetric semantics —
each off-diagonal entry represents both (r,c) and (c,r)).  Entries given
in the upper triangle are folded onto the lower.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from spmv_tpu.device import DeviceOperator, SumOf, csr

__all__ = ["SymmetricMatrix"]


@dataclass
class SymmetricMatrix(DeviceOperator):
    """Symmetric operator from triangle storage: two segmented passes."""

    nrows: int
    ncols: int
    tri_rows: np.ndarray  # stored (lower-triangle) triplets, 0-based
    tri_cols: np.ndarray
    tri_vals: np.ndarray
    dev: SumOf = field(repr=False)  # (L + D, Lᵀ)

    @classmethod
    def from_coo(cls, nrows: int, ncols: int, rows: np.ndarray,
                 cols: np.ndarray, vals: np.ndarray) -> "SymmetricMatrix":
        if nrows != ncols:
            raise ValueError("symmetric storage requires a square matrix")
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        vals = np.asarray(vals)
        # fold any upper-triangle entries onto the lower triangle (each
        # stored off-diagonal entry represents both mirror positions)
        up = rows < cols
        r = np.where(up, cols, rows)
        c = np.where(up, rows, cols)
        strict = r > c
        low = np.lexsort((c, r))
        up = np.lexsort((r[strict], c[strict]))
        dev = SumOf(parts=(
            csr(r[low], c[low], vals[low], nrows),
            csr(c[strict][up], r[strict][up], vals[strict][up], nrows)))
        return cls(nrows=nrows, ncols=ncols, tri_rows=r, tri_cols=c,
                   tri_vals=vals, dev=dev)

    @property
    def nnz(self) -> int:
        """Nonzeros of the OPERATOR (expanded form) — throughput and the
        reference GFLOP/s formula count the work actually done."""
        return self.tri_rows.size + self.spill_nnz

    @property
    def stored_nnz(self) -> int:
        return self.tri_rows.size

    @property
    def spill_nnz(self) -> int:
        """Strict-triangle count: the elements of the transpose pass."""
        return int((self.tri_rows > self.tri_cols).sum())

    def to_coo(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Expanded (general-form) triplets — fresh copies, consistent
        with every format's accessor surface."""
        strict = self.tri_rows > self.tri_cols
        rows = np.concatenate([self.tri_rows, self.tri_cols[strict]])
        cols = np.concatenate([self.tri_cols, self.tri_rows[strict]])
        vals = np.concatenate([self.tri_vals, self.tri_vals[strict]])
        return rows.copy(), cols.copy(), np.array(vals, copy=True)
