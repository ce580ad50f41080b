"""ELL — ELLPACK (global padded row length K).

Reference: ``/root/reference/ell.c`` + ``kernels/Ell.cl`` (two-pass file
conversion to row-major (rows, K) arrays, one 16-lane workgroup per row with
a shared-memory tree reduction).  On the device the (rows, K) column and
value arrays are the format itself (``spmv_tpu.device.Panel``) and the
product is one gather-multiply-reduce over them.  ELL pads every row to
the longest: on a power-law matrix one hub row sets K for all, and
``padded_bytes`` shows that blow-up.

Reference bugs fixed by construction (SURVEY.md §2.2):
* padded value slots were uninitialized memory (``ell.c:147-151``) — here
  padding is explicit zeros;
* the final row's length was never flushed into K (``ell.c:89-100``) — here
  K comes from a bincount over all rows.

Also reproduces the reference's row-length stats output (``ell.c:103-104``).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from spmv_tpu.device import DeviceOperator, Panel, panel

__all__ = ["EllMatrix"]


@dataclass
class EllMatrix(DeviceOperator):
    nrows: int
    ncols: int
    nnz: int
    K: int  # max row length (the ELL width)
    row_length_stats: dict  # average / shortest / longest (ell.c:103-104)
    dev: Panel = field(repr=False)
    # triplets in (row, col) order, kept to materialize the classical
    # row-major (rows, K) format arrays on demand (ell.c:121-158 parity)
    _rows: np.ndarray = field(repr=False, default=None)
    _cols: np.ndarray = field(repr=False, default=None)
    _vals: np.ndarray = field(repr=False, default=None)

    @classmethod
    def from_coo(cls, nrows: int, ncols: int, rows: np.ndarray,
                 cols: np.ndarray, vals: np.ndarray) -> "EllMatrix":
        rows = np.asarray(rows, dtype=np.int64)
        order = np.lexsort((cols, rows))
        rows_s, cols_s, vals_s = rows[order], np.asarray(cols)[order], np.asarray(vals)[order]
        lengths = np.bincount(rows_s, minlength=nrows) if rows.size else np.zeros(nrows, np.int64)
        K = int(lengths.max()) if nrows else 0
        stats = {
            "average": float(lengths.mean()) if nrows else 0.0,
            "shortest": int(lengths.min()) if nrows else 0,
            "longest": K,
        }
        return cls(nrows=nrows, ncols=ncols, nnz=rows.size, K=K,
                   row_length_stats=stats,
                   dev=panel(rows_s, cols_s, vals_s, nrows, K),
                   _rows=rows_s, _cols=cols_s.astype(np.int32), _vals=vals_s)

    @classmethod
    def from_ell(cls, nrows: int, ncols: int, data: np.ndarray,
                 cols: np.ndarray) -> "EllMatrix":
        """Ingest the classical row-major padded arrays ``data/cols`` of
        shape (nrows, K) — the format ``ell.c:121-158`` builds.  Pad slots
        are value 0 (explicitly stored zeros are treated as padding, the
        standard ELL convention; the reference's pads were *uninitialized*
        values at ``cols=0``)."""
        data = np.asarray(data)
        cols = np.asarray(cols)
        if data.shape != cols.shape or data.ndim != 2 or data.shape[0] != nrows:
            raise ValueError(f"data/cols must both be (nrows, K); got "
                             f"{data.shape} / {cols.shape}")
        mask = data != 0
        r, _ = np.nonzero(mask)
        return cls.from_coo(nrows, ncols, r, cols[mask], data[mask])

    def to_coo(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``(rows, cols, vals)`` triplets in (row, col) order — fresh
        copies, part of every format's shared accessor surface."""
        return (np.array(self._rows, np.int64, copy=True),
                np.array(self._cols, np.int64, copy=True),
                np.array(self._vals, copy=True))

    def ell_arrays(self) -> tuple[np.ndarray, np.ndarray]:
        """The classical row-major (nrows, K) ``(data, cols)`` arrays
        (``ell.c:121-158``), zero-padded (fixing the uninitialized-pad bug
        at ``ell.c:147-151``)."""
        data = np.zeros((self.nrows, max(self.K, 1)), dtype=np.float64)
        colsa = np.zeros((self.nrows, max(self.K, 1)), dtype=np.int32)
        if self._rows.size:
            k = np.arange(self._rows.size) - np.searchsorted(self._rows,
                                                              self._rows)
            data[self._rows, k] = self._vals
            colsa[self._rows, k] = self._cols
        return data, colsa

    @staticmethod
    def cpu_spmv(data: np.ndarray, cols: np.ndarray, x: np.ndarray) -> np.ndarray:
        """Independent host recompute from the classical format arrays —
        the ``compute_using_cpu`` redundancy check (``ell.c:357-383``):
        a conversion bug that kept the triplet set but mislaid the format
        arrays would fail this, not just the device-vs-oracle check."""
        x = np.asarray(x, dtype=np.float64)
        return (np.asarray(data, np.float64) * x[cols]).sum(axis=1)
