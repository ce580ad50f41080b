"""HYB — hybrid ELL + COO spill (framework extension, beyond the
reference's five formats).

The classic hybrid of Bell & Garland (SC'09) that cuSPARSE shipped as
HYB: the first ``K`` nonzeros of every row live in a padded ``(nrows, K)``
ELL panel, the rest spill into a row-sorted coordinate list.  ``K`` is
their host-side rule: the largest width that at least
``max(4096, nrows / 3)`` rows fill completely, so the panel pads little
and the long tails of a power-law matrix go to the spill.  A matrix with
fewer rows than that floor is all spill.

On the device the product is ``Panel(x) + Csr(x)``
(``spmv_tpu.device.SumOf``): one gather-multiply-reduce over the panel
plus the row-block kernel over the spill.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from spmv_tpu.device import DeviceOperator, SumOf, csr, panel, row_ranks

__all__ = ["HybMatrix", "hyb_width"]

ROWS_FLOOR = 4096  # Bell & Garland's minimum count of full panel rows


def hyb_width(lengths: np.ndarray) -> int:
    """Largest K with at least ``max(4096, nrows/3)`` rows of length ≥ K
    (0 when no width qualifies)."""
    lengths = np.asarray(lengths, np.int64)
    need = max(ROWS_FLOOR, lengths.size / 3)
    if lengths.size < need:
        return 0
    # rows_at_least[k] = number of rows with length >= k
    rows_at_least = np.cumsum(np.bincount(lengths)[::-1])[::-1]
    return int(np.flatnonzero(rows_at_least >= need).max())


@dataclass
class HybMatrix(DeviceOperator):
    nrows: int
    ncols: int
    nnz: int
    K: int  # ELL panel width
    panel_nnz: int  # elements kept in the panel
    spill_nnz: int  # elements in the coordinate spill
    dev: SumOf = field(repr=False)
    # triplets in (row, col) order — the shared to_coo accessor surface
    _rows: np.ndarray = field(repr=False, default=None)
    _cols: np.ndarray = field(repr=False, default=None)
    _vals: np.ndarray = field(repr=False, default=None)

    @classmethod
    def from_coo(cls, nrows: int, ncols: int, rows: np.ndarray,
                 cols: np.ndarray, vals: np.ndarray) -> "HybMatrix":
        rows = np.asarray(rows, dtype=np.int64)
        order = np.lexsort((np.asarray(cols), rows))
        r, c, v = rows[order], np.asarray(cols)[order], np.asarray(vals)[order]
        K = hyb_width(np.bincount(r, minlength=nrows))
        k = row_ranks(r, nrows)
        keep = k < K
        dev = SumOf(parts=(
            panel(r[keep], c[keep], v[keep], nrows, K, ranks=k[keep]),
            csr(r[~keep], c[~keep], v[~keep], nrows)))
        return cls(nrows=nrows, ncols=ncols, nnz=r.size, K=K,
                   panel_nnz=int(keep.sum()), spill_nnz=int((~keep).sum()),
                   dev=dev, _rows=r, _cols=c.astype(np.int32), _vals=v)

    def to_coo(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``(rows, cols, vals)`` triplets in (row, col) order — fresh
        copies, part of every format's shared accessor surface."""
        return (np.array(self._rows, np.int64, copy=True),
                np.array(self._cols, np.int64, copy=True),
                np.array(self._vals, copy=True))
