"""SELL-C-σ — sliced ELLPACK with local row sorting.

Reference: ``/root/reference/sigma_c.c`` + ``kernels/Sigma_C.cl``.  The
reference implements only the C-slicing half (C=32, one wavefront per
slice, ``sigma_c.c:48``) and delegates the σ-sort to an offline pre-sorted
*file* (``cant-sorted.mtx``), never unpermuting the output.

Here:
* **C = 32**, the reference's slice height;
* **σ is real**: rows are sorted by descending length within σ-row
  windows at conversion, and the output is unpermuted on the device by
  one gather;
* each slice is padded to its own width K_s (``slice_widths``, with
  calloc-style explicit zeros, ``sigma_c.c:153-154``).  On the device,
  slices whose widths round to the same bucket (within 25 %, exact up to
  8) share one padded ``(rows, K)`` slab, so a matrix costs a handful of
  gather-multiply-reduce fusions instead of one per slice
  (``spmv_tpu.device.Permuted``).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from spmv_tpu.device import DeviceOperator, Permuted, panel, row_ranks
from spmv_tpu.formats.base import cdiv

__all__ = ["SellMatrix", "DEFAULT_SIGMA", "C", "bucket_width"]

C = 32  # slice height, sigma_c.c:48
DEFAULT_SIGMA = 1024  # rows per sorting window


def bucket_width(k):
    """Device slab width of a slice of width ``k``: exact up to 8, then
    rounded up to a quarter of k's octave (at most 25 % padding)."""
    k = np.asarray(k, np.int64)
    step = np.left_shift(1, np.maximum(
        np.ceil(np.log2(np.maximum(k, 1))).astype(np.int64) - 3, 0))
    return np.where(k <= 8, k, -(-k // step) * step)


def sigma_sort(rows, nrows: int, sigma: int):
    """Sort rows by descending length within σ-row windows.  Returns
    ``(perm, lengths_pad)``: ``perm[sorted position] = original row`` over
    ``nrows`` padded to whole windows (pad rows are empty)."""
    lengths = np.bincount(np.asarray(rows, np.int64), minlength=nrows)
    nrows_pad = cdiv(max(nrows, 1), sigma) * sigma
    lengths_pad = np.zeros(nrows_pad, np.int64)
    lengths_pad[:nrows] = lengths
    win = lengths_pad.reshape(-1, sigma)
    order = np.argsort(-win, axis=1, kind="stable")
    perm = (np.arange(win.shape[0], dtype=np.int64)[:, None] * sigma
            + order).reshape(-1)
    return perm, lengths_pad


@dataclass
class SellMatrix(DeviceOperator):
    nrows: int
    ncols: int
    nnz: int
    sigma: int
    slice_widths: np.ndarray  # per-slice padded K (slices of C sorted rows)
    dev: Permuted = field(repr=False)
    sorted_rows: bool = False  # did the σ-sort move any row?
    # sorted-space triplets + row permutation, kept to materialize the
    # classical sliced arrays on demand (sigma_c.c:156-202 parity)
    _rows_sorted: np.ndarray = field(repr=False, default=None)
    _cols: np.ndarray = field(repr=False, default=None)
    _vals: np.ndarray = field(repr=False, default=None)
    _perm: np.ndarray = field(repr=False, default=None)  # sorted pos -> orig

    C = C

    @classmethod
    def from_coo(cls, nrows: int, ncols: int, rows: np.ndarray,
                 cols: np.ndarray, vals: np.ndarray, *,
                 sigma: int = DEFAULT_SIGMA) -> "SellMatrix":
        import jax.numpy as jnp

        if sigma % C or sigma <= 0:
            raise ValueError(f"sigma must be a positive multiple of {C}")
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols)
        vals = np.asarray(vals)
        perm, lengths_pad = sigma_sort(rows, nrows, sigma)
        invperm = np.empty_like(perm)
        invperm[perm] = np.arange(perm.size)
        widths = lengths_pad[perm].reshape(-1, C).max(axis=1)

        # slices grouped by bucket width: slab b holds the slices of its
        # width in order; slot(sorted row) = its row in concat(slabs)
        # (rows past nrows are σ-padding: the sort puts them last, so the
        # device slices stop at nrows)
        bucket = bucket_width(widths)
        slab_widths = np.unique(bucket)
        slice_order = np.argsort(bucket, kind="stable")
        size = np.clip(nrows - np.arange(widths.size) * C, 0, C)
        slice_slot = np.empty(widths.size, np.int64)
        slice_slot[slice_order] = np.cumsum(size[slice_order]) - size[slice_order]
        sp = invperm[rows]
        order = np.lexsort((cols, sp))
        sp_s, cols_s, vals_s = sp[order], cols[order], vals[order]
        slot = slice_slot[sp_s // C] + sp_s % C
        k = row_ranks(sp_s, perm.size)
        starts = np.concatenate(
            [[0], np.cumsum([size[bucket == w].sum() for w in slab_widths])])
        parts = []
        for b, w in enumerate(slab_widths):
            sel = (slot >= starts[b]) & (slot < starts[b + 1])
            parts.append(panel(slot[sel] - starts[b], cols_s[sel],
                               vals_s[sel], int(starts[b + 1] - starts[b]),
                               int(w), ranks=k[sel]))
        out_slot = slice_slot[invperm[:nrows] // C] + invperm[:nrows] % C
        return cls(
            nrows=nrows, ncols=ncols, nnz=rows.size, sigma=sigma,
            slice_widths=widths,
            dev=Permuted(parts=tuple(parts),
                         perm=jnp.asarray(out_slot.astype(np.int32))),
            sorted_rows=bool((perm[:nrows] != np.arange(nrows)).any()),
            _rows_sorted=sp_s, _cols=cols_s.astype(np.int32), _vals=vals_s,
            _perm=perm)

    @classmethod
    def from_sell(cls, nrows: int, ncols: int, slice_ptr: np.ndarray,
                  data: np.ndarray, cols: np.ndarray,
                  perm: np.ndarray | None = None, **kwargs) -> "SellMatrix":
        """Ingest the classical sliced arrays (``sigma_c.c:156-202``):
        element j of row r of slice s sits at ``slice_ptr[s] + r + j·C``
        (column-major within the slice).  ``perm`` maps sorted position →
        original row (identity when, like the reference, the rows were
        pre-sorted outside and never unpermuted).  Pad slots are value 0."""
        slice_ptr = np.asarray(slice_ptr, dtype=np.int64)
        data = np.asarray(data).reshape(-1)
        cols = np.asarray(cols).reshape(-1)
        if data.size != slice_ptr[-1]:
            raise ValueError(f"data has {data.size} slots, slice_ptr ends at "
                             f"{slice_ptr[-1]}")
        nz = np.flatnonzero(data != 0)
        s = np.searchsorted(slice_ptr, nz, side="right") - 1
        sr = s * C + (nz - slice_ptr[s]) % C  # sorted row
        orig = sr if perm is None else np.asarray(perm, np.int64)[sr]
        return cls.from_coo(nrows, ncols, orig, cols[nz], data[nz], **kwargs)

    def sell_arrays(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The classical sliced arrays ``(slice_ptr, data, cols)``
        (``sigma_c.c:84-202``): per slice of C sorted rows a padded
        width K_s = ``slice_widths[s]``; column-major packing within the
        slice; calloc-style zero padding."""
        widths = np.asarray(self.slice_widths, np.int64)
        slice_ptr = np.zeros(widths.size + 1, dtype=np.int64)
        np.cumsum(widths * C, out=slice_ptr[1:])
        data = np.zeros(max(int(slice_ptr[-1]), 1), dtype=np.float64)
        colsa = np.zeros(max(int(slice_ptr[-1]), 1), dtype=np.int32)
        sr = self._rows_sorted
        if sr.size:
            k = np.arange(sr.size) - np.searchsorted(sr, sr)
            pos = slice_ptr[sr // C] + sr % C + k * C
            data[pos] = self._vals
            colsa[pos] = self._cols
        return slice_ptr, data, colsa

    def to_coo(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``(rows, cols, vals)`` triplets with ORIGINAL row ids (the σ
        relabeling undone via ``perm``) — fresh copies, part of every
        format's shared accessor surface."""
        return (self._perm[self._rows_sorted],
                np.array(self._cols, np.int64, copy=True),
                np.array(self._vals, copy=True))

    @property
    def perm(self) -> np.ndarray:
        """sorted position → original row (identity when unsorted)."""
        return self._perm

    @staticmethod
    def cpu_spmv(slice_ptr, data, cols, perm, x, nrows: int) -> np.ndarray:
        """Independent host recompute from the classical sliced arrays —
        the redundancy check the reference *lacks* for this format
        (sigma_c is its only driver without ``compute_using_cpu``,
        SURVEY.md §2.2)."""
        slice_ptr = np.asarray(slice_ptr, np.int64)
        data = np.asarray(data, np.float64).reshape(-1)
        cols = np.asarray(cols).reshape(-1)
        x = np.asarray(x, np.float64)
        n = data.size
        s = np.searchsorted(slice_ptr, np.arange(n), side="right") - 1
        sr = s * C + (np.arange(n) - slice_ptr[s]) % C
        orig = sr if perm is None else np.asarray(perm, np.int64)[sr]
        y = np.zeros(max(int(orig.max(initial=0)) + 1, nrows), np.float64)
        np.add.at(y, orig, data * x[cols])
        return y[:nrows]
