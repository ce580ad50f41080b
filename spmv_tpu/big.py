"""Slab × panel tiled SpMV on one device.

The matrix is tiled into (row slab × column panel) sub-matrices, each a
regular format container over its own rows and columns; only nonempty
tiles exist, so a banded matrix's off-band tiles cost nothing.  The
product adds each tile's partial y into its slab.  Every format's device
arrays live in device memory whole, so ``spmv_tpu.load`` never needs this
container; it stays for callers that want bounded per-tile conversions.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from spmv_tpu.device import DeviceOperator
from spmv_tpu.formats.base import cdiv

__all__ = ["TiledSpmv"]


@dataclass(frozen=True)
class Tiles:
    """Device container: ``y[slab d] += tile(x[panel j])`` per tile."""

    tiles: tuple  # per-tile device containers
    where: tuple  # static (d, j) of each tile
    rps: int
    cps: int
    DR: int
    DC: int
    nrows: int

    def __call__(self, x):
        tail = x.shape[1:]
        xp = jnp.pad(x, [(0, self.DC * self.cps - x.shape[0])]
                     + [(0, 0)] * len(tail))
        xp = xp.reshape((self.DC, self.cps) + tail)
        slabs = [jnp.zeros((self.rps,) + tail, x.dtype)
                 for _ in range(self.DR)]
        for (d, j), t in zip(self.where, self.tiles):
            slabs[d] = slabs[d] + t(xp[j])
        return jnp.concatenate(slabs, axis=0)[: self.nrows]


jax.tree_util.register_dataclass(
    Tiles, data_fields=["tiles"],
    meta_fields=["where", "rps", "cps", "DR", "DC", "nrows"])


class TiledSpmv(DeviceOperator):
    """y = A·x over (row slab × column panel) tiles of any matvec format
    (csr/coo/cmrs/ell/sell/hyb)."""

    def __init__(self, format: str, nrows: int, ncols: int, rows, cols,
                 vals, *, slab_rows: int = 1 << 20, panel_cols: int = 1 << 20,
                 **fmt_kwargs):
        from spmv_tpu.api import FORMATS

        format = format.lower()
        if format in ("bsr", "sym"):
            raise NotImplementedError(
                f"tiled {format} not supported; use csr/coo/cmrs/ell/sell/hyb")
        cls = FORMATS[format]
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        vals = np.asarray(vals)
        rps = min(slab_rows, max(nrows, 1))
        cps = min(panel_cols, max(ncols, 1))
        DR, DC = cdiv(max(nrows, 1), rps), cdiv(max(ncols, 1), cps)
        self.format, self.rps, self.cps, self.DR, self.DC = (
            format, rps, cps, DR, DC)
        self.nrows, self.ncols, self.nnz = nrows, ncols, rows.size

        tile_of = (rows // rps) * DC + (cols // cps)
        per_tile = np.bincount(tile_of, minlength=DR * DC)
        order = np.argsort(tile_of, kind="stable")
        rows, cols, vals = rows[order], cols[order], vals[order]
        bounds = np.concatenate([[0], np.cumsum(per_tile)])
        # nonempty tiles only; an all-empty matrix keeps tile (0, 0) so
        # the container has a real shape
        live = np.flatnonzero(per_tile) if rows.size else np.zeros(1, int)
        tiles, where = [], []
        for t in live:
            d, j = divmod(int(t), DC)
            lo, hi = bounds[t], bounds[t + 1]
            tiles.append(cls.from_coo(
                rps, cps, rows[lo:hi] - d * rps, cols[lo:hi] - j * cps,
                vals[lo:hi], **fmt_kwargs).dev)
            where.append((d, j))
        self.n_tiles = len(tiles)
        self.nvalid = np.bincount([d for d, _ in where], minlength=DR)
        self.dev = Tiles(tiles=tuple(tiles), where=tuple(where), rps=rps,
                         cps=cps, DR=DR, DC=DC, nrows=nrows)
