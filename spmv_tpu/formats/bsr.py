"""BSR — 128×128 block-sparse, the multi-RHS (SpMM) format.

Framework extension beyond the reference (which is strictly single-vector,
``coo.c:163-168``).  Only the nonempty (128-row block, 128-col stripe)
tiles are materialized densely; ``Y = A @ X`` is then one batched dense
matmul plus a segment-sum over block rows — plain XLA, because with R
right-hand sides the arithmetic intensity is R × SpMV's and the matrix
units are the right tool.

Trade-off: dense tiles inflate memory/traffic by ``fill = dense slots/nnz``
(17.7× on the cant-scale band matrix); only a large R can pay for that.
``from_coo`` refuses matrices whose fill exceeds ``max_fill`` (hypersparse
inputs should use a matvec format's ``matmat`` instead).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from spmv_tpu.device import DeviceOperator
from spmv_tpu.formats.base import cdiv

__all__ = ["BSRMatrix", "Blocks"]

LANES = 128  # tile edge


@dataclass(frozen=True)
class Blocks:
    """Device container: dense (T, 128, 128) tiles at (block row, column
    stripe) coordinates; ``Y = segment_sum(tiles @ X[stripe], block)``."""

    tiles: object  # (T,128,128) f32
    tile_blk: object  # (T,) i32 block row of each tile
    tile_stp: object  # (T,) i32 column stripe of each tile
    nrows: int
    ncols: int
    precision: str

    def __call__(self, x):
        X = x.reshape(x.shape[0], -1)
        R = X.shape[1]
        nb = cdiv(max(self.nrows, 1), LANES)
        ns = cdiv(max(self.ncols, 1), LANES)
        Xp = jnp.pad(X[: self.ncols], ((0, ns * LANES - self.ncols), (0, 0)))
        Xg = Xp.reshape(ns, LANES, R)[self.tile_stp]  # (T,128,R)
        P = jax.lax.dot_general(
            self.tiles, Xg, (((2,), (1,)), ((0,), (0,))),
            preferred_element_type=jnp.float32,
            precision=(jax.lax.Precision.HIGHEST
                       if self.precision == "highest"
                       else jax.lax.Precision.DEFAULT),
        )  # (T,128,R)
        Y = jax.ops.segment_sum(P, self.tile_blk, num_segments=nb)
        Y = Y.reshape(nb * LANES, R)[: self.nrows]
        return Y.reshape((self.nrows,) + x.shape[1:])


jax.tree_util.register_dataclass(
    Blocks, data_fields=["tiles", "tile_blk", "tile_stp"],
    meta_fields=["nrows", "ncols", "precision"])


@dataclass
class BSRMatrix(DeviceOperator):
    nrows: int
    ncols: int
    nnz: int
    fill: float  # dense tile slots per nonzero
    dev: Blocks = field(repr=False)

    @classmethod
    def from_coo(
        cls,
        nrows: int,
        ncols: int,
        rows: np.ndarray,
        cols: np.ndarray,
        vals: np.ndarray,
        *,
        max_fill: float = 64.0,
        precision: str = "highest",
    ) -> "BSRMatrix":
        """``precision``: "highest" keeps full fp32 products; "default"
        is the matrix units' fast mode, which on the GPU rounds the
        operands to TF32 (~3 decimal digits)."""
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        vals = np.asarray(vals)
        nnz = rows.size
        ns = cdiv(max(ncols, 1), LANES)
        pair = (rows >> 7) * ns + (cols >> 7)
        upair, inv = np.unique(pair, return_inverse=True)
        T = max(upair.size, 1)
        fill = T * LANES * LANES / max(nnz, 1)
        # Guard only when the dense blowup is material (tiny matrices are
        # cheap regardless of their fill ratio).
        if nnz and fill > max_fill and T * LANES * LANES * 4 > 16 * 2**20:
            raise ValueError(
                f"block density too low for BSR (fill {fill:.0f}x > "
                f"max_fill {max_fill}); use a matvec format instead")
        tiles = np.zeros((T, LANES, LANES), np.float32)
        if nnz:
            np.add.at(tiles, (inv, rows & (LANES - 1), cols & (LANES - 1)),
                      vals)
        tile_blk = (upair // ns).astype(np.int32) if nnz else np.zeros(1, np.int32)
        tile_stp = (upair % ns).astype(np.int32) if nnz else np.zeros(1, np.int32)
        return cls(nrows=nrows, ncols=ncols, nnz=nnz, fill=fill,
                   dev=Blocks(tiles=jnp.asarray(tiles),
                              tile_blk=jnp.asarray(tile_blk),
                              tile_stp=jnp.asarray(tile_stp),
                              nrows=nrows, ncols=ncols, precision=precision))

    @property
    def precision(self) -> str:
        return self.dev.precision

    @property
    def tiles(self):
        return self.dev.tiles

    def to_coo(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``(rows, cols, vals)`` reconstructed from the dense tiles.
        Lossy by the format's nature: explicitly-stored zeros vanish
        (a zero tile slot is padding) and duplicate inputs arrive summed
        — the triplets reproduce the *operator*, not the input list."""
        tiles = np.asarray(self.dev.tiles)
        t, rr, cc = np.nonzero(tiles)
        if self.nnz == 0:
            z = np.zeros(0, np.int64)
            return z, z.copy(), np.zeros(0)
        blk = np.asarray(self.dev.tile_blk, np.int64)[t]
        stp = np.asarray(self.dev.tile_stp, np.int64)[t]
        return (blk * LANES + rr, stp * LANES + cc,
                tiles[t, rr, cc].astype(np.float64))

    def __matmul__(self, X):
        return self.matmat(X)
