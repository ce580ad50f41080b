"""Chunked-gather row-sharded SpMV — communication/compute overlap for
the all-gather form.

``RowShardedSpmv(gather_x=True)`` all-gathers the WHOLE x, then computes:
the collective and the product serialize by construction.
``ChunkedRowSpmv`` splits the gather into C chunks and each device's row
slab into C matching column sub-matrices; each step issues the NEXT
chunk's all-gather first (data-independent of this step's product) and
computes on the chunk gathered in the previous step, so XLA's scheduler
may run the transfer concurrently with the compute.  Peak per-device
gathered-x memory is O(ncols/C) instead of O(ncols), and total gather
traffic is unchanged (C gathers of 1/C each).

x is padded to S = round_up(ncols, D·C) entries; device o holds entries
[o·S/D, (o+1)·S/D).  Chunk c of the gather is the ``all_gather`` of every
device's local entries [c·s, (c+1)·s) (s = S/(D·C)), which concatenates
device-major: global column t = o·S/D + l (l the local offset) lands at
o·s + (l − c·s).  Sub-matrix c therefore holds the columns with
``l // s == c``, renumbered to that layout.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from spmv_tpu.device import stack
from spmv_tpu.dist.sharded import _Sharded, local, put_sharded, shard_dev
from spmv_tpu.formats.base import cdiv, round_up

__all__ = ["ChunkedRowSpmv"]


class ChunkedRowSpmv(_Sharded):
    """y = A·x, A row-partitioned, x row-sharded and all-gathered in C
    chunks interleaved with per-chunk compute (the overlapped form of
    ``RowShardedSpmv(gather_x=True)``)."""

    def __init__(self, format: str, nrows: int, ncols: int, rows, cols,
                 vals, mesh: Mesh, *, chunks: int = 4, **fmt_kwargs):
        format = format.lower()
        if format == "bsr":
            raise NotImplementedError(
                "chunked-gather BSR not supported; use "
                "RowShardedSpmv('bsr', ...)")
        self.format, self.mesh = format, mesh
        self.axis = axis = mesh.axis_names[0]
        self.nrows, self.ncols = nrows, ncols
        D = self.D = mesh.shape[axis]
        C = self.C = max(int(chunks), 1)
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        vals = np.asarray(vals)
        self.rps = rps = cdiv(max(nrows, 1), D)
        self.S = S = round_up(max(ncols, 1), D * C)
        self.s = s = S // (D * C)  # local entries per chunk
        owner, lcol = cols // (S // D), cols % (S // D)
        chunk_of = lcol // s
        new_cols = owner * s + lcol % s
        devs = []
        for d in range(D):
            rsel = (rows >= d * rps) & (rows < (d + 1) * rps)
            for c in range(C):
                sel = rsel & (chunk_of == c)
                devs.append(shard_dev(format, False, rps, D * s,
                                      rows[sel] - d * rps, new_cols[sel],
                                      vals[sel], **fmt_kwargs))
        spec = NamedSharding(mesh, P(axis))
        self.arrays = jax.tree.map(
            lambda a: put_sharded(a.reshape((D, C) + a.shape[1:]), spec),
            stack(devs))
        self._fn = self._build()

    def _build(self):
        axis, C, s, nrows = self.axis, self.C, self.s, self.nrows

        def shard_fn(x_local, devs):
            subs = local(devs)  # leaves (C, ...)

            def gather(c):
                return jax.lax.all_gather(x_local[c * s:(c + 1) * s], axis,
                                          axis=0, tiled=True)

            # software pipeline: chunk c+1's all-gather is issued before
            # chunk c's product and depends only on x_local (C is small
            # and static — the loop unrolls)
            y = 0
            g = gather(0)
            for c in range(C):
                g_nxt = gather(c + 1) if c + 1 < C else None
                y = y + jax.tree.map(lambda a: a[c], subs)(g)
                g = g_nxt
            return y

        fn = shard_map(shard_fn, mesh=self.mesh,
                       in_specs=(P(axis), P(axis)), out_specs=P(axis))
        return jax.jit(lambda x, devs: fn(x, devs)[:nrows])

    def _x_in(self, x):
        x = jnp.asarray(x)
        x = jnp.pad(x, [(0, self.S - x.shape[0])] + [(0, 0)] * (x.ndim - 1))
        return put_sharded(x, NamedSharding(self.mesh, P(self.axis)))
