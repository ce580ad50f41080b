"""Ring-rotated SpMV — the SpMV counterpart of ring attention.

``RowShardedSpmv(gather_x=True)`` materializes the whole x on every device
(all-gather).  The ring form keeps x **column-blocked**: device ``d`` owns
row-slab ``d`` of A (split into D column-block sub-matrices) and starts
with x block ``d``; each of the D ring steps multiplies the sub-matrix
matching the currently-held x block into the local y accumulator and
``ppermute``s the x block to the next neighbor.  Peak per-device x memory
is O(ncols/D) instead of O(ncols).  The ``ppermute`` of the held block is
issued before, and independent of, the step's product, so XLA may overlap
the transfer with the compute.

The reference has nothing comparable (no distribution at all, SURVEY.md
§2.3); this is the "large-x scaling" analog of sequence parallelism.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from spmv_tpu.device import stack
from spmv_tpu.dist.sharded import _Sharded, local, put_sharded, shard_dev
from spmv_tpu.formats.base import cdiv

__all__ = ["RingShardedSpmv"]


class RingShardedSpmv(_Sharded):
    """y = A·x, A row-partitioned × column-blocked, x rotated on a ring."""

    def __init__(self, format: str, nrows: int, ncols: int, rows, cols, vals,
                 mesh: Mesh, **fmt_kwargs):
        format = format.lower()
        if format == "bsr":
            raise NotImplementedError(
                "ring-sharded BSR not supported (block-dense container); "
                "use RowShardedSpmv('bsr', ...) or a matvec format")
        self.format, self.mesh = format, mesh
        self.axis = axis = mesh.axis_names[0]
        self.nrows, self.ncols = nrows, ncols
        D = self.D = mesh.shape[axis]
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        vals = np.asarray(vals)
        self.rps = rps = cdiv(max(nrows, 1), D)
        self.cps = cps = cdiv(max(ncols, 1), D)
        # D×D sub-matrices: (row slab d) × (column block j)
        devs = []
        for d in range(D):
            for j in range(D):
                sel = ((rows >= d * rps) & (rows < (d + 1) * rps)
                       & (cols >= j * cps) & (cols < (j + 1) * cps))
                devs.append(shard_dev(format, False, rps, cps,
                                      rows[sel] - d * rps,
                                      cols[sel] - j * cps, vals[sel],
                                      **fmt_kwargs))
        spec = NamedSharding(mesh, P(axis))
        # (D·D, ...) -> (D, D, ...): leading axis = device, second = block
        self.arrays = jax.tree.map(
            lambda a: put_sharded(a.reshape((D, D) + a.shape[1:]), spec),
            stack(devs))
        self._fn = self._build()

    def _build(self):
        axis, D, nrows = self.axis, self.D, self.nrows

        def shard_fn(x_blk, devs):
            blocks = local(devs)  # leaves (D, ...): this slab's D blocks
            my = jax.lax.axis_index(axis)

            def step(k, carry):
                x, y = carry
                j = jax.lax.rem(my - k + D, D)  # block held at step k
                x_nxt = jax.lax.ppermute(
                    x, axis, [(i, (i + 1) % D) for i in range(D)])
                sub = jax.tree.map(
                    lambda a: jax.lax.dynamic_index_in_dim(
                        a, j, axis=0, keepdims=False), blocks)
                return x_nxt, y + sub(x)

            x = x_blk[0]
            y0 = jax.lax.pcast(jnp.zeros((self.rps,) + x.shape[1:], x.dtype),
                               (axis,), to="varying")
            _, y = jax.lax.fori_loop(0, D, step, (x, y0))
            return y

        fn = shard_map(shard_fn, mesh=self.mesh,
                       in_specs=(P(axis), P(axis)), out_specs=P(axis))
        return jax.jit(lambda x, devs: fn(x, devs)[:nrows])

    def _x_in(self, x):
        x = jnp.asarray(x)
        x = jnp.pad(x, [(0, self.D * self.cps - x.shape[0])]
                    + [(0, 0)] * (x.ndim - 1))
        return put_sharded(x.reshape((self.D, self.cps) + x.shape[1:]),
                           NamedSharding(self.mesh, P(self.axis)))
