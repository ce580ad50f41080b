"""Multi-device SpMV via shard_map over a 1-D device mesh.

The reference has no distribution at all (SURVEY.md §2.3); this layer is
the framework's scaling dimension:

* **Row partition** (``RowShardedSpmv``): each device owns a contiguous
  slab of matrix rows and computes its y slab — y comes out sharded, no
  collective on y.  x is either replicated (``gather_x=False``) or
  row-sharded and all-gathered inside the shard (``gather_x=True``).
* **Column partition** (``ColShardedSpmv``): each device owns a column
  slab of A and the matching x slab, computes a full-length partial y,
  and ``psum``s.

Every shard is an ordinary format container over its slab (the format's
own product, ``spmv_tpu.device``); the shards are stacked along
a leading device axis, padded to one shape with inert slots
(``device.stack``), so one jitted ``shard_map`` serves every device.
``x`` may be a vector or an (ncols, R) block: the same program runs SpMM.
With ``dtype="f32x2"`` the shards carry fp64 (hi, lo) value planes and the
product runs in fp64 (``spmv_tpu.x2``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from spmv_tpu.device import stack
from spmv_tpu.formats.base import cdiv

__all__ = ["RowShardedSpmv", "ColShardedSpmv", "put_sharded"]


def put_sharded(v, sharding):
    """Place a host array as a (possibly multi-process) global jax.Array.

    ``jax.device_put`` cannot target non-addressable devices; with the
    callback form each process materializes only its own shards, so the
    same code path serves single-process meshes and true multi-host runs
    brought up via ``mesh.init_distributed`` (every process holds the same
    deterministic host copy, so slicing by index is consistent)."""
    v = np.asarray(v)
    return jax.make_array_from_callback(v.shape, sharding,
                                        lambda idx: v[idx])


def _x2_mode(dtype: str) -> bool:
    if dtype not in ("f32", "f32x2"):
        raise ValueError(f"dtype must be 'f32' or 'f32x2', got {dtype!r}")
    return dtype == "f32x2"


def shard_dev(format: str, x2: bool, nrows: int, ncols: int, rows, cols,
              vals, **fmt_kwargs):
    """One shard's device container (fp64 planes when ``x2``)."""
    if x2:
        from spmv_tpu.x2 import x2_build

        return x2_build(format, nrows, ncols, rows, cols, vals)
    from spmv_tpu.api import FORMATS

    return FORMATS[format].from_coo(nrows, ncols, rows, cols, vals,
                                    **fmt_kwargs).dev


def local(devs):
    """Inside ``shard_map``: drop the (size-1) device axis of every leaf."""
    return jax.tree.map(lambda a: a[0], devs)


class _Sharded:
    """Shared matvec / matmat plumbing: ``self._fn(x, arrays)`` is the
    jitted sharded product; ``_x_in`` lays x out for it."""

    x2 = False

    def _product(self, x, ndim: int):
        dt = np.float64 if self.x2 else np.float32
        x = np.asarray(x, dt)
        if x.ndim != ndim or x.shape[0] != self.ncols:
            want = f"({self.ncols},)" if ndim == 1 else f"({self.ncols}, R)"
            raise ValueError(f"x must be {want}, got {x.shape}")
        if not self.x2:
            return self._fn(self._x_in(x), self.arrays)
        from spmv_tpu.x2 import x2_apply

        return x2_apply(lambda xx: self._fn(self._x_in(xx), self.arrays),
                        x)

    def matvec(self, x):
        return self._product(x, 1)

    def matmat(self, X):
        return self._product(X, 2)

    spmm = matmat
    __matmul__ = matvec


class RowShardedSpmv(_Sharded):
    """y = A·x with A row-partitioned over ``mesh``'s single axis."""

    def __init__(self, format: str, nrows: int, ncols: int, rows, cols, vals,
                 mesh: Mesh, *, gather_x: bool = True, dtype: str = "f32",
                 **fmt_kwargs):
        format = format.lower()
        self.x2 = _x2_mode(dtype)
        if self.x2 and format == "bsr":
            raise NotImplementedError("f32x2 BSR is not supported")
        self.format, self.mesh = format, mesh
        self.axis = axis = mesh.axis_names[0]
        self.nrows, self.ncols = nrows, ncols
        self.gather_x = gather_x
        D = mesh.shape[axis]
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        vals = np.asarray(vals)
        self.rps = rps = cdiv(max(nrows, 1), D)
        devs = []
        for d in range(D):
            sel = (rows >= d * rps) & (rows < (d + 1) * rps)
            devs.append(shard_dev(format, self.x2, rps, ncols,
                                  rows[sel] - d * rps, cols[sel], vals[sel],
                                  **fmt_kwargs))
        spec = NamedSharding(mesh, P(axis))
        self.arrays = jax.tree.map(lambda a: put_sharded(a, spec),
                                   stack(devs))
        # x rows padded so the shard axis divides them evenly
        self.x_rows = cdiv(max(ncols, 1), D) * D
        self._fn = self._build()

    def _build(self):
        axis, ncols, nrows = self.axis, self.ncols, self.nrows
        gather_x = self.gather_x

        def shard_fn(x, devs):
            if gather_x:
                x = jax.lax.all_gather(x, axis, axis=0, tiled=True)
            return local(devs)(x[:ncols])

        fn = shard_map(shard_fn, mesh=self.mesh,
                       in_specs=(P(axis) if gather_x else P(), P(axis)),
                       out_specs=P(axis))
        return jax.jit(lambda x, devs: fn(x, devs)[:nrows])

    def _x_in(self, x):
        x = jnp.asarray(x)
        if not self.gather_x:
            return x
        x = jnp.pad(x, [(0, self.x_rows - x.shape[0])]
                    + [(0, 0)] * (x.ndim - 1))
        return put_sharded(x, NamedSharding(self.mesh, P(self.axis)))

    def _matvec_traced(self, v, arrays):
        """Traceable matvec for composing into larger jitted programs
        (``spmv_tpu.solve``): x is laid out by a sharding constraint, so
        the whole caller — e.g. a Krylov loop — compiles as ONE SPMD
        program over the mesh."""
        if self.gather_x:
            v = jnp.pad(v, (0, self.x_rows - v.shape[0]))
            v = jax.lax.with_sharding_constraint(
                v, NamedSharding(self.mesh, P(self.axis)))
        return self._fn(v, arrays)


class ColShardedSpmv(_Sharded):
    """y = A·x with A column-partitioned (x sharded, partial-y psum)."""

    def __init__(self, format: str, nrows: int, ncols: int, rows, cols, vals,
                 mesh: Mesh, *, dtype: str = "f32", **fmt_kwargs):
        format = format.lower()
        self.x2 = _x2_mode(dtype)
        if format == "bsr":
            raise NotImplementedError(
                "column-sharded BSR not supported (a dense-Y psum per "
                "product defeats the block-dense format); use "
                "RowShardedSpmv('bsr', ...) or shard a matvec format")
        self.format, self.mesh = format, mesh
        self.axis = axis = mesh.axis_names[0]
        self.nrows, self.ncols = nrows, ncols
        D = self.D = mesh.shape[axis]
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        vals = np.asarray(vals)
        self.cps = cps = cdiv(max(ncols, 1), D)
        devs = []
        for d in range(D):
            sel = (cols >= d * cps) & (cols < (d + 1) * cps)
            devs.append(shard_dev(format, self.x2, nrows, cps, rows[sel],
                                  cols[sel] - d * cps, vals[sel],
                                  **fmt_kwargs))
        spec = NamedSharding(mesh, P(axis))
        self.arrays = jax.tree.map(lambda a: put_sharded(a, spec),
                                   stack(devs))
        self._fn = self._build()

    def _build(self):
        axis = self.axis

        def shard_fn(x, devs):
            return jax.lax.psum(local(devs)(x[0]), axis)

        return jax.jit(shard_map(shard_fn, mesh=self.mesh,
                                 in_specs=(P(axis), P(axis)),
                                 out_specs=P()))

    def _blocks(self, x):
        """(ncols, ...) → (D, cps, ...) column slabs."""
        x = jnp.pad(x, [(0, self.D * self.cps - x.shape[0])]
                    + [(0, 0)] * (x.ndim - 1))
        return x.reshape((self.D, self.cps) + x.shape[1:])

    def _x_in(self, x):
        return put_sharded(self._blocks(jnp.asarray(x)),
                           NamedSharding(self.mesh, P(self.axis)))

    def _matvec_traced(self, v, arrays):
        """Traceable matvec (see ``RowShardedSpmv._matvec_traced``)."""
        xs = jax.lax.with_sharding_constraint(
            self._blocks(v), NamedSharding(self.mesh, P(self.axis)))
        return self._fn(xs, arrays)
