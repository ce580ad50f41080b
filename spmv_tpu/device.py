"""Device arrays of the sparse formats and the products over them.

Every format keeps its canonical host arrays (``CSRMatrix.ptr/cols/vals``
and so on) and builds ONE device representation from them: ``int32``
indices and ``float32`` values.  The products:

* :class:`Csr` — row pointers, columns and values of row-sorted
  nonzeros (csr, cmrs, HYB's spill, both passes of sym).  The product is
  the row-block kernel of ``spmv_tpu.csr_kernel`` (Pallas, Triton route):
  one program per block of rows, no atomics.  ``csr_kernel.csr_product``
  says when it runs the plain-XLA reference (a ``segment_sum``)
  instead.
* :class:`Seg` — ``y = segment_sum(vals * x[cols], rows)`` over the
  triplets in file order: COO, whose reference kernel is an atomic
  scatter (``Coo.cl``).  On the GPU the sum adds with atomics, so its
  order changes from run to run and COO results are not bitwise
  deterministic (``spmv_tpu.oracle`` states the tolerance).
* :class:`Panel` — padded ``(n, K)`` column and value slabs:
  ``y = sum(vals * x[cols], axis=1)`` (ELL, HYB's panel, SELL's slices).
* :class:`SumOf` — ``y = Σ parts(x)`` (HYB's panel + spill, sym).
* :class:`Permuted` — ``y = concat(parts(x))[perm]`` (SELL-C-σ: slices
  grouped by width, the σ-sort undone by one gather).

``x`` is a vector ``(ncols,)`` or a block ``(ncols, R)``: one pass serves
any number of right-hand sides.

Extended precision (``spmv_tpu.x2``): a container may carry ``vals_lo``,
the float32 residual of each fp64 value.  The product then runs in fp64
over ``hi + lo`` — the caller traces it inside ``jax.enable_x64``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from spmv_tpu.csr_kernel import REGULAR, block_shape, csr_product

__all__ = ["Csr", "Seg", "Panel", "SumOf", "Permuted", "DeviceOperator",
           "apply", "csr", "seg", "panel", "row_ranks", "nbytes", "slots",
           "stack", "with_lo", "split_x2"]


def _values(vals, vals_lo, x):
    """The value plane(s) in x's precision, broadcast over x's trailing
    (right-hand-side) axes."""
    if vals_lo is None:
        v = vals.astype(x.dtype)
    else:
        v = vals.astype(jnp.float64) + vals_lo.astype(jnp.float64)
    return v.reshape(v.shape + (1,) * (x.ndim - 1))


@dataclass(frozen=True)
class Csr:
    ptr: object  # (nrows+1,) int32 row pointers
    cols: object  # (max(nnz, 1),) int32, row-major
    vals: object  # (max(nnz, 1),) float32
    vals_lo: object = None  # float32 residual plane, or None
    block: tuple = REGULAR  # kernel block shape (csr_kernel.block_shape)

    def __call__(self, x):
        return csr_product(self.ptr, self.cols, self.vals, self.vals_lo, x,
                           block=self.block)


@dataclass(frozen=True)
class Seg:
    rows: object  # (nnz,) int32 output row of each nonzero
    cols: object  # (nnz,) int32
    vals: object  # (nnz,) float32
    vals_lo: object = None  # (nnz,) float32 residual plane, or None
    nrows: int = 0

    def __call__(self, x):
        prod = _values(self.vals, self.vals_lo, x) * x[self.cols]
        return jax.ops.segment_sum(prod, self.rows, num_segments=self.nrows)


@dataclass(frozen=True)
class Panel:
    cols: object  # (n, K) int32; pad slots point at column 0
    vals: object  # (n, K) float32; pad slots hold 0
    vals_lo: object = None

    def __call__(self, x):
        return jnp.sum(_values(self.vals, self.vals_lo, x) * x[self.cols],
                       axis=1)


@dataclass(frozen=True)
class SumOf:
    parts: tuple

    def __call__(self, x):
        return sum((p(x) for p in self.parts[1:]), self.parts[0](x))


@dataclass(frozen=True)
class Permuted:
    parts: tuple  # Panels, in slab order
    perm: object  # (nrows,) int32: row r's position in concat(parts)

    def __call__(self, x):
        return jnp.concatenate([p(x) for p in self.parts], axis=0)[self.perm]


jax.tree_util.register_dataclass(
    Csr, data_fields=["ptr", "cols", "vals", "vals_lo"],
    meta_fields=["block"])
jax.tree_util.register_dataclass(
    Seg, data_fields=["rows", "cols", "vals", "vals_lo"],
    meta_fields=["nrows"])
jax.tree_util.register_dataclass(
    Panel, data_fields=["cols", "vals", "vals_lo"], meta_fields=[])
jax.tree_util.register_dataclass(SumOf, data_fields=["parts"],
                                 meta_fields=[])
jax.tree_util.register_dataclass(Permuted, data_fields=["parts", "perm"],
                                 meta_fields=[])


@jax.jit
def apply(dev, x):
    """y = A·x (or A·X) for any device container; one compile per
    container structure and shape."""
    return dev(x)


def nbytes(dev) -> int:
    """Device bytes of a container: what one product streams, padding
    included (x and y not counted)."""
    return sum(int(a.nbytes) for a in jax.tree.leaves(dev))


def slots(dev) -> int:
    """Padded element slots (nonzeros plus padding) of a container."""
    if isinstance(dev, (Csr, Seg, Panel)):
        return int(dev.vals.size)
    kids = getattr(dev, "parts", getattr(dev, "tiles", None))
    if isinstance(kids, tuple):
        return sum(slots(k) for k in kids)
    return int(kids.size)  # dense block tiles


def split_x2(vals):
    """fp64 values → (hi, lo) float32 planes with hi + lo ≈ vals to
    ~2⁻⁴⁸ relative."""
    v64 = np.asarray(vals, np.float64)
    hi = v64.astype(np.float32)
    return hi, (v64 - hi.astype(np.float64)).astype(np.float32)


# ---------------------------------------------------------------- builders


def csr(rows, cols, vals, nrows: int) -> Csr:
    """Csr container from row-sorted triplets.  An empty matrix keeps one
    inert slot (column 0, value 0) so every array has a real shape."""
    rows = np.asarray(rows, np.int64)
    if rows.size and (np.diff(rows) < 0).any():
        raise ValueError("csr container needs triplets sorted by row")
    lengths = np.bincount(rows, minlength=nrows)
    ptr = np.zeros(nrows + 1, np.int64)
    np.cumsum(lengths, out=ptr[1:])
    n = max(rows.size, 1)
    c = np.zeros(n, np.int32)
    v = np.zeros(n, np.float32)
    c[:rows.size] = cols
    v[:rows.size] = vals
    return Csr(ptr=jnp.asarray(ptr.astype(np.int32)), cols=jnp.asarray(c),
               vals=jnp.asarray(v), block=block_shape(lengths))


def seg(rows, cols, vals, nrows: int) -> Seg:
    return Seg(rows=jnp.asarray(np.asarray(rows, np.int32)),
               cols=jnp.asarray(np.asarray(cols, np.int32)),
               vals=jnp.asarray(np.asarray(vals, np.float32)),
               nrows=int(nrows))


def row_ranks(rows: np.ndarray, nrows: int) -> np.ndarray:
    """Rank of each element within its row, for triplets sorted by row."""
    rows = np.asarray(rows, np.int64)
    starts = np.zeros(nrows + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=nrows), out=starts[1:])
    return np.arange(rows.size, dtype=np.int64) - starts[rows]


def panel(rows, cols, vals, n: int, K: int, ranks=None) -> Panel:
    """(n, K) slabs from row-sorted triplets whose rank within their row
    is below K (``ranks`` defaults to :func:`row_ranks`)."""
    rows = np.asarray(rows, np.int64)
    k = row_ranks(rows, n) if ranks is None else ranks
    c2 = np.zeros((n, K), np.int32)
    v2 = np.zeros((n, K), np.float32)
    c2[rows, k] = cols
    v2[rows, k] = vals
    return Panel(cols=jnp.asarray(c2), vals=jnp.asarray(v2))


def with_lo(hi, lo):
    """``hi``'s container with ``lo``'s value planes as its residuals —
    ``lo`` is the same format built from the residual values, and the
    layouts depend only on the sparsity pattern, so the two agree slot
    for slot."""
    if isinstance(hi, (Csr, Seg, Panel)):
        return dataclasses.replace(hi, vals_lo=lo.vals)
    return dataclasses.replace(
        hi, parts=tuple(with_lo(h, l) for h, l in zip(hi.parts, lo.parts)))


class DeviceOperator:
    """matvec / matmat for a format container holding ``dev``,
    ``nrows`` and ``ncols``."""

    def matvec(self, x):
        x = jnp.asarray(x, jnp.float32)
        if x.ndim != 1 or x.shape[0] != self.ncols:
            raise ValueError(f"x has {x.size} entries, matrix has "
                             f"{self.ncols} columns")
        return apply(self.dev, x)

    def matmat(self, X):
        X = jnp.asarray(X, jnp.float32)
        if X.ndim != 2 or X.shape[0] != self.ncols:
            raise ValueError(f"X must be ({self.ncols}, R), got {X.shape}")
        return apply(self.dev, X)

    def __matmul__(self, x):
        return self.matvec(x)

    @property
    def padded_bytes(self) -> int:
        return nbytes(self.dev)

    @property
    def padded_slots(self) -> int:
        return slots(self.dev)


# ------------------------------------------------------- stacking (dist)


def _pad_to(a: np.ndarray, shape, fill=0) -> np.ndarray:
    out = np.full(shape, fill, dtype=a.dtype)
    out[tuple(slice(0, s) for s in a.shape)] = a
    return out


def _stack_arrays(arrs, fill=0):
    arrs = [np.asarray(a) for a in arrs]
    shape = tuple(max(s) for s in zip(*(a.shape for a in arrs)))
    return np.stack([_pad_to(a, shape, fill) for a in arrs])


def stack(devs):
    """One container whose leaves carry a leading shard axis, from
    per-shard containers of the same format: every shard is padded to the
    largest with inert slots (column 0, value 0) so one program serves
    them all.  Leaves are host arrays; the caller places them."""
    d0 = devs[0]
    if isinstance(d0, Permuted):
        return _stack_permuted(devs)
    if isinstance(d0, SumOf):
        return SumOf(parts=tuple(stack(ps)
                                 for ps in zip(*(d.parts for d in devs))))
    leaves = {f.name: _stack_arrays([getattr(d, f.name) for d in devs])
              for f in dataclasses.fields(d0)
              if hasattr(getattr(d0, f.name), "shape")}
    return dataclasses.replace(d0, **leaves)


def _stack_permuted(devs):
    """SELL shards group their slices by different widths: align them on
    the union of widths (a shard without a width gets an empty slab) and
    re-point each shard's ``perm`` into the padded concatenation."""
    widths = sorted({int(p.cols.shape[1]) for d in devs for p in d.parts})
    empty = {w: Panel(cols=np.zeros((0, w), np.int32),
                      vals=np.zeros((0, w), np.float32),
                      vals_lo=(None if devs[0].parts[0].vals_lo is None
                               else np.zeros((0, w), np.float32)))
             for w in widths}
    by_width = [{int(p.cols.shape[1]): p for p in d.parts} for d in devs]
    rows_of = [max(int(bw.get(w, empty[w]).cols.shape[0]) for bw in by_width)
               for w in widths]
    new_start = np.concatenate([[0], np.cumsum(rows_of)])
    perms = []
    for d in devs:
        sizes = [int(p.cols.shape[0]) for p in d.parts]
        old_start = np.concatenate([[0], np.cumsum(sizes)])
        perm = np.asarray(d.perm, np.int64)
        part = np.searchsorted(old_start, perm, side="right") - 1
        target = np.array([widths.index(int(p.cols.shape[1]))
                           for p in d.parts], np.int64)
        perms.append(new_start[target[part]] + perm - old_start[part])
    parts = tuple(stack([bw.get(w, empty[w]) for bw in by_width])
                  for w in widths)
    return Permuted(parts=parts, perm=_stack_arrays(perms).astype(np.int32))
