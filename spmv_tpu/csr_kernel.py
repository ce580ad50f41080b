"""Row-block CSR product as a Pallas kernel on the Triton route.

One program takes ``block_rows`` consecutive rows.  It loads their row
pointers, then walks the rows together in steps of ``block_k`` slots up
to the block's longest row: masked loads of columns and values, a gather
of x, a multiply, and a sum along the step, all in registers.  Every row
is summed by exactly one program, so no atomics are needed and the row
sums are deterministic, unlike ``segment_sum``'s atomic scatter.

A block of right-hand sides ``X`` of shape ``(ncols, R)`` adds a second
grid axis over column blocks of ``block_r``.  With an fp64 ``x`` the sum
runs in fp64 over ``vals + vals_lo`` (``spmv_tpu.x2``).

``csr_product`` chooses between the kernel and a plain-XLA reference (a
``segment_sum``) from what it can see, after measurements on the
H100 (PERF.md):

* a single vector x: the kernel (1.3× to 6× faster than ``segment_sum``
  on the cant-scale, 4.2M-row band and 524k power-law matrices);
* a block X on a matrix with regular rows: the kernel (1.1× to 1.6×
  faster on the cant-scale matrix at R = 4, 32, 100);
* a block X on a matrix with ragged rows: the reference.  There the
  kernel re-walks each block's longest row once per column block of X,
  and was 2.5× to 3.5× slower on the 524k power law.

Lowered for any platform other than the GPU (the CPU test
configuration), ``csr_product`` runs the reference; the kernel itself is
tested there in Pallas's interpreter (``rowblock(..., interpret=True)``).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

__all__ = ["csr_product", "rowblock", "reference", "block_shape"]

# (rows per program, slots per step, warps)
REGULAR = (64, 16, 4)
RAGGED = (8, 32, 2)
# From this many columns of X on, the reference tells ``segment_sum`` its
# rows are sorted (see ``reference``).
SORTED_FROM_R = 16


def block_shape(lengths: np.ndarray) -> tuple[int, int, int]:
    """Block shape for a matrix with these row lengths.  A program walks
    all its rows up to the longest one, so 64-row programs waste slots
    when rows are ragged: when they would walk more than twice the
    nonzeros, programs take 8 rows (measured on the H100 in PERF.md)."""
    lengths = np.asarray(lengths, np.int64)
    br, bk, _ = REGULAR
    n = -(-max(lengths.size, 1) // br) * br
    padded = np.zeros(n, np.int64)
    padded[:lengths.size] = lengths
    walked = br * bk * (-(-padded.reshape(-1, br).max(axis=1) // bk)).sum()
    return REGULAR if walked <= 2 * max(int(lengths.sum()), 1) else RAGGED


def _kernel(*refs, nrows, nrhs, block_rows, block_k, block_r, has_lo):
    if has_lo:
        ptr_ref, cols_ref, vals_ref, lo_ref, x_ref, y_ref = refs
    else:
        ptr_ref, cols_ref, vals_ref, x_ref, y_ref = refs
    dt = y_ref.dtype
    rows = pl.program_id(0) * block_rows + jnp.arange(block_rows)
    live = rows < nrows
    start = plgpu.load(ptr_ref.at[rows], mask=live, other=0)
    end = plgpu.load(ptr_ref.at[rows + 1], mask=live, other=0)
    steps = (jnp.max(end - start) + block_k - 1) // block_k
    lane = jnp.arange(block_k)
    if nrhs:  # x and y are (n, R) blocks, flattened row-major
        rhs = pl.program_id(1) * block_r + jnp.arange(block_r)
        rhs_live = rhs < nrhs

    def step(i, acc):
        idx = start[:, None] + i * block_k + lane[None, :]
        m = idx < end[:, None]
        c = plgpu.load(cols_ref.at[idx], mask=m, other=0)
        v = plgpu.load(vals_ref.at[idx], mask=m, other=0.0).astype(dt)
        if has_lo:
            v = v + plgpu.load(lo_ref.at[idx], mask=m, other=0.0).astype(dt)
        if not nrhs:
            xv = plgpu.load(x_ref.at[c], mask=m, other=0.0)
            return acc + jnp.sum(v * xv, axis=1)
        xm = m[:, :, None] & rhs_live[None, None, :]
        xv = plgpu.load(x_ref.at[c[:, :, None] * nrhs + rhs[None, None, :]],
                        mask=xm, other=0.0)
        return acc + jnp.sum(v[:, :, None] * xv, axis=1)

    if not nrhs:
        acc = jax.lax.fori_loop(0, steps, step,
                                jnp.zeros((block_rows,), dt))
        plgpu.store(y_ref.at[rows], acc, mask=live)
    else:
        acc = jax.lax.fori_loop(0, steps, step,
                                jnp.zeros((block_rows, block_r), dt))
        plgpu.store(y_ref.at[rows[:, None] * nrhs + rhs[None, :]], acc,
                    mask=live[:, None] & rhs_live[None, :])


def rowblock(ptr, cols, vals, vals_lo, x, *, block=REGULAR,
             block_r: int = 8, interpret: bool = False):
    """The kernel: y = A·x for CSR arrays (``ptr`` (nrows+1,) int32;
    ``cols`` and ``vals`` at least one slot long) and x of shape (ncols,)
    or (ncols, R)."""
    block_rows, block_k, num_warps = block
    nrows = ptr.shape[0] - 1
    nrhs = x.shape[1] if x.ndim == 2 else 0
    grid = (pl.cdiv(nrows, block_rows),)
    if nrhs:
        grid += (pl.cdiv(nrhs, block_r),)
    kernel = functools.partial(
        _kernel, nrows=nrows, nrhs=nrhs, block_rows=block_rows,
        block_k=block_k, block_r=block_r, has_lo=vals_lo is not None)
    args = (ptr, cols, vals) + (() if vals_lo is None else (vals_lo,))
    args, vma = _same_vma(args + (x.reshape(-1),))
    y = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((nrows * max(nrhs, 1),), x.dtype,
                                       vma=vma),
        grid=grid,
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=1),
        interpret=interpret,
        name="csr_rowblock",
    )(*args)
    return y.reshape((nrows,) + x.shape[1:])


def _same_vma(args):
    """Inside ``shard_map``: mark every operand varying over the mesh axes
    any of them varies over (a replicated x beside sharded matrix arrays),
    and return those axes for the kernel's output."""
    vma = frozenset().union(*(jax.typeof(a).vma for a in args))
    return tuple(
        jax.lax.pcast(a, tuple(vma - jax.typeof(a).vma), to="varying")
        if vma - jax.typeof(a).vma else a for a in args), vma


def reference(ptr, cols, vals, vals_lo, x):
    """The same product in plain XLA: each slot's row recovered from the
    row pointers (slots past ``ptr[-1]`` fall outside every row and are
    dropped), then a ``segment_sum``.  The rows are sorted, but the sum is
    told so only for X with ``SORTED_FROM_R`` columns or more: on the H100
    the hint made a vector 1.8-4.8× slower, while without it the atomic
    scatter's time grows with R and was 4.4× slower at R = 100 on the 524k
    power law, the two crossing near R = 16 (PERF.md)."""
    nrows, nslots = ptr.shape[0] - 1, cols.shape[0]
    ends = jnp.zeros(nslots + 1, jnp.int32).at[ptr[1:]].add(1)
    rows = jnp.cumsum(ends)[:nslots]  # rows ending at or before each slot
    v = vals.astype(x.dtype)
    if vals_lo is not None:
        v = v + vals_lo.astype(x.dtype)
    v = v.reshape(v.shape + (1,) * (x.ndim - 1))
    return jax.ops.segment_sum(
        v * x[cols], rows, num_segments=nrows,
        indices_are_sorted=x.ndim == 2 and x.shape[1] >= SORTED_FROM_R)


def csr_product(ptr, cols, vals, vals_lo, x, *, block=REGULAR):
    """y = A·x: the kernel when lowered for the GPU and it fits x (see the
    module notes), else the reference."""
    nrows = ptr.shape[0] - 1
    if nrows == 0 or x.shape[0] == 0:
        return jnp.zeros((nrows,) + x.shape[1:], x.dtype)
    if x.ndim == 2 and tuple(block) != REGULAR:
        return reference(ptr, cols, vals, vals_lo, x)
    return jax.lax.platform_dependent(
        ptr, cols, vals, vals_lo, x,
        cuda=functools.partial(rowblock, block=tuple(block)),
        default=reference)
