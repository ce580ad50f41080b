"""Iterative solvers on top of the device formats — the "production use"
layer the reference lacks entirely (its drivers run one SpMV and exit,
``coo.c:193-199``).

Each solver is one jitted ``lax.while_loop`` around the format's device
product, so the whole Krylov loop runs on the device with one dispatch.
The distributed containers (``spmv_tpu.dist``) compose the same way
through their ``_matvec_traced`` hook: the loop then compiles as ONE SPMD
program over the mesh (matvec collectives + partitioned dot products).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

__all__ = ["bicgstab", "cg", "power_iteration"]


def _operator(a):
    """``(mv, arrays)``: ``mv(v, arrays)`` is a traceable product whose
    device arrays arrive as a jit argument."""
    if hasattr(a, "_matvec_traced"):  # dist containers
        return a._matvec_traced, a.arrays
    if callable(getattr(a, "dev", None)):
        return (lambda v, arrays: arrays(v)), a.dev
    raise TypeError(
        f"solve requires a matvec format container; {type(a).__name__} "
        f"has no device product — use csr/coo/cmrs/ell/sell/hyb/sym")


def cg(a, b, *, tol: float = 1e-5, maxiter: int = 1000, x0=None):
    """Conjugate gradients for SPD ``A``: returns (x, iterations, residual).

    The loop is one jitted ``lax.while_loop``; fp32 on device (use a
    smallish ``tol`` accordingly).
    """
    if a.nrows != a.ncols:
        raise ValueError("cg requires a square matrix")
    mv_of, arrays = _operator(a)
    b = jnp.asarray(b, jnp.float32).reshape(-1)
    if b.shape[0] != a.nrows:
        raise ValueError(f"b has {b.shape[0]} entries, matrix is {a.nrows}")
    x0 = jnp.zeros_like(b) if x0 is None else jnp.asarray(x0, jnp.float32)

    @jax.jit
    def run(b, x0, arrays):
        mv = partial(mv_of, arrays=arrays)
        r0 = b - mv(x0)
        state = (x0, r0, r0, jnp.vdot(r0, r0), jnp.int32(0))
        tol2 = jnp.float32(tol) ** 2 * jnp.maximum(jnp.vdot(b, b), 1e-30)

        def cond(s):
            _, _, _, rs, k = s
            return jnp.logical_and(rs > tol2, k < maxiter)

        def body(s):
            x, r, p, rs, k = s
            ap = mv(p)
            alpha = rs / jnp.vdot(p, ap)
            x = x + alpha * p
            r = r - alpha * ap
            rs_new = jnp.vdot(r, r)
            p = r + (rs_new / rs) * p
            return (x, r, p, rs_new, k + 1)

        x, r, _, rs, k = jax.lax.while_loop(cond, body, state)
        return x, k, jnp.sqrt(rs)

    x, k, res = run(b, x0, arrays)
    return x, int(k), float(res)


def bicgstab(a, b, *, tol: float = 1e-5, maxiter: int = 1000, x0=None):
    """BiCGSTAB for general (nonsymmetric) square ``A``: returns
    (x, iterations, residual).  One jitted ``lax.while_loop``; the van der
    Vorst smoothing step needs two SpMVs per iteration, both fused into
    the same device program."""
    if a.nrows != a.ncols:
        raise ValueError("bicgstab requires a square matrix")
    mv_of, arrays = _operator(a)
    b = jnp.asarray(b, jnp.float32).reshape(-1)
    if b.shape[0] != a.nrows:
        raise ValueError(f"b has {b.shape[0]} entries, matrix is {a.nrows}")
    x0 = jnp.zeros_like(b) if x0 is None else jnp.asarray(x0, jnp.float32)
    eps = jnp.float32(1e-30)

    @jax.jit
    def run(b, x0, arrays):
        mv = partial(mv_of, arrays=arrays)
        r0 = b - mv(x0)
        rhat = r0  # fixed shadow residual
        state = (x0, r0, r0, jnp.vdot(rhat, r0), jnp.vdot(r0, r0),
                 jnp.int32(0))
        tol2 = jnp.float32(tol) ** 2 * jnp.maximum(jnp.vdot(b, b), 1e-30)

        def cond(s):
            *_, rs, k = s
            return jnp.logical_and(rs > tol2, k < maxiter)

        def body(s):
            x, r, p, rho, _, k = s
            v = mv(p)
            alpha = rho / (jnp.vdot(rhat, v) + eps)
            h = x + alpha * p
            s_vec = r - alpha * v
            t = mv(s_vec)
            omega = jnp.vdot(t, s_vec) / (jnp.vdot(t, t) + eps)
            x = h + omega * s_vec
            r = s_vec - omega * t
            rho_new = jnp.vdot(rhat, r)
            beta = (rho_new / (rho + eps)) * (alpha / (omega + eps))
            p = r + beta * (p - omega * v)
            return (x, r, p, rho_new, jnp.vdot(r, r), k + 1)

        x, r, _, _, rs, k = jax.lax.while_loop(cond, body, state)
        return x, k, jnp.sqrt(rs)

    x, k, res = run(b, x0, arrays)
    return x, int(k), float(res)


def power_iteration(a, *, iters: int = 100, seed: int = 0):
    """Dominant eigenvalue estimate by fused power iteration; returns
    (eigenvalue, eigenvector)."""
    if a.nrows != a.ncols:
        raise ValueError("power_iteration requires a square matrix")
    mv_of, arrays = _operator(a)
    v0 = jax.random.normal(jax.random.PRNGKey(seed), (a.ncols,), jnp.float32)

    @partial(jax.jit, static_argnums=1)
    def run(v, n, arrays):
        mv = partial(mv_of, arrays=arrays)

        def body(i, v):
            w = mv(v)
            return w * jax.lax.rsqrt(jnp.vdot(w, w) + 1e-30)
        v = jax.lax.fori_loop(0, n, body, v)
        w = mv(v)
        return jnp.vdot(v, w), v

    lam, v = run(v0, iters, arrays)
    return float(lam), v
