"""High-level API: load → convert → spmv.

The reference exposes five standalone executables with hard-coded
filenames and no flags (``coo.c:18-19``); here the equivalent surface is a
library call plus the ``spmv-tpu`` CLI (``spmv_tpu.cli``).
"""

from __future__ import annotations

import numpy as np

from spmv_tpu.formats.bsr import BSRMatrix
from spmv_tpu.formats.cmrs import CMRSMatrix
from spmv_tpu.formats.coo import COOMatrix
from spmv_tpu.formats.csr import CSRMatrix
from spmv_tpu.formats.ell import EllMatrix
from spmv_tpu.formats.hyb import HybMatrix
from spmv_tpu.formats.sell import SellMatrix
from spmv_tpu.sym import SymmetricMatrix

__all__ = ["FORMATS", "from_coo", "load", "spmv", "spmm"]

FORMATS = {
    "coo": COOMatrix,
    "csr": CSRMatrix,
    "ell": EllMatrix,
    "sell": SellMatrix,
    "sell_c_sigma": SellMatrix,
    "cmrs": CMRSMatrix,
    "hyb": HybMatrix,  # framework extension: ELL panel + segmented spill
    "bsr": BSRMatrix,  # framework extension: 128x128 block-dense SpMM
    # framework extension: symmetric triangle storage, y = (L+D)x + L^T x
    # (input triplets are the STORED triangle, MatrixMarket symmetric
    # semantics — spmv_tpu.load(..., expand_symmetry=False) routes here)
    "sym": SymmetricMatrix,
}


def from_coo(format: str, nrows: int, ncols: int, rows, cols, vals, **kwargs):
    """Convert COO triplets to the named format's device representation."""
    try:
        cls = FORMATS[format.lower()]
    except KeyError:
        raise ValueError(f"unknown format {format!r}; choose from {sorted(FORMATS)}")
    return cls.from_coo(nrows, ncols, np.asarray(rows), np.asarray(cols),
                        np.asarray(vals), **kwargs)


def load(path: str, format: str = "csr", *, synth: dict | None = None, **kwargs):
    """Read a MatrixMarket file (or synthesize, if it is a git-LFS pointer —
    as the reference's bundled matrices are, or missing) and convert.
    ``synth`` kwargs go to :func:`spmv_tpu.synth.synthetic_cant`; the rest
    to the format's ``from_coo``."""
    from spmv_tpu.io.mmio import read_path_or_synthesize

    # the sym container wants the STORED triangle, not the expansion
    info, rows, cols, vals = read_path_or_synthesize(
        path, expand_symmetry=(format.lower() != "sym"), **(synth or {}))
    return from_coo(format, info.nrows, info.ncols, rows, cols, vals, **kwargs)


def spmv(a, x):
    """y = A @ x for any format container."""
    return a.matvec(x)


def spmm(a, X):
    """Y = A @ X for X of shape (ncols, R).

    Every matvec format gathers whole rows of ``X`` in one pass, so one
    device program serves any R; BSR runs one batched dense tile matmul;
    f32x2 containers take and return fp64."""
    return a.matmat(X)
