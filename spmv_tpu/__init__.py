"""A sparse matrix–vector multiplication framework in JAX.

A from-scratch JAX/XLA re-design with the capabilities of
``sgartkink/opencl-spmv-algorithms`` (C + OpenCL): the reference's five
sparse formats COO, CSR, ELL, SELL-C-σ and CMRS plus HYB, symmetric
triangle storage and a block-dense BSR for multi-RHS SpMM, MatrixMarket
ingestion, golden-oracle validation, benchmarking, and multi-device
scaling over ``jax.sharding`` meshes.  See ``SURVEY.md`` for the
reference analysis and ``docs/DESIGN.md`` for the device design.
"""

from spmv_tpu.api import FORMATS, from_coo, load, spmm, spmv
from spmv_tpu.formats.cmrs import CMRSMatrix
from spmv_tpu.formats.coo import COOMatrix
from spmv_tpu.formats.csr import CSRMatrix
from spmv_tpu.formats.ell import EllMatrix
from spmv_tpu.formats.hyb import HybMatrix
from spmv_tpu.big import TiledSpmv
from spmv_tpu.formats.sell import SellMatrix
from spmv_tpu.oracle import (
    check_result,
    default_x,
    fp32_check,
    fp32_rel_tol,
    golden_spmv,
)

from spmv_tpu.x2 import X2Matrix

__version__ = "0.1.0"

__all__ = [
    "FORMATS", "from_coo", "load", "spmv", "spmm",
    "COOMatrix", "CSRMatrix", "EllMatrix", "SellMatrix", "CMRSMatrix",
    "HybMatrix", "TiledSpmv", "X2Matrix",
    "golden_spmv", "check_result", "default_x", "fp32_rel_tol",
    "fp32_check",
    "__version__",
]
