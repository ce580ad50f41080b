"""Tests that need the GPU: they skip under the CPU test config and run
in ``chip_smoke.py``'s "gpu tests" phase, which calls them directly."""

import jax
import numpy as np
import pytest

import spmv_tpu
from spmv_tpu import synth
from spmv_tpu.device import apply

FORMATS = ["coo", "csr", "ell", "sell", "cmrs", "hyb", "bsr"]


@pytest.mark.gpu
def test_products_compile_for_gpu(gpu_device):
    """Every format's product compiles for the GPU with no host callback
    in the program (nothing falls back to the host or an interpreter),
    and its output lives on the GPU."""
    info, r, c, v = synth.power_law(n=4096, avg_nnz_per_row=8,
                                    bandwidth=256, seed=1)
    x = jax.device_put(np.ones(info.ncols, np.float32), gpu_device)
    for fmt in FORMATS:
        a = spmv_tpu.from_coo(fmt, info.nrows, info.ncols, r, c, v)
        hlo = jax.jit(apply).lower(a.dev, x).compile().as_text()
        assert "callback" not in hlo.lower(), fmt
        y = apply(a.dev, x)
        assert y.devices() == {gpu_device}, fmt


@pytest.mark.gpu
def test_csr_kernel_compiled_for_gpu(gpu_device):
    """The CSR product compiles to the Triton row-block kernel on the GPU
    and matches the fp64 oracle at a real width: a vector, blocks of 9 and
    20 right-hand sides, and fp64 (hi, lo) planes."""
    from spmv_tpu.oracle import EPSILON, fp32_check, golden_spmv
    from spmv_tpu.x2 import X2Matrix

    info, r, c, v = synth.power_law(n=65536, avg_nnz_per_row=24,
                                    bandwidth=512, seed=3)
    rng = np.random.default_rng(0)
    for fmt in ("csr", "cmrs", "hyb", "sym"):
        if fmt == "sym":
            low = r >= c
            rr, cc, vv = r[low], c[low], v[low]
        else:
            rr, cc, vv = r, c, v
        a = spmv_tpu.from_coo(fmt, info.nrows, info.ncols, rr, cc, vv)
        x = jax.device_put(np.ones(info.ncols, np.float32), gpu_device)
        hlo = jax.jit(apply).lower(a.dev, x).compile().as_text()
        assert "triton" in hlo.lower(), fmt
    a = spmv_tpu.from_coo("csr", info.nrows, info.ncols, r, c, v)
    x = rng.standard_normal(info.ncols).astype(np.float32)
    assert fp32_check(info.nrows, r, c, v, x, np.asarray(a.matvec(x))).ok
    for R in (9, 20):  # ragged rows: segment_sum without, then with the hint
        X = rng.standard_normal((info.ncols, R)).astype(np.float32)
        assert fp32_check(info.nrows, r, c, v, X,
                          np.asarray(spmv_tpu.spmm(a, X))).ok
    b = X2Matrix.from_coo("csr", info.nrows, info.ncols, r, c, v)
    x64 = rng.standard_normal(info.ncols)
    err = np.abs(b.matvec(x64) - golden_spmv(info.nrows, r, c, v, x64)).max()
    assert err <= EPSILON
