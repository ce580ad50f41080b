"""The plain-XLA device layer: each format's device-array contract, SpMM
for any R, f32x2 in fp64, shard stacking, the bench's peak table, the
compile-cache rule, and chip_smoke.py refusing to run without a GPU."""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

import spmv_tpu
from spmv_tpu import synth
from spmv_tpu.device import (Csr, Panel, Permuted, Seg, SumOf, apply,
                             nbytes, row_ranks, stack)
from spmv_tpu.formats.hyb import hyb_width
from spmv_tpu.formats.sell import C
from spmv_tpu.oracle import EPSILON, fp32_check, golden_spmv

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MATVEC = ["coo", "csr", "ell", "sell", "cmrs", "hyb", "sym"]
ALL = MATVEC + ["bsr"]


def _pl(n=1500, seed=3):
    return synth.power_law(n=n, avg_nnz_per_row=9, bandwidth=200, seed=seed)


def _build(fmt, info, r, c, v):
    if fmt == "sym":  # the stored lower triangle of the symmetrized matrix
        r, c = np.concatenate([r, c]), np.concatenate([c, r])
        v = np.concatenate([v, v])
        low = r >= c
        r, c, v = r[low], c[low], v[low]
    return spmv_tpu.from_coo(fmt, info.nrows, info.ncols, r, c, v)


def _dense(a):
    A = np.zeros((a.nrows, a.ncols))
    np.add.at(A, a.to_coo()[:2], a.to_coo()[2])
    return A


@pytest.mark.parametrize("fmt", ALL)
def test_device_array_contract(fmt):
    """int32 indices and float32 values in every device leaf."""
    a = _build(fmt, *_pl())
    for leaf in jax.tree.leaves(a.dev):
        assert leaf.dtype in (np.int32, np.float32), (fmt, leaf.dtype)
    assert a.padded_bytes == nbytes(a.dev) > 0
    assert a.padded_slots >= (a.nnz if fmt != "sym" else a.stored_nnz)


@pytest.mark.parametrize("edge", sorted(synth.EDGE_CASES))
def test_ell_width_is_longest_row(edge):
    info, r, c, v = synth.edge_case(edge)
    a = spmv_tpu.from_coo("ell", info.nrows, info.ncols, r, c, v)
    longest = int(np.bincount(r, minlength=info.nrows).max(initial=0))
    assert a.K == longest
    assert a.dev.cols.shape == a.dev.vals.shape == (info.nrows, longest)


@pytest.mark.parametrize("sigma", [32, 64, 128, 1024])
def test_sell_slice_widths(sigma):
    """C = 32 rows per slice; each slice's width is its longest sorted
    row, and the device slabs are the slices' widths rounded to buckets
    (exact up to 8, then at most 25 % wider)."""
    info, r, c, v = _pl(n=2000, seed=5)
    a = spmv_tpu.SellMatrix.from_coo(info.nrows, info.ncols, r, c, v,
                                     sigma=sigma)
    assert C == 32
    lengths = np.zeros(a.perm.size, np.int64)
    lengths[:info.nrows] = np.bincount(r, minlength=info.nrows)
    np.testing.assert_array_equal(
        a.slice_widths, lengths[a.perm].reshape(-1, C).max(axis=1))
    from spmv_tpu.formats.sell import bucket_width

    widths = {int(p.cols.shape[1]) for p in a.dev.parts}
    assert widths == set(bucket_width(a.slice_widths).tolist())
    b = bucket_width(a.slice_widths)
    assert (b >= a.slice_widths).all() and (b <= 1.25 * a.slice_widths).all()
    # the device slices cover exactly the real rows
    assert sum(int(p.cols.shape[0]) for p in a.dev.parts) == info.nrows
    # rows sort by descending length inside each σ window
    win = lengths[a.perm].reshape(-1, sigma)
    assert (np.diff(win, axis=1) <= 0).all()


@pytest.mark.parametrize("lengths", [
    np.full(9000, 7),
    np.concatenate([np.full(5000, 3), np.full(5000, 9)]),
    np.arange(12000) % 40,
    np.full(100, 50),
    np.concatenate([np.full(4096, 2), np.zeros(100, int)]),
], ids=["uniform", "two-level", "sawtooth", "below-floor", "at-floor"])
def test_hyb_width_rule(lengths):
    """Bell & Garland: the largest K with ≥ max(4096, nrows/3) rows of
    length ≥ K — checked against a brute-force scan."""
    need = max(4096, lengths.size / 3)
    brute = max([k for k in range(int(lengths.max()) + 1)
                 if (lengths >= k).sum() >= need], default=0)
    assert hyb_width(lengths) == brute


@pytest.mark.parametrize("R", [1, 2, 9, 33, 100])
@pytest.mark.parametrize("fmt", MATVEC)
def test_spmm_matches_dense(fmt, R):
    info, r, c, v = _pl(n=600, seed=R)
    a = _build(fmt, info, r, c, v)
    X = np.random.default_rng(R).standard_normal((info.ncols, R))
    Y = np.asarray(spmv_tpu.spmm(a, X.astype(np.float32)))
    ref = _dense(a) @ X
    assert Y.shape == (info.nrows, R)
    assert np.abs(Y - ref).max() <= 1e-4 * max(np.abs(ref).max(), 1.0)


@pytest.mark.parametrize("fmt", ["csr", "coo", "cmrs", "ell", "sell", "hyb"])
def test_x2_matmat_fp64(fmt):
    """f32x2: fp64 X in, fp64 Y out, within the reference EPSILON."""
    from spmv_tpu.x2 import X2Matrix

    info, r, c, v = _pl(n=800, seed=7)
    v = np.asarray(v) * (1 + 1e-9 * np.arange(v.size))
    a = X2Matrix.from_coo(fmt, info.nrows, info.ncols, r, c, v)
    X = np.random.default_rng(8).standard_normal((info.ncols, 3))
    Y = a.matmat(X)
    assert Y.dtype == np.float64 and Y.shape == (info.nrows, 3)
    assert np.abs(Y - golden_spmv(info.nrows, r, c, v, X)).max() < EPSILON


def test_x2_planes_restore_fp64():
    from spmv_tpu.device import split_x2

    v = np.random.default_rng(0).standard_normal(1000) * 1e3
    hi, lo = split_x2(v)
    assert hi.dtype == lo.dtype == np.float32
    err = np.abs(hi.astype(np.float64) + lo.astype(np.float64) - v)
    assert (err <= np.abs(v) * 2.0 ** -46).all()


@pytest.mark.parametrize("fmt", ALL)
def test_stack_pads_with_inert_slots(fmt):
    """Shards of unequal size stack to one shape; each stacked shard
    still computes its own product (the padding adds nothing)."""
    parts = [_pl(n=400, seed=s) for s in (1, 2)]
    devs = [_build(fmt, *p).dev for p in parts]
    stacked = stack(devs)
    x = np.random.default_rng(0).standard_normal(400).astype(np.float32)
    for i, d in enumerate(devs):
        one = jax.tree.map(lambda a, i=i: a[i], stacked)
        np.testing.assert_allclose(np.asarray(apply(one, x)),
                                   np.asarray(apply(d, x)),
                                   rtol=1e-5, atol=1e-5)


def test_container_kinds():
    info, r, c, v = _pl()
    kinds = {f: type(_build(f, info, r, c, v).dev) for f in MATVEC}
    assert kinds == {"coo": Seg, "csr": Csr, "cmrs": Csr, "ell": Panel,
                     "sell": Permuted, "hyb": SumOf, "sym": SumOf}


def test_row_ranks():
    rows = np.array([0, 0, 0, 2, 2, 3])
    np.testing.assert_array_equal(row_ranks(rows, 5), [0, 1, 2, 0, 1, 0])


@pytest.mark.parametrize("fmt", MATVEC)
def test_matvec_shape_errors(fmt):
    a = _build(fmt, *_pl(n=300))
    with pytest.raises(ValueError):
        a.matvec(np.ones(a.ncols + 1))
    with pytest.raises(ValueError):
        a.matmat(np.ones(a.ncols))


@pytest.mark.parametrize("kind,peak", [("NVIDIA H100 80GB HBM3", 3.35e12),
                                       ("NVIDIA H100 PCIe", 2.0e12)])
def test_peak_table_knows_h100(kind, peak):
    from spmv_tpu.bench.runner import peak_hbm_bw

    class Dev:
        device_kind = kind

    assert peak_hbm_bw(Dev()) == peak


def test_peak_table_unknown_device_raises():
    from spmv_tpu.bench.runner import peak_hbm_bw

    with pytest.raises(ValueError, match="no published"):
        peak_hbm_bw()  # this test run's device is the CPU


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_rule(env_set, tmp_path):
    """JAX_COMPILATION_CACHE_DIR set: nothing is set in code; unset: the
    cache sits at the fixed <checkout>/.jax_cache."""
    code = ("import jax; from spmv_tpu.cache import setup_compile_cache;"
            "p = setup_compile_cache();"
            "print(repr(p), jax.config.jax_compilation_cache_dir)")
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    if env_set:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.split()
    if env_set:
        assert out == ["None", str(tmp_path)]
    else:
        path = os.path.join(ROOT, ".jax_cache")
        assert out == [repr(path), path]


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_gpu(alone, tmp_path):
    """No GPU (this CPU run), or no repository beside the script: a
    non-zero exit and no result line."""
    src = os.path.join(ROOT, "chip_smoke.py")
    if alone:
        with open(src) as f:
            (tmp_path / "chip_smoke.py").write_text(f.read())
        cwd, script = str(tmp_path), str(tmp_path / "chip_smoke.py")
    else:
        cwd, script = ROOT, src
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    p = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    for line in p.stdout.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)


def test_oracle_block_of_rhs():
    info, r, c, v = _pl(n=200)
    X = np.random.default_rng(0).standard_normal((info.ncols, 4))
    Y = golden_spmv(info.nrows, r, c, v, X)
    for j in range(4):
        np.testing.assert_allclose(Y[:, j],
                                   golden_spmv(info.nrows, r, c, v, X[:, j]))
    assert fp32_check(info.nrows, r, c, v, X, Y.astype(np.float32)).ok
