import io
import json

import numpy as np
import pytest

from spmv_tpu import synth
from spmv_tpu.cli import main
from spmv_tpu.errors import ReturnCode
from spmv_tpu.io import mmio


@pytest.fixture
def mtx(tmp_path):
    info, r, c, v = synth.synthetic_cant(n=300, avg_nnz_per_row=6,
                                         bandwidth=30, seed=3)
    p = tmp_path / "m.mtx"
    mmio.write_coo(str(p), info.nrows, info.ncols, r, c, v)
    return str(p)


@pytest.mark.parametrize("fmt", ["csr", "ell", "cmrs"])
def test_cli_run_validates(mtx, fmt, capsys):
    rc = main(["run", "--format", fmt, "--matrix", mtx])
    out = capsys.readouterr().out
    assert rc == ReturnCode.SUCCESS
    assert "result is ok" in out


def test_cli_run_ell_stats(mtx, capsys):
    rc = main(["run", "--format", "ell", "--matrix", mtx])
    out = capsys.readouterr().out
    assert "row length: average" in out  # ell.c:103-104 parity
    assert rc == 0


def test_cli_missing_file(capsys, tmp_path):
    # a missing file is synthesized (LFS-pointer behavior), so use a
    # *malformed* file for the FILE_ERROR path
    bad = tmp_path / "bad.mtx"
    bad.write_text("not a matrix\n")
    rc = main(["run", "--matrix", str(bad)])
    assert rc == ReturnCode.FILE_ERROR


def test_cli_info(mtx, capsys):
    rc = main(["info", "--matrix", mtx])
    out = capsys.readouterr().out
    assert rc == 0 and "row length" in out


def test_cli_bench_json(mtx, tmp_path, capsys):
    out_json = str(tmp_path / "r.json")
    # --probe-bw: the CPU has no published peak to divide by
    rc = main(["bench", "--matrix", mtx, "--formats", "csr", "--probe-bw",
               "--json", out_json])
    assert rc == 0
    d = json.load(open(out_json))
    assert "csr" in d and d["csr"]["nnz"] > 0


def test_cache_roundtrip(mtx, tmp_path):
    from spmv_tpu.cache import cached_convert

    cdir = str(tmp_path / "cache")
    a = cached_convert(mtx, "csr", cache_dir=cdir)
    b = cached_convert(mtx, "csr", cache_dir=cdir)  # hit
    x = np.random.default_rng(0).standard_normal(a.ncols).astype(np.float32)
    np.testing.assert_allclose(np.asarray(a.matvec(x)),
                               np.asarray(b.matvec(x)))
    import os
    assert any(f.endswith(".npz") for f in os.listdir(cdir))


def test_cache_key_changes_with_content(tmp_path):
    from spmv_tpu.cache import cache_key

    p1 = tmp_path / "a.mtx"
    p2 = tmp_path / "b.mtx"
    p1.write_text("%%MatrixMarket matrix coordinate real general\n1 1 1\n1 1 2.0\n")
    p2.write_text("%%MatrixMarket matrix coordinate real general\n1 1 1\n1 1 3.0\n")
    assert cache_key(str(p1), "csr", {}) != cache_key(str(p2), "csr", {})


def test_plan_cache_roundtrip(mtx, tmp_path):
    """A cache hit rebuilds the same container from the cached triplets
    (HYB: same panel width and padding)."""
    from spmv_tpu.cache import cached_convert

    cdir = str(tmp_path / "cache")
    import os
    a = cached_convert(mtx, "hyb", cache_dir=cdir)
    files = os.listdir(cdir)
    assert len(files) == 1 and files[0].endswith(".npz")
    b = cached_convert(mtx, "hyb", cache_dir=cdir)  # triplet-cache hit
    assert os.listdir(cdir) == files
    x = np.random.default_rng(1).standard_normal(a.ncols).astype(np.float32)
    np.testing.assert_allclose(np.asarray(a.matvec(x)),
                               np.asarray(b.matvec(x)))
    assert b.K == a.K and b.padded_slots == a.padded_slots


def test_cli_cache_dir(mtx, tmp_path, capsys):
    cdir = str(tmp_path / "c2")
    rc = main(["run", "--format", "csr", "--matrix", mtx,
               "--cache-dir", cdir])
    assert rc == ReturnCode.SUCCESS
    import os
    files = os.listdir(cdir)
    assert len(files) == 1 and files[0].endswith(".npz")
    rc = main(["run", "--format", "csr", "--matrix", mtx,
               "--cache-dir", cdir])  # warm
    assert rc == ReturnCode.SUCCESS
    assert os.listdir(cdir) == files


def test_cli_run_bsr_spmm(mtx, capsys):
    """The SpMM engine class is reachable from the CLI (round-1 verdict
    item 8): bsr + --rhs validates every column against the oracle."""
    rc = main(["run", "--format", "bsr", "--matrix", mtx, "--rhs", "4"])
    out = capsys.readouterr().out
    assert rc == ReturnCode.SUCCESS
    assert "result is ok" in out and "4 right-hand sides" in out


def test_cli_run_rhs_on_matvec_format(mtx, capsys):
    rc = main(["run", "--format", "csr", "--matrix", mtx, "--rhs", "2"])
    out = capsys.readouterr().out
    assert rc == ReturnCode.SUCCESS
    assert "2 right-hand sides" in out


@pytest.fixture
def spd_mtx(tmp_path):
    """A small SPD matrix on disk (A·Aᵀ + n·I of a band matrix)."""
    info, r, c, v = synth.synthetic_cant(n=200, avg_nnz_per_row=5,
                                         bandwidth=20, seed=6)
    A = np.zeros((info.nrows, info.ncols))
    A[r, c] = v
    S = A @ A.T + info.nrows * np.eye(info.nrows)
    sr, sc = np.nonzero(S)
    p = tmp_path / "spd.mtx"
    mmio.write_coo(str(p), info.nrows, info.nrows, sr, sc, S[sr, sc])
    return str(p)


@pytest.mark.parametrize("solver", ["cg", "bicgstab"])
def test_cli_solve(spd_mtx, solver, capsys):
    rc = main(["solve", "--solver", solver, "--format", "csr",
               "--matrix", spd_mtx, "--tol", "1e-5"])
    out = capsys.readouterr().out
    assert rc == ReturnCode.SUCCESS, out
    assert "converged" in out and "NOT converged" not in out


def test_cli_solve_power(spd_mtx, capsys):
    rc = main(["solve", "--solver", "power", "--format", "csr",
               "--matrix", spd_mtx, "--maxiter", "50"])
    out = capsys.readouterr().out
    assert rc == ReturnCode.SUCCESS
    assert "lambda_max" in out


def test_cli_solve_rejects_rectangular(tmp_path, capsys):
    p = tmp_path / "rect.mtx"
    mmio.write_coo(str(p), 4, 6, [0, 3], [1, 5], [1.0, 2.0])
    rc = main(["solve", "--matrix", str(p)])
    assert rc == ReturnCode.OTHER_ERROR
