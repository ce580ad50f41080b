import io

import numpy as np
import pytest

from spmv_tpu.io import mmio


def roundtrip(nrows, ncols, rows, cols, vals):
    buf = io.StringIO()
    mmio.write_coo(buf, nrows, ncols, rows, cols, vals, comment="test")
    buf.seek(0)
    return mmio.read_coo(io.StringIO(buf.getvalue()))


def test_banner_and_sizes():
    f = io.StringIO(
        "%%MatrixMarket matrix coordinate real general\n"
        "% a comment\n\n"
        "3 4 2\n1 1 1.5\n3 4 -2.0\n"
    )
    info = mmio.read_banner(f)
    assert (info.nrows, info.ncols, info.nnz) == (3, 4, 2)
    assert info.field == "real" and not info.is_symmetric


def test_bad_banner():
    with pytest.raises(mmio.MMError):
        mmio.read_banner(io.StringIO("%%NotMatrixMarket x y z w\n1 1 1\n"))
    with pytest.raises(mmio.MMError):
        mmio.read_banner(
            io.StringIO("%%MatrixMarket matrix coordinate real bogus\n1 1 1\n")
        )


def test_roundtrip_real():
    rows = np.array([0, 2, 2])
    cols = np.array([1, 0, 3])
    vals = np.array([1.5, -2.25, 3.125])
    info, r, c, v = roundtrip(3, 4, rows, cols, vals)
    assert (info.nrows, info.ncols, info.nnz) == (3, 4, 3)
    np.testing.assert_array_equal(r, rows)
    np.testing.assert_array_equal(c, cols)
    np.testing.assert_allclose(v, vals)


def test_pattern():
    f = io.StringIO(
        "%%MatrixMarket matrix coordinate pattern general\n2 2 2\n1 1\n2 2\n"
    )
    info, r, c, v = mmio.read_coo(f)
    np.testing.assert_allclose(v, [1.0, 1.0])


def test_symmetric_expansion():
    f = io.StringIO(
        "%%MatrixMarket matrix coordinate real symmetric\n"
        "3 3 3\n1 1 2.0\n2 1 5.0\n3 2 7.0\n"
    )
    info, r, c, v = mmio.read_coo(f)
    dense = np.zeros((3, 3))
    dense[r, c] = v
    np.testing.assert_allclose(dense, dense.T)
    assert r.size == 5  # 3 stored + 2 mirrored off-diagonals


def test_skew_symmetric():
    f = io.StringIO(
        "%%MatrixMarket matrix coordinate real skew-symmetric\n"
        "3 3 2\n2 1 5.0\n3 2 7.0\n"
    )
    info, r, c, v = mmio.read_coo(f)
    dense = np.zeros((3, 3))
    dense[r, c] = v
    np.testing.assert_allclose(dense, -dense.T)


def test_integer_field():
    f = io.StringIO(
        "%%MatrixMarket matrix coordinate integer general\n2 2 2\n1 2 3\n2 1 -4\n"
    )
    _, r, c, v = mmio.read_coo(f)
    np.testing.assert_allclose(v, [3.0, -4.0])


def test_complex_real_part():
    f = io.StringIO(
        "%%MatrixMarket matrix coordinate complex general\n2 2 1\n1 1 3.0 4.0\n"
    )
    _, r, c, v = mmio.read_coo(f)
    np.testing.assert_allclose(v, [3.0])
    _, _, _, vc = mmio.read_coo(
        io.StringIO(
            "%%MatrixMarket matrix coordinate complex general\n2 2 1\n1 1 3.0 4.0\n"
        ),
        dtype=np.complex128,
    )
    np.testing.assert_allclose(vc, [3.0 + 4.0j])


def test_out_of_bounds_rejected():
    f = io.StringIO(
        "%%MatrixMarket matrix coordinate real general\n2 2 1\n3 1 1.0\n"
    )
    with pytest.raises(mmio.MMError):
        mmio.read_coo(f)


def test_truncated_body():
    f = io.StringIO("%%MatrixMarket matrix coordinate real general\n2 2 2\n1 1 1.0\n")
    with pytest.raises(mmio.MMError):
        mmio.read_coo(f)


def test_dense_array():
    f = io.StringIO(
        "%%MatrixMarket matrix array real general\n2 3 \n1\n2\n3\n4\n5\n6\n"
    )
    info, a = mmio.read_dense(f)
    # column-major storage
    np.testing.assert_allclose(a, [[1, 3, 5], [2, 4, 6]])


def test_file_roundtrip(tmp_path):
    p = tmp_path / "m.mtx"
    rows = np.array([0, 1, 4])
    cols = np.array([2, 0, 4])
    vals = np.array([1.0, 2.0, 3.0])
    mmio.write_coo(str(p), 5, 5, rows, cols, vals)
    info, r, c, v = mmio.read_coo(str(p))
    np.testing.assert_array_equal(r, rows)
    np.testing.assert_allclose(v, vals)


def test_native_parser_parity(tmp_path):
    """C++ body parser must agree exactly with the NumPy fallback."""
    import os

    from spmv_tpu import synth
    from spmv_tpu.io import native

    if not native.available():
        import pytest

        pytest.skip("native parser not built")
    info, r, c, v = synth.synthetic_cant(n=500, avg_nnz_per_row=9,
                                         bandwidth=40, seed=12)
    p = tmp_path / "n.mtx"
    mmio.write_coo(str(p), info.nrows, info.ncols, r, c, v)
    _, r1, c1, v1 = mmio.read_coo(str(p))
    os.environ["SPMV_NO_NATIVE"] = "1"
    native._tried = False
    native._lib = None
    try:
        _, r2, c2, v2 = mmio.read_coo(str(p))
    finally:
        del os.environ["SPMV_NO_NATIVE"]
        native._tried = False
        native._lib = None
    np.testing.assert_array_equal(r1, r2)
    np.testing.assert_array_equal(c1, c2)
    np.testing.assert_array_equal(v1, v2)


def test_typecode_str():
    """mm_typecode_to_str parity (mmio.c:455-510): diagnostics name the
    file's actual kind."""
    f = io.StringIO(
        "%%MatrixMarket matrix coordinate real symmetric\n2 2 1\n1 1 3.0\n"
    )
    info = mmio.read_banner(f)
    assert mmio.typecode_str(info) == "matrix coordinate real symmetric"
    assert (mmio.typecode_str(("matrix", "array", "complex", "general"))
            == "matrix array complex general")
    # the wrong-format errors carry the typecode string
    f2 = io.StringIO(
        "%%MatrixMarket matrix array real general\n1 1\n7\n")
    with pytest.raises(mmio.MMError, match=r"matrix array real general"):
        mmio.read_coo(f2)
    f3 = io.StringIO(
        "%%MatrixMarket matrix coordinate real general\n1 1 1\n1 1 7\n")
    with pytest.raises(mmio.MMError, match=r"matrix coordinate real"):
        mmio.read_dense(f3)


def test_write_dense_roundtrip(tmp_path):
    """Dense-array write path (mmio.c:386-440 analog): column-major body,
    read back by read_dense."""
    a = np.arange(12, dtype=np.float64).reshape(3, 4) / 7.0
    p = tmp_path / "d.mtx"
    mmio.write_dense(str(p), a, comment="dense roundtrip")
    info, b = mmio.read_dense(str(p))
    assert (info.nrows, info.ncols) == (3, 4)
    np.testing.assert_allclose(b, a, rtol=0, atol=0)


def test_write_dense_complex_and_errors(tmp_path):
    z = np.array([[1 + 2j, -3.5j]], dtype=np.complex128)
    p = tmp_path / "z.mtx"
    mmio.write_dense(str(p), z)
    info, b = mmio.read_dense(str(p), dtype=np.complex128)
    assert info.field == "complex"
    np.testing.assert_allclose(b, z)
    with pytest.raises(mmio.MMError, match="2-D"):
        mmio.write_dense(io.StringIO(), np.arange(3.0))


def test_gzip_roundtrip(tmp_path):
    """.mtx.gz is accepted transparently on both read and write paths
    (ingestion hardening for when a real compressed cant.mtx appears)."""
    rows = np.array([0, 2, 2])
    cols = np.array([1, 0, 2])
    vals = np.array([1.5, -2.0, 4.25])
    p = tmp_path / "m.mtx.gz"
    mmio.write_coo(str(p), 3, 3, rows, cols, vals)
    import gzip

    with gzip.open(p, "rt") as f:
        assert f.readline().startswith("%%MatrixMarket")
    info, r, c, v = mmio.read_coo(str(p))
    assert info.nnz == 3
    np.testing.assert_array_equal(r, rows)
    np.testing.assert_allclose(v, vals)
    assert mmio.read_banner(str(p)).nrows == 3
    pd = tmp_path / "d.mtx.gz"
    mmio.write_dense(str(pd), np.eye(2))
    _, a = mmio.read_dense(str(pd))
    np.testing.assert_allclose(a, np.eye(2))
