"""MatrixMarket (``.mtx``) I/O, pure NumPy.

Replacement for the reference's NIST mmio library
(``/root/reference/mmio/mmio.c:96-510``) and its wrapper
``read_size_of_matrices_from_file`` (``helper_functions.h:134-165``).

Superset of the reference's behavior:

* the reference only reads *general coordinate real/integer/pattern* bodies
  with raw ``fscanf`` loops in each driver (e.g. ``coo.c:81``) and rejects
  complex (``helper_functions.h:151-156``); we additionally expand
  ``symmetric`` / ``skew-symmetric`` / ``hermitian`` storage and read dense
  ``array`` bodies,
* a full write path — coordinate (``write_coo``) and dense array
  (``write_dense``) — equivalent to ``mm_write_banner`` /
  ``mm_write_mtx_crd`` / the array writer (``mmio.c:181-187, 249-255,
  386-440``),
* typecode diagnostics: wrong-format errors name the file's actual kind
  via ``typecode_str`` (``mm_typecode_to_str``, ``mmio.c:455-510``),
* transparent ``.mtx.gz`` on every read/write entry point,
* the hot parse path uses ``np.fromfile(sep=' ')`` (C-speed token parsing)
  instead of a per-line scanf loop; see ``spmv_tpu.io.native`` for the
  optional C++ parser that replaces even that.

Everything returns 0-based indices (the reference decrements in each driver,
``coo.c:82-83``).
"""

from __future__ import annotations

import io as _io
import os
from dataclasses import dataclass

import numpy as np

__all__ = [
    "MMInfo",
    "MMError",
    "read_banner",
    "read_coo",
    "write_coo",
    "read_dense",
    "write_dense",
    "typecode_str",
]


class MMError(ValueError):
    """Malformed MatrixMarket input (banner, sizes, or body)."""


_OBJECTS = ("matrix", "vector")
_FORMATS = ("coordinate", "array")
_FIELDS = ("real", "integer", "complex", "pattern")
_SYMMETRIES = ("general", "symmetric", "skew-symmetric", "hermitian")


@dataclass(frozen=True)
class MMInfo:
    """Parsed banner + size line — the analog of the reference's
    ``MM_typecode`` 4-char code (``mmio.h:31-73``) plus
    ``mm_read_mtx_crd_size`` output (``mmio.c:189-217``)."""

    object: str
    format: str
    field: str
    symmetry: str
    nrows: int
    ncols: int
    nnz: int  # stored entries (file count, pre symmetry expansion)

    @property
    def is_coordinate(self) -> bool:
        return self.format == "coordinate"

    @property
    def is_pattern(self) -> bool:
        return self.field == "pattern"

    @property
    def is_symmetric(self) -> bool:
        return self.symmetry != "general"


def typecode_str(info: "MMInfo | tuple[str, str, str, str]") -> str:
    """Human-readable typecode description — the analog of
    ``mm_typecode_to_str`` (``mmio.c:455-510``), which the reference uses
    to print what kind of matrix a failing file actually was.  Accepts an
    ``MMInfo`` or a raw ``(object, format, field, symmetry)`` tuple and
    returns e.g. ``"matrix coordinate real general"``."""
    if isinstance(info, MMInfo):
        parts = (info.object, info.format, info.field, info.symmetry)
    else:
        parts = tuple(info)
    return " ".join(parts)


def _parse_banner_line(line: str) -> tuple[str, str, str, str]:
    parts = line.strip().split()
    if len(parts) < 5 or parts[0] != "%%MatrixMarket":
        raise MMError(f"not a MatrixMarket file (banner: {line!r})")
    obj, fmt, field, sym = (p.lower() for p in parts[1:5])
    if obj not in _OBJECTS:
        raise MMError(f"unsupported object {obj!r}")
    if fmt not in _FORMATS:
        raise MMError(f"unsupported format {fmt!r}")
    if field not in _FIELDS:
        raise MMError(f"unsupported field {field!r}")
    if sym not in _SYMMETRIES:
        raise MMError(f"unsupported symmetry {sym!r}")
    return obj, fmt, field, sym


def _open(path_or_file):
    if hasattr(path_or_file, "read"):
        return path_or_file, False
    if str(path_or_file).endswith(".gz"):
        import gzip

        # BufferedReader over the decompressor: the body parsers' seekable/
        # fromfile fast path is skipped (GzipFile streams), but read() works
        # and the native parser consumes the decompressed buffer whole.
        return gzip.open(path_or_file, "rb"), True
    return open(path_or_file, "rb"), True


def _open_w(path_or_file):
    if hasattr(path_or_file, "write"):
        return path_or_file, False
    if str(path_or_file).endswith(".gz"):
        import gzip

        return gzip.open(path_or_file, "wt"), True
    return open(path_or_file, "w"), True


def read_banner(path_or_file) -> MMInfo:
    """Read banner + size line, leaving the stream at the first data entry.

    Equivalent to ``mm_read_banner`` + ``mm_read_mtx_crd_size``
    (``mmio.c:96-179, 189-217``).
    """
    f, should_close = _open(path_or_file)
    try:
        info = _read_banner_open(f)
    finally:
        if should_close:
            f.close()
    return info


def _read_banner_open(f) -> MMInfo:
    banner = f.readline()
    if isinstance(banner, bytes):
        banner = banner.decode("ascii", errors="replace")
    obj, fmt, field, sym = _parse_banner_line(banner)

    # Skip comment/blank lines to the size line (mmio.c:129-141 analog).
    while True:
        line = f.readline()
        if isinstance(line, bytes):
            line = line.decode("ascii", errors="replace")
        if not line:
            raise MMError("EOF before size line")
        s = line.strip()
        if not s or s.startswith("%"):
            continue
        break

    sizes = s.split()
    if fmt == "coordinate":
        if len(sizes) != 3:
            raise MMError(f"bad coordinate size line: {s!r}")
        nrows, ncols, nnz = (int(x) for x in sizes)
    else:
        if len(sizes) != 2:
            raise MMError(f"bad array size line: {s!r}")
        nrows, ncols = (int(x) for x in sizes)
        nnz = nrows * ncols
    if nrows < 0 or ncols < 0 or nnz < 0:
        raise MMError(f"negative size: {s!r}")
    return MMInfo(obj, fmt, field, sym, nrows, ncols, nnz)


def _parse_body_tokens(f, count: int) -> np.ndarray:
    """Parse ``count`` whitespace-separated numeric tokens at C speed."""
    if isinstance(f, (_io.BufferedReader, _io.FileIO)) and f.seekable():
        toks = np.fromfile(f, dtype=np.float64, count=count, sep=" ")
    else:
        data = f.read()
        if isinstance(data, bytes):
            data = data.decode("ascii")
        toks = np.array(data.split()[:count], dtype=np.float64)
    if toks.size != count:
        raise MMError(f"truncated body: expected {count} tokens, got {toks.size}")
    return toks


def _try_native_body(f, nnz: int, tokens_per_entry: int):
    """Parse the coordinate body with the C++ parser (spmv_tpu.io.native)
    when it is available and the stream is byte-oriented; None otherwise."""
    from spmv_tpu.io import native

    if nnz == 0 or not native.available():
        return None
    buf = f.read()
    if isinstance(buf, str):
        buf = buf.encode("ascii", errors="replace")
    try:
        return native.parse_body(buf, nnz, tokens_per_entry)
    except ValueError as e:
        raise MMError(str(e)) from None


def read_coo(
    path_or_file,
    *,
    expand_symmetry: bool = True,
    dtype=np.float64,
    index_dtype=np.int32,
) -> tuple[MMInfo, np.ndarray, np.ndarray, np.ndarray]:
    """Read a sparse matrix as COO triplets ``(info, rows, cols, vals)``.

    Indices are 0-based.  ``pattern`` entries get value 1.0 (as
    ``mm_read_mtx_crd`` would leave them implicit).  Complex values are kept
    as their real part only when ``dtype`` is real, matching SpMV over the
    real field; pass ``dtype=np.complex128`` to keep them.

    With ``expand_symmetry`` (default), symmetric / skew-symmetric /
    hermitian storage is expanded to general form — a capability the
    reference *lacks* (it parses symmetric files as if general, reading only
    the stored triangle; ``helper_functions.h:151-156`` rejects complex
    only).
    """
    f, should_close = _open(path_or_file)
    try:
        info = _read_banner_open(f)
        if info.format != "coordinate":
            raise MMError("read_coo requires coordinate format, file is "
                          f"[{typecode_str(info)}]; use read_dense")

        tokens_per_entry = {"real": 3, "integer": 3, "pattern": 2, "complex": 4}[
            info.field
        ]
        native_result = _try_native_body(f, info.nnz, tokens_per_entry)
        if native_result is not None:
            nrows_, ncols_, nvals_ = native_result
            rows = nrows_.astype(np.int64) - 1
            cols = ncols_.astype(np.int64) - 1
            if info.field == "pattern":
                vals = np.ones(info.nnz, dtype=np.float64)
            elif info.field == "complex":
                vals = nvals_[0::2] + 1j * nvals_[1::2]
                if not np.issubdtype(np.dtype(dtype), np.complexfloating):
                    vals = vals.real
            else:
                vals = nvals_
        else:
            toks = _parse_body_tokens(f, info.nnz * tokens_per_entry)
            body = toks.reshape(info.nnz, tokens_per_entry)
            rows = body[:, 0].astype(np.int64) - 1
            cols = body[:, 1].astype(np.int64) - 1
            if info.field == "pattern":
                vals = np.ones(info.nnz, dtype=np.float64)
            elif info.field == "complex":
                vals = body[:, 2] + 1j * body[:, 3]
                if not np.issubdtype(np.dtype(dtype), np.complexfloating):
                    vals = vals.real
            else:
                vals = body[:, 2]

        if (
            (rows < 0).any()
            or (cols < 0).any()
            or (rows >= info.nrows).any()
            or (cols >= info.ncols).any()
        ):
            raise MMError("index out of declared bounds")

        if expand_symmetry and info.is_symmetric:
            off = rows != cols
            if info.symmetry == "skew-symmetric":
                mirror_vals = -vals[off]
            elif info.symmetry == "hermitian":
                mirror_vals = np.conj(vals[off])
            else:
                mirror_vals = vals[off]
            rows = np.concatenate([rows, cols[off]])
            cols = np.concatenate([cols, rows[: info.nnz][off]])
            vals = np.concatenate([vals, mirror_vals])

        return (
            info,
            rows.astype(index_dtype),
            cols.astype(index_dtype),
            np.asarray(vals, dtype=dtype),
        )
    finally:
        if should_close:
            f.close()


def read_dense(path_or_file, *, dtype=np.float64) -> tuple[MMInfo, np.ndarray]:
    """Read an ``array``-format (dense, column-major) MatrixMarket body."""
    f, should_close = _open(path_or_file)
    try:
        info = _read_banner_open(f)
        if info.format != "array":
            raise MMError("read_dense requires array format, file is "
                          f"[{typecode_str(info)}]; use read_coo")
        per = 2 if info.field == "complex" else 1
        if info.is_symmetric:
            # Stored entries: lower triangle incl. diagonal, column-major.
            n = info.nrows
            stored = n * (n + 1) // 2
        else:
            stored = info.nrows * info.ncols
        toks = _parse_body_tokens(f, stored * per)
        if info.field == "complex":
            flat = toks[0::2] + 1j * toks[1::2]
        else:
            flat = toks
        if info.is_symmetric:
            n = info.nrows
            a = np.zeros((n, n), dtype=flat.dtype)
            ii, jj = np.tril_indices(n)
            order = np.lexsort((ii, jj))  # column-major storage order
            a[ii[order], jj[order]] = flat
            if info.symmetry == "skew-symmetric":
                a = a - a.T
            elif info.symmetry == "hermitian":
                a = a + np.conj(np.triu(a.T, 1))
            else:
                a = a + np.triu(a.T, 1)
        else:
            a = flat.reshape(info.ncols, info.nrows).T
        if not np.issubdtype(np.dtype(dtype), np.complexfloating):
            a = a.real
        return info, np.asarray(a, dtype=dtype)
    finally:
        if should_close:
            f.close()


def write_coo(
    path_or_file,
    nrows: int,
    ncols: int,
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray | None = None,
    *,
    comment: str | None = None,
) -> None:
    """Write COO triplets as a *general coordinate* MatrixMarket file.

    The analog of ``mm_write_banner`` + ``mm_write_mtx_crd``
    (``mmio.c:181-187, 386-440``); 0-based inputs, 1-based on disk.
    """
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    field = "pattern" if vals is None else (
        "complex" if np.iscomplexobj(vals) else "real"
    )
    f, should_close = _open_w(path_or_file)
    try:
        f.write(f"%%MatrixMarket matrix coordinate {field} general\n")
        if comment:
            for line in comment.splitlines():
                f.write(f"%{line}\n")
        f.write(f"{nrows} {ncols} {rows.size}\n")
        if vals is None:
            body = np.column_stack([rows + 1, cols + 1])
            np.savetxt(f, body, fmt="%d %d")
        elif field == "complex":
            for r, c, v in zip(rows, cols, vals):
                f.write(f"{r + 1} {c + 1} {v.real:.17g} {v.imag:.17g}\n")
        else:
            body = np.column_stack(
                [rows + 1, cols + 1, np.asarray(vals, dtype=np.float64)]
            )
            np.savetxt(f, body, fmt="%d %d %.17g")
    finally:
        if should_close:
            f.close()


def write_dense(path_or_file, a: np.ndarray, *,
                comment: str | None = None) -> None:
    """Write a dense matrix as an ``array``-format MatrixMarket file
    (column-major body, one value per line) — the analog of
    ``mm_write_mtx_array_size`` + the dense half of the reference's write
    path (``mmio.c:249-255, 386-440``), which ``io/mmio.py`` previously
    lacked (the last mmio parity residue).  Complex input writes
    ``real imag`` pairs; everything else writes ``real``."""
    a = np.asarray(a)
    if a.ndim != 2:
        raise MMError(f"write_dense requires a 2-D array, got shape {a.shape}")
    field = "complex" if np.iscomplexobj(a) else "real"
    f, should_close = _open_w(path_or_file)
    try:
        f.write(f"%%MatrixMarket matrix array {field} general\n")
        if comment:
            for line in comment.splitlines():
                f.write(f"%{line}\n")
        f.write(f"{a.shape[0]} {a.shape[1]}\n")
        flat = a.T.reshape(-1)  # column-major storage order (mmio.c:417)
        if field == "complex":
            body = np.column_stack([flat.real, flat.imag])
            np.savetxt(f, body, fmt="%.17g %.17g")
        else:
            np.savetxt(f, flat.astype(np.float64), fmt="%.17g")
    finally:
        if should_close:
            f.close()


def is_real_mtx(path: str) -> bool:
    """True when ``path`` exists and is an actual MatrixMarket file rather
    than a git-LFS pointer (the bundled cant.mtx, ``databases/cant.mtx:1-3``
    in the reference, is a pointer — benches must say so)."""
    if not os.path.exists(path):
        return False
    with open(path, "rb") as f:
        head = f.read(64)
    return not head.startswith(b"version https://git-lfs")


def read_path_or_synthesize(path: str, expand_symmetry: bool = True,
                            **synth_kwargs):
    """Load ``path`` if it is a real .mtx; if it is a git-LFS pointer (as the
    bundled ``databases/cant.mtx`` is, reference ``databases/cant.mtx:1-3``)
    or missing, synthesize a cant-like matrix instead.
    ``expand_symmetry=False`` keeps symmetric storage as its triangle
    (the ``sym`` format's input form)."""
    from spmv_tpu import synth

    if os.path.exists(path):
        with open(path, "rb") as f:
            head = f.read(64)
        if not head.startswith(b"version https://git-lfs"):
            return read_coo(path, expand_symmetry=expand_symmetry)
    return synth.synthetic_cant(**synth_kwargs)
