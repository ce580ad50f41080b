"""ctypes binding to the native C++ MatrixMarket body parser
(``native/mm_parse.cpp``) with transparent build + pure-NumPy fallback.

Set ``SPMV_NO_NATIVE=1`` to force the fallback.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

__all__ = ["available", "parse_body", "ensure_built"]

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
_SO = os.path.join(_NATIVE_DIR, "libmmparse.so")
_lib = None
_tried = False


def ensure_built() -> bool:
    """Build the shared library if missing; returns availability."""
    if os.path.exists(_SO):
        return True
    try:
        subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                       capture_output=True, timeout=120)
    except Exception:
        return False
    return os.path.exists(_SO)


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if os.environ.get("SPMV_NO_NATIVE"):
        return None
    if not ensure_built():
        return None
    try:
        lib = ctypes.CDLL(_SO)
        lib.mm_parse_body.restype = ctypes.c_int64
        lib.mm_parse_body.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_void_p, ctypes.c_int,
        ]
        if lib.mm_native_abi_version() != 1:
            return None
        _lib = lib
    except OSError:
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def parse_body(buf: bytes, count: int, tokens_per_entry: int):
    """Parse `count` coordinate entries from a body buffer.

    Returns (rows_i32_1based, cols_i32_1based, vals_f64_or_None).
    Raises ValueError on truncation; returns None if native unavailable.
    """
    lib = _load()
    if lib is None:
        return None
    rows = np.empty(count, dtype=np.int32)
    cols = np.empty(count, dtype=np.int32)
    if tokens_per_entry == 2:
        vals = None
        vptr = None
    elif tokens_per_entry == 3:
        vals = np.empty(count, dtype=np.float64)
        vptr = vals.ctypes.data_as(ctypes.c_void_p)
    else:
        vals = np.empty(2 * count, dtype=np.float64)
        vptr = vals.ctypes.data_as(ctypes.c_void_p)
    got = lib.mm_parse_body(
        buf, len(buf), count, tokens_per_entry,
        rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        vptr, 0,
    )
    if got != count:
        raise ValueError(f"truncated body: expected {count} entries, got {got}")
    return rows, cols, vals
