"""Parsed-matrix caching.

The reference re-parses the 60 MB .mtx text file from scratch on every run
— three full parses per driver execution (SURVEY.md §3.5).  Here the
parsed triplets are kept as ``.npz``, keyed by a file content fingerprint,
so a second run skips the parse.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np

__all__ = ["cache_key", "save_plan", "load_plan", "cached_convert",
           "setup_compile_cache"]

_CACHE_VERSION = 5  # bump when the cached layout changes


def _fingerprint(path: str) -> str:
    """Content fingerprint: sha256 of size + first/last 64KB (fast on the
    60MB benchmark files, strong enough for a local cache)."""
    h = hashlib.sha256()
    size = os.path.getsize(path)
    h.update(str(size).encode())
    with open(path, "rb") as f:
        h.update(f.read(65536))
        if size > 131072:
            f.seek(-65536, 2)
            h.update(f.read(65536))
    return h.hexdigest()[:24]


def cache_key(path: str, format: str, params: dict) -> str:
    p = json.dumps(params, sort_keys=True, default=str)
    h = hashlib.sha256(f"v{_CACHE_VERSION}|{format}|{p}".encode()).hexdigest()[:12]
    return f"{_fingerprint(path)}-{format}-{h}"


def save_plan(cache_dir: str, key: str, meta: dict, arrays: dict) -> str:
    os.makedirs(cache_dir, exist_ok=True)
    out = os.path.join(cache_dir, key + ".npz")
    tmp = out + ".tmp.npz"
    np.savez_compressed(tmp, __meta__=np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8), **arrays)
    os.replace(tmp, out)
    return out


def load_plan(cache_dir: str, key: str):
    path = os.path.join(cache_dir, key + ".npz")
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        arrays = {k: z[k] for k in z.files if k != "__meta__"}
    return meta, arrays


def cached_convert(path: str, format: str, cache_dir: str | None = None,
                   **fmt_kwargs):
    """Load + convert with an npz cache of the parsed triplets.  Returns
    the format container."""
    from spmv_tpu.api import from_coo
    from spmv_tpu.io.mmio import read_path_or_synthesize

    if cache_dir is None or not os.path.exists(path):
        info, rows, cols, vals = read_path_or_synthesize(path)
        return from_coo(format, info.nrows, info.ncols, rows, cols, vals,
                        **fmt_kwargs)

    key = cache_key(path, "coo-triplets", {})
    hit = load_plan(cache_dir, key)
    if hit is not None:
        meta, arrays = hit
        rows, cols, vals = arrays["rows"], arrays["cols"], arrays["vals"]
        nrows, ncols = meta["nrows"], meta["ncols"]
    else:
        info, rows, cols, vals = read_path_or_synthesize(path)
        nrows, ncols = info.nrows, info.ncols
        save_plan(cache_dir, key, {"nrows": nrows, "ncols": ncols},
                  {"rows": rows, "cols": cols, "vals": vals})
    return from_coo(format, nrows, ncols, rows, cols, vals, **fmt_kwargs)


def setup_compile_cache() -> str | None:
    """Point JAX's persistent compilation cache at ``<checkout>/.jax_cache``
    unless ``JAX_COMPILATION_CACHE_DIR`` is set — JAX reads that variable
    itself, so then nothing is set here.  A fixed path matters: a
    directory that moves from run to run is never found again.
    Returns the path set, or None."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    import jax

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
