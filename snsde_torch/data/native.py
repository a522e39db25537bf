"""ctypes binding of the native (C++) host-side data path (counterpart of
snsde/data/native.py).

`snsde_torch/_native/snsde_data.cc` is the port's own copy of the JAX
package's source (so the two libraries give the same bits). `get_lib()`
builds it at first use with `make` (or g++ directly where make is absent)
into `snsde_torch/_build/libsnsde_data_<digest>.so`, named by a digest of
the source and the Makefile, and loads it; it returns None without a
toolchain, and `SNSDE_NATIVE=0` disables it. Every entry point returns
None without the library, and its callers fall back to the port's Python
versions: NaN-aware natural cubic coefficients, Hermite coefficients with
linear NaN fill, per-channel elapsed-time deltas, seeded missingness
injection and PSV parsing (`data/sepsis.py:parse_psv` tries the native
parser first).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Optional, Tuple

import numpy as np

__all__ = ["get_lib", "natural_cubic_coeffs_native", "hermite_coeffs_native",
           "compute_delta_native", "inject_missingness_native",
           "parse_psv_native"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NATIVE_DIR = os.path.join(_PKG, "_native")
_BUILD_DIR = os.path.join(_PKG, "_build")
_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]

_lib = None
_tried = False


def _lib_path() -> str:
    digest = hashlib.sha256()
    for fname in ("snsde_data.cc", "Makefile"):
        with open(os.path.join(_NATIVE_DIR, fname), "rb") as f:
            digest.update(fname.encode() + b"\0" + f.read())
    return os.path.join(_BUILD_DIR,
                        f"libsnsde_data_{digest.hexdigest()[:16]}.so")


def _build(out: str) -> bool:
    """Build the library to `out` (through a temporary name, so a reader
    never sees half a file); False on any failure."""
    tmp = f"{out}.{os.getpid()}.tmp"
    if shutil.which("make"):
        cmd = ["make", "-s", "-C", _NATIVE_DIR, f"OUT={tmp}"]
    elif shutil.which("g++"):
        os.makedirs(_BUILD_DIR, exist_ok=True)
        cmd = ["g++", *_FLAGS, os.path.join(_NATIVE_DIR, "snsde_data.cc"),
               "-o", tmp]
    else:
        return False
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
        return True
    except Exception:
        return False


def get_lib():
    """Load (building if needed) the native library; None if unavailable
    or disabled by SNSDE_NATIVE=0."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if os.environ.get("SNSDE_NATIVE", "1") == "0":
        return None
    path = _lib_path()
    if not os.path.exists(path) and not _build(path):
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None

    fp = ctypes.POINTER(ctypes.c_float)
    lib.snsde_natural_cubic_coeffs.argtypes = [fp, fp] + \
        [ctypes.c_int64] * 3 + [fp] * 4
    lib.snsde_hermite_coeffs.argtypes = [fp, fp] + \
        [ctypes.c_int64] * 3 + [fp] * 4
    lib.snsde_compute_delta.argtypes = [fp, fp] + [ctypes.c_int64] * 3 + [fp]
    lib.snsde_inject_missingness.argtypes = [fp] + [ctypes.c_int64] * 3 + [
        ctypes.c_float, ctypes.c_uint64
    ]
    lib.snsde_parse_psv.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, fp, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.snsde_parse_psv.restype = ctypes.c_int64
    _lib = lib
    return _lib


def _fptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _coeffs(entry: str, times: np.ndarray, x: np.ndarray):
    lib = get_lib()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, np.float32)
    times = np.ascontiguousarray(times, np.float32)
    B, L, C = x.shape
    outs = [np.empty((B, L - 1, C), np.float32) for _ in range(4)]
    getattr(lib, entry)(_fptr(x), _fptr(times), B, L, C, *map(_fptr, outs))
    return np.concatenate(outs, axis=-1)


def natural_cubic_coeffs_native(times: np.ndarray, x: np.ndarray):
    """[B, L, C] -> packed [B, L-1, 4C] (a, b, 2c, 3d), NaN = missing (or
    None if the library is unavailable)."""
    return _coeffs("snsde_natural_cubic_coeffs", times, x)


def hermite_coeffs_native(times: np.ndarray, x: np.ndarray):
    """Hermite cubic coefficients with backward differences over the
    linearly filled series, packed [B, L-1, 4C] (or None)."""
    return _coeffs("snsde_hermite_coeffs", times, x)


def compute_delta_native(times: np.ndarray, mask: np.ndarray):
    """Per-channel time since the last observation, [B, L, C] (or None)."""
    lib = get_lib()
    if lib is None:
        return None
    mask = np.ascontiguousarray(mask, np.float32)
    times = np.ascontiguousarray(times, np.float32)
    B, L, C = mask.shape
    out = np.empty((B, L, C), np.float32)
    lib.snsde_compute_delta(_fptr(mask), _fptr(times), B, L, C, _fptr(out))
    return out


def inject_missingness_native(x: np.ndarray, rate: float, seed: int):
    """A copy of x [B, L, C] with int(rate L) positions of each (row,
    channel) set to NaN by a seeded xorshift draw, never position 0 (or
    None)."""
    lib = get_lib()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, np.float32).copy()
    B, L, C = x.shape
    lib.snsde_inject_missingness(_fptr(x), B, L, C, ctypes.c_float(rate),
                                 ctypes.c_uint64(seed))
    return x


def parse_psv_native(text: bytes, max_rows: int = 4096,
                     max_cols: int = 64) -> Optional[Tuple[np.ndarray, int]]:
    """(values [rows, cols] float32, cols) of a PSV record with a header
    line, or None."""
    lib = get_lib()
    if lib is None:
        return None
    out = np.empty((max_rows * max_cols,), np.float32)
    n_cols = ctypes.c_int64(0)
    rows = lib.snsde_parse_psv(
        text, len(text), _fptr(out), max_rows, max_cols,
        ctypes.byref(n_cols),
    )
    nc = int(n_cols.value)
    # the C side writes row-major with stride n_cols
    return out[: rows * nc].reshape(rows, nc).copy(), nc
