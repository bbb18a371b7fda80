"""ctypes binding of the native C++ resampler (``native/`` at the repository
root).

The port's own copy of the loader in the JAX package's ``native.py``, with
only the entry point the port calls: the multithreaded affine resample that
``transforms.spatial.Spacingd`` uses when the cache is built. The library is
built with ``make`` on first use when a compiler is there; callers ask
:func:`available` and take the numpy implementation when it is not.
"""

from __future__ import annotations

import ctypes
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
_LIB_PATH = _NATIVE_DIR / "libsegmantic_native.so"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def _load() -> ctypes.CDLL:
    global _lib, _load_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _load_failed:
            raise RuntimeError("native library unavailable")
        try:
            if not _LIB_PATH.exists():
                subprocess.run(
                    ["make", "-s"], cwd=_NATIVE_DIR, check=True, capture_output=True
                )
            lib = ctypes.CDLL(str(_LIB_PATH))
        except (OSError, subprocess.CalledProcessError) as e:
            _load_failed = True
            raise RuntimeError(f"native library unavailable: {e}") from e
        lib.resample_affine_f32.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_float,
        ]
        _lib = lib
        return lib


def available() -> bool:
    """Whether the native library is there (built now if it can be)."""
    try:
        _load()
        return True
    except RuntimeError:
        return False


def _as_i64(seq: Sequence[int]) -> "ctypes.Array":
    return (ctypes.c_int64 * len(seq))(*[int(s) for s in seq])


def resample_affine(
    data: np.ndarray,
    matrix: np.ndarray,
    out_shape: Sequence[int],
    order: int = 1,
    cval: float = 0.0,
) -> np.ndarray:
    """Multithreaded channel-first affine resample (float32)."""
    lib = _load()
    nd = data.ndim - 1
    work = np.ascontiguousarray(data, np.float32)
    out = np.empty((data.shape[0],) + tuple(int(s) for s in out_shape), np.float32)
    m = np.ascontiguousarray(matrix, np.float64)
    lib.resample_affine_f32(
        work.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        _as_i64(work.shape[1:]),
        _as_i64(out.shape[1:]),
        work.shape[0],
        m.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        nd,
        order,
        cval,
    )
    return out
