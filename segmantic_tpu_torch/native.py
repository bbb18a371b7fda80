"""ctypes binding of the native C++ resampler (``native/`` at the repository
root).

The port's own copy of the loader in the JAX package's ``native.py``, with
only the entry point the port calls: the multithreaded affine resample that
``transforms.spatial.Spacingd`` uses when the cache is built. The library is
built with ``make`` on first use when a compiler is there; callers ask
:func:`available` and take the numpy implementation when it is not.

Processes that start together (test workers) build at most one at a time,
under an exclusive ``flock`` on ``native/.build.lock``, and the library is
linked to a temporary name and renamed into place, so no process loads a
half-written file.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
_LIB_PATH = _NATIVE_DIR / "libsegmantic_native.so"
_BUILD_LOCK = _NATIVE_DIR / ".build.lock"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def _build() -> None:
    """Build the library unless it is there, one process at a time: link to
    a temporary name, then rename it onto ``_LIB_PATH``."""
    with open(_BUILD_LOCK, "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if _LIB_PATH.exists():
                return
            tmp = f".{_LIB_PATH.name}.{os.getpid()}.tmp"
            try:
                subprocess.run(["make", "-s", f"TARGET={tmp}"], cwd=_NATIVE_DIR,
                               check=True, capture_output=True)
                os.replace(_NATIVE_DIR / tmp, _LIB_PATH)
            finally:
                (_NATIVE_DIR / tmp).unlink(missing_ok=True)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def _stamp():
    try:
        st = _LIB_PATH.stat()
        return st.st_ino, st.st_size, st.st_mtime_ns
    except FileNotFoundError:
        return None


def _load() -> ctypes.CDLL:
    global _lib, _load_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _load_failed:
            raise RuntimeError("native library unavailable")
        try:
            if not _LIB_PATH.exists():
                _build()
        except (OSError, subprocess.CalledProcessError) as e:
            _load_failed = True
            raise RuntimeError(f"native library unavailable: {e}") from e
        before = _stamp()
        try:
            lib = ctypes.CDLL(str(_LIB_PATH))
        except OSError as e:
            # a file that changed while it was loaded (another process was
            # still writing it) may load on the next call: no caching then
            if _stamp() == before:
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
