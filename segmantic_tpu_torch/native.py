"""ctypes bindings of the native C++ runtime (``native/`` at the repository
root).

The port's own copy of the JAX package's ``native.py``: the multithreaded
affine resample (``transforms.spatial.Spacingd`` when the cache is built),
the exact Euclidean distance transform (``metrics.distance``), the batched
margin-patch crop with its bf16 wire (``data.cache.PatchSampler``), label
surface extraction, mesh decimation and a PLY writer. The library is built
with ``make`` on first use when a compiler is there; callers ask
:func:`available` and take the numpy implementation when it is not.

The bf16 wire needs no bf16 type in numpy: :func:`crop_patches_3d` writes
the bf16 bit patterns into a ``uint16`` array, which the caller views as
``torch.bfloat16``.

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
from typing import Optional, Sequence, Tuple

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
        lib.edt_distance_to_foreground.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int,
        ]
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
        surface_sig = [
            ctypes.POINTER(ctypes.c_uint16),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_uint16,
            ctypes.c_int,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
        ]
        for name in ("extract_label_surface", "extract_label_surface_net",
                     "extract_label_surface_mt"):
            getattr(lib, name).restype = ctypes.c_int64
            getattr(lib, name).argtypes = surface_sig
        lib.decimate_mesh.restype = ctypes.c_int64
        lib.decimate_mesh.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
            ctypes.c_double,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
        ]
        lib.surface_free.argtypes = [ctypes.c_void_p]
        lib.crop_patches_3d.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_void_p,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int,
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_uint8),
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


def _as_f64(seq: Sequence[float]) -> "ctypes.Array":
    return (ctypes.c_double * len(seq))(*[float(s) for s in seq])


def edt_distance_to_foreground(
    mask: np.ndarray, spacing: Optional[Sequence[float]] = None
) -> np.ndarray:
    """Exact EDT (mm): distance from each voxel to the nearest nonzero voxel."""
    lib = _load()
    mask = np.ascontiguousarray(mask.astype(np.uint8))
    ndim = mask.ndim
    if ndim not in (2, 3):
        raise ValueError("EDT supports 2D/3D masks")
    out = np.empty(mask.shape, np.float32)
    spacing = list(spacing) if spacing is not None else [1.0] * ndim
    lib.edt_distance_to_foreground(
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        _as_i64(mask.shape),
        _as_f64(spacing),
        ndim,
    )
    return out


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


def extract_label_surface(
    labels: np.ndarray,
    affine: np.ndarray,
    label_id: int,
    smooth_iters: int = 10,
    method: str = "marching",
    decimate: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Extract the surface of ``labels == label_id`` as (verts, triangles).

    method: 'marching' (marching tetrahedra, a true isosurface triangle mesh,
    the default), 'surface_net' (naive surface nets) or 'voxel' (blocky
    voxel-face quads). ``decimate`` is the fraction of triangles to remove
    afterwards by quadric-error edge collapse (vtkDecimatePro's
    target_reduction; reference: scripts/visualize_label_surfaces.py:33-69).
    """
    lib = _load()
    fn = {
        "marching": lib.extract_label_surface_mt,
        "surface_net": lib.extract_label_surface_net,
        "voxel": lib.extract_label_surface,
    }[method]
    labels = np.ascontiguousarray(np.squeeze(labels).astype(np.uint16))
    if labels.ndim != 3:
        raise ValueError("surface extraction expects a 3D label map")
    affine = np.ascontiguousarray(affine, np.float64)

    verts_p = ctypes.POINTER(ctypes.c_float)()
    tris_p = ctypes.POINTER(ctypes.c_int64)()
    n_verts = ctypes.c_int64(0)
    n_tris = fn(
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        _as_i64(labels.shape),
        affine.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        int(label_id),
        int(smooth_iters),
        ctypes.byref(verts_p),
        ctypes.byref(n_verts),
        ctypes.byref(tris_p),
    )
    try:
        verts = np.ctypeslib.as_array(verts_p, shape=(n_verts.value, 3)).copy()
        tris = np.ctypeslib.as_array(tris_p, shape=(int(n_tris), 3)).copy()
    finally:
        lib.surface_free(verts_p)
        lib.surface_free(tris_p)
    if decimate > 0.0:
        verts, tris = decimate_mesh(verts, tris, decimate)
    return verts, tris


def decimate_mesh(
    verts: np.ndarray, tris: np.ndarray, reduction: float
) -> Tuple[np.ndarray, np.ndarray]:
    """Remove ``reduction`` of the triangles by quadric-error edge collapse
    (the vtkDecimatePro stand-in)."""
    lib = _load()
    verts = np.ascontiguousarray(verts, np.float32)
    tris = np.ascontiguousarray(tris, np.int64)
    verts_p = ctypes.POINTER(ctypes.c_float)()
    tris_p = ctypes.POINTER(ctypes.c_int64)()
    n_verts = ctypes.c_int64(0)
    n_tris = lib.decimate_mesh(
        verts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        len(verts),
        tris.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(tris),
        ctypes.c_double(float(reduction)),
        ctypes.byref(verts_p),
        ctypes.byref(n_verts),
        ctypes.byref(tris_p),
    )
    try:
        out_v = np.ctypeslib.as_array(verts_p, shape=(n_verts.value, 3)).copy()
        out_t = np.ctypeslib.as_array(tris_p, shape=(int(n_tris), 3)).copy()
    finally:
        lib.surface_free(verts_p)
        lib.surface_free(tris_p)
    return out_v, out_t


def write_ply(path, verts: np.ndarray, tris: np.ndarray) -> None:
    """Minimal ascii PLY writer for extracted surfaces."""
    lines = [
        "ply",
        "format ascii 1.0",
        f"element vertex {len(verts)}",
        "property float x",
        "property float y",
        "property float z",
        f"element face {len(tris)}",
        "property list uchar int vertex_indices",
        "end_header",
    ]
    for v in verts:
        lines.append(f"{v[0]:.6f} {v[1]:.6f} {v[2]:.6f}")
    for t in tris:
        lines.append(f"3 {t[0]} {t[1]} {t[2]}")
    Path(path).write_text("\n".join(lines) + "\n")


def crop_patches_3d(
    image: np.ndarray,  # (C, S0, S1, S2) float32
    label: Optional[np.ndarray],  # (S0, S1, S2) uint8|int32 (labels < 256) or None
    starts: np.ndarray,  # (B, 3) int64
    out_size: Sequence[int],
    to_bf16: bool = False,
    out: Optional[Tuple[np.ndarray, Optional[np.ndarray]]] = None,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Multithreaded batched margin-patch crop (zero pad, channel-last, fused
    dtype cast). Returns (images (B, *out, C), labels (B, *out) uint8 or
    None); the images are float32, or with ``to_bf16`` the bf16 bit patterns
    (round to nearest even) in a ``uint16`` array.

    uint8 labels pass straight through (no whole-volume int32 conversion).
    ``out`` lets the caller provide preallocated (and batch-sliced)
    destination arrays (``uint16`` images for ``to_bf16``), so multi-volume
    batches assemble in place.
    """
    lib = _load()
    image = np.ascontiguousarray(image, np.float32)
    c = image.shape[0]
    starts = np.ascontiguousarray(starts, np.int64)
    b = len(starts)
    out_sz = tuple(int(s) for s in out_size)

    img_dtype = np.uint16 if to_bf16 else np.float32
    if out is not None:
        img_out, lbl_out = out
        assert img_out.shape == (b,) + out_sz + (c,) and img_out.dtype == img_dtype
        assert img_out.flags["C_CONTIGUOUS"]
    else:
        img_out = np.empty((b,) + out_sz + (c,), img_dtype)
        lbl_out = np.empty((b,) + out_sz, np.uint8) if label is not None else None

    if label is not None:
        if label.dtype != np.uint8:
            label = np.ascontiguousarray(label, np.int32)
        elif not label.flags["C_CONTIGUOUS"]:
            label = np.ascontiguousarray(label)
        assert lbl_out is not None and lbl_out.shape == (b,) + out_sz
        assert lbl_out.dtype == np.uint8 and lbl_out.flags["C_CONTIGUOUS"]
        lbl_ptr = lbl_out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        lbl_src = label.ctypes.data_as(ctypes.c_void_p)
        lbl_u8 = 1 if label.dtype == np.uint8 else 0
    else:
        lbl_out = None
        lbl_ptr = ctypes.POINTER(ctypes.c_uint8)()
        lbl_src = ctypes.c_void_p()
        lbl_u8 = 0

    lib.crop_patches_3d(
        image.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        lbl_src,
        lbl_u8,
        _as_i64(image.shape[1:]),
        c,
        starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        b,
        _as_i64(out_sz),
        1 if to_bf16 else 0,
        img_out.ctypes.data_as(ctypes.c_void_p),
        lbl_ptr,
    )
    return img_out, lbl_out
