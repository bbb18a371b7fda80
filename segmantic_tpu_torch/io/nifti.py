"""From-scratch NIfTI-1 codec (.nii / .nii.gz), no ITK/nibabel dependency.

Replaces the reference's ITKReader/ITKWriter usage
(reference: src/segmantic/seg/monai_unet.py:157-162,599-609 and the
SimpleITK ReadImage/WriteImage calls throughout its scripts). Host-side
numpy; the port's own copy of the JAX package's codec, so files written by
one package are read by the other.

Conventions (nibabel-compatible): data array is indexed (i, j, k) with the
fastest-varying (file) axis first, and the returned 4x4 affine maps voxel
index -> RAS+ mm. The affine is taken from sform (if sform_code > 0), else
qform (quaternion), else pixdim scaling.

The hot path (gzip inflate) runs in C via zlib (multi-member streams, as a
parallel gzip writes them, are read); writing uses the standard ``gzip``.
"""

from __future__ import annotations

import gzip
import struct
import zlib
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from ..core.volume import Volume

# NIfTI-1 datatype codes <-> numpy dtypes
_DTYPE_FROM_CODE = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
    1024: np.int64,
    1280: np.uint64,
}
_CODE_FROM_DTYPE = {np.dtype(v): k for k, v in _DTYPE_FROM_CODE.items()}

_HDR_SIZE = 348


def _quaternion_to_rotation(b: float, c: float, d: float) -> np.ndarray:
    a2 = 1.0 - (b * b + c * c + d * d)
    a = np.sqrt(max(a2, 0.0))
    return np.array(
        [
            [a * a + b * b - c * c - d * d, 2 * b * c - 2 * a * d, 2 * b * d + 2 * a * c],
            [2 * b * c + 2 * a * d, a * a + c * c - b * b - d * d, 2 * c * d - 2 * a * b],
            [2 * b * d - 2 * a * c, 2 * c * d + 2 * a * b, a * a + d * d - c * c - b * b],
        ]
    )


def _gunzip_multimember(raw: bytes) -> bytes:
    """Inflate a (possibly multi-member, pigz-style) gzip stream."""
    chunks = []
    while raw:
        d = zlib.decompressobj(wbits=47)
        chunks.append(d.decompress(raw))
        chunks.append(d.flush())
        raw = d.unused_data
    return b"".join(chunks)


def _read_bytes(path: Path) -> bytes:
    path = Path(path)
    raw = path.read_bytes()
    if raw[:2] == b"\x1f\x8b":  # gzip magic
        return _gunzip_multimember(raw)
    return raw


def _write_bytes(path: Path, payload: bytes) -> None:
    path = Path(path)
    if path.name.endswith(".gz"):
        # mtime=0 for deterministic output bytes
        path.write_bytes(gzip.compress(payload, compresslevel=4, mtime=0))
        return
    path.write_bytes(payload)


def read_nifti(path: Path) -> Tuple[np.ndarray, np.ndarray]:
    """Read a .nii/.nii.gz file → (data[(i,j,k,...)], affine 4x4 RAS).

    Data keeps its on-disk dtype unless scl_slope/inter require scaling
    (then float32). Trailing singleton dims are squeezed.
    """
    blob = _read_bytes(Path(path))
    if len(blob) < _HDR_SIZE:
        raise ValueError(f"{path}: truncated NIfTI header")

    sizeof_hdr = struct.unpack_from("<i", blob, 0)[0]
    endian = "<"
    if sizeof_hdr != _HDR_SIZE:
        sizeof_hdr = struct.unpack_from(">i", blob, 0)[0]
        if sizeof_hdr != _HDR_SIZE:
            raise ValueError(f"{path}: not a NIfTI-1 file")
        endian = ">"

    def u(fmt: str, off: int):
        return struct.unpack_from(endian + fmt, blob, off)

    magic = blob[344:348]
    if magic[:2] not in (b"n+", b"ni"):
        raise ValueError(f"{path}: bad NIfTI magic {magic!r}")

    dim = u("8h", 40)
    ndim = int(dim[0])
    shape = tuple(int(s) for s in dim[1 : 1 + ndim])
    datatype = u("h", 70)[0]
    if datatype not in _DTYPE_FROM_CODE:
        raise ValueError(f"{path}: unsupported NIfTI datatype code {datatype}")
    dtype = np.dtype(_DTYPE_FROM_CODE[datatype]).newbyteorder(endian)

    pixdim = u("8f", 76)
    vox_offset = int(u("f", 108)[0])
    scl_slope, scl_inter = u("2f", 112)
    qform_code, sform_code = u("2h", 252)

    # data: file order is Fortran (first index fastest)
    count = int(np.prod(shape)) if shape else 0
    data = np.frombuffer(blob, dtype=dtype, count=count, offset=vox_offset)
    data = data.reshape(shape, order="F")
    if endian == ">":
        data = data.astype(data.dtype.newbyteorder("<"))

    if scl_slope not in (0.0, 1.0) or (scl_slope != 0.0 and scl_inter != 0.0):
        data = data.astype(np.float32) * np.float32(scl_slope) + np.float32(scl_inter)

    # squeeze trailing singleton dims beyond 3 (time/vector dims of size 1)
    while data.ndim > 3 and data.shape[-1] == 1:
        data = data.reshape(data.shape[:-1])

    # affine
    if sform_code > 0:
        srow = np.array([u("4f", 280), u("4f", 296), u("4f", 312)], dtype=np.float64)
        affine = np.vstack([srow, [0.0, 0.0, 0.0, 1.0]])
    elif qform_code > 0:
        b, c, d = u("3f", 256)
        qoffset = np.array(u("3f", 268), dtype=np.float64)
        rot = _quaternion_to_rotation(b, c, d)
        qfac = -1.0 if pixdim[0] == -1.0 else 1.0
        spacing = np.array(
            [pixdim[1], pixdim[2], pixdim[3] * qfac], dtype=np.float64
        )
        affine = np.eye(4, dtype=np.float64)
        affine[:3, :3] = rot * spacing[None, :]
        affine[:3, 3] = qoffset
    else:
        affine = np.diag(
            [pixdim[1] or 1.0, pixdim[2] or 1.0, pixdim[3] or 1.0, 1.0]
        ).astype(np.float64)

    return np.ascontiguousarray(data), affine


def write_nifti(
    path: Path,
    data: np.ndarray,
    affine: Optional[np.ndarray] = None,
) -> None:
    """Write a (i,j,k[,t]) array + RAS affine as NIfTI-1 single-file (.nii[.gz])."""
    path = Path(path)
    data = np.asarray(data)
    if affine is None:
        affine = np.eye(4, dtype=np.float64)
    affine = np.asarray(affine, dtype=np.float64)

    if data.dtype == np.bool_:
        data = data.astype(np.uint8)
    if np.dtype(data.dtype) not in _CODE_FROM_DTYPE:
        data = data.astype(np.float32)
    code = _CODE_FROM_DTYPE[np.dtype(data.dtype)]

    ndim = data.ndim
    if ndim > 7:
        raise ValueError("NIfTI supports at most 7 dims")
    dim = [ndim] + list(data.shape) + [1] * (7 - ndim)

    spacing = np.linalg.norm(affine[:3, :3], axis=0)
    spacing = np.where(spacing == 0, 1.0, spacing)
    pixdim = [1.0] + list(spacing[: min(ndim, 3)]) + [1.0] * (7 - min(ndim, 3))

    hdr = bytearray(_HDR_SIZE)
    struct.pack_into("<i", hdr, 0, _HDR_SIZE)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, code)
    struct.pack_into("<h", hdr, 72, data.dtype.itemsize * 8)  # bitpix
    struct.pack_into("<8f", hdr, 76, *pixdim)
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<2f", hdr, 112, 1.0, 0.0)  # scl_slope/inter
    struct.pack_into("<2h", hdr, 252, 0, 1)  # qform_code=0, sform_code=1
    struct.pack_into("<4f", hdr, 280, *affine[0, :])
    struct.pack_into("<4f", hdr, 296, *affine[1, :])
    struct.pack_into("<4f", hdr, 312, *affine[2, :])
    hdr[344:348] = b"n+1\x00"

    payload = bytes(hdr) + b"\x00" * 4 + np.asfortranarray(data).tobytes(order="F")
    _write_bytes(path, payload)


def read_volume(path: Path) -> Volume:
    """Read a NIfTI file into a channel-first :class:`Volume`."""
    data, affine = read_nifti(path)
    if data.ndim == 4:  # treat 4th dim as channels (moved first)
        data = np.moveaxis(data, -1, 0)
    else:
        data = data[None]
    vol = Volume(data=np.ascontiguousarray(data), affine=affine)
    vol.meta["filename"] = str(path)
    vol.meta["original_affine"] = affine.copy()
    return vol


def write_volume(path: Path, vol: Volume) -> None:
    """Write a :class:`Volume` (single- or multi-channel) as NIfTI."""
    data = vol.numpy()
    if data.shape[0] == 1:
        data = data[0]
    else:
        data = np.moveaxis(data, 0, -1)
    write_nifti(path, data, vol.affine)
