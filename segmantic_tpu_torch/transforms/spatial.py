"""Spatial dict-transforms of the deterministic preprocessing (host numpy).

Port of ``segmantic_tpu/transforms/spatial.py`` (``LoadImaged``,
``Orientationd``, ``NormalizeIntensityd``, ``CropForegroundd``, ``Spacingd``,
``EnsureTyped``): the same numpy code with the same applied-ops log, which
``post.Invertd`` replays to map predictions back to the input grid. The
Volume container, NIfTI I/O and orientation helpers are the port's own copies
(``core/``, ``io/``); ``Spacingd`` takes the native C++ resampler
(``native.py``) when the library is available, as the JAX code does.
"""

from __future__ import annotations

from pathlib import Path
from typing import Sequence

import numpy as np

from ..core import orientation as orient
from ..core.volume import Volume
from ..io.nifti import read_volume

from .. import native
from ..ops.resample import grid_matrix, output_affine_for_spacing, resample_affine_np
from .base import MapTransform, Sample


class LoadImaged(MapTransform):
    """Read NIfTI files into channel-first Volumes (keeps affine metadata)."""

    def __call__(self, sample: Sample) -> Sample:
        out = dict(sample)
        for key in self.present_keys(sample):
            value = sample[key]
            if isinstance(value, (str, Path)):
                out[key] = read_volume(Path(value))
        return out


class Orientationd(MapTransform):
    """Reorient volumes to the target axis codes (records inverse info).

    Any target codes are supported (LPS, AIR, ...) for 3D, and 2D volumes
    are reoriented within the two physical axes their plane spans —
    including flips encoded by negative-determinant 2D affines.
    """

    def __init__(self, keys, axcodes: str = "RAS"):
        super().__init__(keys)
        parse_axcodes_validate = orient.parse_axcodes(axcodes)
        if len(parse_axcodes_validate) != 3:
            raise ValueError(f"axcodes must name 3 physical axes, got {axcodes!r}")
        self.axcodes = axcodes

    def __call__(self, sample: Sample) -> Sample:
        out = dict(sample)
        for key in self.present_keys(sample):
            vol: Volume = sample[key]
            data, affine, perm, flips = orient.reorient_to_axcodes(
                vol.numpy(), vol.affine, self.axcodes
            )
            new = vol.with_data(data, affine)
            new.applied_ops.append(
                {
                    "op": "orientation",
                    "pre_affine": vol.affine.copy(),
                    "axcodes": self.axcodes,
                    "perm": list(perm),
                    "flips": list(flips),
                }
            )
            out[key] = new
        return out


class NormalizeIntensityd(MapTransform):
    """Z-score normalize (optionally per channel / nonzero-masked)."""

    def __init__(self, keys, nonzero: bool = False, channel_wise: bool = True):
        super().__init__(keys)
        self.nonzero = nonzero
        self.channel_wise = channel_wise

    def __call__(self, sample: Sample) -> Sample:
        out = dict(sample)
        for key in self.present_keys(sample):
            vol: Volume = sample[key]
            data = vol.numpy().astype(np.float32)
            if self.channel_wise:
                for c in range(data.shape[0]):
                    data[c] = self._normalize(data[c])
            else:
                data = self._normalize(data)
            out[key] = vol.with_data(data)
        return out

    def _normalize(self, x: np.ndarray) -> np.ndarray:
        sel = x[x != 0] if self.nonzero else x
        if sel.size == 0:
            return x
        mean = sel.mean()
        std = sel.std()
        return (x - mean) / (std if std > 0 else 1.0)


def foreground_bbox(
    source: np.ndarray, margin: int = 0
) -> "tuple[list, list]":
    """Bounding box (start, end exclusive) of nonzero voxels across channels."""
    nd = source.ndim - 1
    mask = source != 0
    if not mask.any():
        return [0] * nd, list(source.shape[1:])
    start, end = [], []
    for ax in range(nd):
        other = tuple(a for a in range(source.ndim) if a != ax + 1)
        proj = mask.any(axis=other)
        nz = np.flatnonzero(proj)
        start.append(max(int(nz[0]) - margin, 0))
        end.append(min(int(nz[-1]) + 1 + margin, source.shape[ax + 1]))
    return start, end


class CropForegroundd(MapTransform):
    """Crop all keys to the nonzero bounding box of ``source_key``."""

    def __init__(self, keys, source_key: str, margin: int = 0, allow_smaller: bool = False):
        super().__init__(keys)
        self.source_key = source_key
        self.margin = margin

    def __call__(self, sample: Sample) -> Sample:
        out = dict(sample)
        src: Volume = sample[self.source_key]
        start, end = foreground_bbox(src.numpy(), self.margin)
        for key in self.present_keys(sample):
            vol: Volume = sample[key]
            nd = vol.ndim_spatial
            sl = [slice(None)] + [slice(s, e) for s, e in zip(start, end)]
            data = np.ascontiguousarray(vol.numpy()[tuple(sl)])
            aff = vol.affine.copy()
            aff[:3, 3] = aff[:3, 3] + aff[:3, :nd] @ np.asarray(start, np.float64)
            new = vol.with_data(data, aff)
            new.applied_ops.append(
                {
                    "op": "crop",
                    "start": list(start),
                    "pre_shape": list(vol.spatial_shape),
                    "pre_affine": vol.affine.copy(),
                }
            )
            out[key] = new
        return out


class Spacingd(MapTransform):
    """Resample to target spacing (ITK out-size convention); image linear,
    label nearest."""

    def __init__(self, keys, pixdim: Sequence[float], label_keys: Sequence[str] = ("label",)):
        super().__init__(keys)
        self.pixdim = list(pixdim)
        self.label_keys = set(label_keys)

    def __call__(self, sample: Sample) -> Sample:
        out = dict(sample)
        for key in self.present_keys(sample):
            vol: Volume = sample[key]
            nd = vol.ndim_spatial
            out_aff, out_shape = output_affine_for_spacing(
                vol.affine, vol.spatial_shape, self.pixdim[:nd]
            )
            m = grid_matrix(vol.affine, out_aff, nd)
            order = 0 if key in self.label_keys else 1
            data = self._resample(vol.numpy(), m, out_shape, order)
            new = vol.with_data(data, out_aff)
            new.applied_ops.append(
                {
                    "op": "spacing",
                    "pre_affine": vol.affine.copy(),
                    "pre_shape": list(vol.spatial_shape),
                }
            )
            out[key] = new
        return out

    @staticmethod
    def _resample(data: np.ndarray, m: np.ndarray, out_shape, order: int) -> np.ndarray:
        """The multithreaded native resampler on the cache-build hot path
        (float32, 3D) when the library is available; the numpy resampler
        otherwise (same result)."""
        if data.ndim - 1 == 3 and native.available():
            out = native.resample_affine(
                data.astype(np.float32), m, out_shape, order=order
            )
            return out if np.issubdtype(data.dtype, np.floating) else out.astype(
                data.dtype
            )
        return resample_affine_np(data, m, out_shape, order=order)


class EnsureTyped(MapTransform):
    """Cast image keys to float32 and label keys to int32 numpy arrays."""

    def __init__(self, keys, label_keys: Sequence[str] = ("label",)):
        super().__init__(keys)
        self.label_keys = set(label_keys)

    def __call__(self, sample: Sample) -> Sample:
        out = dict(sample)
        for key in self.present_keys(sample):
            vol: Volume = sample[key]
            dtype = np.int32 if key in self.label_keys else np.float32
            out[key] = vol.with_data(vol.numpy().astype(dtype))
        return out
