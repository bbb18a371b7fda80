"""Spatial dict-transforms: load, orient, crop, pad, resample, random geometry
(host numpy).

Port of ``segmantic_tpu/transforms/spatial.py``: the deterministic
preprocessing (``LoadImaged``, ``Orientationd``, ``NormalizeIntensityd``,
``CropForegroundd``, ``Spacingd``, ``EnsureTyped``, ``SpatialPadd``) with the
applied-ops log that ``post.Invertd`` replays to map predictions back to the
input grid, and the random geometry of a config-driven augmentation
(``RandCropByLabelClassesd``, ``RandFlipd``, ``RandRotated``, ``RandZoomd``),
which draws from the ``numpy.random.Generator`` it is called with: the same
numpy code, so the same crops, flips and resampled voxels from the same
generator. The Volume container, NIfTI I/O and orientation helpers are the
port's own copies (``core/``, ``io/``); ``Spacingd`` takes the native C++
resampler (``native.py``) when the library is available, as the JAX code does.
The rotations and zooms resample whole volumes or patches with numpy on the
host; ``train(augment_spatial=True)`` is the fast path on the card.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

from ..core import orientation as orient
from ..core.volume import Volume
from ..io.nifti import read_volume

from .. import native
from ..image.processing import pad
from ..ops.resample import grid_matrix, output_affine_for_spacing, resample_affine_np
from .base import MapTransform, RandMapTransform, Sample


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


class SpatialPadd(MapTransform):
    """Center-pad up to ``spatial_size`` (no-op for axes already large enough)."""

    def __init__(self, keys, spatial_size: Sequence[int], value: float = 0):
        super().__init__(keys)
        self.spatial_size = list(spatial_size)
        self.value = value

    def __call__(self, sample: Sample) -> Sample:
        out = dict(sample)
        for key in self.present_keys(sample):
            vol: Volume = sample[key]
            padded = pad(vol, self.spatial_size, self.value)
            if padded is not vol:
                padded.applied_ops.append(
                    {
                        "op": "pad",
                        "pre_shape": list(vol.spatial_shape),
                        "pre_affine": vol.affine.copy(),
                    }
                )
            out[key] = padded
        return out


def sample_class_centers(
    label: np.ndarray,
    num_classes: int,
    ratios: Sequence[float],
    num_samples: int,
    spatial_size: Sequence[int],
    rng: np.random.Generator,
    class_indices: Optional[List[np.ndarray]] = None,
) -> List[List[int]]:
    """Sample patch centers by class ratio; clamp so patches fit in bounds.

    ``class_indices`` may be precomputed (flat indices per class) — the host
    volume cache stores these to avoid rescanning the label map every step.
    """
    shape = label.shape[1:]
    nd = len(shape)
    if class_indices is None:
        flat = label.reshape(label.shape[0], -1)[0]
        class_indices = [np.flatnonzero(flat == c) for c in range(num_classes)]
    ratios = np.asarray(ratios, np.float64)
    avail = np.array([len(ci) > 0 for ci in class_indices])
    weights = np.where(avail, ratios, 0.0)
    if weights.sum() == 0:
        weights = avail.astype(np.float64)
    weights = weights / weights.sum()

    centers = []
    lo = [s // 2 for s in spatial_size[:nd]]
    hi = [shape[a] - (spatial_size[a] - spatial_size[a] // 2) for a in range(nd)]
    for _ in range(num_samples):
        cls = rng.choice(num_classes, p=weights)
        pick = class_indices[cls][rng.integers(len(class_indices[cls]))]
        center = list(np.unravel_index(pick, shape))
        center = [int(np.clip(center[a], lo[a], max(hi[a], lo[a]))) for a in range(nd)]
        centers.append(center)
    return centers


class RandCropByLabelClassesd(RandMapTransform):
    """Class-balanced random patch sampling: one sample → ``num_samples``
    patches centered on voxels of ratio-sampled classes."""

    def __init__(
        self,
        keys,
        label_key: str,
        spatial_size: Sequence[int],
        num_classes: int,
        num_samples: int = 1,
        ratios: Optional[Sequence[float]] = None,
    ):
        super().__init__(keys, prob=1.0)
        self.label_key = label_key
        self.spatial_size = list(spatial_size)
        self.num_classes = num_classes
        self.num_samples = num_samples
        self.ratios = (
            list(ratios)
            if ratios is not None
            else [0 if c == 0 else 1 for c in range(num_classes)]
        )

    def __call__(self, sample: Sample, rng: np.random.Generator) -> List[Sample]:
        label: Volume = sample[self.label_key]
        nd = label.ndim_spatial
        size = self.spatial_size[:nd]
        centers = sample_class_centers(
            label.numpy(), self.num_classes, self.ratios, self.num_samples, size, rng,
            class_indices=sample.get("_class_indices"),
        )
        results = []
        for center in centers:
            item = dict(sample)
            for key in self.present_keys(sample):
                vol: Volume = sample[key]
                start = [center[a] - size[a] // 2 for a in range(nd)]
                sl = [slice(None)] + [slice(s, s + size[a]) for a, s in enumerate(start)]
                data = np.ascontiguousarray(vol.numpy()[tuple(sl)])
                aff = vol.affine.copy()
                aff[:3, 3] = aff[:3, 3] + aff[:3, :nd] @ np.asarray(start, np.float64)
                item[key] = vol.with_data(data, aff)
            results.append(item)
        return results


class RandFlipd(RandMapTransform):
    """Flip along one spatial axis with probability ``prob``."""

    def __init__(self, keys, prob: float = 0.1, spatial_axis: int = 0):
        super().__init__(keys, prob)
        self.spatial_axis = spatial_axis

    def __call__(self, sample: Sample, rng: np.random.Generator) -> Sample:
        if not self.should_apply(rng):
            return sample
        out = dict(sample)
        for key in self.present_keys(sample):
            vol: Volume = sample[key]
            out[key] = vol.with_data(
                np.ascontiguousarray(np.flip(vol.numpy(), axis=self.spatial_axis + 1))
            )
        return out


def _rotation_matrix(nd: int, axis: int, angle: float) -> np.ndarray:
    rot = np.eye(nd)
    if nd == 2:
        a, b = 0, 1
    else:
        a, b = [d for d in range(3) if d != axis]
    c, s = np.cos(angle), np.sin(angle)
    rot[a, a], rot[a, b], rot[b, a], rot[b, b] = c, -s, s, c
    return rot


def rotate_volume(vol: Volume, axis: int, angle: float, order: int) -> Volume:
    """Rotate about the volume center (keep_size, zero padding)."""
    nd = vol.ndim_spatial
    rot = _rotation_matrix(nd, axis, angle)
    center = (np.asarray(vol.spatial_shape, np.float64) - 1) / 2
    m = np.zeros((nd, nd + 1))
    m[:, :nd] = rot
    m[:, nd] = center - rot @ center
    data = resample_affine_np(vol.numpy(), m, vol.spatial_shape, order=order)
    return vol.with_data(data)


def zoom_volume(vol: Volume, factors: Sequence[float], order: int) -> Volume:
    """Zoom about the center, keeping the original array size (MONAI
    keep_size semantics: zoom>1 magnifies and crops, zoom<1 shrinks and pads)."""
    nd = vol.ndim_spatial
    center = (np.asarray(vol.spatial_shape, np.float64) - 1) / 2
    m = np.zeros((nd, nd + 1))
    for a in range(nd):
        m[a, a] = 1.0 / factors[a]
        m[a, nd] = center[a] - center[a] / factors[a]
    data = resample_affine_np(vol.numpy(), m, vol.spatial_shape, order=order)
    return vol.with_data(data)


class RandRotated(RandMapTransform):
    """Random rotation about one axis, angle ~ U(-range, range) radians."""

    def __init__(
        self,
        keys,
        prob: float = 0.1,
        range_x: float = 0.0,
        range_y: float = 0.0,
        range_z: float = 0.0,
        label_keys: Sequence[str] = ("label",),
    ):
        super().__init__(keys, prob)
        self.ranges = {0: range_x, 1: range_y, 2: range_z}
        self.label_keys = set(label_keys)

    def __call__(self, sample: Sample, rng: np.random.Generator) -> Sample:
        if not self.should_apply(rng):
            return sample
        out = dict(sample)
        angles = {
            ax: float(rng.uniform(-r, r)) for ax, r in self.ranges.items() if r > 0
        }
        for key in self.present_keys(sample):
            vol: Volume = sample[key]
            order = 0 if key in self.label_keys else 1
            for ax, ang in angles.items():
                vol = rotate_volume(vol, ax, ang, order)
            out[key] = vol
        return out


class RandZoomd(RandMapTransform):
    """Random isotropic zoom ~ U(min_zoom, max_zoom), keep_size."""

    def __init__(
        self,
        keys,
        prob: float = 0.1,
        min_zoom: float = 0.9,
        max_zoom: float = 1.1,
        label_keys: Sequence[str] = ("label",),
    ):
        super().__init__(keys, prob)
        self.min_zoom = min_zoom
        self.max_zoom = max_zoom
        self.label_keys = set(label_keys)

    def __call__(self, sample: Sample, rng: np.random.Generator) -> Sample:
        if not self.should_apply(rng):
            return sample
        factor = float(rng.uniform(self.min_zoom, self.max_zoom))
        out = dict(sample)
        for key in self.present_keys(sample):
            vol: Volume = sample[key]
            order = 0 if key in self.label_keys else 1
            out[key] = zoom_volume(vol, [factor] * vol.ndim_spatial, order)
        return out
