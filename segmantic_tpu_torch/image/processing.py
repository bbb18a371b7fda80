"""Host-side geometric image processing on :class:`Volume`.

Port of ``segmantic_tpu/image/processing.py``, a numpy copy (API parity with
the reference's SimpleITK-based layer, reference:
src/segmantic/image/processing.py:10-156) on the shared affine resample
``ops.resample.resample_affine_np``. Like the JAX module, ``pad`` pads up to
the target centred (MONAI's SpatialPad, which the training path relies on),
where the reference's never pads an image smaller than the target.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..core.volume import Volume, affine_from_spacing_origin
from ..ops.resample import grid_matrix, output_affine_for_spacing, resample_affine_np

__all__ = ["make_image", "extract_slices", "resample", "apply_transform",
           "resample_to_ref", "pad", "crop_center", "crop"]


def make_image(
    shape: Sequence[int],
    spacing: Optional[Sequence[float]] = None,
    value: float = 0,
    dtype=np.uint8,
) -> Volume:
    """Create a (2D/3D) volume with given shape/spacing filled with ``value``."""
    if spacing is not None and len(shape) != len(spacing):
        raise ValueError("shape and spacing must have same dimension")
    data = np.full((1,) + tuple(shape), value, dtype=dtype)
    affine = affine_from_spacing_origin(
        tuple(spacing) if spacing else (1.0,) * len(shape)
    )
    return Volume(data=data, affine=affine)


def extract_slices(image: Volume, axis: int = 2) -> list:
    """Split a 3D volume into 2D slice volumes perpendicular to ``axis``."""
    if image.ndim_spatial != 3:
        raise ValueError("extract_slices expects a 3D volume")
    keep = [a for a in range(3) if a != axis]
    slices = []
    for k in range(image.spatial_shape[axis]):
        idx = [slice(None)] * 4
        idx[axis + 1] = k
        data = image.numpy()[tuple(idx)]
        aff = np.eye(4, dtype=np.float64)
        aff[:3, 0] = image.affine[:3, keep[0]]
        aff[:3, 1] = image.affine[:3, keep[1]]
        aff[:3, 3] = image.affine[:3, 3] + image.affine[:3, axis] * k
        slices.append(Volume(data=data, affine=aff))
    return slices


def resample(
    image: Volume, target_spacing: Sequence[float], nearest: bool = False
) -> Volume:
    """Resample a volume to a target spacing (ITK size convention:
    ``out = ceil(size * spacing / target)``; same origin/direction)."""
    nd = image.ndim_spatial
    out_affine, out_shape = output_affine_for_spacing(
        image.affine, image.spatial_shape, target_spacing[:nd]
    )
    m = grid_matrix(image.affine, out_affine, nd)
    data = resample_affine_np(
        image.numpy(), m, out_shape, order=0 if nearest else 1
    )
    return image.with_data(data, out_affine)


def apply_transform(
    moving_image: Volume,
    fixed_image: Volume,
    transform: Optional[np.ndarray],
    nearest: bool,
) -> Volume:
    """Resample ``moving_image`` onto ``fixed_image``'s grid.

    ``transform`` is a 4x4 physical-space map from fixed to moving (identity
    if None) — same convention as ITK's resample transform.
    """
    nd = fixed_image.ndim_spatial
    t = np.eye(4) if transform is None else np.asarray(transform, np.float64)
    # out index -> fixed phys -> (transform) -> moving phys -> moving index
    eff_out_affine = t @ fixed_image.affine
    m = grid_matrix(moving_image.affine, eff_out_affine, nd)
    data = resample_affine_np(
        moving_image.numpy(), m, fixed_image.spatial_shape, order=0 if nearest else 1
    )
    return moving_image.with_data(data, fixed_image.affine.copy())


def resample_to_ref(moving_image: Volume, fixed_image: Volume, nearest: bool) -> Volume:
    """Resample a volume onto a reference grid (identity physical transform)."""
    return apply_transform(moving_image, fixed_image, None, nearest)


def pad(image: Volume, target_size: Sequence[int], value: float = 0) -> Volume:
    """Center-pad a volume up to ``target_size`` (no-op along axes already
    at/above target)."""
    nd = image.ndim_spatial
    size = image.spatial_shape
    delta = [max(t - s, 0) for s, t in zip(size, target_size)]
    if not any(delta):
        return image
    pad_low = [(d + 1) // 2 for d in delta]
    pad_hi = [d - lo for d, lo in zip(delta, pad_low)]
    widths = [(0, 0)] + list(zip(pad_low, pad_hi))
    data = np.pad(image.numpy(), widths, constant_values=value)
    aff = image.affine.copy()
    aff[:3, 3] = aff[:3, 3] - aff[:3, :nd] @ np.asarray(pad_low, np.float64)
    return image.with_data(data, aff)


def crop_center(image: Volume, target_size: Sequence[int]) -> Volume:
    """Center-crop a volume down to ``target_size``."""
    size = image.spatial_shape
    delta = [max(s - t, 0) for s, t in zip(size, target_size)]
    if not any(delta):
        return image
    lo = [(d + 1) // 2 for d in delta]
    return crop(image, lo, [min(s, t) for s, t in zip(size, target_size)])


def crop(image: Volume, target_offset: Sequence[int], target_size: Sequence[int]) -> Volume:
    """Crop a volume at ``target_offset`` with ``target_size``."""
    nd = image.ndim_spatial
    sl = [slice(None)] + [
        slice(o, o + s) for o, s in zip(target_offset, target_size)
    ]
    data = np.ascontiguousarray(image.numpy()[tuple(sl)])
    aff = image.affine.copy()
    aff[:3, 3] = aff[:3, 3] + aff[:3, :nd] @ np.asarray(target_offset, np.float64)
    return image.with_data(data, aff)
