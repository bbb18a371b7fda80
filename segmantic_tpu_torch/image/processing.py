"""Host-side geometric image processing on :class:`Volume`.

Port of ``segmantic_tpu/image/processing.py``, so far only :func:`pad`, which
``transforms.spatial.SpatialPadd`` needs; the other functions of that module
(``make_image``, ``extract_slices``, ``resample``, ``apply_transform``,
``resample_to_ref``, ``crop``, ``crop_center``) are not ported yet.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..core.volume import Volume


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
