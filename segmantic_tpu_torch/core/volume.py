"""The Volume container: array + affine + metadata.

The JAX-side replacement for MONAI's MetaTensor / SimpleITK's Image
(reference keeps geometry inside sitk.Image / MetaTensor; see
reference: src/segmantic/image/processing.py:20-46). Design differences,
chosen for XLA-friendliness:

- voxel data is a plain array of shape ``(C, *spatial)`` (channel-first,
  index order (i, j, k)); jitted kernels take/return raw arrays with static
  shapes — ``Volume`` itself never crosses the jit boundary.
- geometry is a single 4x4 float64 **affine** on the host (nibabel-style:
  voxel index -> physical RAS mm), from which spacing / direction / origin
  derive.
- ``applied_ops`` records the deterministic preprocessing log so inference
  can invert it (the reference gets this via MONAI's traced transforms; here
  the inverse-op log is explicit — SURVEY.md §7 "Invertd equivalent").
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


def _as_affine(affine: Optional[np.ndarray]) -> np.ndarray:
    if affine is None:
        return np.eye(4, dtype=np.float64)
    affine = np.asarray(affine, dtype=np.float64)
    if affine.shape != (4, 4):
        raise ValueError(f"affine must be 4x4, got {affine.shape}")
    return affine


def affine_from_spacing_origin(
    spacing: Tuple[float, ...],
    origin: Optional[Tuple[float, ...]] = None,
    direction: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Compose an affine from spacing / origin / direction (ITK-style triple)."""
    ndim = len(spacing)
    if origin is None:
        origin = (0.0,) * ndim
    aff = np.eye(4, dtype=np.float64)
    rot = np.eye(ndim) if direction is None else np.asarray(direction, dtype=np.float64)
    aff[:ndim, :ndim] = rot * np.asarray(spacing, dtype=np.float64)[None, :]
    aff[:ndim, 3] = np.asarray(origin, dtype=np.float64)
    return aff


@dataclasses.dataclass
class Volume:
    """A channel-first image volume with physical geometry.

    ``data``: array of shape (C, *spatial) — numpy on the host.
    ``affine``: 4x4 float64 voxel-index→physical(RAS) map for the *spatial*
    axes in index order (i, j, k).
    """

    data: Any
    affine: np.ndarray = None
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)
    applied_ops: List[Dict[str, Any]] = dataclasses.field(default_factory=list)

    def __post_init__(self) -> None:
        self.affine = _as_affine(self.affine)
        if self.data.ndim not in (3, 4):  # (C,H,W) | (C,D,H,W)
            raise ValueError(
                f"Volume data must be (C, *spatial) with 2 or 3 spatial dims, "
                f"got shape {self.data.shape}"
            )

    # -- geometry ---------------------------------------------------------
    @property
    def ndim_spatial(self) -> int:
        return self.data.ndim - 1

    @property
    def spatial_shape(self) -> Tuple[int, ...]:
        return tuple(self.data.shape[1:])

    @property
    def num_channels(self) -> int:
        return int(self.data.shape[0])

    @property
    def spacing(self) -> np.ndarray:
        d = self.ndim_spatial
        return np.linalg.norm(np.asarray(self.affine)[:3, :d], axis=0)[:d]

    @property
    def direction(self) -> np.ndarray:
        d = self.ndim_spatial
        rot = np.asarray(self.affine)[:d, :d]
        sp = self.spacing
        sp = np.where(sp == 0, 1.0, sp)
        return rot / sp[None, :]

    @property
    def origin(self) -> np.ndarray:
        d = self.ndim_spatial
        return np.asarray(self.affine)[:d, 3]

    # -- conversion helpers -------------------------------------------------
    def with_data(self, data: Any, affine: Optional[np.ndarray] = None) -> "Volume":
        """Copy of this volume with new data (and optionally new affine)."""
        return Volume(
            data=data,
            affine=self.affine if affine is None else affine,
            meta=dict(self.meta),
            applied_ops=list(self.applied_ops),
        )

    def numpy(self) -> np.ndarray:
        return np.asarray(self.data)

    @staticmethod
    def from_array(
        array: np.ndarray,
        affine: Optional[np.ndarray] = None,
        spacing: Optional[Tuple[float, ...]] = None,
        origin: Optional[Tuple[float, ...]] = None,
        channel_first: bool = False,
    ) -> "Volume":
        """Wrap a bare spatial array (adds the channel axis unless present)."""
        array = np.asarray(array)
        if not channel_first:
            array = array[None]
        if affine is None and spacing is not None:
            ndim = array.ndim - 1
            affine = affine_from_spacing_origin(
                tuple(spacing), tuple(origin) if origin else (0.0,) * ndim
            )
        return Volume(data=array, affine=affine)

    def voxel_to_physical(self, idx: np.ndarray) -> np.ndarray:
        """Map voxel indices (..., ndim) to physical coordinates."""
        idx = np.asarray(idx, dtype=np.float64)
        d = self.ndim_spatial
        hom = np.concatenate(
            [idx, np.zeros(idx.shape[:-1] + (3 - d,)), np.ones(idx.shape[:-1] + (1,))],
            axis=-1,
        )
        return (hom @ np.asarray(self.affine).T)[..., :3]

    def physical_to_voxel(self, pts: np.ndarray) -> np.ndarray:
        pts = np.asarray(pts, dtype=np.float64)
        inv = np.linalg.inv(np.asarray(self.affine))
        hom = np.concatenate([pts, np.ones(pts.shape[:-1] + (1,))], axis=-1)
        return (hom @ inv.T)[..., : self.ndim_spatial]
