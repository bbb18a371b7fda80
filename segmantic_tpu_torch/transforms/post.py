"""Post-processing dict-transforms of the serving path (host numpy).

Port of ``segmantic_tpu/transforms/post.py`` (``AsDiscreted``, ``Invertd``,
``SaveImaged``): argmax over channels, inversion of the deterministic
preprocessing by replaying its applied-ops log backwards (spacing, crop, pad,
orientation), and NIfTI output. The ensemble combiners are not ported yet.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import numpy as np

from segmantic_tpu.core.orientation import inverse_orientation_op, invert_orientation
from segmantic_tpu.core.volume import Volume
from segmantic_tpu.io.nifti import write_volume

from ..ops.resample import grid_matrix, resample_affine_np
from .base import MapTransform, Sample


class AsDiscreted(MapTransform):
    """Argmax over the channel axis and/or one-hot encode."""

    def __init__(self, keys, argmax: bool = True, to_onehot: Optional[int] = None):
        super().__init__(keys)
        self.argmax = argmax
        self.to_onehot = to_onehot

    def __call__(self, sample: Sample) -> Sample:
        out = dict(sample)
        for key in self.present_keys(sample):
            vol: Volume = sample[key]
            data = vol.numpy()
            if self.argmax and data.shape[0] > 1:
                data = np.argmax(data, axis=0, keepdims=True)
            if self.to_onehot:
                lab = data[0].astype(np.int64)
                data = np.stack(
                    [(lab == c) for c in range(self.to_onehot)]
                ).astype(np.float32)
            out[key] = vol.with_data(data)
        return out


class Invertd(MapTransform):
    """Undo the deterministic preprocessing prefix on predictions.

    Replays the ``applied_ops`` log of ``ref_key`` (the preprocessed input
    volume) backwards onto each ``keys`` volume: spacing-resample back to the
    original grid, un-crop, un-pad, and un-orient. ``nearest`` controls the
    interpolation used for the inverse resample (label maps → nearest).
    """

    def __init__(self, keys, ref_key: str = "image", nearest: bool = True):
        super().__init__(keys)
        self.ref_key = ref_key
        self.nearest = nearest

    def __call__(self, sample: Sample) -> Sample:
        out = dict(sample)
        ref: Volume = sample[self.ref_key]
        for key in self.present_keys(sample):
            vol: Volume = sample[key]
            data = vol.numpy()
            affine = vol.affine.copy()
            for op in reversed(ref.applied_ops):
                data, affine = self._invert_op(op, data, affine)
            inv = vol.with_data(data, affine)
            inv.applied_ops = []
            out[key] = inv
        return out

    def _invert_op(self, op: Dict, data: np.ndarray, affine: np.ndarray):
        kind = op["op"]
        nd = data.ndim - 1
        if kind == "orientation":
            if "perm" in op:  # exact inverse from the recorded ops
                return invert_orientation(
                    data, op["perm"], op["flips"], op["pre_affine"]
                )
            return inverse_orientation_op(
                data, affine, op["pre_affine"], op.get("axcodes", "RAS")
            )
        if kind == "spacing":
            pre_affine = np.asarray(op["pre_affine"])
            pre_shape = tuple(op["pre_shape"])
            m = grid_matrix(affine, pre_affine, nd)
            order = 0 if self.nearest else 1
            return (
                resample_affine_np(data, m, pre_shape, order=order),
                pre_affine.copy(),
            )
        if kind == "crop":
            pre_shape = tuple(op["pre_shape"])
            start = op["start"]
            full = np.zeros(data.shape[:1] + pre_shape, dtype=data.dtype)
            sl = [slice(None)] + [
                slice(s, s + e) for s, e in zip(start, data.shape[1:])
            ]
            full[tuple(sl)] = data
            return full, np.asarray(op["pre_affine"]).copy()
        if kind == "pad":
            pre_shape = tuple(op["pre_shape"])
            delta = [max(c - p, 0) for c, p in zip(data.shape[1:], pre_shape)]
            lo = [(d + 1) // 2 for d in delta]
            sl = [slice(None)] + [
                slice(l, l + p) for l, p in zip(lo, pre_shape)
            ]
            return (
                np.ascontiguousarray(data[tuple(sl)]),
                np.asarray(op["pre_affine"]).copy(),
            )
        raise ValueError(f"unknown applied op {kind!r}")


class SaveImaged(MapTransform):
    """Write volumes as NIfTI: ``output_dir/<stem><suffix>.nii.gz``; the stem
    comes from the volume's source filename metadata."""

    def __init__(
        self,
        keys,
        output_dir: Path,
        output_postfix: str = "seg",
        ref_key: Optional[str] = None,
        dtype=np.uint16,
    ):
        super().__init__(keys)
        self.output_dir = Path(output_dir)
        self.output_postfix = output_postfix
        self.ref_key = ref_key
        self.dtype = dtype

    def __call__(self, sample: Sample) -> Sample:
        self.output_dir.mkdir(parents=True, exist_ok=True)
        for key in self.present_keys(sample):
            vol: Volume = sample[key]
            src = vol.meta.get("filename")
            if src is None and self.ref_key and self.ref_key in sample:
                src = sample[self.ref_key].meta.get("filename")
            stem = Path(src).name if src else key
            for ext in (".nii.gz", ".nii"):
                if stem.endswith(ext):
                    stem = stem[: -len(ext)]
            name = f"{stem}_{self.output_postfix}.nii.gz" if self.output_postfix else f"{stem}.nii.gz"
            out_vol = vol.with_data(vol.numpy().astype(self.dtype))
            write_volume(self.output_dir / name, out_vol)
            vol.meta["saved_to"] = str(self.output_dir / name)
        return sample
