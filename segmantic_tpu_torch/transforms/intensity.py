"""Intensity dict-transforms (host path) + Nyul histogram standardization.

Port of ``segmantic_tpu/transforms/intensity.py``: the random intensity
transforms draw their parameters from the ``numpy.random.Generator`` they are
called with (``should_apply`` first, then the parameters, per key, in the JAX
package's order) and run the shared math of :mod:`.intensity_ops` on the
volume as a one-sample CPU tensor; ``ScaleIntensityd``, ``interp1d`` and
``NyulNormalize``'s host path are the same numpy code. ``interp1d_device``
and ``nyul_apply_device`` are the torch twins of the JAX package's jittable
functions and run on the device of the tensor they are given.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..core.volume import Volume
from .base import MapTransform, RandMapTransform, Sample
from . import intensity_ops as ops


def _apply(vol: Volume, fn, *args) -> Volume:
    """``fn`` of :mod:`.intensity_ops` on one channel-first volume: the ops
    take (S, C, *spatial) and one parameter set per sample, so the volume goes
    in as the only sample and ``args`` carry a leading axis of 1."""
    x = torch.from_numpy(np.ascontiguousarray(vol.numpy().astype(np.float32)))
    return vol.with_data(fn(x[None], *args)[0].numpy())


class RandAdjustContrastd(RandMapTransform):
    def __init__(self, keys, prob: float = 0.1, gamma=(0.5, 4.5)):
        super().__init__(keys, prob)
        self.gamma = gamma if isinstance(gamma, (tuple, list)) else (0.5, gamma)

    def __call__(self, sample: Sample, rng: np.random.Generator) -> Sample:
        if not self.should_apply(rng):
            return sample
        g = np.float32(rng.uniform(*self.gamma))
        out = dict(sample)
        for key in self.present_keys(sample):
            out[key] = _apply(sample[key], ops.adjust_contrast, [g])
        return out


class RandHistogramShiftd(RandMapTransform):
    def __init__(self, keys, prob: float = 0.1, num_control_points: int = 10):
        super().__init__(keys, prob)
        self.num_control_points = num_control_points

    def __call__(self, sample: Sample, rng: np.random.Generator) -> Sample:
        if not self.should_apply(rng):
            return sample
        out = dict(sample)
        n = self.num_control_points
        for key in self.present_keys(sample):
            vol: Volume = sample[key]
            data = vol.numpy().astype(np.float32)
            mn, mx = float(data.min()), float(data.max())
            src = np.linspace(0.0, 1.0, n)
            interval = 1.0 / (n - 1)
            noise = rng.uniform(-0.45 * interval, 0.45 * interval, n)
            noise[0] = noise[-1] = 0.0
            dst = np.sort(src + noise)
            scale = mx - mn
            out[key] = _apply(
                vol,
                ops.histogram_shift,
                (src * scale + mn).astype(np.float32)[None],
                (dst * scale + mn).astype(np.float32)[None],
            )
        return out


class RandBiasFieldd(RandMapTransform):
    def __init__(self, keys, prob: float = 0.1, degree: int = 3, coeff_range=(0.0, 0.1)):
        super().__init__(keys, prob)
        self.degree = degree
        self.coeff_range = coeff_range

    def __call__(self, sample: Sample, rng: np.random.Generator) -> Sample:
        if not self.should_apply(rng):
            return sample
        out = dict(sample)
        for key in self.present_keys(sample):
            vol: Volume = sample[key]
            n = ops.num_bias_coeff(vol.ndim_spatial, self.degree)
            coeff = rng.uniform(*self.coeff_range, n).astype(np.float32)
            out[key] = _apply(vol, lambda x, c: ops.bias_field(x, c, self.degree),
                              coeff[None])
        return out


class RandGibbsNoised(RandMapTransform):
    def __init__(self, keys, prob: float = 0.1, alpha=(0.0, 1.0)):
        super().__init__(keys, prob)
        self.alpha = alpha

    def __call__(self, sample: Sample, rng: np.random.Generator) -> Sample:
        if not self.should_apply(rng):
            return sample
        a = np.float32(rng.uniform(*self.alpha))
        out = dict(sample)
        for key in self.present_keys(sample):
            out[key] = _apply(sample[key], ops.gibbs_noise, [a])
        return out


class RandKSpaceSpikeNoised(RandMapTransform):
    def __init__(self, keys, prob: float = 0.1, intensity_range=(0.95, 1.10)):
        super().__init__(keys, prob)
        self.intensity_range = intensity_range

    def __call__(self, sample: Sample, rng: np.random.Generator) -> Sample:
        if not self.should_apply(rng):
            return sample
        out = dict(sample)
        for key in self.present_keys(sample):
            vol: Volume = sample[key]
            nd = vol.ndim_spatial
            # spike location in the mid-frequency band, away from DC
            loc = rng.uniform(0.55, 0.95, nd).astype(np.float32)
            inten = np.float32(rng.uniform(*self.intensity_range))
            out[key] = _apply(vol, ops.kspace_spike, loc[None], [inten])
        return out


class ScaleIntensityd(MapTransform):
    """Min-max scale to [minv, maxv]."""

    def __init__(self, keys, minv: float = 0.0, maxv: float = 1.0):
        super().__init__(keys)
        self.minv, self.maxv = minv, maxv

    def __call__(self, sample: Sample) -> Sample:
        out = dict(sample)
        for key in self.present_keys(sample):
            vol: Volume = sample[key]
            data = vol.numpy().astype(np.float32)
            mn, mx = data.min(), data.max()
            if mx > mn:
                data = (data - mn) / (mx - mn) * (self.maxv - self.minv) + self.minv
            out[key] = vol.with_data(data)
        return out


# ---------------------------------------------------------------------------
# Nyul piecewise-linear histogram standardization
# ---------------------------------------------------------------------------


def interp1d(x: np.ndarray, xp: np.ndarray, fp: np.ndarray) -> np.ndarray:
    """Linear interpolation with linear *extrapolation* beyond the ends
    (np.interp clamps; Nyul standardization requires extrapolation —
    reference: src/segmantic/seg/nyul_normalize.py:10-40)."""
    x = np.asarray(x, np.float32)
    xp = np.asarray(xp, np.float64)
    fp = np.asarray(fp, np.float64)
    slopes = np.diff(fp) / np.maximum(np.diff(xp), 1e-12)
    idx = np.clip(np.searchsorted(xp, x, side="right") - 1, 0, len(xp) - 2)
    return (fp[idx] + slopes[idx] * (x - xp[idx])).astype(np.float32)


def _quantiles(values: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Quantiles ``q`` of the 1-D ``values`` from a sort, linearly
    interpolated between the two nearest order statistics (numpy's and
    ``jnp.quantile``'s default); ``torch.quantile`` refuses more than 2^24
    elements, a sort does not."""
    ordered = torch.sort(values).values
    pos = q.to(torch.float64) * (ordered.numel() - 1)
    lo = pos.floor().long().clamp(0, ordered.numel() - 1)
    hi = (lo + 1).clamp_max(ordered.numel() - 1)
    frac = (pos - lo).to(ordered.dtype)
    return ordered[lo] + (ordered[hi] - ordered[lo]) * frac


def interp1d_device(x: torch.Tensor, xp, fp) -> torch.Tensor:
    """Torch twin of :func:`interp1d` on x's device, in f32: piecewise-linear
    interpolation with linear extrapolation beyond the landmark range."""
    x = x.to(torch.float32)
    xp = torch.as_tensor(xp, device=x.device).to(torch.float32).contiguous()
    fp = torch.as_tensor(fp, device=x.device).to(torch.float32)
    slopes = torch.diff(fp) / torch.diff(xp).clamp_min(1e-12)
    idx = (torch.searchsorted(xp, x.contiguous(), right=True) - 1).clamp(0, xp.shape[0] - 2)
    return fp[idx] + slopes[idx] * (x - xp[idx])


def nyul_apply_device(data: torch.Tensor, quantiles, standard_scale,
                      nonzero_mask: bool = False) -> torch.Tensor:
    """Nyul standardization of one volume on its device given a fitted scale.

    Landmarks are the quantiles of the volume (of its nonzero voxels when
    ``nonzero_mask``; of all voxels again when there is none) and the volume is
    remapped with extrapolating interpolation; masked-out voxels stay zero."""
    data = data.to(torch.float32)
    q = torch.as_tensor(np.asarray(quantiles), device=data.device)
    flat = data.reshape(-1)
    sel = flat[flat != 0] if nonzero_mask else flat
    if sel.numel() == 0:  # all-zero volume: plain quantiles, no NaN landmarks
        sel = flat
    landmarks = _quantiles(sel, q)
    out = interp1d_device(flat, landmarks, np.asarray(standard_scale)).reshape(data.shape)
    if nonzero_mask:
        out = torch.where(data != 0, out, data)
    return out


class NyulNormalize(MapTransform):
    """Piecewise-linear intensity standardization to a learned standard scale.

    ``fit()`` over a set of volumes learns mean quantile landmarks; __call__
    maps each volume's landmarks onto the standard scale (with linear
    extrapolation outside), optionally over the nonzero mask / per channel.
    Tensors take :meth:`normalize_device` (:func:`nyul_apply_device`).
    """

    def __init__(
        self,
        keys="image",
        quantiles: Optional[Sequence[float]] = None,
        standard_scale: Optional[Sequence[float]] = None,
        nonzero_mask: bool = False,
        channel_wise: bool = False,
    ):
        super().__init__(keys)
        q = np.asarray(
            quantiles if quantiles is not None else np.linspace(0.01, 0.99, 11)
        )
        order = np.argsort(q, kind="stable")
        self.quantiles = q[order]
        self.standard_scale: Optional[np.ndarray] = (
            np.asarray(standard_scale, np.float64)[order]
            if standard_scale is not None
            else None
        )
        self.nonzero_mask = nonzero_mask
        self.channel_wise = channel_wise

    def _landmarks(self, data: np.ndarray) -> np.ndarray:
        sel = data[data != 0] if self.nonzero_mask else data.ravel()
        if sel.size == 0:
            sel = data.ravel()
        return np.quantile(sel, self.quantiles)

    def fit(self, volumes: Sequence[Volume]) -> "NyulNormalize":
        marks = [self._landmarks(v.numpy().astype(np.float32)) for v in volumes]
        self.standard_scale = np.mean(np.stack(marks), axis=0)
        return self

    def normalize_device(self, data):
        """Standardization of one tensor on its own device."""
        if self.standard_scale is None:
            raise RuntimeError("NyulNormalize.fit() must be called before use")
        return nyul_apply_device(
            data, self.quantiles, self.standard_scale, self.nonzero_mask
        )

    def _normalize_array(self, data: np.ndarray) -> np.ndarray:
        if self.standard_scale is None:
            raise RuntimeError("NyulNormalize.fit() must be called before use")
        landmarks = self._landmarks(data)
        out = interp1d(data.ravel(), landmarks, self.standard_scale).reshape(data.shape)
        if self.nonzero_mask:
            out = np.where(data != 0, out, data)
        return out

    def __call__(self, sample: Sample) -> Sample:
        out = dict(sample)
        for key in self.present_keys(sample):
            vol: Volume = sample[key]
            data = vol.numpy().astype(np.float32)
            if self.channel_wise:
                data = np.stack([self._normalize_array(c) for c in data])
            else:
                data = self._normalize_array(data)
            out[key] = vol.with_data(data)
        return out
