"""Batched training augmentation on the device (the training hot path).

Port of ``segmantic_tpu/train/augment.py``: the patch sampler crops margin
patches and this module applies, on the batch, the shear-decomposed rotation +
zoom (``ops/shear_resample.py``; on the card one hand-written kernel per
rotation group, ``ops/fused_shear.py``) followed by a center crop, the
per-sample intensity ops (gamma contrast, histogram shift, polynomial bias
field), per-axis flips, and Gibbs ringing / k-space spikes on exact-count
random subsets of the batch.

Drawing and applying are apart. :func:`draw_params` draws every random
parameter of one step from an explicit ``torch.Generator`` into an
:class:`AugmentParams` of plain numpy arrays; :func:`apply_params` applies a
given set. ``jax.random`` and ``torch.Generator`` give different numbers from
one seed, so the two packages are compared by handing both the same
parameters. :func:`augment_batch` is the two together.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.fused_conv import at_least_f32
from ..ops.shear_resample import (  # noqa: F401  (rotation_matrix: as the JAX module)
    center_crop, rotate_zoom_nn_gather, rotate_zoom_shear, rotation_matrix,
)
from ..transforms import intensity_ops as iops

__all__ = ["AugmentConfig", "AugmentParams", "draw_params", "apply_params",
           "augment_batch"]


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    """Static augmentation configuration: the JAX package's fields and
    defaults."""

    spatial: bool = False
    intensity: bool = False
    flip_prob: float = 0.2
    rotate_prob: float = 0.2
    rotate_range: float = 0.4
    zoom_prob: float = 0.2
    zoom_range: Tuple[float, float] = (0.8, 1.3)
    contrast_prob: float = 0.2
    contrast_gamma: Tuple[float, float] = (0.5, 4.5)
    hist_shift_prob: float = 0.2
    hist_control_points: int = 10
    bias_prob: float = 0.2
    bias_degree: int = 3
    bias_coeff_range: Tuple[float, float] = (0.0, 0.1)
    gibbs_prob: float = 0.2
    gibbs_alpha: Tuple[float, float] = (0.0, 1.0)
    spike_prob: float = 0.2
    spike_intensity: Tuple[float, float] = (0.95, 1.10)
    # round the image's interpolation weights and samples to bf16 (products
    # summed in f32). The trainer couples this to mixed_precision: when the
    # step computes in bf16, the weight noise is below the cast that follows.
    # Labels are unaffected (their copies are exact either way).
    interp_bf16: bool = True
    # resample the labels with one composed-affine nearest-neighbour gather
    # (ops.shear_resample.rotate_zoom_nn_gather: rounds once, the ideal
    # rotate + zoom of a label map) instead of the shear chain, which rounds
    # after every pass; they differ only at boundary voxels where the two
    # roundings disagree. Opt-in, as in the JAX package (where the gather
    # measured far slower than the chain on its TPU); with it on, the labels
    # launch no shear-group kernel.
    label_affine_gather: bool = False
    # run the rotation + zoom chain on an exact-count random subset of the
    # batch (count = round(P[any rotation or zoom] * B)), whose members draw
    # their parameters conditioned on being active, instead of on every
    # sample with independent gates (most of which draw the identity).
    spatial_subset: bool = True


@dataclasses.dataclass
class AugmentParams:
    """Every random parameter of one step, as plain numpy arrays. Samples are
    named by their index in the batch; a ``*_index`` array lists the samples
    an augmentation applies to, row ``i`` of its parameters going to sample
    ``*_index[i]``. Fields of augmentations that are off are ``None``."""

    flips: np.ndarray  # (B, nd) bool
    spatial_index: Optional[np.ndarray] = None  # (n,) int
    angles: Optional[np.ndarray] = None  # (n, n_rot) f32, 0 where a rotation is off
    zoom: Optional[np.ndarray] = None  # (n,) f32, 1 where the zoom is off
    contrast_gate: Optional[np.ndarray] = None  # (B,) bool
    contrast_gamma: Optional[np.ndarray] = None  # (B,) f32
    hist_gate: Optional[np.ndarray] = None  # (B,) bool
    hist_noise: Optional[np.ndarray] = None  # (B, control points) f32
    bias_gate: Optional[np.ndarray] = None  # (B,) bool
    bias_coeff: Optional[np.ndarray] = None  # (B, monomials) f32
    gibbs_index: Optional[np.ndarray] = None  # (n_gibbs,) int
    gibbs_alpha: Optional[np.ndarray] = None  # (n_gibbs,) f32
    spike_index: Optional[np.ndarray] = None  # (n_spike,) int
    spike_loc: Optional[np.ndarray] = None  # (n_spike, nd) f32
    spike_intensity: Optional[np.ndarray] = None  # (n_spike,) f32


def _subset_count(prob: float, batch: int) -> int:
    return int(round(prob * batch))


def _spatial_pattern_table(cfg: AugmentConfig, n_rot: int):
    """The active (rotation-axis mask, zoom) patterns and the CDF of their
    probabilities conditioned on at least one being active. Bit k (< n_rot) =
    rotate axis k; bit n_rot = zoom."""
    pr, pz = cfg.rotate_prob, cfg.zoom_prob
    pats, probs = [], []
    for bits in range(1, 2 ** (n_rot + 1)):
        rot_bits = [(bits >> a) & 1 for a in range(n_rot)]
        z_bit = (bits >> n_rot) & 1
        p = float(np.prod([pr if b else 1 - pr for b in rot_bits]))
        p *= pz if z_bit else 1 - pz
        pats.append(rot_bits + [z_bit])
        probs.append(p)
    probs = np.asarray(probs, np.float64)
    cdf = np.cumsum(probs / probs.sum())[:-1]
    return np.asarray(pats, np.float32), cdf.astype(np.float32)


def _uniform(generator, shape, lo: float, hi: float) -> np.ndarray:
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    return (u * (hi - lo) + lo).numpy()


def _gate(generator, batch: int, prob: float) -> np.ndarray:
    return (torch.rand((batch,), generator=generator) < prob).numpy()


def _subset(generator, batch: int, count: int) -> np.ndarray:
    """``count`` distinct samples of the batch, uniformly at random."""
    return torch.randperm(batch, generator=generator)[:count].numpy()


def draw_params(generator: Optional[torch.Generator], cfg: AugmentConfig, batch: int,
                nd: int) -> AugmentParams:
    """Draw one step's parameters for a batch of ``batch`` ``nd``-dimensional
    samples from ``generator`` (on the CPU). Only what ``cfg`` turns on is
    drawn, the flips first."""
    params = AugmentParams(
        flips=(torch.rand((batch, nd), generator=generator) < cfg.flip_prob).numpy())
    n_rot = 3 if nd == 3 else 1
    if cfg.spatial:
        lo, hi = cfg.zoom_range
        if cfg.spatial_subset and batch > 1:
            p_any = 1.0 - (1.0 - cfg.rotate_prob) ** n_rot * (1.0 - cfg.zoom_prob)
            count = _subset_count(p_any, batch)
            params.spatial_index = _subset(generator, batch, count)
            # (angles, zoom) given at least one is active: inverse CDF over the
            # table of active patterns, then uniform magnitudes for its bits
            pats, cdf = _spatial_pattern_table(cfg, n_rot)
            u = _uniform(generator, (count,), 0.0, 1.0)
            bits = pats[(u[:, None] >= cdf[None, :]).sum(1)]
            rot_on, zoom_on = bits[:, :n_rot] > 0, bits[:, n_rot] > 0
        else:  # every sample, independent gates
            count = batch
            params.spatial_index = np.arange(batch)
            rot_on = _uniform(generator, (count, n_rot), 0.0, 1.0) < cfg.rotate_prob
            zoom_on = _uniform(generator, (count,), 0.0, 1.0) < cfg.zoom_prob
        angles = _uniform(generator, (count, n_rot), -cfg.rotate_range, cfg.rotate_range)
        params.angles = np.where(rot_on, angles, np.float32(0.0))
        params.zoom = np.where(zoom_on, _uniform(generator, (count,), lo, hi),
                               np.float32(1.0))
    if cfg.intensity:
        params.contrast_gate = _gate(generator, batch, cfg.contrast_prob)
        params.contrast_gamma = _uniform(generator, (batch,), *cfg.contrast_gamma)
        params.hist_gate = _gate(generator, batch, cfg.hist_shift_prob)
        spread = 0.45 / (cfg.hist_control_points - 1)
        params.hist_noise = _uniform(generator, (batch, cfg.hist_control_points),
                                     -spread, spread)
        params.bias_gate = _gate(generator, batch, cfg.bias_prob)
        params.bias_coeff = _uniform(
            generator, (batch, iops.num_bias_coeff(nd, cfg.bias_degree)),
            *cfg.bias_coeff_range)
        n_gibbs = _subset_count(cfg.gibbs_prob, batch)
        params.gibbs_index = _subset(generator, batch, n_gibbs)
        params.gibbs_alpha = _uniform(generator, (n_gibbs,), *cfg.gibbs_alpha)
        n_spike = _subset_count(cfg.spike_prob, batch)
        params.spike_index = _subset(generator, batch, n_spike)
        params.spike_loc = _uniform(generator, (n_spike, nd), 0.55, 0.95)
        params.spike_intensity = _uniform(generator, (n_spike,), *cfg.spike_intensity)
    return params


def _index(idx: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(idx, np.int64), device=device)


def _spatial(images, labels, params: AugmentParams, cfg: AugmentConfig, out_shape):
    """Rotation + zoom of the samples in ``spatial_index`` (one batched call
    of the shear chain for the images, one for the labels or, with
    ``label_affine_gather``, one composed-affine gather), the static center
    crop for the rest. ``images`` (B, C, *margin), ``labels`` (B, 1, *margin);
    the results are new tensors."""
    out_i = center_crop(images, out_shape).clone(memory_format=torch.contiguous_format)
    out_l = center_crop(labels, out_shape).clone(memory_format=torch.contiguous_format)
    if params.spatial_index is None or len(params.spatial_index) == 0:
        return out_i, out_l
    idx = _index(params.spatial_index, images.device)
    angles = torch.as_tensor(params.angles, dtype=torch.float32, device=images.device)
    zoom = torch.as_tensor(params.zoom, dtype=torch.float32, device=images.device)
    bounds = dict(out_shape=out_shape, angle_max=cfg.rotate_range,
                  zoom_min=min(cfg.zoom_range[0], 1.0))
    aug_i = rotate_zoom_shear(images[idx], angles, zoom, order=1, bf16=cfg.interp_bf16,
                              **bounds)
    if cfg.label_affine_gather:
        aug_l = rotate_zoom_nn_gather(labels[idx], params.angles, params.zoom, out_shape)
    else:
        aug_l = rotate_zoom_shear(labels[idx], angles, zoom, order=0, **bounds)
    out_i[idx] = center_crop(aug_i, out_shape)
    out_l[idx] = center_crop(aug_l, out_shape)
    return out_i, out_l


def _on_samples(images, selected: np.ndarray, fn):
    """``fn`` on the samples ``selected`` lists (its parameters row by row)."""
    if len(selected) == 0:
        return images
    idx = _index(selected, images.device)
    images[idx] = fn(images[idx])
    return images


def _hist_shift(x: torch.Tensor, noise: np.ndarray) -> torch.Tensor:
    dims = tuple(range(1, x.ndim))
    xf = at_least_f32(x)
    src, dst = iops.random_control_points(
        torch.as_tensor(noise, device=x.device).to(xf.dtype), xf.amin(dims), xf.amax(dims))
    return iops.histogram_shift(x, src, dst)


def apply_params(
    images: torch.Tensor,  # (B, *margin_shape, C) channel-last
    labels: torch.Tensor,  # (B, *margin_shape) int
    params: AugmentParams,
    cfg: AugmentConfig,
    out_shape: Sequence[int],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply one step's parameters: margin patches in, (B, *out_shape, C)
    images and (B, *out_shape) labels out, in the JAX package's order
    (rotation + zoom and center crop; contrast, histogram shift, bias field;
    flips; Gibbs; spike). The inputs are not modified."""
    out_shape = tuple(int(s) for s in out_shape)
    img = images.movedim(-1, 1)  # (B, C, *spatial)
    lbl = labels[:, None]
    if lbl.dtype.is_floating_point:
        lbl = lbl.to(torch.int32)
    img, lbl = _spatial(img, lbl, params, cfg, out_shape)

    if cfg.intensity:
        sel = np.flatnonzero(params.contrast_gate)
        img = _on_samples(img, sel, lambda x: iops.adjust_contrast(
            x, params.contrast_gamma[sel]))
        sel = np.flatnonzero(params.hist_gate)
        img = _on_samples(img, sel, lambda x: _hist_shift(x, params.hist_noise[sel]))
        sel = np.flatnonzero(params.bias_gate)
        img = _on_samples(img, sel, lambda x: iops.bias_field(
            x, params.bias_coeff[sel], cfg.bias_degree))

    for b in np.flatnonzero(params.flips.any(1)):
        img[b] = iops.flip(img[b], params.flips[b])
        lbl[b] = iops.flip(lbl[b], params.flips[b])

    if cfg.intensity:
        # the FFT-heavy ops run on exact-count subsets: per-sample probability
        # count / B per step at count / B of the work
        img = _on_samples(img, params.gibbs_index, lambda x: iops.gibbs_noise(
            x, params.gibbs_alpha))
        img = _on_samples(img, params.spike_index, lambda x: iops.kspace_spike(
            x, params.spike_loc, params.spike_intensity))
    return img.movedim(1, -1), lbl[:, 0]


def augment_batch(
    images: torch.Tensor,  # (B, *margin_shape, C) channel-last
    labels: torch.Tensor,  # (B, *margin_shape) int
    generator: Optional[torch.Generator],
    cfg: AugmentConfig,
    out_shape: Optional[Sequence[int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Draw one step's parameters from ``generator`` (on the CPU) and apply
    them. ``out_shape`` defaults to the input's spatial shape (no margin)."""
    if out_shape is None:
        out_shape = labels.shape[1:]
    if (not cfg.spatial and not cfg.intensity and cfg.flip_prob <= 0
            and tuple(out_shape) == tuple(labels.shape[1:])):
        return images, labels  # nothing to draw, nothing to do
    params = draw_params(generator, cfg, images.shape[0], labels.ndim - 1)
    return apply_params(images, labels, params, cfg, out_shape)
