"""Batched training augmentation on the device.

Port of ``segmantic_tpu/train/augment.py`` for the default configuration
(``spatial=False``, ``intensity=False``): per-sample, per-axis random flips
with probability ``flip_prob``, drawn from an explicit ``torch.Generator``
(the JAX package draws from ``jax.random``; the two give different numbers
from the same seed). Without spatial augmentation the sampler's patches are
already the training patch (no margin to crop). The spatial (rotation +
zoom) and intensity augmentations are not ported yet and raise rather than
being skipped.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..transforms import intensity_ops as iops

__all__ = ["AugmentConfig", "augment_batch"]


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    """The acting fields of the JAX package's augmentation configuration
    (same names and defaults); the rotation, zoom and intensity parameters
    come with the spatial and intensity augmentation."""

    spatial: bool = False
    intensity: bool = False
    flip_prob: float = 0.2

    def check_ported(self) -> None:
        if self.spatial or self.intensity:
            raise NotImplementedError(
                "spatial and intensity augmentation are not ported yet (ROADMAP "
                "Queue 1: train/augment.py, ops/shear_resample.py, "
                "transforms/intensity_ops.py)"
            )


def augment_batch(
    images: torch.Tensor,  # (B, *spatial, C) channel-last
    labels: torch.Tensor,  # (B, *spatial) int
    generator: Optional[torch.Generator],
    cfg: AugmentConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sample, per-axis random flips of image and label together. The
    draws come from ``generator`` (on the CPU), one (B, nd) uniform draw per
    call."""
    cfg.check_ported()
    if cfg.flip_prob <= 0:
        return images, labels
    nd = labels.ndim - 1
    do_flip = (torch.rand((images.shape[0], nd), generator=generator)
               < cfg.flip_prob).tolist()
    out_i, out_l = [], []
    for b in range(images.shape[0]):
        # channel-last image: flip the same spatial axes as the label
        out_i.append(iops.flip(images[b].movedim(-1, 0), do_flip[b]).movedim(0, -1))
        out_l.append(iops.flip(labels[b][None], do_flip[b])[0])
    return torch.stack(out_i), torch.stack(out_l)
