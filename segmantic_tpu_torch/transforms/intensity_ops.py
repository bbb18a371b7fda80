"""Intensity-augmentation math (single sample, channel-first).

Port of ``segmantic_tpu/transforms/intensity_ops.py``; so far only ``flip``,
the one op of the default training augmentation. Contrast, histogram shift,
bias field, Gibbs ringing and k-space spikes come with the augmentation
slice (ROADMAP Queue 1).
"""

from __future__ import annotations

from typing import Sequence

import torch

__all__ = ["flip"]


def flip(x: torch.Tensor, do_flip: Sequence[bool]) -> torch.Tensor:
    """Flip spatial axis ``a`` of a channel-first (C, *spatial) tensor where
    ``do_flip[a]`` is true."""
    dims = [a + 1 for a in range(x.ndim - 1) if bool(do_flip[a])]
    return x.flip(dims) if dims else x
