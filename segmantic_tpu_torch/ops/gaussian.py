"""Separable Gaussian smoothing of a channel-first tensor.

Port of ``segmantic_tpu/ops/gaussian.py`` (XLA in the JAX package, no Pallas
kernel): used by the landmark heat-map transform
(``detect.transforms.VertHeatMap``; the reference runs MONAI's GaussianSmooth
with a hard-coded ``.cuda()``, reference:
src/segmantic/detect/transforms.py:278) and available as a general op.

Each axis is a truncated 1D kernel, ``radius = max(int(truncate * sigma +
0.5), 1)``, over zero-padded borders, applied as a sum of shifted slices in
plain PyTorch: one multiply and one add a tap, separate operations in a fixed
order, so the card and the CPU round alike (a cuDNN convolution would take
TF32 on the card unless told not to). The kernel is applied flipped, as
``jnp.convolve`` does, though it is symmetric.
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from ._cuda import resolve_device

__all__ = ["gaussian_smooth"]


def _kernel_1d(sigma: float, truncate: float = 4.0) -> np.ndarray:
    radius = max(int(truncate * sigma + 0.5), 1)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def gaussian_smooth(x, sigma: Union[float, Sequence[float]], truncate: float = 4.0,
                    device="cuda") -> torch.Tensor:
    """Gaussian-filter a (C, *spatial) tensor along every spatial axis
    (zero-padded borders, like MONAI's GaussianSmooth default); an axis with
    sigma <= 0 is left as it is. Computes in f32; a floating input keeps its
    dtype, any other comes out f32. A tensor is smoothed on its own device;
    any other input (a numpy array) is moved to ``device`` first, the card
    unless the CPU is asked for."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x), device=resolve_device(device))
    nd = x.ndim - 1
    sigmas = [float(sigma)] * nd if np.isscalar(sigma) else [float(s) for s in sigma]
    out = x.to(torch.float32)
    for axis in range(nd):
        if sigmas[axis] <= 0:
            continue
        k = _kernel_1d(sigmas[axis], truncate)[::-1]  # convolution flips the kernel
        pad = (len(k) - 1) // 2
        moved = out.movedim(axis + 1, -1)
        n = moved.shape[-1]
        padded = F.pad(moved, (pad, pad))
        acc = padded[..., 0:n] * float(k[0])
        for j in range(1, len(k)):
            acc = acc + padded[..., j:j + n] * float(k[j])
        out = acc.movedim(-1, axis + 1).contiguous()
    return out.to(x.dtype) if x.dtype.is_floating_point else out
