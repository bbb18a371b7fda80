"""Phase-space stride-1 SAME 3^3 convolution (the decoder's phase stages).

Port of the forward of ``segmantic_tpu/ops/phase_gemm.py``
(``phase_conv_gemm``: the folded kernel for L = 64 and the direct kernel for
L >= 128) and of ``fast_conv.phase_conv_s1`` that routes to it. ``p`` is a
phase-major tensor (B, D, H, W, 8*Ci) standing for the full-resolution volume
``depth_to_space(p)``; the result is the phase-major tensor of
``conv3_SAME(depth_to_space(p), w)``, optionally followed by the same
epilogue as :mod:`.fused_conv` (bias, folded-norm scale/shift, activation).

``phase_conv`` launches ``csrc/phase_conv.cu`` (one kernel for every L) for
CUDA tensors and runs :func:`phase_conv_plain` for CPU tensors.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _cuda
from .fast_conv import phase_conv_s1_plain, tile_phase
from .fused_conv import _epilogue_vectors, activation, check_args, launch_conv3

__all__ = ["phase_conv", "phase_conv_plain", "counter"]

counter = _cuda.LaunchCounter("phase_conv")


def phase_conv_plain(p, w, bias=None, scale=None, shift=None, alpha=None,
                     relu_mode: str = "none", out_dtype=None) -> torch.Tensor:
    """Plain PyTorch version: the expanded kernel-3 conv over the phase
    tensor in p's dtype (7/8 of its weights are structural zeros), then the
    epilogue in f32 with per-true-channel vectors tiled over the 8 phases."""
    out_dtype = out_dtype or p.dtype
    y = phase_conv_s1_plain(p, w).float()
    s, t = _epilogue_vectors(w.shape[-1], bias, scale, shift, p.device)
    y = y * tile_phase(s) + tile_phase(t)
    return activation(y, relu_mode, alpha).to(out_dtype)


def phase_conv(
    p: torch.Tensor,  # (B, D, H, W, 8*Ci) phase-major
    w: torch.Tensor,  # (3, 3, 3, Ci, Co) DHWIO
    bias: Optional[torch.Tensor] = None,  # (Co,) per true channel
    scale: Optional[torch.Tensor] = None,
    shift: Optional[torch.Tensor] = None,
    alpha: Optional[torch.Tensor] = None,
    relu_mode: str = "none",
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Phase-major (B, D, H, W, 8*Co) tensor of the 3^3 SAME conv of the
    volume ``p`` stands for, then ``(+ bias) * scale + shift`` and the
    activation; f32 accumulation over exactly the 27 true taps."""
    out_dtype = out_dtype or p.dtype
    if p.ndim != 5 or p.shape[-1] % 8:
        raise ValueError(f"p must be (B, D, H, W, 8*C), got {tuple(p.shape)}")
    ci = p.shape[-1] // 8
    co = w.shape[-1]
    check_args(p, w, relu_mode, alpha, out_dtype, (3, 3, 3, ci, co))
    if p.device.type == "cpu":
        return phase_conv_plain(p, w, bias, scale, shift, alpha, relu_mode, out_dtype)
    b, d, h, wd, _ = p.shape
    out = torch.empty((b, d, h, wd, 8 * co), dtype=out_dtype, device=p.device)
    launch_conv3("segk_phase_conv3", p, w, bias, scale, shift, alpha, relu_mode,
                 out, (b, 2 * d, 2 * h, 2 * wd))
    counter.count += 1
    return out
