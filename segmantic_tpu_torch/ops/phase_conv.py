"""Phase-space stride-1 SAME 3^3 convolution (the decoder's phase stages)
and its gradients.

Port of ``segmantic_tpu/ops/phase_gemm.py`` (``phase_conv_gemm``: the
folded kernel for L = 64 and the direct kernel for L >= 128; the weight
gradient ``phase_conv_gemm_dw`` with its two kernels and ``_unfold_dw``; the
differentiable ``phase_conv``) and of ``fast_conv.phase_conv_s1`` that routes
to it. ``p`` is a phase-major tensor (B, D, H, W, 8*Ci) standing for the
full-resolution volume ``depth_to_space(p)``; the result is the phase-major
tensor of ``conv3_SAME(depth_to_space(p), w)``, optionally followed by the
same epilogue as :mod:`.fused_conv` (bias, folded-norm scale/shift,
activation).

``phase_conv`` launches ``csrc/phase_conv.cu`` and ``phase_conv_dw``
``csrc/phase_conv_dw.cu`` (one kernel each for every L) for CUDA tensors on
the body ``fused_conv.conv_body`` / ``dw_body`` names: the tensor-core body
for bf16 input with Ci % 8 == 0 (the weight gradient: and Co % 8 == 0; launch
plans ``fused_conv.plan`` / ``dw_plan``), the few-channel body for bf16 input
with Ci = 1..7 (packed UNETR's one-channel input layer; ``fused_conv.fewc_plan``
/ ``fewc_dw_plan`` with ``phase=True``), the register-tiled f32 body otherwise
(``fused_conv.f32_plan`` / ``f32_dw_plan`` at full resolution); CPU
tensors run :func:`phase_conv_plain` and :func:`phase_conv_dw_plain`.
:func:`phase_conv_grad` is the ``torch.autograd.Function`` over both.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _cuda
from .fast_conv import depth_to_space, phase_conv_s1_plain, tile_phase
from .fused_conv import (
    _epilogue_vectors, activation, at_least_f32, check_args, check_dw_args,
    conv3d_dw_plain, flip_io, launch_conv3, launch_conv3_dw,
)

__all__ = [
    "phase_conv", "phase_conv_plain", "phase_conv_dw", "phase_conv_dw_plain",
    "phase_conv_grad", "counter", "dw_counter",
]

counter = _cuda.LaunchCounter("phase_conv")
dw_counter = _cuda.LaunchCounter("phase_conv_dw")


def phase_conv_plain(p, w, bias=None, scale=None, shift=None, alpha=None,
                     relu_mode: str = "none", out_dtype=None) -> torch.Tensor:
    """Plain PyTorch version: the expanded kernel-3 conv over the phase
    tensor in p's dtype (7/8 of its weights are structural zeros), then the
    epilogue in f32 with per-true-channel vectors tiled over the 8 phases."""
    out_dtype = out_dtype or p.dtype
    y = at_least_f32(phase_conv_s1_plain(p, w))
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
    packed_cache: Optional[dict] = None,  # see fused_conv.launch_conv3
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
                 out, (b, 2 * d, 2 * h, 2 * wd), packed_cache)
    counter.count += 1
    return out


def phase_conv_dw_plain(p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the weight gradient: the dense dw (f32) of
    the full-resolution views ``depth_to_space(p)`` and ``depth_to_space(g)``."""
    ci, co = p.shape[-1] // 8, g.shape[-1] // 8
    return conv3d_dw_plain(depth_to_space(p, ci), depth_to_space(g, co))


def phase_conv_dw(p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """True-kernel weight gradient (3, 3, 3, Ci, Co) f32 of the phase conv:
    p (B, D, H, W, 8*Ci) its input, g (B, D, H, W, 8*Co) its output
    cotangent, both phase-major. Replaces kernels 5 and 6 and ``_unfold_dw``
    of the JAX package with one entry point for every L."""
    for t, name in ((p, "p"), (g, "g")):
        if t.ndim != 5 or t.shape[-1] % 8:
            raise ValueError(f"{name} must be (B, D, H, W, 8*C), got {tuple(t.shape)}")
    check_dw_args(p, g)
    if p.device.type == "cpu":
        return phase_conv_dw_plain(p, g)
    b, d, h, w, _ = p.shape
    out = launch_conv3_dw("segk_phase_conv3_dw", p, g, (b, 2 * d, 2 * h, 2 * w),
                          p.shape[-1] // 8, g.shape[-1] // 8)
    dw_counter.count += 1
    return out


class _PhaseConvGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, p, w):
        p, w = p.contiguous(), w.contiguous()
        ctx.save_for_backward(p, w)
        return phase_conv(p, w)

    @staticmethod
    def backward(ctx, g):
        p, w = ctx.saved_tensors
        g = g.contiguous()
        dp = dw = None
        if ctx.needs_input_grad[0]:
            dp = phase_conv(g, flip_io(w), out_dtype=p.dtype)
        if ctx.needs_input_grad[1]:
            dw = phase_conv_dw(p, g).to(w.dtype)
        return dp, dw


def phase_conv_grad(p: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Differentiable phase-space 3^3 SAME conv without epilogue (the port of
    ``phase_gemm.phase_conv``): p (B, D, H, W, 8*Ci), w (3, 3, 3, Ci, Co) in
    p's dtype; returns (B, D, H, W, 8*Co)."""
    return _PhaseConvGrad.apply(p, w)
