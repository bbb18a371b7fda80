"""Fused stride-1 SAME 3^3 convolution with the folded-norm epilogue.

Port of ``segmantic_tpu/ops/pallas_conv.py`` (``conv3d_pallas`` and the
kernel it launches, ``conv3d_packed_p``): the same function on plain
channel-last tensors, without the TPU's batch-into-lanes packing.

``conv3d`` launches the CUDA kernel ``csrc/fused_conv.cu`` for tensors on a
CUDA device and runs :func:`conv3d_plain`, the plain PyTorch version, for
tensors on the CPU.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import _cuda

__all__ = ["conv3d", "conv3d_plain", "counter", "RELU_MODES"]

RELU_MODES = {"none": 0, "relu": 1, "prelu": 2}
counter = _cuda.LaunchCounter("fused_conv")


def _epilogue_vectors(co: int, bias, scale, shift, device):
    """(conv + bias) * scale + shift == conv * scale + (bias * scale + shift)."""
    f32 = dict(dtype=torch.float32, device=device)
    s = torch.ones(co, **f32) if scale is None else scale.to(**f32).reshape(co)
    t = torch.zeros(co, **f32) if shift is None else shift.to(**f32).reshape(co)
    if bias is not None:
        t = bias.to(**f32).reshape(co) * s + t
    return s.contiguous(), t.contiguous()


def activation(y: torch.Tensor, relu_mode: str, alpha) -> torch.Tensor:
    if relu_mode == "prelu":
        return torch.where(y >= 0, y, alpha.to(y.dtype).reshape(()) * y)
    if relu_mode == "relu":
        return torch.clamp_min(y, 0)
    return y


def conv3d_plain(x, weights, bias=None, scale=None, shift=None, alpha=None,
                 relu_mode: str = "none", out_dtype=None) -> torch.Tensor:
    """Plain PyTorch version: ``F.conv3d`` in x's dtype, then the same
    epilogue as the kernel in f32.

    x (B, D, H, W, C); weights (3, 3, 3, C, CO) DHWIO; returns (B, D, H, W, CO)
    in ``out_dtype`` (default: x's dtype)."""
    out_dtype = out_dtype or x.dtype
    co = weights.shape[-1]
    y = F.conv3d(
        x.permute(0, 4, 1, 2, 3), weights.permute(4, 3, 0, 1, 2), padding=1,
    ).permute(0, 2, 3, 4, 1).float()
    s, t = _epilogue_vectors(co, bias, scale, shift, x.device)
    y = y * s + t
    return activation(y, relu_mode, alpha).to(out_dtype)


def check_args(x, weights, relu_mode, alpha, out_dtype, weight_shape):
    if relu_mode not in RELU_MODES:
        raise ValueError(f"relu_mode must be one of {sorted(RELU_MODES)}")
    if relu_mode == "prelu" and alpha is None:
        raise ValueError("relu_mode='prelu' needs alpha")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if weights.dtype != x.dtype:
        raise TypeError(f"weights dtype {weights.dtype} != x dtype {x.dtype}")
    if out_dtype not in (x.dtype, torch.float32):
        raise TypeError(f"out_dtype must be {x.dtype} or float32")
    if tuple(weights.shape) != tuple(weight_shape):
        raise ValueError(f"weights shape {tuple(weights.shape)} != {weight_shape}")


def launch_conv3(entry: str, x, weights, bias, scale, shift, alpha, relu_mode,
                 out, full_dims) -> None:
    """Shared launch of the two conv3 kernels (dense and phase layouts)."""
    for t, name in ((x, "x"), (weights, "weights"), (out, "out")):
        _cuda.check_cuda(t, name)
    b, d, h, w = full_dims
    if b * d > 65535:  # one grid row per (b, d) plane: CUDA's grid.z limit
        raise ValueError(f"batch * depth = {b * d} exceeds 65535 planes")
    co = weights.shape[-1]
    s, t = _epilogue_vectors(co, bias, scale, shift, x.device)
    a = None
    if relu_mode == "prelu":
        a = alpha.to(device=x.device, dtype=torch.float32).reshape(1).contiguous()
    _cuda.launch(
        entry, x.data_ptr(), weights.data_ptr(), s.data_ptr(), t.data_ptr(),
        None if a is None else a.data_ptr(), RELU_MODES[relu_mode], out.data_ptr(),
        b, d, h, w, weights.shape[-2], co,
        int(x.dtype == torch.bfloat16), int(out.dtype == torch.bfloat16),
    )


def conv3d(
    x: torch.Tensor,  # (B, D, H, W, C) channel-last
    weights: torch.Tensor,  # (3, 3, 3, C, CO) DHWIO
    bias: Optional[torch.Tensor] = None,  # (CO,)
    scale: Optional[torch.Tensor] = None,  # (CO,) folded-norm scale
    shift: Optional[torch.Tensor] = None,  # (CO,) folded-norm shift
    alpha: Optional[torch.Tensor] = None,  # (1,) PReLU slope
    relu_mode: str = "none",  # none | relu | prelu
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Fused stride-1 SAME 3^3 conv: y = (conv(x) + bias) * scale + shift,
    then the activation. f32 accumulation; bf16 or f32 in, out in
    ``out_dtype`` (x's dtype or f32)."""
    out_dtype = out_dtype or x.dtype
    if x.ndim != 5:
        raise ValueError(f"x must be (B, D, H, W, C), got {tuple(x.shape)}")
    c = x.shape[-1]
    co = weights.shape[-1]
    check_args(x, weights, relu_mode, alpha, out_dtype, (3, 3, 3, c, co))
    if x.device.type == "cpu":
        return conv3d_plain(x, weights, bias, scale, shift, alpha, relu_mode, out_dtype)
    b, d, h, w, _ = x.shape
    out = torch.empty((b, d, h, w, co), dtype=out_dtype, device=x.device)
    launch_conv3("segk_fused_conv3", x, weights, bias, scale, shift, alpha,
                 relu_mode, out, (b, d, h, w))
    counter.count += 1
    return out
