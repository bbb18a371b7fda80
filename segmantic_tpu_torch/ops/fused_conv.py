"""Fused stride-1 SAME 3^3 convolution with the folded-norm epilogue, and
its gradients.

Port of ``segmantic_tpu/ops/pallas_conv.py``: ``conv3d_pallas`` and the
kernel it launches (``conv3d_packed_p``), the weight gradient
``conv3d_packed_dw`` and the differentiable ``conv3d_packed``; the same
functions on plain channel-last tensors, without the TPU's batch-into-lanes
packing.

``conv3d`` launches the CUDA kernel ``csrc/fused_conv.cu`` and
``conv3d_dw`` the kernel ``csrc/fused_conv_dw.cu`` for tensors on a CUDA
device; for tensors on the CPU they run :func:`conv3d_plain` and
:func:`conv3d_dw_plain`, the plain PyTorch versions. :func:`conv3d_grad` is
the ``torch.autograd.Function`` over both: forward and input gradient on the
conv kernel (the input gradient of a SAME stride-1 conv is the same conv with
spatially flipped, in/out-swapped weights), weight gradient on the dw kernel.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import _cuda

__all__ = [
    "conv3d", "conv3d_plain", "conv3d_dw", "conv3d_dw_plain", "conv3d_grad",
    "counter", "dw_counter", "RELU_MODES",
]

RELU_MODES = {"none": 0, "relu": 1, "prelu": 2}
counter = _cuda.LaunchCounter("fused_conv")
dw_counter = _cuda.LaunchCounter("fused_conv_dw")


def at_least_f32(t: torch.Tensor) -> torch.Tensor:
    """t in f32, or in its own dtype where that is wider (float64 on the CPU:
    the plain versions serve as an f64 reference)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def check_dtype(t: torch.Tensor, name: str) -> None:
    """Kernels take f32 or bf16; the plain versions also take f64 on the CPU."""
    if t.dtype in (torch.float32, torch.bfloat16):
        return
    if t.dtype == torch.float64 and t.device.type == "cpu":
        return
    raise TypeError(f"{name} must be float32 or bfloat16 (float64 on the CPU), "
                    f"got {t.dtype}")


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
    epilogue as the kernel in f32 (f64 for f64 input).

    x (B, D, H, W, C); weights (3, 3, 3, C, CO) DHWIO; returns (B, D, H, W, CO)
    in ``out_dtype`` (default: x's dtype)."""
    out_dtype = out_dtype or x.dtype
    co = weights.shape[-1]
    y = at_least_f32(F.conv3d(
        x.permute(0, 4, 1, 2, 3), weights.permute(4, 3, 0, 1, 2), padding=1,
    ).permute(0, 2, 3, 4, 1))
    s, t = _epilogue_vectors(co, bias, scale, shift, x.device)
    y = y * s + t
    return activation(y, relu_mode, alpha).to(out_dtype)


def check_args(x, weights, relu_mode, alpha, out_dtype, weight_shape):
    if relu_mode not in RELU_MODES:
        raise ValueError(f"relu_mode must be one of {sorted(RELU_MODES)}")
    if relu_mode == "prelu" and alpha is None:
        raise ValueError("relu_mode='prelu' needs alpha")
    check_dtype(x, "x")
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


def conv3d_dw_plain(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the weight gradient, in f32 (f64 for f64
    input): ``torch.nn.grad.conv3d_weight`` on the upcasts of x
    (B, D, H, W, C) and dy (B, D, H, W, CO); returns (3, 3, 3, C, CO) DHWIO."""
    c, co = x.shape[-1], dy.shape[-1]
    dw = torch.nn.grad.conv3d_weight(
        at_least_f32(x.permute(0, 4, 1, 2, 3)), (co, c, 3, 3, 3),
        at_least_f32(dy.permute(0, 4, 1, 2, 3)), padding=1,
    )
    return dw.permute(2, 3, 4, 1, 0).contiguous()


def check_dw_args(x, dy) -> None:
    check_dtype(x, "x")
    if dy.dtype != x.dtype:
        raise TypeError(f"dy dtype {dy.dtype} != x dtype {x.dtype}")
    if x.shape[:4] != dy.shape[:4]:
        raise ValueError(f"x and dy cover different grids: {tuple(x.shape)} vs "
                         f"{tuple(dy.shape)}")


def launch_conv3_dw(entry: str, x, dy, full_dims, c: int, co: int) -> torch.Tensor:
    """Shared launch of the two dw kernels (dense and phase layouts): the
    per-split partials go to a workspace sized by the C side's plan."""
    for t, name in ((x, "x"), (dy, "dy")):
        _cuda.check_cuda(t, name)
    b, d, h, w = full_dims
    n = _cuda.query("segk_conv3_dw_workspace", b, d, h, w, c, co)
    ws = torch.empty(n, dtype=torch.float32, device=x.device)
    out = torch.empty((3, 3, 3, c, co), dtype=torch.float32, device=x.device)
    _cuda.launch(entry, x.data_ptr(), dy.data_ptr(), ws.data_ptr(), out.data_ptr(),
                 b, d, h, w, c, co, int(x.dtype == torch.bfloat16))
    return out


def conv3d_dw(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Weight gradient of the stride-1 SAME 3^3 conv:
    ``dw[t, ci, co] = sum_{b,p} x[b, p+t-1, ci] * dy[b, p, co]``, f32
    accumulation and result (3, 3, 3, C, CO); x (B, D, H, W, C) and
    dy (B, D, H, W, CO) both f32 or both bf16 (or f64 on the CPU)."""
    if x.ndim != 5 or dy.ndim != 5:
        raise ValueError(f"x and dy must be 5-D, got {tuple(x.shape)}, {tuple(dy.shape)}")
    check_dw_args(x, dy)
    if x.device.type == "cpu":
        return conv3d_dw_plain(x, dy)
    out = launch_conv3_dw("segk_fused_conv3_dw", x, dy, tuple(x.shape[:4]),
                          x.shape[-1], dy.shape[-1])
    dw_counter.count += 1
    return out


def flip_io(w: torch.Tensor) -> torch.Tensor:
    """Weights of the input gradient of a SAME stride-1 conv: spatial flip,
    in/out swap (``pallas_conv._packed_bwd``, ``phase_gemm._flip_io``)."""
    return w.flip(0, 1, 2).transpose(-1, -2).contiguous()


class _Conv3dGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        x, w = x.contiguous(), w.contiguous()
        ctx.save_for_backward(x, w)
        return conv3d(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = conv3d(dy, flip_io(w), out_dtype=x.dtype)
        if ctx.needs_input_grad[1]:
            dw = conv3d_dw(x, dy).to(w.dtype)
        return dx, dw


def conv3d_grad(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Differentiable stride-1 SAME 3^3 conv without epilogue (the port of
    ``pallas_conv.conv3d_packed``): x (B, D, H, W, C), w (3, 3, 3, C, CO) in
    x's dtype. Add the bias outside, as the JAX package does."""
    return _Conv3dGrad.apply(x, w)
