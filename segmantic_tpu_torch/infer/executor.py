"""Folded-BN eval forward of the UNet, on the hand-written kernels.

Port of ``segmantic_tpu/infer/executor.py::make_eval_forward``. At eval time
the graph is static and the norm statistics are constants, so:

- **BatchNorm folds** into the conv epilogue: ``y = (conv(x) + bias) * s + t``
  with ``s = gamma / sqrt(var + 1e-5)``, ``t = beta - mean * s``;
- **every stride-1 3^3 conv** runs through the fused conv kernel
  (:mod:`..ops.fused_conv`) with bias, folded norm and PReLU in its epilogue.
  The JAX package gated this on the TPU's lane-packing win region
  (B*C <= 128); on the card every such conv takes the kernel;
- the **strided projection** of a residual unit shares one conv with the
  unit's first (strided) subunit: output channels concatenated, then split;
- the **top decoder stages** run in subpixel phase space: the conv-transpose's
  phase tensor carries the 2x-upsampled volume at input resolution, its 3^3
  conv runs through the phase conv kernel (:mod:`..ops.phase_conv`), and at
  the top stage the identity residual folds into the kernel's centre tap;
  one depth-to-space at the end.

The stride-2 convs and the conv-transposes stay ``F.conv3d`` /
``F.conv_transpose3d``, as the JAX package left them to XLA. The folded
parameters are prepared once per model (serving weights are constant); the
returned callable maps windows (B, D, H, W, C) to f32 logits.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import torch

from ..models.unet import BN_EPS, ConvUnit, ResidualUnit, UNet
from ..ops import fast_conv, fused_conv, phase_conv

_RELU_MODES = {"PRELU": "prelu", "RELU": "relu"}


def executor_supported(model) -> bool:
    """3D, kernel 3, BATCH (foldable) or NONE norm, PReLU or ReLU."""
    return (
        isinstance(model, UNet)
        and model.spatial_dims == 3
        and model.kernel_size == 3
        and model.up_kernel_size == 3
        and model.norm in ("BATCH", "NONE")
        and model.act in ("PRELU", "RELU")
    )


@dataclasses.dataclass
class _Conv:
    """One conv with its folded epilogue, prepared for the compute dtype."""

    w: torch.Tensor  # DHWIO, compute dtype
    bias: torch.Tensor  # (CO,) f32
    scale: Optional[torch.Tensor]  # (CO,) f32, folded norm (None: no norm)
    shift: Optional[torch.Tensor]
    alpha: Optional[torch.Tensor]  # (1,) f32 PReLU slope
    relu_mode: str  # none | relu | prelu
    # the kernels' packed copies of w (serving weights are constant)
    packed: dict = dataclasses.field(default_factory=dict)

    def epilogue(self, y: torch.Tensor, tile: bool = False) -> torch.Tensor:
        """Folded norm + activation on a conv output (bias already added),
        in y's dtype; ``tile`` spreads the vectors over the 8 phases."""
        if self.scale is not None:
            s, t = self.scale, self.shift
            if tile:
                s, t = fast_conv.tile_phase(s), fast_conv.tile_phase(t)
            y = y * s.to(y.dtype) + t.to(y.dtype)
        return fused_conv.activation(y, self.relu_mode, self.alpha)


def _prepare(unit: ConvUnit, dtype, conv_only: bool) -> _Conv:
    conv = unit.conv
    scale = shift = alpha = None
    relu_mode = "none"
    if not conv_only:
        norm = unit.norm
        if norm is not None:
            scale = (norm.weight / torch.sqrt(norm.running_var + BN_EPS)).float()
            shift = (norm.bias - norm.running_mean * scale).float()
        relu_mode = _RELU_MODES[unit.act]
        if relu_mode == "prelu":
            alpha = unit.PReLU_0.weight.detach().float().reshape(1)
    return _Conv(
        w=conv.dhwio().to(dtype).contiguous(), bias=conv.bias.detach().float(),
        scale=scale, shift=shift, alpha=alpha, relu_mode=relu_mode,
    )


def _kernel_conv(x: torch.Tensor, c: _Conv):
    """Stride-1 3^3 conv + epilogue on the fused conv kernel."""
    return fused_conv.conv3d(
        x.contiguous(), c.w, bias=c.bias, scale=c.scale,
        shift=c.shift, alpha=c.alpha, relu_mode=c.relu_mode, out_dtype=x.dtype,
        packed_cache=c.packed,
    )


def _plain_conv(x: torch.Tensor, c: _Conv, stride: int, transposed: bool):
    """Strided conv / conv-transpose through torch, epilogue after."""
    if transposed:
        y = fast_conv.conv_transpose_same(x, c.w, stride=stride)
    else:
        y = fast_conv.conv_same(x, c.w, stride=stride)
    return c.epilogue(y + c.bias.to(y.dtype))


class _ResidualUnit:
    def __init__(self, ru: ResidualUnit, dtype, last_conv_only: bool):
        self.strides = ru.strides
        units = ru.units()
        n = len(units)
        self.convs = [
            _prepare(u, dtype, last_conv_only and i == n - 1) for i, u in enumerate(units)
        ]
        self.fused = None  # strided projection sharing the first subunit's conv
        self.proj = None
        proj = ru.projection
        if proj is not None:
            pw = proj.dhwio().to(dtype)
            pb = proj.bias.detach().float()
            c0 = self.convs[0]
            if ru.strides != 1 and pw.shape == c0.w.shape:
                self.fused = (torch.cat([c0.w, pw], -1).contiguous(),
                              torch.cat([c0.bias, pb]))
            else:
                self.proj = _Conv(pw.contiguous(), pb, None, None, None, "none")

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        c0 = self.convs[0]
        if self.fused is not None:
            wcat, bcat = self.fused
            feats = c0.w.shape[-1]
            both = fast_conv.conv_same(x, wcat, stride=self.strides)
            both = both + bcat.to(both.dtype)
            y, residual = c0.epilogue(both[..., :feats]), both[..., feats:]
            start = 1
        else:
            residual = x if self.proj is None else _plain_conv(
                x, self.proj, self.strides, transposed=False)
            y, start = x, 0
        for i in range(start, len(self.convs)):
            stride = self.strides if i == 0 else 1
            if stride == 1:
                y = _kernel_conv(y, self.convs[i])
            else:
                y = _plain_conv(y, self.convs[i], stride, transposed=False)
        return y + residual.to(y.dtype)


class _PhaseStage:
    """Decoder stage (conv-transpose unit + 1-subunit residual unit) in
    subpixel phase space, with one depth-to-space at the end."""

    def __init__(self, up: ConvUnit, ru: ResidualUnit, dtype, last_conv_only: bool):
        self.up = _prepare(up, dtype, conv_only=False)
        units = ru.units()
        n = len(units)
        self.convs = [
            _prepare(u, dtype, last_conv_only and i == n - 1) for i, u in enumerate(units)
        ]
        self.feats = self.up.w.shape[-1]
        # a single conv-only subunit (the flagship top): the identity
        # residual folds into the kernel's centre tap, out = conv(ph, w + I)
        self.fold_identity = n == 1 and last_conv_only
        self.weights = [c.w for c in self.convs]
        if self.fold_identity:
            w = self.weights[0].clone()
            w[1, 1, 1] += torch.eye(self.feats, dtype=w.dtype, device=w.device)
            self.weights[0] = w

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        up = self.up
        ph = fast_conv.subpixel_phase_conv(x, up.w)
        ph = up.epilogue(ph + fast_conv.tile_phase(up.bias).to(ph.dtype), tile=True)
        ph = ph.contiguous()
        yp = ph
        for c, w in zip(self.convs, self.weights):
            yp = phase_conv.phase_conv(
                yp, w, bias=c.bias, scale=c.scale, shift=c.shift, alpha=c.alpha,
                relu_mode=c.relu_mode, out_dtype=yp.dtype, packed_cache=c.packed,
            )
        if not self.fold_identity:
            yp = yp + ph
        return fast_conv.depth_to_space(yp, self.feats)


def make_eval_forward(model: UNet, compute_dtype: torch.dtype = torch.bfloat16
                      ) -> Callable[[torch.Tensor], torch.Tensor]:
    """``windows (B, D, H, W, C) -> f32 logits (B, D, H, W, classes)``.

    Numerically the eval ``model.forward`` (folded-norm rounding aside) in
    ``compute_dtype``; runs on the model's device, which must also hold the
    windows."""
    if not executor_supported(model):
        raise ValueError("configuration not supported by the eval executor")
    down, up = _build_stages(model, compute_dtype)
    strides = model.strides

    @torch.no_grad()
    def eval_forward(windows: torch.Tensor) -> torch.Tensor:
        y = windows.to(compute_dtype)
        skips = []
        for f in down[:-1]:
            y = f(y)
            skips.append(y)
        y = down[-1](y)
        for level, f in zip(reversed(range(len(strides))), up):
            y = f(torch.cat([skips[level], y], dim=-1))
        return y.float()

    return eval_forward


@torch.no_grad()
def _build_stages(model: UNet, compute_dtype):
    """Prepared encoder units and decoder stages, in forward order."""
    nres = model.num_res_units
    strides = model.strides
    enc_units = model.encoder()

    def prep_down(unit, s):
        if nres > 0:
            return _ResidualUnit(unit, compute_dtype, last_conv_only=False)
        conv = _prepare(unit, compute_dtype, conv_only=False)
        if s == 1:
            return lambda y: _kernel_conv(y, conv)
        return lambda y: _plain_conv(y, conv, s, transposed=False)

    down: List[Callable] = [
        prep_down(u, s) for u, s in zip(enc_units, list(strides) + [1])
    ]
    up: List[Callable] = []
    for level, units in zip(reversed(range(len(strides))), model.decoder()):
        is_top = level == 0
        feats = model.out_channels if is_top else model.channels[level - 1]
        if model.phase_stage_ok(feats, strides[level]):
            up.append(_PhaseStage(units[0], units[1], compute_dtype, is_top))
            continue
        conv = _prepare(units[0], compute_dtype, conv_only=is_top and nres == 0)
        ru = (_ResidualUnit(units[1], compute_dtype, last_conv_only=is_top)
              if nres > 0 else None)

        def stage(y, conv=conv, ru=ru, s=strides[level]):
            y = _plain_conv(y, conv, s, transposed=True)
            return y if ru is None else ru(y)

        up.append(stage)
    return down, up
