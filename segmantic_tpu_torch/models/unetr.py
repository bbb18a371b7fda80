"""UNETR (Hatamizadeh et al., 2021; MONAI topology) as torch modules, 3D.

Port of ``segmantic_tpu/models/unetr.py``, the unpacked graph
(``SEGMANTIC_UNETR_PACK=off``; packed and unpacked compute the same function
with the same parameter tree):

- a ViT encoder: non-overlapping 16^3 patch embedding (a stride-16 conv), a
  learnable position embedding, pre-LN transformer blocks (LayerNorm eps
  1e-6, flax ``MultiHeadDotProductAttention``, MLP with flax's tanh GELU);
  hidden states are tapped at depths L/4, L/2, 3L/4 and L;
- CNN skip branches: the input through two 3^3 conv blocks (f); the taps
  through 3, 2 and 1 deconv + conv-block stages (2f at 1/2, 4f at 1/4, 8f
  at 1/8 resolution);
- a decoder from the last tap: deconv x2, concatenate the skip, two 3^3
  convs, four stages to full resolution, then a 1^3 conv head.

Channel-last (B, D, H, W, C) in and out, parameters cast to the input's
dtype at use, InstanceNorm by default (f32 statistics). The attention is
plain torch as the JAX package leaves it to XLA: ``torch.matmul`` in the
input's dtype, the query scaled by 1/sqrt(head_dim), softmax in f32, then
cast. The patch embedding and the head are ``F.conv3d``, the kernel-2
deconvs ``F.conv_transpose3d``; every stride-1 3^3 conv (the conv blocks,
``nn.Conv`` in the JAX module) runs through
:func:`..ops.fused_conv.conv3d_grad`, the hand-written kernels on the card.

The position embedding ties the parameters to the token grid, so the model
is built for one ``spatial_size`` and takes only inputs of that size, as in
the JAX package (where another size fails inside flax).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.fused_conv import at_least_f32
from .unet import Conv, ConvTranspose, PReLU, _lecun_normal_, activation, make_norm

__all__ = ["LayerNorm", "Dense", "MultiHeadDotProductAttention", "TransformerBlock",
           "ConvBlock", "DeconvBlock", "UNETR"]

LN_EPS = 1e-6


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` (eps 1e-6) over the last axis: mean and
    ``E[x^2] - E[x]^2`` (clipped at 0) in f32 or wider, output in x's dtype."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        xf = at_least_f32(x)
        mean = xf.mean(-1, keepdim=True)
        var = torch.clamp_min((xf * xf).mean(-1, keepdim=True) - mean * mean, 0.0)
        y = (xf - mean) * (torch.rsqrt(var + LN_EPS) * self.weight) + self.bias
        return y.to(x.dtype)


class Dense(nn.Module):
    """flax ``nn.Dense``: weight (out, in), in x's dtype."""

    def __init__(self, c_in: int, c_out: int, generator=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c_out, c_in))
        self.bias = nn.Parameter(torch.zeros(c_out))
        with torch.no_grad():
            _lecun_normal_(self.weight, c_in, generator)

    def forward(self, x):
        tp = self.__dict__.get("tp")  # a column-parallel share (parallel.shard_params)
        if tp is not None:
            w = self.weight.to(x.dtype)
            return tp.column(x, lambda v: F.linear(v, w)) + self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class _Projection(nn.Module):
    """A flax ``DenseGeneral`` of the attention, in flax's shapes: ``weight``
    (hidden, heads, head_dim) for query / key / value, (heads, head_dim,
    hidden) for out."""

    def __init__(self, w_shape, b_shape, fan_in: int, generator=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(w_shape))
        self.bias = nn.Parameter(torch.zeros(b_shape))
        with torch.no_grad():
            _lecun_normal_(self.weight, fan_in, generator)


class MultiHeadDotProductAttention(nn.Module):
    """flax ``nn.MultiHeadDotProductAttention`` (self-attention, no mask, no
    dropout) in the input's dtype, softmax in f32."""

    def __init__(self, hidden: int, heads: int, generator=None):
        super().__init__()
        if hidden % heads:
            raise ValueError(f"hidden size {hidden} is not a multiple of {heads} heads")
        hd = hidden // heads
        self.heads = heads
        for name in ("query", "key", "value"):
            self.add_module(name, _Projection((hidden, heads, hd), (heads, hd), hidden,
                                              generator))
        self.out = _Projection((heads, hd, hidden), (hidden,), hidden, generator)

    def forward(self, x):  # (B, T, H)
        dt = x.dtype
        b, t, h = x.shape

        def project(p):  # (B, T, H) -> (B, heads, T, hd)
            w = p.weight.to(dt).reshape(h, -1)
            y = torch.matmul(x, w).reshape(b, t, self.heads, -1) + p.bias.to(dt)
            return y.transpose(1, 2)

        q, k, v = project(self.query), project(self.key), project(self.value)
        q = q / math.sqrt(q.shape[-1])
        logits = torch.matmul(q, k.transpose(-1, -2))
        weights = torch.softmax(at_least_f32(logits), dim=-1).to(dt)
        y = torch.matmul(weights, v).transpose(1, 2).reshape(b, t, h)  # (B, T, heads*hd)
        return torch.matmul(y, self.out.weight.to(dt).reshape(h, h)) + self.out.bias.to(dt)


class TransformerBlock(nn.Module):
    """Pre-LN ViT block: LN -> MHSA -> +res, LN -> MLP(GELU) -> +res."""

    def __init__(self, hidden: int, heads: int, mlp_dim: int, generator=None):
        super().__init__()
        self.LayerNorm_0 = LayerNorm(hidden)
        self.MultiHeadDotProductAttention_0 = MultiHeadDotProductAttention(
            hidden, heads, generator)
        self.LayerNorm_1 = LayerNorm(hidden)
        self.Dense_0 = Dense(hidden, mlp_dim, generator)
        self.Dense_1 = Dense(mlp_dim, hidden, generator)

    def forward(self, x):
        x = x + self.MultiHeadDotProductAttention_0(self.LayerNorm_0(x))
        y = F.gelu(self.Dense_0(self.LayerNorm_1(x)), approximate="tanh")
        return x + self.Dense_1(y)


class ConvBlock(nn.Module):
    """(3^3 conv -> norm -> act) twice, the UNETR basic block."""

    def __init__(self, c_in: int, features: int, norm: str = "INSTANCE",
                 act: str = "RELU", generator=None):
        super().__init__()
        self.act = act.upper()
        self.act_fn = None if self.act == "PRELU" else activation(self.act)
        c = c_in
        for i in range(2):
            self.add_module(f"conv_{i}", Conv(c, features, 3, 1, generator))
            norm_module = make_norm(norm, features)
            if norm_module is not None:
                self.add_module(f"Norm_{i}", norm_module)
            if self.act == "PRELU":
                self.add_module(f"PReLU_{i}", PReLU())
            c = features

    def forward(self, x):
        for i in range(2):
            x = getattr(self, f"conv_{i}")(x)
            norm = getattr(self, f"Norm_{i}", None)
            if norm is not None:
                x = norm(x)
            x = getattr(self, f"PReLU_{i}")(x) if self.act_fn is None else self.act_fn(x)
        return x


class DeconvBlock(nn.Module):
    """Stride-2 kernel-2 transposed conv: an exact 2x upsample."""

    def __init__(self, c_in: int, features: int, generator=None):
        super().__init__()
        self.deconv = ConvTranspose(c_in, features, 2, 2, generator)

    def forward(self, x):
        return self.deconv(x)


class UNETR(nn.Module):
    """ViT encoder + progressive-deconv decoder for ``spatial_size`` inputs.

    Defaults are MONAI's / the JAX package's: hidden 768, 12 layers, 12
    heads, MLP 3072, feature size 16, patch 16, InstanceNorm, ReLU."""

    def __init__(self, spatial_size: Sequence[int], spatial_dims: int = 3,
                 in_channels: int = 1, out_channels: int = 2, hidden_size: int = 768,
                 num_layers: int = 12, num_heads: int = 12, mlp_dim: int = 3072,
                 feature_size: int = 16, patch_size: int = 16, norm: str = "INSTANCE",
                 act: str = "RELU", generator: Optional[torch.Generator] = None):
        super().__init__()
        if spatial_dims != 3:
            raise ValueError("UNETR is 3D: expected (N, D, H, W, C) input")
        if patch_size != 16:
            # the 4-stage x2 decoder implies a 16x patch grid (MONAI's constant)
            raise ValueError("UNETR requires patch_size=16")
        spatial_size = tuple(int(s) for s in spatial_size)
        if len(spatial_size) != 3 or any(s % patch_size for s in spatial_size):
            raise ValueError(f"spatial size {spatial_size} must be divisible by patch "
                             f"{patch_size}")
        self.spatial_dims = 3
        self.spatial_size = spatial_size
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.feature_size = feature_size
        self.patch_size = patch_size
        self.grid = tuple(s // patch_size for s in spatial_size)
        g = generator
        f, hid = feature_size, hidden_size
        common = dict(norm=norm, act=act, generator=g)

        self.patch_embed = Conv(in_channels, hid, patch_size, patch_size, g)
        self.pos_embed = nn.Parameter(torch.empty(1, math.prod(self.grid), hid))
        with torch.no_grad():
            nn.init.trunc_normal_(self.pos_embed, 0.0, 0.02, -0.04, 0.04, generator=g)
        for i in range(num_layers):
            self.add_module(f"block_{i}", TransformerBlock(hid, num_heads, mlp_dim, g))
        self.encoder_norm = LayerNorm(hid)

        self.encoder1 = ConvBlock(in_channels, f, **common)
        for name, n_up, feats in (("encoder2", 3, 2 * f), ("encoder3", 2, 4 * f),
                                  ("encoder4", 1, 8 * f)):
            c = hid
            for j in range(n_up):
                self.add_module(f"{name}_up_{j}", DeconvBlock(c, feats, g))
                self.add_module(f"{name}_conv_{j}", ConvBlock(feats, feats, **common))
                c = feats
        c = hid
        for name, feats in (("decoder5", 8 * f), ("decoder4", 4 * f), ("decoder3", 2 * f),
                            ("decoder2", f)):
            self.add_module(f"{name}_up", DeconvBlock(c, feats, g))
            self.add_module(f"{name}_conv", ConvBlock(2 * feats, feats, **common))
            c = feats
        self.out = Conv(f, out_channels, 1, 1, g)

    def phase_top_ok(self) -> bool:
        """False: the port runs UNETR unpacked, so there is no phase-major
        head for the trainer's phase Dice (lane packing through the phase
        kernels: ROADMAP Queue 2)."""
        return False

    def forward(self, x: torch.Tensor, phase_logits: bool = False) -> torch.Tensor:
        """Logits (N, D, H, W, classes) of an input of ``spatial_size``."""
        if phase_logits:
            raise ValueError("the port's UNETR runs unpacked and emits no phase logits "
                             "(lane packing: ROADMAP Queue 2)")
        if x.ndim != 5:
            raise ValueError("UNETR is 3D: expected (N, D, H, W, C) input")
        spatial = tuple(x.shape[1:4])
        if any(s % self.patch_size for s in spatial):
            raise ValueError(f"spatial size {spatial} must be divisible by patch "
                             f"{self.patch_size}")
        if spatial != self.spatial_size:
            raise ValueError(
                f"UNETR was built for inputs of {self.spatial_size} (its position "
                f"embedding ties the token grid to spatial_size), got {spatial}")
        b, hid = x.shape[0], self.hidden_size
        z = self.patch_embed(x).reshape(b, -1, hid)
        z = z + self.pos_embed.to(z.dtype)
        taps = {}
        quarter = max(1, self.num_layers // 4)
        for i in range(self.num_layers):
            z = getattr(self, f"block_{i}")(z)
            if (i + 1) % quarter == 0:
                taps[(i + 1) // quarter] = z
        z12 = self.encoder_norm(taps.get(4, z))

        def grid_view(t):  # (B, T, H) -> (B, *grid, H)
            return t.reshape((b,) + self.grid + (hid,))

        def up(t, name, n_up):
            y = grid_view(t)
            for j in range(n_up):
                y = getattr(self, f"{name}_conv_{j}")(getattr(self, f"{name}_up_{j}")(y))
            return y

        enc1 = self.encoder1(x)
        enc2 = up(taps.get(1, z), "encoder2", 3)
        enc3 = up(taps.get(2, z), "encoder3", 2)
        enc4 = up(taps.get(3, z), "encoder4", 1)
        y = grid_view(z12)
        for name, skip in (("decoder5", enc4), ("decoder4", enc3), ("decoder3", enc2),
                           ("decoder2", enc1)):
            y = getattr(self, f"{name}_up")(y)
            y = getattr(self, f"{name}_conv")(torch.cat([y, skip], dim=-1))
        return self.out(y)
