"""UNETR (Hatamizadeh et al., 2021; MONAI topology) as torch modules, 3D.

Port of ``segmantic_tpu/models/unetr.py``, both of its graphs, which compute
the same function with the same parameter tree:

- a ViT encoder: non-overlapping 16^3 patch embedding (a stride-16 conv), a
  learnable position embedding, pre-LN transformer blocks (LayerNorm eps
  1e-6, flax ``MultiHeadDotProductAttention``, MLP with flax's tanh GELU);
  hidden states are tapped at depths L/4, L/2, 3L/4 and L;
- CNN skip branches: the input through two 3^3 conv blocks (f); the taps
  through 3, 2 and 1 deconv + conv-block stages (2f at 1/2, 4f at 1/4, 8f
  at 1/8 resolution);
- a decoder from the last tap: deconv x2, concatenate the skip, two 3^3
  convs, four stages to full resolution, then a 1^3 conv head.

Packed (``pack=True``, the default, as the JAX package's
``SEGMANTIC_UNETR_PACK=on``): the two narrow regions, full resolution at
C = f and half resolution at C = 2f, run in subpixel phase space. Their
tensors are phase-major at half their resolution (2x2x2 blocks folded into
the channels, :func:`..ops.fast_conv.space_to_depth`): the input of
``encoder1``, the last ``encoder2`` stage, ``decoder3`` and ``decoder2``. The
kernel-2 deconvs into them are one product onto the phase channels
(``subpixel_phase_conv_k2``), the skips join by ``phase_concat``, the 3^3
convs run on the phase-space kernels (:func:`..ops.phase_conv.phase_conv_grad`;
the one-channel input conv on cuDNN over the full-resolution view, the faster
route at that shape: ``models.unet.Conv._conv``),
the norms reduce over (spatial, phase) per true channel, the head is the
block-diagonal ``phase_pointwise_conv``, and one ``depth_to_space`` gives
the logits (or ``forward(phase_logits=True)`` returns the phase-major ones,
which the trainer's phase Dice takes). ``pack=False`` runs the plain graph.

Channel-last (B, D, H, W, C) in and out, parameters cast to the input's
dtype at use, InstanceNorm by default (f32 statistics). The attention is
plain torch as the JAX package leaves it to XLA: ``torch.matmul`` in the
input's dtype, the query scaled by 1/sqrt(head_dim), softmax in f32, then
cast. The patch embedding and the plain head are ``F.conv3d``, the plain
kernel-2 deconvs ``F.conv_transpose3d``; every other stride-1 3^3 conv (the
conv blocks, ``nn.Conv`` in the JAX module) runs through
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

from ..ops.fast_conv import depth_to_space, phase_concat, space_to_depth
from ..ops.fused_conv import at_least_f32
from .unet import Conv, ConvTranspose, PReLU, _lecun_normal_, activation, make_norm

__all__ = ["LayerNorm", "Dense", "MultiHeadDotProductAttention", "TransformerBlock",
           "ConvBlock", "DeconvBlock", "UNETR", "mark_phase_space"]

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
    """(3^3 conv -> norm -> act) twice, the UNETR basic block. ``phase``: its
    tensors are phase-major, the convs run in phase space and the norms
    reduce over the 8 phases too (same parameters)."""

    def __init__(self, c_in: int, features: int, norm: str = "INSTANCE",
                 act: str = "RELU", generator=None, phase: bool = False):
        super().__init__()
        self.act = act.upper()
        self.act_fn = None if self.act == "PRELU" else activation(self.act)
        self.phase = phase
        c = c_in
        for i in range(2):
            self.add_module(f"conv_{i}", Conv(c, features, 3, 1, generator))
            norm_module = make_norm(norm, features)
            if norm_module is not None:
                self.add_module(f"Norm_{i}", norm_module)
            if self.act == "PRELU":
                self.add_module(f"PReLU_{i}", PReLU())
            c = features
        if phase:
            mark_phase_space(self)

    def forward(self, x):
        for i in range(2):
            x = getattr(self, f"conv_{i}")(x, phase=self.phase)
            norm = getattr(self, f"Norm_{i}", None)
            if norm is not None:
                x = norm(x, groups=8 if self.phase else 1)
            x = getattr(self, f"PReLU_{i}")(x) if self.act_fn is None else self.act_fn(x)
        return x


class DeconvBlock(nn.Module):
    """Stride-2 kernel-2 transposed conv: an exact 2x upsample. ``phase_out``:
    it returns the phase-major tensor of the upsampled volume at the input's
    resolution (same parameters)."""

    def __init__(self, c_in: int, features: int, generator=None, phase_out: bool = False):
        super().__init__()
        self.deconv = ConvTranspose(c_in, features, 2, 2, generator)
        self.phase_out = phase_out
        if phase_out:
            mark_phase_space(self)

    def forward(self, x):
        return self.deconv(x, phase_out=self.phase_out)


def mark_phase_space(module: nn.Module) -> None:
    """Mark the layers of ``module`` as phase-space ones: their outputs are
    phase-major, so ``parallel.tp_placement`` keeps them whole (an all-gather
    of column slices would interleave the phases wrongly)."""
    for m in module.modules():
        if isinstance(m, (Conv, ConvTranspose)):
            m.phase_space = True


class UNETR(nn.Module):
    """ViT encoder + progressive-deconv decoder for ``spatial_size`` inputs.

    Defaults are MONAI's / the JAX package's: hidden 768, 12 layers, 12
    heads, MLP 3072, feature size 16, patch 16, InstanceNorm, ReLU, and the
    packed graph (``pack``; see the module's docstring). ``pack`` changes no
    parameter, so a checkpoint loads into either graph."""

    def __init__(self, spatial_size: Sequence[int], spatial_dims: int = 3,
                 in_channels: int = 1, out_channels: int = 2, hidden_size: int = 768,
                 num_layers: int = 12, num_heads: int = 12, mlp_dim: int = 3072,
                 feature_size: int = 16, patch_size: int = 16, norm: str = "INSTANCE",
                 act: str = "RELU", generator: Optional[torch.Generator] = None,
                 pack: bool = True):
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
        self.pack = pack  # spatial % 16 == 0 gives the even sizes packing needs
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

        self.encoder1 = ConvBlock(in_channels, f, phase=pack, **common)
        for name, n_up, feats in (("encoder2", 3, 2 * f), ("encoder3", 2, 4 * f),
                                  ("encoder4", 1, 8 * f)):
            c = hid
            for j in range(n_up):
                # packed, the last (half-resolution, 2f) encoder2 stage is phase-major
                ph = pack and name == "encoder2" and j == n_up - 1
                self.add_module(f"{name}_up_{j}", DeconvBlock(c, feats, g, phase_out=ph))
                self.add_module(f"{name}_conv_{j}", ConvBlock(feats, feats, phase=ph,
                                                              **common))
                c = feats
        c = hid
        for name, feats in (("decoder5", 8 * f), ("decoder4", 4 * f), ("decoder3", 2 * f),
                            ("decoder2", f)):
            ph = pack and name in ("decoder3", "decoder2")
            self.add_module(f"{name}_up", DeconvBlock(c, feats, g, phase_out=ph))
            self.add_module(f"{name}_conv", ConvBlock(2 * feats, feats, phase=ph, **common))
            c = feats
        self.out = Conv(f, out_channels, 1, 1, g)
        if pack:
            mark_phase_space(self.out)

    def phase_top_ok(self) -> bool:
        """Packed, the head's tensor before its ``depth_to_space`` is the
        phase-major logits tensor (lane ``phase * classes + class``), which
        the trainer's phase Dice takes."""
        return self.pack

    def forward(self, x: torch.Tensor, phase_logits: bool = False) -> torch.Tensor:
        """Logits (N, D, H, W, classes) of an input of ``spatial_size``, or
        with ``phase_logits`` (packed only) the phase-major logits
        (N, D/2, H/2, W/2, 8 * classes)."""
        if phase_logits and not self.pack:
            raise ValueError("UNETR emits phase logits only packed (UNETR(pack=True))")
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

        enc1 = self.encoder1(space_to_depth(x) if self.pack else x)
        enc2 = up(taps.get(1, z), "encoder2", 3)
        enc3 = up(taps.get(2, z), "encoder3", 2)
        enc4 = up(taps.get(3, z), "encoder4", 1)
        y = grid_view(z12)
        for name, skip in (("decoder5", enc4), ("decoder4", enc3), ("decoder3", enc2),
                           ("decoder2", enc1)):
            up_block = getattr(self, f"{name}_up")
            if up_block.phase_out:
                y = phase_concat(up_block(y), skip)
            else:
                y = torch.cat([up_block(y), skip], dim=-1)
            y = getattr(self, f"{name}_conv")(y)
            if name == "decoder3" and self.pack:  # decoder2's deconv reads the volume
                y = depth_to_space(y, 2 * self.feature_size)
        if not self.pack:
            return self.out(y)
        out = self.out(y, phase=True)
        return out if phase_logits else depth_to_space(out, self.out_channels)
