"""SegResNet (MONAI topology, Myronenko 2018) as torch modules, 2D or 3D.

Port of ``segmantic_tpu/models/segresnet.py``:

- an initial 3^nd conv to ``init_filters``;
- encoder stages ``i = 0..n-1``: a stride-2 3^nd conv doubling the channels
  (for i > 0), then ``blocks_down[i]`` pre-activation residual blocks
  (norm -> act -> conv3, twice, + identity);
- decoder stages, deep to shallow: a 1^nd conv halving the channels, a
  stride-2 kernel-3 SAME conv-transpose (exact 2x upsample), the ADDITIVE
  skip of the matching encoder stage, then ``blocks_up[j]`` residual blocks;
- a final norm -> act -> 1^nd conv to ``out_channels``.

Channel-last (B, *S, C) in and out, parameters cast to the input's dtype
at use, GroupNorm (f32 statistics) by default. Modules carry the flax names
(``conv_init``, ``down_i``, ``enc_i_b/{Norm_0, conv_0, Norm_1, conv_1}``,
``up_conv_j``, ``up_j``, ``dec_j_b``, ``Norm_0``, ``conv_final``), so
``models.unet.from_flax_variables`` / ``to_flax_variables`` bridge the two
packages' checkpoints. In 3D every stride-1 3^3 conv runs through
:func:`..ops.fused_conv.conv3d_grad` (the hand-written conv and dw kernels on
the card): the JAX package admits such a conv to its Pallas kernel only
inside a TPU gate (B * C <= 128), the port routes every one by the function
it computes. The strided convs, the 1^3 convs and the transpose are
``F.conv3d`` / ``F.conv_transpose3d``; in 2D every conv is ``F.conv2d`` /
``F.conv_transpose2d``, as the JAX package's 2D convs are XLA. There is no phase-space stage
(additive skips keep every stage at full resolution), so ``phase_top_ok()``
is False and the train step takes the plain Dice.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from .unet import DROPOUT_REFUSAL, Conv, ConvTranspose, PReLU, activation, make_norm

__all__ = ["ResBlock", "SegResNet"]


class ResBlock(nn.Module):
    """Pre-activation residual block: (norm -> act -> conv3) x 2 + identity."""

    def __init__(self, features: int, norm: str = "GROUP", act: str = "RELU",
                 generator: Optional[torch.Generator] = None, nd: int = 3):
        super().__init__()
        self.act = act.upper()
        self.act_fn = None if self.act == "PRELU" else activation(self.act)
        for i in range(2):
            norm_module = make_norm(norm, features)
            if norm_module is not None:
                self.add_module(f"Norm_{i}", norm_module)
            if self.act == "PRELU":
                self.add_module(f"PReLU_{i}", PReLU())
            self.add_module(f"conv_{i}", Conv(features, features, 3, 1, generator, nd))

    def forward(self, x):
        y = x
        for i in range(2):
            norm = getattr(self, f"Norm_{i}", None)
            if norm is not None:
                y = norm(y)
            y = getattr(self, f"PReLU_{i}")(y) if self.act_fn is None else self.act_fn(y)
            y = getattr(self, f"conv_{i}")(y)
        return x + y


class SegResNet(nn.Module):
    """Residual encoder-decoder with additive skips (channel-last in and out).

    Defaults are MONAI's / the JAX package's: init_filters 8, blocks_down
    (1, 2, 2, 4), blocks_up (1, 1, 1), GroupNorm, ReLU."""

    def __init__(self, spatial_dims: int = 3, in_channels: int = 1,
                 out_channels: int = 2, init_filters: int = 8,
                 blocks_down: Sequence[int] = (1, 2, 2, 4),
                 blocks_up: Sequence[int] = (1, 1, 1), norm: str = "GROUP",
                 act: str = "RELU", dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if spatial_dims not in (2, 3):
            raise ValueError(f"spatial_dims must be 2 or 3, got {spatial_dims}")
        blocks_down, blocks_up = tuple(blocks_down), tuple(blocks_up)
        if len(blocks_up) != len(blocks_down) - 1:
            raise ValueError("len(blocks_up) must be len(blocks_down) - 1")
        self.spatial_dims = spatial_dims
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.init_filters = init_filters
        self.blocks_down = blocks_down
        self.blocks_up = blocks_up
        self.norm = norm.upper()
        self.act = act.upper()
        self.dropout = dropout  # the identity in eval; training raises DROPOUT_REFUSAL
        f = init_filters
        g = generator
        nd = spatial_dims

        self.conv_init = Conv(in_channels, f, 3, 1, g, nd)
        for i, n_blocks in enumerate(blocks_down):
            feats = f * 2**i
            if i > 0:
                self.add_module(f"down_{i}", Conv(feats // 2, feats, 3, 2, g, nd))
            for b in range(n_blocks):
                self.add_module(f"enc_{i}_{b}", ResBlock(feats, norm, act, g, nd))
        for j, n_blocks in enumerate(blocks_up):
            feats = f * 2 ** (len(blocks_down) - 2 - j)
            self.add_module(f"up_conv_{j}", Conv(2 * feats, feats, 1, 1, g, nd))
            self.add_module(f"up_{j}", ConvTranspose(feats, feats, 3, 2, g, nd))
            for b in range(n_blocks):
                self.add_module(f"dec_{j}_{b}", ResBlock(feats, norm, act, g, nd))
        norm_module = make_norm(norm, f)
        if norm_module is not None:
            self.Norm_0 = norm_module
        self.act_fn = None if self.act == "PRELU" else activation(self.act)
        if self.act == "PRELU":
            self.PReLU_0 = PReLU()
        self.conv_final = Conv(f, out_channels, 1, 1, g, nd)

    def phase_top_ok(self) -> bool:
        """The phase-major Dice is a UNet decoder feature (the trainer asks
        every architecture)."""
        return False

    def forward(self, x: torch.Tensor, phase_logits: bool = False) -> torch.Tensor:
        """Logits (N, *S, classes)."""
        if phase_logits:
            raise ValueError("SegResNet has no phase-logits output")
        if x.ndim != self.spatial_dims + 2:
            raise ValueError(f"expected (N, *spatial[{self.spatial_dims}], C) input, "
                             f"got {tuple(x.shape)}")
        if self.training and self.dropout > 0:
            raise NotImplementedError(DROPOUT_REFUSAL)
        y = self.conv_init(x)
        skips = []
        for i, n_blocks in enumerate(self.blocks_down):
            if i > 0:
                y = getattr(self, f"down_{i}")(y)
            for b in range(n_blocks):
                y = getattr(self, f"enc_{i}_{b}")(y)
            skips.append(y)
        for j, n_blocks in enumerate(self.blocks_up):
            i = len(self.blocks_down) - 1 - j  # the stage being left
            y = getattr(self, f"up_{j}")(getattr(self, f"up_conv_{j}")(y))
            y = y + skips[i - 1]
            for b in range(n_blocks):
                y = getattr(self, f"dec_{j}_{b}")(y)
        norm = getattr(self, "Norm_0", None)
        if norm is not None:
            y = norm(y)
        y = self.PReLU_0(y) if self.act_fn is None else self.act_fn(y)
        return self.conv_final(y)
