"""Residual 2D / 3D UNet as torch modules: the training forward and the plain
eval math.

Port of ``segmantic_tpu/models/unet.py`` (MONAI-UNet topology: stride-2
residual encoder, transposed-conv decoder with skip concatenation, residual
units with projection shortcuts, BatchNorm, PReLU). The modules are named
like the flax auto-names (``ResidualUnit_i``, ``ConvUnit_j``, ``Conv_0``,
``ConvTranspose_0``, ``Norm_0``, ``PReLU_0``) so a ``state_dict`` key reads as
the flax path it came from; :func:`from_flax_variables` and
:func:`to_flax_variables` convert between the two, for the UNet and for the
SegResNet and UNETR of :mod:`.segresnet` and :mod:`.unetr`, which share the
norms (:func:`make_norm`: BATCH, INSTANCE, GROUP, NONE) and activations
(:func:`activation`) defined here.

``UNet.forward`` runs the JAX module's graph: channel-last (B, *S, C) in and
out (S = (D, H, W) or (H, W)), XLA-SAME padding, parameters cast to the
input's dtype at use, and the narrow top decoder stages in subpixel phase
space (``phase_stage_ok``: 2^nd phases), optionally returning the top stage's
phase-major logits (``phase_logits``).
In ``train()`` mode BatchNorm normalises by the batch statistics (in f32,
biased variance) and updates the running statistics as flax does; in
``eval()`` mode it uses the running statistics. In 3D every stride-1 3^3 conv
goes through :func:`..ops.fused_conv.conv3d_grad` and every phase-space conv
through :func:`..ops.phase_conv.phase_conv_grad` (the hand-written kernels on
the card, their plain versions on the CPU) but one from a single true
channel (``F.conv3d`` on the full-resolution view, ``Conv._conv``); strided
convs, conv-transposes and 1x1 projections are ``F.conv3d`` /
``F.conv_transpose3d``, as the JAX package leaves them to XLA. In 2D every
conv is ``F.conv2d`` / ``F.conv_transpose2d`` (the phase-space convs too, on
the expanded kernel), as the JAX package's 2D convs are XLA: its Pallas
routes are 3D only.
Training with dropout > 0 raises :data:`DROPOUT_REFUSAL`, as the JAX trainer
does. The folded, kernel-backed serving forward is
:mod:`segmantic_tpu_torch.infer.executor`, tested against this one.
"""

from __future__ import annotations

import contextlib
import re
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.fast_conv import (
    conv_same, depth_to_space, phase_conv_s1_plain, phase_pointwise_conv, space_to_depth,
    subpixel_phase_conv, subpixel_phase_conv_k2, tile_phase,
)
from ..ops.fused_conv import at_least_f32, conv3d_grad
from ..ops.phase_conv import phase_conv_grad
from ..parallel.comm import all_reduce_sum

__all__ = [
    "UNet", "ResidualUnit", "ConvUnit", "Conv", "ConvTranspose", "BatchNorm",
    "GroupNorm", "Norm", "make_norm", "PReLU", "activation", "frozen_running_stats",
    "cross_rank_norm",
    "from_flax_variables", "to_flax_variables", "DROPOUT_REFUSAL",
]

BN_EPS = 1e-5
BN_MOMENTUM = 0.9  # flax's; torch's momentum 0.1
# phase-channel bound of the phase stages (2^nd * out_feats): the JAX
# package's default SEGMANTIC_PHASE_MAX, the head and the next stage
PHASE_MAX = 128

# The JAX trainer cannot train with dropout either: its step applies the
# module with training=True and no "dropout" PRNG stream, so flax's
# nn.Dropout raises (segmantic_tpu/train/trainer.py:393-400). Eval forwards
# with dropout > 0 are the identity in both packages.
DROPOUT_REFUSAL = (
    "training with dropout > 0 is refused, as the JAX trainer refuses it: its train "
    "step applies the module with no 'dropout' PRNG stream "
    "(segmantic_tpu/train/trainer.py:393-400), so flax's nn.Dropout raises")


def _lecun_normal_(w: torch.Tensor, fan_in: int, generator) -> None:
    """flax's default kernel init: truncated normal, variance 1/fan_in."""
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)


class Conv(nn.Module):
    """``nd``-D conv with XLA-SAME padding (flax ``Conv_0``); weight (O, I, *k)."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int, stride: int,
                 generator: Optional[torch.Generator] = None, nd: int = 3):
        super().__init__()
        k = kernel_size
        self.stride = stride
        self.nd = nd
        self.weight = nn.Parameter(torch.empty((c_out, c_in) + (k,) * nd))
        self.bias = nn.Parameter(torch.zeros(c_out))
        with torch.no_grad():
            _lecun_normal_(self.weight, c_in * k**nd, generator)

    def dhwio(self) -> torch.Tensor:
        """The kernel as flax stores it: (*k, I, O)."""
        return self.weight.permute(*range(2, 2 + self.nd), 1, 0)

    def forward(self, x, phase: bool = False):
        """``phase``: x is a phase-major tensor (B, *S, 2^nd * C) and the conv
        runs on the volume it stands for (same parameters)."""
        w = self.dhwio().to(x.dtype)
        b = self.bias.to(x.dtype)
        tp = self.__dict__.get("tp")  # a column-parallel share (parallel.shard_params)
        if tp is not None:
            if phase:
                raise ValueError("a phase-space conv is never sharded "
                                 "(tp_placement keeps the phase region whole)")
            return tp.column(x, lambda v: self._conv(v, w, None, False)) + b
        return self._conv(x, w, b, phase)

    def _conv(self, x, w, b, phase: bool):
        """The conv on x with kernel w (*k, I, O) and bias b (None: none, never
        in phase space), by the route of its shape: kernels 1-2 for a
        stride-1 3^3 conv in 3D, kernels 3-6 in phase space, XLA-SAME
        ``F.conv`` otherwise; a 1^nd kernel in phase space is the
        block-diagonal product of ``phase_pointwise_conv``. A phase-space
        conv from one true channel (packed UNETR's input layer) in f32 runs
        on the CUDA-core phase bodies: 7.16 ms a step's forward and weight
        gradient at 8 x 96^3 x 1 -> 16, against cuDNN's 2.98 ms on the
        full-resolution view with TF32 and 108.1 ms without (PERF.md);
        bf16 takes the few-channel bodies (0.25 ms)."""
        if phase and w.shape[0] == 1:
            return phase_pointwise_conv(x, w, b)
        if self.nd == 3:
            if phase:
                return phase_conv_grad(x, w) + tile_phase(b)
            if self.stride == 1 and w.shape[:3] == (3, 3, 3):
                y = conv3d_grad(x, w)
                return y if b is None else y + b
        elif phase:
            return phase_conv_s1_plain(x, w) + tile_phase(b, self.nd)
        return conv_same(x, w, b, self.stride)


class ConvTranspose(nn.Module):
    """flax SAME stride-2 conv-transpose (``ConvTranspose_0``), ``nd``-D.

    ``weight`` is in torch's ``ConvTranspose{nd}d`` layout (Ci, Co, *k) and
    already spatially flipped: flax's SAME transpose (no kernel flip) equals
    torch's unpadded transposed conv with the flipped kernel, cropped to the
    first ``stride * N`` outputs per axis."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int, stride: int,
                 generator: Optional[torch.Generator] = None, nd: int = 3):
        super().__init__()
        k = kernel_size
        self.stride = stride
        self.nd = nd
        self.weight = nn.Parameter(torch.empty((c_in, c_out) + (k,) * nd))
        self.bias = nn.Parameter(torch.zeros(c_out))
        with torch.no_grad():
            # flax's ConvTranspose fan-in is the kernel's in-axis size * k^nd
            _lecun_normal_(self.weight, c_in * k**nd, generator)

    def dhwio(self) -> torch.Tensor:
        """The kernel as flax stores it: (*k, Ci, Co), unflipped."""
        spatial = tuple(range(2, 2 + self.nd))
        return self.weight.flip(spatial).permute(*spatial, 0, 1)

    def forward(self, x, phase_out: bool = False):
        """``phase_out``: return the phase-major tensor (B, *S, 2^nd * Co) of
        the 2x-upsampled output at input resolution (subpixel factorisation,
        stride 2, kernel 3 or 2)."""
        tp = self.__dict__.get("tp")  # a column-parallel share (parallel.shard_params)
        if phase_out:
            if tp is not None:
                raise ValueError("a phase-space conv-transpose is never sharded "
                                 "(tp_placement keeps the phase region whole)")
            subpixel = subpixel_phase_conv_k2 if self.weight.shape[-1] == 2 else \
                subpixel_phase_conv
            y = subpixel(x, self.dhwio().to(x.dtype))
            return y + tile_phase(self.bias.to(x.dtype), self.nd)
        if tp is not None:
            return tp.column(x, lambda v: self._conv_t(v, None)) + self.bias.to(x.dtype)
        return self._conv_t(x, self.bias.to(x.dtype))

    def _conv_t(self, x, b):
        n = x.shape[1:-1]
        s = self.stride
        conv_t = F.conv_transpose3d if self.nd == 3 else F.conv_transpose2d
        y = conv_t(x.movedim(-1, 1), self.weight.to(x.dtype), b, stride=s)
        y = y[(slice(None), slice(None)) + tuple(slice(0, s * m) for m in n)]
        return y.movedim(1, -1)


class BatchNorm(nn.Module):
    """BatchNorm over the last (channel) axis, eps 1e-5, as flax computes it.

    Training: mean and variance of the batch in f32 or wider (``E[x^2] - E[x]^2``,
    clipped at 0: the biased variance), normalisation in f32, output in x's
    dtype, and the running statistics updated in place as
    ``0.9 * old + 0.1 * batch`` with the biased variance (torch's
    ``F.batch_norm`` would use the unbiased one). ``groups > 1``: x is
    phase-major (…, groups * C) and the statistics are per true channel over
    the phases (the JAX ``Norm.phase_groups``). With a process ``group`` set
    (:func:`cross_rank_norm`) the training statistics are those of the
    batches of all the group's ranks together."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.frozen = False  # see frozen_running_stats
        self.group = None  # see cross_rank_norm

    def _group_moments(self, xf, axes):
        """Mean and biased variance over the batch of every rank of
        ``self.group``: the per-channel sum, sum of squares and count in one
        ``all_reduce`` of one packed vector, the gradient flowing back through
        it to every rank (flax's ``BatchNorm(axis_name=...)``)."""
        count = xf.new_full((1,), xf.numel() // xf.shape[-1])
        total, squares, count = all_reduce_sum([xf.sum(axes), (xf * xf).sum(axes), count],
                                               self.group)
        mean = total / count
        var = torch.clamp_min(squares / count - mean * mean, 0.0)
        return mean, var

    def forward(self, x, groups: int = 1):
        shape = x.shape
        if groups > 1:
            x = x.reshape(shape[:-1] + (groups, shape[-1] // groups))
        xf = at_least_f32(x)
        if self.training:
            axes = tuple(range(x.ndim - 1))
            if self.group is None:
                mean = xf.mean(axes)
                var = torch.clamp_min((xf * xf).mean(axes) - mean * mean, 0.0)
            else:
                mean, var = self._group_moments(xf, axes)
            if not self.frozen:
                with torch.no_grad():
                    m = BN_MOMENTUM
                    self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                    self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        y = (xf - mean) * (torch.rsqrt(var + BN_EPS) * self.weight) + self.bias
        return y.to(x.dtype).reshape(shape)


@contextlib.contextmanager
def frozen_running_stats(module: nn.Module):
    """Within the block the BatchNorms of ``module`` normalise as before but
    leave their running statistics alone: the recomputed forward of a
    rematerialised step (``torch.utils.checkpoint``) must not update them a
    second time (the JAX package takes ``batch_stats`` from the primal only)."""
    norms = [m for m in module.modules() if isinstance(m, BatchNorm)]
    for m in norms:
        m.frozen = True
    try:
        yield
    finally:
        for m in norms:
            m.frozen = False


@contextlib.contextmanager
def cross_rank_norm(module: nn.Module, group):
    """Within the block the BatchNorms of ``module`` reduce their training
    statistics over the ranks of ``group`` (None: this rank's batch alone).
    The data-parallel step holds it over its forward and backward, so a
    rematerialised forward reduces again, in the same order on every rank."""
    norms = [m for m in module.modules() if isinstance(m, BatchNorm)]
    for m in norms:
        m.group = group
    try:
        yield
    finally:
        for m in norms:
            m.group = None


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm`` (eps 1e-5) over the last (channel) axis: channel
    c is in group ``c // (C / groups)``; mean and ``E[x^2] - E[x]^2`` (clipped
    at 0) in f32 or wider over all non-batch positions of a group, the
    normalisation in that type, output in x's dtype. ``phase_groups > 1``: x
    is phase-major (…, phase_groups * C) and the phases are reduced too (the
    same values as the full-resolution layout)."""

    def __init__(self, c: int, groups: int):
        super().__init__()
        if c % groups:
            raise ValueError(f"{groups} groups do not divide {c} channels")
        self.groups = groups
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x, phase_groups: int = 1):
        c, g = self.weight.shape[0], self.groups
        shape = x.shape
        xf = at_least_f32(x).reshape(shape[0], -1, phase_groups, g, c // g)
        axes = (1, 2, 4)
        mean = xf.mean(axes, keepdim=True)
        var = torch.clamp_min((xf * xf).mean(axes, keepdim=True) - mean * mean, 0.0)
        mul = torch.rsqrt(var + BN_EPS) * self.weight.reshape(g, c // g)
        y = (xf - mean) * mul + self.bias.reshape(g, c // g)
        return y.to(x.dtype).reshape(shape)


class Norm(nn.Module):
    """The JAX package's ``Norm`` for INSTANCE (one group a channel) and GROUP
    (min(8, C) groups): a flax ``GroupNorm_0`` inside, so its parameters sit at
    ``Norm_k/GroupNorm_0/{scale,bias}`` as in the flax tree. (BATCH is
    :class:`BatchNorm` itself, whose keys the UNet's checkpoints already use;
    see :func:`make_norm`.)"""

    def __init__(self, c: int, kind: str):
        super().__init__()
        kind = kind.upper()
        self.GroupNorm_0 = GroupNorm(c, c if kind == "INSTANCE" else min(8, c))

    def forward(self, x, groups: int = 1):
        return self.GroupNorm_0(x, phase_groups=groups)


def make_norm(kind: str, c: int) -> Optional[nn.Module]:
    """The norm of kind BATCH, INSTANCE, GROUP or NONE (None) over c channels;
    ``forward(x, groups=1)`` either way, ``groups`` the phases of a
    phase-major x (the JAX ``Norm.phase_groups``)."""
    kind = kind.upper()
    if kind == "BATCH":
        return BatchNorm(c)
    if kind in ("INSTANCE", "GROUP"):
        return Norm(c, kind)
    if kind == "NONE":
        return None
    raise ValueError(f"unsupported norm {kind!r}")


def activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """The JAX package's ``_activation`` without PRELU, which has a parameter
    (:class:`PReLU`): RELU, LEAKYRELU (slope 0.01), GELU (flax's ``nn.gelu``
    is the tanh approximation) and TANH, in x's dtype."""
    name = name.upper()
    if name == "RELU":
        return lambda x: torch.clamp_min(x, 0)
    if name == "LEAKYRELU":
        return lambda x: F.leaky_relu(x, 0.01)
    if name == "GELU":
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "TANH":
        return torch.tanh
    raise ValueError(f"unsupported activation {name!r}")


class PReLU(nn.Module):
    """PReLU with one slope (torch default init 0.25, what MONAI uses)."""

    def __init__(self, init: float = 0.25):
        super().__init__()
        self.weight = nn.Parameter(torch.full((1,), init))

    def forward(self, x):
        return torch.where(x >= 0, x, self.weight.to(x.dtype) * x)


class ConvUnit(nn.Module):
    """conv (optionally strided / transposed) -> norm -> activation."""

    def __init__(self, c_in: int, c_out: int, *, kernel_size: int = 3,
                 strides: int = 1, transposed: bool = False,
                 conv_only: bool = False, norm: str = "BATCH",
                 act: str = "PRELU", generator=None, nd: int = 3):
        super().__init__()
        conv_cls = ConvTranspose if transposed else Conv
        name = "ConvTranspose_0" if transposed else "Conv_0"
        self.transposed = transposed
        self.conv_only = conv_only
        self.act = act.upper()
        self.add_module(name, conv_cls(c_in, c_out, kernel_size, strides, generator, nd))
        if not conv_only:
            norm_module = make_norm(norm, c_out)
            if norm_module is not None:
                self.Norm_0 = norm_module
            if self.act == "PRELU":
                self.PReLU_0 = PReLU()
            else:
                self.act_fn = activation(self.act)

    @property
    def conv(self):
        return self.ConvTranspose_0 if self.transposed else self.Conv_0

    @property
    def norm(self) -> Optional[nn.Module]:
        return getattr(self, "Norm_0", None)

    def forward(self, x, phase: str = ""):
        """``phase``: '' the ordinary layout; 'out' (transposed only) emits a
        phase tensor; 'both' consumes and emits one (the JAX ConvUnit's
        modes). Norm statistics stay per true channel either way."""
        if self.transposed:
            x = self.conv(x, phase_out=phase in ("out", "both"))
        else:
            x = self.conv(x, phase=phase in ("in", "both"))
        if self.conv_only:
            return x
        if self.norm is not None:
            x = self.norm(x, groups=2 ** (x.ndim - 2) if phase else 1)
        if self.act == "PRELU":
            return self.PReLU_0(x)
        return self.act_fn(x)


class ResidualUnit(nn.Module):
    """``subunits`` conv units with a (projected) residual shortcut; the first
    subunit carries the stride, the shortcut is a kernel-size (1x1x1 when
    unstrided) conv whenever shape or channels change."""

    def __init__(self, c_in: int, c_out: int, *, strides: int = 1,
                 kernel_size: int = 3, subunits: int = 2,
                 last_conv_only: bool = False, norm: str = "BATCH",
                 act: str = "PRELU", generator=None, nd: int = 3):
        super().__init__()
        self.subunits = max(1, subunits)
        self.strides = strides
        c = c_in
        for i in range(self.subunits):
            self.add_module(f"ConvUnit_{i}", ConvUnit(
                c, c_out, kernel_size=kernel_size,
                strides=strides if i == 0 else 1,
                conv_only=last_conv_only and i == self.subunits - 1,
                norm=norm, act=act, generator=generator, nd=nd,
            ))
            c = c_out
        if strides != 1 or c_in != c_out:
            rk = kernel_size if strides != 1 else 1
            self.Conv_0 = Conv(c_in, c_out, rk, strides, generator, nd)

    def units(self) -> List[ConvUnit]:
        return [getattr(self, f"ConvUnit_{i}") for i in range(self.subunits)]

    @property
    def projection(self) -> Optional[Conv]:
        return getattr(self, "Conv_0", None)

    def forward(self, x, phase: bool = False):
        """``phase``: phase tensor in and out (stride 1, identity shortcut)."""
        y = x
        for unit in self.units():
            y = unit(y, phase="both" if phase else "")
        residual = x if self.projection is None else self.projection(x)
        return y + residual


class UNet(nn.Module):
    """Residual 2D / 3D UNet with skip concatenation (channel-last in and out).

    Defaults are the reference's flagship: channels (16, 32, 64, 128, 256),
    strides (2, 2, 2, 2), 2 residual units, BatchNorm, PReLU."""

    def __init__(self, spatial_dims: int = 3, in_channels: int = 1,
                 out_channels: int = 2,
                 channels: Sequence[int] = (16, 32, 64, 128, 256),
                 strides: Sequence[int] = (2, 2, 2, 2), num_res_units: int = 2,
                 norm: str = "BATCH", act: str = "PRELU", dropout: float = 0.0,
                 kernel_size: int = 3, up_kernel_size: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if spatial_dims not in (2, 3):
            raise ValueError(f"spatial_dims must be 2 or 3, got {spatial_dims}")
        channels, strides = list(channels), list(strides)
        if len(channels) < 2 or len(strides) != len(channels) - 1:
            raise ValueError("need len(channels) >= 2 and len(strides) == len(channels) - 1")
        self.spatial_dims = spatial_dims
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.channels = tuple(channels)
        self.strides = tuple(strides)
        self.num_res_units = num_res_units
        self.norm = norm.upper()
        self.act = act.upper()
        self.dropout = dropout  # the identity in eval; training raises DROPOUT_REFUSAL
        self.kernel_size = kernel_size
        self.up_kernel_size = up_kernel_size

        counters = {"ResidualUnit": 0, "ConvUnit": 0}
        order: List[str] = []

        def add(kind: str, module: nn.Module) -> None:
            name = f"{kind}_{counters[kind]}"
            counters[kind] += 1
            self.add_module(name, module)
            order.append(name)

        common = dict(norm=norm, act=act, generator=generator, nd=spatial_dims)

        def down(c_in, c_out, s):
            if num_res_units > 0:
                add("ResidualUnit", ResidualUnit(
                    c_in, c_out, strides=s, kernel_size=kernel_size,
                    subunits=num_res_units, **common))
            else:
                add("ConvUnit", ConvUnit(c_in, c_out, kernel_size=kernel_size,
                                         strides=s, **common))

        c = in_channels
        for ch, s in zip(channels[:-1], strides):
            down(c, ch, s)
            c = ch
        down(c, channels[-1], 1)
        c = channels[-1]
        for level in reversed(range(len(strides))):
            is_top = level == 0
            feats = out_channels if is_top else channels[level - 1]
            add("ConvUnit", ConvUnit(
                channels[level] + c, feats, kernel_size=up_kernel_size,
                strides=strides[level], transposed=True,
                conv_only=is_top and num_res_units == 0, **common))
            if num_res_units > 0:
                add("ResidualUnit", ResidualUnit(
                    feats, feats, strides=1, kernel_size=kernel_size,
                    subunits=1, last_conv_only=is_top, **common))
            c = feats
        self.order = tuple(order)  # creation order == flax auto-naming order

    def encoder(self) -> List[nn.Module]:
        n = len(self.strides) + 1
        return [getattr(self, name) for name in self.order[:n]]

    def decoder(self) -> List[List[nn.Module]]:
        """Per level, deepest first: [up ConvUnit(, ResidualUnit)]."""
        n = len(self.strides) + 1
        rest = [getattr(self, name) for name in self.order[n:]]
        step = 2 if self.num_res_units > 0 else 1
        return [rest[i:i + step] for i in range(0, len(rest), step)]

    def phase_stage_ok(self, out_feats: int, strides: int) -> bool:
        """Run this decoder stage in subpixel phase space? The JAX package's
        ``models/unet.py::phase_stage_ok`` without its environment knobs (the
        train graph and the eval executor both consult it)."""
        return (
            self.num_res_units > 0
            and self.dropout == 0.0
            and strides == 2
            and self.kernel_size == 3
            and self.up_kernel_size == 3
            and (2**self.spatial_dims) * out_feats <= PHASE_MAX
        )

    def phase_top_ok(self) -> bool:
        """Does the top decoder stage run in phase space? (Decidable from the
        configuration; the train step's phase-major Dice consults it.)"""
        return self.phase_stage_ok(self.out_channels, self.strides[0])

    def forward(self, x: torch.Tensor, phase_logits: bool = False) -> torch.Tensor:
        """Logits (N, *S, classes). With ``phase_logits`` the output stays
        phase-major at half resolution, (N, *S/2, 2^nd * classes),
        ``depth_to_space`` of which is the ordinary output (even sizes)."""
        if x.ndim != self.spatial_dims + 2:
            raise ValueError(f"expected (N, *spatial[{self.spatial_dims}], C) input, "
                             f"got {tuple(x.shape)}")
        if self.training and self.dropout > 0:
            raise NotImplementedError(DROPOUT_REFUSAL)
        enc = self.encoder()
        skips = []
        y = x
        for unit in enc[:-1]:
            y = unit(y)
            skips.append(y)
        y = enc[-1](y)
        for level, units in zip(reversed(range(len(self.strides))), self.decoder()):
            y = torch.cat([skips[level], y], dim=-1)
            is_top = level == 0
            feats = self.out_channels if is_top else self.channels[level - 1]
            if self.phase_stage_ok(feats, self.strides[level]):
                up, ru = units
                y = ru(up(y, phase="out"), phase=True)
                if is_top and phase_logits:
                    return y
                y = depth_to_space(y, feats)
                continue
            for unit in units:
                y = unit(y)
        if phase_logits:
            if any(s % 2 for s in y.shape[1:-1]):
                raise ValueError("phase_logits=True requires even output spatial "
                                 f"dims, got {tuple(y.shape[1:-1])}")
            y = space_to_depth(y)
        return y


# -- flax variables <-> torch state_dict -------------------------------------


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


# Which flax module a parameter sits in, from its module names alone (the
# same rule both ways): the BatchNorm inside the JAX ``Norm_k``, the slopes of
# ``PReLU_k``, the scale / bias of a GroupNorm or LayerNorm (UNETR's
# ``encoder_norm`` is one), ``Dense_k`` (kernel (in, out) <-> weight (out,
# in)), the projections of ``MultiHeadDotProductAttention_k`` (kept in flax's
# shapes), conv-transposes (the UNet's ``ConvTranspose_0``, UNETR's ``deconv``,
# SegResNet's ``up_j``) and, for every other kernel, a conv.
_BN_MODULE = re.compile(r"Norm_\d+$")
_PRELU = re.compile(r"PReLU_\d+$")
_SCALE_BIAS = re.compile(r"(GroupNorm_\d+|LayerNorm_\d+|encoder_norm)$")
_DENSE = re.compile(r"Dense_\d+$")
_ATTENTION = re.compile(r"MultiHeadDotProductAttention_\d+$")
_TRANSPOSED = re.compile(r"(ConvTranspose_0|deconv|up_\d+)$")


def _kernel_kind(mods: Sequence[str]) -> str:
    last = mods[-1] if mods else ""
    if _DENSE.match(last):
        return "dense"
    if len(mods) > 1 and _ATTENTION.match(mods[-2]):
        return "attention"
    if _TRANSPOSED.match(last):
        return "transposed"
    return "conv"


def from_flax_variables(variables: Dict) -> Dict[str, np.ndarray]:
    """flax ``{"params", "batch_stats"}`` tree -> torch ``state_dict`` (numpy).

    Conv kernels go (*k, I, O) -> (O, I, *k) (DHWIO -> OIDHW in 3D, HWIO ->
    OIHW in 2D); transposed-conv kernels (*k, Ci, Co) -> the flipped
    (Ci, Co, *k) layout of :class:`ConvTranspose`; Dense kernels
    (in, out) -> (out, in); attention projections keep flax's shapes;
    BatchNorm scale/bias/mean/var -> weight/bias/running_mean/running_var;
    GroupNorm / LayerNorm scale -> weight; PReLU alpha -> weight; UNETR's
    ``pos_embed`` as it is."""
    out: Dict[str, np.ndarray] = {}
    for path, leaf in _flatten(variables.get("params", {})):
        arr = np.asarray(leaf)
        *mods, name = path
        last = mods[-1] if mods else ""
        if last == "BatchNorm_0" or _SCALE_BIAS.match(last):
            if last == "BatchNorm_0":
                mods = mods[:-1]
            name = {"scale": "weight", "bias": "bias"}[name]
        elif _PRELU.match(last):
            name = {"alpha": "weight"}[name]
        elif name == "kernel":
            kind = _kernel_kind(mods)
            if kind == "dense":
                arr = arr.T
            elif kind == "transposed":
                nd = arr.ndim - 2
                arr = arr[(slice(None, None, -1),) * nd].transpose(nd, nd + 1, *range(nd))
            elif kind == "conv":
                nd = arr.ndim - 2
                arr = arr.transpose(nd + 1, nd, *range(nd))
            name = "weight"
        elif name not in ("bias", "pos_embed"):
            raise KeyError(f"unknown flax parameter {'/'.join(path)}")
        out[".".join(mods + [name])] = np.ascontiguousarray(arr)
    for path, leaf in _flatten(variables.get("batch_stats", {})):
        *mods, name = path
        if not mods or mods[-1] != "BatchNorm_0":
            raise KeyError(f"unknown flax statistic {'/'.join(path)}")
        name = {"mean": "running_mean", "var": "running_var"}[name]
        out[".".join(mods[:-1] + [name])] = np.ascontiguousarray(leaf)
    return out


def to_flax_variables(state_dict: Dict) -> Dict[str, Dict]:
    """Inverse of :func:`from_flax_variables` (tensors or arrays in)."""
    params: Dict = {}
    stats: Dict = {}

    def put(tree, path, value):
        for p in path[:-1]:
            tree = tree.setdefault(p, {})
        tree[path[-1]] = value

    for key, value in state_dict.items():
        arr = value.detach().cpu().numpy() if torch.is_tensor(value) else np.asarray(value)
        *mods, name = key.split(".")
        last = mods[-1] if mods else ""
        if _BN_MODULE.match(last):
            if name in ("running_mean", "running_var"):
                put(stats, mods + ["BatchNorm_0", name[len("running_"):]], arr)
            else:
                put(params, mods + ["BatchNorm_0", {"weight": "scale", "bias": "bias"}[name]], arr)
        elif _SCALE_BIAS.match(last):
            put(params, mods + [{"weight": "scale", "bias": "bias"}[name]], arr)
        elif _PRELU.match(last):
            put(params, mods + ["alpha"], arr)
        elif name == "weight":
            kind = _kernel_kind(mods)
            if kind == "dense":
                arr = arr.T
            elif kind == "transposed":
                nd = arr.ndim - 2
                arr = arr.transpose(*range(2, 2 + nd), 0, 1)[(slice(None, None, -1),) * nd]
            elif kind == "conv":
                nd = arr.ndim - 2
                arr = arr.transpose(*range(2, 2 + nd), 1, 0)
            put(params, mods + ["kernel"], np.ascontiguousarray(arr))
        elif name in ("bias", "pos_embed"):
            put(params, mods + [name], arr)
        else:
            raise KeyError(f"unknown state_dict entry {key}")
    return {"params": params, "batch_stats": stats}
