"""Residual 3D UNet as torch modules: the training forward and the plain
eval math.

Port of ``segmantic_tpu/models/unet.py`` (MONAI-UNet topology: stride-2
residual encoder, transposed-conv decoder with skip concatenation, residual
units with projection shortcuts, BatchNorm, PReLU). The modules are named
like the flax auto-names (``ResidualUnit_i``, ``ConvUnit_j``, ``Conv_0``,
``ConvTranspose_0``, ``Norm_0``, ``PReLU_0``) so a ``state_dict`` key reads as
the flax path it came from; :func:`from_flax_variables` and
:func:`to_flax_variables` convert between the two.

``UNet.forward`` runs the JAX module's graph: channel-last (B, D, H, W, C) in
and out, XLA-SAME padding, parameters cast to the input's dtype at use, and
the narrow top decoder stages in subpixel phase space (``phase_stage_ok``),
optionally returning the top stage's phase-major logits (``phase_logits``).
In ``train()`` mode BatchNorm normalises by the batch statistics (in f32,
biased variance) and updates the running statistics as flax does; in
``eval()`` mode it uses the running statistics. Every stride-1 3^3 conv goes
through :func:`..ops.fused_conv.conv3d_grad` and every phase-space conv
through :func:`..ops.phase_conv.phase_conv_grad` (the hand-written kernels on
the card, their plain versions on the CPU); strided convs, conv-transposes
and 1x1 projections are ``F.conv3d`` / ``F.conv_transpose3d``, as the JAX
package leaves them to XLA. The folded, kernel-backed serving forward is
:mod:`segmantic_tpu_torch.infer.executor`, tested against this one.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.fast_conv import (
    conv3d_same, depth_to_space, space_to_depth, subpixel_phase_conv, tile_phase,
)
from ..ops.fused_conv import at_least_f32, conv3d_grad
from ..ops.phase_conv import phase_conv_grad

__all__ = [
    "UNet", "ResidualUnit", "ConvUnit", "Conv", "ConvTranspose", "BatchNorm",
    "PReLU", "from_flax_variables", "to_flax_variables",
]

BN_EPS = 1e-5
BN_MOMENTUM = 0.9  # flax's; torch's momentum 0.1
# phase-channel bound of the phase stages (8 * out_feats): the JAX package's
# default SEGMANTIC_PHASE_MAX, the head and the next stage
PHASE_MAX = 128


def _lecun_normal_(w: torch.Tensor, fan_in: int, generator) -> None:
    """flax's default kernel init: truncated normal, variance 1/fan_in."""
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)


class Conv(nn.Module):
    """3D conv with XLA-SAME padding (flax ``Conv_0``); weight OIDHW."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int, stride: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        k = kernel_size
        self.stride = stride
        self.weight = nn.Parameter(torch.empty(c_out, c_in, k, k, k))
        self.bias = nn.Parameter(torch.zeros(c_out))
        with torch.no_grad():
            _lecun_normal_(self.weight, c_in * k**3, generator)

    def dhwio(self) -> torch.Tensor:
        return self.weight.permute(2, 3, 4, 1, 0)

    def forward(self, x, phase: bool = False):
        """``phase``: x is a phase-major tensor (B, *S, 8*C) and the conv runs
        on the volume it stands for (same parameters)."""
        w = self.dhwio().to(x.dtype)
        b = self.bias.to(x.dtype)
        if phase:
            return phase_conv_grad(x, w) + tile_phase(b)
        if self.stride == 1 and w.shape[:3] == (3, 3, 3):
            return conv3d_grad(x, w) + b
        return conv3d_same(x, w, b, self.stride)


class ConvTranspose(nn.Module):
    """flax SAME stride-2 conv-transpose (``ConvTranspose_0``).

    ``weight`` is in torch's ``ConvTranspose3d`` layout (Ci, Co, k, k, k) and
    already spatially flipped: flax's SAME transpose (no kernel flip) equals
    torch's unpadded transposed conv with the flipped kernel, cropped to the
    first ``stride * N`` outputs per axis."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int, stride: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        k = kernel_size
        self.stride = stride
        self.weight = nn.Parameter(torch.empty(c_in, c_out, k, k, k))
        self.bias = nn.Parameter(torch.zeros(c_out))
        with torch.no_grad():
            # flax's ConvTranspose fan-in is the kernel's in-axis size * k^3
            _lecun_normal_(self.weight, c_in * k**3, generator)

    def dhwio(self) -> torch.Tensor:
        """The kernel as flax stores it: (k, k, k, Ci, Co), unflipped."""
        return self.weight.flip(2, 3, 4).permute(2, 3, 4, 0, 1)

    def forward(self, x, phase_out: bool = False):
        """``phase_out``: return the phase-major tensor (B, *S, 8*Co) of the
        2x-upsampled output at input resolution (subpixel factorisation,
        stride 2 kernel 3 only)."""
        if phase_out:
            y = subpixel_phase_conv(x, self.dhwio().to(x.dtype))
            return y + tile_phase(self.bias.to(x.dtype))
        n = x.shape[1:4]
        s = self.stride
        y = F.conv_transpose3d(x.permute(0, 4, 1, 2, 3), self.weight.to(x.dtype),
                               self.bias.to(x.dtype), stride=s)
        y = y[:, :, : s * n[0], : s * n[1], : s * n[2]]
        return y.permute(0, 2, 3, 4, 1)


class BatchNorm(nn.Module):
    """BatchNorm over the last (channel) axis, eps 1e-5, as flax computes it.

    Training: mean and variance of the batch in f32 or wider (``E[x^2] - E[x]^2``,
    clipped at 0: the biased variance), normalisation in f32, output in x's
    dtype, and the running statistics updated in place as
    ``0.9 * old + 0.1 * batch`` with the biased variance (torch's
    ``F.batch_norm`` would use the unbiased one). ``groups > 1``: x is
    phase-major (…, groups * C) and the statistics are per true channel over
    the phases (the JAX ``Norm.phase_groups``)."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x, groups: int = 1):
        shape = x.shape
        if groups > 1:
            x = x.reshape(shape[:-1] + (groups, shape[-1] // groups))
        xf = at_least_f32(x)
        if self.training:
            axes = tuple(range(x.ndim - 1))
            mean = xf.mean(axes)
            var = torch.clamp_min((xf * xf).mean(axes) - mean * mean, 0.0)
            with torch.no_grad():
                m = BN_MOMENTUM
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        y = (xf - mean) * (torch.rsqrt(var + BN_EPS) * self.weight) + self.bias
        return y.to(x.dtype).reshape(shape)


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
                 act: str = "PRELU", generator=None):
        super().__init__()
        conv_cls = ConvTranspose if transposed else Conv
        name = "ConvTranspose_0" if transposed else "Conv_0"
        self.transposed = transposed
        self.conv_only = conv_only
        self.act = act.upper()
        self.add_module(name, conv_cls(c_in, c_out, kernel_size, strides, generator))
        if not conv_only:
            if norm.upper() == "BATCH":
                self.Norm_0 = BatchNorm(c_out)
            if self.act == "PRELU":
                self.PReLU_0 = PReLU()

    @property
    def conv(self):
        return self.ConvTranspose_0 if self.transposed else self.Conv_0

    @property
    def norm(self) -> Optional[BatchNorm]:
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
            x = self.norm(x, groups=8 if phase else 1)
        if self.act == "PRELU":
            return self.PReLU_0(x)
        return torch.clamp_min(x, 0)


class ResidualUnit(nn.Module):
    """``subunits`` conv units with a (projected) residual shortcut; the first
    subunit carries the stride, the shortcut is a kernel-size (1x1x1 when
    unstrided) conv whenever shape or channels change."""

    def __init__(self, c_in: int, c_out: int, *, strides: int = 1,
                 kernel_size: int = 3, subunits: int = 2,
                 last_conv_only: bool = False, norm: str = "BATCH",
                 act: str = "PRELU", generator=None):
        super().__init__()
        self.subunits = max(1, subunits)
        self.strides = strides
        c = c_in
        for i in range(self.subunits):
            self.add_module(f"ConvUnit_{i}", ConvUnit(
                c, c_out, kernel_size=kernel_size,
                strides=strides if i == 0 else 1,
                conv_only=last_conv_only and i == self.subunits - 1,
                norm=norm, act=act, generator=generator,
            ))
            c = c_out
        if strides != 1 or c_in != c_out:
            rk = kernel_size if strides != 1 else 1
            self.Conv_0 = Conv(c_in, c_out, rk, strides, generator)

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
    """Residual 3D UNet with skip concatenation (channel-last in and out).

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
        if spatial_dims != 3:
            raise NotImplementedError("the port's UNet is 3D only (2D: ROADMAP Queue 1)")
        if norm.upper() not in ("BATCH", "NONE"):
            raise NotImplementedError(f"norm {norm!r}: the port has BATCH and NONE")
        if act.upper() not in ("PRELU", "RELU"):
            raise NotImplementedError(f"act {act!r}: the port has PRELU and RELU")
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
        self.dropout = dropout  # eval only: dropout is the identity (training raises)
        self.kernel_size = kernel_size
        self.up_kernel_size = up_kernel_size

        counters = {"ResidualUnit": 0, "ConvUnit": 0}
        order: List[str] = []

        def add(kind: str, module: nn.Module) -> None:
            name = f"{kind}_{counters[kind]}"
            counters[kind] += 1
            self.add_module(name, module)
            order.append(name)

        common = dict(norm=norm, act=act, generator=generator)

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
        ``models/unet.py::phase_stage_ok`` for 3D, without its environment
        knobs (the train graph and the eval executor both consult it)."""
        return (
            self.num_res_units > 0
            and self.dropout == 0.0
            and strides == 2
            and self.kernel_size == 3
            and self.up_kernel_size == 3
            and 8 * out_feats <= PHASE_MAX
        )

    def phase_top_ok(self) -> bool:
        """Does the top decoder stage run in phase space? (Decidable from the
        configuration; the train step's phase-major Dice consults it.)"""
        return self.phase_stage_ok(self.out_channels, self.strides[0])

    def forward(self, x: torch.Tensor, phase_logits: bool = False) -> torch.Tensor:
        """Logits (N, D, H, W, classes). With ``phase_logits`` the output
        stays phase-major at half resolution, (N, D/2, H/2, W/2, 8*classes),
        ``depth_to_space`` of which is the ordinary output (even sizes)."""
        if x.ndim != 5:
            raise ValueError(f"expected (N, D, H, W, C) input, got {tuple(x.shape)}")
        if self.training and self.dropout > 0:
            raise NotImplementedError(
                "training with dropout > 0 is not ported yet (ROADMAP Queue 1: "
                "train() extras)")
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
            if any(s % 2 for s in y.shape[1:4]):
                raise ValueError("phase_logits=True requires even output spatial "
                                 f"dims, got {tuple(y.shape[1:4])}")
            y = space_to_depth(y)
        return y


# -- flax variables <-> torch state_dict -------------------------------------


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def from_flax_variables(variables: Dict) -> Dict[str, np.ndarray]:
    """flax ``{"params", "batch_stats"}`` tree -> torch ``state_dict`` (numpy).

    Conv kernels go DHWIO -> OIDHW; transposed-conv kernels DHWIO -> the
    flipped (Ci, Co, k, k, k) layout of :class:`ConvTranspose`; BatchNorm
    scale/bias/mean/var -> weight/bias/running_mean/running_var; PReLU alpha ->
    weight."""
    out: Dict[str, np.ndarray] = {}
    for path, leaf in _flatten(variables.get("params", {})):
        arr = np.asarray(leaf)
        *mods, name = path
        if mods and mods[-1] == "BatchNorm_0":
            mods = mods[:-1]
            name = {"scale": "weight", "bias": "bias"}[name]
        elif mods and mods[-1] == "PReLU_0":
            name = {"alpha": "weight"}[name]
        elif name == "kernel" and mods[-1] == "ConvTranspose_0":
            arr, name = arr[::-1, ::-1, ::-1].transpose(3, 4, 0, 1, 2), "weight"
        elif name == "kernel":
            arr, name = arr.transpose(4, 3, 0, 1, 2), "weight"
        elif name != "bias":
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
        if last == "Norm_0":
            if name in ("running_mean", "running_var"):
                put(stats, mods + ["BatchNorm_0", name[len("running_"):]], arr)
            else:
                put(params, mods + ["BatchNorm_0", {"weight": "scale", "bias": "bias"}[name]], arr)
        elif last == "PReLU_0":
            put(params, mods + ["alpha"], arr)
        elif last == "ConvTranspose_0" and name == "weight":
            put(params, mods + ["kernel"],
                np.ascontiguousarray(arr.transpose(2, 3, 4, 0, 1)[::-1, ::-1, ::-1]))
        elif name == "weight":
            put(params, mods + ["kernel"], np.ascontiguousarray(arr.transpose(2, 3, 4, 1, 0)))
        elif name == "bias":
            put(params, mods + ["bias"], arr)
        else:
            raise KeyError(f"unknown state_dict entry {key}")
    return {"params": params, "batch_stats": stats}
