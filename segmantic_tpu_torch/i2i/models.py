"""Image-to-image translation models (pix2pix / CycleGAN) as torch modules.

Port of ``segmantic_tpu/i2i/models.py``: the instance-norm ResNet generator
(c7s1-f, d2f, d4f, R4f x n_blocks, u2f, uf, c7s1-out + tanh) and the PatchGAN
discriminator, 2D or 3D, channel-last (B, *S, C) in and out. The convs are
the port's :class:`~segmantic_tpu_torch.models.unet.Conv` /
:class:`~segmantic_tpu_torch.models.unet.ConvTranspose`: XLA-SAME padding,
flax's unflipped SAME conv-transpose and its ``lecun_normal`` init. In 3D
the stride-1 3^3 convs of the ResNet blocks run through kernel 1 (and 2 in
the backward) on the card, as every stride-1 3^3 conv of the port does; the
7^k, 4^k and strided convs and the conv-transposes are cuDNN, as the JAX
package leaves all of i2i to XLA.

The submodules carry flax's auto-names (``Conv_0``, ``InstanceNorm_0``,
``ResnetBlock_0``, ``ConvTranspose_1``, ...), so a ``state_dict`` key reads
as the flax path; :func:`from_flax_variables` / :func:`to_flax_variables`
convert the generator's and the discriminator's trees.
"""

from __future__ import annotations

import re
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.unet import Conv, ConvTranspose

__all__ = [
    "InstanceNorm", "ResnetBlock", "ResnetGenerator", "PatchDiscriminator",
    "from_flax_variables", "to_flax_variables",
]


class InstanceNorm(nn.Module):
    """Per sample and channel over the spatial axes: mean and biased variance,
    ``(x - mean) / sqrt(var + eps) * scale + bias``, in x's dtype. The
    parameters keep flax's names, ``scale`` and ``bias``."""

    def __init__(self, c: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        axes = tuple(range(1, x.ndim - 1))
        mean = x.mean(axes, keepdim=True)
        var = x.var(axes, keepdim=True, correction=0)
        y = (x - mean) / torch.sqrt(var + self.eps)
        return y * self.scale.to(x.dtype) + self.bias.to(x.dtype)


class ResnetBlock(nn.Module):
    """conv3-IN-ReLU-conv3-IN plus the identity."""

    def __init__(self, features: int, nd: int = 2, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.Conv_0 = Conv(features, features, 3, 1, generator, nd)
        self.InstanceNorm_0 = InstanceNorm(features)
        self.Conv_1 = Conv(features, features, 3, 1, generator, nd)
        self.InstanceNorm_1 = InstanceNorm(features)

    def forward(self, x):
        y = F.relu(self.InstanceNorm_0(self.Conv_0(x)))
        return x + self.InstanceNorm_1(self.Conv_1(y))


class ResnetGenerator(nn.Module):
    """c7s1-f, d2f, d4f, R4f x n_blocks, u2f, uf, c7s1-out + tanh.

    ``in_channels`` and ``spatial_dims`` are what flax infers from the input
    at ``init``; the spatial sizes must be multiples of 4."""

    def __init__(self, in_channels: int, out_channels: int = 1, base_features: int = 64,
                 n_blocks: int = 6, spatial_dims: int = 2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        nd, f = spatial_dims, base_features
        self.n_blocks = n_blocks
        self.Conv_0 = Conv(in_channels, f, 7, 1, generator, nd)
        self.InstanceNorm_0 = InstanceNorm(f)
        self.Conv_1 = Conv(f, 2 * f, 3, 2, generator, nd)
        self.InstanceNorm_1 = InstanceNorm(2 * f)
        self.Conv_2 = Conv(2 * f, 4 * f, 3, 2, generator, nd)
        self.InstanceNorm_2 = InstanceNorm(4 * f)
        for i in range(n_blocks):
            setattr(self, f"ResnetBlock_{i}", ResnetBlock(4 * f, nd, generator))
        self.ConvTranspose_0 = ConvTranspose(4 * f, 2 * f, 3, 2, generator, nd)
        self.InstanceNorm_3 = InstanceNorm(2 * f)
        self.ConvTranspose_1 = ConvTranspose(2 * f, f, 3, 2, generator, nd)
        self.InstanceNorm_4 = InstanceNorm(f)
        self.Conv_3 = Conv(f, out_channels, 7, 1, generator, nd)

    def forward(self, x):
        y = F.relu(self.InstanceNorm_0(self.Conv_0(x)))
        y = F.relu(self.InstanceNorm_1(self.Conv_1(y)))
        y = F.relu(self.InstanceNorm_2(self.Conv_2(y)))
        for i in range(self.n_blocks):
            y = getattr(self, f"ResnetBlock_{i}")(y)
        y = F.relu(self.InstanceNorm_3(self.ConvTranspose_0(y)))
        y = F.relu(self.InstanceNorm_4(self.ConvTranspose_1(y)))
        return torch.tanh(self.Conv_3(y))


class PatchDiscriminator(nn.Module):
    """70x70 PatchGAN: C64-C128-C256-C512 -> 1-channel patch logits (for
    ``n_layers`` 3; 4^k kernels, leaky ReLU 0.2, no norm after the first)."""

    def __init__(self, in_channels: int, base_features: int = 64, n_layers: int = 3,
                 spatial_dims: int = 2, generator: Optional[torch.Generator] = None):
        super().__init__()
        nd, f = spatial_dims, base_features
        self.n_layers = n_layers
        self.Conv_0 = Conv(in_channels, f, 4, 2, generator, nd)
        for i in range(1, n_layers):
            setattr(self, f"Conv_{i}", Conv(f * 2 ** (i - 1), f * 2 ** i, 4, 2, generator, nd))
            setattr(self, f"InstanceNorm_{i - 1}", InstanceNorm(f * 2 ** i))
        top = f * 2 ** n_layers
        setattr(self, f"Conv_{n_layers}", Conv(f * 2 ** (n_layers - 1), top, 4, 1, generator, nd))
        setattr(self, f"InstanceNorm_{n_layers - 1}", InstanceNorm(top))
        setattr(self, f"Conv_{n_layers + 1}", Conv(top, 1, 4, 1, generator, nd))

    def forward(self, x):
        y = F.leaky_relu(self.Conv_0(x), 0.2)
        for i in range(1, self.n_layers + 1):
            conv, norm = getattr(self, f"Conv_{i}"), getattr(self, f"InstanceNorm_{i - 1}")
            y = F.leaky_relu(norm(conv(y)), 0.2)
        return getattr(self, f"Conv_{self.n_layers + 1}")(y)


# -- flax variables <-> torch state_dict -------------------------------------
# i2i's own bridge: the UNet's (models/unet.py) takes only ``ConvTranspose_0``
# as a transposed conv and knows no ``InstanceNorm_k``.

_CONV = re.compile(r"Conv_\d+$")
_TRANSPOSED = re.compile(r"ConvTranspose_\d+$")
_NORM = re.compile(r"InstanceNorm_\d+$")


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def from_flax_variables(variables: Dict) -> Dict[str, np.ndarray]:
    """flax ``{"params": ...}`` of a generator or discriminator -> torch
    ``state_dict`` (numpy): conv kernels (*k, I, O) -> (O, I, *k),
    conv-transpose kernels (*k, Ci, Co) -> the flipped (Ci, Co, *k) of
    :class:`ConvTranspose`; biases and InstanceNorm ``scale`` / ``bias`` as
    they are."""
    out: Dict[str, np.ndarray] = {}
    for path, leaf in _flatten(variables["params"]):
        arr = np.asarray(leaf)
        *mods, name = path
        last = mods[-1] if mods else ""
        nd = arr.ndim - 2
        if name == "kernel" and _TRANSPOSED.match(last):
            flipped = arr[(slice(None, None, -1),) * nd]
            arr, name = flipped.transpose(nd, nd + 1, *range(nd)), "weight"
        elif name == "kernel" and _CONV.match(last):
            arr, name = arr.transpose(nd + 1, nd, *range(nd)), "weight"
        elif not (name == "bias" or (name == "scale" and _NORM.match(last))):
            raise KeyError(f"unknown flax parameter {'/'.join(path)}")
        out[".".join(mods + [name])] = np.ascontiguousarray(arr)
    return out


def to_flax_variables(state_dict: Dict) -> Dict[str, Dict]:
    """Inverse of :func:`from_flax_variables` (tensors or arrays in)."""
    params: Dict = {}
    for key, value in state_dict.items():
        arr = value.detach().cpu().numpy() if torch.is_tensor(value) else np.asarray(value)
        *mods, name = key.split(".")
        last = mods[-1] if mods else ""
        nd = arr.ndim - 2
        if name == "weight" and _TRANSPOSED.match(last):
            kernel = arr.transpose(*range(2, 2 + nd), 0, 1)
            arr, name = kernel[(slice(None, None, -1),) * nd], "kernel"
        elif name == "weight" and _CONV.match(last):
            arr, name = arr.transpose(*range(2, 2 + nd), 1, 0), "kernel"
        elif not (name == "bias" or (name == "scale" and _NORM.match(last))):
            raise KeyError(f"unknown state_dict entry {key}")
        tree = params
        for m in mods:
            tree = tree.setdefault(m, {})
        tree[name] = np.ascontiguousarray(arr)
    return {"params": params}
