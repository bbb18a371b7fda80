"""Phase-space (subpixel) conv identities used by the eval forward.

Port of the subset of ``segmantic_tpu/ops/fast_conv.py`` that the folded
eval forward and the phase-space models run: the subpixel conv-transposes in
phase space (``subpixel_phase_conv``, kernel 3; ``subpixel_phase_conv_k2``,
kernel 2), the kernel-1 conv in phase space (``phase_pointwise_conv``), the
phase-major channel concat (``phase_concat``), the phase-major
``depth_to_space`` / ``space_to_depth`` pair, ``tile_phase`` and the
block-space expansion of a stride-1 3^3 kernel (``expand_s1_kernel``), plus
the XLA-SAME convs and conv-transposes the plain model uses.

Every function takes 2D or 3D tensors (the rank of x). Layouts follow the JAX
package: tensors are channel-last (B, *S, C), kernels (*k, I, O) (DHWIO in
3D), and a phase tensor (B, *S, 2^nd * C) orders its channels phase-major as
(pz, py, px, c) with c fastest (4 phases (py, px) in 2D).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "conv_same",
    "conv_transpose_same",
    "subpixel_phase_conv",
    "subpixel_phase_conv_k2",
    "phase_pointwise_conv",
    "phase_concat",
    "expand_s1_kernel",
    "phase_conv_s1_plain",
    "tile_phase",
    "depth_to_space",
    "space_to_depth",
]

_CONV = {2: F.conv2d, 3: F.conv3d}
_CONV_T = {2: F.conv_transpose2d, 3: F.conv_transpose3d}


def _channels_first(x: torch.Tensor) -> torch.Tensor:
    return x.movedim(-1, 1)


def _channels_last(x: torch.Tensor) -> torch.Tensor:
    return x.movedim(1, -1)


def _oi(w: torch.Tensor) -> torch.Tensor:
    """(*k, I, O) -> torch's (O, I, *k)."""
    nd = w.ndim - 2
    return w.permute(nd + 1, nd, *range(nd))


def _same_pads(size: int, k: int, s: int):
    """XLA SAME padding (lo, hi) for one axis; lo gets the smaller half."""
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def conv_same(x: torch.Tensor, w: torch.Tensor, bias=None, stride: int = 1):
    """XLA-SAME conv, 2D or 3D. x (B, *S, C); w (*k, C, CO), flax's layout.

    For stride 2, kernel 3 on even sizes XLA pads (0, 1), which torch's
    symmetric ``padding=1`` does not reproduce; the pads are applied here."""
    nd = x.ndim - 2
    k = w.shape[0]
    pads = []
    for size in reversed(x.shape[1:-1]):
        pads += list(_same_pads(size, k, stride))
    xp = F.pad(_channels_first(x), pads)
    return _channels_last(_CONV[nd](xp, _oi(w), bias=bias, stride=stride))


def conv_transpose_same(x: torch.Tensor, w: torch.Tensor, bias=None, stride: int = 2):
    """flax/lax SAME conv-transpose (no kernel flip), stride 2, kernel 3, 2D
    or 3D; w (*k, Ci, Co).

    Equals torch's transposed conv with the spatially flipped kernel and no
    padding, cropped to the first ``2 N`` outputs per axis."""
    nd = x.ndim - 2
    n = x.shape[1:-1]
    wt = w.flip(tuple(range(nd))).permute(nd, nd + 1, *range(nd))  # (Ci, Co, *k)
    y = _CONV_T[nd](_channels_first(x), wt, bias=bias, stride=stride)
    y = y[(slice(None), slice(None)) + tuple(slice(0, stride * m) for m in n)]
    return _channels_last(y)


@lru_cache(maxsize=None)
def _sel_transpose() -> np.ndarray:
    """S[a, p_out, t] for the stride-2 k3 SAME conv-transpose:
    y[2d] = w[0] x[d-1] + w[2] x[d],  y[2d+1] = w[1] x[d]."""
    s = np.zeros((2, 2, 3), np.float32)
    s[0, 0, 0] = 1.0
    s[1, 0, 2] = 1.0
    s[1, 1, 1] = 1.0
    return s


@lru_cache(maxsize=None)
def _sel_s1() -> np.ndarray:
    """V[a, p_in, p_out, t] for the stride-1 k3 SAME conv in block space:
    input 2(d+a-1)+pi meets output 2d+po at tap t = 2a + pi - po - 1."""
    v = np.zeros((3, 2, 2, 3), np.float32)
    for a in range(3):
        for pi in range(2):
            for po in range(2):
                t = 2 * a + pi - po - 1
                if 0 <= t < 3:
                    v[a, pi, po, t] = 1.0
    return v


def subpixel_phase_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Phase tensor (B, *S, 2^nd * Co) of the stride-2 k3 SAME conv-transpose
    of x (B, *S, Ci) with w (*3^nd, Ci, Co): a kernel-2 conv at input
    resolution with left padding 1 (``depth_to_space`` of it is the
    conv-transpose output)."""
    nd = x.ndim - 2
    ci, co = w.shape[-2], w.shape[-1]
    taps, blocks, phases = "tuv"[:nd], "abc"[:nd], "pqr"[:nd]
    sel = torch.as_tensor(_sel_transpose(), dtype=w.dtype, device=w.device)
    spec = (f"{taps}io," + ",".join(f"{b}{p}{t}" for b, p, t in zip(blocks, phases, taps))
            + f"->{blocks}i{phases}o")
    wsub = torch.einsum(spec, w, *([sel] * nd)).reshape((2,) * nd + (ci, 2**nd * co))
    xp = F.pad(_channels_first(x), (1, 0) * nd)
    return _channels_last(_CONV[nd](xp, _oi(wsub).to(x.dtype)))


def subpixel_phase_conv_k2(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Phase tensor (B, *S, 2^nd * Co) of the stride-2 kernel-2 SAME
    conv-transpose of x (B, *S, Ci) with w (*2^nd, Ci, Co), whose
    ``depth_to_space`` is the 2x upsampled output. Per axis
    ``y[2d + p] = w[1 - p] x[d]``: each output phase sees one tap, so the
    upsample is one (Ci -> 2^nd * Co) product with the spatially reversed
    kernel."""
    nd = x.ndim - 2
    ci, co = w.shape[-2], w.shape[-1]
    wr = w.flip(tuple(range(nd)))  # tap 1 - p feeds phase p
    wp = wr.permute((nd,) + tuple(range(nd)) + (nd + 1,)).reshape(ci, 2**nd * co)
    return torch.matmul(x, wp.to(x.dtype))


def phase_pointwise_conv(p: torch.Tensor, w: torch.Tensor, bias=None) -> torch.Tensor:
    """Kernel-1 conv (w (*1^nd, Ci, Co)) of the volume the phase tensor p
    (B, *S, 2^nd * Ci) stands for, as a phase tensor: block-diagonal over the
    phases, one shared (Ci -> Co) product on the (..., 2^nd, Ci) view."""
    nd = p.ndim - 2
    g = 2**nd
    ci, co = w.shape[-2], w.shape[-1]
    y = torch.matmul(p.reshape(p.shape[:-1] + (g, ci)), w.reshape(ci, co).to(p.dtype))
    y = y.reshape(p.shape[:-1] + (g * co,))
    if bias is not None:
        y = y + tile_phase(bias, nd).to(y.dtype)
    return y


def phase_concat(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Phase tensor of the channel concat of the volumes two phase tensors
    stand for: concat on the true-channel axis of the (..., 2^nd, C) views."""
    g = 2 ** (a.ndim - 2)
    ca, cb = a.shape[-1] // g, b.shape[-1] // g
    y = torch.cat([a.reshape(a.shape[:-1] + (g, ca)), b.reshape(b.shape[:-1] + (g, cb))],
                  dim=-1)
    return y.reshape(a.shape[:-1] + (g * (ca + cb),))


def expand_s1_kernel(w: torch.Tensor) -> torch.Tensor:
    """(*3^nd, Ci, Co) -> (*3^nd, 2^nd*Ci, 2^nd*Co): the stride-1 3^nd SAME
    conv as a block-space kernel-3 conv between phase tensors
    (``conv3(x) == d2s(conv_SAME(s2d(x), expand_s1_kernel(w)))``)."""
    nd = w.ndim - 2
    ci, co = w.shape[-2], w.shape[-1]
    taps, blocks, pin, pout = "tuv"[:nd], "abc"[:nd], "PQR"[:nd], "XYZ"[:nd]
    sel = torch.as_tensor(_sel_s1(), dtype=w.dtype, device=w.device)
    spec = (f"{taps}io,"
            + ",".join(f"{b}{i}{o}{t}" for b, i, o, t in zip(blocks, pin, pout, taps))
            + f"->{blocks}{pin}i{pout}o")
    wsub = torch.einsum(spec, w, *([sel] * nd))
    return wsub.reshape((3,) * nd + (2**nd * ci, 2**nd * co))


def phase_conv_s1_plain(p: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Stride-1 3^nd SAME conv applied in phase space as the expanded k3 conv
    (the JAX package's XLA path, ``fast_conv._phase_conv_xla_k3``), 2D or
    3D."""
    nd = p.ndim - 2
    wsub = expand_s1_kernel(w).to(p.dtype)
    return _channels_last(_CONV[nd](_channels_first(p), _oi(wsub), padding=1))


def tile_phase(v: torch.Tensor, nd: int = 3) -> torch.Tensor:
    """(C,) -> (2^nd * C,) phase-major (phases repeat the channel block)."""
    return v.repeat(2**nd)


def depth_to_space(p: torch.Tensor, c_out: int) -> torch.Tensor:
    """(B, *S, 2^nd * C) phase-major -> (B, *2S, C)."""
    nd = p.ndim - 2
    b, sp = p.shape[0], p.shape[1:-1]
    x = p.reshape((b,) + tuple(sp) + (2,) * nd + (c_out,))
    perm = (0,) + sum(((1 + i, 1 + nd + i) for i in range(nd)), ()) + (1 + 2 * nd,)
    return x.permute(perm).reshape((b,) + tuple(2 * s for s in sp) + (c_out,))


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """(B, *S, C) with even S -> (B, *S/2, 2^nd * C), phase-major."""
    nd = x.ndim - 2
    b, c, sp = x.shape[0], x.shape[-1], x.shape[1:-1]
    y = x.reshape((b,) + sum(((s // 2, 2) for s in sp), ()) + (c,))
    perm = ((0,) + tuple(1 + 2 * i for i in range(nd)) + tuple(2 + 2 * i for i in range(nd))
            + (1 + 2 * nd,))
    return y.permute(perm).reshape((b,) + tuple(s // 2 for s in sp) + (2**nd * c,))
