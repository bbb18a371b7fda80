"""Phase-space (subpixel) conv identities used by the eval forward.

Port of the subset of ``segmantic_tpu/ops/fast_conv.py`` that the folded
eval forward runs: the subpixel conv-transpose in phase space
(``subpixel_phase_conv``), the phase-major ``depth_to_space`` /
``space_to_depth`` pair, ``tile_phase`` and the block-space expansion of a
stride-1 3^3 kernel (``expand_s1_kernel``), plus the XLA-SAME stride-2 conv
and conv-transpose the plain model uses.

Layouts follow the JAX package: tensors are channel-last (B, *S, C), kernels
DHWIO, and a phase tensor (B, *S, 8*C) orders its channels phase-major as
(pz, py, px, c) with c fastest.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "conv3d_same",
    "conv_transpose3d_same",
    "subpixel_phase_conv",
    "expand_s1_kernel",
    "phase_conv_s1_plain",
    "tile_phase",
    "depth_to_space",
    "space_to_depth",
]


def _to_ncdhw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 4, 1, 2, 3)


def _to_ndhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 4, 1)


def _same_pads(size: int, k: int, s: int):
    """XLA SAME padding (lo, hi) for one axis; lo gets the smaller half."""
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def conv3d_same(x: torch.Tensor, w: torch.Tensor, bias=None, stride: int = 1):
    """XLA-SAME conv. x (B, D, H, W, C); w (k, k, k, C, CO) DHWIO.

    For stride 2, kernel 3 on even sizes XLA pads (0, 1), which torch's
    symmetric ``padding=1`` does not reproduce; the pads are applied here."""
    k = w.shape[0]
    pads = []
    for size in reversed(x.shape[1:4]):
        pads += list(_same_pads(size, k, stride))
    xp = F.pad(_to_ncdhw(x), pads)
    y = F.conv3d(xp, w.permute(4, 3, 0, 1, 2), bias=bias, stride=stride)
    return _to_ndhwc(y)


def conv_transpose3d_same(x: torch.Tensor, w: torch.Tensor, bias=None,
                          stride: int = 2):
    """flax/lax SAME conv-transpose (no kernel flip), stride 2, kernel 3.

    Equals torch's transposed conv with the spatially flipped kernel and no
    padding, cropped to the first ``2 N`` outputs per axis."""
    n = x.shape[1:4]
    wt = w.flip(0, 1, 2).permute(3, 4, 0, 1, 2)  # (Ci, Co, k, k, k)
    y = F.conv_transpose3d(_to_ncdhw(x), wt, bias=bias, stride=stride)
    y = y[:, :, : stride * n[0], : stride * n[1], : stride * n[2]]
    return _to_ndhwc(y)


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
    """Phase tensor (B, *S, 8*Co) of the stride-2 k3 SAME conv-transpose of
    x (B, *S, Ci) with w (3, 3, 3, Ci, Co): a kernel-2 conv at input
    resolution with left padding 1 (``depth_to_space`` of it is the
    conv-transpose output)."""
    ci, co = w.shape[-2], w.shape[-1]
    sel = torch.as_tensor(_sel_transpose(), dtype=w.dtype, device=w.device)
    wsub = torch.einsum("tuvio,apt,bqu,crv->abcipqro", w, sel, sel, sel)
    wsub = wsub.reshape(2, 2, 2, ci, 8 * co)
    xp = F.pad(_to_ncdhw(x), (1, 0, 1, 0, 1, 0))
    return _to_ndhwc(F.conv3d(xp, wsub.permute(4, 3, 0, 1, 2).to(x.dtype)))


def expand_s1_kernel(w: torch.Tensor) -> torch.Tensor:
    """(3, 3, 3, Ci, Co) -> (3, 3, 3, 8*Ci, 8*Co): the stride-1 3^3 SAME conv
    as a block-space kernel-3 conv between phase tensors
    (``conv3(x) == d2s(conv_SAME(s2d(x), expand_s1_kernel(w)))``)."""
    ci, co = w.shape[-2], w.shape[-1]
    sel = torch.as_tensor(_sel_s1(), dtype=w.dtype, device=w.device)
    wsub = torch.einsum("tuvio,aPXt,bQYu,cRZv->abcPQRiXYZo", w, sel, sel, sel)
    return wsub.reshape(3, 3, 3, 8 * ci, 8 * co)


def phase_conv_s1_plain(p: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Stride-1 3^3 SAME conv applied in phase space as the expanded k3 conv
    (the JAX package's XLA path, ``fast_conv._phase_conv_xla_k3``)."""
    wsub = expand_s1_kernel(w).to(p.dtype)
    y = F.conv3d(_to_ncdhw(p), wsub.permute(4, 3, 0, 1, 2), padding=1)
    return _to_ndhwc(y)


def tile_phase(v: torch.Tensor, nd: int = 3) -> torch.Tensor:
    """(C,) -> (2^nd * C,) phase-major (phases repeat the channel block)."""
    return v.repeat(2**nd)


def depth_to_space(p: torch.Tensor, c_out: int) -> torch.Tensor:
    """(B, D, H, W, 8*C) phase-major -> (B, 2D, 2H, 2W, C)."""
    b, d, h, w, _ = p.shape
    x = p.reshape(b, d, h, w, 2, 2, 2, c_out)
    x = x.permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(b, 2 * d, 2 * h, 2 * w, c_out)


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """(B, D, H, W, C) with even D, H, W -> (B, D/2, H/2, W/2, 8*C)."""
    b, d, h, w, c = x.shape
    y = x.reshape(b, d // 2, 2, h // 2, 2, w // 2, 2, c)
    y = y.permute(0, 1, 3, 5, 2, 4, 6, 7)
    return y.reshape(b, d // 2, h // 2, w // 2, 8 * c)
