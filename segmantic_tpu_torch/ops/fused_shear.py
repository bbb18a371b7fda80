"""One rotation group of the augmentation's shear chain as one kernel.

Port of ``exp/fused_shear_pallas.py::make_group_kernel``: the three passes
``shear(a <- b, s0)``, ``shear(b <- a, s1)``, ``shear(a <- b, s2)`` of one
rotation plane, for every index of the third axis, with the plane held on
chip across the passes so that a group reads its input once and writes its
output once. Beyond the Pallas experiment, the port's group takes what the
production chain needs: per-sample coefficients, the zoom folded into a pass,
and passes that emit only a center window (``ops/shear_resample.py``).

``shear_group`` launches ``csrc/shear_group.cu`` for CUDA tensors and runs
:func:`shear_group_plain` (three ``shear_pass`` calls) for CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from . import _cuda
from .shear_resample import shear_pass

__all__ = ["shear_group", "shear_group_plain", "counter"]

counter = _cuda.LaunchCounter("shear_group")

# (use_zoom, frame_extent of the sheared axis or None, out_extent or None)
PassSpec = Tuple[bool, Optional[int], Optional[int]]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.uint8: 2, torch.int32: 3}
_SMEM_LIMIT = 232448  # bytes of shared memory one block may opt into (sm_90)


def shear_group_plain(x, a_axis: int, b_axis: int, coef, zoom,
                      specs: Sequence[PassSpec], order: int, bf16: bool) -> torch.Tensor:
    """The three banded-matrix passes the group stands for."""
    for j, (use_zoom, frame, ext) in enumerate(specs):
        a, b = (b_axis, a_axis) if j == 1 else (a_axis, b_axis)
        x = shear_pass(x, a, b, coef[:, j], order, ext, bf16,
                       zoom=zoom if use_zoom else None,
                       frame_extent=frame if use_zoom else None)
    return x


def shear_group(
    x: torch.Tensor,  # (S, C, *spatial) f32 / bf16 (order 0 or 1), uint8 / int32 (order 0)
    a_axis: int,
    b_axis: int,
    coef: torch.Tensor,  # (S, 3) f32: the passes' coefficients, per sample
    zoom: torch.Tensor,  # (S,) f32
    specs: Sequence[PassSpec],  # one per pass
    order: int,
    bf16: bool = False,
) -> torch.Tensor:
    """``shear(a<-b)``, ``shear(b<-a)``, ``shear(a<-b)`` in the (a, b) plane;
    the result has the extents the passes' ``out_extent`` leave."""
    if len(specs) != 3 or coef.shape != (x.shape[0], 3) or zoom.shape != (x.shape[0],):
        raise ValueError(
            f"need 3 pass specs, coef (S, 3) and zoom (S,); got {len(specs)}, "
            f"{tuple(coef.shape)}, {tuple(zoom.shape)} for {x.shape[0]} samples")
    if order not in (0, 1):
        raise ValueError(f"order must be 0 or 1, got {order}")
    if x.device.type == "cpu":
        return shear_group_plain(x, a_axis, b_axis, coef, zoom, specs, order, bf16)

    if x.dtype not in _DTYPES:
        raise TypeError(f"shear_group takes {sorted(map(str, _DTYPES))}, got {x.dtype}")
    if order == 1 and not x.dtype.is_floating_point:
        raise TypeError(f"order 1 needs a floating type, got {x.dtype}")
    squeeze = x.ndim == 4  # 2D: a third axis of extent 1
    if squeeze:
        x = x.unsqueeze(-1)
    if x.ndim != 5 or {a_axis, b_axis} - {0, 1, 2} or a_axis == b_axis:
        raise ValueError("x must be (S, C, *spatial) in 2D or 3D with two distinct plane axes")
    _cuda.check_cuda(x, "x")
    coef = coef.to(torch.float32).contiguous()
    zoom = zoom.to(torch.float32).contiguous()
    _cuda.check_cuda(coef, "coef")
    _cuda.check_cuda(zoom, "zoom")

    c_axis = 3 - a_axis - b_axis
    dims = list(x.shape[2:])
    ext = {a_axis: dims[a_axis], b_axis: dims[b_axis]}
    passes = []
    for j, (use_zoom, frame, out_ext) in enumerate(specs):
        sheared, other = (b_axis, a_axis) if j == 1 else (a_axis, b_axis)
        n_in = ext[sheared]
        n_out = n_in if out_ext is None else min(int(out_ext), n_in)
        if n_in < 2 or n_out < 1 or (n_in - n_out) % 2:
            raise ValueError(f"pass {j}: extent {n_in} -> {n_out} is not a center "
                             "window of the same parity over at least 2 samples")
        frame = n_in if frame is None else int(frame)
        passes += [n_in, ext[other], n_out, int(bool(use_zoom)), frame]
        ext[sheared] = n_out
    out_dims = list(dims)
    out_dims[a_axis], out_dims[b_axis] = ext[a_axis], ext[b_axis]

    def strides(d):
        st = [d[1] * d[2], d[2], 1]
        return [st[a_axis], st[b_axis], st[c_axis], d[0] * d[1] * d[2]]

    # a block holds the input plane and pass 0's output in shared memory; where
    # the third axis is the memory-minor one it takes a chunk of it, at least
    # 4 bytes wide, as far as the buffers leave room
    plane_elems = passes[0] * passes[1] + passes[2] * passes[1]
    item = x.element_size()
    wc = max(1, 4 // item) if c_axis == 2 else 1
    wc = min(wc, dims[c_axis])
    while wc > 1 and plane_elems * wc * item > _SMEM_LIMIT:
        wc //= 2
    if plane_elems * wc * item > _SMEM_LIMIT:
        raise ValueError(
            f"a {passes[0]} x {passes[1]} plane of {x.dtype} needs "
            f"{plane_elems * item} bytes of shared memory; a block has {_SMEM_LIMIT}")

    y = torch.empty((x.shape[0], x.shape[1], *out_dims), dtype=x.dtype, device=x.device)
    _cuda.launch(
        "segk_shear_group", x.data_ptr(), y.data_ptr(), coef.data_ptr(), zoom.data_ptr(),
        (ctypes.c_int * 15)(*passes), (ctypes.c_int * 8)(*strides(dims), *strides(out_dims)),
        _DTYPES[x.dtype], x.shape[0] * x.shape[1], x.shape[1], dims[c_axis], wc, order,
        int(bool(bf16) and order == 1),
    )
    counter.count += 1
    return y.squeeze(-1) if squeeze else y
