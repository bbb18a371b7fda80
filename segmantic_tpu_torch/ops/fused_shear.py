"""One rotation group of the augmentation's shear chain as one kernel.

Port of ``exp/fused_shear_pallas.py::make_group_kernel``: the three passes
``shear(a <- b, s0)``, ``shear(b <- a, s1)``, ``shear(a <- b, s2)`` of one
rotation plane, for every index of the third axis, with the plane held on
chip across the passes so that a group reads its input once and writes its
output once. Beyond the Pallas experiment, the port's group takes what the
production chain needs: per-sample coefficients, the zoom folded into a pass,
and passes that emit only a center window (``ops/shear_resample.py``).

``shear_group`` launches ``csrc/shear_group.cu`` for CUDA tensors and runs
:func:`shear_group_plain` (three ``shear_pass`` calls) for CPU tensors. The
launch geometry is Python (:func:`group_plan`): a block holds one plane of
one (sample, channel, chunk of the third axis) in one shared-memory buffer
and runs the passes in place, a warp per line. A plane too large for a
block's shared memory (the 2D flagship's 384^2 bf16 margin patch) is held in
a global scratch buffer of the block's own instead, served by L1 and L2.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import List, Optional, Sequence, Tuple

import torch

from . import _cuda
from .shear_resample import shear_pass

__all__ = ["shear_group", "shear_group_plain", "group_plan", "GroupPlan", "counter"]

counter = _cuda.LaunchCounter("shear_group")

# (use_zoom, frame_extent of the sheared axis or None, out_extent or None)
PassSpec = Tuple[bool, Optional[int], Optional[int]]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.uint8: 2, torch.int32: 3}
_SMEM_LIMIT = 232448  # bytes of shared memory one block may opt into (sm_90)
_SMEM_PER_SM = 233472  # bytes of shared memory of one SM (sm_90)
_SMEM_RESERVED = 1024  # what the system keeps of it per resident block
_THREADS_PER_SM = 2048
_LANE_OUTPUTS = 8  # outputs of one line a lane keeps in registers (kMaxPerLane)


def shear_group_plain(x, a_axis: int, b_axis: int, coef, zoom,
                      specs: Sequence[PassSpec], order: int, bf16: bool) -> torch.Tensor:
    """The three banded-matrix passes the group stands for."""
    for j, (use_zoom, frame, ext) in enumerate(specs):
        a, b = (b_axis, a_axis) if j == 1 else (a_axis, b_axis)
        x = shear_pass(x, a, b, coef[:, j], order, ext, bf16,
                       zoom=zoom if use_zoom else None,
                       frame_extent=frame if use_zoom else None)
    return x


@dataclasses.dataclass(frozen=True)
class GroupPlan:
    """How one group is launched. A block takes the (a, b) planes of one image
    at ``wc * cp`` neighbours of the third axis: ``wc`` of them packed into
    units of ``unit_bytes`` where that axis is the memory-minor one, else
    ``cp`` planes side by side; all share their positions and weights. A
    plane buffer has ``passes[0]`` rows of ``row_units`` units (padded to an
    odd number of 32-bit words). ``block_lines``: lines too long for a warp's
    registers go a block per line through ``scratch_units`` of scratch; else
    the positions that an output index fixes lie in one f32 table per pass.
    ``global_plane``: the plane does not fit a block's shared memory and lies
    in ``global_bytes`` of global scratch (one plane a block, ``wc = cp = 1``);
    ``smem_bytes`` then counts the tables or the scratch line only."""

    passes: Tuple[int, ...]  # (n_in, n_other, n_out, use_zoom, frame) per pass
    out_dims: Tuple[int, int, int]
    in_strides: Tuple[int, int, int, int]  # elements: a, b, c, image
    out_strides: Tuple[int, int, int, int]
    wc: int
    cp: int
    unit_bytes: int
    row_units: int
    block_lines: bool
    scratch_units: int
    threads: int
    smem_bytes: int
    blocks_per_sm: int  # by shared memory and threads; registers are the card's to count
    chunks: int  # blocks along the third axis
    grid: int  # chunks * images
    vec_in: bool  # 16-byte loads along the rows of x
    vec_out: bool  # 16-byte stores along the rows of y
    global_plane: bool
    global_bytes: int  # of the planes' scratch for the whole grid (0: shared memory)


def _passes(dims: Sequence[int], a_axis: int, b_axis: int, specs: Sequence[PassSpec]):
    """The passes' extents (15 ints) and the output's spatial dims."""
    ext = {a_axis: dims[a_axis], b_axis: dims[b_axis]}
    passes: List[int] = []
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
    return tuple(passes), tuple(out_dims)


def _layout(passes, wc: int, cp: int, item: int, global_plane: bool = False):
    """(row_units, block_lines, scratch_units, smem_bytes) of ``cp`` planes of
    ``wc``-element units; ``global_plane``: the planes lie outside shared
    memory."""
    unit = wc * item
    longest = max(passes[2], passes[7], passes[12])
    block_lines = longest > 32 * _LANE_OUTPUTS
    row_bytes = -(-passes[1] * unit // 4) * 4
    if (row_bytes // 4) % 2 == 0:  # an odd number of words: columns hit distinct banks
        row_bytes += 4
    row_units = row_bytes // unit
    scratch = cp * longest if block_lines else 0
    # behind the planes: the scratch lines, or one f32 per output index of each pass
    behind = scratch * unit if block_lines else 4 * (passes[2] + passes[7] + passes[12])
    planes = 0 if global_plane else cp * passes[0] * row_units * unit
    return row_units, block_lines, scratch, planes + behind


def _blocks_by_smem(smem_bytes: int) -> int:
    return _SMEM_PER_SM // (smem_bytes + _SMEM_RESERVED)


@functools.lru_cache(maxsize=64)
def group_plan(dims: Sequence[int], a_axis: int, b_axis: int, specs: Sequence[PassSpec],
               dtype: torch.dtype, images: int = 1, aligned: bool = True,
               sms: int = 132) -> GroupPlan:
    """The launch plan of one group over ``images`` volumes of spatial extents
    ``dims`` (three; a 2D plane has a third extent of 1) on a card of ``sms``
    SMs. ``aligned``: x starts on a 16-byte boundary (y, allocated by the
    wrapper, does). A plane that fits no block's shared memory takes a global
    plane; a plan whose tables or scratch line do not fit either raises."""
    c_axis = 3 - a_axis - b_axis
    passes, out_dims = _passes(dims, a_axis, b_axis, specs)
    item = torch.empty((), dtype=dtype).element_size()
    nc = dims[c_axis]

    def strides(d):
        st = [d[1] * d[2], d[2], 1]
        return (st[a_axis], st[b_axis], st[c_axis], d[0] * d[1] * d[2])

    # where the third axis is the memory-minor one a block takes a unit of up
    # to 4 bytes of it, else two planes: the widest that leaves two blocks on
    # an SM and two blocks for every SM, else the widest that fits at all
    widest = max(1, 4 // item) if c_axis == 2 else 1
    while widest > nc:
        widest //= 2
    shapes = [(w, 1) for w in (4, 2) if w <= widest]
    if widest == 1 and nc > 1:
        shapes.append((1, 2))
    shapes.append((1, 1))
    fits = [wp for wp in shapes if _layout(passes, *wp, item)[3] <= _SMEM_LIMIT]
    global_plane = not fits
    if global_plane:
        fits = [(1, 1)]
        if _layout(passes, 1, 1, item, True)[3] > _SMEM_LIMIT:
            raise ValueError(
                f"the lines of a {passes[0]} x {passes[1]} plane of {dtype} need "
                f"{_layout(passes, 1, 1, item, True)[3]} bytes of shared memory; a block has "
                f"{_SMEM_LIMIT}")
    good = [(w, p) for w, p in fits
            if _blocks_by_smem(_layout(passes, w, p, item)[3]) >= 2
            and (p == 1 or images * -(-nc // p) >= 2 * sms)]
    wc, cp = (good or fits)[0]
    row_units, block_lines, scratch, smem = _layout(passes, wc, cp, item, global_plane)
    by_smem = _blocks_by_smem(smem)
    threads = 256 if by_smem >= 4 and not block_lines else 512
    in_st, out_st = strides(dims), strides(out_dims)

    def rows_of_16_bytes(st, width) -> bool:
        steps = (st[0], st[3]) + ((st[2],) if nc > 1 else ())  # between the rows' starts
        return (wc == 1 and st[1] == 1 and (width * item) % 16 == 0
                and all((s * item) % 16 == 0 for s in steps))

    chunks = -(-nc // (wc * cp))
    return GroupPlan(
        passes=passes, out_dims=out_dims, in_strides=in_st, out_strides=out_st, wc=wc,
        cp=cp, unit_bytes=wc * item, row_units=row_units, block_lines=block_lines,
        scratch_units=scratch, threads=threads, smem_bytes=smem,
        blocks_per_sm=min(by_smem, _THREADS_PER_SM // threads), chunks=chunks,
        grid=chunks * images,
        vec_in=aligned and rows_of_16_bytes(in_st, passes[1]),
        vec_out=rows_of_16_bytes(out_st, passes[7]),
        global_plane=global_plane,
        global_bytes=chunks * images * passes[0] * row_units * item if global_plane else 0,
    )


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

    images = x.shape[0] * x.shape[1]
    p = group_plan(tuple(x.shape[2:]), a_axis, b_axis, tuple(map(tuple, specs)), x.dtype, images,
                   x.data_ptr() % 16 == 0,
                   torch.cuda.get_device_properties(x.device).multi_processor_count)
    y = torch.empty((x.shape[0], x.shape[1], *p.out_dims), dtype=x.dtype, device=x.device)
    head = (coef.data_ptr(), zoom.data_ptr(), (ctypes.c_int * 15)(*p.passes),
            (ctypes.c_int * 8)(*p.in_strides, *p.out_strides), _DTYPES[x.dtype], images,
            x.shape[1], x.shape[2 + 3 - a_axis - b_axis])
    tail = (order, int(bool(bf16) and order == 1), p.row_units, int(p.block_lines), p.threads,
            int(p.vec_in), int(p.vec_out), p.smem_bytes)
    if p.global_plane:
        planes = torch.empty(p.global_bytes, dtype=torch.uint8, device=x.device)
        _cuda.launch("segk_shear_group_global", x.data_ptr(), y.data_ptr(), planes.data_ptr(),
                     *head, *tail)
    else:
        _cuda.launch("segk_shear_group", x.data_ptr(), y.data_ptr(), *head, p.wc, p.cp, *tail)
    counter.count += 1
    return y.squeeze(-1) if squeeze else y
