"""Sliding-window Gaussian-blend accumulation (the scatter half of
sliding-window inference).

Port of ``segmantic_tpu/ops/pallas_blend.py::accumulate_windows_pallas``:
``acc[window_b] += logits[b] * importance`` for the windows of one chunk, in
place, windows applied in order b = 0 .. B-1. No alignment contract and no
channel padding: any starts and any channel count.

``accumulate_windows`` launches ``csrc/blend.cu`` (a gather over the tiles of
the windows' union, bit-equal to the sequential loop) for CUDA tensors and
runs :func:`accumulate_windows_plain` for CPU tensors. With ``wacc`` the same
pass adds the importance map into the weight map, ``wacc[window_b] +=
importance``, which the caller otherwise does with one slice-add per window.

The launch geometry is Python: :func:`launch_shape` (the block of threads and
the route, ``float4`` accesses when the channel count allows them, scalar
otherwise) and :func:`union_tiles` (the tile grid over the windows' bounding
box, which tiles a window touches and which windows each takes, in order).
The kernel derives the same lists from the starts it is given by value, so a
call uploads nothing and can be captured in a CUDA graph.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import _cuda

__all__ = [
    "accumulate_windows", "accumulate_windows_plain", "counter", "launch_shape",
    "union_tiles", "UnionPlan", "MAX_WINDOWS", "ROWS",
]

counter = _cuda.LaunchCounter("blend")

MAX_WINDOWS = 32  # windows one launch takes by value (csrc/blend.cu: kMaxWindows)
ROWS = 4  # z planes a thread owns (csrc/blend.cu: kRows)
_BLOCK_THREADS = 256


def _window_slices(start: Sequence[int], roi: Sequence[int]):
    return tuple(slice(int(s), int(s) + int(r)) for s, r in zip(start, roi))


def accumulate_windows_plain(acc, logits, importance, starts, wacc=None) -> torch.Tensor:
    """The sequential loop: one read-modify-write per window, in order."""
    imp = importance[..., None]
    roi = logits.shape[1:4]
    for b, s in enumerate(np.asarray(starts).reshape(-1, 3)):
        acc[_window_slices(s, roi)] += logits[b] * imp
        if wacc is not None:
            wacc[_window_slices(s, roi)] += imp
    return acc


def launch_shape(channels: int, aligned: bool = True) -> Tuple[int, Tuple[int, int, int]]:
    """(vec, (bx, tx, ty)): floats per access and the block of threads.

    ``vec`` is 4 (``float4`` loads and stores of ``acc`` and ``logits``) when
    the channel count is a multiple of 4 and both base pointers are 16-byte
    ``aligned``, else 1. A thread owns one channel unit of ``vec`` floats
    (``bx`` units side by side, looping when a voxel has more) of one voxel
    (``tx`` along x, ``ty`` rows along y) in ``ROWS`` z planes; channel units
    and x run fastest, so a warp reads one contiguous run of a row."""
    vec = 4 if channels % 4 == 0 and aligned else 1
    bx = min(channels // vec, 32)
    tx = max(1, 32 // bx)
    ty = max(1, _BLOCK_THREADS // (bx * tx))
    return vec, (bx, tx, ty)


@dataclasses.dataclass(frozen=True)
class UnionPlan:
    """The tiles one launch covers. ``origin`` is the corner of the windows'
    bounding box, ``tile`` the voxels (z, y, x) of one block, ``grid`` the
    tiles per axis; ``tiles[i]`` is the (z, y, x) index of the i-th tile that
    some window touches and ``windows[i]`` the windows it takes, ascending.
    A block whose list is empty returns before it touches ``acc``."""

    origin: Tuple[int, int, int]
    tile: Tuple[int, int, int]
    grid: Tuple[int, int, int]
    tiles: Tuple[Tuple[int, int, int], ...]
    windows: Tuple[Tuple[int, ...], ...]


@functools.lru_cache(maxsize=256)
def _union_tiles(starts_bytes: bytes, roi, tile) -> UnionPlan:
    starts = np.frombuffer(starts_bytes, np.int64).reshape(-1, 3)
    origin = starts.min(axis=0)
    extent = starts.max(axis=0) + np.asarray(roi) - origin
    grid = tuple(int(-(-extent[a] // tile[a])) for a in range(3))
    # per axis: does window b overlap tile i
    over = []
    for a in range(3):
        lo = origin[a] + np.arange(grid[a]) * tile[a]
        over.append((starts[:, a, None] < lo + tile[a]) & (starts[:, a, None] + roi[a] > lo))
    hit = over[0][:, :, None, None] & over[1][:, None, :, None] & over[2][:, None, None, :]
    index = np.argwhere(hit.any(axis=0))
    return UnionPlan(
        origin=tuple(int(v) for v in origin), tile=tuple(tile), grid=grid,
        tiles=tuple(tuple(int(v) for v in t) for t in index),
        windows=tuple(tuple(int(b) for b in np.nonzero(hit[:, t[0], t[1], t[2]])[0])
                      for t in index),
    )


def union_tiles(starts, roi: Sequence[int], tile: Sequence[int]) -> UnionPlan:
    """The tile grid of one launch over ``starts`` (at most ``MAX_WINDOWS``
    windows of extent ``roi``): cached, since a served volume repeats the
    same chunks."""
    starts = np.ascontiguousarray(np.asarray(starts, np.int64).reshape(-1, 3))
    return _union_tiles(starts.tobytes(), tuple(int(r) for r in roi),
                        tuple(int(t) for t in tile))


def accumulate_windows(
    acc: torch.Tensor,  # (D, H, W, C) f32, updated in place
    logits: torch.Tensor,  # (B, R0, R1, R2, C) f32
    importance: torch.Tensor,  # (R0, R1, R2) f32
    starts,  # (B, 3) window origins on the host (numpy or CPU tensor)
    wacc: Optional[torch.Tensor] = None,  # (D, H, W, 1) f32 weight map, in place
) -> torch.Tensor:
    """acc[win] += logits * importance (and wacc[win] += importance) for every
    window, in place; returns acc.

    ``starts`` stays on the host and goes to the kernel by value, at most
    ``MAX_WINDOWS`` windows a launch; a longer chunk takes several launches
    in order, which adds each voxel's windows in the same order."""
    starts = np.asarray(starts, np.int64).reshape(-1, 3)
    if acc.ndim != 4 or logits.ndim != 5:
        raise ValueError("acc must be (D, H, W, C) and logits (B, R0, R1, R2, C)")
    b, r0, r1, r2, c = logits.shape
    if len(starts) != b or acc.shape[-1] != c or tuple(importance.shape) != (r0, r1, r2):
        raise ValueError(
            f"shape mismatch: acc {tuple(acc.shape)}, logits {tuple(logits.shape)}, "
            f"importance {tuple(importance.shape)}, {len(starts)} starts"
        )
    tensors = [(acc, "acc"), (logits, "logits"), (importance, "importance")]
    if wacc is not None:
        if tuple(wacc.shape) != (*acc.shape[:3], 1) or wacc.device != acc.device:
            raise ValueError(f"wacc must be {(*acc.shape[:3], 1)} beside acc, "
                             f"got {tuple(wacc.shape)} on {wacc.device}")
        tensors.append((wacc, "wacc"))
    for t, name in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    roi = np.array([r0, r1, r2])
    if (starts < 0).any() or (starts + roi > np.array(acc.shape[:3])).any():
        raise ValueError("a window reaches outside the accumulator")
    if acc.device.type == "cpu":
        return accumulate_windows_plain(acc, logits, importance, starts, wacc)
    for t, name in tensors:
        _cuda.check_cuda(t, name)
    aligned = acc.data_ptr() % 16 == 0 and logits.data_ptr() % 16 == 0
    vec, (bx, tx, ty) = launch_shape(c, aligned)
    for i in range(0, b, MAX_WINDOWS):
        part = starts[i:i + MAX_WINDOWS]
        plan = union_tiles(part, (r0, r1, r2), (ROWS, ty, tx))
        _cuda.launch(
            "segk_blend", acc.data_ptr(), logits[i:i + MAX_WINDOWS].data_ptr(),
            importance.data_ptr(), wacc.data_ptr() if wacc is not None else None,
            (ctypes.c_int * (3 * len(part)))(*part.ravel().tolist()), len(part),
            r0, r1, r2, c, acc.shape[1], acc.shape[2], vec, bx, tx, ty,
            *plan.origin, *plan.grid,
        )
        counter.count += 1
    return acc
