"""Sliding-window Gaussian-blend accumulation (the scatter half of
sliding-window inference).

Port of ``segmantic_tpu/ops/pallas_blend.py::accumulate_windows_pallas``:
``acc[window_b] += logits[b] * importance`` for the windows of one chunk, in
place, windows applied in order b = 0 .. B-1. No alignment contract and no
channel padding: any starts and any channel count.

``accumulate_windows`` launches ``csrc/blend.cu`` (a gather, bit-equal to
the sequential loop) for CUDA tensors and runs :func:`accumulate_windows_plain`
for CPU tensors. The weight-map accumulation stays a plain torch op, as the
JAX package left it to XLA.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from . import _cuda

__all__ = ["accumulate_windows", "accumulate_windows_plain", "counter"]

counter = _cuda.LaunchCounter("blend")


def _window_slices(start: Sequence[int], roi: Sequence[int]):
    return tuple(slice(int(s), int(s) + int(r)) for s, r in zip(start, roi))


def accumulate_windows_plain(acc, logits, importance, starts) -> torch.Tensor:
    """The sequential loop: one read-modify-write per window, in order."""
    imp = importance[..., None]
    roi = logits.shape[1:4]
    for b, s in enumerate(np.asarray(starts).reshape(-1, 3)):
        acc[_window_slices(s, roi)] += logits[b] * imp
    return acc


def accumulate_windows(
    acc: torch.Tensor,  # (D, H, W, C) f32, updated in place
    logits: torch.Tensor,  # (B, R0, R1, R2, C) f32
    importance: torch.Tensor,  # (R0, R1, R2) f32
    starts,  # (B, 3) window origins on the host (numpy or CPU tensor)
) -> torch.Tensor:
    """acc[win] += logits * importance for every window, in place; returns acc.

    ``starts`` stays on the host: the chunk's bounding box is computed from
    it without a device round trip (the window grid is host-side anyway)."""
    starts = np.asarray(starts, np.int64).reshape(-1, 3)
    if acc.ndim != 4 or logits.ndim != 5:
        raise ValueError("acc must be (D, H, W, C) and logits (B, R0, R1, R2, C)")
    b, r0, r1, r2, c = logits.shape
    if len(starts) != b or acc.shape[-1] != c or tuple(importance.shape) != (r0, r1, r2):
        raise ValueError(
            f"shape mismatch: acc {tuple(acc.shape)}, logits {tuple(logits.shape)}, "
            f"importance {tuple(importance.shape)}, {len(starts)} starts"
        )
    for t, name in ((acc, "acc"), (logits, "logits"), (importance, "importance")):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    roi = np.array([r0, r1, r2])
    if (starts < 0).any() or (starts + roi > np.array(acc.shape[:3])).any():
        raise ValueError("a window reaches outside the accumulator")
    if acc.device.type == "cpu":
        return accumulate_windows_plain(acc, logits, importance, starts)
    for t, name in ((acc, "acc"), (logits, "logits"), (importance, "importance")):
        _cuda.check_cuda(t, name)
    lo = starts.min(axis=0)
    n = starts.max(axis=0) + roi - lo
    starts_d = torch.as_tensor(starts.astype(np.int32)).to(acc.device)
    _cuda.launch(
        "segk_blend", acc.data_ptr(), logits.data_ptr(), importance.data_ptr(),
        starts_d.data_ptr(), b, r0, r1, r2, c, acc.shape[1], acc.shape[2],
        int(lo[0]), int(lo[1]), int(lo[2]), int(n[0]), int(n[1]), int(n[2]),
    )
    counter.count += 1
    return acc
