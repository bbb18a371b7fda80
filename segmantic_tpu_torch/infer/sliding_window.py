"""Sliding-window inference with Gaussian-blended overlap accumulation.

Port of the single-device path of ``segmantic_tpu/infer/sliding_window.py``:
the same window grid (MONAI convention, last window snapped to the edge),
the same separable Gaussian importance map and the same blend, on the
unaligned grid the JAX package uses off the TPU (no channel padding, no grid
quantisation); ``mode="constant"`` blends with an importance map of ones.
The volume and both accumulators live on the device; each
chunk of ``sw_batch_size`` windows is gathered, run through the predictor and
blended by the blend kernel (:mod:`..ops.blend`), which adds the importance
map into the weight map in the same pass; the short last chunk is
padded by repeating its last window and the duplicates' logits are dropped
before blending. ``wire_dtype`` (e.g. ``torch.bfloat16``) casts the host
volume before upload. :class:`SlidingWindowInferer` is the MONAI-style
callable with the settings fixed.

The mesh, volume-sharded and host-streamed modes of the JAX package are not
ported yet.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import blend
from ..ops._cuda import resolve_device

__all__ = ["window_starts", "gaussian_importance", "sliding_window_inference",
           "SlidingWindowInferer", "BLEND_MODES"]

BLEND_MODES = ("gaussian", "constant")

# accumulators above this many bytes were streamed from host memory by the
# JAX package (sliding_window_inference_streamed), not ported yet
_STREAM_BYTES = 8 << 30


def window_starts(
    image_size: Sequence[int],
    roi_size: Sequence[int],
    overlap: float,
) -> List[Tuple[int, ...]]:
    """Window origin grid (MONAI convention): stride = roi * (1 - overlap),
    last window snapped so it ends exactly at the image edge; axis 0 major."""
    per_axis: List[List[int]] = []
    for size, roi in zip(image_size, roi_size):
        if roi >= size:
            per_axis.append([0])
            continue
        stride = max(int(roi * (1.0 - overlap)), 1)
        starts = list(range(0, size - roi + 1, stride))
        if starts[-1] != size - roi:
            starts.append(size - roi)
        per_axis.append(starts)
    grids = np.meshgrid(*per_axis, indexing="ij")
    return [tuple(int(g.flat[i]) for g in grids) for i in range(grids[0].size)]


def gaussian_importance(roi_size: Sequence[int], sigma_scale: float = 0.125) -> np.ndarray:
    """Separable Gaussian window-importance map (MONAI's blend weights)."""
    maps = []
    for s in roi_size:
        center = (s - 1) / 2.0
        sigma = max(s * sigma_scale, 1e-3)
        x = np.arange(s, dtype=np.float64)
        maps.append(np.exp(-0.5 * ((x - center) / sigma) ** 2))
    w = maps[0]
    for m in maps[1:]:
        w = np.multiply.outer(w, m)
    w = np.maximum(w, w.max() * 1e-3)  # avoid zero weights at corners
    return w.astype(np.float32)


def _gather(volume: torch.Tensor, starts, roi) -> torch.Tensor:
    """volume (*spatial, C), starts (B, 3) host ints -> windows (B, *roi, C)."""
    return torch.stack([
        volume[s[0]:s[0] + roi[0], s[1]:s[1] + roi[1], s[2]:s[2] + roi[2]]
        for s in starts
    ])


def sliding_window_inference(
    volume,  # (*spatial, C) numpy array or tensor
    roi_size: Sequence[int],
    sw_batch_size: int,
    predictor: Callable,  # (B, *roi, C) -> (B, *roi, num_classes) f32
    overlap: float = 0.25,
    mode: str = "gaussian",
    num_classes: Optional[int] = None,
    device="cuda",
    wire_dtype: Optional[torch.dtype] = None,
    mesh=None,
    shard_volume: bool = False,
) -> torch.Tensor:
    """Tiled inference over a 3D volume with Gaussian (``mode="gaussian"``)
    or uniform (``"constant"``) blending; returns (*spatial, num_classes)
    blended logits (f32, on ``device``: the card unless the caller asks for
    the CPU; CUDA without a card raises). The volume is zero-padded up to the
    roi where it is smaller (and the result cropped back)."""
    if mode not in BLEND_MODES:
        raise ValueError(f"mode must be one of {BLEND_MODES}, got {mode!r}")
    if mesh is not None or shard_volume:
        raise NotImplementedError(
            "mesh / shard_volume sliding window is not ported yet (ROADMAP "
            "Queue 1: parallel)"
        )
    nd = len(roi_size)
    if nd != 3:
        raise NotImplementedError("the port's sliding window is 3D only")
    device = resolve_device(device)
    n_cls_est = num_classes if num_classes else 8
    est = int(np.prod(volume.shape[:nd])) * 4 * (n_cls_est + 2)
    if est > _STREAM_BYTES:
        raise NotImplementedError(
            "volume needs the host-streamed sliding window (accumulators above "
            f"{_STREAM_BYTES >> 30} GiB), which is not ported yet"
        )
    vol = torch.as_tensor(volume)
    if wire_dtype is not None:
        vol = vol.to(wire_dtype)
    vol = vol.to(device)
    spatial = tuple(vol.shape[:nd])
    roi = tuple(int(r) for r in roi_size)

    pad = [max(roi[a] - spatial[a], 0) for a in range(nd)]
    lo = [p // 2 for p in pad]
    if any(pad):
        widths = []
        for a in reversed(range(nd)):  # F.pad order: last axis first
            widths += [lo[a], pad[a] - lo[a]]
        vol = torch.nn.functional.pad(vol, [0, 0] + widths)
    padded = tuple(vol.shape[:nd])

    starts = np.asarray(window_starts(padded, roi, overlap), np.int64)
    if mode == "gaussian":
        importance = torch.as_tensor(gaussian_importance(roi), device=device)
    else:
        importance = torch.ones(roi, dtype=torch.float32, device=device)

    if num_classes is None:
        num_classes = predictor(_gather(vol, starts[:1], roi)).shape[-1]
    acc = torch.zeros(padded + (num_classes,), dtype=torch.float32, device=device)
    wacc = torch.zeros(padded + (1,), dtype=torch.float32, device=device)

    for i in range(0, len(starts), sw_batch_size):
        chunk = starts[i:i + sw_batch_size]
        n = len(chunk)
        if n < sw_batch_size:  # pad to the static batch, drop duplicates after
            chunk_run = np.concatenate([chunk, np.repeat(chunk[-1:], sw_batch_size - n, 0)])
        else:
            chunk_run = chunk
        logits = predictor(_gather(vol, chunk_run, roi))[:n]
        # one pass adds the logits into acc and the importance into the weight map
        blend.accumulate_windows(acc, logits.float().contiguous(), importance, chunk, wacc)

    out = acc / wacc
    return out[lo[0]:lo[0] + spatial[0], lo[1]:lo[1] + spatial[1], lo[2]:lo[2] + spatial[2]]


class SlidingWindowInferer:
    """Callable with fixed roi / sw-batch / overlap / mode (MONAI-style API):
    ``inferer(volume, predictor)`` is :func:`sliding_window_inference` with
    these settings. (The JAX twin's mesh and TPU wire options are not
    ported: ROADMAP Queue 1.)"""

    def __init__(
        self,
        roi_size: Sequence[int],
        sw_batch_size: int = 4,
        overlap: float = 0.25,
        mode: str = "gaussian",
        device="cuda",
        wire_dtype: Optional[torch.dtype] = None,
    ):
        self.roi_size = list(roi_size)
        self.sw_batch_size = sw_batch_size
        self.overlap = overlap
        self.mode = mode
        self.device = device
        self.wire_dtype = wire_dtype

    def __call__(self, volume, predictor: Callable) -> torch.Tensor:
        return sliding_window_inference(
            volume, self.roi_size, self.sw_batch_size, predictor, overlap=self.overlap,
            mode=self.mode, device=self.device, wire_dtype=self.wire_dtype,
        )
