"""Sliding-window inference with Gaussian-blended overlap accumulation.

Port of the single-device paths of ``segmantic_tpu/infer/sliding_window.py``,
2D and 3D: the same window grid (MONAI convention, last window snapped to the
edge), the same separable Gaussian importance map and the same blend, on the
unaligned grid the JAX package uses off the TPU (no channel padding, no grid
quantisation); ``mode="constant"`` blends with an importance map of ones.

In memory (:func:`sliding_window_inference`): the volume and both
accumulators live on the device; each chunk of ``sw_batch_size`` windows is
gathered, run through the predictor and blended by the blend kernel
(:mod:`..ops.blend`), which adds the importance map into the weight map in
the same pass; the short last chunk is padded by repeating its last window
and the duplicates' logits are dropped before blending. A 2D volume runs as a
3D one of unit depth (the kernel's windows are then one plane deep).
``wire_dtype`` (e.g. ``torch.bfloat16``) casts the host volume before upload.

Host-streamed (:func:`sliding_window_inference_streamed`): the volume and both
accumulators stay in host memory and only each chunk of windows travels to
the device and its logits back. :func:`sliding_window_inference` takes this
path by itself, as the JAX function does, for a volume on the host whose
accumulators would pass ``_STREAM_BYTES``: a numpy array, or a CPU tensor
when ``device`` is not the CPU. A tensor on ``device`` always runs in memory.

:class:`SlidingWindowInferer` is the MONAI-style callable with the settings
fixed.

Over the ranks of a mesh (:func:`..parallel.make_mesh`), as the JAX package
over its devices, in two modes. Window sharding (``mesh=``): ``sw_batch_size``
is rounded to a multiple of the data size, each rank runs its share of every
chunk of windows and blends it into its own accumulators with the blend
kernel, and the accumulators are summed over the data group. Volume sharding
(``shard_volume=True``, :func:`sliding_window_inference_sharded`): each rank
holds a slab of axis 0 plus the next slab's first ``roi[0]`` rows (the halo,
received from the next rank), blends the windows that start in its slab, and
sends the tails that spill past it to the next rank; it falls back to window
sharding where a slab would be thinner than the roi. Both return the whole
cropped result on every rank (the sharded one all-gathers its slabs), and a
volume with a mesh never streams from the host.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..ops import blend
from ..ops._cuda import resolve_device
from ..parallel import comm

__all__ = ["window_starts", "gaussian_importance", "sliding_window_inference",
           "sliding_window_inference_streamed", "sliding_window_inference_sharded",
           "SlidingWindowInferer", "BLEND_MODES"]

BLEND_MODES = ("gaussian", "constant")

# accumulators of a host volume above this many bytes are streamed from host
# memory (the JAX package's rule: they would not fit the device)
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
    """volume (D, H, W, C), starts (B, 3) host ints -> windows (B, *roi, C)."""
    return torch.stack([
        volume[s[0]:s[0] + roi[0], s[1]:s[1] + roi[1], s[2]:s[2] + roi[2]]
        for s in starts
    ])


def _importance(roi: Sequence[int], mode: str) -> np.ndarray:
    if mode == "gaussian":
        return gaussian_importance(roi)
    return np.ones(tuple(roi), np.float32)


def _streams(volume, device: torch.device, nd: int, num_classes: Optional[int]) -> bool:
    """Does the JAX package's rule send this volume to the streamed path? Its
    accumulators (``prod(spatial) * 4 * (classes or 8 + 2)`` bytes) pass
    ``_STREAM_BYTES`` and it lies on the host: a numpy array, or a CPU
    tensor when the device is not the CPU."""
    on_host = isinstance(volume, np.ndarray) or (
        torch.is_tensor(volume) and volume.device.type == "cpu" and device.type != "cpu")
    est = int(np.prod(volume.shape[:nd])) * 4 * ((num_classes or 8) + 2)
    return on_host and est > _STREAM_BYTES


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
    """Tiled inference over a 2D or 3D volume (``len(roi_size)`` spatial axes)
    with Gaussian (``mode="gaussian"``) or uniform (``"constant"``) blending;
    returns (*spatial, num_classes) blended logits, f32, on ``device`` (the
    card unless the caller asks for the CPU; CUDA without a card raises). The
    volume is zero-padded up to the roi where it is smaller (and the result
    cropped back). A host volume whose accumulators pass ``_STREAM_BYTES``
    goes through :func:`sliding_window_inference_streamed`, which ignores
    ``wire_dtype`` as the JAX package does, and its result is a CPU tensor.

    ``mesh``: the windows are shared over the mesh's data axis (see the
    module's docstring), or with ``shard_volume`` the volume
    (:func:`sliding_window_inference_sharded`) where its slabs would be at
    least ``roi_size[0]`` thick; ``shard_volume`` without a mesh is ignored,
    as in the JAX package."""
    if mode not in BLEND_MODES:
        raise ValueError(f"mode must be one of {BLEND_MODES}, got {mode!r}")
    nd = len(roi_size)
    if nd not in (2, 3):
        raise ValueError(f"the sliding window takes 2D or 3D windows, got roi {roi_size}")
    if mesh is not None and shard_volume:
        n_data = mesh.shape["data"]
        spatial0 = volume.shape[0] + max(roi_size[0] - volume.shape[0], 0)
        if n_data > 1 and -(-spatial0 // n_data) >= roi_size[0]:
            return sliding_window_inference_sharded(
                volume, roi_size, sw_batch_size, predictor, mesh, overlap=overlap,
                mode=mode, num_classes=num_classes, device=device, wire_dtype=wire_dtype)
        # slabs thinner than the roi: window sharding
    n_share, share = 1, 0  # this rank's share of every chunk of windows
    if mesh is not None:
        n_share, share = mesh.shape["data"], mesh.data_index
        if sw_batch_size % n_share:
            sw_batch_size = max(n_share, (sw_batch_size // n_share) * n_share)
    device = resolve_device(device)
    if mesh is None and _streams(volume, device, nd, num_classes):
        return torch.from_numpy(sliding_window_inference_streamed(
            volume, roi_size, sw_batch_size, predictor, overlap=overlap, mode=mode,
            num_classes=num_classes, device=device))
    vol = torch.as_tensor(volume)
    if wire_dtype is not None:
        vol = vol.to(wire_dtype)
    vol = vol.to(device)
    roi = tuple(int(r) for r in roi_size)
    importance = _importance(roi, mode)
    if nd == 2:  # one plane deep: the 3D grid, gather and blend at unit depth
        vol, roi, importance = vol[None], (1,) + roi, importance[None]

    def run(windows: torch.Tensor) -> torch.Tensor:
        """The predictor on (B, *roi, C) windows, as 3D ones of unit depth in 2D."""
        return predictor(windows[:, 0])[:, None] if nd == 2 else predictor(windows)

    spatial = tuple(vol.shape[:3])

    pad = [max(roi[a] - spatial[a], 0) for a in range(3)]
    lo = [p // 2 for p in pad]
    if any(pad):
        widths = []
        for a in reversed(range(3)):  # F.pad order: last axis first
            widths += [lo[a], pad[a] - lo[a]]
        vol = torch.nn.functional.pad(vol, [0, 0] + widths)
    padded = tuple(vol.shape[:3])

    starts = np.asarray(window_starts(padded, roi, overlap), np.int64)
    importance = torch.as_tensor(importance, device=device)

    if num_classes is None:
        num_classes = run(_gather(vol, starts[:1], roi)).shape[-1]
    acc = torch.zeros(padded + (num_classes,), dtype=torch.float32, device=device)
    wacc = torch.zeros(padded + (1,), dtype=torch.float32, device=device)

    per = sw_batch_size // n_share
    for i in range(0, len(starts), sw_batch_size):
        chunk = starts[i:i + sw_batch_size]
        n = len(chunk)
        if n < sw_batch_size:  # pad to the static batch, drop duplicates after
            chunk_run = np.concatenate([chunk, np.repeat(chunk[-1:], sw_batch_size - n, 0)])
        else:
            chunk_run = chunk
        mine = min(max(n - share * per, 0), per)  # this rank's windows that are not padding
        if mine == 0:
            continue
        chunk_run = chunk_run[share * per:(share + 1) * per]
        logits = run(_gather(vol, chunk_run, roi))[:mine]
        # one pass adds the logits into acc and the importance into the weight map
        blend.accumulate_windows(acc, logits.float().contiguous(), importance,
                                 chunk_run[:mine], wacc)
    if mesh is not None and mesh.distributed:
        dist.all_reduce(acc, group=mesh.data_group)
        dist.all_reduce(wacc, group=mesh.data_group)

    out = acc / wacc
    out = out[lo[0]:lo[0] + spatial[0], lo[1]:lo[1] + spatial[1], lo[2]:lo[2] + spatial[2]]
    return out[0] if nd == 2 else out


def _padded_rows(volume, start: int, stop: int, lo, pad, nd: int, device, wire_dtype):
    """Rows ``[start, stop)`` of the volume zero-padded by ``lo`` before and
    ``pad - lo`` after each spatial axis, on ``device``; only those rows of the
    volume (numpy or tensor) are read and uploaded."""
    spatial0 = volume.shape[0]
    a = min(max(start - lo[0], 0), spatial0)
    b = min(max(stop - lo[0], 0), spatial0)
    core = torch.as_tensor(volume[a:b] if b > a else volume[:0])
    if wire_dtype is not None:
        core = core.to(wire_dtype)
    core = core.to(device)
    front = min(max(lo[0] - start, 0), stop - start)
    back = (stop - start) - front - (b - a if b > a else 0)
    widths = [0, 0]  # channels
    for ax in reversed(range(1, nd)):
        widths += [lo[ax], pad[ax] - lo[ax]]
    widths += [front, back]
    return torch.nn.functional.pad(core, widths)


def sliding_window_inference_sharded(
    volume,  # (*spatial, C) numpy array or tensor
    roi_size: Sequence[int],
    sw_batch_size: int,
    predictor: Callable,  # (B, *roi, C) -> (B, *roi, num_classes) f32
    mesh,
    overlap: float = 0.25,
    mode: str = "gaussian",
    num_classes: Optional[int] = None,
    device="cuda",
    wire_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Tiled inference with the VOLUME sharded over the mesh's data axis
    (spatial axis 0): the JAX function of this name. 2D or 3D.

    The window grid is the single-device one. With n ranks on the data axis
    the padded axis 0 splits into n slabs of ``max(ceil(d / n), roi[0])``
    rows; a window belongs to the slab its start row lies in. Each rank
    uploads its slab only and receives the next slab's first ``roi[0]`` rows
    from the next rank (the halo; zeros on the last rank), runs its windows in
    chunks of ``sw_batch_size`` and blends them with the blend kernel into
    accumulators of ``slab + roi[0]`` rows, sends the ``roi[0]``-row tails to
    the next rank, which adds them into its first rows, and divides. The
    slabs are all-gathered, so every rank returns the whole cropped
    (*spatial, num_classes) f32 result on ``device``, as the JAX function
    returns its global array."""
    if mode not in BLEND_MODES:
        raise ValueError(f"mode must be one of {BLEND_MODES}, got {mode!r}")
    device = resolve_device(device)
    n, r = mesh.shape["data"], mesh.data_index
    group = mesh.data_group
    nd = len(roi_size)
    roi = tuple(int(v) for v in roi_size)
    roi0 = roi[0]
    spatial = tuple(volume.shape[:nd])
    pad = [max(roi[a] - spatial[a], 0) for a in range(nd)]
    lo = [p // 2 for p in pad]
    grid_size = tuple(spatial[a] + pad[a] for a in range(nd))
    d_roi = grid_size[0]
    slab = max(-(-d_roi // n), roi0)
    pad[0] += slab * n - d_roi
    padded = tuple(spatial[a] + pad[a] for a in range(nd))
    importance = torch.as_tensor(_importance(roi, mode), device=device)
    if nd == 2:
        importance = importance[None]

    # this rank's slab and the halo from the next one
    ext = torch.cat([
        _padded_rows(volume, r * slab, (r + 1) * slab, lo, pad, nd, device, wire_dtype),
        torch.zeros((roi0,) + padded[1:] + (volume.shape[-1],),
                    dtype=wire_dtype or _dtype_of(volume), device=device)])
    if n > 1:
        halo = ext[slab:]
        comm.p2p(sends=[(ext[:roi0].contiguous(), mesh.peer(r - 1))] if r > 0 else [],
                 recvs=[(halo, mesh.peer(r + 1))] if r < n - 1 else [], group=group)

    def windows_of(chunk):
        return torch.stack([ext[tuple(slice(s[a], s[a] + roi[a]) for a in range(nd))]
                            for s in chunk])

    if num_classes is None:
        num_classes = int(predictor(windows_of([(0,) * nd])).shape[-1])
    mine = [(s[0] - r * slab,) + tuple(s[1:])
            for s in window_starts(grid_size, roi, overlap)
            if min(s[0] // slab, n - 1) == r]
    acc = torch.zeros((slab + roi0,) + padded[1:] + (num_classes,), dtype=torch.float32,
                      device=device)
    wacc = torch.zeros((slab + roi0,) + padded[1:] + (1,), dtype=torch.float32,
                       device=device)
    # 2D: the blend kernel's windows are one plane deep
    acc3, wacc3 = (acc[None], wacc[None]) if nd == 2 else (acc, wacc)
    for i in range(0, len(mine), sw_batch_size):
        chunk = mine[i:i + sw_batch_size]
        logits = predictor(windows_of(chunk)).float()
        starts3 = np.asarray([(0,) + s for s in chunk] if nd == 2 else chunk, np.int64)
        if nd == 2:
            logits = logits[:, None]
        blend.accumulate_windows(acc3, logits.contiguous(), importance, starts3, wacc3)

    if n > 1:
        tails = torch.cat([acc[slab:], wacc[slab:]], -1).contiguous()
        into = torch.empty_like(tails)
        comm.p2p(sends=[(tails, mesh.peer(r + 1))] if r < n - 1 else [],
                 recvs=[(into, mesh.peer(r - 1))] if r > 0 else [], group=group)
        if r > 0:
            acc[:roi0] += into[..., :num_classes]
            wacc[:roi0] += into[..., num_classes:]
    out = (acc[:slab] / wacc[:slab]).contiguous()
    if n > 1:
        whole = torch.empty((n * slab,) + out.shape[1:], dtype=out.dtype, device=device)
        dist.all_gather_into_tensor(whole, out, group=group)
        out = whole
    return out[tuple(slice(lo[a], lo[a] + spatial[a]) for a in range(nd))]


def _dtype_of(volume) -> torch.dtype:
    if torch.is_tensor(volume):
        return volume.dtype
    return torch.from_numpy(np.asarray(volume[:0])).dtype


def sliding_window_inference_streamed(
    volume: np.ndarray,  # (*spatial, C) host array
    roi_size: Sequence[int],
    sw_batch_size: int,
    predictor: Callable,  # (B, *roi, C) -> (B, *roi, num_classes) on device
    overlap: float = 0.25,
    mode: str = "gaussian",
    num_classes: Optional[int] = None,
    device="cuda",
) -> np.ndarray:
    """Sliding-window inference for volumes too large for the device: the
    JAX function of this name, with ``device``. 2D or 3D.

    The volume and both f32 accumulators stay in host memory; each chunk of
    windows (the last one short) is cropped on the host, copied into pinned
    memory and uploaded without blocking, run through the predictor on ``device``, and
    its logits come back and are blended on the host in window order
    (``acc += logits * imp``, ``wacc += imp``). One chunk deep, as in the JAX
    function: chunk k+1 is launched before chunk k is blended, and the wait
    for chunk k's logits on the host is the only synchronisation. Returns
    ``acc / wacc`` cropped back, (*spatial, num_classes) f32 numpy."""
    device = resolve_device(device)
    pinned = device.type == "cuda"
    volume = np.asarray(volume)
    nd = len(roi_size)
    roi = tuple(int(r) for r in roi_size)
    spatial = volume.shape[:nd]

    pad = [max(roi[a] - spatial[a], 0) for a in range(nd)]
    lo = [p // 2 for p in pad]
    if any(pad):
        widths = [(lo[a], pad[a] - lo[a]) for a in range(nd)] + [(0, 0)]
        volume = np.pad(volume, widths)
    padded = volume.shape[:nd]

    starts = window_starts(padded, roi, overlap)
    imp = _importance(roi, mode)[..., None]

    def launch(chunk):
        """Crop, upload and run one chunk; returns a function that waits for
        its logits on the host."""
        windows = torch.from_numpy(np.stack([
            volume[tuple(slice(s[a], s[a] + roi[a]) for a in range(nd))] for s in chunk]))
        if pinned:
            windows = windows.pin_memory()
        logits = predictor(windows.to(device, non_blocking=True)).float()
        if not pinned:
            return lambda: logits.numpy()
        host = torch.empty(logits.shape, dtype=torch.float32, pin_memory=True)
        host.copy_(logits, non_blocking=True)
        done = torch.cuda.Event()
        done.record()

        def ready() -> np.ndarray:
            done.synchronize()
            return host.numpy()

        return ready

    if num_classes is None:
        num_classes = int(launch([(0,) * nd])().shape[-1])
    acc = np.zeros(tuple(padded) + (num_classes,), np.float32)
    wacc = np.zeros(tuple(padded) + (1,), np.float32)

    chunks = [starts[i:i + sw_batch_size] for i in range(0, len(starts), sw_batch_size)]
    pending = None  # (chunk, its logits once they are on the host)
    for chunk in chunks + [None]:
        launched = None if chunk is None else (chunk, launch(chunk))
        if pending is not None:
            done_chunk, ready = pending
            logits = ready()
            for j, s in enumerate(done_chunk):
                sl = tuple(slice(s[a], s[a] + roi[a]) for a in range(nd))
                acc[sl] += logits[j] * imp
                wacc[sl] += imp
        pending = launched

    np.divide(acc, wacc, out=acc)
    return acc[tuple(slice(lo[a], lo[a] + spatial[a]) for a in range(nd))]


class SlidingWindowInferer:
    """Callable with fixed roi / sw-batch / overlap / mode / mesh (MONAI-style
    API): ``inferer(volume, predictor)`` is :func:`sliding_window_inference`
    with these settings. (The JAX twin's TPU options ``use_pallas`` and
    ``upload_pipeline`` have no counterpart here.)"""

    def __init__(
        self,
        roi_size: Sequence[int],
        sw_batch_size: int = 4,
        overlap: float = 0.25,
        mode: str = "gaussian",
        device="cuda",
        wire_dtype: Optional[torch.dtype] = None,
        mesh=None,
        shard_volume: bool = False,
    ):
        self.roi_size = list(roi_size)
        self.sw_batch_size = sw_batch_size
        self.overlap = overlap
        self.mode = mode
        self.device = device
        self.wire_dtype = wire_dtype
        self.mesh = mesh
        self.shard_volume = shard_volume

    def __call__(self, volume, predictor: Callable) -> torch.Tensor:
        return sliding_window_inference(
            volume, self.roi_size, self.sw_batch_size, predictor, overlap=self.overlap,
            mode=self.mode, device=self.device, wire_dtype=self.wire_dtype,
            mesh=self.mesh, shard_volume=self.shard_volume,
        )
