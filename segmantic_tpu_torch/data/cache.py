"""Host volume cache + class-balanced patch batch sampler.

Port of ``segmantic_tpu/data/cache.py``. The deterministic preprocessing runs once per
volume into host RAM, with a per-class voxel index so class-balanced crop
centers are O(1) to sample. Each training step then samples ``num_samples``
patch centers per chosen volume by class ratio, crops the patches (numpy
slicing + zero pad) and stacks a channel-last batch; a background thread
keeps the next batch ready while the device runs the step.

The sampler draws from ``np.random.default_rng(seed)`` exactly as the JAX
package's does, so for one seed both packages produce the same batches, with
the same ``ratios`` rule. A 3D batch is cropped, zero padded, moved
channel-last and cast by the multithreaded C++ crop of ``native/``
(``native.crop_patches_3d``) when the library loads and the volumes qualify
(the JAX rule ``_native_ok``), else in numpy; the two routes give the same
bits.

``image_wire_dtype=torch.bfloat16`` halves the bytes a batch takes to the
device when the step computes in bf16. numpy has no bf16 type of its own, so
a bf16 image batch is a CPU ``torch.bfloat16`` tensor (the C++ crop writes
its bit patterns into a ``uint16`` array, viewed as bf16 without a copy; the
numpy route rounds its f32 batch to nearest even, as the C++ crop does); an
f32 batch and the labels stay numpy arrays.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.volume import Volume

from ..transforms.base import Compose, Sample

__all__ = ["CachedVolume", "VolumeCache", "PatchSampler", "PrefetchLoader"]


class CachedVolume:
    """One preprocessed volume in host RAM with its class-location index."""

    def __init__(self, sample: Sample, num_classes: int):
        self.image: Volume = sample["image"]
        self.label: Optional[Volume] = sample.get("label")
        self.num_classes = num_classes
        self.class_indices: Optional[List[np.ndarray]] = None
        if self.label is not None:
            flat = self.label.numpy().reshape(-1)
            order = np.argsort(flat, kind="stable")
            bounds = np.searchsorted(flat[order], np.arange(num_classes + 1))
            self.class_indices = [order[bounds[c]:bounds[c + 1]] for c in range(num_classes)]

    @property
    def spatial_shape(self) -> Tuple[int, ...]:
        return self.image.spatial_shape


class VolumeCache:
    """Apply the deterministic preprocessing once per file pair and keep the
    results in RAM; ``cache_rate`` < 1 caches only that fraction (the rest is
    recomputed at each access)."""

    def __init__(self, files: Sequence[Dict], preprocessing: Compose, num_classes: int,
                 cache_rate: float = 1.0):
        self.files = list(files)
        self.preprocessing = preprocessing
        self.num_classes = num_classes
        n_cache = int(len(self.files) * cache_rate)
        self._cache: Dict[int, CachedVolume] = {}
        if n_cache:
            import concurrent.futures as cf
            import os

            workers = min(os.cpu_count() or 1, n_cache, 8)
            if workers > 1:  # numpy/zlib release the GIL
                with cf.ThreadPoolExecutor(workers) as pool:
                    for i, vol in enumerate(pool.map(self._load, range(n_cache))):
                        self._cache[i] = vol
            else:
                for i in range(n_cache):
                    self._cache[i] = self._load(i)

    def _load(self, i: int) -> CachedVolume:
        return CachedVolume(self.preprocessing(dict(self.files[i])), self.num_classes)

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, i: int) -> CachedVolume:
        if i in self._cache:
            return self._cache[i]
        return self._load(i)


def _crop_with_pad(data: np.ndarray, start: Sequence[int], size: Sequence[int]) -> np.ndarray:
    """Crop (C, *spatial) with zero padding where the window leaves bounds."""
    out = np.zeros(data.shape[:1] + tuple(size), dtype=data.dtype)
    src_sl, dst_sl = [slice(None)], [slice(None)]
    for a in range(data.ndim - 1):
        s0, s1 = start[a], start[a] + size[a]
        c0, c1 = max(s0, 0), min(s1, data.shape[1 + a])
        if c0 >= c1:
            return out
        src_sl.append(slice(c0, c1))
        dst_sl.append(slice(c0 - s0, c1 - s0))
    out[tuple(dst_sl)] = data[tuple(src_sl)]
    return out


def _wire_is_bf16(dtype) -> bool:
    """Whether an ``image_wire_dtype`` is ``torch.bfloat16``; float32
    (``np.float32`` or ``torch.float32``) is the other choice."""
    if dtype is torch.bfloat16:
        return True
    if dtype in (torch.float32, np.float32) and not isinstance(dtype, str):
        return False
    raise ValueError(f"image_wire_dtype must be float32 or torch.bfloat16, got {dtype!r}")


def _bf16_view(bits: np.ndarray) -> torch.Tensor:
    """A ``uint16`` array of bf16 bit patterns as a CPU ``torch.bfloat16``
    tensor (no copy)."""
    return torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)


class PatchSampler:
    """Class-balanced margin-patch batches from a VolumeCache: image
    (B, *margin_size, C) in ``image_wire_dtype`` (float32: a numpy array;
    bfloat16: a CPU ``torch.bfloat16`` tensor) and label (B, *margin_size)
    uint8 (int32 above 256 classes), with margin_size = patch_size + 2 *
    margin. Crop centers fall on class c with weight ``ratios[c]`` among the
    classes the volume holds (default: the foreground classes equally, the
    background never). The margin feeds the rotation + zoom on the device, so
    that patch borders come from real data: the patch window is clamped
    inside the volume and only the margin may hang outside, zero padded."""

    def __init__(self, cache: VolumeCache, patch_size: Sequence[int], batch_size: int,
                 num_samples: int = 4, ratios: Optional[Sequence[float]] = None,
                 margin: int = 0, seed: int = 0, image_wire_dtype=np.float32):
        self.cache = cache
        self.image_wire_dtype = image_wire_dtype
        self._bf16 = _wire_is_bf16(image_wire_dtype)
        self.patch_size = list(patch_size)
        self.margin = margin
        self.margin_size = [p + 2 * margin for p in self.patch_size]
        self.batch_size = batch_size
        self.num_samples = num_samples
        self.num_classes = cache.num_classes
        self.ratios = (
            list(ratios)
            if ratios is not None
            else [0 if c == 0 else 1 for c in range(cache.num_classes)]
        )
        self.rng = np.random.default_rng(seed)

    def _sample_center(self, vol: CachedVolume) -> List[int]:
        ratios = np.asarray(self.ratios, np.float64)
        avail = np.array([len(ci) > 0 for ci in vol.class_indices])
        w = np.where(avail, ratios, 0.0)
        if w.sum() == 0:
            w = avail.astype(np.float64)
        w = w / w.sum()
        cls = self.rng.choice(self.num_classes, p=w)
        pick = vol.class_indices[cls][self.rng.integers(len(vol.class_indices[cls]))]
        return list(np.unravel_index(pick, vol.spatial_shape))

    def sample_batch(self):
        nd = len(self.patch_size)
        picks: List[Tuple[CachedVolume, List[int]]] = []
        while len(picks) < self.batch_size:
            vol = self.cache[self.rng.integers(len(self.cache))]
            take = min(self.num_samples, self.batch_size - len(picks))
            for _ in range(take):
                center = self._sample_center(vol)
                start = []
                for a in range(nd):
                    p, s = self.patch_size[a], vol.spatial_shape[a]
                    if s < p:  # volume smaller than the patch: center it
                        st = -((p - s) // 2)
                    else:  # keep the patch window inside the volume
                        st = min(max(center[a] - p // 2, 0), s - p)
                    start.append(st - self.margin)
                picks.append((vol, start))

        # the multithreaded C++ crop when it qualifies (the same bits)
        if nd == 3 and self.num_classes <= 256 and self._native_ok(picks):
            return self._sample_batch_native(picks)

        images, labels = [], []
        for vol, start in picks:
            images.append(_crop_with_pad(vol.image.numpy(), start, self.margin_size))
            labels.append(_crop_with_pad(vol.label.numpy(), start, self.margin_size)[0])
        image_b = np.moveaxis(np.stack(images).astype(np.float32), 1, -1)  # channel-last
        if self._bf16:
            image_b = torch.from_numpy(image_b).to(torch.bfloat16)
        # uint8 labels are lossless up to 256 classes: 4x less to upload
        label_dtype = np.uint8 if self.num_classes <= 256 else np.int32
        return image_b, np.stack(labels).astype(label_dtype)

    @staticmethod
    def _native_ok(picks) -> bool:
        from .. import native

        if not native.available():
            return False
        return all(
            v.image.numpy().dtype == np.float32
            and v.label is not None
            and np.issubdtype(v.label.numpy().dtype, np.integer)
            for v, _ in picks
        )

    def _sample_batch_native(self, picks):
        """Fused C++ pad + crop + transpose + cast, multithreaded over the
        batch; the whole batch is allocated once and each volume's run of
        picks writes its slice in batch order."""
        from .. import native

        b = len(picks)
        c = picks[0][0].image.numpy().shape[0]
        out_sz = tuple(self.margin_size)
        img_out = np.empty((b,) + out_sz + (c,), np.uint16 if self._bf16 else np.float32)
        lbl_out = np.empty((b,) + out_sz, np.uint8)
        i = 0
        while i < len(picks):
            vol = picks[i][0]
            j = i
            starts = []
            while j < len(picks) and picks[j][0] is vol:
                starts.append(picks[j][1])
                j += 1
            native.crop_patches_3d(
                vol.image.numpy(),
                vol.label.numpy()[0],
                np.asarray(starts, np.int64),
                self.margin_size,
                to_bf16=self._bf16,
                out=(img_out[i:j], lbl_out[i:j]),
            )
            i = j
        return (_bf16_view(img_out) if self._bf16 else img_out), lbl_out


class PrefetchLoader:
    """Background-thread batch prefetcher (double-buffered). An exception in
    the sampler ends the thread and is raised by the next :meth:`next`."""

    def __init__(self, sampler: PatchSampler, prefetch: int = 2):
        self.sampler = sampler
        self.queue: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self) -> None:
        while not self._stop.is_set():
            try:
                item = self.sampler.sample_batch()
            except Exception as err:  # handed to the consumer, which raises it
                item = err
            while not self._stop.is_set():
                try:
                    self.queue.put(item, timeout=0.5)
                    break
                except queue.Full:
                    continue
            if isinstance(item, Exception):
                return

    def next(self) -> Tuple[np.ndarray, np.ndarray]:
        item = self.queue.get()
        if isinstance(item, Exception):
            raise RuntimeError("the patch sampler failed") from item
        return item

    def stop(self) -> None:
        self._stop.set()
        try:
            while True:
                self.queue.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=30)
