"""Paired-volume data pipeline for image-to-image translation.

Port of ``segmantic_tpu/i2i/data.py``: paired NIfTI volumes -> the source
resampled onto the target grid (the numpy resampler, or
:func:`~segmantic_tpu_torch.ops.resample.resample_affine_torch` on ``device``
with ``on_device_resample``) -> robust percentile windowing into the
generators' tanh range [-1, 1] -> 2D slices perpendicular to a chosen axis,
padded / cropped to one static shape -> shuffled, restartable batches for
:func:`~segmantic_tpu_torch.i2i.train.train_pix2pix` /
:func:`~segmantic_tpu_torch.i2i.train.train_cyclegan`. The numpy code is a
copy of the JAX package's, so its batches are bit-equal. ``translate_volume``
runs a trained generator slice-wise over a whole volume and reassembles it
with its geometry; ``load_generator`` rebuilds one from a checkpoint of
either package on ``device``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.volume import Volume
from ..io.nifti import read_volume
from ..ops._cuda import resolve_device
from ..ops.resample import (
    grid_matrix,
    output_affine_for_spacing,
    resample_affine_np,
    resample_affine_torch,
)
from ..train.checkpoint import load_checkpoint
from .models import ResnetGenerator, from_flax_variables

IntensityWindow = Tuple[float, float]


def scale_to_tanh(
    data: np.ndarray,
    low_pct: float = 0.5,
    high_pct: float = 99.5,
    window: Optional[IntensityWindow] = None,
) -> Tuple[np.ndarray, IntensityWindow]:
    """Affinely map a robust intensity window onto [-1, 1] (clipped).

    GAN generators end in tanh, so training data must live in its range;
    percentile windowing keeps a few hot voxels from crushing the contrast
    of everything else.
    """
    x = np.asarray(data, np.float32)
    if window is None:
        lo, hi = np.percentile(x, [low_pct, high_pct])
        if hi <= lo:  # constant (or near-constant) volume
            lo, hi = float(x.min()), float(x.max() + 1.0)
        window = (float(lo), float(hi))
    lo, hi = window
    y = (x - lo) / (hi - lo) * 2.0 - 1.0
    return np.clip(y, -1.0, 1.0), window


def unscale_from_tanh(data: np.ndarray, window: IntensityWindow) -> np.ndarray:
    """Inverse of :func:`scale_to_tanh` (without the clip)."""
    lo, hi = window
    return (np.asarray(data, np.float32) + 1.0) * 0.5 * (hi - lo) + lo


def _resample_onto(
    moving: Volume,
    out_affine: np.ndarray,
    out_shape: Tuple[int, ...],
    on_device: bool,
    device=None,
) -> np.ndarray:
    """Resample ``moving`` onto an output grid; on ``device`` when
    ``on_device``."""
    m = grid_matrix(moving.affine, out_affine, moving.ndim_spatial)
    if on_device:
        out = resample_affine_torch(
            torch.as_tensor(moving.numpy(), dtype=torch.float32, device=device),
            torch.as_tensor(m, dtype=torch.float32, device=device),
            tuple(int(s) for s in out_shape),
            order=1,
        )
        return out.cpu().numpy()
    return resample_affine_np(moving.numpy(), m, out_shape, order=1)


def _slices(data: np.ndarray, axis: int) -> np.ndarray:
    """(C, D, H, W) channel-first volume → (n_slices, h, w, C) slice stack."""
    # channel-first spatial axis `axis` is array axis axis+1
    x = np.moveaxis(data, axis + 1, 0)  # (S, C, h, w)
    return np.moveaxis(x, 1, -1)  # (S, h, w, C)


def _unslice(stack: np.ndarray, axis: int) -> np.ndarray:
    """Inverse of :func:`_slices`: (S, h, w, C) → (C, ..spatial..)."""
    x = np.moveaxis(stack, -1, 1)  # (S, C, h, w)
    return np.moveaxis(x, 0, axis + 1)


def _fit_shape(stack: np.ndarray, shape: Tuple[int, int]) -> np.ndarray:
    """Center pad/crop every slice of (S, h, w, C) to (S, *shape, C)."""
    out = stack
    for ax, target in zip((1, 2), shape):
        cur = out.shape[ax]
        if cur > target:
            lo = (cur - target + 1) // 2
            sl = [slice(None)] * out.ndim
            sl[ax] = slice(lo, lo + target)
            out = out[tuple(sl)]
        elif cur < target:
            lo = (target - cur + 1) // 2
            widths = [(0, 0)] * out.ndim
            widths[ax] = (lo, target - cur - lo)
            out = np.pad(out, widths, constant_values=-1.0)
    return out


def _round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


class PairedSliceDataset:
    """Host-cached 2D slice batches from paired (or unpaired) volume files.

    Restartable: every ``iter()`` starts a fresh, differently-shuffled
    epoch — exactly what the i2i train loops expect when they re-``iter``
    an exhausted source. With ``paired=False`` the two domains shuffle
    independently (CycleGAN's unpaired sampling).
    """

    def __init__(
        self,
        pairs: Sequence[Tuple[Path, Path]],
        batch_size: int = 16,
        axis: int = 2,
        slice_shape: Optional[Tuple[int, int]] = None,
        spacing: Optional[Sequence[float]] = None,
        paired: bool = True,
        min_content: float = 0.01,
        low_pct: float = 0.5,
        high_pct: float = 99.5,
        seed: int = 0,
        on_device_resample: bool = False,
        device="cuda",
    ) -> None:
        if not pairs:
            raise ValueError("PairedSliceDataset needs at least one volume pair")
        self.batch_size = int(batch_size)
        self.axis = int(axis)
        self.paired = bool(paired)
        self._seed = int(seed)
        self._epoch = 0
        # the device is used (and must exist) only for the on-device resample
        device = resolve_device(device) if on_device_resample else None

        src_stacks: List[np.ndarray] = []
        dst_stacks: List[np.ndarray] = []
        src_windows: List[IntensityWindow] = []
        dst_windows: List[IntensityWindow] = []
        for src_path, dst_path in pairs:
            src = read_volume(Path(src_path))
            dst = read_volume(Path(dst_path))
            if dst.ndim_spatial != 3 or src.ndim_spatial != 3:
                raise ValueError("i2i slice pipeline expects 3D volumes")
            if spacing is not None:
                out_aff, out_shape = output_affine_for_spacing(
                    dst.affine, dst.spatial_shape, tuple(spacing)[:3]
                )
                dst = dst.with_data(
                    _resample_onto(dst, out_aff, out_shape, on_device_resample, device),
                    out_aff,
                )
            # source rides on the (possibly respaced) target grid so slices align
            src = src.with_data(
                _resample_onto(src, dst.affine, dst.spatial_shape, on_device_resample, device),
                dst.affine.copy(),
            )

            raw_src = _slices(src.numpy().astype(np.float32), self.axis)
            raw_dst = _slices(dst.numpy().astype(np.float32), self.axis)
            if min_content > 0:
                frac = np.mean(np.abs(raw_dst) > 1e-6, axis=(1, 2, 3))
                frac_s = np.mean(np.abs(raw_src) > 1e-6, axis=(1, 2, 3))
                keep = (frac >= min_content) | (frac_s >= min_content)
                if not keep.any():
                    keep = np.ones(len(raw_dst), bool)
                raw_src, raw_dst = raw_src[keep], raw_dst[keep]

            s, sw = scale_to_tanh(raw_src, low_pct, high_pct)
            d, dw = scale_to_tanh(raw_dst, low_pct, high_pct)
            src_stacks.append(s)
            dst_stacks.append(d)
            src_windows.append(sw)
            dst_windows.append(dw)

        if slice_shape is None:
            h = max(s.shape[1] for s in dst_stacks)
            w = max(s.shape[2] for s in dst_stacks)
            # two stride-2 stages in the generators: slice dims must be /4
            slice_shape = (_round_up(h, 4), _round_up(w, 4))
        self.slice_shape = (int(slice_shape[0]), int(slice_shape[1]))

        self.src = np.concatenate(
            [_fit_shape(s, self.slice_shape) for s in src_stacks], axis=0
        )
        self.dst = np.concatenate(
            [_fit_shape(s, self.slice_shape) for s in dst_stacks], axis=0
        )
        #: mean windows across volumes — persisted with checkpoints so
        #: ``translate`` can windowed-unscale its tanh outputs
        self.source_window: IntensityWindow = tuple(
            float(v) for v in np.mean(src_windows, axis=0)
        )
        self.target_window: IntensityWindow = tuple(
            float(v) for v in np.mean(dst_windows, axis=0)
        )

    @property
    def num_slices(self) -> int:
        return int(self.src.shape[0])

    def __len__(self) -> int:  # batches per epoch
        return max(1, self.num_slices // self.batch_size)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        epoch = self._epoch
        self._epoch += 1
        rng = np.random.default_rng(self._seed + 7919 * epoch)
        n, bs = self.num_slices, self.batch_size
        order_a = rng.permutation(n)
        order_b = order_a if self.paired else rng.permutation(n)
        if n < bs:  # tiny datasets: wrap around to fill one static batch
            reps = -(-bs // n)
            order_a = np.tile(order_a, reps)
            order_b = np.tile(order_b, reps)
            n = len(order_a)
        for i in range(n // bs):
            sel_a = order_a[i * bs : (i + 1) * bs]
            sel_b = order_b[i * bs : (i + 1) * bs]
            yield self.src[sel_a], self.dst[sel_b]


class UnpairedSliceDataset:
    """Slice batches from two independent volume domains (CycleGAN).

    Unlike :class:`PairedSliceDataset` there is no correspondence between
    the domains: each file list is loaded, optionally respaced onto its own
    grid, windowed, and sliced independently; batches sample each domain
    with its own shuffle. Slice geometry is the union static shape.
    """

    def __init__(
        self,
        a_files: Sequence[Path],
        b_files: Sequence[Path],
        batch_size: int = 16,
        axis: int = 2,
        slice_shape: Optional[Tuple[int, int]] = None,
        spacing: Optional[Sequence[float]] = None,
        min_content: float = 0.01,
        low_pct: float = 0.5,
        high_pct: float = 99.5,
        seed: int = 0,
        on_device_resample: bool = False,
        device="cuda",
    ) -> None:
        if not a_files or not b_files:
            raise ValueError("UnpairedSliceDataset needs volumes in both domains")
        self.batch_size = int(batch_size)
        self.axis = int(axis)
        self._seed = int(seed)
        self._epoch = 0
        # the device is used (and must exist) only for the on-device resample
        device = resolve_device(device) if on_device_resample else None

        def load_domain(files):
            stacks, windows = [], []
            for path in files:
                vol = read_volume(Path(path))
                if vol.ndim_spatial != 3:
                    raise ValueError("i2i slice pipeline expects 3D volumes")
                if spacing is not None:
                    out_aff, out_shape = output_affine_for_spacing(
                        vol.affine, vol.spatial_shape, tuple(spacing)[:3]
                    )
                    vol = vol.with_data(
                        _resample_onto(vol, out_aff, out_shape, on_device_resample, device),
                        out_aff,
                    )
                raw = _slices(vol.numpy().astype(np.float32), self.axis)
                if min_content > 0:
                    keep = np.mean(np.abs(raw) > 1e-6, axis=(1, 2, 3)) >= min_content
                    if keep.any():
                        raw = raw[keep]
                scaled, win = scale_to_tanh(raw, low_pct, high_pct)
                stacks.append(scaled)
                windows.append(win)
            return stacks, tuple(float(v) for v in np.mean(windows, axis=0))

        a_stacks, self.source_window = load_domain(a_files)
        b_stacks, self.target_window = load_domain(b_files)

        if slice_shape is None:
            h = max(s.shape[1] for s in a_stacks + b_stacks)
            w = max(s.shape[2] for s in a_stacks + b_stacks)
            slice_shape = (_round_up(h, 4), _round_up(w, 4))
        self.slice_shape = (int(slice_shape[0]), int(slice_shape[1]))
        self.src = np.concatenate(
            [_fit_shape(s, self.slice_shape) for s in a_stacks], axis=0
        )
        self.dst = np.concatenate(
            [_fit_shape(s, self.slice_shape) for s in b_stacks], axis=0
        )

    @property
    def num_slices(self) -> int:
        return int(min(self.src.shape[0], self.dst.shape[0]))

    def __len__(self) -> int:
        return max(1, self.num_slices // self.batch_size)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        epoch = self._epoch
        self._epoch += 1
        rng = np.random.default_rng(self._seed + 7919 * epoch)
        bs = self.batch_size

        def order(n):
            o = rng.permutation(n)
            if n < bs:
                o = np.tile(o, -(-bs // n))
            return o

        order_a, order_b = order(len(self.src)), order(len(self.dst))
        n = min(len(order_a), len(order_b))
        for i in range(max(n // bs, 1)):
            sel_a = order_a[i * bs : (i + 1) * bs]
            sel_b = order_b[i * bs : (i + 1) * bs]
            if len(sel_a) < bs or len(sel_b) < bs:
                break
            yield self.src[sel_a], self.dst[sel_b]


def translate_volume(
    apply_fn: Callable[[np.ndarray], np.ndarray],
    vol: Volume,
    axis: int = 2,
    batch_size: int = 16,
    window: Optional[IntensityWindow] = None,
    output_window: Optional[IntensityWindow] = None,
    low_pct: float = 0.5,
    high_pct: float = 99.5,
) -> Volume:
    """Run a trained generator slice-wise over a whole volume.

    The volume is windowed into tanh range (its own robust window unless
    ``window`` pins the one used in training), translated slice-by-slice in
    fixed-size batches, reassembled on the original grid, and — when
    ``output_window`` (e.g. the training target window stored in the
    checkpoint) is given — mapped back to physical intensities.
    """
    if vol.ndim_spatial != 3:
        raise ValueError("translate_volume expects a 3D volume")
    scaled, _ = scale_to_tanh(vol.numpy(), low_pct, high_pct, window=window)
    stack = _slices(scaled, axis)
    n, h, w = stack.shape[:3]
    ph, pw = _round_up(h, 4), _round_up(w, 4)
    padded = _fit_shape(stack, (ph, pw))

    outs = []
    for i in range(0, n, batch_size):
        chunk = padded[i : i + batch_size]
        if len(chunk) < batch_size:  # static shapes: wrap-pad the tail batch
            fill = batch_size - len(chunk)
            chunk = np.concatenate([chunk, padded[:fill]], axis=0)
            outs.append(np.asarray(apply_fn(chunk))[: batch_size - fill])
        else:
            outs.append(np.asarray(apply_fn(chunk)))
    out = np.concatenate(outs, axis=0)
    out = _fit_shape(out, (h, w))  # crop the /4 padding back off
    data = _unslice(out, axis).astype(np.float32)
    if output_window is not None:
        data = unscale_from_tanh(data, output_window)
    return vol.with_data(data)


def load_generator(
    ckpt_path: Path, direction: str = "ab", device="cuda"
) -> Tuple[Callable[[np.ndarray], np.ndarray], dict]:
    """Rebuild a trained pix2pix/CycleGAN generator from its checkpoint (of
    either package) on ``device``.

    Returns ``apply(batch) -> batch`` over (N, h, w, C) numpy slices (f32,
    under ``torch.inference_mode``) plus the checkpoint hparams (which carry
    the training intensity windows)."""
    device = resolve_device(device)
    ckpt = load_checkpoint(Path(ckpt_path))
    hparams = ckpt.get("hparams", {})
    params = ckpt["variables"]["params"]
    if hparams.get("model") == "cyclegan":
        if direction not in ("ab", "ba"):
            raise ValueError(f"direction must be 'ab' or 'ba', got {direction!r}")
        params = params[f"gen_{direction}"]
        out_channels = int(
            hparams["b_channels" if direction == "ab" else "a_channels"]
        )
    else:
        out_channels = int(hparams.get("out_channels", 1))
    stem = np.asarray(params["Conv_0"]["kernel"])  # (*k, in, out): flax infers both
    gen = ResnetGenerator(
        in_channels=int(stem.shape[-2]),
        out_channels=out_channels,
        base_features=int(hparams.get("base_features", 64)),
        n_blocks=int(hparams.get("n_blocks", 6)),
        spatial_dims=stem.ndim - 2,
    )
    gen.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                         from_flax_variables({"params": params}).items()})
    gen = gen.to(device).eval()

    def apply(batch):
        with torch.inference_mode():
            x = torch.as_tensor(np.asarray(batch, np.float32), device=device)
            return gen(x).cpu().numpy()

    return apply, hparams
