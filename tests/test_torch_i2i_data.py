"""The port's i2i data pipeline (``segmantic_tpu_torch/i2i/data.py``) and
``resample_affine_torch`` against the JAX package.

- ``resample_affine_torch`` against ``resample_affine_jax`` on a rotated and
  zoomed grid with ``cval``, 2D and 3D: order 0 bit-equal; order 1 within
  2e-6 * max|data| (a few f32 ulps: XLA's CPU backend contracts the
  multiply-adds of the coordinates and the lerp into FMAs, torch rounds each
  product);
- the numpy helpers, both datasets (paired, unpaired, respaced, with the
  source on a coarser grid) and ``translate_volume`` bit-equal to the JAX
  ones, two epochs of batches each. With ``on_device_resample=True`` the
  datasets are bit-equal where every product of the lerp is exact in f32
  (the coarse source onto its target: weights 0, 1/2, 1); respaced by 1.5 and
  1.25 (weights such as 3/8, whose products round) the slices agree within
  1e-6 (a few ulps of the tanh range, for the FMA contraction above) and the
  windows within 1e-6 relative.
"""

from __future__ import annotations

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmantic_tpu.core.volume import Volume, affine_from_spacing_origin
from segmantic_tpu.i2i import data as jd
from segmantic_tpu.io.nifti import read_volume, write_volume
from segmantic_tpu.ops.resample import resample_affine_jax
from segmantic_tpu_torch.core.volume import Volume as TVolume
from segmantic_tpu_torch.i2i import data as td
from segmantic_tpu_torch.ops.resample import resample_affine_np, resample_affine_torch


def _rotated_zoom(nd: int, rng) -> np.ndarray:
    th = 0.3
    rot = np.eye(nd)
    rot[:2, :2] = [[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]]
    lin = rot @ np.diag([0.8, 1.1, 0.9][:nd])
    return np.concatenate([lin, rng.uniform(-2, 2, (nd, 1))], 1)


@pytest.mark.parametrize("nd", [2, 3])
@pytest.mark.parametrize("order", [0, 1])
def test_resample_affine_torch_matches_jax(nd, order):
    rng = np.random.default_rng(10 * nd + order)
    x = rng.uniform(0, 100, (2,) + (11, 13, 9)[:nd]).astype(np.float32)
    m = _rotated_zoom(nd, rng).astype(np.float32)
    out_shape = (12, 10, 8)[:nd]
    want = np.asarray(resample_affine_jax(jnp.asarray(x), jnp.asarray(m), out_shape,
                                          order=order, cval=-5.0))
    got = resample_affine_torch(torch.from_numpy(x), torch.from_numpy(m), out_shape,
                                order=order, cval=-5.0)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert (want == -5.0).any() and (want != -5.0).any()  # both inside and outside points
    if order == 0:
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        assert np.abs(got.numpy() - want).max() <= 2e-6 * np.abs(x).max()
    # the host resampler agrees as well (the same semantics)
    host = resample_affine_np(x, m.astype(np.float64), out_shape, order=order, cval=-5.0)
    assert np.abs(got.numpy() - host).max() <= 2e-6 * np.abs(x).max()


def test_resample_affine_torch_keeps_the_input_dtype():
    x = torch.arange(2 * 6 * 6, dtype=torch.float64).reshape(2, 6, 6)
    m = torch.tensor([[0.5, 0.0, 0.5], [0.0, 0.5, 1.0]])
    got = resample_affine_torch(x, m, (9, 9), order=1)
    assert got.dtype == torch.float64
    want = np.asarray(resample_affine_jax(jnp.asarray(x.numpy(), jnp.float32), jnp.asarray(m),
                                          (9, 9), order=1))
    np.testing.assert_array_equal(got.numpy().astype(np.float32), want)


def test_numpy_helpers_bit_equal():
    rng = np.random.default_rng(3)
    x = rng.uniform(-50, 700, (1, 9, 7, 5)).astype(np.float32)
    for kw in ({}, {"low_pct": 0.0, "high_pct": 100.0}, {"window": (10.0, 300.0)}):
        (a, wa), (b, wb) = jd.scale_to_tanh(x, **kw), td.scale_to_tanh(x, **kw)
        assert wa == wb and np.array_equal(a, b)
    np.testing.assert_array_equal(td.unscale_from_tanh(a, wa), jd.unscale_from_tanh(a, wa))
    const = np.full((4, 4, 4), 3.0, np.float32)  # the constant-volume window
    assert td.scale_to_tanh(const)[1] == jd.scale_to_tanh(const)[1]
    for axis in range(3):
        s = td._slices(x, axis)
        np.testing.assert_array_equal(s, jd._slices(x, axis))
        np.testing.assert_array_equal(td._unslice(s, axis), x)
        for shape in ((8, 8), (12, 4), (3, 11)):
            np.testing.assert_array_equal(td._fit_shape(s, shape), jd._fit_shape(s, shape))


def _write(path: Path, data: np.ndarray, spacing) -> Path:
    write_volume(path, Volume(data[None], affine_from_spacing_origin(spacing)))
    return path


@pytest.fixture(scope="module")
def volumes(tmp_path_factory):
    root = tmp_path_factory.mktemp("i2i_data")
    rng = np.random.default_rng(5)
    t1 = rng.uniform(0, 800, (18, 14, 6)).astype(np.float32)
    t1[:, :, 0] = 0.0  # an empty slice: dropped by min_content
    pairs = [(_write(root / "a_t1.nii.gz", t1, (1.0, 1.2, 2.0)),
              _write(root / "a_t2.nii.gz", 1000.0 - t1, (1.0, 1.2, 2.0)))]
    t1b = rng.uniform(0, 600, (20, 12, 4)).astype(np.float32)
    pairs.append((_write(root / "b_t1.nii.gz", t1b, (1.0, 1.2, 2.0)),
                  _write(root / "b_t2.nii.gz", np.sqrt(t1b) * 20, (1.0, 1.2, 2.0))))
    # a coarser source: resampled onto the target's grid (ratio 2, exact in f32)
    pairs.append((_write(root / "c_t1.nii.gz", rng.uniform(0, 100, (8, 8, 5)).astype(
        np.float32), (2.0, 2.0, 2.0)), _write(root / "c_t2.nii.gz", rng.uniform(
            0, 100, (16, 16, 5)).astype(np.float32), (1.0, 1.0, 2.0))))
    return pairs


def _same_batches(a, b, epochs: int = 2, atol: float = 0.0):
    """Equal datasets: bit-equal for ``atol`` 0, else within ``atol`` (and the
    windows within ``atol`` relative)."""
    assert a.slice_shape == b.slice_shape and a.num_slices == b.num_slices
    assert len(a) == len(b)
    for wa, wb in ((a.source_window, b.source_window), (a.target_window, b.target_window)):
        np.testing.assert_allclose(wb, wa, rtol=atol, atol=0)
    pairs = [(a.src, b.src), (a.dst, b.dst)]
    for _ in range(epochs):
        ba, bb = list(a), list(b)
        assert len(ba) == len(bb) and ba
        pairs += [p for (x1, y1), (x2, y2) in zip(ba, bb) for p in ((x1, x2), (y1, y2))]
    for want, got in pairs:
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)


@pytest.mark.parametrize("kw", [
    dict(batch_size=4, axis=2, seed=7),
    dict(batch_size=3, axis=0, seed=1, paired=False),
    dict(batch_size=5, axis=1, slice_shape=(16, 8), min_content=0.0, seed=2),
    dict(batch_size=4, axis=2, spacing=(1.5, 1.5, 2.0), seed=3),
    dict(batch_size=4, axis=2, seed=8, on_device_resample=True),
], ids=["paired", "unpaired-axis0", "fixed-shape", "respaced", "on-device"])
def test_paired_dataset_bit_equal(volumes, kw):
    port_kw = dict(kw, device="cpu") if kw.get("on_device_resample") else kw
    _same_batches(jd.PairedSliceDataset(volumes, **kw), td.PairedSliceDataset(volumes, **port_kw))


def test_respaced_on_device_datasets_match(volumes):
    kw = dict(batch_size=4, axis=2, spacing=(1.5, 1.5, 2.0), seed=3, on_device_resample=True)
    _same_batches(jd.PairedSliceDataset(volumes, **kw),
                  td.PairedSliceDataset(volumes, device="cpu", **kw), atol=1e-6)
    a_files, b_files = [p for p, _ in volumes], [q for _, q in volumes][:2]
    _same_batches(jd.UnpairedSliceDataset(a_files, b_files, **kw),
                  td.UnpairedSliceDataset(a_files, b_files, device="cpu", **kw), atol=1e-6)


@pytest.mark.parametrize("kw", [
    dict(batch_size=3, axis=2, seed=4),
    dict(batch_size=2, axis=1, min_content=0.0, seed=5),
    dict(batch_size=4, axis=2, spacing=(2.0, 2.4, 2.0), seed=6),
], ids=["plain", "axis1", "respaced"])
def test_unpaired_dataset_bit_equal(volumes, kw):
    a_files = [p for p, _ in volumes]
    b_files = [q for _, q in volumes][:2]
    port_kw = dict(kw, device="cpu") if kw.get("on_device_resample") else kw
    _same_batches(jd.UnpairedSliceDataset(a_files, b_files, **kw),
                  td.UnpairedSliceDataset(a_files, b_files, **port_kw))


def test_on_device_resample_matches_the_host_path(volumes):
    """The device resampler lands the coarse source where the numpy one does."""
    kw = dict(batch_size=4, axis=2, seed=8)
    host = td.PairedSliceDataset(volumes, **kw)
    dev = td.PairedSliceDataset(volumes, on_device_resample=True, device="cpu", **kw)
    np.testing.assert_allclose(dev.src, host.src, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(dev.dst, host.dst)


@pytest.mark.parametrize("axis,batch,window,out_window", [
    (2, 4, None, (0.0, 10.0)),
    (0, 5, (100.0, 700.0), None),
    (1, 3, None, (-20.0, 40.0)),
])
def test_translate_volume_bit_equal(volumes, axis, batch, window, out_window):
    path = volumes[0][0]
    jvol = read_volume(path)
    tvol = TVolume(np.asarray(jvol.numpy()), np.asarray(jvol.affine))

    def fn(x):  # a stand-in generator: pointwise, so the tail batch's wrap shows
        return np.tanh(0.7 * x + 0.1).astype(np.float32)

    kw = dict(axis=axis, batch_size=batch, window=window, output_window=out_window)
    want, got = jd.translate_volume(fn, jvol, **kw), td.translate_volume(fn, tvol, **kw)
    assert got.spatial_shape == tvol.spatial_shape
    np.testing.assert_array_equal(got.affine, jvol.affine)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    if out_window is not None:
        lo, hi = out_window
        assert lo <= got.numpy().min() and got.numpy().max() <= hi
