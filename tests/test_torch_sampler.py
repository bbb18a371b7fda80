"""The patch sampler's ``ratios``, its bf16 wire and its native crop route
against the JAX package's sampler.

One seed draws the same centers in both packages, with and without
``ratios``. A 3D batch goes through the multithreaded C++ crop of
``native/`` when the library loads (the JAX rule ``_native_ok``), else
through numpy; the two routes give the same bits, f32 and bf16 images (round
to nearest even), uint8 and int32 label volumes, patches hanging outside the
volume included. The port's bf16 batch is a CPU ``torch.bfloat16`` tensor
(the JAX package's an ``ml_dtypes`` array): the bit patterns are compared.
The module fixture holds both packages to one finished library
(``test_torch_native_sync.one_native_library``), so the JAX sampler never
takes numpy for a failure its loader cached at collection.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from segmantic_tpu.core.volume import Volume as JVolume
from segmantic_tpu.data import cache as jcache
from segmantic_tpu_torch import native
from segmantic_tpu_torch.core.volume import Volume
from segmantic_tpu_torch.data import cache
from segmantic_tpu_torch.train import trainer
from tests.test_torch_native_sync import one_native_library


@pytest.fixture(scope="module", autouse=True)
def native_library():
    return one_native_library()


def _volumes(label_dtype, nd=3):
    """Three volumes of different sizes, one smaller than the patch along an
    axis, two channels, labels 0..classes-1 (class 3 absent from the last)."""
    rng = np.random.default_rng(11)
    shapes = [(26, 30, 22), (20, 34, 28), (14, 24, 26)] if nd == 3 else [(40, 36), (18, 44)]
    out = []
    for i, shape in enumerate(shapes):
        grid = np.stack(np.meshgrid(*[np.linspace(-1, 1, s) for s in shape], indexing="ij"))
        r2 = (grid ** 2).sum(0)
        lbl = ((r2 < 0.8).astype(np.int64) + (r2 < 0.4) + (r2 < 0.1) * (i < 2)).astype(
            label_dtype)
        img = (rng.standard_normal((2,) + shape) * 3 + lbl).astype(np.float32)
        out.append((img, lbl[None]))
    return out


def _caches(label_dtype, nd=3, classes=4):
    vols = _volumes(label_dtype, nd)
    ident = lambda d: d  # noqa: E731
    port = cache.VolumeCache([{"image": Volume(data=i, affine=np.eye(4)),
                               "label": Volume(data=lb, affine=np.eye(4))}
                              for i, lb in vols], ident, classes)
    ref = jcache.VolumeCache([{"image": JVolume(data=i, affine=np.eye(4)),
                               "label": JVolume(data=lb, affine=np.eye(4))}
                              for i, lb in vols], ident, classes)
    return port, ref


def _bits(image) -> np.ndarray:
    if torch.is_tensor(image):
        assert image.dtype == torch.bfloat16 and image.device.type == "cpu"
        return image.view(torch.int16).numpy().view(np.uint16)
    if image.dtype == np.float32:
        return image
    return image.view(np.uint16)  # ml_dtypes bfloat16


@pytest.mark.parametrize("label_dtype", [np.uint8, np.int32])
@pytest.mark.parametrize("ratios", [None, [0.5, 1.0, 0.0, 3.0]], ids=["default", "ratios"])
@pytest.mark.parametrize("wire", ["f32", "bf16"])
@pytest.mark.parametrize("route", ["native", "numpy"])
def test_sampler_matches_jax(route, wire, ratios, label_dtype, monkeypatch, native_library):
    import ml_dtypes

    if route == "numpy":
        monkeypatch.setattr(cache.PatchSampler, "_native_ok", staticmethod(lambda picks: False))
        monkeypatch.setattr(jcache.PatchSampler, "_native_ok", staticmethod(lambda picks: False))
    elif not native_library:
        pytest.fail("the native library did not build")
    taken = []
    real = native.crop_patches_3d
    monkeypatch.setattr(native, "crop_patches_3d",
                        lambda *a, **k: taken.append(1) or real(*a, **k))
    port, ref = _caches(label_dtype)
    kw = dict(batch_size=7, num_samples=3, ratios=ratios, margin=5, seed=4)
    sp = cache.PatchSampler(port, (16, 16, 16), image_wire_dtype=(
        torch.bfloat16 if wire == "bf16" else np.float32), **kw)
    sj = jcache.PatchSampler(ref, (16, 16, 16), image_wire_dtype=(
        ml_dtypes.bfloat16 if wire == "bf16" else np.float32), **kw)
    for _ in range(3):
        (pi, pl), (ji, jl) = sp.sample_batch(), sj.sample_batch()
        assert tuple(pi.shape) == (7, 26, 26, 26, 2) and pl.shape == (7, 26, 26, 26)
        assert pl.dtype == jl.dtype == np.uint8
        np.testing.assert_array_equal(_bits(pi), _bits(ji))
        np.testing.assert_array_equal(pl, jl)
        assert (pl == 0).any() and (_bits(pi) == 0).any()  # the margin hangs outside
    assert bool(taken) == (route == "native")
    if ratios is not None:
        assert sp.ratios == sj.ratios == ratios


@pytest.mark.parametrize("label_dtype", [np.uint8, np.int32])
@pytest.mark.parametrize("wire", [np.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_native_route_is_bit_equal_to_numpy(wire, label_dtype, monkeypatch, native_library):
    """The same draws through the C++ crop and through numpy; a bf16 batch
    is the f32 batch rounded to nearest even (torch's cast)."""
    if not native_library:
        pytest.fail("the native library did not build")
    port, _ = _caches(label_dtype)
    kw = dict(batch_size=8, num_samples=4, margin=6, seed=9)
    fast = cache.PatchSampler(port, (16, 16, 16), image_wire_dtype=wire, **kw)
    slow = cache.PatchSampler(port, (16, 16, 16), image_wire_dtype=wire, **kw)
    f32 = cache.PatchSampler(port, (16, 16, 16), **kw)
    monkeypatch.setattr(slow, "_native_ok", lambda picks: False)
    for _ in range(3):
        (fi, fl), (si, sl), (ri, _) = fast.sample_batch(), slow.sample_batch(), f32.sample_batch()
        assert type(fi) is type(si) and fl.dtype == sl.dtype == np.uint8
        np.testing.assert_array_equal(_bits(fi), _bits(si))
        np.testing.assert_array_equal(fl, sl)
        np.testing.assert_array_equal(_bits(fi), _bits(torch.from_numpy(ri).to(wire)
                                                        if wire is torch.bfloat16 else ri))


def test_sampler_2d_takes_numpy_and_the_bf16_wire(native_library):
    import ml_dtypes

    port, ref = _caches(np.uint8, nd=2)
    sp = cache.PatchSampler(port, (24, 24), 5, num_samples=2, margin=4, seed=1,
                            image_wire_dtype=torch.bfloat16)
    sj = jcache.PatchSampler(ref, (24, 24), 5, num_samples=2, margin=4, seed=1,
                             image_wire_dtype=ml_dtypes.bfloat16)
    (pi, pl), (ji, jl) = sp.sample_batch(), sj.sample_batch()
    np.testing.assert_array_equal(_bits(pi), _bits(ji))
    np.testing.assert_array_equal(pl, jl)


def test_wire_dtype_names():
    port, _ = _caches(np.uint8)
    for dtype in (np.float32, np.dtype(np.float32), torch.float32):
        assert not cache.PatchSampler(port, (8, 8, 8), 2, image_wire_dtype=dtype)._bf16
    assert cache.PatchSampler(port, (8, 8, 8), 2, image_wire_dtype=torch.bfloat16)._bf16
    for dtype in (np.float16, torch.float16, "float32", "bfloat16"):
        with pytest.raises(ValueError, match="float32 or torch.bfloat16"):
            cache.PatchSampler(port, (8, 8, 8), 2, image_wire_dtype=dtype)


@pytest.mark.parametrize("mixed_precision", [True, False], ids=["bf16", "f32"])
def test_train_hands_the_step_the_samplers_wire(tmp_path, monkeypatch, mixed_precision):
    """``train()`` builds its sampler with the bf16 wire under
    ``mixed_precision`` (f32 otherwise), and the step gets the image in that
    dtype, as the JAX trainer passes ``image_wire_dtype``."""
    from segmantic_tpu_torch.io.nifti import write_volume

    for sub in ("image", "label"):
        (tmp_path / sub).mkdir()
    for i, (img, lbl) in enumerate(_volumes(np.uint8)):
        write_volume(tmp_path / "image" / f"c{i}.nii.gz", Volume(data=img[:1], affine=np.eye(4)))
        write_volume(tmp_path / "label" / f"c{i}.nii.gz", Volume(data=lbl, affine=np.eye(4)))
    seen, wires = [], []
    real_step, real_sampler = trainer.make_train_step, trainer.PatchSampler

    def recording_step(*args, **kwargs):
        step = real_step(*args, **kwargs)
        return lambda image, label: seen.append((image.dtype, label.dtype)) or step(image, label)

    def recording_sampler(*args, **kwargs):
        wires.append(kwargs.get("image_wire_dtype"))
        return real_sampler(*args, **kwargs)

    monkeypatch.setattr(trainer, "make_train_step", recording_step)
    monkeypatch.setattr(trainer, "PatchSampler", recording_sampler)
    trainer.train(image_dir=tmp_path / "image", labels_dir=tmp_path / "label",
                  output_dir=tmp_path / "run", num_classes=4, spatial_size=(16, 16, 16),
                  channels=(4, 8), strides=(2,), max_epochs=1, batch_size=1, num_samples=2,
                  val_roi_size=(16, 16, 16), mixed_precision=mixed_precision, device="cpu")
    want = torch.bfloat16 if mixed_precision else torch.float32
    assert wires == [want if mixed_precision else np.float32]
    assert seen and all(d == (want, torch.uint8) for d in seen)
