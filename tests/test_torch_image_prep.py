"""The port's image preparation modules against the JAX package's: numpy
copies, so every result is bit-equal.

``image.processing`` (the seven functions beyond ``pad``), ``image.modality``
(Otsu, the N4-style bias correction on a small volume with few iterations,
the median filter, CT scaling and its inverse), ``image.utils`` (the axis
reversal; without vtk both raise the same ``RuntimeError``),
``image.make_mixed_modal_dataset`` and the iSEG export (the same datasets
and attributes in both ``.h5`` files).
"""

from __future__ import annotations

import numpy as np
import pytest

from segmantic_tpu.core.volume import Volume as JVolume
from segmantic_tpu.data import iseg as jiseg
from segmantic_tpu.image import make_mixed_modal_dataset as jmixed
from segmantic_tpu.image import modality as jmod
from segmantic_tpu.image import processing as jproc
from segmantic_tpu.image import utils as jutils
from segmantic_tpu_torch import image
from segmantic_tpu_torch.core.volume import Volume, affine_from_spacing_origin
from segmantic_tpu_torch.data import iseg
from segmantic_tpu_torch.image import make_mixed_modal_dataset as mixed
from segmantic_tpu_torch.image import modality as mod
from segmantic_tpu_torch.image import processing as proc
from segmantic_tpu_torch.image import utils as iutils


def _oblique(spacing=(0.8, 1.1, 1.5)):
    aff = affine_from_spacing_origin(spacing, (10.0, -20.0, 5.0))
    t = 0.1
    rot = np.array([[np.cos(t), -np.sin(t), 0], [np.sin(t), np.cos(t), 0], [0, 0, 1.0]])
    aff[:3, :3] = rot @ aff[:3, :3]
    return aff


def _pair(data, aff):
    return Volume(data=data, affine=aff.copy()), JVolume(data=data.copy(), affine=aff.copy())


def _same(got, want):
    assert got.numpy().dtype == want.numpy().dtype
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(got.affine, want.affine)


@pytest.mark.parametrize("shape,spacing", [((5, 6, 7), (0.5, 1.0, 2.0)), ((4, 9), None)])
def test_make_image_matches(shape, spacing):
    _same(proc.make_image(shape, spacing, value=3, dtype=np.int16),
          jproc.make_image(shape, spacing, value=3, dtype=np.int16))
    with pytest.raises(ValueError):
        proc.make_image((3, 4, 5), (1.0, 1.0))


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_extract_slices_matches(axis):
    data = np.random.default_rng(axis).standard_normal((1, 5, 6, 7)).astype(np.float32)
    port, jax_ = _pair(data, _oblique())
    got, want = proc.extract_slices(port, axis), jproc.extract_slices(jax_, axis)
    assert len(got) == len(want) == data.shape[axis + 1]
    for g, w in zip(got, want):
        _same(g, w)


@pytest.mark.parametrize("nearest", [False, True])
def test_resample_and_transforms_match(nearest):
    rng = np.random.default_rng(7)
    data = (rng.standard_normal((1, 9, 10, 11)) * 30).astype(np.float32)
    port, jax_ = _pair(data, _oblique())
    _same(proc.resample(port, (1.3, 0.7, 1.1), nearest), jproc.resample(jax_, (1.3, 0.7, 1.1),
                                                                       nearest))
    fixed_p, fixed_j = _pair(np.zeros((1, 8, 9, 7), np.float32), _oblique((1.0, 1.2, 1.4)))
    t = np.eye(4)
    t[:3, 3] = (0.5, -1.0, 0.3)
    _same(proc.apply_transform(port, fixed_p, t, nearest),
          jproc.apply_transform(jax_, fixed_j, t, nearest))
    _same(proc.resample_to_ref(port, fixed_p, nearest),
          jproc.resample_to_ref(jax_, fixed_j, nearest))


@pytest.mark.parametrize("target", [(4, 6, 5), (9, 4, 20), (9, 10, 11)])
def test_crop_and_crop_center_match(target):
    data = np.arange(990, dtype=np.float32).reshape(1, 9, 10, 11)
    port, jax_ = _pair(data, _oblique())
    _same(proc.crop_center(port, target), jproc.crop_center(jax_, target))
    _same(proc.crop(port, (1, 2, 3), (3, 4, 5)), jproc.crop(jax_, (1, 2, 3), (3, 4, 5)))


def test_otsu_median_and_ct_scaling_match():
    rng = np.random.default_rng(3)
    data = np.concatenate([rng.normal(100, 10, 500), rng.normal(300, 30, 700)]).astype(
        np.float32).reshape(1, 10, 12, 10)
    assert mod.otsu_threshold(data) == jmod.otsu_threshold(data)
    assert mod.otsu_threshold(data, bins=37) == jmod.otsu_threshold(data, bins=37)
    port, jax_ = _pair(data, _oblique())
    _same(mod.otsu_mask(port), jmod.otsu_mask(jax_))
    _same(mod.median_filter(port, 1), jmod.median_filter(jax_, 1))
    ct = (rng.uniform(-1500, 3500, (1, 8, 9, 10))).astype(np.float32)
    port, jax_ = _pair(ct, _oblique())
    scaled_p, scaled_j = mod.scale_clamp_ct(port), jmod.scale_clamp_ct(jax_)
    _same(scaled_p, scaled_j)
    _same(mod.unscale_ct(scaled_p), jmod.unscale_ct(scaled_j))


@pytest.mark.parametrize("field_fit", ["bspline", "gaussian"])
def test_bias_correct_matches(field_fit):
    """A 24^3 phantom under a smooth multiplicative field, 2 levels of 3
    iterations, with and without a mask."""
    rng = np.random.default_rng(5)
    grid = np.stack(np.meshgrid(*[np.linspace(-1, 1, 24)] * 3, indexing="ij"))
    body = ((grid ** 2).sum(0) < 0.8).astype(np.float32)
    field = np.exp(0.3 * grid[0] - 0.2 * grid[1] * grid[2])
    data = ((100 + 50 * (grid[2] > 0)) * body * field + rng.uniform(0, 5, body.shape))
    port, jax_ = _pair(data[None].astype(np.float32), _oblique())
    kw = dict(shrink_factor=2, num_fitting_levels=2, num_iterations=3, field_fit=field_fit)
    _same(mod.bias_correct(port, **kw), jmod.bias_correct(jax_, **kw))
    mask_p, mask_j = _pair(body[None].astype(np.uint8), _oblique())
    _same(mod.bias_correct(port, mask=mask_p, **kw), jmod.bias_correct(jax_, mask=mask_j, **kw))
    assert mod._BSPLINE_BASIS_CACHE is not jmod._BSPLINE_BASIS_CACHE
    resid = rng.standard_normal((12, 10, 11))
    m = resid > -0.5
    np.testing.assert_array_equal(mod.fit_bspline_field(resid, m, cells=2),
                                  jmod.fit_bspline_field(resid, m, cells=2))


def test_image_utils_match(monkeypatch):
    x = np.arange(24).reshape(2, 3, 4)
    np.testing.assert_array_equal(iutils.array_view_reverse_ordering(x),
                                  jutils.array_view_reverse_ordering(x))
    assert iutils.array_view_reverse_ordering(x).shape == (4, 3, 2)
    import sys

    monkeypatch.setitem(sys.modules, "vtk", None)  # vtk absent, as on both machines
    port, jax_ = _pair(np.zeros((1, 3, 4, 5), np.float32), _oblique())
    with pytest.raises(RuntimeError) as got:
        iutils.vtk_image_from_volume(port)
    with pytest.raises(RuntimeError) as want:
        jutils.vtk_image_from_volume(jax_)
    assert str(got.value) == str(want.value) and "vtk" in str(got.value)
    assert image.__all__ == ["labels", "modality", "processing", "utils"]


def test_make_mixed_modal_dataset_matches(tmp_path):
    for m in ("m0", "m1"):
        for sub in ("img", "lbl"):
            (tmp_path / m / sub).mkdir(parents=True)
        for stem in ("a", "b") if m == "m0" else ("c",):
            (tmp_path / m / "img" / f"{stem}.nii.gz").write_bytes(f"i{m}{stem}".encode())
            (tmp_path / m / "lbl" / f"{stem}.nii.gz").write_bytes(f"l{m}{stem}".encode())
    dirs = [tmp_path / m / sub for m in ("m0", "m1") for sub in ("img", "lbl")]
    mixed.make_mixed_modal_dataset(*dirs, tmp_path / "port" / "img", tmp_path / "port" / "lbl")
    jmixed.make_mixed_modal_dataset(*dirs, tmp_path / "jax" / "img", tmp_path / "jax" / "lbl")
    for sub in ("img", "lbl"):
        got = {p.name: p.read_bytes() for p in (tmp_path / "port" / sub).iterdir()}
        want = {p.name: p.read_bytes() for p in (tmp_path / "jax" / sub).iterdir()}
        assert got == want and sorted(got) == ["a_mdix0.nii.gz", "b_mdix0.nii.gz",
                                               "c_mdix1.nii.gz"]
    assert mixed.copy_image_labels(*dirs[:2], tmp_path / "o" / "i", tmp_path / "o" / "l",
                                   "_x") == 2


def _h5_tree(path):
    import h5py

    out = {}
    with h5py.File(path, "r") as f:
        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                out[name] = (obj.dtype.str, obj.shape, obj.compression, obj[()].tobytes())
            else:
                out[name] = "group"
        f.visititems(visit)
    return out


def test_iseg_export_matches(tmp_path):
    rng = np.random.default_rng(2)
    img = (rng.standard_normal((1, 6, 7, 8)) * 10).astype(np.float32)
    lbl = rng.integers(0, 4, (1, 6, 7, 8)).astype(np.uint8)
    aff = _oblique()
    tissues = {1: ("Bone", 1.0, 0.9, 0.8), 2: ("Fat", 0.9, 0.8, 0.1), 3: ("bad",)}
    np.testing.assert_array_equal(iseg.voxel_sizes(aff), jiseg.voxel_sizes(aff))
    for key_set in (("image", "label"), ("label",)):
        sample_p = {"label": Volume(data=lbl, affine=aff.copy(), meta={"filename": "s.nii.gz"})}
        sample_j = {"label": JVolume(data=lbl, affine=aff.copy(), meta={"filename": "s.nii.gz"})}
        if "image" in key_set:
            sample_p["image"] = Volume(data=img, affine=aff.copy(), meta={"filename": "s.nii.gz"})
            sample_j["image"] = JVolume(data=img, affine=aff.copy(),
                                        meta={"filename": "s.nii.gz"})
        kw = dict(label_dict=tissues, allow_missing_keys=True, print_log=False)
        iseg.iSegSaver(["image", "label"], output_dir=tmp_path / "port", **kw)(sample_p)
        jiseg.iSegSaver(["image", "label"], output_dir=tmp_path / "jax", **kw)(sample_j)
        got, want = _h5_tree(tmp_path / "port" / "s" / "s_trans.h5"), _h5_tree(
            tmp_path / "jax" / "s" / "s_trans.h5")
        assert got == want and "Tissues/Bone/rgbo" in got and "Tissues/bad" not in got
    with pytest.raises(RuntimeError, match="missing keys"):
        iseg.iSegSaver(["image", "label"], {})({"label": sample_p["label"]})
