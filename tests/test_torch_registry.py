"""The port's config-driven transform factory against the JAX package's.

The cases of ``tests/transforms/test_registry.py`` through both registries
(each builds its own package's classes; the results are compared exactly, the
code under them being numpy): build from config, ``_disabled_`` and empty
configs, ``@`` references, ``$import`` expressions, dotted targets. The two
registries hold the same names; ``EnsureChannelFirstd`` aliases ``EnsureTyped``.
"""

from __future__ import annotations

import numpy as np
import pytest

from segmantic_tpu.core.volume import Volume as JVolume
from segmantic_tpu.transforms import registry as jregistry
from segmantic_tpu_torch.core.volume import Volume
from segmantic_tpu_torch.transforms import base, intensity, post, registry, spatial

BOTH = [(registry, Volume, "segmantic_tpu_torch"), (jregistry, JVolume, "segmantic_tpu")]
IDS = ["port", "jax"]


def _registries():
    for reg in (registry, jregistry):
        if not reg.TRANSFORM_REGISTRY:
            reg._register_builtins()
    return registry.TRANSFORM_REGISTRY, jregistry.TRANSFORM_REGISTRY


def test_registries_hold_the_same_names():
    port, ref = _registries()
    assert set(port) == set(ref)
    for name in ("LoadImaged", "SpatialPadd", "RandCropByLabelClassesd", "RandFlipd",
                 "RandRotated", "RandZoomd", "RandAdjustContrastd", "RandHistogramShiftd",
                 "RandBiasFieldd", "RandGibbsNoised", "RandKSpaceSpikeNoised",
                 "ScaleIntensityd", "NyulNormalize", "MapLabels", "MapLabelsd", "Invertd",
                 "MeanEnsembled", "VoteEnsembled", "SelectBestEnsembled", "Compose"):
        assert name in port, name


def test_registry_builds_the_ports_own_classes():
    port, ref = _registries()
    for name, cls in port.items():
        if isinstance(cls, type) and cls.__module__.startswith("segmantic_tpu"):
            assert cls.__module__.startswith("segmantic_tpu_torch."), name
            assert ref[name].__name__ == cls.__name__
    assert port["SpatialPadd"] is spatial.SpatialPadd
    assert port["RandGibbsNoised"] is intensity.RandGibbsNoised
    assert port["MapLabelsd"] is post.MapLabelsd
    assert port["Compose"] is base.Compose
    assert port["EnsureChannelFirstd"] is port["EnsureTyped"] is spatial.EnsureTyped


def test_register_transform_as_a_call_and_as_a_decorator():
    class Twice:
        def __init__(self, keys):
            self.keys = keys

    registry.register_transform("TwiceCall", Twice)

    @registry.register_transform("TwiceDeco")
    class Other(Twice):
        pass

    try:
        assert registry.build_transform({"_target_": "TwiceCall", "keys": "a"}).keys == "a"
        assert isinstance(registry.build_transform({"_target_": "TwiceDeco", "keys": "a"}),
                          Other)
    finally:
        del registry.TRANSFORM_REGISTRY["TwiceCall"], registry.TRANSFORM_REGISTRY["TwiceDeco"]


@pytest.mark.parametrize("reg,vol,_pkg", BOTH, ids=IDS)
def test_build_compose_from_config(reg, vol, _pkg):
    cfg = {
        "_target_": "Compose",
        "transforms": [
            {"_target_": "NormalizeIntensityd", "keys": "@image_key"},
            {"_target_": "SpatialPadd", "keys": ["@image_key"], "spatial_size": [8, 8, 8]},
        ],
    }
    pipeline = reg.build_pipeline(cfg)
    assert type(pipeline).__name__ == "Compose" and len(pipeline.transforms) == 2
    data = np.random.default_rng(0).standard_normal((1, 4, 4, 4)).astype(np.float32)
    out = pipeline({"image": vol(data=data)})
    assert out["image"].spatial_shape == (8, 8, 8)
    assert out["image"].applied_ops[-1]["op"] == "pad"


def test_built_pipelines_agree():
    cfg = [
        {"_target_": "NormalizeIntensityd", "keys": "@image_key"},
        {"_target_": "SpatialPadd", "keys": ["@image_key", "@label_key"],
         "spatial_size": [8, 9, 7]},
        {"_target_": "ScaleIntensityd", "keys": "@image_key", "minv": "$1 - 2", "maxv": 1.0},
    ]
    rng = np.random.default_rng(1)
    data = rng.standard_normal((1, 4, 5, 6)).astype(np.float32)
    lbl = rng.integers(0, 3, (1, 4, 5, 6)).astype(np.int32)
    aff = np.diag([1.0, 2.0, 3.0, 1.0])
    got = registry.build_pipeline(cfg)({"image": Volume(data=data, affine=aff.copy()),
                                        "label": Volume(data=lbl, affine=aff.copy())})
    want = jregistry.build_pipeline(cfg)({"image": JVolume(data=data, affine=aff.copy()),
                                          "label": JVolume(data=lbl, affine=aff.copy())})
    for key in ("image", "label"):
        np.testing.assert_array_equal(got[key].numpy(), want[key].numpy())
        np.testing.assert_array_equal(got[key].affine, want[key].affine)
    assert got["image"].numpy().min() == -1.0


@pytest.mark.parametrize("reg,_vol,_pkg", BOTH, ids=IDS)
def test_disabled_and_empty(reg, _vol, _pkg):
    assert reg.build_transform(None) is None
    assert reg.build_transform({}) is None
    assert reg.build_transform([]) is None
    assert reg.build_pipeline({}) is None
    off = {"_target_": "NormalizeIntensityd", "keys": "image", "_disabled_": True}
    assert reg.build_transform(off) is None
    pipeline = reg.build_pipeline({"_target_": "Compose", "transforms": [off]})
    assert len(pipeline.transforms) == 0
    assert len(reg.build_pipeline([off, dict(off, _disabled_=False)]).transforms) == 1


@pytest.mark.parametrize("reg,_vol,_pkg", BOTH, ids=IDS)
def test_at_reference_resolution(reg, _vol, _pkg):
    cfg = {"_target_": "NormalizeIntensityd", "keys": "@image_key"}
    assert reg.build_pipeline(cfg, image_key="img").transforms[0].keys == ["img"]
    nested = reg.build_pipeline({"_target_": "SpatialPadd", "keys": ["@label_key"],
                                 "spatial_size": "@size"},
                                extra_context={"size": [4, "$2 + 3"]}).transforms[0]
    assert nested.keys == ["label"] and nested.spatial_size == [4, 5]
    with pytest.raises(KeyError, match="Unresolved reference"):
        reg.build_transform({"_target_": "NormalizeIntensityd", "keys": "@nope"}, {})
    with pytest.raises(KeyError, match="Unknown transform target"):
        reg.build_transform({"_target_": "NoSuchTransformd", "keys": "image"})


@pytest.mark.parametrize("reg,vol,pkg", BOTH, ids=IDS)
def test_dollar_import_expression(reg, vol, pkg):
    cfg = {"_target_": f"$import {pkg}; {pkg}.transforms.post.MapLabelsd",
           "mapping": {1: 2}, "keys": ["label"]}
    t = reg.build_transform(cfg)
    assert type(t).__module__ == f"{pkg}.transforms.post"
    out = t({"label": vol(data=np.array([[[[0, 1]]]], dtype=np.int32))})
    np.testing.assert_array_equal(out["label"].numpy(), [[[[0, 2]]]])


@pytest.mark.parametrize("reg,vol,pkg", BOTH, ids=IDS)
def test_dotted_target(reg, vol, pkg):
    cfg = {"_target_": f"{pkg}.transforms.intensity.ScaleIntensityd", "keys": "image",
           "minv": 0.0, "maxv": 1.0}
    t = reg.build_transform(cfg)
    assert type(t).__module__ == f"{pkg}.transforms.intensity"
    out = t({"image": vol(data=np.array([[[[-5.0, 5.0]]]], dtype=np.float32))})
    assert out["image"].numpy().min() == 0.0 and out["image"].numpy().max() == 1.0


def test_nested_compose_flattens_and_builds_a_random_pipeline():
    cfg = {"_target_": "Compose", "transforms": [
        {"_target_": "Compose", "transforms": [
            {"_target_": "SpatialPadd", "keys": ["@image_key"], "spatial_size": [6, 6, 6]}]},
        {"_target_": "RandFlipd", "keys": ["@image_key"], "prob": 1.0, "spatial_axis": 1},
    ]}
    pipeline = registry.build_pipeline(cfg)
    assert [type(t).__name__ for t in pipeline.transforms] == ["SpatialPadd", "RandFlipd"]
    det, rand = pipeline.split_deterministic()
    assert len(det.transforms) == 1 and len(rand.transforms) == 1
    data = np.arange(216, dtype=np.float32).reshape(1, 6, 6, 6)
    out = pipeline({"image": Volume(data=data)}, np.random.default_rng(0))
    np.testing.assert_array_equal(out["image"].numpy(), data[:, :, ::-1])
