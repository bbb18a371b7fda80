"""The port's host transforms against the JAX package's, class by class.

Both sides get the same volumes (each package's own ``Volume`` around the same
arrays) and ``np.random.default_rng(seed)``: the draws happen in the same
order, so the pure-numpy transforms (``SpatialPadd``, ``RandCropByLabelClassesd``,
``RandFlipd``, ``RandRotated``, ``RandZoomd``, ``ScaleIntensityd``,
``MapLabels(d)``, ``interp1d``, ``NyulNormalize``'s host path, ``Compose``) are
exact. The five random intensity transforms and ``zscore`` run torch on the
port's side and jnp on the other (an FFT round trip against per-axis circulant
products for Gibbs): 1e-5 of max|ref|. ``nyul_apply_device`` (torch, landmarks
from a sort) against the JAX function and against the host path: 1e-5 of
max|ref| (f32 landmarks on the device, f64 on the host).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmantic_tpu.core.volume import Volume as JVolume
from segmantic_tpu.image import processing as jprocessing
from segmantic_tpu.transforms import base as jbase
from segmantic_tpu.transforms import intensity as jintensity
from segmantic_tpu.transforms import intensity_ops as jops
from segmantic_tpu.transforms import post as jpost
from segmantic_tpu.transforms import spatial as jspatial
from segmantic_tpu_torch.core.volume import Volume
from segmantic_tpu_torch.image import processing
from segmantic_tpu_torch.transforms import base, intensity, intensity_ops, post, spatial


def _pair(seed, shape=(12, 14, 10), channels=1, classes=4):
    """{"image", "label"} samples around the same arrays, port and JAX."""
    rng = np.random.default_rng(seed)
    lbl = rng.integers(0, classes, (1, *shape)).astype(np.int32)
    img = (np.repeat(lbl, channels, 0) * 50.0
           + 10.0 * rng.standard_normal((channels, *shape))).astype(np.float32)
    aff = np.diag([0.8, 1.1, 1.5, 1.0])[:, [1, 0, 2, 3]]
    aff[:3, 3] = (3.0, -2.0, 7.0)
    make = lambda V: {"image": V(data=img.copy(), affine=aff.copy()),  # noqa: E731
                      "label": V(data=lbl.copy(), affine=aff.copy())}
    return make(Volume), make(JVolume)


def _same(got, want, keys=("image", "label")):
    for key in keys:
        assert got[key].numpy().dtype == want[key].numpy().dtype, key
        np.testing.assert_array_equal(got[key].numpy(), want[key].numpy(), err_msg=key)
        np.testing.assert_array_equal(got[key].affine, want[key].affine, err_msg=key)


def _close(got, want, tol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("target", [(16, 16, 16), (12, 20, 9), (4, 4, 4), (13, 14, 15)])
def test_pad_and_spatial_padd(target):
    a, b = _pair(0)
    got, want = processing.pad(a["image"], target, 2.0), jprocessing.pad(b["image"], target, 2.0)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(got.affine, want.affine)
    if target == (4, 4, 4):
        assert got is a["image"]  # nothing to pad: the same object
    got = spatial.SpatialPadd(["image", "label"], target)(a)
    want = jspatial.SpatialPadd(["image", "label"], target)(b)
    _same(got, want)
    ops_g, ops_w = got["image"].applied_ops, want["image"].applied_ops
    assert [o["op"] for o in ops_g] == [o["op"] for o in ops_w]
    for og, ow in zip(ops_g, ops_w):
        assert og["pre_shape"] == ow["pre_shape"]
        np.testing.assert_array_equal(og["pre_affine"], ow["pre_affine"])


def test_invertd_undoes_spatial_padd():
    a, _ = _pair(1)
    padded = spatial.SpatialPadd(["image"], (16, 17, 13))(a)
    back = post.Invertd(["image"], ref_key="image")(padded)
    np.testing.assert_array_equal(back["image"].numpy(), a["image"].numpy())
    np.testing.assert_array_equal(back["image"].affine, a["image"].affine)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("ratios", [None, [1, 1, 0, 3]])
def test_sample_class_centers(seed, ratios):
    a, _ = _pair(seed)
    label = a["label"].numpy()
    ratios = ratios or [0, 1, 1, 1]
    got = spatial.sample_class_centers(label, 4, ratios, 5, [8, 8, 8],
                                       np.random.default_rng(seed))
    want = jspatial.sample_class_centers(label, 4, ratios, 5, [8, 8, 8],
                                         np.random.default_rng(seed))
    assert got == want
    flat = label.reshape(1, -1)[0]
    indices = [np.flatnonzero(flat == c) for c in range(4)]
    cached = spatial.sample_class_centers(label, 4, ratios, 5, [8, 8, 8],
                                          np.random.default_rng(seed), class_indices=indices)
    assert cached == got


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("size,num_samples", [((8, 8, 8), 4), ((12, 6, 10), 1)])
def test_rand_crop_by_label_classes(seed, size, num_samples):
    a, b = _pair(seed, channels=2)
    kw = dict(label_key="label", spatial_size=list(size), num_classes=4,
              num_samples=num_samples)
    got = spatial.RandCropByLabelClassesd(["image", "label"], **kw)(
        a, np.random.default_rng(seed))
    want = jspatial.RandCropByLabelClassesd(["image", "label"], **kw)(
        b, np.random.default_rng(seed))
    assert isinstance(got, list) and len(got) == len(want) == num_samples
    for g, w in zip(got, want):
        _same(g, w)
        assert g["image"].spatial_shape == size


def test_rand_crop_reads_cached_class_indices():
    a, _ = _pair(3)
    flat = a["label"].numpy().reshape(1, -1)[0]
    only_class_2 = [np.array([], np.int64), np.array([], np.int64), np.flatnonzero(flat == 2),
                    np.array([], np.int64)]
    crop = spatial.RandCropByLabelClassesd(["image", "label"], label_key="label",
                                           spatial_size=[1, 1, 1], num_classes=4, num_samples=6)
    out = crop(dict(a, _class_indices=only_class_2), np.random.default_rng(0))
    assert all(int(o["label"].numpy().ravel()[0]) == 2 for o in out)


@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("prob,seed", [(1.0, 0), (0.5, 1), (0.5, 4), (0.0, 2)])
def test_rand_flipd(axis, prob, seed):
    a, b = _pair(seed)
    got = spatial.RandFlipd(["image", "label"], prob, axis)(a, np.random.default_rng(seed))
    want = jspatial.RandFlipd(["image", "label"], prob, axis)(b, np.random.default_rng(seed))
    _same(got, want)
    if prob == 0.0:
        assert got is a


@pytest.mark.parametrize("seed,ranges", [(0, dict(range_z=0.5)), (1, dict(range_x=0.3, range_y=0.2)),
                                         (2, dict(range_x=0.4, range_y=0.1, range_z=0.6))])
def test_rand_rotated(seed, ranges):
    a, b = _pair(seed)
    got = spatial.RandRotated(["image", "label"], prob=1.0, **ranges)(
        a, np.random.default_rng(seed))
    want = jspatial.RandRotated(["image", "label"], prob=1.0, **ranges)(
        b, np.random.default_rng(seed))
    _same(got, want)
    assert got["label"].numpy().dtype == np.int32  # order 0: labels keep whole values
    assert set(np.unique(got["label"].numpy())) <= {0, 1, 2, 3}
    assert not np.array_equal(got["image"].numpy(), a["image"].numpy())


@pytest.mark.parametrize("seed,zoom", [(0, (0.7, 0.9)), (1, (1.1, 1.4)), (2, (0.9, 1.1))])
def test_rand_zoomd(seed, zoom):
    a, b = _pair(seed)
    got = spatial.RandZoomd(["image", "label"], 1.0, *zoom)(a, np.random.default_rng(seed))
    want = jspatial.RandZoomd(["image", "label"], 1.0, *zoom)(b, np.random.default_rng(seed))
    _same(got, want)
    assert set(np.unique(got["label"].numpy())) <= {0, 1, 2, 3}
    assert got["image"].spatial_shape == a["image"].spatial_shape


def test_rotate_and_zoom_volume_and_rotation_matrix():
    a, b = _pair(6, shape=(9, 10))  # 2D too
    for nd, axis in ((2, 0), (3, 0), (3, 1), (3, 2)):
        np.testing.assert_array_equal(spatial._rotation_matrix(nd, axis, 0.3),
                                      jspatial._rotation_matrix(nd, axis, 0.3))
    for order in (0, 1):
        np.testing.assert_array_equal(
            spatial.rotate_volume(a["image"], 0, 0.4, order).numpy(),
            jspatial.rotate_volume(b["image"], 0, 0.4, order).numpy())
        np.testing.assert_array_equal(
            spatial.zoom_volume(a["image"], [1.2, 0.8], order).numpy(),
            jspatial.zoom_volume(b["image"], [1.2, 0.8], order).numpy())


@pytest.mark.parametrize("prob", [0.0, 1.0])
def test_should_apply_draws_once_whatever_the_outcome(prob):
    """A transform that does not fire still spends its draw: the generator is
    in the same state after the port's transform as after the JAX one."""
    a, b = _pair(7)
    r1, r2 = np.random.default_rng(9), np.random.default_rng(9)
    spatial.RandZoomd(["image"], prob)(a, r1)
    jspatial.RandZoomd(["image"], prob)(b, r2)
    assert r1.random() == r2.random()
    assert base.RandMapTransform("k", 0.25).should_apply(np.random.default_rng(3)) == \
        jbase.RandMapTransform("k", 0.25).should_apply(np.random.default_rng(3))
    assert base._is_random(spatial.RandFlipd("image")) and not base._is_random(
        spatial.SpatialPadd("image", [4, 4, 4]))


_INTENSITY = [
    ("RandAdjustContrastd", dict(gamma=(0.5, 2.0))),
    ("RandAdjustContrastd", dict(gamma=3.0)),
    ("RandHistogramShiftd", dict(num_control_points=8)),
    ("RandBiasFieldd", dict(degree=3, coeff_range=(0.0, 0.3))),
    ("RandGibbsNoised", dict(alpha=(0.3, 0.8))),
    ("RandKSpaceSpikeNoised", dict(intensity_range=(0.95, 1.10))),
]


@pytest.mark.parametrize("shape,channels", [((12, 14, 10), 1), ((9, 8, 11), 2), ((16, 12), 1)])
@pytest.mark.parametrize("name,kw", _INTENSITY, ids=[f"{n}{i}" for i, (n, _) in enumerate(_INTENSITY)])
def test_random_intensity_transforms(name, kw, shape, channels):
    a, b = _pair(8, shape=shape, channels=channels)
    r1, r2 = np.random.default_rng(5), np.random.default_rng(5)
    got = getattr(intensity, name)(["image"], prob=1.0, **kw)(a, r1)
    want = getattr(jintensity, name)(["image"], prob=1.0, **kw)(b, r2)
    _close(got["image"].numpy(), want["image"].numpy())
    assert r1.random() == r2.random()  # the same draws, in the same order
    assert got["label"] is a["label"]
    np.testing.assert_array_equal(got["image"].affine, want["image"].affine)
    skipped = getattr(intensity, name)(["image"], prob=0.0, **kw)(a, np.random.default_rng(1))
    assert skipped is a


def test_random_intensity_transforms_draw_per_key():
    """Two keys: histogram control points and spike locations are drawn anew
    for each key, in key order, as in the JAX package."""
    rng = np.random.default_rng(10)
    x1, x2 = (rng.standard_normal((1, 8, 9, 10)).astype(np.float32) for _ in range(2))
    a = {"t1": Volume(data=x1), "t2": Volume(data=x2)}
    b = {"t1": JVolume(data=x1), "t2": JVolume(data=x2)}
    for name in ("RandHistogramShiftd", "RandKSpaceSpikeNoised", "RandBiasFieldd"):
        got = getattr(intensity, name)(["t1", "t2"], prob=1.0)(a, np.random.default_rng(2))
        want = getattr(jintensity, name)(["t1", "t2"], prob=1.0)(b, np.random.default_rng(2))
        for key in ("t1", "t2"):
            _close(got[key].numpy(), want[key].numpy())


@pytest.mark.parametrize("minv,maxv", [(0.0, 1.0), (-1.0, 3.0)])
def test_scale_intensityd(minv, maxv):
    a, b = _pair(11, channels=2)
    _same(intensity.ScaleIntensityd("image", minv, maxv)(a),
          jintensity.ScaleIntensityd("image", minv, maxv)(b), keys=("image",))
    flat = {"image": Volume(data=np.full((1, 3, 3, 3), 2.0, np.float32))}
    np.testing.assert_array_equal(intensity.ScaleIntensityd("image")(flat)["image"].numpy(), 2.0)


def test_map_labels():
    a, b = _pair(12)
    mapping = {0: 0, 1: 5, 2: 1, 3: 9}
    _same(post.MapLabelsd(mapping, ["label"])(a), jpost.MapLabelsd(mapping, ["label"])(b),
          keys=("label",))
    arr = a["label"].numpy()
    np.testing.assert_array_equal(post.MapLabels(mapping)(arr), jpost.MapLabels(mapping)(arr))
    got = post.MapLabels(mapping)(a["label"])
    assert isinstance(got, Volume) and got.numpy().dtype == np.int64
    assert post.MapLabelsd(mapping, ["nope"])(a)["label"] is a["label"]


@pytest.mark.parametrize("channel_wise", [True, False])
@pytest.mark.parametrize("nonzero", [True, False])
def test_zscore(channel_wise, nonzero):
    rng = np.random.default_rng(13)
    x = (rng.standard_normal((3, 7, 8, 9)) * 4.0 + 2.0).astype(np.float32)
    x[rng.random(x.shape) < 0.3] = 0.0
    x[2] = 0.0  # a channel without a nonzero voxel; a constant one
    got = intensity_ops.zscore(torch.from_numpy(x), channel_wise, nonzero).numpy()
    want = np.asarray(jops.zscore(jnp.asarray(x), channel_wise, nonzero))
    _close(got, want)
    if nonzero:
        assert (got[x == 0] == 0).all()


def test_interp1d_host_and_device():
    rng = np.random.default_rng(14)
    xp = np.sort(rng.standard_normal(9) * 3.0)
    fp = np.sort(rng.standard_normal(9) * 2.0)
    x = np.concatenate([rng.standard_normal(500) * 5.0, xp]).astype(np.float32)  # beyond the ends
    want = jintensity.interp1d(x, xp, fp)
    np.testing.assert_array_equal(intensity.interp1d(x, xp, fp), want)
    got = intensity.interp1d_device(torch.from_numpy(x), xp, fp)
    assert got.dtype == torch.float32
    _close(got.numpy(), np.asarray(jintensity.interp1d_device(jnp.asarray(x), xp, fp)))
    _close(got.numpy(), want)


@pytest.mark.parametrize("nonzero_mask", [False, True])
@pytest.mark.parametrize("channel_wise", [False, True])
def test_nyul_normalize_fit_and_apply(nonzero_mask, channel_wise):
    rng = np.random.default_rng(15)
    arrays = []
    for _ in range(3):
        x = (rng.gamma(2.0, 30.0, (2, 8, 9, 10))).astype(np.float32)
        x[rng.random(x.shape) < 0.25] = 0.0
        arrays.append(x)
    kw = dict(nonzero_mask=nonzero_mask, channel_wise=channel_wise)
    port = intensity.NyulNormalize("image", **kw).fit([Volume(data=x) for x in arrays])
    ref = jintensity.NyulNormalize("image", **kw).fit([JVolume(data=x) for x in arrays])
    np.testing.assert_array_equal(port.quantiles, ref.quantiles)
    np.testing.assert_array_equal(port.standard_scale, ref.standard_scale)
    got = port({"image": Volume(data=arrays[0])})["image"].numpy()
    want = ref({"image": JVolume(data=arrays[0])})["image"].numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    with pytest.raises(RuntimeError, match="fit"):
        intensity.NyulNormalize("image")({"image": Volume(data=arrays[0])})
    with pytest.raises(RuntimeError, match="fit"):
        intensity.NyulNormalize("image").normalize_device(torch.zeros(3))
    # unsorted quantiles and their scale are sorted together
    q, s = [0.9, 0.1, 0.5], [3.0, 1.0, 2.0]
    p2, r2 = intensity.NyulNormalize(quantiles=q, standard_scale=s), \
        jintensity.NyulNormalize(quantiles=q, standard_scale=s)
    np.testing.assert_array_equal(p2.standard_scale, r2.standard_scale)
    np.testing.assert_array_equal(p2.quantiles, [0.1, 0.5, 0.9])


@pytest.mark.parametrize("nonzero_mask", [False, True])
@pytest.mark.parametrize("case", ["volume", "all_zero", "some_zero"])
def test_nyul_apply_device(nonzero_mask, case):
    rng = np.random.default_rng(16)
    x = rng.gamma(2.0, 30.0, (1, 10, 11, 12)).astype(np.float32)
    if case == "all_zero":
        x[:] = 0.0
    elif case == "some_zero":
        x[rng.random(x.shape) < 0.4] = 0.0
    nyul = intensity.NyulNormalize("image", nonzero_mask=nonzero_mask)
    nyul.fit([Volume(data=rng.gamma(2.0, 30.0, (1, 6, 6, 6)).astype(np.float32))])
    got = nyul.normalize_device(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == x.shape
    want = np.asarray(jintensity.nyul_apply_device(jnp.asarray(x), nyul.quantiles,
                                                   nyul.standard_scale, nonzero_mask))
    assert np.isfinite(got.numpy()).all()
    tol = 1e-5 * max(np.abs(want).max(), 1.0)
    assert np.abs(got.numpy() - want).max() <= tol
    host = nyul({"image": Volume(data=x)})["image"].numpy()
    assert np.abs(got.numpy() - host).max() <= 1e-5 * max(np.abs(host).max(), 1.0)
    if nonzero_mask:
        assert (got.numpy()[x == 0] == 0).all()


def test_nyul_apply_device_takes_more_than_16m_elements():
    """``torch.quantile`` refuses inputs above 2^24 elements; the landmarks
    come from a sort. A flat f32 array of 2^24 + 5 known values: the quantiles
    of a ramp are the ramp's own points."""
    n = 2 ** 24 + 5
    x = torch.linspace(0.0, 1.0, n)
    with pytest.raises(RuntimeError):
        torch.quantile(x, 0.5)
    q = np.array([0.0, 0.25, 0.5, 0.75, 1.0])
    scale = np.array([0.0, 10.0, 20.0, 30.0, 40.0])
    got = intensity.nyul_apply_device(x, q, scale)
    assert torch.allclose(got, 40.0 * x, atol=1e-4)
    np.testing.assert_allclose(intensity._quantiles(x, torch.from_numpy(q)).numpy(), q,
                               atol=1e-7)


@pytest.mark.parametrize("n", [1, 2, 7, 1000])
def test_sorted_quantiles_match_numpy(n):
    rng = np.random.default_rng(17)
    x = rng.standard_normal(n).astype(np.float32)
    q = np.linspace(0.0, 1.0, 11)
    got = intensity._quantiles(torch.from_numpy(x), torch.from_numpy(q)).numpy()
    np.testing.assert_allclose(got, np.quantile(x, q), rtol=1e-6, atol=1e-6)


def _mixed(mod_spatial, mod_intensity, mod_base, rng=None):
    return mod_base.Compose([
        mod_spatial.SpatialPadd(["image", "label"], [16, 16, 16]),
        mod_intensity.ScaleIntensityd("image", 0.0, 2.0),
        mod_base.Compose([
            mod_spatial.RandCropByLabelClassesd(["image", "label"], "label", [8, 8, 8], 4, 3),
            None,
            mod_spatial.RandFlipd(["image", "label"], 0.5, 1),
        ]),
        mod_spatial.RandRotated(["image", "label"], 0.7, range_x=0.3),
        mod_spatial.RandZoomd(["image", "label"], 0.7, 0.8, 1.2),
    ], rng=rng)


def test_compose_matches_the_jax_compose():
    a, b = _pair(18)
    port = _mixed(spatial, intensity, base)
    ref = _mixed(jspatial, jintensity, jbase)
    assert len(port.transforms) == 5 and len(port.flatten().transforms) == 6
    got = port.flatten()(a, np.random.default_rng(4))
    want = ref.flatten()(b, np.random.default_rng(4))
    assert isinstance(got, list) and len(got) == len(want) == 3
    for g, w in zip(got, want):
        _same(g, w)
    # the nested Compose is not random itself, so it is called without the rng
    # and draws from its own: the same on both sides
    nested_g = port(a, np.random.default_rng(4))
    nested_w = ref(b, np.random.default_rng(4))
    for g, w in zip(nested_g, nested_w):
        _same(g, w)


def test_compose_split_flatten_and_default_rng():
    port = _mixed(spatial, intensity, base).flatten()
    det, rand = port.split_deterministic()
    assert [type(t).__name__ for t in det.transforms] == ["SpatialPadd", "ScaleIntensityd"]
    assert [type(t).__name__ for t in rand.transforms] == [
        "RandCropByLabelClassesd", "RandFlipd", "RandRotated", "RandZoomd"]
    assert det.rng is port.rng and rand.rng is port.rng
    a, _ = _pair(19)
    whole = port(a, np.random.default_rng(1))
    halves = rand(det(a), np.random.default_rng(1))
    for g, w in zip(whole, halves):
        _same(g, w)
    # no fan-out: a dict comes back, and Compose(transforms) works without an rng
    plain = base.Compose([spatial.SpatialPadd(["image"], [16, 16, 16])])
    out = plain(a)
    assert isinstance(out, dict) and out["image"].spatial_shape == (16, 16, 16)
    all_det, none = plain.split_deterministic()
    assert len(all_det.transforms) == 1 and none.transforms == []
    # the default generator is seeded: two pipelines replay the same draws
    one = _mixed(spatial, intensity, base).flatten()(a)
    two = _mixed(spatial, intensity, base).flatten()(a)
    for g, w in zip(one, two):
        _same(g, w)
