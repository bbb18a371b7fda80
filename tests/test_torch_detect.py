"""The landmark transforms and the Gaussian smoothing against the JAX package's.

``gaussian_smooth`` (an XLA convolution in the JAX package, shifted slices
here) agrees within 1e-6 * max|ref| in f32; the five host transforms are numpy
copies and agree exactly; ``VertHeatMap`` smooths on the device it is given
(here the CPU; without a card the default ``"cuda"`` refuses) and agrees
within 1e-6 * max|ref| per channel, the centroid truncation, the peak
normalisation and the gamma included.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from segmantic_tpu.core.volume import Volume as JVolume
from segmantic_tpu.detect import transforms as jdt
from segmantic_tpu.ops.gaussian import gaussian_smooth as jgauss
from segmantic_tpu_torch import detect
from segmantic_tpu_torch.core.volume import Volume, affine_from_spacing_origin
from segmantic_tpu_torch.detect import transforms as tdt
from segmantic_tpu_torch.ops.gaussian import gaussian_smooth


@pytest.mark.parametrize("shape,sigma,dtype", [
    ((2, 11, 12, 13), 1.6, np.float32),
    ((1, 17, 9, 14), (0.8, 0.0, 2.3), np.float32),
    ((1, 15, 16), (1.2, 2.5), np.float32),
    ((1, 10, 11, 12), 0.9, np.int32),
    ((1, 10, 11, 12), (1.0, 1.5, 0.5), np.uint8),
    ((3, 21), 3.0, np.float64),
], ids=["3d-scalar", "3d-axis-skipped", "2d-per-axis", "3d-int", "3d-uint8", "1d-f64"])
def test_gaussian_smooth_matches_jax(shape, sigma, dtype):
    rng = np.random.default_rng(len(shape) + int(np.sum(sigma)))
    x = (rng.standard_normal(shape) * 40).astype(dtype) if np.issubdtype(dtype, np.floating) \
        else rng.integers(0, 200, shape).astype(dtype)
    x.flat[x.size // 3] = 255 if dtype == np.uint8 else 500  # an impulse on top
    sig = sigma if np.isscalar(sigma) else tuple(sigma)
    got = gaussian_smooth(torch.from_numpy(x), sig)
    want = np.asarray(jgauss(x, sig))
    want_dtype = x.dtype if np.issubdtype(dtype, np.floating) else np.float32
    if dtype == np.float64:  # jax without x64 computes and returns f32
        want_dtype = np.float32
        got = got.to(torch.float32)
    assert got.numpy().dtype == want.dtype == want_dtype
    assert np.abs(got.numpy() - want).max() <= 1e-6 * np.abs(want).max()
    if not np.isscalar(sigma) and 0.0 in sigma:  # a skipped axis is untouched
        x1 = torch.zeros((1, 5, 6, 15))
        x1[0, 2, 3, 7] = 1.0
        out = gaussian_smooth(x1, (0.0, 0.0, 1.0))
        assert out[0, :, :, 7].count_nonzero() == 1 and torch.isclose(out.sum(), torch.tensor(1.0))


def test_gaussian_smooth_takes_numpy_and_keeps_the_kernel_orientation():
    x = np.zeros((1, 9), np.float32)
    x[0, 4] = 1.0
    out = gaussian_smooth(x, 1.0, device="cpu").numpy()[0]
    np.testing.assert_allclose(out, out[::-1], rtol=0, atol=1e-8)
    assert abs(out.sum() - 1.0) < 1e-6 and out.argmax() == 4


def _spine(rng, shape=(20, 18, 30), classes=5):
    """A label volume of ``classes - 1`` stacked boxes (vertebrae) along axis 2."""
    lbl = np.zeros(shape, np.uint8)
    step = shape[2] // classes
    for k in range(1, classes):
        c0, c1 = rng.integers(4, 8), rng.integers(4, 8)
        lbl[c0:c0 + 8, c1:c1 + 7, k * step - 2:k * step + 2] = k
    return lbl


def _vols(lbl, affine):
    return (Volume(data=lbl[None], affine=affine.copy()),
            JVolume(data=lbl[None], affine=affine.copy()))


@pytest.mark.parametrize("as_volume", [True, False])
def test_vert_heat_map_matches_jax(as_volume):
    rng = np.random.default_rng(3)
    lbl = _spine(rng)
    aff = affine_from_spacing_origin((1.0, 1.0, 1.2))
    names = ["L1", "L2", "L3", "L4", "L5", "S1"]  # more names than classes: zero channels
    port, jax_ = _vols(lbl, aff) if as_volume else (lbl[None], lbl[None])
    got = tdt.VertHeatMap("label", gamma=100.0, label_names=names, device="cpu")(
        {"label": port})["label"]
    want = jdt.VertHeatMap("label", gamma=100.0, label_names=names)({"label": jax_})["label"]
    g = got.numpy() if as_volume else got
    w = np.asarray(want.numpy() if as_volume else want)
    assert g.dtype == w.dtype == np.float32 and g.shape == w.shape == (7,) + lbl.shape
    for c in range(7):
        assert np.abs(g[c] - w[c]).max() <= 1e-6 * max(np.abs(w[c]).max(), 1.0)
    assert np.isclose(g[1:5].max(axis=(1, 2, 3)), 100.0).all() and not g[5:].any()
    if as_volume:
        np.testing.assert_array_equal(got.affine, want.affine)


def test_vert_heat_map_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdt.VertHeatMap("label")
    assert tdt.VertHeatMap("label", device="cpu").device.type == "cpu"


def test_load_save_embed_extract_bbox_match_jax(tmp_path):
    """LoadVert -> EmbedVert -> VertHeatMap-free extraction -> SaveVert and
    BoundingBoxd through both packages, with Volume and raw-array inputs."""
    pts = {"L1": [3.0, 4.0, 5.0], "L2": [6.0, 7.5, 9.0], "T12": [2.0, 2.0, 2.6]}
    (tmp_path / "case_a.json").write_text(json.dumps(pts))
    (tmp_path / "case_b.json").write_text(json.dumps({"1": [1.0, 2.0, 3.0], "4": [4.0, 4, 4]}))
    aff = affine_from_spacing_origin((1.0, 0.5, 1.3), (1.0, -2.0, 0.5))
    img = np.zeros((1, 12, 20, 10), np.float32)
    for name in ("case_a.json", "case_b.json"):
        sample = {"verts": str(tmp_path / name)}
        got = tdt.LoadVert("verts")(sample)
        want = jdt.LoadVert("verts")(sample)
        assert got["verts_meta_dict"] == want["verts_meta_dict"]
        assert got["verts"].keys() == want["verts"].keys()
        for k in got["verts"]:
            np.testing.assert_array_equal(got["verts"][k], want["verts"][k])
        for as_volume in (True, False):
            # a Volume has a channel axis, a raw array is the spatial grid alone
            ref_p = Volume(data=img, affine=aff.copy()) if as_volume else img[0]
            ref_j = JVolume(data=img, affine=aff.copy()) if as_volume else img[0]
            meta = {} if as_volume else {"image_meta_dict": {"affine": aff}}
            eg = tdt.EmbedVert("verts", ref_key="image")(dict(got, image=ref_p, **meta))
            ew = jdt.EmbedVert("verts", ref_key="image")(dict(want, image=ref_j, **meta))
            eg_arr = eg["verts"].numpy() if as_volume else eg["verts"]
            ew_arr = ew["verts"].numpy() if as_volume else ew["verts"]
            np.testing.assert_array_equal(eg_arr, ew_arr)
            assert eg_arr.any()
            bg = tdt.BoundingBoxd("verts")(eg)
            bw = jdt.BoundingBoxd("verts")(ew)
            assert bg["result"] == bw["result"]
            # a one-hot heat map of the embedded points, then the peaks back
            ids = sorted(got["verts"])
            heat = np.zeros((max(ids) + 1,) + img.shape[1:], np.float32)
            emb = eg_arr[0] if as_volume else eg_arr
            for i in ids:
                heat[i][emb == i] = 1.0
            hp = Volume(data=heat, affine=aff.copy()) if as_volume else heat
            hj = JVolume(data=heat, affine=aff.copy()) if as_volume else heat
            xg = tdt.ExtractVertPosition("heat")(dict(heat=hp, **({} if as_volume else {
                "heat_meta_dict": {"affine": aff}})))
            xw = jdt.ExtractVertPosition("heat")(dict(heat=hj, **({} if as_volume else {
                "heat_meta_dict": {"affine": aff}})))
            assert xg["heat"].keys() == xw["heat"].keys() == set(ids)
            for k in ids:
                np.testing.assert_array_equal(xg["heat"][k], xw["heat"][k])
        out_p, out_j = tmp_path / "port", tmp_path / "jax"
        tdt.SaveVert("verts", output_dir=out_p, print_log=False)(got)
        jdt.SaveVert("verts", output_dir=out_j, print_log=False)(want)
        stem = name[:-5]
        assert (out_p / stem / f"{stem}_trans.json").read_text() == \
            (out_j / stem / f"{stem}_trans.json").read_text()


def test_detect_exports_match():
    from segmantic_tpu import detect as jdetect

    assert detect.__all__ == jdetect.__all__
    assert all(hasattr(detect, n) for n in detect.__all__)
