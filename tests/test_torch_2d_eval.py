"""A 2D checkpoint the port trained, through the port's ``predict``,
``ensemble_creator`` and ``serve`` against the JAX package's, on the CPU.

The data are those of ``tests/infer/test_predict.py`` (24x20 images with an
anisotropic affine); ``train(spatial_dims=2, device="cpu")`` writes the
checkpoints, which both packages read. Both forwards run in f32 (patched as
in ``tests/test_torch_predict.py``), so only summation order differs: saved
label maps agree on >= 99.9% of pixels, and where they are equal the Dice
values agree within 1e-6. The twins of ``test_predict_with_spacing_and_metrics``
(``:33``), ``test_ensemble_modes`` and ``test_predict_flipped_2d_affine_matches_physical``
(``:108``: a negative-determinant 2D affine predicts the same physical map),
and of ``tests/test_serve.py`` (2D health, info and segment round trip over
a socket).
"""

from __future__ import annotations

import json
import threading
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import segmantic_tpu.infer.ensemble as jensemble
import segmantic_tpu.infer.predict as jpredict
import segmantic_tpu.serve as jserve
import segmantic_tpu.train.trainer as jtrainer
import segmantic_tpu_torch.infer.ensemble as pensemble
import segmantic_tpu_torch.infer.predict as ppredict
import segmantic_tpu_torch.serve as pserve
from segmantic_tpu.core.volume import Volume, affine_from_spacing_origin
from segmantic_tpu.io.nifti import read_volume, write_volume
from segmantic_tpu.utils import config as jcfg
from segmantic_tpu_torch.train import trainer
from tests.test_torch_predict import _agreement, f32_forwards

TISSUES = {"A": 1, "B": 2}


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("predict2d")
    img_dir, lbl_dir = root / "image", root / "label"
    img_dir.mkdir()
    lbl_dir.mkdir()
    rng = np.random.default_rng(0)
    aff = affine_from_spacing_origin((1.0, 1.5), (3.0, -2.0))
    for i in range(4):
        lbl = np.zeros((24, 20), np.int32)
        lbl[4:12, 4:12] = 1
        lbl[14:20, 12:18] = 2
        img = (lbl == 1) * 2.0 + (lbl == 2) * -2.0 + rng.normal(0, 0.2, (24, 20))
        write_volume(img_dir / f"c{i}.nii.gz",
                     Volume(data=img.astype(np.float32)[None], affine=aff))
        write_volume(lbl_dir / f"c{i}.nii.gz",
                     Volume(data=lbl.astype(np.uint8)[None], affine=aff.copy()))
    result = trainer.train(
        image_dir=img_dir, labels_dir=lbl_dir, output_dir=root / "run", num_classes=3,
        spatial_dims=2, spatial_size=(16, 16), channels=(8, 16), strides=(2,), max_epochs=8,
        mixed_precision=False, optimizer={"optimizer": "Adam", "lr": 3e-3},
        val_roi_size=(24, 24), seed=0, device="cpu")
    return root, img_dir, lbl_dir, result


def test_predict_with_spacing_and_metrics_matches_jax(trained, tmp_path, monkeypatch):
    root, img_dir, lbl_dir, result = trained
    f32_forwards(monkeypatch, jpredict, ppredict)
    kw = dict(test_images=[img_dir / "c0.nii.gz", img_dir / "c1.nii.gz"],
              test_labels=[lbl_dir / "c0.nii.gz", lbl_dir / "c1.nii.gz"],
              tissue_dict=TISSUES, spacing=[1.2, 1.2], save_confusion_plots=False)
    want = jpredict.predict(model_file=result.best_checkpoint, output_dir=tmp_path / "jax", **kw)
    got = ppredict.predict(model_file=result.best_checkpoint, output_dir=tmp_path / "port",
                           device="cpu", **kw)
    assert len(got) == len(want) == 2
    orig = read_volume(img_dir / "c0.nii.gz")
    for g, w in zip(got, want):
        pred = read_volume(g.saved_to)
        assert pred.spatial_shape == orig.spatial_shape  # inverted onto the original grid
        np.testing.assert_allclose(pred.affine, orig.affine, atol=1e-4)
        agree = _agreement(g.saved_to, w.saved_to)
        assert agree >= 0.999, agree
        assert g.dice > 0.5
        if agree == 1.0:
            assert abs(g.dice - w.dice) <= 1e-6
            np.testing.assert_allclose(g.per_class_dice, w.per_class_dice, atol=1e-6)
    assert (tmp_path / "port" / "mean_dice.txt").exists()


def test_ensemble_modes_match_jax(trained, tmp_path, monkeypatch):
    root, img_dir, _, _ = trained
    f32_forwards(monkeypatch, jensemble, pensemble)
    ckpts = sorted((root / "run").glob("*.ckpt"))
    assert len(ckpts) >= 2
    yml = tmp_path / "select.yml"
    jcfg.dump({"A": 0, "B": 1}, yml)
    for mode in ("mean", "vote", "select_best"):
        kw = dict(model_files=ckpts[:2], test_images=[img_dir / "c1.nii.gz"],
                  tissue_dict=TISSUES, combination_mode=mode, roi_size=(16, 16))
        if mode == "select_best":
            kw["candidate_per_tissue_path"] = yml
        want = jensemble.ensemble_creator(output_dir=tmp_path / f"jax_{mode}", **kw)
        got = pensemble.ensemble_creator(output_dir=tmp_path / f"port_{mode}", device="cpu",
                                         **kw)
        assert len(got) == len(want) == 1 and got[0].name == want[0].name
        assert set(np.unique(read_volume(got[0]).numpy())) <= {0, 1, 2}
        assert _agreement(got[0], want[0]) >= 0.999, mode


def test_predict_flipped_2d_affine_matches_physical(trained, tmp_path, monkeypatch):
    """A 2D image stored with a flipped (negative-determinant) affine predicts
    the same physical segmentation as its unflipped twin, lands back on the
    flipped grid, and agrees with the JAX package's prediction of it."""
    _, img_dir, _, result = trained
    f32_forwards(monkeypatch, jpredict, ppredict)
    orig = read_volume(img_dir / "c0.nii.gz")
    data = orig.numpy()
    flipped = data[:, ::-1, :].copy()
    aff = orig.affine.copy()
    aff[:3, 3] = aff[:3, 3] + aff[:3, 0] * (data.shape[1] - 1)
    aff[:3, 0] = -aff[:3, 0]
    flip_dir = tmp_path / "flip"
    flip_dir.mkdir()
    write_volume(flip_dir / "c0f.nii.gz", Volume(data=flipped, affine=aff))

    kw = dict(save_confusion_plots=False, device="cpu")
    ppredict.predict(result.best_checkpoint, [img_dir / "c0.nii.gz"],
                     output_dir=tmp_path / "a", **kw)
    ppredict.predict(result.best_checkpoint, [flip_dir / "c0f.nii.gz"],
                     output_dir=tmp_path / "b", **kw)
    jpredict.predict(result.best_checkpoint, [flip_dir / "c0f.nii.gz"],
                     output_dir=tmp_path / "jax_b", save_confusion_plots=False)
    pred_a = read_volume(next((tmp_path / "a").rglob("*.nii.gz")))
    path_b = next((tmp_path / "b").rglob("*.nii.gz"))
    pred_b = read_volume(path_b)
    assert pred_b.spatial_shape == orig.spatial_shape
    np.testing.assert_allclose(pred_b.affine, aff, atol=1e-4)
    np.testing.assert_array_equal(pred_b.numpy()[:, ::-1, :], pred_a.numpy())
    assert _agreement(path_b, next((tmp_path / "jax_b").rglob("*.nii.gz"))) >= 0.999


def test_serve_2d_round_trip_matches_jax(trained, tmp_path, monkeypatch):
    _, _, _, result = trained
    jax_forward = jtrainer.make_val_forward
    monkeypatch.setattr(pserve, "make_val_forward",
                        lambda m: trainer.make_val_forward(m, torch.float32))
    monkeypatch.setattr(jtrainer, "make_val_forward", lambda m: jax_forward(m, jnp.float32))
    session = pserve.InferenceSession(result.best_checkpoint, sw_batch_size=2, device="cpu")
    srv = pserve.make_server(session, host="127.0.0.1", port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        with urllib.request.urlopen(f"{base}/v1/info") as r:
            info = json.loads(r.read())
        assert info["spatial_dims"] == 2 and info["num_classes"] == 3
        img = np.random.default_rng(0).standard_normal((24, 20)).astype(np.float32)
        in_path = tmp_path / "in.nii.gz"
        write_volume(in_path, Volume(data=img[None],
                                     affine=affine_from_spacing_origin((1.0, 1.5), (2.0, -1.0))))
        req = urllib.request.Request(f"{base}/v1/segment", data=in_path.read_bytes(),
                                     method="POST")
        with urllib.request.urlopen(req) as r:
            (tmp_path / "port.nii.gz").write_bytes(r.read())
    finally:
        srv.shutdown()
        srv.server_close()
    jsession = jserve.InferenceSession(result.best_checkpoint, sw_batch_size=2)
    (tmp_path / "jax.nii.gz").write_bytes(jsession.segment_bytes(in_path.read_bytes()))
    got = read_volume(tmp_path / "port.nii.gz")
    assert got.spatial_shape == (24, 20)
    assert _agreement(tmp_path / "port.nii.gz", tmp_path / "jax.nii.gz") >= 0.999
