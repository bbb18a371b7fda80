"""``train()`` in 2D through the port against the JAX package, on the CPU.

The twins of ``tests/train/test_end_to_end.py`` (train, resume) in 2D with
``device="cpu"``, on the same toy data: the trained checkpoint loads in the
JAX package, whose forward agrees with the port's within 1e-5 * max|ref|
(f32), and the JAX package's save of it loads back in the port bit-equal.
The config-path twins are ``tests/test_torch_2d_config.py``.
"""

from __future__ import annotations

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmantic_tpu.core.volume import Volume as JVolume
from segmantic_tpu.core.volume import affine_from_spacing_origin
from segmantic_tpu.io.nifti import write_volume
from segmantic_tpu.train import checkpoint as jckpt
from segmantic_tpu.train import trainer as jtrainer
from segmantic_tpu_torch.train import trainer
from tests.train.test_end_to_end import synth_case


@pytest.fixture(scope="module")
def toy_2d(tmp_path_factory):
    """The 2D toy of ``tests/train/test_end_to_end.py``: six 32x32 cases."""
    root = tmp_path_factory.mktemp("toy2d")
    img_dir, lbl_dir = root / "image", root / "label"
    img_dir.mkdir()
    lbl_dir.mkdir()
    rng = np.random.default_rng(0)
    aff = affine_from_spacing_origin((1.0, 1.0))
    for i in range(6):
        img, lbl = synth_case(rng)
        write_volume(img_dir / f"case{i}.nii.gz", JVolume(data=img[None], affine=aff))
        write_volume(lbl_dir / f"case{i}.nii.gz",
                     JVolume(data=lbl[None].astype(np.uint8), affine=aff.copy()))
    return img_dir, lbl_dir


TWIN = dict(num_classes=3, spatial_dims=2, spatial_size=(16, 16), mixed_precision=False,
            val_roi_size=(32, 32), device="cpu")


def test_train_end_to_end_2d(toy_2d, tmp_path):
    img_dir, lbl_dir = toy_2d
    out = tmp_path / "run"
    result = trainer.train(image_dir=img_dir, labels_dir=lbl_dir, output_dir=out,
                           channels=(4, 8, 16), strides=(2, 2), num_samples=4, batch_size=2,
                           max_epochs=6, early_stop_patience=50,
                           optimizer={"optimizer": "Adam", "lr": 3e-3}, seed=0, **TWIN)
    assert (out / "Dataset.json").exists() and (out / "history.json").exists()
    assert result.best_checkpoint is not None and result.best_checkpoint.exists()
    history = json.loads((out / "history.json").read_text())
    assert len(history) == 6
    assert history[-1]["train_loss"] < history[0]["train_loss"]
    assert result.best_val_dice > 0.35, result.best_val_dice

    # the checkpoint rebuilds the model in both packages, with the same forward
    model = trainer.SegmentationModel.load(result.best_checkpoint, device="cpu")
    assert model.num_classes == 3 and model.spatial_dims == 2
    jmodel = jtrainer.SegmentationModel.load(result.best_checkpoint)
    x = np.random.default_rng(1).standard_normal((1, 16, 16, 1)).astype(np.float32)
    want = np.asarray(jmodel.apply(jnp.asarray(x)))
    with torch.no_grad():
        got = model.module(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, 16, 16, 3)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()

    # and back: the JAX package's save of it loads in the port bit-equal
    back = tmp_path / "back.ckpt"
    jckpt.save_checkpoint(back, jmodel.variables, jmodel.hparams)
    again = trainer.SegmentationModel.load(back, device="cpu")
    for key, value in model.module.state_dict().items():
        assert torch.equal(again.module.state_dict()[key], value), key


def test_train_resume_from_checkpoint_2d(toy_2d, tmp_path):
    img_dir, lbl_dir = toy_2d
    first = trainer.train(image_dir=img_dir, labels_dir=lbl_dir, output_dir=tmp_path / "first",
                          channels=(4, 8), strides=(2,), max_epochs=2, **TWIN)
    assert first.best_checkpoint is not None
    resumed = trainer.train(image_dir=img_dir, labels_dir=lbl_dir,
                            output_dir=tmp_path / "second",
                            checkpoint_file=first.best_checkpoint, max_epochs=1,
                            **{k: v for k, v in TWIN.items() if k != "spatial_size"})
    assert len(resumed.history) == 1
    assert resumed.model.spatial_dims == 2 and resumed.model.spatial_size == [16, 16]
