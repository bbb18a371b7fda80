"""``train()`` in 2D from config dicts and the CLI, on the CPU.

The twins of ``tests/train/test_config_paths.py`` in 2D with
``device="cpu"`` on the toy of ``tests/test_torch_2d_e2e.py``: a config
``preprocessing``, a config ``augmentation`` (the host path) and the fused
device augmentation each train one finite epoch; SegResNet 2D trains;
``train-config`` takes ``spatial_dims: 2``; the validation roi defaults to
160 along each of the 2 axes (the JAX package's ``[160] * spatial_dims``).
"""

from __future__ import annotations

import json

import numpy as np

from segmantic_tpu_torch.train import trainer
from tests.test_torch_2d_e2e import TWIN, toy_2d  # noqa: F401  (a fixture)


def test_train_segresnet_2d(toy_2d, tmp_path):
    img_dir, lbl_dir = toy_2d
    result = trainer.train(image_dir=img_dir, labels_dir=lbl_dir, output_dir=tmp_path / "run",
                           arch="segresnet",
                           arch_params={"init_filters": 4, "blocks_down": [1, 2],
                                        "blocks_up": [1]},
                           max_epochs=2, **TWIN)
    assert len(result.history) == 2
    assert all(np.isfinite(h["train_loss"]) for h in result.history)
    assert isinstance(result.model.module, trainer.SegResNet)
    assert result.model.module.spatial_dims == 2


CONFIG = dict(num_classes=3, spatial_dims=2, spatial_size=(16, 16), channels=(4, 8),
              strides=(2,), max_epochs=1, mixed_precision=False, val_roi_size=(24, 24),
              device="cpu")


def test_train_with_config_preprocessing_2d(toy_2d, tmp_path):
    img_dir, lbl_dir = toy_2d
    keys = ["@image_key", "@label_key"]
    result = trainer.train(
        image_dir=img_dir, labels_dir=lbl_dir, output_dir=tmp_path / "run",
        preprocessing={"_target_": "Compose", "transforms": [
            {"_target_": "LoadImaged", "keys": keys},
            {"_target_": "Orientationd", "keys": keys},
            {"_target_": "NormalizeIntensityd", "keys": "@image_key"},
            {"_target_": "EnsureTyped", "keys": keys},
        ]}, **CONFIG)
    assert len(result.history) == 1 and np.isfinite(result.history[0]["train_loss"])


def test_train_with_config_augmentation_host_path_2d(toy_2d, tmp_path):
    img_dir, lbl_dir = toy_2d
    keys = ["@image_key", "@label_key"]
    result = trainer.train(
        image_dir=img_dir, labels_dir=lbl_dir, output_dir=tmp_path / "run",
        augmentation={"_target_": "Compose", "transforms": [
            {"_target_": "SpatialPadd", "keys": keys, "spatial_size": [16, 16]},
            {"_target_": "RandCropByLabelClassesd", "keys": keys, "label_key": "@label_key",
             "spatial_size": [16, 16], "num_classes": 3, "num_samples": 2},
            {"_target_": "RandFlipd", "keys": keys, "prob": 0.5, "spatial_axis": 0},
        ]}, **CONFIG)
    assert len(result.history) == 1 and np.isfinite(result.history[0]["train_loss"])


def test_train_with_fused_device_augmentation_2d(toy_2d, tmp_path):
    img_dir, lbl_dir = toy_2d
    result = trainer.train(image_dir=img_dir, labels_dir=lbl_dir, output_dir=tmp_path / "run",
                           augment_spatial=True, augment_intensity=True, **CONFIG)
    assert len(result.history) == 1 and np.isfinite(result.history[0]["train_loss"])


def test_validation_roi_defaults_to_160_along_each_axis(toy_2d, tmp_path, monkeypatch):
    """The JAX package's ``[160] * spatial_dims``: (160, 160) in 2D."""
    img_dir, lbl_dir = toy_2d
    rois = []
    real = trainer.sliding_window_inference

    def spy(volume, roi, *args, **kw):
        rois.append(tuple(roi))
        return real(volume, roi, *args, **kw)

    monkeypatch.setattr(trainer, "sliding_window_inference", spy)
    trainer.train(image_dir=img_dir, labels_dir=lbl_dir, output_dir=tmp_path / "run",
                  **{k: v for k, v in CONFIG.items() if k != "val_roi_size"})
    assert rois and set(rois) == {(160, 160)}


def test_cli_train_config_takes_spatial_dims_2(toy_2d, tmp_path):
    from click.testing import CliRunner

    from segmantic_tpu_torch.commands.unet_cli import app

    img_dir, lbl_dir = toy_2d
    settings = dict(CONFIG, image_dir=str(img_dir), labels_dir=str(lbl_dir),
                    output_dir=str(tmp_path / "out"), spatial_size=[16, 16],
                    channels=[4, 8], strides=[2], val_roi_size=[24, 24])
    cfg = tmp_path / "train.json"
    cfg.write_text(json.dumps(settings))
    res = CliRunner().invoke(app, ["train-config", "-c", str(cfg)])
    assert res.exit_code == 0, res.output
    history = json.loads((tmp_path / "out" / "history.json").read_text())
    assert len(history) == 1 and np.isfinite(history[0]["train_loss"])
    model = trainer.SegmentationModel.load(tmp_path / "out" / "last.ckpt", device="cpu")
    assert model.spatial_dims == 2
