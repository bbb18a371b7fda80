"""Config-driven ``preprocessing`` / ``augmentation`` through the port's
``train()``, 3D at tiny size (the 2D twin of ``tests/train/test_config_paths.py``
is ``tests/test_torch_2d_e2e.py``).

``_host_augment_batch`` against the JAX package's function on the same
stand-in cache (each package's own ``Volume`` around the same arrays), the same
pipeline config and the same ``(seed, epoch, step)``: bit-equal, the pipeline
being pure numpy on both sides (pad, class-balanced crop, flip, rotate, zoom).
``train(device="cpu")`` with a config ``preprocessing`` fills the cache that
``default_preprocessing`` fills for the equivalent settings; with a config
``augmentation`` it takes the host path (no ``PrefetchLoader``) and steps on
batches of ``batch_size * num_samples`` patches; ``train-config`` reads both
dicts from a JSON file.
"""

from __future__ import annotations

import functools
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from segmantic_tpu.core.volume import Volume as JVolume
from segmantic_tpu.train import trainer as jtrainer
from segmantic_tpu.transforms import registry as jregistry
from segmantic_tpu_torch.core.volume import Volume
from segmantic_tpu_torch.data import cache
from segmantic_tpu_torch.train import trainer
from segmantic_tpu_torch.transforms import registry
from tests.test_torch_train import SMALL, phantoms  # noqa: F401  (fixture)

KEYS = ["@image_key", "@label_key"]
PREPROCESSING = {
    "_target_": "Compose",
    "transforms": [
        {"_target_": "LoadImaged", "keys": KEYS},
        {"_target_": "Orientationd", "keys": KEYS},
        {"_target_": "NormalizeIntensityd", "keys": "@image_key"},
        {"_target_": "CropForegroundd", "keys": KEYS, "source_key": "@label_key"},
        {"_target_": "EnsureTyped", "keys": KEYS},
    ],
}


def _augmentation(size, num_samples, prob=0.5):
    return {
        "_target_": "Compose",
        "transforms": [
            {"_target_": "SpatialPadd", "keys": KEYS, "spatial_size": size},
            {"_target_": "RandCropByLabelClassesd", "keys": KEYS, "label_key": "@label_key",
             "spatial_size": size, "num_classes": 4, "num_samples": num_samples},
            {"_target_": "RandFlipd", "keys": KEYS, "prob": prob, "spatial_axis": 0},
            {"_target_": "RandFlipd", "keys": KEYS, "prob": 0.5, "spatial_axis": 2,
             "_disabled_": True},
            {"_target_": "RandRotated", "keys": KEYS, "prob": prob, "range_z": "$3.0 / 10"},
            {"_target_": "RandZoomd", "keys": KEYS, "prob": prob, "min_zoom": 0.8,
             "max_zoom": 1.2},
        ],
    }


def _stand_in_caches(seed=0, n=3):
    """The same volumes as a list of objects with ``.image`` / ``.label``, once
    around the port's ``Volume`` and once around the JAX package's."""
    rng = np.random.default_rng(seed)
    port, ref = [], []
    for shape in [(14, 18, 20), (20, 12, 16), (16, 16, 16)][:n]:  # one axis below the patch
        lbl = rng.integers(0, 4, (1, *shape)).astype(np.int32)
        img = (lbl + 0.3 * rng.standard_normal((1, *shape))).astype(np.float32)
        aff = np.diag([1.0, 1.5, 2.0, 1.0])
        port.append(SimpleNamespace(image=Volume(data=img, affine=aff.copy()),
                                    label=Volume(data=lbl, affine=aff.copy())))
        ref.append(SimpleNamespace(image=JVolume(data=img, affine=aff.copy()),
                                   label=JVolume(data=lbl, affine=aff.copy())))
    return port, ref


@pytest.mark.parametrize("seed,epoch,step", [(0, 0, 0), (0, 1, 2), (7, 3, 1), (11, 0, 5)])
def test_host_augment_batch_is_bit_equal_to_the_jax_function(seed, epoch, step):
    port, ref = _stand_in_caches()
    cfg = _augmentation([16, 16, 16], 3)
    got = trainer._host_augment_batch(port, registry.build_pipeline(cfg), 2, 3, seed, epoch,
                                      step)
    want = jtrainer._host_augment_batch(ref, jregistry.build_pipeline(cfg), 2, 3, seed,
                                        epoch, step)
    assert got[0].shape == (6, 16, 16, 16, 1) and got[0].dtype == np.float32
    assert got[1].shape == (6, 16, 16, 16) and got[1].dtype == np.int32
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_host_augment_batch_depends_on_seed_epoch_and_step_only():
    port, _ = _stand_in_caches()
    aug = registry.build_pipeline(_augmentation([16, 16, 16], 2))
    a = trainer._host_augment_batch(port, aug, 2, 2, 3, 1, 4)
    b = trainer._host_augment_batch(port, aug, 2, 2, 3, 1, 4)
    c = trainer._host_augment_batch(port, aug, 2, 2, 3, 1, 5)
    np.testing.assert_array_equal(a[0], b[0])
    assert not np.array_equal(a[0], c[0])


def test_train_with_config_preprocessing_fills_the_default_cache(phantoms, tmp_path,  # noqa: F811
                                                                 monkeypatch):
    root, dataset, _ = phantoms
    built = []
    real = cache.VolumeCache

    def spy(files, pre, *a, **kw):
        built.append(pre)
        return real(files, pre, *a, **kw)

    monkeypatch.setattr(trainer, "VolumeCache", spy)
    result = trainer.train(image_dir=root / "image", labels_dir=root / "label",
                           output_dir=tmp_path / "run", preprocessing=PREPROCESSING,
                           max_epochs=1, device="cpu", **SMALL)
    assert len(result.history) == 1 and np.isfinite(result.history[0]["train_loss"])
    assert np.isfinite(result.history[0]["val_loss"])
    names = [type(t).__name__ for t in built[0].transforms]
    assert names == ["LoadImaged", "Orientationd", "NormalizeIntensityd", "CropForegroundd",
                     "EnsureTyped"]
    files = dataset.training_files()
    got = real(files, built[0], 4)
    want = real(files, trainer.default_preprocessing(["image", "label"]), 4)
    for i in range(len(files)):
        np.testing.assert_array_equal(got[i].image.numpy(), want[i].image.numpy())
        np.testing.assert_array_equal(got[i].label.numpy(), want[i].label.numpy())
        np.testing.assert_array_equal(got[i].image.affine, want[i].image.affine)


def test_train_with_config_augmentation_takes_the_host_path(phantoms, tmp_path,  # noqa: F811
                                                            monkeypatch):
    root, _, _ = phantoms

    def no_loader(*a, **kw):
        raise AssertionError("the host path starts no PrefetchLoader")

    monkeypatch.setattr(trainer, "PrefetchLoader", no_loader)
    batches = []
    real = trainer._host_augment_batch

    def spy(*a):
        out = real(*a)
        batches.append((a[4:], out[0].shape, out[1].shape))
        return out

    monkeypatch.setattr(trainer, "_host_augment_batch", spy)
    result = trainer.train(image_dir=root / "image", labels_dir=root / "label",
                           output_dir=tmp_path / "run",
                           augmentation=_augmentation([16, 16, 16], 3, prob=0.3),
                           num_samples=3, batch_size=2, max_epochs=2, device="cpu", **SMALL)
    assert len(result.history) == 2
    assert all(np.isfinite(r["train_loss"]) and np.isfinite(r["val_loss"])
               for r in result.history)
    assert (tmp_path / "run" / "last.ckpt").exists()
    assert [b[0] for b in batches] == [(0, e, s) for e in range(2) for s in range(2)]
    assert all(b[1] == (6, 16, 16, 16, 1) and b[2] == (6, 16, 16, 16) for b in batches)


def test_cli_train_config_takes_both_dicts_from_a_json_file(phantoms, tmp_path,  # noqa: F811
                                                            monkeypatch):
    from click.testing import CliRunner

    from segmantic_tpu_torch.commands.unet_cli import app

    _, _, datalist = phantoms
    settings = dict(SMALL, datalist=str(datalist), output_dir=str(tmp_path / "out"),
                    num_classes=0, max_epochs=1, device="cpu", num_samples=2,
                    preprocessing=PREPROCESSING,
                    augmentation=_augmentation([16, 16, 16], 2, prob=0.2))
    cfg = tmp_path / "train.json"
    cfg.write_text(json.dumps(settings))
    seen = {}
    real = trainer.train

    @functools.wraps(real)  # train-config validates against the signature
    def spy(**kw):
        seen.update(kw)
        return real(**kw)

    monkeypatch.setattr(trainer, "train", spy)
    res = CliRunner().invoke(app, ["train-config", "-c", str(cfg)])
    assert res.exit_code == 0, res.output
    assert seen["preprocessing"] == PREPROCESSING
    assert seen["augmentation"] == settings["augmentation"]
    history = json.loads((tmp_path / "out" / "history.json").read_text())
    assert len(history) == 1 and np.isfinite(history[0]["train_loss"])


def test_config_pipelines_leave_no_option_of_the_other_refusals(tmp_path):
    """The other refused options still raise with a config pipeline given."""
    with pytest.raises(NotImplementedError, match="JAX trainer refuses it"):
        trainer.train(output_dir=tmp_path, num_classes=2, device="cpu",
                      augmentation=_augmentation([8, 8, 8], 1), dropout=0.1)


def test_host_batch_feeds_the_train_step(phantoms):  # noqa: F811
    """int32 labels and f32 channel-last images, as the host path collates
    them, go through ``make_train_step`` like the sampler's batches."""
    from segmantic_tpu_torch.train.augment import AugmentConfig
    from segmantic_tpu_torch.train.optim import make_optimizer

    port, _ = _stand_in_caches()
    image, label = trainer._host_augment_batch(
        port, registry.build_pipeline(_augmentation([16, 16, 16], 2)), 2, 2, 0, 0, 0)
    model = trainer.SegmentationModel.create(
        num_classes=4, spatial_size=[16, 16, 16], channels=(4, 8, 16), strides=(2, 2), seed=0,
        device="cpu")
    module = model.module.train().requires_grad_(True)
    opt = make_optimizer(module.parameters(), {"optimizer": "Adam", "lr": 1e-3})
    step = trainer.make_train_step(module, opt, AugmentConfig(), [16, 16, 16], False)
    loss = step(torch.from_numpy(image), torch.from_numpy(label))
    assert torch.isfinite(loss)
