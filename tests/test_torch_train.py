"""``train()`` of the PyTorch port end to end on the CPU, and its data and
metric layers, vs the JAX package.

Tiny nested-ellipsoid phantoms (24-32 voxels a side, 4 classes) are written
as NIfTI; the port trains a small UNet (channels (4, 8, 16)) for two epochs
on ``device="cpu"`` and writes ``Dataset.json``, ``history.json``,
``last.ckpt`` and its top-k checkpoints, which the JAX package's
``SegmentationModel.load`` reads back to the same forward (f32, 1e-4
absolute + 1e-3 relative). The patch sampler gives the JAX package's batches
for one seed (exactly); validation, the confusion matrix and the flips
agree with the JAX functions; the CLI subcommands train; training runs with
jax unimportable; unported options raise naming the ROADMAP.
"""

from __future__ import annotations

import json
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmantic_tpu.core.volume import Volume, affine_from_spacing_origin
from segmantic_tpu.data import cache as jcache
from segmantic_tpu.data.dataset import PairedDataSet
from segmantic_tpu.io.nifti import write_volume
from segmantic_tpu.metrics import overlap as joverlap
from segmantic_tpu.train import trainer as jtrainer
from segmantic_tpu.transforms import intensity_ops as jiops
from segmantic_tpu_torch.data import cache
from segmantic_tpu_torch.metrics import overlap
from segmantic_tpu_torch.train import checkpoint, trainer
from segmantic_tpu_torch.train.augment import AugmentConfig, augment_batch
from segmantic_tpu_torch.transforms import intensity_ops
from tests.test_torch_unet_slice import _flax_variables

REPO = Path(__file__).resolve().parent.parent
SMALL = dict(num_classes=4, spatial_size=(16, 16, 16), channels=(4, 8, 16), strides=(2, 2),
             mixed_precision=False, optimizer={"optimizer": "Adam", "lr": 3e-3},
             val_roi_size=(16, 16, 16), seed=0)


def _phantom(rng, shape):
    grid = np.stack(np.meshgrid(*[np.linspace(-1, 1, s) for s in shape], indexing="ij"))
    lbl = np.zeros(shape, np.uint8)
    for k, radius in enumerate((0.9, 0.6, 0.3)):
        center = rng.uniform(-0.1, 0.1, 3)[:, None, None, None]
        lbl[(((grid - center) / radius) ** 2).sum(0) < 1] = k + 1
    img = (lbl * 1.0 + 0.2 * rng.standard_normal(shape)).astype(np.float32)
    return img, lbl


@pytest.fixture(scope="module")
def phantoms(tmp_path_factory):
    root = tmp_path_factory.mktemp("phantoms")
    (root / "image").mkdir()
    (root / "label").mkdir()
    rng = np.random.default_rng(0)
    aff = affine_from_spacing_origin((1.0, 1.0, 1.0))
    for i, shape in enumerate([(24, 28, 32), (32, 24, 28), (28, 32, 24), (24, 24, 24),
                               (32, 28, 24)]):
        img, lbl = _phantom(rng, shape)
        write_volume(root / "image" / f"c{i}.nii.gz", Volume(data=img[None], affine=aff))
        write_volume(root / "label" / f"c{i}.nii.gz", Volume(data=lbl[None], affine=aff.copy()))
    dataset = PairedDataSet(root / "image", "*.nii.gz", root / "label", "*.nii.gz",
                            random_seed=0)
    datalist = root / "datalist.json"
    doc = json.loads(dataset.dump_dataset())
    doc["labels"] = {"0": "Background", "1": "a", "2": "b", "3": "c"}
    datalist.write_text(json.dumps(doc))
    return root, dataset, datalist


@pytest.fixture(scope="module")
def trained(phantoms, tmp_path_factory):
    root, _, _ = phantoms
    out = tmp_path_factory.mktemp("run")
    result = trainer.train(image_dir=root / "image", labels_dir=root / "label",
                           output_dir=out, max_epochs=2, device="cpu", **SMALL)
    return out, result


def test_train_writes_history_and_checkpoints(trained):
    out, result = trained
    assert (out / "Dataset.json").exists() and (out / "last.ckpt").exists()
    history = json.loads((out / "history.json").read_text())
    assert len(history) == 2 == len(result.history)
    assert set(history[0]) == {"epoch", "train_loss", "val_loss", "val_dice", "lr",
                               "seconds", "train_voxels_per_sec"}
    for rec in history:
        assert all(np.isfinite(v) for v in rec.values())
    assert result.best_checkpoint is not None and result.best_checkpoint.exists()
    assert result.best_checkpoint.name == checkpoint.checkpoint_filename(
        result.best_val_epoch, result.history[result.best_val_epoch]["val_loss"],
        result.best_val_dice)
    kept = [p for p in out.glob("*.ckpt") if p.name != "last.ckpt"]
    assert 1 <= len(kept) <= 3


def test_jax_package_loads_the_port_checkpoint(trained):
    out, result = trained
    x = np.random.default_rng(1).standard_normal((1, 16, 16, 16, 1)).astype(np.float32)
    for path in (result.best_checkpoint, out / "last.ckpt"):
        jmodel = jtrainer.SegmentationModel.load(path)
        want = np.asarray(jmodel.apply(jnp.asarray(x)))
        port = trainer.SegmentationModel.load(path, device="cpu")
        with torch.no_grad():
            got = port.module(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-3)
    last = trainer.SegmentationModel.load(out / "last.ckpt", device="cpu")
    for (k, a), b in zip(last.module.state_dict().items(),
                         result.model.module.state_dict().values()):
        assert torch.equal(a, b), k


def test_patch_sampler_matches_jax_sampler(phantoms):
    _, dataset, _ = phantoms
    files = dataset.training_files()
    port = cache.VolumeCache(files, trainer.default_preprocessing(["image", "label"]), 4)
    ref = jcache.VolumeCache(files, jtrainer.default_preprocessing(["image", "label"]), 4)
    sp = cache.PatchSampler(port, (16, 16, 16), batch_size=6, num_samples=4, seed=3)
    sj = jcache.PatchSampler(ref, (16, 16, 16), batch_size=6, num_samples=4, seed=3,
                             image_wire_dtype=np.float32)
    for _ in range(3):
        (pi, pl), (ji, jl) = sp.sample_batch(), sj.sample_batch()
        assert pi.dtype == np.float32 and pl.dtype == np.uint8 and pi.shape == (6, 16, 16, 16, 1)
        np.testing.assert_array_equal(pi, ji)
        np.testing.assert_array_equal(pl, jl)
    loader = cache.PrefetchLoader(cache.PatchSampler(port, (16, 16, 16), 2, seed=3))
    try:
        assert loader.next()[0].shape == (2, 16, 16, 16, 1)
    finally:
        loader.stop()
    assert not loader._thread.is_alive()


def test_prefetch_loader_raises_the_samplers_error():
    class Broken:
        def sample_batch(self):
            raise ValueError("bad volume")

    loader = cache.PrefetchLoader(Broken())
    try:
        with pytest.raises(RuntimeError, match="sampler failed") as info:
            loader.next()
        assert isinstance(info.value.__cause__, ValueError)
    finally:
        loader.stop()
    assert not loader._thread.is_alive()


def test_validate_matches_jax_validate(phantoms):
    """Both packages validate the same weights on the same cached volumes
    (f32 eval forwards, roi 16^3 windows, overlap 0.25)."""
    _, dataset, _ = phantoms
    files = dataset.training_files()[:2]
    module = jtrainer.UNet(spatial_dims=3, in_channels=1, out_channels=4,
                           channels=(4, 8, 16), strides=(2, 2))
    variables = _flax_variables(module, seed=5)
    model = trainer.SegmentationModel.create(num_classes=4, channels=(4, 8, 16),
                                             strides=(2, 2), device="cpu")
    model.module.load_state_dict({
        k: torch.from_numpy(np.array(v))
        for k, v in trainer.from_flax_variables(variables).items()})
    port = cache.VolumeCache(files, trainer.default_preprocessing(["image", "label"]), 4)
    ref = jcache.VolumeCache(files, jtrainer.default_preprocessing(["image", "label"]), 4)
    got = trainer.validate(model.module, port, 4, roi=(16, 16, 16),
                           val_forward=trainer.make_val_forward(model.module, torch.float32))
    want = jtrainer.validate(module, variables, ref, 4, 3, roi=(16, 16, 16),
                             val_forward=jtrainer.make_val_forward(module, jnp.float32))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-3)


def test_confusion_matrix_and_dice_match_jax():
    rng = np.random.default_rng(2)
    target = rng.integers(0, 5, (6, 7, 8))
    pred = np.where(rng.random((6, 7, 8)) < 0.7, target, rng.integers(0, 5, (6, 7, 8)))
    pred[pred == 4] = 3  # class 4 only in the target
    want = joverlap.confusion_matrix(5, target, pred)
    got = overlap.confusion_matrix(5, torch.from_numpy(target), torch.from_numpy(pred))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(overlap.dice_from_confusion(got),
                                  joverlap.dice_from_confusion(want))


def test_flip_matches_jax_and_augment_batch_flips_image_with_label():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 4, 5, 6)).astype(np.float32)
    for mask in ([True, False, True], [False, True, False], [False] * 3):
        np.testing.assert_array_equal(
            intensity_ops.flip(torch.from_numpy(x), mask).numpy(),
            np.asarray(jiops.flip(jnp.asarray(x), jnp.asarray(mask))))
    img = torch.from_numpy(rng.standard_normal((16, 6, 7, 8, 1)).astype(np.float32))
    lbl = (img[..., 0] > 0).to(torch.uint8)
    gen = torch.Generator().manual_seed(0)
    out_i, out_l = augment_batch(img, lbl, gen, AugmentConfig(flip_prob=0.5))
    assert out_i.shape == img.shape and out_l.shape == lbl.shape
    assert torch.equal((out_i[..., 0] > 0).to(torch.uint8), out_l)  # pairs flip together
    assert not torch.equal(out_i, img)
    same, _ = augment_batch(img, lbl, None, AugmentConfig(flip_prob=0.0))
    assert same is img


@pytest.mark.parametrize("kw", [
    dict(augment_spatial=True), dict(augment_intensity=True),
    dict(preprocessing={"a": 1}), dict(augmentation={"a": 1}),
    dict(model_parallel=2), dict(zero_optimizer=True), dict(accumulate_steps=2),
    dict(remat=True), dict(profile_dir="p"), dict(arch="segresnet"),
    dict(val_blend_mode="constant"),
], ids=lambda kw: next(iter(kw)))
def test_unported_train_options_raise(kw, tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
        trainer.train(output_dir=tmp_path, num_classes=2, device="cpu", **kw)


def test_train_on_cuda_without_cuda_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trainer.train(output_dir=tmp_path, num_classes=2)


def test_resolve_num_classes_matches_jax(phantoms, tmp_path):
    _, _, datalist = phantoms
    assert trainer._resolve_num_classes(0, None, datalist) == 4
    tl = tmp_path / "tissues.txt"
    tl.write_text("V7\nN2\nC0.1 0.2 0.3 0.5 Bone\nC0.1 0.2 0.3 0.5 Fat\n")
    assert trainer._resolve_num_classes(0, tl, None) == jtrainer._resolve_num_classes(
        0, tl, None) == 3
    with pytest.raises(ValueError, match="redundant"):
        trainer._resolve_num_classes(3, tl, None)


def test_cli_train_passes_flags(phantoms, monkeypatch, tmp_path):
    from click.testing import CliRunner

    from segmantic_tpu_torch.commands.unet_cli import app

    _, _, datalist = phantoms
    seen = {}
    monkeypatch.setattr(trainer, "train", lambda **kw: seen.update(kw))
    res = CliRunner().invoke(app, ["train", "-d", str(datalist), "-r", str(tmp_path),
                                   "--max-epochs", "3", "--device", "cpu"])
    assert res.exit_code == 0, res.output
    assert seen["datalist"] == datalist and seen["max_epochs"] == 3
    assert seen["device"] == "cpu" and seen["output_dir"] == tmp_path
    assert CliRunner().invoke(app, ["train", "--help"]).output.count("--device") == 1


def test_cli_train_config_trains(phantoms, tmp_path):
    from click.testing import CliRunner

    from segmantic_tpu_torch.commands.unet_cli import app

    _, _, datalist = phantoms
    cfg = tmp_path / "train.json"
    cfg.write_text(json.dumps(dict(
        SMALL, datalist=str(datalist), output_dir=str(tmp_path / "out"), num_classes=0,
        max_epochs=1, device="cpu")))
    res = CliRunner().invoke(app, ["train-config", "-c", str(cfg)])
    assert res.exit_code == 0, res.output
    assert (tmp_path / "out" / "last.ckpt").exists()
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"output_dir": "x", "not_a_key": 1}))
    assert CliRunner().invoke(app, ["train-config", "-c", str(bad)]).exit_code != 0


def test_trains_with_jax_blocked(phantoms, tmp_path):
    """A process in which ``import jax`` (and flax, optax) fails trains one
    epoch and writes its checkpoint."""
    root, _, _ = phantoms
    script = textwrap.dedent(f"""
        import sys
        for name in ("jax", "jaxlib", "flax", "optax"):
            sys.modules[name] = None  # import raises ImportError
        sys.path.insert(0, {str(REPO)!r})
        from pathlib import Path
        from segmantic_tpu_torch.train.trainer import train
        res = train(image_dir=Path({str(root / "image")!r}),
                    labels_dir=Path({str(root / "label")!r}),
                    output_dir=Path({str(tmp_path / "out")!r}), max_epochs=1,
                    device="cpu", **{SMALL!r})
        loaded = [m for m in ("jax", "flax", "optax") if sys.modules.get(m) is not None]
        print("OK", len(res.history), loaded)
    """)
    res = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=600, cwd=tmp_path)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "OK 1 []"
    assert (tmp_path / "out" / "last.ckpt").exists()
