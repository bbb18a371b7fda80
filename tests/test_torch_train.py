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
jax unimportable; the JAX ``train()``'s mesh refusals at a world of one and
the dropout refusal raise. With the
augmentation: the sampler's margin patches equal the JAX sampler's, ``train``
runs with ``augment_spatial`` and ``augment_intensity``, and one train step
with injected augmentation parameters gives the JAX step's loss on the same
augmented batch.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmantic_tpu.core.volume import Volume, affine_from_spacing_origin
from segmantic_tpu.data import cache as jcache
from segmantic_tpu.data.dataset import PairedDataSet
from segmantic_tpu.io.nifti import write_volume
from segmantic_tpu.metrics import overlap as joverlap
from segmantic_tpu.train import augment as jaug
from segmantic_tpu.train import optim as joptim
from segmantic_tpu.train import trainer as jtrainer
from segmantic_tpu.transforms import intensity_ops as jiops
from segmantic_tpu_torch.data import cache
from segmantic_tpu_torch.metrics import overlap
from segmantic_tpu_torch.train import augment as taug
from segmantic_tpu_torch.train import checkpoint, optim, trainer
from segmantic_tpu_torch.train.augment import AugmentConfig, augment_batch
from segmantic_tpu_torch.transforms import intensity_ops
from tests.test_torch_augment import _jax_replay
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


TB_TAGS = {"train_loss", "val_loss", "val_dice", "lr", "train_voxels_per_sec"}


def _read_scalars(logs):
    """{tag: [(step, value), ...]} from the event files under ``logs`` (TFRecord
    framing: u64 length, u32 crc, payload, u32 crc)."""
    import struct

    from tensorboardX.proto import event_pb2

    scalars = {}
    for path in sorted(logs.glob("events.out.tfevents.*")):
        blob, pos = path.read_bytes(), 0
        while pos < len(blob):
            (n,) = struct.unpack_from("<Q", blob, pos)
            event = event_pb2.Event.FromString(blob[pos + 12: pos + 12 + n])
            pos += 12 + n + 4
            for v in event.summary.value:
                scalars.setdefault(v.tag, []).append((event.step, v.simple_value))
    return scalars


def test_train_writes_the_tensorboard_scalars_of_the_jax_trainer(trained):
    """The five tags the JAX package's train() writes (trainer.py: add_scalar),
    one point per epoch, equal to history.json up to the f32 the file stores."""
    out, result = trained
    scalars = _read_scalars(out / "logs")
    assert set(scalars) == TB_TAGS
    for tag in TB_TAGS:
        assert [step for step, _ in scalars[tag]] == [0, 1]
        np.testing.assert_allclose([v for _, v in scalars[tag]],
                                   [rec[tag] for rec in result.history], rtol=1e-6)


def test_train_warns_when_no_tensorboard_writer_can_be_had(phantoms, tmp_path, monkeypatch):
    root, _, _ = phantoms
    monkeypatch.setitem(sys.modules, "tensorboardX", None)  # import raises ImportError
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    with pytest.warns(UserWarning, match="no TensorBoard writer available"):
        result = trainer.train(image_dir=root / "image", labels_dir=root / "label",
                               output_dir=tmp_path / "run", max_epochs=1, device="cpu", **SMALL)
    assert len(result.history) == 1 and (tmp_path / "run" / "last.ckpt").exists()
    assert not list((tmp_path / "run").glob("logs/events*"))


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


@pytest.mark.parametrize("margin", [4, 12])
def test_patch_sampler_margin_matches_jax_sampler(phantoms, margin):
    """Margin patches: the same picks (one seed), the window grown by
    ``margin`` on each side, zeros only where the margin hangs outside the
    volume (margin 12 does on every 24-voxel axis); the center of a margin
    patch is the plain patch of the same pick."""
    _, dataset, _ = phantoms
    files = dataset.training_files()
    port = cache.VolumeCache(files, trainer.default_preprocessing(["image", "label"]), 4)
    ref = jcache.VolumeCache(files, jtrainer.default_preprocessing(["image", "label"]), 4)
    kw = dict(batch_size=6, num_samples=3, seed=7)
    sp = cache.PatchSampler(port, (16, 16, 16), margin=margin, **kw)
    sj = jcache.PatchSampler(ref, (16, 16, 16), margin=margin, image_wire_dtype=np.float32,
                             **kw)
    plain = cache.PatchSampler(port, (16, 16, 16), **kw)
    size = 16 + 2 * margin
    assert sp.margin_size == sj.margin_size == [size] * 3
    inner = (slice(None),) + (slice(margin, margin + 16),) * 3
    for _ in range(3):
        (pi, pl), (ji, jl), (ci, cl) = sp.sample_batch(), sj.sample_batch(), plain.sample_batch()
        assert pi.shape == (6, size, size, size, 1) and pl.shape == (6, size, size, size)
        assert pi.dtype == np.float32 and pl.dtype == np.uint8
        np.testing.assert_array_equal(pi, ji)
        np.testing.assert_array_equal(pl, jl)
        np.testing.assert_array_equal(pi[inner], ci)
        np.testing.assert_array_equal(pl[inner], cl)


@pytest.mark.parametrize("kw", [
    dict(augment_spatial=True), dict(augment_intensity=True),
    dict(augment_spatial=True, augment_intensity=True),
], ids=lambda kw: "+".join(kw))
def test_train_with_augmentation_runs(phantoms, tmp_path, kw):
    """``train`` with the device augmentation on the CPU (the plain shear
    chain): finite history, checkpoints written. The margin (16 // 4 = 4) makes
    24-voxel margin patches of the 16-voxel patch."""
    root, _, _ = phantoms
    result = trainer.train(image_dir=root / "image", labels_dir=root / "label",
                           output_dir=tmp_path, max_epochs=2, device="cpu", **SMALL, **kw)
    history = json.loads((tmp_path / "history.json").read_text())
    assert len(history) == 2 == len(result.history)
    for rec in history:
        assert all(np.isfinite(v) for v in rec.values())
    assert (tmp_path / "last.ckpt").exists() and result.best_checkpoint.exists()


@pytest.mark.parametrize("mixed_precision", [False, True], ids=["f32", "bf16"])
def test_augmented_train_step_matches_jax_step(monkeypatch, mixed_precision):
    """One train step on a margin batch with the augmentation's parameters
    injected, against the JAX step on the batch the JAX package's pieces
    augment with the same parameters. f32: the loss within the step test's
    tolerance (1e-4 absolute + 1e-3 relative), updated parameters likewise;
    bf16 (``interp_bf16`` interpolation, bf16 model): loss within 2e-2."""
    rng = np.random.default_rng(11)
    grid = np.stack(np.meshgrid(*[np.linspace(-1, 1, 24)] * 3, indexing="ij"))
    labels = np.stack([
        ((((grid - rng.uniform(-0.2, 0.2, 3)[:, None, None, None]) ** 2).sum(0) < r)
         .astype(np.uint8) * k) for r, k in ((0.5, 1), (0.3, 2), (0.6, 3), (0.4, 1))])
    images = (labels[..., None] + 0.3 * rng.standard_normal((4, 24, 24, 24, 1))).astype(
        np.float32)
    cfg = AugmentConfig(spatial=True, intensity=True, flip_prob=0.5, contrast_prob=0.5,
                        hist_shift_prob=0.5, bias_prob=0.5)
    # the step couples interp_bf16 to mixed_precision, as the JAX trainer does
    eff = dataclasses.replace(cfg, interp_bf16=mixed_precision)
    params = taug.draw_params(torch.Generator().manual_seed(12), cfg, 4, 3)
    assert len(params.spatial_index) == 2 and len(params.gibbs_index) == 1
    aug_i, aug_l = _jax_replay(images, labels, params, eff, (16, 16, 16))

    module = jtrainer.UNet(spatial_dims=3, in_channels=1, out_channels=4,
                           channels=(4, 8, 16), strides=(2, 2))
    variables = _flax_variables(module, seed=6)
    opt_cfg = {"optimizer": "SGD", "lr": 0.1, "momentum": 0.9}
    tx = joptim.make_optimizer(opt_cfg)
    jstep = jtrainer.make_train_step(module, tx, jaug.AugmentConfig(flip_prob=0.0),
                                     (16, 16, 16), mixed_precision=mixed_precision)
    jparams = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    jstats = jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"])
    new_params, _, _, want_loss = jstep(jparams, jstats, tx.init(jparams), jnp.asarray(aug_i),
                                        jnp.asarray(aug_l), jax.random.key(0))

    model = trainer.SegmentationModel.create(num_classes=4, channels=(4, 8, 16),
                                             strides=(2, 2), device="cpu")
    model.module.load_state_dict({
        k: torch.from_numpy(np.array(v))
        for k, v in trainer.from_flax_variables(variables).items()})
    net = model.module.train().requires_grad_(True)
    step = trainer.make_train_step(net, optim.make_optimizer(net.parameters(), opt_cfg), cfg,
                                   (16, 16, 16), mixed_precision=mixed_precision)
    monkeypatch.setattr(taug, "draw_params", lambda *a, **k: params)
    loss = step(torch.from_numpy(images), torch.from_numpy(labels))
    if mixed_precision:
        np.testing.assert_allclose(loss.item(), float(want_loss), atol=2e-2)
        return
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=1e-4, rtol=1e-3)
    got = trainer.to_flax_variables(net.state_dict())["params"]
    flat = lambda tree: jax.tree_util.tree_leaves_with_path(tree)  # noqa: E731
    for (path, leaf), (_, mine) in zip(flat(jax.tree_util.tree_map(np.asarray, new_params)),
                                       flat(got)):
        np.testing.assert_allclose(mine, leaf, atol=2e-4, rtol=1e-3, err_msg=str(path))


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


@pytest.mark.parametrize("kw, err, match", [
    # a world of one: the JAX train()'s own refusals of a mesh it cannot build
    pytest.param(dict(model_parallel=2), ValueError,
                 r"model_parallel=2 must divide the device count \(1\)", id="model_parallel"),
    pytest.param(dict(zero_optimizer=True), ValueError,
                 "zero_optimizer needs more than one device", id="zero_optimizer"),
    # not a gap of the port: the JAX trainer cannot train with dropout either
    pytest.param(dict(dropout=0.1), NotImplementedError, "JAX trainer refuses it",
                 id="dropout"),
])
def test_unported_train_options_raise(kw, err, match, tmp_path):
    with pytest.raises(err, match=match):
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
    """A process in which ``import jax`` (and flax, optax, segmantic_tpu) fails trains one
    epoch and writes its checkpoint."""
    root, _, _ = phantoms
    script = textwrap.dedent(f"""
        import sys
        for name in ("jax", "jaxlib", "flax", "optax", "segmantic_tpu"):
            sys.modules[name] = None  # import raises ImportError
        sys.path.insert(0, {str(REPO)!r})
        from pathlib import Path
        from segmantic_tpu_torch.train.trainer import train
        res = train(image_dir=Path({str(root / "image")!r}),
                    labels_dir=Path({str(root / "label")!r}),
                    output_dir=Path({str(tmp_path / "out")!r}), max_epochs=1,
                    device="cpu", **{SMALL!r})
        loaded = [m for m, mod in sys.modules.items() if mod is not None
                  and m.split(".")[0] in ("jax", "flax", "optax", "segmantic_tpu")]
        print("OK", len(res.history), loaded)
    """)
    res = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=600, cwd=tmp_path)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "OK 1 []"
    assert (tmp_path / "out" / "last.ckpt").exists()
