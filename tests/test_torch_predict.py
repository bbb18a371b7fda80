"""The port's ``predict`` and ``segment_volume(pre=...)`` against the JAX
package's, end to end on the CPU.

One checkpoint written by the JAX package (``SegmentationModel.create`` with a
seed and its saver) is read by both; two anisotropic NIfTI cases go through
both ``predict`` functions with a ``spacing`` resample, with labels and
without, with an output directory and without. Both forwards run in f32, so
only summation order differs: the saved label maps agree on >= 99.9% of
voxels, and where they are equal the per-case Dice, per-class Dice and
metrics agree within 1e-6, the printed tables and ``mean_dice.txt`` are the
same text, and both write ``<stem>_confusion.png``.
"""

from __future__ import annotations

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import segmantic_tpu.infer.predict as jpredict
import segmantic_tpu_torch.infer.predict as ppredict
from segmantic_tpu.core.volume import Volume, affine_from_spacing_origin
from segmantic_tpu.io.nifti import read_volume, write_volume
from segmantic_tpu.train import checkpoint as jckpt
from segmantic_tpu.train.trainer import SegmentationModel as JaxModel
from segmantic_tpu.train.trainer import default_preprocessing as jax_pre
from segmantic_tpu.train.trainer import make_val_forward as jax_val_forward
from segmantic_tpu_torch.train.trainer import SegmentationModel
from segmantic_tpu_torch.train.trainer import default_preprocessing as port_pre
from segmantic_tpu_torch.train.trainer import make_val_forward as port_val_forward

NUM_CLASSES = 3
CLASS_NAMES = {"Background": 0, "A": 1, "B": 2}
SPACING = [1.2, 1.2, 1.2]


def jax_checkpoint(path: Path, seed: int, metrics=None) -> Path:
    """A small 3D UNet from the JAX package's initialisers, saved by its saver."""
    model = JaxModel.create(num_classes=NUM_CLASSES, spatial_size=(16, 16, 16),
                            channels=(4, 8), strides=(2,), num_res_units=1, seed=seed)
    jckpt.save_checkpoint(path, model.variables, model.hparams, metrics=metrics)
    return path


def write_case(root: Path, name: str, shape, seed: int, spacing=(1.0, 1.3, 1.6)):
    """An anisotropic image with two boxes of tissue and its label map."""
    rng = np.random.default_rng(seed)
    lbl = np.zeros(shape, np.uint8)
    a = [s // 6 for s in shape]
    lbl[a[0]:shape[0] // 2 + 2, a[1]:shape[1] - a[1], a[2]:shape[2] // 2 + 1] = 1
    lbl[shape[0] // 2 + 2:shape[0] - 2, a[1] + 1:shape[1] // 2 + 3, shape[2] // 2:] = 2
    img = (lbl * 1.5 + rng.normal(0.0, 0.3, shape)).astype(np.float32)
    aff = affine_from_spacing_origin(spacing, (2.0, -3.0, 4.0))
    for sub in ("image", "label"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    write_volume(root / "image" / f"{name}.nii.gz", Volume(data=img[None], affine=aff))
    write_volume(root / "label" / f"{name}.nii.gz", Volume(data=lbl[None], affine=aff.copy()))
    return root / "image" / f"{name}.nii.gz", root / "label" / f"{name}.nii.gz"


def f32_forwards(monkeypatch, jax_module, port_module):
    """Both packages' eval forwards in f32 (bf16 by default in both)."""
    monkeypatch.setattr(jax_module, "make_val_forward",
                        lambda m: jax_val_forward(m, jnp.float32))
    monkeypatch.setattr(port_module, "make_val_forward",
                        lambda m: port_val_forward(m, torch.float32))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("predict")
    ckpt = jax_checkpoint(root / "model.ckpt", seed=3)
    cases = [write_case(root, "c0", (20, 18, 14), 0), write_case(root, "c1", (22, 16, 15), 1)]
    return ckpt, [c[0] for c in cases], [c[1] for c in cases]


def _agreement(a: Path, b: Path) -> float:
    va, vb = read_volume(a), read_volume(b)
    assert va.spatial_shape == vb.spatial_shape
    np.testing.assert_allclose(va.affine, vb.affine, atol=1e-6)
    return float((va.numpy() == vb.numpy()).mean())


@pytest.mark.parametrize("with_labels", [True, False], ids=["labels", "no-labels"])
@pytest.mark.parametrize("with_output", [True, False], ids=["output-dir", "no-output"])
def test_predict_matches_jax(data, tmp_path, monkeypatch, capsys, with_labels, with_output):
    ckpt, images, labels = data
    f32_forwards(monkeypatch, jpredict, ppredict)
    kw = dict(test_labels=labels if with_labels else None, tissue_dict=CLASS_NAMES,
              spacing=SPACING, sw_batch_size=2)
    capsys.readouterr()
    want = jpredict.predict(ckpt, images, output_dir=tmp_path / "jax" if with_output else None,
                            **kw)
    want_out = capsys.readouterr().out
    got = ppredict.predict(ckpt, images, output_dir=tmp_path / "port" if with_output else None,
                           device="cpu", **kw)
    got_out = capsys.readouterr().out

    assert len(got) == len(want) == 2
    equal_maps = True
    for g, w in zip(got, want):
        assert g.image == w.image
        assert (g.saved_to is None) == (w.saved_to is None) == (not with_output)
        if with_output:
            assert g.saved_to.name == w.saved_to.name == g.image.name
            agree = _agreement(g.saved_to, w.saved_to)
            assert agree >= 0.999, agree
            equal_maps &= agree == 1.0
        assert (g.dice is None) == (w.dice is None) == (not with_labels)
        if with_labels and equal_maps:
            assert abs(g.dice - w.dice) <= 1e-6
            np.testing.assert_allclose(g.per_class_dice, w.per_class_dice, atol=1e-6)
            for name in w.metrics:
                np.testing.assert_allclose(g.metrics[name], w.metrics[name], atol=1e-6)
        expect = {"read", "preprocessing", "sliding_window", "inversion", "argmax"}
        expect |= {"metrics"} if with_labels else set()
        expect |= {"write"} if with_output else set()
        assert set(g.seconds) == expect and min(g.seconds.values()) >= 0.0
    if equal_maps:
        assert got_out == want_out
    if with_labels:
        assert "mean dice over 2 cases" in got_out
    if with_output and with_labels:
        assert (tmp_path / "port" / "mean_dice.txt").read_text() == \
            (tmp_path / "jax" / "mean_dice.txt").read_text()
        assert len((tmp_path / "port" / "mean_dice.txt").read_text().splitlines()) == 3
        for sub in ("jax", "port"):
            assert sorted(p.name for p in (tmp_path / sub).glob("*_confusion.png")) == [
                "c0_confusion.png", "c1_confusion.png"]
    elif with_output:
        assert not list((tmp_path / "port").glob("*_confusion.png"))
        assert not (tmp_path / "port" / "mean_dice.txt").exists()


@pytest.mark.parametrize("case", [0, 1])
def test_segment_volume_with_pre_matches_jax(data, case):
    """``pre=`` keyed on image and label, as ``predict`` passes it."""
    ckpt, images, labels = data
    raw = {"image": images[case], "label": labels[case]}
    port_model = SegmentationModel.load(ckpt, device="cpu")
    jax_model = JaxModel.load(ckpt)
    got, got_sample = ppredict.segment_volume(
        port_model, dict(raw), val_forward=port_val_forward(port_model.module, torch.float32),
        pre=port_pre(["image", "label"], SPACING), sw_batch_size=2)
    want, want_sample = jpredict.segment_volume(
        jax_model, dict(raw), val_forward=jax_val_forward(jax_model.module, jnp.float32),
        pre=jax_pre(["image", "label"], SPACING), sw_batch_size=2)
    assert sorted(got_sample) == sorted(want_sample) == ["image", "label"]
    for key in ("image", "label"):
        np.testing.assert_array_equal(got_sample[key].numpy(), want_sample[key].numpy())
    assert got.spatial_shape == want.spatial_shape == read_volume(images[case]).spatial_shape
    np.testing.assert_allclose(got.affine, want.affine, atol=1e-6)
    assert float((got.numpy() == want.numpy()).mean()) >= 0.999
    # the default pipeline over the sample's keys is the same as passing it
    again, _ = ppredict.segment_volume(
        port_model, dict(raw), val_forward=port_val_forward(port_model.module, torch.float32),
        spacing=SPACING, sw_batch_size=2)
    np.testing.assert_array_equal(again.numpy(), got.numpy())


def test_predict_mesh_is_not_ported(data, tmp_path):
    """``predict(mesh=)`` is ported: a mesh of one (no process group) gives the
    mesh-less result, files included (two ranks: test_torch_parallel_infer)."""
    from segmantic_tpu_torch.parallel import make_mesh

    ckpt, images, labels = data
    want = ppredict.predict(ckpt, images, labels, output_dir=tmp_path / "plain",
                            save_confusion_plots=False, device="cpu")
    got = ppredict.predict(ckpt, images, labels, output_dir=tmp_path / "mesh",
                           save_confusion_plots=False, mesh=make_mesh(), device="cpu")
    assert [r.dice for r in got] == [r.dice for r in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(read_volume(g.saved_to).numpy(),
                                      read_volume(w.saved_to).numpy())
    assert ((tmp_path / "mesh" / "mean_dice.txt").read_text()
            == (tmp_path / "plain" / "mean_dice.txt").read_text())
