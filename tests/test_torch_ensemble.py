"""The port's ensemble path against the JAX package's on the CPU.

The three combiners on random discrete and one-hot arrays (bit-equal: the
same numpy code), ``parse_val_dice`` on file names and on the metrics stored
in a checkpoint, ``ensemble_creator`` in all three modes over checkpoints
named by ``checkpoint_filename`` (both forwards in f32: the saved
``<stem>_seg.nii.gz`` maps agree on >= 99.9% of voxels), and the same
``ValueError``s.
"""

from __future__ import annotations

import numpy as np
import pytest

import segmantic_tpu.infer.ensemble as jensemble
import segmantic_tpu_torch.infer.ensemble as pensemble
from segmantic_tpu.core.volume import Volume as JVolume
from segmantic_tpu.io.nifti import read_volume
from segmantic_tpu.train import checkpoint as jckpt
from segmantic_tpu.transforms import post as jpost
from segmantic_tpu_torch.core.volume import Volume
from segmantic_tpu_torch.train import checkpoint
from segmantic_tpu_torch.transforms import post
from segmantic_tpu_torch.utils import config
from tests.test_torch_predict import f32_forwards, jax_checkpoint, write_case

KEYS = ["pred0", "pred1", "pred2"]


def _preds(kind: str, seed: int):
    """Three model outputs (C, 7, 6, 5): logits, argmaxed labels or one-hot."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((3, 4, 7, 6, 5)).astype(np.float32)
    if kind == "logits":
        return logits
    lab = logits.argmax(axis=1)[:, None]  # (E, 1, *spatial)
    if kind == "discrete":
        return lab.astype(np.int64)
    return np.stack([np.concatenate([(m == c) for c in range(4)]) for m in lab]).astype(
        np.float32)


COMBINERS = [
    ("mean", "logits", lambda mod: mod.MeanEnsembled(keys=KEYS, output_key="pred")),
    ("mean-weighted", "logits", lambda mod: mod.MeanEnsembled(
        keys=KEYS, output_key="pred", weights=[0.8125, 0.5, 0.25])),
    ("vote", "discrete", lambda mod: mod.VoteEnsembled(keys=KEYS, output_key="pred",
                                                       num_classes=4)),
    ("vote-inferred", "discrete", lambda mod: mod.VoteEnsembled(keys=KEYS, output_key="pred")),
    ("vote-onehot", "onehot", lambda mod: mod.VoteEnsembled(keys=KEYS, output_key="pred")),
    ("select-best", "discrete", lambda mod: mod.SelectBestEnsembled(
        keys=KEYS, output_key="pred", label_model_dict={1: 0, 2: 2, 3: 1})),
    ("select-best-onehot", "onehot", lambda mod: mod.SelectBestEnsembled(
        keys=KEYS, output_key="pred", label_model_dict={"1": "2", "3": "0"})),
]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name,kind,make", COMBINERS, ids=[c[0] for c in COMBINERS])
def test_combiners_match_jax(name, kind, make, seed):
    arr = _preds(kind, seed)
    aff = np.diag([1.0, 1.5, 2.0, 1.0])
    got = make(post)({k: Volume(data=a, affine=aff.copy()) for k, a in zip(KEYS, arr)})
    want = make(jpost)({k: JVolume(data=a, affine=aff.copy()) for k, a in zip(KEYS, arr)})
    assert got["pred"].numpy().dtype == want["pred"].numpy().dtype
    np.testing.assert_array_equal(got["pred"].numpy(), want["pred"].numpy())
    np.testing.assert_array_equal(got["pred"].affine, want["pred"].affine)
    assert all(got[k] is not None for k in KEYS)  # the inputs stay in the sample


@pytest.mark.parametrize("name,expected", [
    (checkpoint.checkpoint_filename(3, 0.25, 0.8125), 0.8125),
    ("epoch=0-val_loss=1.00-val_dice=.5.ckpt", 0.5),
    ("model-val_dice=1.ckpt", 1.0),
    ("model.ckpt", 0.625),  # no dice in the name: the stored metrics
    ("missing.ckpt", None),  # no file
])
def test_parse_val_dice_matches_jax(tmp_path, name, expected):
    path = tmp_path / name
    if name == "model.ckpt":
        jckpt.save_checkpoint(path, {"params": {"w": np.zeros(2, np.float32)}}, {},
                              metrics={"val_dice": 0.625})
    elif name != "missing.ckpt":
        path.write_bytes(b"not read")
    assert checkpoint.parse_val_dice(path) == jckpt.parse_val_dice(path) == expected
    if name == "model.ckpt":  # a checkpoint without val_dice in its metrics
        jckpt.save_checkpoint(path, {"params": {"w": np.zeros(2, np.float32)}}, {})
        assert checkpoint.parse_val_dice(path) is None is jckpt.parse_val_dice(path)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    root = tmp_path_factory.mktemp("ensemble")
    ckpts = [jax_checkpoint(root / checkpoint.checkpoint_filename(i, 0.5, dice), seed=10 + i)
             for i, dice in enumerate((0.75, 0.5, 0.625))]
    image, label = write_case(root, "e0", (20, 18, 14), 5)
    yml = root / "candidates.yml"
    config.dump({"A": 2, "B": 0}, yml)
    return root, ckpts, image, label, yml


@pytest.mark.parametrize("n_models", [2, 3])
@pytest.mark.parametrize("mode", ["mean", "vote", "select_best"])
def test_ensemble_creator_matches_jax(models, tmp_path, monkeypatch, mode, n_models):
    root, ckpts, image, label, yml = models
    f32_forwards(monkeypatch, jensemble, pensemble)
    kw = dict(model_files=ckpts[:n_models], test_images=[image], test_labels=[label],
              tissue_dict={"Background": 0, "A": 1, "B": 2}, spacing=[1.2, 1.2, 1.2],
              combination_mode=mode, roi_size=(16, 16, 16))
    if mode == "select_best":
        if n_models == 2:
            config.dump({"A": 1, "B": 0}, tmp_path / "two.yml")
            kw["candidate_per_tissue_path"] = tmp_path / "two.yml"
        else:
            kw["candidate_per_tissue_path"] = yml
    want = jensemble.ensemble_creator(output_dir=tmp_path / "jax", **kw)
    got = pensemble.ensemble_creator(output_dir=tmp_path / "port", device="cpu", **kw)
    assert [p.name for p in got] == [p.name for p in want] == ["e0_seg.nii.gz"]
    g, w = read_volume(got[0]), read_volume(want[0])
    assert g.spatial_shape == w.spatial_shape == read_volume(image).spatial_shape
    np.testing.assert_allclose(g.affine, w.affine, atol=1e-6)
    agree = float((g.numpy() == w.numpy()).mean())
    assert agree >= 0.999, agree
    assert set(np.unique(g.numpy())) <= {0, 1, 2}


@pytest.mark.parametrize("kw,match", [
    (dict(combination_mode="select_best", tissue_dict={"A": 1}), "candidate_per_tissue_path"),
    (dict(combination_mode="select_best", candidate_per_tissue_path="c.yml"),
     "requires a tissue list"),
    (dict(combination_mode="median"), "unknown combination mode 'median'"),
    (dict(combination_mode=pensemble.EnsembleCombination.select_best),
     "candidate_per_tissue_path"),
])
def test_ensemble_creator_raises_as_jax(models, kw, match):
    _, ckpts, image, _, _ = models
    args = dict(model_files=ckpts[:1], test_images=[image])
    jkw = dict(kw)
    if isinstance(kw["combination_mode"], pensemble.EnsembleCombination):
        jkw["combination_mode"] = jensemble.EnsembleCombination(kw["combination_mode"].value)
    with pytest.raises(ValueError, match=match) as got:
        pensemble.ensemble_creator(device="cpu", **args, **kw)
    with pytest.raises(ValueError, match=match) as want:
        jensemble.ensemble_creator(**args, **jkw)
    assert str(got.value) == str(want.value)
