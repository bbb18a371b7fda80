"""``train()`` on two gloo CPU ranks against ``train()`` on one: two epochs,
augmentation off (flips too: each rank draws its own), SGD with momentum
(``test_torch_parallel_step`` says why), the same history within the step's
limits and the files written by rank 0 alone; then ``train(zero_optimizer=True)`` and ``train(model_parallel=2)`` on
two ranks (the JAX package's end-to-end tests,
``tests/parallel/test_zero_optimizer.py:114-158`` and
``test_model_parallel_train.py:45-71``), the TP checkpoint gathered whole and
read by the JAX package's ``SegmentationModel.load``.
"""

from __future__ import annotations

import numpy as np
import pytest

from segmantic_tpu.train.trainer import SegmentationModel as JaxSegmentationModel
from segmantic_tpu_torch.train import trainer
from tests.test_torch_parallel_ranks import Ranks, no_flips
from tests.test_torch_train import phantoms  # noqa: F401  (the module fixture)

BASE = dict(num_classes=4, spatial_size=(16, 16, 16), channels=(4, 8, 16), strides=(2, 2),
            mixed_precision=False, val_roi_size=(16, 16, 16), seed=0, max_epochs=2,
            batch_size=2, num_samples=2)
SGD = {"optimizer": "SGD", "lr": 1e-2, "momentum": 0.9}
WRITTEN = {"Dataset.json", "history.json", "last.ckpt"}


@pytest.fixture(scope="module")
def runs(phantoms, tmp_path_factory):  # noqa: F811
    root, _, _ = phantoms
    data = dict(image_dir=root / "image", labels_dir=root / "label")
    out = tmp_path_factory.mktemp("train")
    kws = {
        "dp": dict(BASE, optimizer=SGD, **data),
        "zero": dict(BASE, optimizer={"optimizer": "Adam", "lr": 3e-3}, zero_optimizer=True,
                     lr_scheduling={"scheduler": "Cosine", "T_0": 4}, **data),
        "tp": dict(BASE, channels=(4, 8, 64), optimizer={"optimizer": "Adam", "lr": 3e-3},
                   model_parallel=2, **data),
    }
    ranks = Ranks("train", 2, out / "ranks",
                  cases=[dict(kw=kw, out_root=out / name) for name, kw in kws.items()])
    undo = no_flips(trainer)
    try:
        one = trainer.train(output_dir=out / "one", device="cpu", **kws["dp"])
    finally:
        undo()
    two = ranks.wait()
    return {name: (two[0][i], two[1][i]) for i, name in enumerate(kws)} | {
        "one": one, "out": out}


def test_two_ranks_train_as_one(runs):
    (r0, r1), one = runs["dp"], runs["one"]
    assert len(r0["history"]) == len(one.history) == 2
    for got, other, want in zip(r0["history"], r1["history"], one.history):
        for key in ("train_loss", "val_loss", "val_dice", "lr"):
            assert got[key] == other[key], key  # every rank: the same numbers
            np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=1e-6, err_msg=key)
    state = {k: v.numpy() for k, v in one.model.module.state_dict().items()}
    for k, v in state.items():
        np.testing.assert_allclose(r0["state"][k], v, rtol=1e-4, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("name", ["dp", "zero", "tp"])
def test_rank_zero_alone_writes_files(runs, name):
    r0, r1 = runs[name]
    assert WRITTEN <= set(r0["files"]) and r0["best"] is not None
    assert r1["files"] == [] and r1["best"] is None
    for rec in r0["history"]:
        assert np.isfinite(rec["train_loss"]) and np.isfinite(rec["val_loss"])


def test_tp_checkpoint_is_whole_and_the_jax_package_reads_it(runs):
    """The TP run's checkpoint holds every kernel whole (rank 0 gathered
    them), equal to what both ranks hold at the end (``unshard_params``)."""
    r0, r1 = runs["tp"]
    for k, v in r0["state"].items():
        np.testing.assert_array_equal(v, r1["state"][k], err_msg=k)
    model = JaxSegmentationModel.load(runs["out"] / "tp" / "rank0" / "last.ckpt")
    flat = trainer.from_flax_variables(model.variables)
    assert sorted(flat) == sorted(r0["state"])
    for k, v in flat.items():
        np.testing.assert_array_equal(v, r0["state"][k], err_msg=k)
