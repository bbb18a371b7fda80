"""``predict(mesh=)`` and ``ensemble_evaluate(mesh=)`` of the port on two
gloo CPU ranks, on checkpoints the JAX package wrote, against the JAX
functions on two devices of the conftest's virtual mesh and against the
port's mesh-less calls. Both packages' eval forwards run in f32 (bf16 by
default in both), as in ``test_torch_predict``. Against the JAX package the
limits are that file's: label maps agree on >= 99.9% of voxels, Dice within
1e-6 where they agree fully, logits within 1e-4. Two ranks differ from one
only in the order of the window sums, so their label maps are equal and
their Dice within 1e-6. Rank 0 alone writes files.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from segmantic_tpu.infer import ensemble as jensemble
from segmantic_tpu.infer import predict as jpredict
from segmantic_tpu.io.nifti import read_volume
from segmantic_tpu.parallel import mesh as jmesh
from segmantic_tpu.train.trainer import SegmentationModel as JaxModel
from segmantic_tpu.train.trainer import default_preprocessing as jax_pre
from segmantic_tpu.train.trainer import make_val_forward as jax_val_forward
from tests.test_torch_parallel_ranks import Ranks, predict_case
from tests.test_torch_predict import CLASS_NAMES, SPACING, jax_checkpoint, write_case

ROI = (16, 16, 16)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("infer")
    ckpts = [jax_checkpoint(root / "a.ckpt", seed=3), jax_checkpoint(root / "b.ckpt", seed=4)]
    cases = [write_case(root, "c0", (20, 18, 14), 0), write_case(root, "c1", (22, 16, 15), 1)]
    images, labels = [c[0] for c in cases], [c[1] for c in cases]
    kw = dict(ckpt=ckpts[0], images=images, labels=labels,
              predict_kw=dict(tissue_dict=CLASS_NAMES, spacing=SPACING, sw_batch_size=2),
              models=ckpts, roi=ROI)
    ranks = Ranks("predict", 2, root / "ranks", out_root=root / "two", **kw)
    one = predict_case(out_root=root / "one", mesh=False, **kw)
    mesh = jmesh.make_mesh(devices=jax.devices()[:2])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpredict, "make_val_forward", lambda m: jax_val_forward(m, jnp.float32))
        want = jpredict.predict(ckpts[0], images, labels, output_dir=root / "jax", mesh=mesh,
                                save_confusion_plots=False, **kw["predict_kw"])
    models = [JaxModel.load(c) for c in ckpts]
    sample = jax_pre(["image"], SPACING)({"image": images[0]})
    work = jensemble.ensemble_evaluate(
        models, sample, ROI, sw_batch_size=3, mesh=mesh,
        forwards=[jax_val_forward(m.module, jnp.float32) for m in models])
    want_ens = [np.asarray(work[f"pred{i}"].numpy()) for i in range(len(models))]
    two = ranks.wait()
    return dict(two=two, one=one, jax=want, jax_ens=want_ens)


def test_predict_on_two_ranks(runs):
    (r0, r1), one = runs["two"], runs["one"]
    assert r0["dice"] == r1["dice"]
    for got, ref, want, dice, dice_ref in zip(r0["preds"], one["preds"], runs["jax"],
                                              r0["dice"], one["dice"]):
        np.testing.assert_array_equal(got, ref)
        assert abs(dice - dice_ref) <= 1e-6
        agree = float((got == read_volume(want.saved_to).numpy()).mean())
        assert agree >= 0.999, agree
        if agree == 1.0:
            assert abs(dice - want.dice) <= 1e-6


def test_rank_zero_alone_writes_the_predictions(runs):
    r0, r1 = runs["two"]
    assert set(r0["files"]) == {"c0.nii.gz", "c1.nii.gz", "mean_dice.txt"}
    assert r1["files"] == []


def test_ensemble_evaluate_on_two_ranks(runs):
    (r0, r1), one = runs["two"], runs["one"]
    for got, other, ref, want in zip(r0["ensemble"], r1["ensemble"], one["ensemble"],
                                     runs["jax_ens"]):
        np.testing.assert_array_equal(got, other)
        np.testing.assert_allclose(got, ref, atol=1e-5)
        np.testing.assert_allclose(got, want, atol=1e-4)
