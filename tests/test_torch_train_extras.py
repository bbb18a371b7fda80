"""The ``train()`` options accumulate_steps, remat, profile_dir and
val_blend_mode, the sliding window's constant blend and
``SlidingWindowInferer``, and ``SegmentationModel.load``'s rule for variable
collections, against the JAX package where it has them.

- ``accumulate_steps=2``: two micro-batches through the port's train step
  against the JAX step under ``optax.MultiSteps`` (SGD with momentum, f32,
  the tiny UNet of ``test_torch_unet_train.py``): the parameters unchanged
  after the first, both packages' parameters and BatchNorm statistics after
  the second (1e-4 absolute + 1e-3 relative); Adam's step count advancing
  once per two micro-batches;
- ``remat=True``: the same step's gradients and loss as without it
  (bit-equal on the CPU) and the running statistics updated once;
- the constant blend and ``SlidingWindowInferer`` against their JAX twins
  (1e-5 relative + 1e-6 absolute, the tolerance of
  ``test_torch_sliding_window.py``); ``validate(blend_mode="constant")``
  against the JAX ``validate``;
- ``train(profile_dir=...)`` writes a trace of epoch 1's steps;
- a checkpoint with an unexpected non-empty collection, or without a
  non-empty one the model needs, raises as in the JAX package; empty or
  absent ``batch_stats`` load for a GroupNorm model.
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from segmantic_tpu.data import cache as jcache
from segmantic_tpu.infer import sliding_window as jsw
from segmantic_tpu.models.unet import UNet as FlaxUNet
from segmantic_tpu.train import augment as jaug
from segmantic_tpu.train import optim as jo
from segmantic_tpu.train import trainer as jtrainer
from segmantic_tpu_torch.data import cache
from segmantic_tpu_torch.infer import sliding_window as sw
from segmantic_tpu_torch.models.unet import to_flax_variables
from segmantic_tpu_torch.train import checkpoint, optim, trainer
from segmantic_tpu_torch.train.augment import AugmentConfig
from tests.test_torch_train import phantoms  # noqa: F401 (a fixture)
from tests.test_torch_unet_slice import _bridge, _flax_variables
from tests.test_torch_unet_train import CFG, SHAPE, TOL, _flat

SW_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def case():
    module = FlaxUNet(spatial_dims=3, **CFG)
    variables = _flax_variables(module, seed=31)
    rng = np.random.default_rng(32)
    xs = [rng.standard_normal(SHAPE).astype(np.float32) for _ in range(2)]
    labels = [rng.integers(0, 3, SHAPE[:4]).astype(np.uint8) for _ in range(2)]
    return module, variables, xs, labels


# SGD with momentum, as test_torch_unet_train.py: Adam would turn the
# rounding noise in the gradients of the conv biases that feed a BatchNorm
# (true gradient zero) into whole steps of lr
OPT = {"optimizer": "SGD", "lr": 0.1, "momentum": 0.9}


def _port_step(variables, opt_cfg=OPT, **kw):
    model = _bridge(variables, **CFG).train().requires_grad_(True)
    opt = optim.make_optimizer(model.parameters(), opt_cfg)
    step = trainer.make_train_step(model, opt, AugmentConfig(flip_prob=0.0), SHAPE[1:4],
                                   mixed_precision=False, **kw)
    return model, opt, step


def test_accumulate_steps_matches_optax_multisteps(case):
    module, variables, xs, labels = case
    tx = optax.MultiSteps(jo.make_optimizer(OPT), every_k_schedule=2)
    jstep = jtrainer.make_train_step(module, tx, jaug.AugmentConfig(flip_prob=0.0),
                                     SHAPE[1:4], mixed_precision=False)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    stats = jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"])
    opt_state = tx.init(params)

    model, opt, step = _port_step(variables, accumulate_steps=2)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    for i in range(2):
        params, stats, opt_state, want_loss = jstep(
            params, stats, opt_state, jnp.asarray(xs[i]), jnp.asarray(labels[i]),
            jax.random.key(i))
        loss = step(torch.from_numpy(xs[i]), torch.from_numpy(labels[i]))
        np.testing.assert_allclose(loss.item(), float(want_loss), **TOL)
        if i == 0:  # the parameters wait for the second micro-batch, the statistics not
            for k, v in model.named_parameters():
                assert torch.equal(v.detach(), before[k]), k
            assert not torch.equal(model.state_dict()["ResidualUnit_0.ConvUnit_0.Norm_0"
                                                      ".running_mean"],
                                   before["ResidualUnit_0.ConvUnit_0.Norm_0.running_mean"])
    got = to_flax_variables(model.state_dict())
    for coll, want in (("params", params), ("batch_stats", stats)):
        flat = dict(_flat(got[coll]))
        for key, leaf in _flat(jax.tree_util.tree_map(np.asarray, want)):
            np.testing.assert_allclose(flat[key], leaf, err_msg="/".join(key), **TOL)


def test_accumulate_steps_advance_adam_once_per_update(case):
    _, variables, xs, labels = case
    model, opt, step = _port_step(variables, {"optimizer": "Adam", "lr": 1e-2},
                                  accumulate_steps=2)
    for i in range(4):
        step(torch.from_numpy(xs[i % 2]), torch.from_numpy(labels[i % 2]))
        counts = {int(s["step"]) for s in opt.state.values()}
        assert counts == ({(i + 1) // 2} if i else set())


def test_accumulate_steps_must_be_positive(case):
    with pytest.raises(ValueError, match="accumulate_steps"):
        _port_step(case[1], accumulate_steps=0)


def test_remat_gives_the_same_step_and_updates_the_statistics_once(case):
    _, variables, xs, labels = case
    runs = []
    for remat in (False, True):
        model = _bridge(variables, **CFG).train().requires_grad_(True)
        opt = torch.optim.SGD(model.parameters(), lr=0.0)  # keeps the gradients
        step = trainer.make_train_step(model, opt, AugmentConfig(flip_prob=0.0),
                                       SHAPE[1:4], mixed_precision=False, remat=remat)
        loss = step(torch.from_numpy(xs[0]), torch.from_numpy(labels[0]))
        runs.append((loss, {k: p.grad for k, p in model.named_parameters()},
                     {k: b.clone() for k, b in model.named_buffers()}))
    (loss0, grads0, stats0), (loss1, grads1, stats1) = runs
    assert torch.equal(loss0, loss1)
    for k in grads0:
        assert torch.equal(grads0[k], grads1[k]), k
    for k in stats0:  # one update, not two (the recomputation leaves them)
        assert torch.equal(stats0[k], stats1[k]), k


@pytest.mark.parametrize("mode", ["constant", "gaussian"])
def test_blend_modes_match_jax(mode):
    vol = np.random.default_rng(33).standard_normal((20, 14, 11, 1)).astype(np.float32)

    def jpred(w):  # depends on the window, so the blend weights matter
        return jnp.concatenate([w, w.mean(axis=(1, 2, 3), keepdims=True) - 2.0 * w], axis=-1)

    def ppred(w):
        return torch.cat([w, w.mean(dim=(1, 2, 3), keepdim=True) - 2.0 * w], dim=-1).float()

    want = np.asarray(jsw.sliding_window_inference(vol, (8, 8, 8), 3, jpred, overlap=0.5,
                                                   mode=mode))
    got = sw.sliding_window_inference(vol, (8, 8, 8), 3, ppred, overlap=0.5, mode=mode,
                                      device="cpu")
    np.testing.assert_allclose(got.numpy(), want, **SW_TOL)
    inferer = sw.SlidingWindowInferer((8, 8, 8), sw_batch_size=3, overlap=0.5, mode=mode,
                                      device="cpu")
    jinferer = jsw.SlidingWindowInferer((8, 8, 8), sw_batch_size=3, overlap=0.5, mode=mode)
    np.testing.assert_allclose(inferer(vol, ppred).numpy(), np.asarray(jinferer(vol, jpred)),
                               **SW_TOL)
    if mode == "constant":  # the plain mean of the windows that cover a voxel
        assert not np.allclose(got.numpy(), np.asarray(jsw.sliding_window_inference(
            vol, (8, 8, 8), 3, jpred, overlap=0.5, mode="gaussian")))


def test_unknown_blend_mode_raises(tmp_path):
    with pytest.raises(ValueError, match="mode"):
        sw.sliding_window_inference(np.zeros((4, 4, 4, 1), np.float32), (4, 4, 4), 1,
                                    lambda w: w, mode="triangle", device="cpu")
    with pytest.raises(ValueError, match="val_blend_mode"):
        trainer.train(output_dir=tmp_path, num_classes=2, val_blend_mode="triangle",
                      device="cpu")


def test_validate_with_constant_blend_matches_jax(phantoms):  # noqa: F811
    _, dataset, _ = phantoms
    files = dataset.training_files()[:2]
    module = jtrainer.UNet(spatial_dims=3, in_channels=1, out_channels=4,
                           channels=(4, 8, 16), strides=(2, 2))
    variables = _flax_variables(module, seed=34)
    model = trainer.SegmentationModel.create(num_classes=4, channels=(4, 8, 16),
                                             strides=(2, 2), device="cpu")
    model.module.load_state_dict({
        k: torch.from_numpy(np.array(v))
        for k, v in trainer.from_flax_variables(variables).items()})
    port = cache.VolumeCache(files, trainer.default_preprocessing(["image", "label"]), 4)
    ref = jcache.VolumeCache(files, jtrainer.default_preprocessing(["image", "label"]), 4)
    got = trainer.validate(model.module, port, 4, roi=(16, 16, 16), blend_mode="constant",
                           val_forward=trainer.make_val_forward(model.module, torch.float32))
    want = jtrainer.validate(module, variables, ref, 4, 3, roi=(16, 16, 16),
                             blend_mode="constant",
                             val_forward=jtrainer.make_val_forward(module, jnp.float32))
    np.testing.assert_allclose(got, want, **TOL)


def test_train_with_every_extra_writes_a_trace(phantoms, tmp_path):  # noqa: F811
    root, _, _ = phantoms
    result = trainer.train(
        image_dir=root / "image", labels_dir=root / "label", output_dir=tmp_path / "run",
        num_classes=4, spatial_size=(16, 16, 16), channels=(4, 8, 16), strides=(2, 2),
        max_epochs=2, mixed_precision=False, val_roi_size=(16, 16, 16), device="cpu",
        accumulate_steps=2, remat=True, val_blend_mode="constant",
        profile_dir=tmp_path / "profile", seed=0)
    assert len(result.history) == 2
    assert all(np.isfinite(v) for rec in result.history for v in rec.values())
    traces = list((tmp_path / "profile").glob("*.json"))
    assert [t.name for t in traces] == ["train_epoch1.pt.trace.json"]
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any("conv3d" in e.get("name", "") for e in events)


def test_load_applies_the_jax_rule_for_variable_collections(tmp_path):
    """Empty or absent collections are no mismatch (a GroupNorm model has no
    ``batch_stats``; the trainers save ``{}``); a non-empty one the model
    lacks, or a missing one it needs, raises."""
    seg = trainer.SegmentationModel.create(
        num_classes=2, arch="segresnet", device="cpu",
        arch_params={"init_filters": 4, "blocks_down": [1, 1], "blocks_up": [1]})
    unet = trainer.SegmentationModel.create(num_classes=2, channels=(4, 8), strides=(2,),
                                            device="cpu")
    params = seg.variables["params"]
    for variables in ({"params": params}, {"params": params, "batch_stats": {}}):
        checkpoint.save_checkpoint(tmp_path / "seg.ckpt", variables, seg.hparams)
        loaded = trainer.SegmentationModel.load(tmp_path / "seg.ckpt", device="cpu")
        for (k, a), b in zip(loaded.module.state_dict().items(),
                             seg.module.state_dict().values()):
            assert torch.equal(a, b), k
    checkpoint.save_checkpoint(tmp_path / "extra.ckpt",
                               {"params": params, "cache": {"x": np.zeros(1)}}, seg.hparams)
    with pytest.raises(ValueError, match="unexpected variable collections: \\['cache'\\]"):
        trainer.SegmentationModel.load(tmp_path / "extra.ckpt", device="cpu")
    checkpoint.save_checkpoint(tmp_path / "nostats.ckpt",
                               {"params": unet.variables["params"]}, unet.hparams)
    with pytest.raises(ValueError, match="missing variable collections: \\['batch_stats'\\]"):
        trainer.SegmentationModel.load(tmp_path / "nostats.ckpt", device="cpu")
