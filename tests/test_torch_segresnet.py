"""The port's SegResNet and its norms and activations against the JAX package.

A tiny SegResNet (init_filters 4, blocks_down (1, 2), blocks_up (1,), 3
classes, GroupNorm, ReLU) gets a flax variables tree filled from a numpy seed,
bridged into the torch modules; both packages run on the same numpy inputs:

- the forward in f32 and in bf16, and every parameter gradient of the Dice
  loss in f64 (mapped to the flax tree by ``to_flax_variables``);
- ``make_norm`` in its four kinds (with phase groups, and BatchNorm's
  running statistics in training) and each activation, against the JAX
  ``Norm`` and ``_activation``;
- a checkpoint written by either package read by the other, the variables
  bit-equal;
- ``train(arch="segresnet", device="cpu")`` for two epochs; ``predict`` label
  maps against the JAX ``predict`` (both forwards in f32); a UNet + SegResNet
  ``ensemble_creator`` against the JAX one (as
  ``tests/infer/test_ensemble_mixed_arch.py``).

Tolerances: f32 1e-4 absolute + 1e-3 relative; bf16 2e-2 * max|ref|;
gradients 1e-3 * max|g| of each tensor (``_assert_grads_close``); label maps
>= 99.9% equal (summation order only).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import segmantic_tpu.infer.ensemble as jensemble
import segmantic_tpu.infer.predict as jpredict
import segmantic_tpu_torch.infer.ensemble as pensemble
import segmantic_tpu_torch.infer.predict as ppredict
from segmantic_tpu.models import unet as junet
from segmantic_tpu.models.segresnet import SegResNet as FlaxSegResNet
from segmantic_tpu.train import checkpoint as jckpt
from segmantic_tpu.train import losses as jl
from segmantic_tpu.train.trainer import SegmentationModel as JaxModel
from segmantic_tpu_torch.models import unet as punet
from segmantic_tpu_torch.models.segresnet import SegResNet
from segmantic_tpu_torch.models.unet import from_flax_variables, to_flax_variables
from segmantic_tpu_torch.train import losses, trainer
from segmantic_tpu_torch.train.trainer import SegmentationModel
from tests.test_torch_predict import _agreement, f32_forwards, write_case
from tests.test_torch_train import phantoms  # noqa: F401 (a fixture)
from tests.test_torch_unet_slice import _flax_variables
from tests.test_torch_unet_train import TOL, _assert_grads_close

CFG = dict(in_channels=1, out_channels=3, init_filters=4, blocks_down=(1, 2), blocks_up=(1,))
ARCH_PARAMS = {"init_filters": 4, "blocks_down": [1, 2], "blocks_up": [1]}
SHAPE = (2, 16, 16, 16, 1)


def _bridge(variables, **cfg):
    model = SegResNet(**cfg)
    state = from_flax_variables(jax.tree_util.tree_map(np.asarray, variables))
    assert set(state) == set(model.state_dict())
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in state.items()})
    return model.eval()


@pytest.fixture(scope="module")
def case():
    module = FlaxSegResNet(**CFG)
    variables = _flax_variables(module, seed=11)
    rng = np.random.default_rng(12)
    x = rng.standard_normal(SHAPE).astype(np.float32)
    labels = rng.integers(0, 3, SHAPE[:4]).astype(np.int32)
    return module, variables, x, labels


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """A SegResNet and a UNet checkpoint written by the JAX package."""
    root = tmp_path_factory.mktemp("segresnet")
    out = {}
    for name, kw in (("segresnet", dict(arch="segresnet", arch_params=ARCH_PARAMS)),
                     ("unet", dict(channels=(4, 8), strides=(2,), num_res_units=1))):
        model = JaxModel.create(num_classes=3, spatial_size=(16, 16, 16), seed=4, **kw)
        out[name] = root / f"{name}.ckpt"
        jckpt.save_checkpoint(out[name], model.variables, model.hparams,
                              metrics={"val_dice": 0.5})
    return out


def test_forward_matches_flax_f32(case):
    module, variables, x, _ = case
    model = _bridge(variables, **CFG)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(lambda v, x: module.apply(v, x, training=False))(
        variables, jnp.asarray(x)))
    assert got.shape == SHAPE[:4] + (3,)
    np.testing.assert_allclose(got, want, **TOL)


def test_forward_matches_flax_bf16(case):
    module, variables, x, _ = case
    model = _bridge(variables, **CFG)
    with torch.no_grad():
        got = model(torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    want = np.asarray(jax.jit(lambda v, x: module.apply(v, x, training=False))(
        variables, jnp.asarray(x, jnp.bfloat16))).astype(np.float32)
    assert np.abs(got.float().numpy() - want).max() <= 2e-2 * np.abs(want).max()


def test_gradients_match_flax(case):
    """Every parameter gradient of the Dice loss in f64 (the plain versions
    take f64 on the CPU; JAX under ``jax.enable_x64``): in f32 both packages'
    gradients of the tensors that feed a norm are dominated by summation
    order, each as far from the f64 gradient as from the other."""
    module, variables, x, labels = case

    with jax.enable_x64(True):
        params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                        variables["params"])

        def loss_fn(p):
            out = module.apply({"params": p}, jnp.asarray(x, jnp.float64), training=True)
            return jl.dice_loss(out, jnp.asarray(labels))

        want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
        want_grads = jax.tree_util.tree_map(np.asarray, want_grads)
    model = _bridge(variables, **CFG).double().train().requires_grad_(True)
    loss = losses.dice_loss(model(torch.from_numpy(x).double()), torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), **TOL)
    grads = to_flax_variables({k: p.grad for k, p in model.named_parameters()})["params"]
    _assert_grads_close(grads, want_grads)


def test_phase_logits_and_dropout_in_training_raise(case):
    _, variables, x, _ = case
    model = _bridge(variables, **CFG)
    assert not model.phase_top_ok()
    with pytest.raises(ValueError, match="phase-logits"):
        model(torch.from_numpy(x), phase_logits=True)
    dropped = SegResNet(dropout=0.1, **CFG).train()
    with pytest.raises(NotImplementedError, match="JAX trainer refuses it"):
        dropped(torch.from_numpy(x))


@pytest.mark.parametrize("phase_groups", [1, 8])
@pytest.mark.parametrize("kind", ["BATCH", "INSTANCE", "GROUP", "NONE"])
def test_norm_matches_jax(kind, phase_groups):
    c = 16
    rng = np.random.default_rng(13)
    x = (2.0 * rng.standard_normal((2, 3, 4, 5, phase_groups * c)) + 0.5).astype(np.float32)
    jnorm = junet.Norm(kind=kind, phase_groups=phase_groups)
    shapes = jax.eval_shape(lambda k: jnorm.init(k, jnp.asarray(x), False), jax.random.key(0))
    fill = np.random.default_rng(14)
    variables = jax.tree_util.tree_map_with_path(  # scales and variances > 0
        lambda path, leaf: (0.2 * fill.standard_normal(leaf.shape)
                            + (1.0 if path[-1].key in ("scale", "var") else 0.0)
                            ).astype(np.float32), shapes)
    norm = punet.make_norm(kind, c)
    if kind == "NONE":
        assert norm is None
        return
    # the flax tree of the module alone, under the name the models give it
    state = from_flax_variables(jax.tree_util.tree_map(
        np.asarray, {col: {"Norm_0": tree} for col, tree in variables.items()}))
    norm.load_state_dict({k[len("Norm_0."):]: torch.from_numpy(np.array(v))
                          for k, v in state.items()})
    for training in (False, True):
        norm.train(training)
        got = norm(torch.from_numpy(x), groups=phase_groups)
        want, mutated = jnorm.apply(variables, jnp.asarray(x), training,
                                    mutable=["batch_stats"])
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
        if kind == "BATCH" and training:
            stats = mutated["batch_stats"]["BatchNorm_0"]
            np.testing.assert_allclose(norm.running_mean.numpy(), stats["mean"], **TOL)
            np.testing.assert_allclose(norm.running_var.numpy(), stats["var"], **TOL)
        got16 = norm(torch.from_numpy(x).to(torch.bfloat16), groups=phase_groups)
        want16, _ = jnorm.apply(variables, jnp.asarray(x, jnp.bfloat16), training,
                                mutable=["batch_stats"])
        want16 = np.asarray(want16).astype(np.float32)
        assert got16.dtype == torch.bfloat16
        assert np.abs(got16.float().detach().numpy() - want16).max() <= \
            2e-2 * np.abs(want16).max()


def test_group_norm_groups_are_channel_blocks():
    """flax's group order: channel c is in group c // (C / groups)."""
    norm = punet.make_norm("GROUP", 16)
    assert norm.GroupNorm_0.groups == 8
    x = torch.zeros(1, 2, 2, 2, 16)
    x[..., 2:4] = torch.arange(16.0).reshape(1, 2, 2, 2, 2)  # group 1 only
    y = norm(x)
    assert torch.equal(y[..., :2], torch.zeros_like(y[..., :2]))
    assert y[..., 2:4].std() > 0.5
    assert punet.make_norm("INSTANCE", 6).GroupNorm_0.groups == 6
    assert punet.make_norm("GROUP", 4).GroupNorm_0.groups == 4
    with pytest.raises(ValueError, match="unsupported norm"):
        punet.make_norm("LAYER", 4)


@pytest.mark.parametrize("name", ["PRELU", "RELU", "LEAKYRELU", "GELU", "TANH"])
def test_activations_match_jax(name):
    x = np.random.default_rng(15).standard_normal((3, 4, 5)).astype(np.float32) * 3
    fn = junet._activation(name)
    if name == "PRELU":
        want = np.asarray(fn.apply({"params": {"alpha": np.full((1,), 0.3, np.float32)}},
                                   jnp.asarray(x)))
        prelu = punet.PReLU(0.3)
        got = prelu(torch.from_numpy(x)).detach().numpy()
    else:
        want = np.asarray(fn(jnp.asarray(x)))
        got = punet.activation(name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError, match="unsupported activation"):
        punet.activation("SWISH")


@pytest.mark.parametrize("norm,act", [("INSTANCE", "GELU"), ("GROUP", "LEAKYRELU"),
                                      ("BATCH", "TANH")])
def test_unet_takes_every_norm_and_activation(norm, act):
    """The UNet's norms and activations, in training (with phase stages) and
    through the eval forward the trainer picks (the folded executor takes
    BATCH / NONE with PRELU / RELU only)."""
    cfg = dict(in_channels=1, out_channels=3, channels=(4, 8), strides=(2,),
               num_res_units=1, norm=norm, act=act)
    module = junet.UNet(spatial_dims=3, **cfg)
    variables = _flax_variables(module, seed=16)
    model = punet.UNet(**cfg)
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                           from_flax_variables(jax.tree_util.tree_map(np.asarray,
                                                                      variables)).items()})
    x = np.random.default_rng(17).standard_normal((2, 8, 8, 8, 1)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, x: module.apply(v, x, training=False))(
        variables, jnp.asarray(x)))
    got = trainer.make_val_forward(model, torch.float32)(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    want_t, _ = jax.jit(lambda v, x: module.apply(v, x, training=True, mutable=["batch_stats"]))(
        variables, jnp.asarray(x))
    got_t = model.train()(torch.from_numpy(x))
    np.testing.assert_allclose(got_t.detach().numpy(), np.asarray(want_t), **TOL)


def test_checkpoints_round_trip_both_ways(ckpts, tmp_path):
    jax_model = JaxModel.load(ckpts["segresnet"])
    port = SegmentationModel.load(ckpts["segresnet"], device="cpu")
    assert isinstance(port.module, SegResNet) and port.module.init_filters == 4
    want = jax.tree_util.tree_map(np.asarray, jax_model.variables)
    got = port.variables
    assert got["batch_stats"] == {} and "batch_stats" not in want  # GroupNorm: none
    flat_w = dict(jax.tree_util.tree_leaves_with_path(want["params"]))
    flat_g = dict(jax.tree_util.tree_leaves_with_path(got["params"]))
    assert flat_w.keys() == flat_g.keys()
    for path, leaf in flat_w.items():
        np.testing.assert_array_equal(flat_g[path], leaf)
    port.save(tmp_path / "port.ckpt")
    back = JaxModel.load(tmp_path / "port.ckpt")
    for path, leaf in jax.tree_util.tree_leaves_with_path(back.variables["params"]):
        np.testing.assert_array_equal(np.asarray(leaf), flat_w[path])
    x = np.random.default_rng(18).standard_normal((1, 16, 16, 16, 1)).astype(np.float32)
    with torch.no_grad():
        got_y = port.module(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got_y, np.asarray(back.apply(jnp.asarray(x))), **TOL)


def test_train_two_epochs_on_cpu(phantoms, tmp_path):  # noqa: F811
    root, _, _ = phantoms
    result = trainer.train(
        image_dir=root / "image", labels_dir=root / "label", output_dir=tmp_path,
        num_classes=4, spatial_size=(16, 16, 16), arch="segresnet",
        arch_params=ARCH_PARAMS, max_epochs=2, mixed_precision=False,
        val_roi_size=(16, 16, 16), batch_size=2, num_samples=2, device="cpu", seed=0)
    assert len(result.history) == 2
    assert all(np.isfinite(v) for rec in result.history for v in rec.values())
    assert (tmp_path / "last.ckpt").exists() and result.best_checkpoint.exists()
    jax_model = JaxModel.load(tmp_path / "last.ckpt")
    assert type(jax_model.module).__name__ == "SegResNet"


def test_predict_label_maps_match_jax(ckpts, tmp_path, monkeypatch):
    images, labels = zip(*(write_case(tmp_path / "data", f"c{i}", shape, i)
                           for i, shape in enumerate([(20, 18, 14), (22, 16, 15)])))
    f32_forwards(monkeypatch, jpredict, ppredict)
    kw = dict(test_labels=list(labels), tissue_dict={"Background": 0, "A": 1, "B": 2},
              sw_batch_size=2)
    want = jpredict.predict(ckpts["segresnet"], list(images), output_dir=tmp_path / "jax", **kw)
    got = ppredict.predict(ckpts["segresnet"], list(images), output_dir=tmp_path / "port",
                           device="cpu", **kw)
    for g, w in zip(got, want):
        assert _agreement(g.saved_to, w.saved_to) >= 0.999
        assert abs(g.dice - w.dice) <= 1e-3


def test_mixed_architecture_ensemble_matches_jax(ckpts, tmp_path, monkeypatch):
    image, _ = write_case(tmp_path / "data", "case", (20, 18, 16), 5)
    f32_forwards(monkeypatch, jensemble, pensemble)
    files = [ckpts["unet"], ckpts["segresnet"]]
    kw = dict(combination_mode="mean", roi_size=(16, 16, 16))
    want = jensemble.ensemble_creator(files, [image], output_dir=tmp_path / "jax", **kw)
    got = pensemble.ensemble_creator(files, [image], output_dir=tmp_path / "port",
                                     device="cpu", **kw)
    assert len(got) == len(want) == 1 and got[0].name == want[0].name
    assert _agreement(got[0], want[0]) >= 0.999
