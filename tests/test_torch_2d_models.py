"""The port's 2D UNet and 2D SegResNet against the JAX package.

A tiny 2D UNet (channels (4, 8, 16), strides (2, 2), 2 residual units, 3
classes: both decoder stages run in phase space, 4 phases) and a tiny 2D
SegResNet (init_filters 4, blocks_down (1, 2), blocks_up (1,)) get a flax
variables tree filled from a numpy seed, bridged into the torch modules
(HWIO <-> OIHW, transposed kernels flipped), and both packages run on the
same numpy inputs:

- the eval forward in f32 within 1e-5 * max|ref|, and bf16 judged against
  the flax f32 output within 2e-2 * max|ref| (as the JAX bf16 is);
- the training forward (batch statistics) in f32 within 1e-5 * max|ref|, the
  UNet's phase-major logits among them, and the updated running statistics;
- every parameter gradient of the Dice loss (the phase-major Dice at 4
  phases for the UNet) of one f64 step, per tensor within 1e-5 * max|g| of
  that tensor (floor 1e-3 of the largest gradient: conv biases before a
  norm, whose true gradient is zero), the loss within 1e-6: the JAX Dice
  takes its softmax in f32 even under x64;
- the bridge round trip, the phase gate in 2D against the JAX
  ``phase_stage_ok``, UNETR 2D refused by both packages, and training with
  dropout > 0 refused by both (the JAX trainer's step passes no dropout PRNG
  stream) while the eval forward with dropout stays the identity.
"""

from __future__ import annotations

import flax.errors
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmantic_tpu.models import unet as junet
from segmantic_tpu.models.segresnet import SegResNet as FlaxSegResNet
from segmantic_tpu.models.unet import UNet as FlaxUNet
from segmantic_tpu.models.unetr import UNETR as FlaxUNETR
from segmantic_tpu.ops import fast_conv as jfc
from segmantic_tpu.train import losses as jl
from segmantic_tpu_torch.models.segresnet import SegResNet
from segmantic_tpu_torch.models.unet import (
    PHASE_MAX, UNet, from_flax_variables, to_flax_variables,
)
from segmantic_tpu_torch.models.unetr import UNETR
from segmantic_tpu_torch.ops import fast_conv
from segmantic_tpu_torch.train import losses

UNET = dict(spatial_dims=2, in_channels=1, out_channels=3, channels=(4, 8, 16),
            strides=(2, 2), num_res_units=2)
SEGRESNET = dict(spatial_dims=2, in_channels=1, out_channels=3, init_filters=4,
                 blocks_down=(1, 2), blocks_up=(1,))
ARCHS = {"unet": (FlaxUNet, UNet, UNET), "segresnet": (FlaxSegResNet, SegResNet, SEGRESNET)}
SHAPE = (2, 32, 32, 1)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def flax_variables_2d(module, seed: int):
    """The flax variables of a 2D module (shapes traced, not run) filled from a
    numpy seed: lecun-scale kernels, non-trivial biases, norm scales and
    running statistics."""
    shapes = jax.eval_shape(lambda k, x: module.init(k, x, training=False),
                            jax.random.key(0), jnp.zeros((1, 8, 8, module.in_channels)))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        n = rng.standard_normal(leaf.shape)
        if name == "kernel":
            v = n / np.sqrt(np.prod(leaf.shape[:-1]))
        elif name in ("var", "scale"):
            v = 1.0 + 0.2 * np.abs(n)
        elif name == "alpha":
            v = 0.25 + 0.05 * n
        else:  # bias, mean
            v = 0.1 * n
        return v.astype(np.float32)

    return jax.tree_util.tree_map(np.asarray, jax.tree_util.tree_map_with_path(fill, shapes))


def bridge(cls, variables, **cfg):
    model = cls(**cfg)
    state = from_flax_variables(variables)
    assert set(state) == set(model.state_dict())
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in state.items()})
    return model.eval()


@pytest.fixture(scope="module", params=sorted(ARCHS))
def case(request):
    flax_cls, cls, cfg = ARCHS[request.param]
    module = flax_cls(**cfg)
    variables = flax_variables_2d(module, seed=21)
    rng = np.random.default_rng(22)
    x = rng.standard_normal(SHAPE).astype(np.float32)
    labels = rng.integers(0, 3, SHAPE[:3]).astype(np.int32)
    return request.param, module, variables, x, labels, bridge(cls, variables, **cfg)


def _close(got, want, frac):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= frac * np.abs(want).max(), (err, np.abs(want).max())


def test_bridge_round_trip_2d(case):
    """HWIO <-> OIHW for convs, flax's unflipped (H, W, Ci, Co) <-> the
    flipped (Ci, Co, H, W) of ConvTranspose; the tree comes back bit-equal."""
    name, _, variables, _, _, model = case
    state = model.state_dict()
    flat = dict(_flat(variables["params"]))
    for path, kernel in flat.items():
        if path[-1] != "kernel":
            continue
        w = state[".".join(path[:-1]) + ".weight"].numpy()
        if path[-2] in ("ConvTranspose_0", "up_0"):
            np.testing.assert_array_equal(w, kernel[::-1, ::-1].transpose(2, 3, 0, 1))
        else:
            np.testing.assert_array_equal(w, kernel.transpose(3, 2, 0, 1))
    back = to_flax_variables(state)
    for col in variables:
        want = dict(_flat(variables[col]))
        got = dict(_flat(back[col]))
        assert got.keys() == want.keys()
        for key in want:
            np.testing.assert_array_equal(got[key], want[key])


def test_eval_forward_matches_flax_f32(case):
    _, module, variables, x, _, model = case
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    want = jax.jit(lambda v, x: module.apply(v, x, training=False))(variables, jnp.asarray(x))
    assert got.shape == SHAPE[:3] + (3,)
    _close(got, want, 1e-5)


def test_eval_forward_bf16_against_flax_f32(case):
    _, module, variables, x, _, model = case
    with torch.no_grad():
        got = model(torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16
    want = module.apply(variables, jnp.asarray(x), training=False)
    _close(got.float().numpy(), want, 2e-2)


def test_training_forward_and_statistics_match_flax_f32(case):
    name, module, variables, x, _, model = case
    kw = dict(phase_logits=True) if name == "unet" else {}
    want, mutated = module.apply(variables, jnp.asarray(x), training=True,
                                 mutable=["batch_stats"], **kw)
    model.train()
    with torch.no_grad():
        got = model(torch.from_numpy(x), **kw)
    if name == "unet":
        assert got.shape == (2, 16, 16, 12)  # 4 phases of 3 classes at half resolution
    _close(got.numpy(), want, 1e-5)
    stats = dict(_flat(to_flax_variables(model.state_dict())["batch_stats"]))
    want_stats = dict(_flat(mutated.get("batch_stats", {})))
    assert stats.keys() == want_stats.keys()
    for key, leaf in want_stats.items():
        np.testing.assert_allclose(stats[key], leaf, atol=1e-6, rtol=1e-5)


def test_gradients_of_one_f64_step_match_flax(case):
    """The UNet's loss is the phase-major Dice at 4 phases on its phase
    logits, the SegResNet's the full-resolution Dice."""
    name, module, variables, x, labels, model = case
    phase = name == "unet"
    with jax.enable_x64(True):
        params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                        variables["params"])
        stats = variables.get("batch_stats", {})

        def loss_fn(p):
            out, _ = module.apply({"params": p, "batch_stats": stats},
                                  jnp.asarray(x, jnp.float64), training=True,
                                  mutable=["batch_stats"],
                                  **(dict(phase_logits=True) if phase else {}))
            if phase:
                return jl.dice_loss_phase(out, jfc.space_to_depth(
                    jnp.asarray(labels[..., None])))
            return jl.dice_loss(out, jnp.asarray(labels))

        want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
        want_grads = dict(_flat(jax.tree_util.tree_map(np.asarray, want_grads)))
    model = model.double().train().requires_grad_(True)
    if phase:
        out = model(torch.from_numpy(x).double(), phase_logits=True)
        loss = losses.dice_loss_phase(out, fast_conv.space_to_depth(
            torch.from_numpy(labels[..., None])))
    else:
        loss = losses.dice_loss(model(torch.from_numpy(x).double()), torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-6)
    got = dict(_flat(to_flax_variables(
        {k: p.grad for k, p in model.named_parameters()})["params"]))
    assert got.keys() == want_grads.keys()
    floor = 1e-3 * max(np.abs(v).max() for v in want_grads.values())
    for key, want in want_grads.items():
        scale = max(np.abs(want).max(), floor)
        np.testing.assert_allclose(got[key], want, atol=1e-5 * scale, rtol=0,
                                   err_msg="/".join(key))


def test_phase_gate_is_the_jax_gate_at_4_phases():
    """``(2 ** nd) * out_feats <= 128``: 32 classes still take the phase top
    stage in 2D (8 would be the 3D limit at 16)."""
    for nd in (2, 3):
        for feats in (3, 16, 17, 32, 33):
            model = UNet(spatial_dims=nd, out_channels=feats, channels=(4, 8), strides=(2,))
            want = junet.phase_stage_ok(nd, feats, 2, num_res_units=2, dropout=0.0,
                                        kernel_size=3, up_kernel_size=3)
            assert model.phase_top_ok() == want == ((2**nd) * feats <= PHASE_MAX)


def test_phase_logits_are_the_space_to_depth_of_the_output():
    model = bridge(UNet, flax_variables_2d(FlaxUNet(**UNET), seed=25), **UNET).train()
    x = np.random.default_rng(26).standard_normal(SHAPE).astype(np.float32)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        full = model(torch.from_numpy(x))
        model.load_state_dict(state)
        ph = model(torch.from_numpy(x), phase_logits=True)
    np.testing.assert_allclose(fast_conv.space_to_depth(full).numpy(), ph.numpy(),
                               atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(fast_conv.depth_to_space(ph, 3).numpy(), full.numpy(),
                               atol=1e-6, rtol=1e-6)


def test_unetr_2d_raises_in_both_packages():
    with pytest.raises(ValueError, match="UNETR is 3D"):
        UNETR(spatial_size=(32, 32), spatial_dims=2)
    module = FlaxUNETR(spatial_dims=2, hidden_size=16, num_layers=1, num_heads=2, mlp_dim=16,
                       feature_size=4)
    with pytest.raises(ValueError, match="UNETR is 3D"):
        module.init(jax.random.key(0), jnp.zeros((1, 32, 32, 1)))


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_dropout_in_training_raises_in_both_packages(name):
    """The reference's own refusal: its train step applies the module with
    ``training=True`` and no ``dropout`` PRNG stream, which flax's
    ``nn.Dropout`` refuses. The eval forwards with dropout are the identity
    in both, so they still agree."""
    flax_cls, cls, cfg = ARCHS[name]
    cfg = dict(cfg, dropout=0.2)
    module = flax_cls(**cfg)
    variables = flax_variables_2d(module, seed=23)
    x = np.random.default_rng(24).standard_normal(SHAPE).astype(np.float32)
    with pytest.raises(flax.errors.InvalidRngError, match="dropout"):
        module.apply(variables, jnp.asarray(x), training=True, mutable=["batch_stats"])
    model = bridge(cls, variables, **cfg)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    _close(got, module.apply(variables, jnp.asarray(x), training=False), 1e-5)
    with pytest.raises(NotImplementedError, match="JAX trainer refuses it"):
        model.train()(torch.from_numpy(x))
