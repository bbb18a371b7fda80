"""The port's UNet training forward and train step vs the JAX package.

A tiny UNet (channels (4, 8, 16), strides (2, 2), 2 residual units,
3 classes: both decoder stages run in phase space) gets a flax variables tree
filled from a numpy seed, bridged into the torch modules, and both packages
run on the same numpy inputs in f32:

- the training forward with ``phase_logits`` against ``module.apply(...,
  training=True, mutable=["batch_stats"], phase_logits=True)``: output, the
  phase-major Dice loss, every parameter gradient (mapped to the flax tree by
  ``to_flax_variables``) and the updated BatchNorm statistics (flax's biased
  variance, momentum 0.9);
- one ``make_train_step`` step (flips off, f32, SGD with momentum) against
  the JAX step: loss, updated parameters and statistics;
- the plain forward on bf16 input against the JAX UNet on the same bf16
  input (the repaired ``Conv.forward`` casts its weights to the input's
  dtype, as the JAX module does).

Tolerances: f32 1e-4 absolute + 1e-3 relative for activations, loss and
statistics; gradients 1e-3 * max|g| of each tensor (the backward sums over
all voxels in another order; see ``_assert_grads_close`` for the floor);
bf16 2e-2 * max|ref|.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmantic_tpu.models.unet import UNet as FlaxUNet
from segmantic_tpu.ops import fast_conv as jfc
from segmantic_tpu.train import augment as jaug
from segmantic_tpu.train import losses as jl
from segmantic_tpu.train import optim as jo
from segmantic_tpu.train import trainer as jtrainer
from segmantic_tpu_torch.models.unet import UNet, to_flax_variables
from segmantic_tpu_torch.ops import fast_conv, fused_conv, phase_conv
from segmantic_tpu_torch.train import losses, optim, trainer
from segmantic_tpu_torch.train.augment import AugmentConfig
from tests.test_torch_unet_slice import _bridge, _flax_variables

CFG = dict(in_channels=1, out_channels=3, channels=(4, 8, 16), strides=(2, 2),
           num_res_units=2)
SHAPE = (2, 16, 16, 16, 1)
TOL = dict(atol=1e-4, rtol=1e-3)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _assert_grads_close(got_tree, want_tree):
    """Each gradient within 1e-3 * its max|g|; the floor of that scale,
    1e-2 of the largest gradient anywhere, covers the conv biases that feed
    a BatchNorm, whose true gradient is zero (the norm removes the mean) and
    whose computed gradients are rounding noise in both packages."""
    got = dict(_flat(got_tree))
    want = dict(_flat(want_tree))
    assert got.keys() == want.keys()
    floor = 1e-2 * max(np.abs(v).max() for v in want.values())
    for key in want:
        scale = max(np.abs(want[key]).max(), floor)
        np.testing.assert_allclose(got[key], want[key], atol=1e-3 * scale, rtol=0,
                                   err_msg="/".join(key))


@pytest.fixture(scope="module")
def case():
    module = FlaxUNet(spatial_dims=3, **CFG)
    variables = _flax_variables(module, seed=7)
    rng = np.random.default_rng(8)
    x = rng.standard_normal(SHAPE).astype(np.float32)
    labels = rng.integers(0, 3, SHAPE[:4]).astype(np.int32)
    return module, variables, x, labels


def test_training_forward_loss_grads_and_stats_match_flax(case):
    module, variables, x, labels = case
    yp = jfc.space_to_depth(jnp.asarray(labels[..., None]))

    def loss_fn(params):
        out, mutated = module.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, jnp.asarray(x),
            training=True, mutable=["batch_stats"], phase_logits=True)
        return jl.dice_loss_phase(out, yp), (out, mutated["batch_stats"])

    (want_loss, (want_out, want_stats)), want_grads = jax.value_and_grad(
        loss_fn, has_aux=True)(variables["params"])

    model = _bridge(variables, **CFG).train().requires_grad_(True)
    fused_conv.counter.reset()
    phase_conv.counter.reset()
    out = model(torch.from_numpy(x), phase_logits=True)
    assert out.shape == (2, 8, 8, 8, 24) and fused_conv.counter.count == 0  # CPU: plain
    loss = losses.dice_loss_phase(out, fast_conv.space_to_depth(
        torch.from_numpy(labels[..., None])))
    loss.backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), **TOL)
    np.testing.assert_allclose(loss.item(), float(want_loss), **TOL)
    grads = to_flax_variables({k: p.grad for k, p in model.named_parameters()})["params"]
    _assert_grads_close(grads, want_grads)
    stats = to_flax_variables(model.state_dict())["batch_stats"]
    for key, leaf in _flat(want_stats):
        np.testing.assert_allclose(dict(_flat(stats))[key], leaf, **TOL)


def test_training_forward_full_resolution_output(case):
    """Without ``phase_logits`` the output is the depth-to-space of the
    phase-major one (same batch statistics)."""
    module, variables, x, _ = case
    model = _bridge(variables, **CFG).train()
    with torch.no_grad():
        full = model(torch.from_numpy(x))
        model.load_state_dict(_bridge(variables, **CFG).state_dict())
        ph = model(torch.from_numpy(x), phase_logits=True)
    np.testing.assert_allclose(fast_conv.space_to_depth(full).numpy(), ph.numpy(),
                               atol=1e-6, rtol=1e-6)
    want, _ = module.apply(variables, jnp.asarray(x), training=True,
                           mutable=["batch_stats"])
    np.testing.assert_allclose(full.numpy(), np.asarray(want), **TOL)


def test_train_step_matches_jax_step(case):
    module, variables, x, labels = case
    opt_cfg = {"optimizer": "SGD", "lr": 0.1, "momentum": 0.9}
    tx = jo.make_optimizer(opt_cfg)
    jstep = jtrainer.make_train_step(module, tx, jaug.AugmentConfig(flip_prob=0.0),
                                     (16, 16, 16), mixed_precision=False)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    stats = jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"])
    new_params, new_stats, _, want_loss = jstep(
        params, stats, tx.init(params), jnp.asarray(x), jnp.asarray(labels.astype(np.uint8)),
        jax.random.key(0))

    model = _bridge(variables, **CFG).train().requires_grad_(True)
    opt = optim.make_optimizer(model.parameters(), opt_cfg)
    step = trainer.make_train_step(model, opt, AugmentConfig(flip_prob=0.0), (16, 16, 16),
                                   mixed_precision=False)
    loss = step(torch.from_numpy(x), torch.from_numpy(labels.astype(np.uint8)))
    np.testing.assert_allclose(loss.item(), float(want_loss), **TOL)
    got = to_flax_variables(model.state_dict())
    want = {"params": new_params, "batch_stats": new_stats}
    for key, leaf in _flat(jax.tree_util.tree_map(np.asarray, want)):
        np.testing.assert_allclose(dict(_flat(got))[key], leaf, atol=2e-4, rtol=1e-3,
                                   err_msg="/".join(key))


def test_plain_forward_bf16_matches_flax_bf16(case):
    module, variables, x, _ = case
    model = _bridge(variables, **CFG)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(module.apply(variables, xb, training=False).astype(jnp.float32))
    with torch.no_grad():
        got = model(torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2 * np.abs(want).max())


def test_bf16_training_forward_keeps_f32_master_gradients(case):
    _, variables, x, labels = case
    model = _bridge(variables, **CFG).train().requires_grad_(True)
    out = model(torch.from_numpy(x).bfloat16(), phase_logits=True)
    assert out.dtype == torch.bfloat16
    losses.dice_loss_phase(out, fast_conv.space_to_depth(
        torch.from_numpy(labels[..., None]))).backward()
    for name, p in model.named_parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32, name
        assert torch.isfinite(p.grad).all(), name
    for name, buf in model.named_buffers():
        assert buf.dtype == torch.float32, name


def test_training_with_dropout_raises():
    model = UNet(**dict(CFG, dropout=0.1)).train()
    with pytest.raises(NotImplementedError, match="JAX trainer refuses it"):
        model(torch.zeros(SHAPE))


def test_f64_reference_step_on_the_cpu(case):
    """The plain versions take f64 on the CPU (the f64 reference of the
    card's f32 step): the whole step runs in f64 and lands within f32
    rounding of the f32 step; half precision is refused."""
    _, variables, x, labels = case
    results = []
    for dtype in (torch.float32, torch.float64):
        model = _bridge(variables, **CFG).to(dtype).train().requires_grad_(True)
        step = trainer.make_train_step(model, torch.optim.SGD(model.parameters(), lr=0.0),
                                       AugmentConfig(flip_prob=0.0), (16, 16, 16),
                                       mixed_precision=False)
        loss = step(torch.from_numpy(x).to(dtype), torch.from_numpy(labels))
        assert loss.dtype == dtype
        results.append((loss.item(), [p.grad.double() for p in model.parameters()]))
    (l32, g32), (l64, g64) = results
    np.testing.assert_allclose(l32, l64, rtol=1e-5)
    scale = max(g.abs().max().item() for g in g64)
    for a, b in zip(g32, g64):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4 * scale, rtol=0)
    with pytest.raises(TypeError, match="float64 on the CPU"):
        fused_conv.conv3d(torch.zeros(1, 3, 3, 3, 2, dtype=torch.float16),
                          torch.zeros(3, 3, 3, 2, 2, dtype=torch.float16))
