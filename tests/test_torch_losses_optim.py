"""Losses, optimizers and LR schedules of the port vs the JAX package.

- ``dice_loss``, ``dice_loss_phase`` and ``dice_ce_loss``: values and
  gradients (the closed-form backward of the autograd Functions against
  ``jax.grad`` of the JAX losses, whose production paths are custom VJPs too),
  with and without background, on numpy-seeded f32 logits. Tolerance 1e-6
  absolute + 1e-5 relative (f32 sums over a few thousand voxels).
- Optimizers: N updates of SGD (momentum), Adam, amsgrad and AdaBelief from
  ``make_optimizer`` against the optax transforms of the JAX
  ``make_optimizer`` on the same gradient sequence, including a learning-rate
  change between steps. Tolerance 1e-6 absolute + 1e-5 relative.
- ``LRScheduler`` sequences against the JAX class (exact).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from segmantic_tpu.ops import fast_conv as jfc
from segmantic_tpu.train import losses as jl
from segmantic_tpu.train import optim as jo
from segmantic_tpu_torch.ops import fast_conv
from segmantic_tpu_torch.train import losses, optim

TOL = dict(atol=1e-6, rtol=1e-5)


def _case(seed, shape=(2, 6, 4, 8), classes=4):
    rng = np.random.default_rng(seed)
    logits = (2.0 * rng.standard_normal(shape + (classes,))).astype(np.float32)
    labels = rng.integers(0, classes, shape).astype(np.int32)
    return logits, labels


def _port_value_grad(fn, logits, labels, **kw):
    x = torch.from_numpy(logits).requires_grad_()
    loss = fn(x, torch.from_numpy(labels), **kw)
    loss.backward()
    return loss.item(), x.grad.numpy()


@pytest.mark.parametrize("include_background", [True, False])
def test_dice_loss_matches_jax(include_background):
    logits, labels = _case(0)
    val, grad = _port_value_grad(losses.dice_loss, logits, labels,
                                 include_background=include_background)
    ref = lambda x: jl.dice_loss(x, jnp.asarray(labels),  # noqa: E731
                                 include_background=include_background)
    want, want_g = jax.value_and_grad(ref)(jnp.asarray(logits))
    np.testing.assert_allclose(val, float(want), **TOL)
    np.testing.assert_allclose(grad, np.asarray(want_g), **TOL)


@pytest.mark.parametrize("include_background", [True, False])
def test_dice_loss_onehot_labels_autograd_path(include_background):
    logits, labels = _case(1)
    onehot = np.eye(4, dtype=np.float32)[labels]
    val, grad = _port_value_grad(losses.dice_loss, logits, onehot,
                                 include_background=include_background)
    ref = lambda x: jl.dice_loss(x, jnp.asarray(onehot),  # noqa: E731
                                 include_background=include_background)
    want, want_g = jax.value_and_grad(ref)(jnp.asarray(logits))
    np.testing.assert_allclose(val, float(want), **TOL)
    np.testing.assert_allclose(grad, np.asarray(want_g), **TOL)


@pytest.mark.parametrize("include_background", [True, False])
def test_dice_loss_phase_matches_jax_and_full_resolution(include_background):
    logits, labels = _case(2, shape=(2, 4, 6, 8), classes=3)
    xp = fast_conv.space_to_depth(torch.from_numpy(logits)).numpy()
    yp = fast_conv.space_to_depth(torch.from_numpy(labels[..., None])).numpy()
    val, grad = _port_value_grad(losses.dice_loss_phase, xp, yp,
                                 include_background=include_background)
    ref = lambda x: jl.dice_loss_phase(x, jnp.asarray(yp),  # noqa: E731
                                       include_background=include_background)
    want, want_g = jax.value_and_grad(ref)(jnp.asarray(xp))
    np.testing.assert_allclose(val, float(want), **TOL)
    np.testing.assert_allclose(grad, np.asarray(want_g), **TOL)
    full = losses.dice_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                            include_background=include_background).item()
    np.testing.assert_allclose(val, full, **TOL)  # Dice ignores voxel order
    assert np.array_equal(
        yp, np.asarray(jfc.space_to_depth(jnp.asarray(labels[..., None]))))


def test_dice_ce_loss_matches_jax():
    logits, labels = _case(3)
    val, grad = _port_value_grad(losses.dice_ce_loss, logits, labels,
                                 lambda_dice=0.7, lambda_ce=1.3)
    ref = lambda x: jl.dice_ce_loss(x, jnp.asarray(labels),  # noqa: E731
                                    lambda_dice=0.7, lambda_ce=1.3)
    want, want_g = jax.value_and_grad(ref)(jnp.asarray(logits))
    np.testing.assert_allclose(val, float(want), **TOL)
    np.testing.assert_allclose(grad, np.asarray(want_g), **TOL)


def test_dice_loss_bf16_logits_give_bf16_gradient():
    logits, labels = _case(4)
    x = torch.from_numpy(logits).bfloat16().requires_grad_()
    losses.dice_loss(x, torch.from_numpy(labels)).backward()
    assert x.grad.dtype == torch.bfloat16
    _, want = _port_value_grad(losses.dice_loss, x.detach().float().numpy(), labels)
    np.testing.assert_allclose(x.grad.float().numpy(), want, atol=2e-2 * np.abs(want).max())


OPTIMIZERS = {
    "sgd": {"optimizer": "SGD", "lr": 0.05, "momentum": 0.9},
    "adam": {"optimizer": "Adam", "lr": 1e-2, "epsilon": 1e-6},
    "amsgrad": {"optimizer": "Adam", "lr": 1e-2, "amsgrad": True},
    "adabelief": {"optimizer": "AdaBelief", "lr": 1e-2, "epsilon": 1e-8},
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_updates_match_optax(name):
    cfg = OPTIMIZERS[name]
    rng = np.random.default_rng(5)
    params = {"a": rng.standard_normal((3, 4)).astype(np.float32),
              "b": rng.standard_normal((5,)).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(6)]
    lrs = [cfg["lr"]] * 3 + [cfg["lr"] * 0.5] * 3  # a schedule change midway

    tx = jo.make_optimizer(cfg)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = optim.make_optimizer(list(tp.values()), cfg)
    for g, lr in zip(grads, lrs):
        state = jo.set_learning_rate(state, lr)
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        optim.set_learning_rate(opt, lr)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
    for k in params:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), **TOL)


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="unsupported optimizer"):
        optim.make_optimizer([torch.nn.Parameter(torch.zeros(1))], {"optimizer": "Lion"})


@pytest.mark.parametrize("cfg", [
    {"scheduler": "Constant"},
    {"scheduler": "ReduceOnPlateau", "patience": 2, "factor": 0.3},
    {"scheduler": "Cosine", "T_0": 4},
    {"scheduler": "Cosine", "T_0": 3, "T_multi": 2},
], ids=["constant", "plateau", "cosine", "cosine_warm_restarts"])
def test_lr_scheduler_sequence_matches_jax(cfg):
    val_losses = [1.0, 0.9, 0.95, 0.97, 0.96, 0.8, 0.85, 0.86, 0.87, 0.88, 0.5, 0.6,
                  0.61, 0.62]
    port, ref = optim.LRScheduler(0.1, cfg), jo.LRScheduler(0.1, cfg)
    assert [port.step(v) for v in val_losses] == [ref.step(v) for v in val_losses]
