"""The port's lane-packed UNETR trained against the JAX package's: every
parameter gradient of the phase Dice in f64 (JAX under ``jax.enable_x64``),
1e-3 * max|g| of each tensor, and one ``make_train_step`` step (f32, SGD
with momentum, flips off) against the JAX trainer's, the loss through
``dice_loss_phase`` and the updated parameters. The model, the inputs and
the helpers are ``test_torch_unetr_pack.py``'s.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from segmantic_tpu.ops import fast_conv as jfc
from segmantic_tpu.train import augment as jaug
from segmantic_tpu.train import losses as jl
from segmantic_tpu.train import optim as jo
from segmantic_tpu.train import trainer as jtrainer
from segmantic_tpu_torch.models.unet import to_flax_variables
from segmantic_tpu_torch.train import optim, trainer
from segmantic_tpu_torch.train.augment import AugmentConfig
from tests.test_torch_unet_train import TOL, _assert_grads_close, _flat
from tests.test_torch_unetr_pack import SIZE, _bridge, _port_grads, case, packed_jax  # noqa: F401


def test_packed_gradients_match_jax_f64(case, packed_jax):
    """Every parameter gradient of the phase Dice on the phase logits (the
    trainer's loss of a packed UNETR) in f64."""
    module, variables, x, labels = case
    with jax.enable_x64(True):
        params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                        variables["params"])
        yp = jfc.space_to_depth(jnp.asarray(labels[..., None]))

        def loss_fn(p):
            out = module.apply({"params": p}, jnp.asarray(x, jnp.float64), training=True,
                               phase_logits=True)
            return jl.dice_loss_phase(out, yp)

        want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
        want_grads = jax.tree_util.tree_map(np.asarray, want_grads)
    loss, grads = _port_grads(variables, x, labels)
    np.testing.assert_allclose(loss, float(want_loss), **TOL)
    _assert_grads_close(grads["params"], want_grads)


def test_train_step_through_the_phase_dice_matches_jax(case, packed_jax, monkeypatch):
    """One step of each trainer (f32, SGD 0.1 with momentum 0.9, no flips):
    the port's loss goes through ``dice_loss_phase`` (the JAX trainer's
    ``use_phase_logits``), and the loss and the updated parameters match."""
    module, variables, x, labels = case
    opt_cfg = {"optimizer": "SGD", "lr": 0.1, "momentum": 0.9}
    tx = jo.make_optimizer(opt_cfg)
    jstep = jtrainer.make_train_step(module, tx, jaug.AugmentConfig(flip_prob=0.0), SIZE,
                                     mixed_precision=False)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    new_params, _, _, want_loss = jstep(
        params, {}, tx.init(params), jnp.asarray(x), jnp.asarray(labels.astype(np.uint8)),
        jax.random.key(0))

    calls = []
    real = trainer.dice_loss_phase
    monkeypatch.setattr(trainer, "dice_loss_phase",
                        lambda *a, **k: calls.append(a[0].shape) or real(*a, **k))
    model = _bridge(variables).train().requires_grad_(True)
    opt = optim.make_optimizer(model.parameters(), opt_cfg)
    step = trainer.make_train_step(model, opt, AugmentConfig(flip_prob=0.0), SIZE,
                                   mixed_precision=False)
    loss = step(torch.from_numpy(x), torch.from_numpy(labels.astype(np.uint8)))
    assert calls == [(2, 16, 16, 16, 24)]
    np.testing.assert_allclose(loss.item(), float(want_loss), **TOL)
    got = dict(_flat(to_flax_variables(model.state_dict())["params"]))
    for key, leaf in _flat(jax.tree_util.tree_map(np.asarray, new_params)):
        np.testing.assert_allclose(got[key], leaf, atol=2e-4, rtol=1e-3,
                                   err_msg="/".join(key))
