"""2D training through the port against the JAX package, on the CPU.

- ``dice_loss_phase`` at 4 phases (a 2D UNet's phase logits) against the
  JAX ``dice_loss_phase``, loss and gradient within 1e-5 relative, and
  against the full-resolution ``dice_loss`` in f64 within 1e-12; the Dice
  sums kernel's plan at the 2D flagship's phase grid (a voxel's class lanes
  stay C, whatever the phase count) and its traversal emulated at 4 phases.
- The 2D augmentation by injected ``AugmentParams`` against the JAX
  package's pieces replayed with the same parameters (the helpers of
  ``tests/test_torch_augment.py``): images within 1e-4 * max|ref|, labels
  exactly; the 2D rotation is one group of three shear passes, the unit
  ``fused_shear.shear_group`` (kernel 8 on the card) takes.
- One 2D ``make_train_step`` step (f32, flips off, SGD) against the JAX step,
  and a step with dropout refused, as the JAX step cannot run it.

``train()`` in 2D end to end is ``tests/test_torch_2d_e2e.py``.
"""

from __future__ import annotations

import dataclasses

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
from segmantic_tpu_torch.ops import fast_conv, fused_shear, phase_dice
from segmantic_tpu_torch.ops.shear_resample import chain_plan
from segmantic_tpu_torch.train import augment as taug
from segmantic_tpu_torch.train import losses, optim, trainer
from segmantic_tpu_torch.train.augment import AugmentConfig
from tests.test_torch_2d_models import UNET, _flat, bridge, flax_variables_2d
from tests.test_torch_augment import _batch, _dense, _jax_replay
from tests.test_torch_dice_plan import sums_traversal_plain

TOL = dict(atol=1e-4, rtol=1e-3)


def _phase_inputs(seed, shape=(2, 8, 10), classes=3):
    """Full-resolution 2D logits and labels and their 4-phase views."""
    rng = np.random.default_rng(seed)
    logits = (2.0 * rng.standard_normal(shape + (classes,))).astype(np.float32)
    labels = rng.integers(0, classes, shape).astype(np.uint8)
    xp = fast_conv.space_to_depth(torch.from_numpy(logits)).numpy()
    yp = fast_conv.space_to_depth(torch.from_numpy(labels[..., None])).numpy()
    return logits, labels, xp, yp


@pytest.mark.parametrize("include_background", [True, False])
def test_dice_loss_phase_at_4_phases_matches_jax(include_background):
    _, _, xp, yp = _phase_inputs(0)
    assert xp.shape == (2, 4, 5, 12) and yp.shape == (2, 4, 5, 4)
    np.testing.assert_array_equal(
        yp, np.asarray(jfc.space_to_depth(jnp.asarray(_phase_inputs(0)[1][..., None]))))

    def jax_loss(x):
        return jl.dice_loss_phase(x, jnp.asarray(yp), include_background=include_background)

    want_l, want_g = jax.value_and_grad(jax_loss)(jnp.asarray(xp))
    tx = torch.from_numpy(xp).requires_grad_()
    loss = losses.dice_loss_phase(tx, torch.from_numpy(yp),
                                  include_background=include_background)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_l), rtol=1e-5)
    want_g = np.asarray(want_g)
    assert np.abs(tx.grad.numpy() - want_g).max() <= 1e-5 * np.abs(want_g).max()


def test_dice_loss_phase_at_4_phases_is_the_full_resolution_dice():
    logits, labels, xp, yp = _phase_inputs(1)
    a = torch.from_numpy(xp).double().requires_grad_()
    b = torch.from_numpy(logits).double().requires_grad_()
    la = losses.dice_loss_phase(a, torch.from_numpy(yp))
    lb = losses.dice_loss(b, torch.from_numpy(labels))
    (la + lb).backward()
    np.testing.assert_allclose(la.item(), lb.item(), rtol=1e-12)
    np.testing.assert_allclose(fast_conv.depth_to_space(a.grad, 3).numpy(), b.grad.numpy(),
                               atol=1e-12)


def test_dice_sums_plan_and_traversal_at_4_phases():
    """One thread owns one fine voxel and its C class lanes, so 4 phases of 8
    classes keep 8 lanes in registers (the limit is MAX_CLASSES = 32 a
    voxel, not P * C); the 2D flagship's grid (16 x 128^2 coarse voxels of 4
    phases) gets a one-wave plan, and the emulated traversal of a small 2D
    phase tensor equals the plain sums."""
    assert phase_dice.lanes_padded(8) == 8 <= phase_dice.MAX_CLASSES
    nvox = 128 * 128 * 4
    plan = phase_dice.sums_plan(16, nvox, 8, 132)
    assert plan.unroll == 4 and plan.voxels_per_block % (phase_dice.THREADS * 4) == 0
    assert (plan.blocks - 1) * plan.voxels_per_block < nvox <= plan.blocks * plan.voxels_per_block
    assert plan.blocks * 16 <= 3 * 132
    _, _, xp, yp = _phase_inputs(2, (3, 18, 22), 8)
    xp, yp = torch.from_numpy(xp), torch.from_numpy(yp)
    small = phase_dice.sums_plan(3, 9 * 11 * 4, 8, 2)
    got = sums_traversal_plain(xp, yp, small)
    want = phase_dice.dice_phase_sums_plain(xp, yp)
    for g, w in zip(got, want):
        assert (g - w).abs().max() <= 1e-5 * w.abs().max()
    assert torch.equal(got[2], want[2])


FULL = AugmentConfig(spatial=True, intensity=True, interp_bf16=False)


@pytest.mark.parametrize("cfg,seed", [
    (_dense(FULL), 0),
    (FULL, 1),  # the default probabilities
    (dataclasses.replace(_dense(FULL), spatial_subset=False), 2),
    (AugmentConfig(spatial=True, interp_bf16=False), 3),
    (_dense(AugmentConfig(intensity=True)), 4),
    (dataclasses.replace(_dense(FULL), interp_bf16=True), 5),
], ids=["dense", "defaults", "independent-gates", "spatial-only", "intensity-only",
        "bf16-interp"])
def test_2d_augmentation_matches_jax_replay(cfg, seed):
    margin = (24, 24) if cfg.spatial else (16, 16)
    images, labels = _batch(seed, 8, margin, 1)
    params = taug.draw_params(torch.Generator().manual_seed(seed), cfg, 8, 2)
    assert params.flips.shape == (8, 2)
    if cfg.spatial:
        assert params.angles.shape[1] == 1  # one rotation angle in 2D
    if cfg.intensity:
        assert params.spike_loc.shape[1] == 2
    got_i, got_l = taug.apply_params(torch.from_numpy(images), torch.from_numpy(labels),
                                     params, cfg, (16, 16))
    want_i, want_l = _jax_replay(images, labels, params, cfg, (16, 16))
    assert got_i.shape == want_i.shape == (8, 16, 16, 1)
    np.testing.assert_array_equal(got_l.numpy(), want_l)
    tol = 1e-2 if cfg.interp_bf16 else 1e-4
    assert np.abs(got_i.numpy() - want_i).max() <= tol * np.abs(want_i).max()


def test_2d_rotation_is_one_shear_group_of_three_passes():
    """The 2D chain with its zoom folded in is one rotation group: exactly
    what ``fused_shear.shear_group`` takes, and its launch plan accepts the
    plane as a 3D frame with a unit third axis."""
    passes, _, extents, groups = chain_plan((24, 24), 1, (16, 16), 0.4, 0.8)
    assert len(passes) == 3 and len(groups) == 1
    a_axis, b_axis, specs = groups[0]
    assert (a_axis, b_axis) == (0, 1) and len(specs) == 3
    for dtype in (torch.bfloat16, torch.float32, torch.uint8):
        plan = fused_shear.group_plan((24, 24, 1), a_axis, b_axis, tuple(map(tuple, specs)),
                                      dtype, 8, True, 132)
        assert plan.out_dims[2] == 1 and plan.smem_bytes > 0 and plan.grid > 0


@pytest.mark.parametrize("full,out,dtype,global_plane", [
    ((144, 144, 144), (96, 96, 96), torch.bfloat16, False),  # the 3D flagship's margin patch
    ((144, 144, 144), (96, 96, 96), torch.float32, False),
    ((144, 144, 144), (96, 96, 96), torch.uint8, False),
    ((384, 384), (256, 256), torch.bfloat16, True),  # the 2D flagship's image: 297 KB
    ((384, 384), (256, 256), torch.float32, True),
    ((384, 384), (256, 256), torch.uint8, False),  # its labels: 148 KB
    ((24, 24), (16, 16), torch.bfloat16, False),
])
def test_the_kernel_plans_every_group_of_the_flagship_chains(full, out, dtype, global_plane):
    """``group_plan`` takes every group of both flagship chains: a plane that
    fits a block's shared memory (227 KB on sm_90) is held there, a larger one
    in global scratch, one plane a block; shared memory holds the rest."""
    n_rot = 1 if len(full) == 2 else 3
    _, _, _, groups = chain_plan(full, n_rot, out, 0.4, 0.8)
    dims = tuple(full) + (1,) * (3 - len(full))
    for a_axis, b_axis, specs in groups:
        p = fused_shear.group_plan(dims, a_axis, b_axis, tuple(map(tuple, specs)), dtype, 16)
        assert p.global_plane is global_plane
        assert p.smem_bytes <= fused_shear._SMEM_LIMIT
        if global_plane:
            assert (p.wc, p.cp) == (1, 1) and p.global_bytes == \
                p.grid * p.passes[0] * p.row_units * dtype.itemsize
        else:
            assert p.global_bytes == 0
        dims = p.out_dims


def test_2d_train_step_matches_jax_step():
    module = FlaxUNet(**UNET)
    variables = flax_variables_2d(module, seed=31)
    rng = np.random.default_rng(32)
    x = rng.standard_normal((4, 16, 16, 1)).astype(np.float32)
    labels = rng.integers(0, 3, (4, 16, 16)).astype(np.uint8)
    opt_cfg = {"optimizer": "SGD", "lr": 0.1, "momentum": 0.9}
    tx = jo.make_optimizer(opt_cfg)
    jstep = jtrainer.make_train_step(module, tx, jaug.AugmentConfig(flip_prob=0.0), (16, 16),
                                     mixed_precision=False)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    stats = jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"])
    new_params, new_stats, _, want_loss = jstep(params, stats, tx.init(params),
                                                jnp.asarray(x), jnp.asarray(labels),
                                                jax.random.key(0))

    model = bridge(UNet, variables, **UNET).train().requires_grad_(True)
    opt = optim.make_optimizer(model.parameters(), opt_cfg)
    step = trainer.make_train_step(model, opt, AugmentConfig(flip_prob=0.0), (16, 16),
                                   mixed_precision=False)
    loss = step(torch.from_numpy(x), torch.from_numpy(labels))
    np.testing.assert_allclose(loss.item(), float(want_loss), **TOL)
    got = dict(_flat(to_flax_variables(model.state_dict())))
    want = {"params": new_params, "batch_stats": new_stats}
    for key, leaf in _flat(jax.tree_util.tree_map(np.asarray, want)):
        np.testing.assert_allclose(got[key], leaf, atol=2e-4, rtol=1e-3, err_msg="/".join(key))


def test_a_train_step_with_dropout_raises_as_the_jax_step_cannot_run_it():
    model = UNet(**dict(UNET, dropout=0.1))
    opt = optim.make_optimizer(model.parameters(), {"optimizer": "SGD", "lr": 0.1})
    step = trainer.make_train_step(model, opt, AugmentConfig(), (16, 16), mixed_precision=False)
    with pytest.raises(NotImplementedError, match="JAX trainer refuses it"):
        step(torch.zeros((2, 16, 16, 1)), torch.zeros((2, 16, 16), dtype=torch.uint8))
