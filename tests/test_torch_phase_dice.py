"""The port's phase-major Dice sweeps against the JAX package's.

``ops/phase_dice.py``'s plain versions (what a CPU tensor gets; the card's
kernels are held against them in ``tests/test_torch_kernels_cuda.py``) against
the Pallas kernels of ``exp/pallas_dice_ab.py`` in interpret mode (the file is
loaded by path and left as it is) and against
``segmantic_tpu.train.losses._dice_phase_fwd`` / ``_dice_phase_bwd``; the
``autograd.Function`` behind ``dice_loss_phase`` against
``jax.value_and_grad`` of the JAX loss. Inputs from numpy seeds. Limits: f32
1e-5 relative (sums over ~10^3 voxels in another order). For bf16 logits the
port computes in f32 and rounds once: its gradient is held within one bf16
rounding (2^-8 * max|ref|) of the JAX f32 gradient at the same bf16-rounded
logits, and within 4e-2 * max|ref| of the JAX bf16 gradient, whose backward
stores four full-volume intermediates in bf16 (probabilities, their
cotangents, the products and the inner sums: up to 2^-8 each).
"""

from __future__ import annotations

import importlib.util
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmantic_tpu.train import losses as jlosses
from segmantic_tpu_torch.ops import phase_dice
from segmantic_tpu_torch.train import losses as tlosses

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def pallas_dice():
    """``exp/pallas_dice_ab.py`` as a module; its import-time edits of the
    environment and of ``sys.path`` are undone."""
    env, path = dict(os.environ), list(sys.path)
    spec = importlib.util.spec_from_file_location("pallas_dice_ab",
                                                  REPO / "exp" / "pallas_dice_ab.py")
    module = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(module)
    finally:
        os.environ.clear()
        os.environ.update(env)
        sys.path[:] = path
    return module


def _inputs(seed, shape=(2, 8, 8, 8), n_phase=8, classes=4):
    rng = np.random.default_rng(seed)
    xp = (rng.standard_normal(shape + (n_phase * classes,)) * 2.0).astype(np.float32)
    yp = rng.integers(0, classes, shape + (n_phase,)).astype(np.uint8)
    return xp, yp


def _close(got, want, rtol=1e-5):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("classes", [4, 8, 16])
def test_sums_plain_match_pallas_interpret(pallas_dice, classes):
    xp, yp = _inputs(0, classes=classes)
    assert pallas_dice.eligible(xp.shape, yp.shape)
    want = pallas_dice.dice_phase_sums(jnp.asarray(xp), jnp.asarray(yp), interpret=True)
    got = phase_dice.dice_phase_sums(torch.from_numpy(xp), torch.from_numpy(yp))
    for g, w in zip(got, want):
        assert g.shape == (2, classes) and g.dtype == torch.float32
        _close(g, w)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))  # counts: whole numbers


@pytest.mark.parametrize("classes", [4, 8, 16])
def test_dx_plain_matches_pallas_interpret(pallas_dice, classes):
    xp, yp = _inputs(1, classes=classes)
    rng = np.random.default_rng(2)
    hot = rng.standard_normal((2, 8 * classes)).astype(np.float32)
    cold = rng.standard_normal((2, 8 * classes)).astype(np.float32)
    want = pallas_dice.dice_phase_dx(jnp.asarray(xp), jnp.asarray(yp), jnp.asarray(hot),
                                     jnp.asarray(cold), interpret=True)
    got = phase_dice.dice_phase_dx(torch.from_numpy(xp), torch.from_numpy(yp),
                                   torch.from_numpy(hot), torch.from_numpy(cold))
    assert got.shape == xp.shape and got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("shape,n_phase,classes", [
    ((2, 8, 8, 8), 8, 4), ((3, 5, 6, 7), 8, 5), ((2, 9, 10), 4, 3),
])
def test_sums_plain_match_jax_forward(shape, n_phase, classes):
    """Any voxel count, any class count, 2D phases: the shapes the Pallas
    experiment gated out, against the JAX production forward's residuals."""
    xp, yp = _inputs(3, shape, n_phase, classes)
    _, (_, _, _, inter, denom) = jlosses._dice_phase_fwd(
        jnp.asarray(xp), jnp.asarray(yp), True, 1e-5, 1e-5)
    got_i, got_p, got_c = phase_dice.dice_phase_sums_plain(torch.from_numpy(xp),
                                                           torch.from_numpy(yp))
    _close(got_i, inter)
    _close(got_p + got_c, denom)
    want_c = np.stack([np.bincount(yp[b].ravel(), minlength=classes)
                       for b in range(shape[0])])
    np.testing.assert_array_equal(got_c.numpy(), want_c)


@pytest.mark.parametrize("include_background", [True, False])
def test_dx_plain_matches_jax_backward(include_background):
    """hot / cold built as the port's backward builds them, the sweep against
    ``_dice_phase_bwd`` on the JAX forward's residuals."""
    xp, yp = _inputs(4, (2, 6, 6, 6), 8, 5)
    args = (include_background, 1e-5, 1e-5)
    _, res = jlosses._dice_phase_fwd(jnp.asarray(xp), jnp.asarray(yp), *args)
    want, _ = jlosses._dice_phase_bwd(*args, res, jnp.float32(0.7))
    inter, denom = (torch.from_numpy(np.array(r)) for r in res[3:])
    d_inter, d_denom = tlosses._dice_cotangents(torch.tensor(0.7), inter, denom, *args)
    got = phase_dice.dice_phase_dx_plain(torch.from_numpy(xp), torch.from_numpy(yp),
                                         (d_inter + d_denom).repeat(1, 8),
                                         d_denom.repeat(1, 8))
    _close(got, want)


@pytest.mark.parametrize("include_background", [True, False])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 4e-2)])
def test_loss_and_gradient_match_jax_value_and_grad(dtype, tol, include_background):
    xp, yp = _inputs(5, (2, 6, 6, 6), 8, 4)
    jx = jnp.asarray(xp).astype(dtype)

    def jax_loss(x):
        return jlosses.dice_loss_phase(x, jnp.asarray(yp),
                                       include_background=include_background)

    want_l, want_g = jax.value_and_grad(jax_loss)(jx)
    tx = torch.from_numpy(xp).to(getattr(torch, dtype)).requires_grad_()
    loss = tlosses.dice_loss_phase(tx, torch.from_numpy(yp),
                                   include_background=include_background)
    loss.backward()
    assert loss.dtype == torch.float32 and tx.grad.dtype == tx.dtype
    np.testing.assert_allclose(loss.item(), float(want_l), rtol=1e-5)
    want_g = np.asarray(want_g.astype(jnp.float32))
    assert np.abs(tx.grad.float().numpy() - want_g).max() <= tol * np.abs(want_g).max()
    if dtype == "bfloat16":  # one rounding away from the f32 gradient at the same logits
        exact = np.asarray(jax.grad(jax_loss)(jx.astype(jnp.float32)))
        assert (np.abs(tx.grad.float().numpy() - exact).max()
                <= 2.0 ** -8 * np.abs(exact).max())
    if not include_background:  # class 0's lanes still get the softmax's share
        assert tx.grad.float().abs().reshape(-1, 4)[:, 0].max() > 0


def test_phase_function_equals_the_full_resolution_dice():
    """Dice sums are invariant to permuting voxels: the phase Function on
    (B, *S/2, P * C) equals ``dice_loss`` on the (B, *S/2, P, C) view, loss and
    gradient, in f64 to 1e-12."""
    xp, yp = _inputs(6, (2, 4, 5, 6), 8, 3)
    a = torch.from_numpy(xp).double().requires_grad_()
    b = torch.from_numpy(xp).double().requires_grad_()
    la = tlosses.dice_loss_phase(a, torch.from_numpy(yp))
    lb = tlosses.dice_loss(b.reshape(2, 4, 5, 6, 8, 3), torch.from_numpy(yp))
    la.backward()
    lb.backward()
    assert la.dtype == torch.float64
    np.testing.assert_allclose(la.item(), lb.item(), rtol=1e-12)
    np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), atol=1e-12)


def test_one_hot_labels_and_presoftmaxed_inputs_take_autograd():
    xp, yp = _inputs(7, (1, 4, 4, 4), 8, 3)
    onehot = torch.nn.functional.one_hot(torch.from_numpy(yp).long(), 3).float()
    x = torch.from_numpy(xp)
    want = tlosses.dice_loss_phase(x, torch.from_numpy(yp))
    got = tlosses.dice_loss(x.reshape(1, 4, 4, 4, 8, 3), onehot)
    np.testing.assert_allclose(got.item(), want.item(), rtol=1e-6)
    probs = torch.softmax(x.reshape(1, 4, 4, 4, 8, 3), -1).reshape(x.shape)
    pre = tlosses.dice_loss_phase(probs, torch.from_numpy(yp), apply_softmax=False)
    np.testing.assert_allclose(pre.item(), want.item(), rtol=1e-6)


def test_shapes_and_label_types_are_checked():
    xp, yp = _inputs(8, (1, 4, 4, 4), 8, 3)
    with pytest.raises(ValueError, match="same voxels"):
        phase_dice.dice_phase_sums(torch.from_numpy(xp), torch.from_numpy(yp[:, :3]))
    with pytest.raises(TypeError, match="integer"):
        phase_dice.dice_phase_sums(torch.from_numpy(xp), torch.from_numpy(yp).float())
