"""Gradients of the port's conv kernels vs the Pallas kernels they replace.

The plain versions that a CPU tensor takes (and that the card's kernels are
held against in ``chip_smoke.py``) against the JAX package's Pallas kernels in
interpret mode, on numpy-seeded f32 inputs:

- ``fused_conv.conv3d_dw`` against ``pallas_conv.conv3d_packed_dw`` (shapes
  that ``pallas_conv.supported`` accepts: B*C >= 64, W % 8 == 0), and the
  ``conv3d_grad`` Function's dx and dw against ``jax.vjp`` of
  ``pallas_conv.conv3d_packed``;
- ``phase_conv.phase_conv_dw`` against ``phase_gemm.phase_conv_gemm_dw`` in
  its folded (L = 64, W % 16 == 0) and direct (L = 128) cases, and the
  ``phase_conv_grad`` Function against ``jax.vjp`` of ``phase_gemm.phase_conv``.

Tolerance 1e-4 absolute + 1e-4 relative: f32 sums of up to ~10^4 terms in
another order.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmantic_tpu.ops import pallas_conv, phase_gemm
from segmantic_tpu_torch.ops import fused_conv, phase_conv

TOL = dict(atol=1e-4, rtol=1e-4)


def _rand(rng, shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("x_shape,co", [((2, 4, 8, 8, 32), 16), ((4, 3, 6, 16, 16), 24)])
def test_conv3d_dw_plain_matches_pallas(x_shape, co):
    assert pallas_conv.supported(x_shape, co)
    rng = np.random.default_rng(0)
    x = _rand(rng, x_shape)
    dy = _rand(rng, x_shape[:4] + (co,))
    got = fused_conv.conv3d_dw(_t(x), _t(dy)).numpy()
    want = np.asarray(pallas_conv.conv3d_packed_dw(jnp.asarray(x), jnp.asarray(dy),
                                                   interpret=True))
    assert got.shape == want.shape == (3, 3, 3, x_shape[-1], co)
    np.testing.assert_allclose(got, want, **TOL)


def test_conv3d_grad_matches_pallas_vjp():
    rng = np.random.default_rng(1)
    x = _rand(rng, (2, 4, 8, 8, 32))
    w = _rand(rng, (3, 3, 3, 32, 16), 0.05)
    dy = _rand(rng, (2, 4, 8, 8, 16))
    y_ref, vjp = jax.vjp(lambda a, b: pallas_conv.conv3d_packed(a, b, True),
                         jnp.asarray(x), jnp.asarray(w))
    dx_ref, dw_ref = vjp(jnp.asarray(dy))
    xt, wt = _t(x).requires_grad_(), _t(w).requires_grad_()
    y = fused_conv.conv3d_grad(xt, wt)
    y.backward(_t(dy))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_ref), **TOL)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(dw_ref), **TOL)


@pytest.mark.parametrize("p_shape", [(1, 2, 4, 16, 64), (1, 3, 4, 8, 128)],
                         ids=["folded_L64", "direct_L128"])
def test_phase_conv_dw_plain_matches_pallas(p_shape):
    assert phase_gemm._fold_ok(p_shape) == (p_shape[-1] == 64)
    rng = np.random.default_rng(2)
    c = p_shape[-1] // 8
    p = _rand(rng, p_shape)
    g = _rand(rng, p_shape)
    w = _rand(rng, (3, 3, 3, c, c), 0.1)
    got = phase_conv.phase_conv_dw(_t(p), _t(g)).numpy()
    want = np.asarray(phase_gemm.phase_conv_gemm_dw(
        jnp.asarray(p), jnp.asarray(g), jnp.asarray(w), interpret=True))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("p_shape", [(1, 2, 4, 16, 64), (1, 3, 4, 8, 128)],
                         ids=["folded_L64", "direct_L128"])
def test_phase_conv_grad_matches_pallas_vjp(p_shape):
    rng = np.random.default_rng(3)
    c = p_shape[-1] // 8
    p = _rand(rng, p_shape)
    w = _rand(rng, (3, 3, 3, c, c), 0.1)
    g = _rand(rng, p_shape)
    y_ref, vjp = jax.vjp(lambda a, b: phase_gemm.phase_conv(a, b, True),
                         jnp.asarray(p), jnp.asarray(w))
    dp_ref, dw_ref = vjp(jnp.asarray(g))
    pt, wt = _t(p).requires_grad_(), _t(w).requires_grad_()
    y = phase_conv.phase_conv_grad(pt, wt)
    y.backward(_t(g))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref), **TOL)
    np.testing.assert_allclose(pt.grad.numpy(), np.asarray(dp_ref), **TOL)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(dw_ref), **TOL)


def test_dw_wrappers_take_plain_versions_for_cpu_tensors_and_check_args():
    rng = np.random.default_rng(4)
    x, dy = _t(_rand(rng, (1, 3, 3, 3, 2))), _t(_rand(rng, (1, 3, 3, 3, 4)))
    fused_conv.dw_counter.reset()
    phase_conv.dw_counter.reset()
    assert torch.equal(fused_conv.conv3d_dw(x, dy), fused_conv.conv3d_dw_plain(x, dy))
    p, g = _t(_rand(rng, (1, 2, 2, 2, 16))), _t(_rand(rng, (1, 2, 2, 2, 24)))
    assert phase_conv.phase_conv_dw(p, g).shape == (3, 3, 3, 2, 3)
    assert fused_conv.dw_counter.count == 0 and phase_conv.dw_counter.count == 0
    with pytest.raises(TypeError, match="dtype"):
        fused_conv.conv3d_dw(x, dy.double())
    with pytest.raises(ValueError, match="different grids"):
        fused_conv.conv3d_dw(x, dy[:, :2])
    with pytest.raises(ValueError, match="8\\*C"):
        phase_conv.phase_conv_dw(p[..., :12], g)
