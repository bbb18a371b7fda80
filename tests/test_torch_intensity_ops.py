"""The port's intensity-augmentation ops against the JAX package's.

The JAX functions take one channel-first sample; the port's take a batch with
one parameter set per sample. Same numpy-seeded inputs and parameters through
both, per sample; limit 1e-4 * max|ref| (f32 arithmetic in another order: the
bias polynomial is evaluated separably, Gibbs is an FFT round trip instead of
per-axis circulant matrices). Even and odd extents for the k-space ops.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmantic_tpu.transforms import intensity_ops as jiops
from segmantic_tpu_torch.transforms import intensity_ops as tiops

SHAPES = [(2, 1, 8, 9, 10), (3, 2, 7, 8, 6), (2, 1, 12, 11)]  # (S, C, *spatial)


def _batch(seed, shape):
    rng = np.random.default_rng(seed)
    return rng, (rng.standard_normal(shape) * 3.0 + 1.0).astype(np.float32)


def _check(got: torch.Tensor, ref, x):
    ref = np.stack([np.asarray(r) for r in ref])
    assert got.shape == x.shape and got.dtype == torch.float32
    assert np.abs(got.numpy() - ref).max() <= 1e-4 * np.abs(ref).max()


@pytest.mark.parametrize("shape", SHAPES)
def test_adjust_contrast_matches_jax(shape):
    rng, x = _batch(0, shape)
    gamma = rng.uniform(0.5, 4.5, shape[0]).astype(np.float32)
    got = tiops.adjust_contrast(torch.from_numpy(x), gamma)
    _check(got, [jiops.adjust_contrast(jnp.asarray(x[i]), gamma[i])
                 for i in range(shape[0])], x)


@pytest.mark.parametrize("shape", SHAPES)
def test_histogram_shift_and_control_points_match_jax(shape):
    rng, x = _batch(1, shape)
    k = 10
    noise = rng.uniform(-0.45 / (k - 1), 0.45 / (k - 1), (shape[0], k)).astype(np.float32)
    xt = torch.from_numpy(x)
    dims = tuple(range(1, x.ndim))
    src, dst = tiops.random_control_points(noise, xt.amin(dims), xt.amax(dims))
    ref = []
    for i in range(shape[0]):
        # the JAX function with its uniform draw replaced by the same noise
        n = jnp.asarray(noise[i]).at[0].set(0.0).at[-1].set(0.0)
        s0 = jnp.linspace(0.0, 1.0, k)
        d0 = jnp.sort(s0 + n)
        mn, mx = jnp.min(x[i]), jnp.max(x[i])
        js, jd = s0 * (mx - mn) + mn, d0 * (mx - mn) + mn
        np.testing.assert_allclose(src[i].numpy(), np.asarray(js), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(dst[i].numpy(), np.asarray(jd), rtol=1e-6, atol=1e-6)
        ref.append(jiops.histogram_shift(jnp.asarray(x[i]), js, jd))
    got = tiops.histogram_shift(xt, src, dst)
    _check(got, ref, x)
    assert (np.diff(dst.numpy(), axis=1) >= 0).all()  # monotone, ends pinned
    np.testing.assert_allclose(dst[:, [0, -1]].numpy(), src[:, [0, -1]].numpy())


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("degree", [2, 3])
def test_bias_field_matches_jax(shape, degree):
    rng, x = _batch(2, shape)
    nd = len(shape) - 2
    n = tiops.num_bias_coeff(nd, degree)
    assert n == jiops.num_bias_coeff(nd, degree)
    coeff = rng.uniform(0.0, 0.1, (shape[0], n)).astype(np.float32)
    got = tiops.bias_field(torch.from_numpy(x), coeff, degree)
    _check(got, [jiops.bias_field(jnp.asarray(x[i]), jnp.asarray(coeff[i]), degree)
                 for i in range(shape[0])], x)
    field = tiops.polynomial_bias_field(shape[2:], torch.from_numpy(coeff), degree)
    want = np.stack([np.asarray(jiops.polynomial_bias_field(
        tuple(shape[2:]), jnp.asarray(coeff[i]), degree)) for i in range(shape[0])])
    np.testing.assert_allclose(field.numpy(), want, rtol=1e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_gibbs_noise_matches_jax(shape):
    rng, x = _batch(3, shape)
    alpha = rng.uniform(0.0, 1.0, shape[0]).astype(np.float32)
    alpha[0] = 0.0  # identity
    got = tiops.gibbs_noise(torch.from_numpy(x), alpha)
    _check(got, [jiops.gibbs_noise(jnp.asarray(x[i]), jnp.asarray(alpha[i]))
                 for i in range(shape[0])], x)
    assert np.abs(got[0].numpy() - x[0]).max() <= 1e-5 * np.abs(x).max()


@pytest.mark.parametrize("shape", SHAPES)
def test_kspace_spike_matches_jax(shape):
    rng, x = _batch(4, shape)
    nd = len(shape) - 2
    loc = rng.uniform(0.55, 0.95, (shape[0], nd)).astype(np.float32)
    inten = rng.uniform(0.95, 1.10, shape[0]).astype(np.float32)
    got = tiops.kspace_spike(torch.from_numpy(x), loc, inten)
    _check(got, [jiops.kspace_spike(jnp.asarray(x[i]), jnp.asarray(loc[i]),
                                    jnp.asarray(inten[i])) for i in range(shape[0])], x)


def test_ops_keep_bf16_and_compute_in_f32():
    """A bf16 batch comes back in bf16, within bf16 rounding of the f32 result."""
    rng, x = _batch(5, (2, 1, 8, 8, 8))
    xb = torch.from_numpy(x).to(torch.bfloat16)
    gamma = np.asarray([0.7, 2.0], np.float32)
    got = tiops.adjust_contrast(xb, gamma)
    want = tiops.adjust_contrast(xb.float(), gamma)
    assert got.dtype == torch.bfloat16
    assert (got.float() - want).abs().max() <= 2.0 ** -8 * want.abs().max()
    assert tiops.gibbs_noise(xb, np.asarray([0.3, 0.6], np.float32)).dtype == torch.bfloat16
