"""Phase-space conv of the PyTorch port vs the Pallas kernels it replaces.

The plain version is held against ``phase_gemm.phase_conv_gemm`` in
interpret mode in both of its cases (the W-parity-folded kernel, L=64 with
W % 16 == 0, and the direct kernel, L=128) and against
``fast_conv.phase_conv_s1`` (the XLA path), in f32. The phase identities the
executor builds on (channel order, subpixel conv-transpose, kernel expansion,
XLA-SAME strided convs) are pinned against the JAX functions directly.
Tolerances: f32 summation order, 1e-4 absolute + relative unless stated.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmantic_tpu.ops import fast_conv as jfc
from segmantic_tpu.ops import phase_gemm
from segmantic_tpu_torch.ops import fast_conv, fused_conv, phase_conv


def _rand(rng, shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("p_shape", [(1, 4, 4, 16, 64), (1, 4, 4, 8, 128)],
                         ids=["folded_L64", "direct_L128"])
def test_plain_matches_pallas_phase_gemm(p_shape):
    rng = np.random.default_rng(1)
    c = p_shape[-1] // 8
    p = _rand(rng, p_shape)
    w = _rand(rng, (3, 3, 3, c, c), 0.1)
    assert phase_gemm._fold_ok(p_shape) == (p_shape[-1] == 64)
    got = phase_conv.phase_conv_plain(torch.from_numpy(p), torch.from_numpy(w)).numpy()
    pallas = np.asarray(phase_gemm.phase_conv_gemm(jnp.asarray(p), jnp.asarray(w),
                                                   interpret=True))
    xla = np.asarray(jfc.phase_conv_s1(jnp.asarray(p), jnp.asarray(w)))
    np.testing.assert_allclose(got, pallas, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got, xla, atol=1e-4, rtol=1e-4)


def test_phase_conv_is_conv_of_the_upsampled_volume():
    """d2s(phase_conv(p, w)) == conv3_SAME(d2s(p), w) with the epilogue."""
    rng = np.random.default_rng(2)
    p = torch.from_numpy(_rand(rng, (2, 3, 4, 5, 24)))
    w = torch.from_numpy(_rand(rng, (3, 3, 3, 3, 5), 0.2))
    bias, scale, shift = (torch.from_numpy(_rand(rng, (5,))) for _ in range(3))
    alpha = torch.tensor([0.3])
    got = phase_conv.phase_conv(p, w, bias, scale, shift, alpha, relu_mode="prelu")
    want = fused_conv.conv3d_plain(fast_conv.depth_to_space(p, 3), w, bias, scale,
                                   shift, alpha, relu_mode="prelu")
    np.testing.assert_allclose(fast_conv.depth_to_space(got, 5).numpy(), want.numpy(),
                               atol=1e-5, rtol=1e-5)


def test_phase_major_channel_order():
    """Channel (pz, py, px, c), c fastest: full-res voxel (2d+pz, 2h+py,
    2w+px) lands at channel ((pz*2+py)*2+px)*C + c -- same as the JAX pair."""
    rng = np.random.default_rng(3)
    x = _rand(rng, (2, 4, 6, 8, 3))
    p = fast_conv.space_to_depth(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(p, np.asarray(jfc.space_to_depth(jnp.asarray(x))))
    for pz, py, px, c in [(0, 0, 0, 0), (1, 0, 1, 2), (0, 1, 1, 1), (1, 1, 1, 2)]:
        ch = ((pz * 2 + py) * 2 + px) * 3 + c
        np.testing.assert_array_equal(p[:, 1, 2, 3, ch], x[:, 2 + pz, 4 + py, 6 + px, c])
    back = fast_conv.depth_to_space(torch.from_numpy(p), 3).numpy()
    np.testing.assert_array_equal(back, x)
    v = torch.arange(3.0)
    np.testing.assert_array_equal(fast_conv.tile_phase(v).numpy(),
                                  np.asarray(jfc.tile_phase(jnp.arange(3.0), 3)))


def test_subpixel_phase_conv_and_kernel_expansion_match_jax():
    rng = np.random.default_rng(4)
    x = _rand(rng, (2, 5, 4, 6, 6))
    w = _rand(rng, (3, 3, 3, 6, 4), 0.2)
    got = fast_conv.subpixel_phase_conv(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    want = np.asarray(jfc.subpixel_phase_conv(jnp.asarray(x), jnp.asarray(w)))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(
        fast_conv.expand_s1_kernel(torch.from_numpy(w)).numpy(),
        np.asarray(jfc.expand_s1_kernel(jnp.asarray(w))),
    )


@pytest.mark.parametrize("size", [(8, 8, 8), (7, 6, 5)])
def test_strided_same_conv_and_transpose_match_lax(size):
    """XLA-SAME stride-2 conv (pads (0,1) on even sizes) and the flax SAME
    conv-transpose (no kernel flip), each against lax directly."""
    rng = np.random.default_rng(5)
    x = _rand(rng, (2,) + size + (3,))
    w = _rand(rng, (3, 3, 3, 3, 4), 0.3)
    dn = ("NDHWC", "DHWIO", "NDHWC")
    got = fast_conv.conv3d_same(torch.from_numpy(x), torch.from_numpy(w), stride=2).numpy()
    want = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (2, 2, 2), "SAME", dimension_numbers=dn))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    got_t = fast_conv.conv_transpose3d_same(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    want_t = np.asarray(jax.lax.conv_transpose(
        jnp.asarray(x), jnp.asarray(w), (2, 2, 2), "SAME", dimension_numbers=dn))
    np.testing.assert_allclose(got_t, want_t, atol=1e-5, rtol=1e-5)


def test_wrapper_runs_plain_version_for_cpu_tensors():
    rng = np.random.default_rng(6)
    p = torch.from_numpy(_rand(rng, (1, 3, 3, 3, 16)))
    w = torch.from_numpy(_rand(rng, (3, 3, 3, 2, 2)))
    phase_conv.counter.reset()
    assert torch.equal(phase_conv.phase_conv(p, w), phase_conv.phase_conv_plain(p, w))
    assert phase_conv.counter.count == 0
    with pytest.raises(ValueError, match="8\\*C"):
        phase_conv.phase_conv(p[..., :12], w)
