"""Fused stride-1 conv of the PyTorch port vs the Pallas kernel it replaces.

The plain version (what the wrapper runs for CPU tensors) is held against
``pallas_conv.conv3d_pallas`` in interpret mode and against its XLA
reference, in f32, at the batch-packed kernel's own test size
(B=4, C=16, 8^3). Tolerance: 1e-4 absolute + 1e-4 relative, from f32
summation order over 27*16 terms. The CUDA kernel itself is compared with
the plain version on the card in ``test_torch_kernels_cuda.py``.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmantic_tpu.ops import pallas_conv
from segmantic_tpu_torch.ops import fused_conv

B, S, C, CO = 4, 8, 16, 16


def _inputs(seed: int, with_norm: bool):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, S, S, C)).astype(np.float32)
    w = (0.1 * rng.standard_normal((3, 3, 3, C, CO))).astype(np.float32)
    bias = rng.standard_normal(CO).astype(np.float32)
    alpha = np.array([0.2], np.float32)
    scale = shift = None
    if with_norm:
        scale = (rng.random(CO) + 0.5).astype(np.float32)
        shift = rng.standard_normal(CO).astype(np.float32)
    return x, w, bias, scale, shift, alpha


def _torch(a):
    return None if a is None else torch.from_numpy(a)


def _jax(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("with_norm", [False, True])
@pytest.mark.parametrize("relu_mode", ["none", "relu", "prelu"])
def test_plain_matches_pallas_and_reference(relu_mode, with_norm):
    args = _inputs(3, with_norm)
    x, w, bias, scale, shift, alpha = args
    got = fused_conv.conv3d_plain(
        *map(_torch, (x, w, bias, scale, shift, alpha)), relu_mode=relu_mode
    ).numpy()
    jargs = dict(bias=_jax(bias), scale=_jax(scale), shift=_jax(shift),
                 alpha=_jax(alpha), relu_mode=relu_mode)
    pallas = np.asarray(pallas_conv.conv3d_pallas(
        jnp.asarray(x), jnp.asarray(w), interpret=True, **jargs))
    ref = np.asarray(pallas_conv.conv3d_reference(jnp.asarray(x), jnp.asarray(w), **jargs))
    np.testing.assert_allclose(got, pallas, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)


def test_wrapper_runs_plain_version_for_cpu_tensors():
    x, w, bias, scale, shift, alpha = map(_torch, _inputs(5, True))
    fused_conv.counter.reset()
    got = fused_conv.conv3d(x, w, bias, scale, shift, alpha, relu_mode="prelu")
    want = fused_conv.conv3d_plain(x, w, bias, scale, shift, alpha, relu_mode="prelu")
    assert torch.equal(got, want)
    assert fused_conv.counter.count == 0  # no kernel launched


def test_wrapper_checks_arguments():
    x, w, *_ = map(_torch, _inputs(6, False))
    with pytest.raises(ValueError, match="prelu"):
        fused_conv.conv3d(x, w, relu_mode="prelu")
    with pytest.raises(TypeError, match="dtype"):
        fused_conv.conv3d(x, w.double())
    with pytest.raises(ValueError, match="shape"):
        fused_conv.conv3d(x, w[..., :8, :])
    with pytest.raises(ValueError, match="relu_mode"):
        fused_conv.conv3d(x, w, relu_mode="gelu")
