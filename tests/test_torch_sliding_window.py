"""Sliding-window inference of the PyTorch port vs the JAX CPU path.

Both run the same deterministic predictor (an elementwise map of the window,
written once in each framework) over the same volume: the window grid, the
Gaussian importance, the short-tail padding, the padding of volumes smaller
than the roi and the blend must agree. Tolerance 1e-5 relative: the blend is
the same f32 arithmetic in the same window order.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmantic_tpu.infer import sliding_window as jsw
from segmantic_tpu_torch.infer import sliding_window as sw
from segmantic_tpu_torch.ops import blend


def _jax_predictor(w):
    w = w.astype(jnp.float32)
    return jnp.concatenate([w, 2.0 * w + 1.0, -w * w], axis=-1)


def _torch_predictor(w):
    w = w.float()
    return torch.cat([w, 2.0 * w + 1.0, -w * w], dim=-1)


@pytest.mark.parametrize("shape,roi,sw_batch,overlap", [
    ((23, 20, 18), (8, 8, 8), 3, 0.25),  # short tail chunk
    ((6, 20, 11), (8, 8, 8), 4, 0.5),  # axis 0 smaller than the roi: padded
    ((16, 16, 16), (16, 16, 16), 2, 0.25),  # one window
])
def test_matches_jax_cpu_path(shape, roi, sw_batch, overlap):
    vol = np.random.default_rng(0).standard_normal(shape + (1,)).astype(np.float32)
    want = np.asarray(jsw.sliding_window_inference(
        vol, roi, sw_batch, _jax_predictor, overlap=overlap))
    blend.counter.reset()
    got = sw.sliding_window_inference(vol, roi, sw_batch, _torch_predictor,
                                      overlap=overlap, device="cpu")
    assert got.shape == shape + (3,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    assert blend.counter.count == 0  # CPU tensors: the plain blend


def test_grid_and_importance_match_jax():
    for size, roi, ov in [((100, 64, 37), (32, 32, 32), 0.25), ((9, 9, 9), (4, 5, 9), 0.6)]:
        assert sw.window_starts(size, roi, ov) == jsw.window_starts(size, roi, ov)
    np.testing.assert_array_equal(sw.gaussian_importance((7, 8, 9)),
                                  jsw.gaussian_importance((7, 8, 9)))


def test_bf16_wire_matches_jax_wire():
    vol = np.random.default_rng(1).standard_normal((12, 10, 9, 1)).astype(np.float32)
    want = np.asarray(jsw.sliding_window_inference(
        vol, (8, 8, 8), 2, _jax_predictor, wire_dtype=jnp.bfloat16))
    got = sw.sliding_window_inference(vol, (8, 8, 8), 2, _torch_predictor,
                                      wire_dtype=torch.bfloat16)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_unported_modes_raise():
    vol = np.zeros((8, 8, 8, 1), np.float32)
    with pytest.raises(NotImplementedError, match="mesh"):
        sw.sliding_window_inference(vol, (8, 8, 8), 1, _torch_predictor, mesh=object())
