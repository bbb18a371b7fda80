"""Blend-accumulate of the PyTorch port vs the Pallas kernel it replaces.

The plain version (the sequential per-window loop the wrapper runs for CPU
tensors) is held against ``accumulate_windows_pallas`` in interpret mode on
starts that meet the Pallas alignment contract and overlap. Both compute
``acc + logits * importance`` per window in f32 in the same order, so the
tolerance is 1e-6 relative (one rounding step, should XLA fuse differently).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmantic_tpu.ops.pallas_blend import accumulate_windows_pallas
from segmantic_tpu_torch.ops import blend


def _case(seed=0):
    rng = np.random.default_rng(seed)
    acc = rng.standard_normal((32, 32, 48, 8)).astype(np.float32)
    logits = rng.standard_normal((4, 16, 16, 32, 8)).astype(np.float32)
    imp = rng.random((16, 16, 32)).astype(np.float32)
    # axis-1 starts % 8 == 0, axis-2 starts * C % 128 == 0; windows overlap
    starts = np.array([[0, 0, 0], [8, 8, 16], [16, 16, 16], [4, 16, 0]], np.int32)
    return acc, logits, imp, starts


def test_plain_matches_pallas_interpret():
    acc, logits, imp, starts = _case()
    got = blend.accumulate_windows_plain(
        torch.from_numpy(acc.copy()), torch.from_numpy(logits),
        torch.from_numpy(imp), starts).numpy()
    want = np.asarray(accumulate_windows_pallas(
        jnp.asarray(acc), jnp.asarray(logits), jnp.asarray(imp),
        jnp.asarray(starts), tile=8, interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_plain_is_the_sequential_numpy_loop():
    acc, logits, imp, starts = _case(1)
    want = acc.copy()
    for b, s in enumerate(starts):
        sl = tuple(slice(int(a), int(a) + r) for a, r in zip(s, logits.shape[1:4]))
        want[sl] = want[sl] + logits[b] * imp[..., None]
    got = blend.accumulate_windows(
        torch.from_numpy(acc), torch.from_numpy(logits), torch.from_numpy(imp), starts)
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrapper_checks_arguments():
    acc, logits, imp, starts = _case(2)
    acc, logits, imp = map(torch.from_numpy, (acc, logits, imp))
    blend.counter.reset()
    with pytest.raises(ValueError, match="outside"):
        blend.accumulate_windows(acc, logits, imp, starts + np.array([20, 0, 0]))
    with pytest.raises(TypeError, match="float32"):
        blend.accumulate_windows(acc, logits.double(), imp, starts)
    with pytest.raises(ValueError, match="mismatch"):
        blend.accumulate_windows(acc, logits, imp, starts[:3])
    assert blend.counter.count == 0
