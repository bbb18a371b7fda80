"""The port's 2D sliding window, its host-streamed sliding window and the
rule that picks between them, against the JAX package on the CPU.

The same deterministic predictor (an elementwise map of the window, written
once in each framework) runs over the same volume in both packages:

- 2D in memory (gaussian and constant blend, a short tail chunk, a roi
  larger than the image) against ``segmantic_tpu``'s
  ``sliding_window_inference``, within 1e-5 relative (the same f32 blend in
  the same window order);
- ``sliding_window_inference_streamed`` (3D and 2D) against the port's
  in-memory path (bit-equal: the same products and sums in the same order)
  and against the JAX streamed function (1e-5 relative), with small-volume
  padding and a short last chunk; the twins of
  ``tests/infer/test_sliding_window.py::test_streamed_matches_device_path``
  and ``::test_streamed_small_volume_padding``;
- the dispatch of ``sliding_window_inference`` with ``_STREAM_BYTES``
  lowered: a host numpy array above it streams (the result a CPU tensor,
  ``wire_dtype`` ignored as in the JAX function), a tensor on the device
  runs in memory at any size, a CPU tensor on the CPU device too, and a mesh
  raises; the estimate is the JAX package's ``prod(spatial) * 4 * (classes
  or 8 + 2)``.
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


def _volume(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(tuple(shape) + (1,)).astype(np.float32)


@pytest.mark.parametrize("shape,roi,sw_batch,overlap,mode", [
    ((40, 33), (16, 16), 3, 0.25, "gaussian"),  # short tail chunk
    ((40, 33), (16, 16), 4, 0.5, "constant"),
    ((10, 24), (16, 16), 2, 0.25, "gaussian"),  # axis 0 smaller than the roi: padded
    ((9, 7), (16, 16), 2, 0.25, "constant"),  # roi larger than the image
])
def test_2d_matches_jax(shape, roi, sw_batch, overlap, mode):
    vol = _volume(shape)
    want = np.asarray(jsw.sliding_window_inference(
        vol, roi, sw_batch, _jax_predictor, overlap=overlap, mode=mode))
    blend.counter.reset()
    got = sw.sliding_window_inference(vol, roi, sw_batch, _torch_predictor,
                                      overlap=overlap, mode=mode, device="cpu")
    assert got.shape == tuple(shape) + (3,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    assert blend.counter.count == 0  # CPU tensors: the plain blend


def test_2d_windows_reach_the_predictor_as_2d():
    seen = []

    def predictor(w):
        seen.append(tuple(w.shape))
        return _torch_predictor(w)

    sw.sliding_window_inference(_volume((20, 20)), (8, 8), 4, predictor, device="cpu")
    assert seen[0] == (1, 8, 8, 1)  # the probe for the class count
    assert len(seen) > 1 and all(s == (4, 8, 8, 1) for s in seen[1:])


@pytest.mark.parametrize("shape,roi,sw_batch", [
    ((40, 36, 30), (16, 16, 16), 4),  # the JAX test's volume: a short last chunk
    ((10, 9, 8), (16, 16, 16), 2),  # smaller than the roi: padded, one window
    ((41, 30), (16, 16), 3),  # 2D
])
@pytest.mark.parametrize("mode", ["gaussian", "constant"])
def test_streamed_matches_the_in_memory_path_and_jax(shape, roi, sw_batch, mode):
    vol = _volume(shape, seed=5)
    got = sw.sliding_window_inference_streamed(vol, roi, sw_batch, _torch_predictor,
                                               overlap=0.25, mode=mode, device="cpu")
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    assert got.shape == tuple(shape) + (3,)
    in_memory = sw.sliding_window_inference(vol, roi, sw_batch, _torch_predictor,
                                            overlap=0.25, mode=mode, device="cpu")
    np.testing.assert_array_equal(got, in_memory.numpy())
    want = jsw.sliding_window_inference_streamed(vol, roi, sw_batch, _jax_predictor,
                                                 overlap=0.25, mode=mode)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_streamed_probes_the_classes_and_runs_chunks_in_window_order():
    vol = _volume((30, 30, 20), seed=6)
    batches = []

    def predictor(w):
        batches.append(w.shape[0])
        return _torch_predictor(w)

    out = sw.sliding_window_inference_streamed(vol, (16, 16, 16), 3, predictor, device="cpu")
    n = len(sw.window_starts((30, 30, 20), (16, 16, 16), 0.25))
    # one probe window, then full chunks and the short last one (not padded)
    assert batches == [1] + [3] * (n // 3) + ([n % 3] if n % 3 else [])
    assert out.shape == (30, 30, 20, 3)


@pytest.fixture
def low_threshold(monkeypatch):
    """``_STREAM_BYTES`` at 40 KiB: a 24^3 volume's accumulators (24^3 * 4 *
    (3 + 2) bytes, 270 KiB) pass it; a 12^3 one's (34 KiB) do not."""
    monkeypatch.setattr(sw, "_STREAM_BYTES", 40 << 10)
    calls = []
    real = sw.sliding_window_inference_streamed

    def spy(*args, **kw):
        calls.append(kw.get("device"))
        return real(*args, **kw)

    monkeypatch.setattr(sw, "sliding_window_inference_streamed", spy)
    return calls


def test_host_numpy_above_the_threshold_streams(low_threshold):
    vol = _volume((24, 24, 24), seed=7)
    blend.counter.reset()
    got = sw.sliding_window_inference(vol, (16, 16, 16), 4, _torch_predictor, num_classes=3,
                                      device="cpu", wire_dtype=torch.bfloat16)
    assert low_threshold == [torch.device("cpu")]
    assert got.device.type == "cpu" and got.dtype == torch.float32
    # wire_dtype is ignored on the streamed path (the JAX function's too)
    want = sw.sliding_window_inference_streamed(vol, (16, 16, 16), 4, _torch_predictor,
                                                device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def test_host_numpy_below_the_threshold_runs_in_memory(low_threshold):
    sw.sliding_window_inference(_volume((12, 12, 12)), (8, 8, 8), 4, _torch_predictor,
                                num_classes=3, device="cpu")
    assert low_threshold == []


def test_the_estimate_assumes_8_classes_when_none_are_given(low_threshold):
    """12^3 * 4 * (8 + 2) = 69 KiB > 40 KiB: streamed without ``num_classes``
    (whose 3 would give 34 KiB)."""
    sw.sliding_window_inference(_volume((12, 12, 12)), (8, 8, 8), 4, _torch_predictor,
                                device="cpu")
    assert low_threshold == [torch.device("cpu")]
    low_threshold.clear()
    sw.sliding_window_inference(_volume((12, 12, 12)), (8, 8, 8), 4, _torch_predictor,
                                num_classes=3, device="cpu")
    assert low_threshold == []


def test_a_device_tensor_runs_in_memory_at_any_size(low_threshold):
    vol = torch.from_numpy(_volume((24, 24, 24), seed=8))
    got = sw.sliding_window_inference(vol, (16, 16, 16), 4, _torch_predictor, num_classes=3,
                                      device="cpu")
    assert low_threshold == []
    want = sw.sliding_window_inference_streamed(vol.numpy(), (16, 16, 16), 4,
                                                _torch_predictor, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def test_streams_names_host_volumes_only():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    vol = np.zeros((8, 8, 8, 1), np.float32)
    for streams, volume, device in [
        (True, vol, cpu), (True, vol, cuda),
        (False, torch.from_numpy(vol), cpu),  # the device's own tensor
        (True, torch.from_numpy(vol), cuda),  # a host tensor for the card
        (False, torch.empty((8, 8, 8, 1), device="meta"), cuda),
    ]:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(sw, "_STREAM_BYTES", 0)
            assert sw._streams(volume, device, 3, None) is streams


def test_a_mesh_still_raises(low_threshold):
    """A mesh never streams, as in the JAX package: a mesh of one gives the
    in-memory result of a volume above the threshold; ``shard_volume`` without
    a mesh is ignored and streams."""
    from segmantic_tpu_torch.parallel import make_mesh

    vol = _volume((24, 24, 24))
    want = sw.sliding_window_inference(torch.from_numpy(vol), (16, 16, 16), 4,
                                       _torch_predictor, device="cpu")  # in memory
    got = sw.sliding_window_inference(vol, (16, 16, 16), 4, _torch_predictor, device="cpu",
                                      mesh=make_mesh())
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert low_threshold == []
    sw.sliding_window_inference(vol, (16, 16, 16), 4, _torch_predictor, device="cpu",
                                shard_volume=True)
    assert low_threshold == [torch.device("cpu")]


def test_the_threshold_is_the_jax_packages():
    assert sw._STREAM_BYTES == 8 << 30
