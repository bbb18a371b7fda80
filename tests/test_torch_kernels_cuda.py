"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and ``nvcc`` and skips without one. This
file imports neither JAX nor the JAX package, so it runs on a machine that
has only PyTorch; ``tests/conftest.py`` imports JAX, so skip it there:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py -q

Tolerances: f32 1e-4 * max|ref| (summation order over up to 27 * 256 terms,
TF32 off for the plain version); bf16 2e-2 * max|ref| (the plain version
rounds the conv output to bf16 before its epilogue); the blend is bit-equal.
The weight gradients sum over every position (up to ~10^5 terms here): f32
1e-3 * max|ref|, bf16 inputs 2e-2 * max|ref|; a repeated dw launch is
bit-equal (fixed-order reduction).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from segmantic_tpu_torch.ops import blend, fused_conv, phase_conv

pytestmark = pytest.mark.cuda

DTYPES = [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)]
DW_DTYPES = [(torch.float32, 1e-3), (torch.bfloat16, 2e-2)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card, see the module docstring)")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(g, *shape, scale=1.0, device="cuda"):
    return (torch.randn(shape, generator=g) * scale).to(device)


def _close(got, want, tol):
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * want.float().abs().max().item(), err


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("shape,co,relu_mode", [
    ((2, 5, 7, 9, 3), 5, "prelu"),  # ragged tiles, C and CO below a tile
    ((4, 12, 12, 12, 64), 64, "relu"),
    ((1, 6, 6, 6, 128), 256, "none"),  # several channel chunks and CO tiles
])
def test_fused_conv(cuda, shape, co, relu_mode, dtype, tol):
    g = torch.Generator().manual_seed(0)
    x = _randn(g, *shape).to(dtype)
    w = _randn(g, 3, 3, 3, shape[-1], co, scale=(27 * shape[-1]) ** -0.5).to(dtype)
    kw = dict(bias=_randn(g, co), scale=_randn(g, co).abs() + 0.5, shift=_randn(g, co),
              alpha=torch.tensor([0.2], device=cuda), relu_mode=relu_mode)
    fused_conv.counter.reset()
    got = fused_conv.conv3d(x, w, **kw)
    assert fused_conv.counter.count == 1 and got.dtype == dtype
    _close(got, fused_conv.conv3d_plain(x, w, **kw), tol)


def test_fused_conv_f32_output_from_bf16(cuda):
    g = torch.Generator().manual_seed(1)
    x = _randn(g, 2, 8, 8, 8, 16).to(torch.bfloat16)
    w = _randn(g, 3, 3, 3, 16, 16, scale=0.05).to(torch.bfloat16)
    got = fused_conv.conv3d(x, w, out_dtype=torch.float32)
    assert got.dtype == torch.float32
    _close(got, fused_conv.conv3d_plain(x, w, out_dtype=torch.float32), 1e-2)


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("shape,ci,co", [
    ((1, 3, 4, 5, 24), 3, 3),
    ((2, 6, 8, 16, 64), 8, 8),  # the top decoder stage's L = 64
    ((1, 4, 4, 4, 128), 16, 16),  # the second stage's L = 128
])
def test_phase_conv(cuda, shape, ci, co, dtype, tol):
    g = torch.Generator().manual_seed(2)
    p = _randn(g, *shape).to(dtype)
    w = _randn(g, 3, 3, 3, ci, co, scale=(27 * ci) ** -0.5).to(dtype)
    kw = dict(bias=_randn(g, co), scale=_randn(g, co).abs() + 0.5, shift=_randn(g, co),
              alpha=torch.tensor([0.3], device=cuda), relu_mode="prelu")
    phase_conv.counter.reset()
    got = phase_conv.phase_conv(p, w, **kw)
    assert phase_conv.counter.count == 1
    _close(got, phase_conv.phase_conv_plain(p, w, **kw), tol)


@pytest.mark.parametrize("starts", [
    [[0, 0, 0], [0, 0, 24], [0, 30, 20], [40, 10, 0]],  # overlapping
    [[50, 50, 40]],  # one window at the far corner
    [[3, 5, 7], [3, 5, 7]],  # the same window twice
])
def test_blend_bit_equal(cuda, starts):
    g = torch.Generator().manual_seed(3)
    roi = (32, 32, 24)
    acc = _randn(g, 82, 82, 64, 5)
    logits = _randn(g, len(starts), *roi, 5)
    imp = torch.rand(roi, generator=g).to(cuda)
    starts = np.asarray(starts)
    blend.counter.reset()
    got = blend.accumulate_windows(acc.clone(), logits, imp, starts)
    want = blend.accumulate_windows_plain(acc.clone(), logits, imp, starts)
    torch.cuda.synchronize()
    assert blend.counter.count == 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype,tol", DW_DTYPES)
@pytest.mark.parametrize("shape,co", [
    ((2, 5, 7, 9, 3), 5),  # ragged tiles, C and CO below a chunk
    ((4, 12, 12, 12, 16), 16),
    ((2, 6, 6, 6, 128), 256),  # the bottom stage: many outputs, few positions
    ((2, 16, 20, 24, 32), 32),  # several position tiles per split
])
def test_fused_conv_dw(cuda, shape, co, dtype, tol):
    g = torch.Generator().manual_seed(4)
    x = _randn(g, *shape).to(dtype)
    dy = _randn(g, *shape[:4], co).to(dtype)
    fused_conv.dw_counter.reset()
    got = fused_conv.conv3d_dw(x, dy)
    assert fused_conv.dw_counter.count == 1 and got.dtype == torch.float32
    assert got.shape == (3, 3, 3, shape[-1], co)
    _close(got, fused_conv.conv3d_dw_plain(x, dy), tol)
    assert torch.equal(got, fused_conv.conv3d_dw(x, dy))  # deterministic


@pytest.mark.parametrize("dtype,tol", DW_DTYPES)
@pytest.mark.parametrize("shape,ci,co", [
    ((1, 3, 4, 5, 24), 3, 5),
    ((2, 6, 8, 16, 64), 8, 8),  # the top decoder stage's L = 64
    ((2, 4, 4, 4, 128), 16, 16),  # the second stage's L = 128
])
def test_phase_conv_dw(cuda, shape, ci, co, dtype, tol):
    g = torch.Generator().manual_seed(5)
    p = _randn(g, *shape).to(dtype)
    gy = _randn(g, *shape[:4], 8 * co).to(dtype)
    phase_conv.dw_counter.reset()
    got = phase_conv.phase_conv_dw(p, gy)
    assert phase_conv.dw_counter.count == 1 and got.shape == (3, 3, 3, ci, co)
    _close(got, phase_conv.phase_conv_dw_plain(p, gy), tol)
    assert torch.equal(got, phase_conv.phase_conv_dw(p, gy))


def _grads(fn, *args):
    args = [a.detach().clone().requires_grad_() for a in args]
    out = fn(*args)
    g = torch.Generator().manual_seed(9)
    cot = _randn(g, *out.shape).to(out.dtype)
    out.backward(cot)
    return [out] + [a.grad for a in args]


@pytest.mark.parametrize("dtype,tol", DW_DTYPES)
def test_conv3d_grad_function(cuda, dtype, tol):
    g = torch.Generator().manual_seed(6)
    x = _randn(g, 2, 8, 10, 12, 16).to(dtype)
    w = _randn(g, 3, 3, 3, 16, 24, scale=0.05).to(dtype)
    fused_conv.counter.reset()
    fused_conv.dw_counter.reset()
    got = _grads(fused_conv.conv3d_grad, x, w)
    assert fused_conv.counter.count == 2 and fused_conv.dw_counter.count == 1
    want = _grads(fused_conv.conv3d_plain, x, w)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        _close(a, b, tol)


@pytest.mark.parametrize("dtype,tol", DW_DTYPES)
def test_phase_conv_grad_function(cuda, dtype, tol):
    g = torch.Generator().manual_seed(7)
    p = _randn(g, 2, 4, 6, 8, 64).to(dtype)
    w = _randn(g, 3, 3, 3, 8, 8, scale=0.1).to(dtype)
    phase_conv.counter.reset()
    phase_conv.dw_counter.reset()
    got = _grads(phase_conv.phase_conv_grad, p, w)
    assert phase_conv.counter.count == 2 and phase_conv.dw_counter.count == 1
    want = _grads(phase_conv.phase_conv_plain, p, w)
    for a, b in zip(got, want):
        _close(a, b, tol)
