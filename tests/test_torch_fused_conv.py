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


def _im2col_row(x, pos, ck, nchunks, krows):
    """The K vector of output position ``pos`` of x (D, H, W, C) in the packed
    order: per chunk, row ``tap * ck + ci`` (zero outside the volume, zero
    beyond C, zero in the padding rows)."""
    d, h, w, c = x.shape
    a = np.zeros((nchunks, krows), np.float32)
    for tap, (tz, ty, tx) in enumerate(np.ndindex(3, 3, 3)):
        z, y, xx = pos[0] + tz - 1, pos[1] + ty - 1, pos[2] + tx - 1
        if 0 <= z < d and 0 <= y < h and 0 <= xx < w:
            for ci in range(c):
                a[ci // ck, tap * ck + ci % ck] = x[z, y, xx, ci]
    return a


@pytest.mark.parametrize("c,co,nt", [(8, 8, 8), (16, 16, 16), (32, 32, 32), (24, 5, 8),
                                     (64, 40, 16), (8, 20, 16)])
def test_pack_weights_is_the_k_by_n_order_the_kernel_reads(c, co, nt):
    """Packed weights against a plain einsum over their [K][N] order (the
    C = 8 case pads K = 216 to 224 with a zero tap; C = 24 pads its chunk to
    32 channels; CO pads to whole N tiles), and unpack(pack(w)) convolves like w."""
    rng = np.random.default_rng(c + co)
    x = rng.standard_normal((1, 4, 5, 6, c)).astype(np.float32)
    w = rng.standard_normal((3, 3, 3, c, co)).astype(np.float32)
    packed = fused_conv.pack_weights(torch.from_numpy(w), nt)
    ck, nchunks, krows = fused_conv._chunking(c)
    assert krows % 16 == 0 and (ck, krows) == ((8, 224) if c == 8 else (ck, 27 * ck))
    assert tuple(packed.shape) == (-(-co // nt), nchunks, krows, nt) and packed.is_contiguous()
    want = fused_conv.conv3d_plain(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    for pos in [(0, 0, 0), (1, 2, 3), (3, 4, 5)]:
        a = _im2col_row(x[0], pos, ck, nchunks, krows)
        got = np.einsum("ck,tckn->tn", a, packed.numpy()).reshape(-1)
        np.testing.assert_allclose(got[:co], want[0][pos], atol=1e-4, rtol=1e-4)
        assert not got[co:].any()  # the padding columns are zero
    back = fused_conv.unpack_weights(packed, c, co)
    assert torch.equal(back, torch.from_numpy(w))
    assert torch.equal(fused_conv.conv3d_plain(torch.from_numpy(x), back),
                       torch.from_numpy(want))


FLAGSHIP = [  # (full-resolution extents, C, CO) of every conv the flagship UNet launches
    ((48, 48, 48), 16, 16), ((24, 24, 24), 32, 32), ((12, 12, 12), 64, 64),
    ((6, 6, 6), 128, 128), ((6, 6, 6), 128, 256), ((6, 6, 6), 256, 256),
    ((96, 96, 96), 8, 8),  # phase L = 64; phase L = 128 is 48^3 x 16 again
]


def _check_plan(p, dims, c, co, out_bytes):
    b, d, h, w = dims
    assert p.td * p.th * p.tw <= 32 * p.warps and 1 <= p.warps <= 8
    assert p.nt in (8, 16, 32) and p.n_tiles * p.nt >= co > (p.n_tiles - 1) * p.nt
    assert p.nchunks * p.ck >= c > (p.nchunks - 1) * p.ck and p.stages in (2, 3)
    assert p.nbricks == b * -(-d // p.td) * -(-h // p.th) * -(-w // p.tw)
    assert 1 <= p.grid_x <= min(p.nbricks, 2 ** 31 - 1) and p.n_tiles <= 65535
    assert p.smem_bytes <= fused_conv.SMEM_LIMIT
    krows = fused_conv._chunking(c)[2]
    assert p.smem_bytes == fused_conv._smem_bytes(
        p.ck, krows, p.nt, (p.td, p.th, p.tw), p.warps, p.nchunks, p.stages, p.resident,
        out_bytes)
    assert abs(p.fill - b * d * h * w / (p.nbricks * p.warps * 32)) < 1e-12


@pytest.mark.parametrize("batch", [4, 8])
@pytest.mark.parametrize("extents,c,co", FLAGSHIP)
def test_plan_fills_the_rows_at_every_flagship_shape(extents, c, co, batch):
    """>= 75% of a block's M rows are real output positions and the grid is
    within CUDA's limits at every shape of the flagship path, serving (batch
    4) and training (batch 8), bf16 and f32 output."""
    for out_bytes in (2, 4):
        p = fused_conv.plan((batch,) + extents, c, co, out_bytes)
        _check_plan(p, (batch,) + extents, c, co, out_bytes)
        assert p.fill >= 0.75, p
        assert p.grid_x * p.n_tiles >= min(132, p.nbricks * p.n_tiles) // 2, p


@pytest.mark.parametrize("dims,c,co", [
    ((2, 20, 22, 26), 24, 5), ((1, 5, 7, 9), 8, 8), ((2, 3, 4, 5), 16, 300),
    ((1, 1, 1, 1), 8, 1), ((1, 200, 200, 200), 32, 8), ((70000, 2, 2, 2), 8, 8),
])
def test_plan_is_sane_at_ragged_shapes(dims, c, co):
    p = fused_conv.plan(dims, c, co)
    _check_plan(p, dims, c, co, 2)
    assert 0 < p.fill <= 1


def test_plan_refuses_channel_counts_without_16_byte_vectors():
    """The tensor-core plan refuses C % 8 != 0; the rule sends those channel
    counts elsewhere: bf16 C = 1..7 to the few-channel body, f32 and bf16
    C = 12 to the CUDA-core body."""
    with pytest.raises(ValueError, match="C % 8"):
        fused_conv.plan((1, 8, 8, 8), 12, 8)
    x = torch.zeros((1, 2, 2, 2, 16), dtype=torch.bfloat16)
    assert fused_conv.conv_body(x, 16, 16) == "tensor_cores"
    assert fused_conv.conv_body(x.float(), 16, 16) == "cuda_cores"
    assert fused_conv.conv_body(x[..., :12], 12, 16) == "cuda_cores"
    assert fused_conv.conv_body(torch.zeros((1, 2, 2, 2, 24)).bfloat16(), 3, 16) == "few_channels"
