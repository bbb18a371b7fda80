"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and ``nvcc`` and skips without one. This
file imports neither JAX nor the JAX package, so it runs on a machine that
has only PyTorch; ``tests/conftest.py`` imports JAX, so skip it there:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py -q

Tolerances: f32 1e-4 * max|ref| (summation order over up to 27 * 256 terms,
TF32 off for the plain version); bf16 2e-2 * max|ref| (the plain version
rounds the conv output to bf16 before its epilogue); the blend is bit-equal.
bf16 convs with C, CO >= 64 (dense) run the deep-channel body, other bf16
convs with C % 8 == 0 the tensor-core body, bf16 with C = 1..7 the
few-channel body, f32 and the other bf16 channel counts the register-tiled f32
body (``csrc/conv3_f32.cuh``); a
repeated conv launch is bit-equal.
The weight gradients sum over every position (up to ~10^5 terms here): f32
1e-3 * max|ref|, bf16 inputs 2e-2 * max|ref|; a repeated dw launch is
bit-equal (fixed-order reduction). bf16 weight gradients with C >= 64 and
CO >= 128 (dense) run the deep-channel dw body, others with C % 8 == 0 and
CO % 8 == 0 the tensor-core dw body, held to 1e-3 * max|ref| at every dw
shape of a flagship step (both sides sum the same exactly upcast products in
f32, in another order), bf16 with C = 1..7 and any CO the few-channel dw body,
held to the same; f32 and the other channel counts the register-tiled f32 dw
body (``csrc/conv3_f32_dw.cuh``).
The shear group does two products and one sum per output: order 0 and the
bf16-weight mode are bit-equal to the plain version, f32 within 1e-6 *
max|ref| (the plain version's matrix product may fuse the multiply and add).
The Dice sums run over up to ~10^5 voxels in another order, with the card's
approximate exponential (2 ulp) and one reciprocal a voxel: 1e-5 relative, the
label counts exact;
the Dice cotangent 1e-5 * max|ref| in f32 and 2e-2 in bf16 (one rounding of
the output); repeated launches are bit-equal.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from segmantic_tpu_torch.infer.sliding_window import window_starts
from segmantic_tpu_torch.ops import (
    _cuda, blend, fused_conv, fused_shear, phase_conv, phase_dice, shear_resample,
)
from segmantic_tpu_torch.train import losses

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
    ((2, 5, 7, 9, 12), 5, "prelu"),  # bf16: C % 8 != 0 above 8, the f32 body
    ((4, 12, 12, 12, 64), 64, "relu"),
    ((1, 6, 6, 6, 128), 256, "none"),  # several channel chunks and CO tiles
    ((4, 6, 6, 6, 128), 128, "prelu"),  # the bottom of the flagship UNet
    ((4, 6, 6, 6, 128), 256, "prelu"),
    ((4, 6, 6, 6, 256), 256, "prelu"),
    ((2, 20, 22, 26, 16), 8, "prelu"),  # extents a multiple of no brick; the head's CO = 8
    ((2, 20, 22, 26, 24), 5, "relu"),  # a chunk padded to 32 channels, scalar stores
    ((1, 3, 2, 50, 8), 40, "none"),  # C = 8 pairs taps; CO over two N tiles
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
    assert torch.equal(got, fused_conv.conv3d(x, w, **kw))  # deterministic
    cache = {}  # the packed weights kept between calls, as the executor keeps them
    for _ in range(2):
        assert torch.equal(got, fused_conv.conv3d(x, w, packed_cache=cache, **kw))
    assert len(cache) == int(fused_conv.conv_body(x, shape[-1], co) != "f32_tiles")


@pytest.mark.parametrize("shape,co", [
    ((2, 8, 8, 8, 16), 16), ((2, 9, 10, 11, 24), 5), ((1, 6, 6, 6, 64), 40),
])
def test_fused_conv_f32_output_from_bf16(cuda, shape, co):
    g = torch.Generator().manual_seed(1)
    x = _randn(g, *shape).to(torch.bfloat16)
    w = _randn(g, 3, 3, 3, shape[-1], co, scale=0.05).to(torch.bfloat16)
    kw = dict(bias=_randn(g, co), alpha=torch.tensor([0.2], device=cuda), relu_mode="prelu")
    got = fused_conv.conv3d(x, w, out_dtype=torch.float32, **kw)
    assert got.dtype == torch.float32
    _close(got, fused_conv.conv3d_plain(x, w, out_dtype=torch.float32, **kw), 1e-2)
    assert torch.equal(got, fused_conv.conv3d(x, w, out_dtype=torch.float32, **kw))


def test_conv_refuses_a_sample_beyond_32_bit_offsets(cuda):
    """The tensor-core body indexes inside a sample in 32 bits: the wrapper
    raises before any launch (tensors of that size are never made here)."""
    x = torch.empty((1, 1, 1, 1, 8), dtype=torch.bfloat16, device=cuda)
    w = torch.empty((3, 3, 3, 8, 8), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="2\\^31"):
        fused_conv.launch_conv3("segk_fused_conv3", x, w, None, None, None, None, "none",
                                x, (1, 2048, 2048, 64))


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("shape,ci,co", [
    ((1, 3, 4, 5, 24), 3, 3),
    ((1, 3, 4, 5, 96), 12, 5),  # bf16: C % 8 != 0 above 8, the f32 body
    ((2, 6, 8, 16, 64), 8, 8),  # the top decoder stage's L = 64
    ((1, 4, 4, 4, 128), 16, 16),  # the second stage's L = 128
    ((2, 10, 11, 13, 64), 8, 8),  # full-resolution extents a multiple of no brick
    ((2, 10, 11, 13, 192), 24, 5),  # a padded chunk, scalar stores
    ((1, 5, 7, 9, 64), 8, 16),
    ((1, 3, 3, 3, 512), 64, 40),  # two chunks, two N tiles
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
    assert torch.equal(got, phase_conv.phase_conv(p, w, **kw))  # deterministic
    if dtype == torch.bfloat16:
        wide = phase_conv.phase_conv(p, w, out_dtype=torch.float32, **kw)
        assert wide.dtype == torch.float32
        _close(wide, phase_conv.phase_conv_plain(p, w, out_dtype=torch.float32, **kw), 1e-2)


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


@pytest.mark.parametrize("classes", [8, 5, 3, 4])  # float4 route, scalar route
@pytest.mark.parametrize("volume,roi,n_windows", [
    ((82, 82, 64), (32, 32, 24), 16),  # a 16-window chunk
    ((50, 44, 41), (32, 32, 24), 3),  # a short chunk, every window snapped to an edge
    ((40, 36, 30), (8, 10, 6), 40),  # more windows than one launch takes
])
def test_blend_union_shapes(cuda, volume, roi, n_windows, classes):
    """Bit-equal to the sequential loop, the accumulator outside the windows'
    union untouched (a sentinel survives), one launch per MAX_WINDOWS windows,
    and the weight map in the same pass."""
    g = torch.Generator().manual_seed(19)
    grid = np.asarray(window_starts(volume, roi, 0.25))
    if n_windows <= len(grid):
        starts = grid[-n_windows:]
    else:
        extra = np.stack([torch.randint(0, v - r + 1, (n_windows - len(grid),), generator=g).numpy()
                          for v, r in zip(volume, roi)], axis=1)
        starts = np.concatenate([grid, extra])
    covered = torch.zeros(volume, dtype=torch.bool, device=cuda)
    for s in starts:
        covered[tuple(slice(int(a), int(a) + r) for a, r in zip(s, roi))] = True
    acc = _randn(g, *volume, classes)
    acc[~covered] = 777.0
    wacc = torch.rand((*volume, 1), generator=g).to(cuda)
    logits = _randn(g, len(starts), *roi, classes)
    imp = torch.rand(roi, generator=g).to(cuda)
    blend.counter.reset()
    got, got_w = acc.clone(), wacc.clone()
    blend.accumulate_windows(got, logits, imp, starts, got_w)
    assert blend.counter.count == -(-len(starts) // blend.MAX_WINDOWS)
    want, want_w = acc.clone(), wacc.clone()
    blend.accumulate_windows_plain(want, logits, imp, starts, want_w)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(got_w, want_w)
    assert bool((got[~covered] == 777.0).all())
    again = blend.accumulate_windows(acc.clone(), logits, imp, starts)
    assert torch.equal(again, want)  # repeated, and without the weight map


def test_blend_more_channel_units_than_a_block_is_wide(cuda):
    """136 channels are 34 float4 a voxel: 32 threads side by side, then a loop."""
    g = torch.Generator().manual_seed(25)
    roi = (8, 8, 8)
    starts = np.array([[0, 0, 0], [5, 6, 7], [12, 12, 12]])
    acc = _randn(g, 20, 20, 20, 136)
    wacc = torch.rand((20, 20, 20, 1), generator=g).to(cuda)
    logits = _randn(g, 3, *roi, 136)
    imp = torch.rand(roi, generator=g).to(cuda)
    assert blend.launch_shape(136) == (4, (32, 1, 8))
    want, want_w = acc.clone(), wacc.clone()
    blend.accumulate_windows_plain(want, logits, imp, starts, want_w)
    blend.accumulate_windows(acc, logits, imp, starts, wacc)
    torch.cuda.synchronize()
    assert torch.equal(acc, want) and torch.equal(wacc, want_w)


def test_blend_unaligned_views_take_the_scalar_route(cuda):
    g = torch.Generator().manual_seed(20)
    roi = (8, 8, 8)
    starts = np.array([[0, 0, 0], [4, 4, 4]])
    store = _randn(g, 12 * 12 * 12 * 4 + 1)
    acc = store[1:].view(12, 12, 12, 4)  # 4 bytes off a 16-byte boundary
    assert acc.data_ptr() % 16 != 0 and acc.is_contiguous()
    logits = _randn(g, 2, *roi, 4)
    imp = torch.rand(roi, generator=g).to(cuda)
    want = blend.accumulate_windows_plain(acc.clone(), logits, imp, starts)
    got = blend.accumulate_windows(acc, logits, imp, starts)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_blend_is_captured_in_a_cuda_graph(cuda):
    """A call uploads nothing: it records into a graph and replays."""
    g = torch.Generator().manual_seed(22)
    roi = (16, 16, 16)
    starts = np.array([[0, 0, 0], [8, 8, 8], [16, 16, 16]])
    acc = _randn(g, 32, 32, 32, 8)
    logits = _randn(g, 3, *roi, 8)
    imp = torch.rand(roi, generator=g).to(cuda)
    want = acc.clone()
    for _ in range(3):  # the warm-up call, then two replays
        blend.accumulate_windows_plain(want, logits, imp, starts)
    blend.accumulate_windows(acc, logits, imp, starts)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        blend.accumulate_windows(acc, logits, imp, starts)
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(acc, want)


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
    # bf16 on the phase dw's Hopper body (at least PHASE_DW_MIN_POSITIONS block
    # voxels), extents a multiple of no brick: the per-tz path (Co <= 16), the
    # general path at Ci = 16 (three co chunks), 32 and 64 (N = 64, 128)
    ((2, 30, 34, 38, 128), 16, 16),
    ((2, 18, 26, 38, 128), 16, 48),
    ((1, 36, 33, 30, 256), 32, 16),
    ((1, 34, 36, 30, 512), 64, 32),
])
def test_phase_conv_dw(cuda, shape, ci, co, dtype, tol):
    g = torch.Generator().manual_seed(5)
    p = _randn(g, *shape).to(dtype)
    gy = _randn(g, *shape[:4], 8 * co).to(dtype)
    hop = (dtype == torch.bfloat16 and ci >= fused_conv.PHASE_DW_MIN_C
           and p.numel() // p.shape[-1] >= fused_conv.PHASE_DW_MIN_POSITIONS)
    assert (fused_conv.dw_body(p, ci, co, True) == "phase_blocks") == hop
    phase_conv.dw_counter.reset()
    fused_conv.phase_dw_counter.reset()
    got = phase_conv.phase_conv_dw(p, gy)
    assert phase_conv.dw_counter.count == 1 and got.shape == (3, 3, 3, ci, co)
    assert fused_conv.phase_dw_counter.count == int(hop)
    # the phase body (f32 sums of the same exactly upcast products) within 1e-3
    _close(got, phase_conv.phase_conv_dw_plain(p, gy), 1e-3 if hop else tol)
    assert torch.equal(got, phase_conv.phase_conv_dw(p, gy))


def test_phase_dw_launcher_refuses_plans_it_did_not_size(cuda):
    """The phase dw's Hopper body's launcher refuses a shared-memory sum
    other than its own and an instance it does not have (two warpgroups of
    three tiles at N = 64)."""
    p = torch.zeros((1, 4, 6, 8, 128), dtype=torch.bfloat16, device=cuda)
    dims = (1, 8, 12, 16)
    q = fused_conv.phase_dw_plan(dims, 16, 16)
    out = torch.empty((3, 3, 3, 16, 16), dtype=torch.float32, device=cuda)
    ws = torch.empty(q.workspace, dtype=torch.float32, device=cuda)
    args = (p.data_ptr(), p.data_ptr(), ws.data_ptr(), out.data_ptr(), *dims, 16, 16, q.td, q.th,
            q.tw, q.tpw, q.nwg, q.splits, q.stages)
    _cuda.launch("segk_phase_conv3_dw_wgmma", *args, q.smem_bytes)
    with pytest.raises(RuntimeError, match="CUDA error"):
        _cuda.launch("segk_phase_conv3_dw_wgmma", *args, q.smem_bytes + 1024)
    p32 = torch.zeros((1, 4, 6, 8, 256), dtype=torch.bfloat16, device=cuda)
    q32 = fused_conv.phase_dw_plan(dims, 32, 16)
    ws32 = torch.empty(q32.workspace, dtype=torch.float32, device=cuda)
    with pytest.raises(RuntimeError, match="CUDA error"):  # no (N 64, TPW 3, NWG 2) instance
        _cuda.launch("segk_phase_conv3_dw_wgmma", p32.data_ptr(), p.data_ptr(), ws32.data_ptr(),
                     out.data_ptr(), *dims, 32, 16, q32.td, q32.th, q32.tw, 3, 2,
                     q32.splits, q32.stages, q32.smem_bytes)


# (layout, stored shape of x, stored channels of dy): every dw shape of one
# flagship train step at batch 8, then ragged and odd ones
DW_FLAGSHIP = [
    ("dense", (8, 48, 48, 48, 16), 16), ("dense", (8, 24, 24, 24, 32), 32),
    ("dense", (8, 12, 12, 12, 64), 64), ("dense", (8, 6, 6, 6, 128), 128),
    ("dense", (8, 6, 6, 6, 128), 256), ("dense", (8, 6, 6, 6, 256), 256),
    ("phase", (8, 48, 48, 48, 64), 64),  # L = 64: 96^3 x 8 -> 8
    ("phase", (8, 24, 24, 24, 128), 128),  # L = 128
]
DW_ODD = [
    ("dense", (2, 20, 22, 26, 16), 16),  # extents a multiple of no brick
    ("dense", (2, 10, 11, 13, 16), 24),  # CO = 24
    ("dense", (3, 7, 9, 50, 40), 16),  # C = 40: a chunk padded with zero rows
    ("dense", (1, 6, 6, 6, 8), 8),  # one brick: one split, no reduce launch
    ("dense", (2, 5, 7, 9, 8), 32),  # tap pairs, K rows mostly padding
    ("phase", (1, 5, 7, 9, 64), 128),  # C = 8 -> 16, ragged full-resolution bricks
    ("phase", (2, 10, 11, 13, 192), 64),  # C = 24 -> 8
]


def _dense_rows(x, c, co, least) -> bool:
    """Whether the rule sends bf16 dense x to a dense Hopper body (``least``:
    ``fused_conv.DENSE_MIN_POSITIONS`` or ``DENSE_DW_MIN_POSITIONS``)."""
    return (fused_conv.dense_eligible(c, co, x.shape[3])
            and x.numel() // x.shape[-1] >= least[c])


def _pairs(x, c, co) -> bool:
    """Whether the rule sends bf16 dense x to the dense pairs dw body."""
    return (fused_conv.dense_pairs_eligible(c, co, x.shape[3])
            and x.numel() // x.shape[-1] >= fused_conv.DENSE_PAIRS_MIN_POSITIONS)


def _pieces(p, c, co) -> bool:
    """Whether the rule sends bf16 phase-major p to the phase pieces dw body."""
    return (fused_conv.phase_pieces_eligible(c, co)
            and p.numel() // p.shape[-1] >= fused_conv.PHASE_PIECES_MIN_POSITIONS)


@pytest.mark.parametrize("shape", [
    (8, 24, 24, 24, 32),  # the flagship's, SegResNet's and UNETR's 24^3 x 32 (batch 8)
    (4, 24, 24, 24, 32),  # a rank's at two ranks
    (2, 30, 21, 50, 32),  # extents a multiple of no brick
    (1, 9, 40, 64, 32),  # a few bricks a block
])
def test_dense_pairs_dw_body(cuda, shape):
    g = torch.Generator().manual_seed(19)
    x = _randn(g, *shape).to(torch.bfloat16)
    dy = _randn(g, *shape).to(torch.bfloat16)
    assert fused_conv.dw_body(x, 32, 32) == ("dense_pairs" if _pairs(x, 32, 32)
                                             else "tensor_cores")
    fused_conv.dense_pairs_counter.reset()
    got = fused_conv.conv3d_dw(x, dy)
    assert fused_conv.dense_pairs_counter.count == int(_pairs(x, 32, 32))
    _close(got, fused_conv.conv3d_dw_plain(x, dy), 1e-3)
    assert torch.equal(got, fused_conv.conv3d_dw(x, dy))  # fixed-order sums: bit-equal
    # the weight gradient through the autograd Function takes the same body
    w = _randn(g, 3, 3, 3, 32, 32, scale=0.03).to(torch.bfloat16).requires_grad_()
    fused_conv.dense_pairs_counter.reset()
    fused_conv.conv3d_grad(x, w).float().sum().backward()
    assert fused_conv.dense_pairs_counter.count == int(_pairs(x, 32, 32))


def test_dense_pairs_launcher_refuses_plans_it_did_not_size(cuda):
    """The pairs body's launcher refuses a shared-memory sum other than its
    own, more blocks than bricks and channels other than 32."""
    from segmantic_tpu_torch.ops.fused_conv import dense_pairs_plan

    x = torch.zeros((1, 8, 8, 16, 32), dtype=torch.bfloat16, device=cuda)
    q = dense_pairs_plan((1, 8, 8, 16), 32, 32)
    ws = torch.empty(q.workspace * 2, dtype=torch.float32, device=cuda)
    out = torch.empty((3, 3, 3, 32, 32), dtype=torch.float32, device=cuda)
    head = (x.data_ptr(), x.data_ptr(), ws.data_ptr(), out.data_ptr(), 1, 8, 8, 16)
    _cuda.launch("segk_fused_conv3_dw_pairs", *head, 32, 32, q.grid_x, q.stages, q.smem_bytes)
    for args in ((32, 32, q.grid_x, q.stages, q.smem_bytes + 1024),
                 (32, 32, q.nbricks + 1, q.stages, q.smem_bytes),
                 (16, 16, q.grid_x, q.stages, q.smem_bytes)):
        with pytest.raises(RuntimeError, match="CUDA error"):
            _cuda.launch("segk_fused_conv3_dw_pairs", *head, *args)


@pytest.mark.parametrize("shape", [
    (8, 48, 48, 48, 64),  # the flagship's L = 64 (96^3 x 8, batch 8)
    (4, 48, 48, 48, 64),  # a rank's at two ranks
    (2, 18, 26, 38, 64),  # extents a multiple of no brick
    (1, 24, 24, 24, 64),  # the least volume
])
def test_phase_pieces_dw_body(cuda, shape):
    g = torch.Generator().manual_seed(21)
    p = _randn(g, *shape).to(torch.bfloat16)
    gy = _randn(g, *shape).to(torch.bfloat16)
    assert fused_conv.dw_body(p, 8, 8, True) == ("phase_pieces" if _pieces(p, 8, 8)
                                                 else "tensor_cores")
    fused_conv.phase_pieces_counter.reset()
    got = phase_conv.phase_conv_dw(p, gy)
    assert fused_conv.phase_pieces_counter.count == int(_pieces(p, 8, 8))
    _close(got, phase_conv.phase_conv_dw_plain(p, gy), 1e-3)
    assert torch.equal(got, phase_conv.phase_conv_dw(p, gy))
    w = _randn(g, 3, 3, 3, 8, 8, scale=0.07).to(torch.bfloat16).requires_grad_()
    fused_conv.phase_pieces_counter.reset()
    phase_conv.phase_conv_grad(p, w).float().sum().backward()
    assert fused_conv.phase_pieces_counter.count == int(_pieces(p, 8, 8))


def test_phase_pieces_launcher_refuses_plans_it_did_not_size(cuda):
    """The pieces body's launcher refuses a shared-memory sum other than its
    own, a brick of an odd count of k16 steps and channels other than 8."""
    from segmantic_tpu_torch.ops.fused_conv import phase_pieces_plan, phase_pieces_smem_bytes

    p = torch.zeros((1, 4, 6, 16, 64), dtype=torch.bfloat16, device=cuda)
    dims = (1, 8, 12, 32)
    q = phase_pieces_plan(dims, 8, 8)
    ws = torch.empty(q.workspace, dtype=torch.float32, device=cuda)
    out = torch.empty((3, 3, 3, 8, 8), dtype=torch.float32, device=cuda)
    head = (p.data_ptr(), p.data_ptr(), ws.data_ptr(), out.data_ptr(), *dims)
    _cuda.launch("segk_phase_conv3_dw_pieces", *head, 8, 8, q.td, q.th, q.tw, q.splits, q.stages,
                 q.smem_bytes)
    for args in ((8, 8, q.td, q.th, q.tw, q.splits, q.stages, q.smem_bytes + 1024),
                 (8, 8, 1, 1, 16, 1, 2, phase_pieces_smem_bytes(1, 1, 16, 2)),
                 (16, 16, q.td, q.th, q.tw, q.splits, q.stages, q.smem_bytes)):
        with pytest.raises(RuntimeError, match="CUDA error"):
            _cuda.launch("segk_phase_conv3_dw_pieces", *head, *args)


def _dw_case(layout, shape, co):
    """(module, kernel, plain, full-resolution dims, true C, true CO)."""
    if layout == "dense":
        return (fused_conv, fused_conv.conv3d_dw, fused_conv.conv3d_dw_plain,
                tuple(shape[:4]), shape[-1], co)
    full = (shape[0],) + tuple(2 * v for v in shape[1:4])
    return (phase_conv, phase_conv.phase_conv_dw, phase_conv.phase_conv_dw_plain,
            full, shape[-1] // 8, co // 8)


@pytest.mark.parametrize("layout,shape,co", DW_FLAGSHIP + DW_ODD)
def test_dw_tensor_core_body(cuda, layout, shape, co):
    mod, kernel, plain, dims, c_true, co_true = _dw_case(layout, shape, co)
    g = torch.Generator().manual_seed(16)
    x = _randn(g, *shape).to(torch.bfloat16)
    dy = _randn(g, *shape[:4], co).to(torch.bfloat16)
    deep = layout == "dense" and c_true >= 64 and co_true >= 128  # the deep-channel dw rule
    # the phase dw's Hopper body from Ci = 16 at these volumes (the L = 128 stage)
    hop = (layout == "phase" and c_true >= fused_conv.PHASE_DW_MIN_C
           and x.numel() // x.shape[-1] >= fused_conv.PHASE_DW_MIN_POSITIONS)
    # the dense Hopper dw body at C = CO = 8 or 16 (the 48^3 x 16 stage)
    dense = layout == "dense" and _dense_rows(x, c_true, co_true,
                                              fused_conv.DENSE_DW_MIN_POSITIONS)
    # the dense pairs body at C = CO = 32 (the 24^3 x 32 stage), the phase
    # pieces body at Ci = Co = 8 (L = 64)
    pairs = layout == "dense" and _pairs(x, c_true, co_true)
    pieces = layout == "phase" and _pieces(x, c_true, co_true)
    assert fused_conv.dw_body(x, c_true, co_true, layout == "phase") == (
        "deep_channels" if deep else "phase_blocks" if hop else "dense_rows" if dense
        else "dense_pairs" if pairs else "phase_pieces" if pieces else "tensor_cores")
    mod.dw_counter.reset()
    got = kernel(x, dy)
    assert mod.dw_counter.count == 1 and got.dtype == torch.float32
    assert got.shape == (3, 3, 3, c_true, co_true)
    _close(got, plain(x, dy), 1e-3)
    assert torch.equal(got, kernel(x, dy))  # fixed-order partials: bit-equal
    assert mod.dw_counter.count == 2


# (stored shape of x at the training batch, CO): the stride-1 3^3 conv shapes
# of SegResNet and UNETR at full width that the flagship has not, the input
# layers' C = 1 (the few-channel bodies) and the 96^3 batch-8 ones among them
ARCH_SHAPES = [
    ((8, 96, 96, 96, 1), 8), ((8, 96, 96, 96, 8), 8), ((8, 96, 96, 96, 1), 16),
    ((8, 96, 96, 96, 16), 16), ((8, 96, 96, 96, 32), 16), ((8, 48, 48, 48, 32), 32),
    ((8, 48, 48, 48, 64), 32), ((8, 24, 24, 24, 64), 64), ((8, 24, 24, 24, 128), 64),
    ((8, 12, 12, 12, 32), 32), ((8, 12, 12, 12, 128), 128), ((8, 12, 12, 12, 256), 128),
]


@pytest.mark.parametrize("shape,co", ARCH_SHAPES)
def test_arch_conv_shapes(cuda, shape, co):
    g = torch.Generator().manual_seed(17)
    x = _randn(g, *shape).to(torch.bfloat16)
    w = _randn(g, 3, 3, 3, shape[-1], co, scale=(27 * shape[-1]) ** -0.5).to(torch.bfloat16)
    assert fused_conv.conv_body(x, shape[-1], co) == (
        "few_channels" if shape[-1] < 8 else
        "deep_channels" if min(shape[-1], co) >= 64 else
        "dense_rows" if _dense_rows(x, shape[-1], co, fused_conv.DENSE_MIN_POSITIONS) else
        "mid_channels" if shape[-1] + co >= 48 and fused_conv.mid_eligible(shape[-1], co, False)
        and shape[2] % 8 == 0 and shape[3] % 8 == 0 else "tensor_cores")
    fused_conv.counter.reset()
    got = fused_conv.conv3d(x, w)
    assert fused_conv.counter.count == 1 and got.shape == shape[:4] + (co,)
    _close(got, fused_conv.conv3d_plain(x, w), 2e-2)
    assert torch.equal(got, fused_conv.conv3d(x, w))


@pytest.mark.parametrize("shape,co", ARCH_SHAPES)
def test_arch_dw_shapes(cuda, shape, co):
    g = torch.Generator().manual_seed(18)
    x = _randn(g, *shape).to(torch.bfloat16)
    dy = _randn(g, *shape[:4], co).to(torch.bfloat16)
    mid = shape[-1] % 64 == 0 and co == 64 and x.numel() // shape[-1] >= 32768
    assert fused_conv.dw_body(x, shape[-1], co) == (
        "few_channels" if shape[-1] < 8 else
        "deep_channels" if shape[-1] >= 64 and co >= 128 else
        "dense_rows" if _dense_rows(x, shape[-1], co, fused_conv.DENSE_DW_MIN_POSITIONS) else
        "dense_pairs" if _pairs(x, shape[-1], co) else
        "mid_channels" if mid else "tensor_cores")
    fused_conv.dw_counter.reset()
    got = fused_conv.conv3d_dw(x, dy)
    assert fused_conv.dw_counter.count == 1 and got.shape == (3, 3, 3, shape[-1], co)
    _close(got, fused_conv.conv3d_dw_plain(x, dy), 1e-3)
    assert torch.equal(got, fused_conv.conv3d_dw(x, dy))


# the deep-channel bodies (csrc/conv3_wgmma.cuh, conv3_dw_wgmma.cuh; bf16,
# dense, C >= 64 and CO >= 64, the dw from CO = 128): UNETR's and the
# flagship's deep rows, the input gradients of the CI != CO convs (CO -> C),
# and ragged shapes (extents a multiple of no brick, C = 64 -> 192, CO = 72, a
# second chunk mostly padding at C = 72 or 96, W = 70)
DEEP_ROWS = [
    ((8, 12, 12, 12, 256), 128), ((8, 12, 12, 12, 128), 128), ((8, 24, 24, 24, 128), 64),
    ((8, 24, 24, 24, 64), 64), ((8, 12, 12, 12, 64), 64), ((4, 12, 12, 12, 64), 64),
    ((4, 6, 6, 6, 128), 128), ((4, 6, 6, 6, 128), 256), ((4, 6, 6, 6, 256), 256),
    ((8, 6, 6, 6, 256), 128), ((8, 12, 12, 12, 128), 256), ((8, 24, 24, 24, 64), 128),
]
DEEP_RAGGED = [((2, 5, 7, 9, 64), 192), ((2, 5, 7, 9, 96), 72), ((1, 6, 6, 6, 72), 64),
               ((1, 3, 4, 70, 64), 64)]


@pytest.mark.parametrize("shape,co", DEEP_ROWS + DEEP_RAGGED)
def test_deep_channel_conv_body(cuda, shape, co):
    """The forward on the deep-channel body: bf16 and f32 output against the
    plain version, one counted launch of the body each, bit-equal on repeat
    (the split-K partials are summed in a fixed order)."""
    g = torch.Generator().manual_seed(23)
    c = shape[-1]
    x = _randn(g, *shape).to(torch.bfloat16)
    w = _randn(g, 3, 3, 3, c, co, scale=(27 * c) ** -0.5).to(torch.bfloat16)
    kw = dict(bias=_randn(g, co), scale=_randn(g, co).abs() + 0.5, shift=_randn(g, co),
              alpha=torch.tensor([0.2], device=cuda), relu_mode="prelu")
    assert fused_conv.conv_body(x, c, co) == "deep_channels"
    for out_dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-2)):
        fused_conv.counter.reset()
        fused_conv.deep_counter.reset()
        got = fused_conv.conv3d(x, w, out_dtype=out_dtype, **kw)
        assert fused_conv.counter.count == fused_conv.deep_counter.count == 1
        assert got.dtype == out_dtype and got.shape == shape[:4] + (co,)
        _close(got, fused_conv.conv3d_plain(x, w, out_dtype=out_dtype, **kw), tol)
        assert torch.equal(got, fused_conv.conv3d(x, w, out_dtype=out_dtype, **kw))


@pytest.mark.parametrize("shape,co", DEEP_ROWS + DEEP_RAGGED)
def test_deep_channel_dw_body(cuda, shape, co):
    """The weight gradient on the deep-channel body, 1e-3 * max|ref| (both
    sides sum exactly upcast products in f32), bit-equal on repeat: through
    the wrapper where the rule takes it (CO >= 128), else through its entry
    point with its own plan."""
    g = torch.Generator().manual_seed(24)
    c = shape[-1]
    x = _randn(g, *shape).to(torch.bfloat16)
    dy = _randn(g, *shape[:4], co).to(torch.bfloat16)
    want = fused_conv.conv3d_dw_plain(x, dy)
    if co >= 128:
        assert fused_conv.dw_body(x, c, co) == "deep_channels"
        fused_conv.deep_dw_counter.reset()
        got = fused_conv.conv3d_dw(x, dy)
        assert fused_conv.deep_dw_counter.count == 1
        again = fused_conv.conv3d_dw(x, dy)
    else:  # the tensor-core or, at 24^3 x 64, the mid-channel dw body by the rule
        assert fused_conv.dw_body(x, c, co) in ("tensor_cores", "mid_channels")
        p = fused_conv.deep_dw_plan(tuple(shape[:4]), c, co)
        ws = torch.empty(max(p.workspace, 1), dtype=torch.float32, device=cuda)

        def entry():
            out = torch.empty((3, 3, 3, c, co), dtype=torch.float32, device=cuda)
            _cuda.launch("segk_fused_conv3_dw_wgmma", x.data_ptr(), dy.data_ptr(), ws.data_ptr(),
                         out.data_ptr(), *shape[:4], c, co, p.td, p.th, p.tw, p.nt, p.tpw,
                         p.nwg, p.splits, p.stages, p.smem_bytes)
            return out

        got, again = entry(), entry()
    _close(got, want, 1e-3)
    assert torch.equal(got, again)


@pytest.mark.parametrize("shape,co", [((2, 12, 12, 12, 128), 256), ((4, 6, 6, 6, 256), 128),
                                      ((2, 24, 24, 24, 64), 128)])
def test_deep_channel_bodies_take_the_grad_function(cuda, shape, co):
    """``conv3d_grad`` at deep shapes: its forward and its input gradient (the
    conv CO -> C) launch the deep-channel conv body, its weight gradient the
    deep-channel dw body where CO >= 128; out, dx and dw against autograd
    through the plain version."""
    g = torch.Generator().manual_seed(25)
    c = shape[-1]
    x = _randn(g, *shape).to(torch.bfloat16)
    w = _randn(g, 3, 3, 3, c, co, scale=(27 * c) ** -0.5).to(torch.bfloat16)
    fused_conv.deep_counter.reset()
    fused_conv.deep_dw_counter.reset()
    got = _grads(fused_conv.conv3d_grad, x, w)
    assert fused_conv.deep_counter.count == 2
    assert fused_conv.deep_dw_counter.count == int(co >= 128)
    want = _grads(fused_conv.conv3d_plain, x, w)
    for a, b in zip(got, want):
        _close(a, b, 2e-2)


def test_deep_launchers_refuse_a_plan_with_another_shared_memory_sum(cuda):
    x = torch.zeros((1, 6, 6, 6, 64), dtype=torch.bfloat16, device=cuda)
    w = torch.zeros((3, 3, 3, 64, 64), dtype=torch.bfloat16, device=cuda)
    p = fused_conv.deep_plan((1, 6, 6, 6), 64, 64)
    pk = fused_conv.pack_weights_deep(w, p.nt)
    s, t = fused_conv._epilogue_vectors(64, None, None, None, cuda)
    out = torch.empty_like(x)
    ws = torch.empty(max(p.workspace, 1), dtype=torch.float32, device=cuda)
    args = (x.data_ptr(), pk.data_ptr(), s.data_ptr(), t.data_ptr(), None, 0, out.data_ptr(),
            ws.data_ptr(), 1, 6, 6, 6, 64, 64, 1, p.td, p.th, p.tw, p.nt, p.spw, p.nwg, p.splits,
            p.stages)
    _cuda.launch("segk_fused_conv3_wgmma", *args, p.smem_bytes)
    with pytest.raises(RuntimeError, match="CUDA error"):
        _cuda.launch("segk_fused_conv3_wgmma", *args, p.smem_bytes + 1024)
    q = fused_conv.deep_dw_plan((1, 6, 6, 6), 64, 64)
    dw = torch.empty((3, 3, 3, 64, 64), dtype=torch.float32, device=cuda)
    args = (x.data_ptr(), x.data_ptr(), dw.data_ptr(), dw.data_ptr(), 1, 6, 6, 6, 64, 64, q.td,
            q.th, q.tw, q.nt, q.tpw, q.nwg, 1, q.stages)
    _cuda.launch("segk_fused_conv3_dw_wgmma", *args, q.smem_bytes)
    with pytest.raises(RuntimeError, match="CUDA error"):
        _cuda.launch("segk_fused_conv3_dw_wgmma", *args, q.smem_bytes + 1024)


# (x shape, CO): the stride-1 3^3 convs of a 3D i2i generator's ResNet blocks
# (4 * base channels at a quarter of the input), f32 as i2i trains, so the
# register-tiled f32 bodies: base 16 on a 32^3 input, and the CLI's base 64 on
# 64^3 and 32^3 inputs
I2I_SHAPES = [((1, 8, 8, 8, 64), 64), ((1, 16, 16, 16, 256), 256), ((2, 8, 8, 8, 256), 256)]


@pytest.mark.parametrize("shape,co", I2I_SHAPES)
def test_i2i_generator_conv_shapes_f32(cuda, shape, co):
    g = torch.Generator().manual_seed(19)
    c = shape[-1]
    x = _randn(g, *shape)
    w = _randn(g, 3, 3, 3, c, co, scale=(27 * c) ** -0.5)
    dy = _randn(g, *shape[:4], co)
    assert fused_conv.conv_body(x, c, co) == fused_conv.dw_body(x, c, co) == "f32_tiles"
    for counter in (fused_conv.counter, fused_conv.dw_counter, fused_conv.f32_counter,
                    fused_conv.f32_dw_counter):
        counter.reset()
    got = fused_conv.conv3d(x, w)
    dw = fused_conv.conv3d_dw(x, dy)
    assert fused_conv.counter.count == 1 and fused_conv.dw_counter.count == 1
    assert fused_conv.f32_counter.count == 1 and fused_conv.f32_dw_counter.count == 1
    _close(got, fused_conv.conv3d_plain(x, w), 1e-4)
    _close(dw, fused_conv.conv3d_dw_plain(x, dy), 1e-3)
    assert torch.equal(got, fused_conv.conv3d(x, w))
    assert torch.equal(dw, fused_conv.conv3d_dw(x, dy))


# (layout, stored shape of x, true CO): the f32 bodies at ragged extents, C
# from 1 (4-byte staging, a chunk of one channel) to past a 16-channel chunk,
# CO past an N tile or not a multiple of 4 (scalar stores)
F32_ODD = [("dense", (2, 5, 7, 9, 12), 20), ("dense", (1, 6, 6, 6, 3), 7),
           ("dense", (3, 1, 1, 1, 24), 5), ("dense", (1, 3, 4, 70, 16), 16),
           ("phase", (1, 3, 4, 5, 8), 16), ("phase", (1, 2, 3, 4, 8 * 20), 6)]


@pytest.mark.parametrize("layout,shape,co", F32_ODD)
def test_f32_bodies_at_ragged_shapes(cuda, layout, shape, co):
    """The register-tiled f32 conv and dw bodies against their plain versions
    (f32 1e-4 / 1e-3 * max|ref|), one launch of each body, the epilogue
    (PReLU) after a K split's sum, bit-equal on repeat."""
    g = torch.Generator().manual_seed(23)
    phase = layout == "phase"
    c = shape[-1] // (8 if phase else 1)
    x = _randn(g, *shape)
    w = _randn(g, 3, 3, 3, c, co, scale=(27 * c) ** -0.5)
    dy = _randn(g, *shape[:4], (8 if phase else 1) * co)
    kw = dict(bias=_randn(g, co), scale=_randn(g, co).abs() + 0.5, shift=_randn(g, co),
              alpha=torch.tensor([0.2], device=cuda), relu_mode="prelu")
    conv, plain = ((phase_conv.phase_conv, phase_conv.phase_conv_plain) if phase
                   else (fused_conv.conv3d, fused_conv.conv3d_plain))
    dwk, dwp = ((phase_conv.phase_conv_dw, phase_conv.phase_conv_dw_plain) if phase
                else (fused_conv.conv3d_dw, fused_conv.conv3d_dw_plain))
    assert fused_conv.conv_body(x, c, co, phase) == fused_conv.dw_body(x, c, co, phase) == \
        "f32_tiles"
    fused_conv.f32_counter.reset()
    fused_conv.f32_dw_counter.reset()
    got, dw = conv(x, w, **kw), dwk(x, dy)
    assert fused_conv.f32_counter.count == 1 and fused_conv.f32_dw_counter.count == 1
    _close(got, plain(x, w, **kw), 1e-4)
    _close(dw, dwp(x, dy), 1e-3)
    assert torch.equal(got, conv(x, w, **kw)) and torch.equal(dw, dwk(x, dy))


def test_f32_launchers_refuse_a_plan_they_did_not_size(cuda):
    """The C launchers compute the shared memory of a plan themselves and
    refuse one that disagrees with the wrapper's (the launch never runs)."""
    g = torch.Generator().manual_seed(24)
    dims, c, co = (1, 8, 8, 8), 16, 16
    x, dy = _randn(g, *dims, c), _randn(g, *dims, co)
    w = _randn(g, 3, 3, 3, c, co)
    s, t = fused_conv._epilogue_vectors(co, None, None, None, x.device)
    out = torch.empty_like(dy)
    p = fused_conv.f32_plan(dims, c, co)
    ws = torch.empty(max(p.workspace, 1), device=cuda)
    args = (x.data_ptr(), w.data_ptr(), s.data_ptr(), t.data_ptr(), None, 0, out.data_ptr(),
            ws.data_ptr(), *dims, c, co, 0, 0, p.td, p.th, p.tw, p.nt, p.ck, p.splits, p.stages)
    _cuda.launch("segk_fused_conv3_f32", *args, p.smem_bytes)
    with pytest.raises(RuntimeError, match="CUDA error"):
        _cuda.launch("segk_fused_conv3_f32", *args, p.smem_bytes + 16)
    q = fused_conv.f32_dw_plan(dims, c, co)
    dws = torch.empty(max(q.workspace, 1), device=cuda)
    dout = torch.empty((3, 3, 3, c, co), device=cuda)
    args = (x.data_ptr(), dy.data_ptr(), dws.data_ptr(), dout.data_ptr(), *dims, c, co, 0, q.td,
            q.th, q.tw, q.taps, q.ci, q.nt, q.npg, q.splits, q.stages)
    _cuda.launch("segk_fused_conv3_dw_f32", *args, q.smem_bytes)
    with pytest.raises(RuntimeError, match="CUDA error"):
        _cuda.launch("segk_fused_conv3_dw_f32", *args, q.smem_bytes + 16)


def test_i2i_3d_generator_runs_its_block_convs_on_the_kernels(cuda):
    """A 3D i2i generator (base 16, 2 blocks) on the card: its four stride-1
    3^3 convs launch kernel 1 once each a forward, and once more each (input
    gradient) plus kernel 2 once each in the backward; output and every
    parameter gradient against the same module on the CPU (f32), within 1e-3
    * max(max|ref| of the tensor, 1e-2 * max|ref| over all gradients): the
    floor takes in the conv biases in front of an InstanceNorm, whose true
    gradient is zero and whose f32 gradients are rounding noise."""
    from segmantic_tpu_torch.i2i.models import ResnetGenerator

    gen = ResnetGenerator(1, 1, 16, 2, spatial_dims=3, generator=torch.Generator().manual_seed(3))
    x = torch.randn((1, 32, 32, 32, 1), generator=torch.Generator().manual_seed(4))
    r = torch.randn((1, 32, 32, 32, 1), generator=torch.Generator().manual_seed(5))
    (gen(x) * r).sum().backward()
    want = [gen(x).detach()] + [p.grad.clone() for p in gen.parameters()]
    gen = gen.to(cuda)
    gen.zero_grad(set_to_none=True)
    fused_conv.counter.reset()
    fused_conv.dw_counter.reset()
    y = gen(x.to(cuda))
    assert fused_conv.counter.count == 4
    (y * r.to(cuda)).sum().backward()
    assert fused_conv.counter.count == 8 and fused_conv.dw_counter.count == 4
    _close(y.detach(), want[0].to(cuda), 1e-4)
    floor = 1e-2 * max(g.abs().max().item() for g in want[1:])
    for p, ref in zip(gen.parameters(), want[1:]):
        err = (p.grad.cpu() - ref).abs().max().item()
        assert err <= 1e-3 * max(ref.abs().max().item(), floor), err


@pytest.mark.parametrize("shape,co", [((2, 10, 11, 13, 12), 16), ((2, 5, 7, 9, 16), 20)])
def test_dw_other_channel_counts_keep_the_cuda_core_body(cuda, shape, co):
    g = torch.Generator().manual_seed(17)
    x = _randn(g, *shape).to(torch.bfloat16)
    dy = _randn(g, *shape[:4], co).to(torch.bfloat16)
    assert fused_conv.dw_body(x, shape[-1], co) == "f32_tiles"
    fused_conv.dw_counter.reset()
    got = fused_conv.conv3d_dw(x, dy)
    assert fused_conv.dw_counter.count == 1
    _close(got, fused_conv.conv3d_dw_plain(x, dy), 1e-3)
    assert torch.equal(got, fused_conv.conv3d_dw(x, dy))


# (layout, stored shape of x, true CO): the few-channel bodies (bf16, C = 1..7)
# at ragged extents, W * C whole 16-byte pieces or not, CO below, at and over
# an N tile, the one-class UNet's 1 -> 1, and the three 96^3 rows
FEWC = [
    ("dense", (2, 5, 7, 9, 1), 8), ("dense", (2, 5, 7, 9, 3), 5), ("dense", (2, 6, 10, 32, 2), 16),
    ("dense", (1, 4, 6, 17, 7), 24), ("dense", (2, 5, 7, 16, 1), 1), ("dense", (1, 9, 40, 48, 2), 16),
    ("phase", (2, 3, 4, 5, 8), 16), ("phase", (1, 3, 4, 8, 16), 8), ("phase", (1, 2, 3, 4, 56), 5),
    ("phase", (1, 3, 4, 5, 8), 1), ("phase", (1, 5, 7, 18, 24), 20),
    ("dense", (8, 96, 96, 96, 1), 8), ("dense", (8, 96, 96, 96, 1), 16),
    ("phase", (8, 48, 48, 48, 8), 16),
]


@pytest.mark.parametrize("layout,shape,co", FEWC)
def test_few_channel_bodies(cuda, layout, shape, co):
    """The conv (bf16 and f32 out, prelu epilogue) and the weight gradient
    against their plain versions, one counted launch each, bit-equal on
    repeat."""
    g = torch.Generator().manual_seed(22)
    x = _randn(g, *shape).to(torch.bfloat16)
    c = shape[-1] // 8 if layout == "phase" else shape[-1]
    stored_co = 8 * co if layout == "phase" else co
    dy = _randn(g, *shape[:4], stored_co).to(torch.bfloat16)
    w = _randn(g, 3, 3, 3, c, co, scale=(27 * c) ** -0.5).to(torch.bfloat16)
    kw = dict(bias=_randn(g, co), scale=_randn(g, co).abs() + 0.5, shift=_randn(g, co),
              alpha=torch.tensor([0.2], device=cuda), relu_mode="prelu")
    mod = phase_conv if layout == "phase" else fused_conv
    conv, plain = ((phase_conv.phase_conv, phase_conv.phase_conv_plain) if layout == "phase"
                   else (fused_conv.conv3d, fused_conv.conv3d_plain))
    dwk, dwp = ((phase_conv.phase_conv_dw, phase_conv.phase_conv_dw_plain) if layout == "phase"
                else (fused_conv.conv3d_dw, fused_conv.conv3d_dw_plain))
    assert fused_conv.conv_body(x, c, co, layout == "phase") == \
        fused_conv.dw_body(x, c, co, layout == "phase") == "few_channels"
    for out_dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-2)):
        mod.counter.reset()
        got = conv(x, w, out_dtype=out_dtype, **kw)
        assert mod.counter.count == 1 and got.dtype == out_dtype
        _close(got, plain(x, w, out_dtype=out_dtype, **kw), tol)
        assert torch.equal(got, conv(x, w, out_dtype=out_dtype, **kw))
    mod.dw_counter.reset()
    got = dwk(x, dy)
    assert mod.dw_counter.count == 1 and got.shape == (3, 3, 3, c, co)
    _close(got, dwp(x, dy), 1e-3)
    assert torch.equal(got, dwk(x, dy))


def test_few_channel_launchers_refuse_a_plan_with_another_shared_memory_sum(cuda):
    x = torch.zeros((1, 4, 6, 16, 1), dtype=torch.bfloat16, device=cuda)
    dims = (1, 4, 6, 16)
    p = fused_conv.fewc_plan(dims, 1, 8)
    wp = fused_conv.pack_weights(torch.zeros((3, 3, 3, 1, 8), dtype=torch.bfloat16,
                                             device=cuda), p.nt)
    out = torch.empty((1, 4, 6, 16, 8), dtype=torch.bfloat16, device=cuda)
    s, t = fused_conv._epilogue_vectors(8, None, None, None, cuda)
    args = (x.data_ptr(), wp.data_ptr(), s.data_ptr(), t.data_ptr(), None, 0, out.data_ptr(),
            *dims, 1, 8, 1, p.th, p.tw, p.seg, p.nt, p.grid_x)
    _cuda.launch("segk_fused_conv3_fewc", *args, p.smem_bytes, 1)
    with pytest.raises(RuntimeError, match="CUDA error"):
        _cuda.launch("segk_fused_conv3_fewc", *args, p.smem_bytes + 16, 1)
    q = fused_conv.fewc_dw_plan(dims, 1, 8)
    dw = torch.empty((3, 3, 3, 1, 8), device=cuda)
    args = (x.data_ptr(), out.data_ptr(), dw.data_ptr(), dw.data_ptr(), *dims, 1, 8, q.th, q.tw,
            q.seg, q.nt, 1)
    _cuda.launch("segk_fused_conv3_dw_fewc", *args, q.smem_bytes, 1, 1)
    with pytest.raises(RuntimeError, match="CUDA error"):
        _cuda.launch("segk_fused_conv3_dw_fewc", *args, q.smem_bytes - 16, 1, 1)


def test_dw_launcher_refuses_a_plan_with_another_shared_memory_sum(cuda):
    x = torch.zeros((1, 6, 6, 6, 16), dtype=torch.bfloat16, device=cuda)
    out = torch.zeros((3, 3, 3, 16, 16), device=cuda)
    p = fused_conv.dw_plan((1, 6, 6, 6), 16, 16)
    args = (x.data_ptr(), x.data_ptr(), out.data_ptr(), out.data_ptr(), 1, 6, 6, 6, 16, 16,
            p.td, p.th, p.tw, p.ck, p.nt, 1, p.stages)
    _cuda.launch("segk_fused_conv3_dw_mma", *args, p.smem_bytes)
    with pytest.raises(RuntimeError, match="CUDA error"):
        _cuda.launch("segk_fused_conv3_dw_mma", *args, p.smem_bytes + 16)
    with pytest.raises(ValueError, match="2\\^31"):
        fused_conv.launch_conv3_dw("segk_fused_conv3_dw", x, x, (1, 2048, 2048, 64), 16, 16)


@pytest.mark.parametrize("name", ["conv3d_grad", "phase_conv_grad"])
def test_bf16_grad_functions_take_the_tensor_core_dw_body(cuda, name):
    """The Function's weight gradient is the dw wrapper's result rounded to
    bf16, bit for bit (the launch is deterministic)."""
    g = torch.Generator().manual_seed(18)
    if name == "conv3d_grad":
        mod, fn, dw = fused_conv, fused_conv.conv3d_grad, fused_conv.conv3d_dw
        x, c, co = _randn(g, 2, 8, 10, 12, 16).to(torch.bfloat16), 16, 24
    else:
        mod, fn, dw = phase_conv, phase_conv.phase_conv_grad, phase_conv.phase_conv_dw
        x, c, co = _randn(g, 2, 4, 6, 8, 64).to(torch.bfloat16), 8, 8
    w = _randn(g, 3, 3, 3, c, co, scale=0.1).to(torch.bfloat16).requires_grad_()
    assert fused_conv.dw_body(x, c, co) == "tensor_cores"
    out = fn(x, w)
    cot = _randn(g, *out.shape).to(torch.bfloat16)
    mod.dw_counter.reset()
    out.backward(cot)
    assert mod.dw_counter.count == 1
    assert torch.equal(w.grad, dw(x, cot).to(torch.bfloat16))


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


# (stored phase tensor, CI, CO): the phase-space convs of packed UNETR
# (feature 16) at batch 2; CI = 1 (the input layer) runs the few-channel bodies
UNETR_PACK_SHAPES = [((2, 48, 48, 48, 8), 1, 16), ((2, 48, 48, 48, 128), 16, 16),
                     ((2, 48, 48, 48, 256), 32, 16), ((2, 24, 24, 24, 256), 32, 32),
                     ((2, 24, 24, 24, 512), 64, 32)]


@pytest.mark.parametrize("shape,ci,co", UNETR_PACK_SHAPES)
def test_unetr_pack_phase_shapes(cuda, shape, ci, co):
    """Kernels 3-6 at packed UNETR's shapes, bf16: the forward, the input
    gradient (the forward on the flipped, io-swapped kernel) and the weight
    gradient against their plain versions, each launch bit-equal on repeat."""
    g = torch.Generator().manual_seed(21)
    p = _randn(g, *shape).to(torch.bfloat16)
    w = _randn(g, 3, 3, 3, ci, co, scale=(27 * ci) ** -0.5).to(torch.bfloat16)
    gy = _randn(g, *shape[:4], 8 * co).to(torch.bfloat16)
    wt = fused_conv.flip_io(w)
    assert fused_conv.conv_body(p, ci, co, True) == (
        "few_channels" if ci % 8 else "mid_channels" if ci + co >= 48 else "phase_lanes"
        if fused_conv.phase_fwd_eligible(ci, co) else "tensor_cores")
    phase_conv.counter.reset()
    phase_conv.dw_counter.reset()
    got, dx, dw = phase_conv.phase_conv(p, w), phase_conv.phase_conv(gy, wt), \
        phase_conv.phase_conv_dw(p, gy)
    assert phase_conv.counter.count == 2 and phase_conv.dw_counter.count == 1
    assert got.shape == shape[:4] + (8 * co,) and dx.shape == shape
    _close(got, phase_conv.phase_conv_plain(p, w), 2e-2)
    _close(dx, phase_conv.phase_conv_plain(gy, wt), 2e-2)
    _close(dw, phase_conv.phase_conv_dw_plain(p, gy), 1e-3)
    assert torch.equal(got, phase_conv.phase_conv(p, w))
    assert torch.equal(dx, phase_conv.phase_conv(gy, wt))
    assert torch.equal(dw, phase_conv.phase_conv_dw(p, gy))


def test_packed_unetr_step_runs_on_the_phase_and_dice_kernels(cuda):
    """One f32 step of a small packed UNETR (32^3, feature 8) on the card:
    kernels 3-4 run its 8 phase-space convs forward and 7 backward (the
    one-channel input conv takes no input gradient), kernels 5-6 their 8
    weight gradients, kernel 9 the loss once each; the loss and every gradient against the same step on the
    CPU, within 1e-3 * max(max|ref| of the tensor, 1e-2 * max|ref| over all
    gradients) (the floor takes in the conv biases in front of an
    InstanceNorm, whose true gradient is zero)."""
    from segmantic_tpu_torch.models.unetr import UNETR
    from segmantic_tpu_torch.train.augment import AugmentConfig
    from segmantic_tpu_torch.train.trainer import make_train_step

    gen = torch.Generator().manual_seed(8)
    x = torch.randn((2, 32, 32, 32, 1), generator=gen)
    y = torch.randint(0, 3, (2, 32, 32, 32), generator=gen).to(torch.uint8)
    out = []
    for device in ("cpu", cuda):
        model = UNETR((32, 32, 32), out_channels=3, hidden_size=32, num_layers=4,
                      num_heads=4, mlp_dim=64, feature_size=8,
                      generator=torch.Generator().manual_seed(9)).to(device).train()
        step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=0.0),
                               AugmentConfig(flip_prob=0.0), (32, 32, 32), False)
        for c in (phase_conv.counter, phase_conv.dw_counter, phase_dice.sums_counter,
                  phase_dice.dx_counter):
            c.reset()
        loss = step(x, y).item()
        out.append((loss, {k: p.grad.cpu() for k, p in model.named_parameters()}))
    assert model.pack and model.phase_top_ok()
    assert (phase_conv.counter.count, phase_conv.dw_counter.count) == (15, 8)
    assert (phase_dice.sums_counter.count, phase_dice.dx_counter.count) == (1, 1)
    (want_loss, want), (got_loss, got) = out
    assert abs(got_loss - want_loss) <= 1e-5 * abs(want_loss)
    floor = 1e-2 * max(g.abs().max().item() for g in want.values())
    for k, ref in want.items():
        err = (got[k] - ref).abs().max().item()
        assert err <= 1e-3 * max(ref.abs().max().item(), floor), k


def _group_inputs(g, full, out_shape, samples, channels, dtype, cuda):
    """A batch, per-sample coefficients and the three groups' specs of the
    chain for ``full`` -> ``out_shape`` at the augmentation's default bounds."""
    passes, divz, _, groups = shear_resample.chain_plan(full, 3, out_shape, 0.4, 0.8)
    angles = (torch.rand((samples, 3), generator=g) * 0.8 - 0.4).to(cuda)
    zoom = (torch.rand((samples,), generator=g) * 0.5 + 0.8).to(cuda)
    coef = shear_resample.shear_coefficients(angles, zoom, passes, divz)
    if dtype.is_floating_point:
        x = _randn(g, samples, channels, *full).to(dtype)
    else:
        x = torch.randint(0, 9, (samples, channels, *full), generator=g).to(cuda, dtype)
    return x, coef, zoom, groups


@pytest.mark.parametrize("dtype,order,bf16", [
    (torch.float32, 1, False), (torch.float32, 1, True), (torch.bfloat16, 1, True),
    (torch.float32, 0, False), (torch.uint8, 0, False), (torch.int32, 0, False),
])
@pytest.mark.parametrize("full,out_shape", [
    ((20, 22, 24), (12, 12, 14)),  # shrinking windows, folded zoom
    ((15, 18, 17), None),  # full frame, odd extents
    ((40, 40, 40), (26, 26, 26)),
])
def test_shear_group(cuda, full, out_shape, dtype, order, bf16):
    g = torch.Generator().manual_seed(10)
    x, coef, zoom, groups = _group_inputs(g, full, out_shape, 3, 2, dtype, cuda)
    for i, (a_axis, b_axis, specs) in enumerate(groups):
        c = coef[:, 3 * i: 3 * i + 3].contiguous()
        fused_shear.counter.reset()
        got = fused_shear.shear_group(x, a_axis, b_axis, c, zoom, specs, order, bf16)
        torch.cuda.synchronize()
        assert fused_shear.counter.count == 1
        want = fused_shear.shear_group_plain(x, a_axis, b_axis, c, zoom, specs, order, bf16)
        assert got.shape == want.shape and got.dtype == want.dtype == dtype
        if order == 0 or bf16:
            assert torch.equal(got, want), (i, (got.float() - want.float()).abs().max())
        else:
            _close(got, want, 1e-6)
        assert torch.equal(got, fused_shear.shear_group(x, a_axis, b_axis, c, zoom, specs,
                                                        order, bf16))
        x = want.contiguous()  # the next group's input, as the chain hands it on


@pytest.mark.parametrize("dtype,order,bf16", [
    (torch.float32, 1, False), (torch.bfloat16, 1, True), (torch.float32, 0, False),
    (torch.bfloat16, 0, False), (torch.uint8, 0, False), (torch.int32, 0, False),
])
@pytest.mark.parametrize("full,out_shape", [
    ((300, 20, 6), None),  # lines beyond a warp's registers: a block per line
    ((18, 21), (12, 13)),  # 2D
    ((9, 11, 3), None),  # ragged chunks of the third axis: 3 = 2 + 1 (bf16), 3 of 4 (uint8)
    ((64, 48, 32), (40, 30, 20)),  # 16-byte rows in and out, shrinking windows
    ((133, 20, 24), None),  # two planes a block where blocks abound: 133 = 66 pairs + 1
    ((384, 384), (256, 256)),  # 2D flagship: planes beyond 2 bytes in global scratch
])
def test_shear_group_planned_shapes(cuda, full, out_shape, dtype, order, bf16):
    g = torch.Generator().manual_seed(23)
    n_rot = 3 if len(full) == 3 else 1
    passes, divz, _, groups = shear_resample.chain_plan(full, n_rot, out_shape, 0.4, 0.8)
    angles = (torch.rand((2, n_rot), generator=g) * 0.8 - 0.4).to(cuda)
    zoom = (torch.rand((2,), generator=g) * 0.5 + 0.8).to(cuda)
    coef = shear_resample.shear_coefficients(angles, zoom, passes, divz)
    if dtype.is_floating_point:
        x = _randn(g, 2, 2, *full).to(dtype)
    else:
        x = torch.randint(0, 9, (2, 2, *full), generator=g).to(cuda, dtype)
    for i, (a_axis, b_axis, specs) in enumerate(groups):
        c = coef[:, 3 * i: 3 * i + 3].contiguous()
        fused_shear.counter.reset()
        got = fused_shear.shear_group(x, a_axis, b_axis, c, zoom, specs, order, bf16)
        torch.cuda.synchronize()
        assert fused_shear.counter.count == 1
        want = fused_shear.shear_group_plain(x, a_axis, b_axis, c, zoom, specs, order, bf16)
        assert got.shape == want.shape and got.dtype == dtype
        if order == 0 or bf16:
            assert torch.equal(got, want), (i, (got.float() - want.float()).abs().max())
        else:
            _close(got, want, 1e-6)
        x = want.contiguous()


def test_shear_group_takes_an_unaligned_view(cuda):
    """x off a 16-byte boundary: element loads, the same result."""
    g = torch.Generator().manual_seed(24)
    x, coef, zoom, groups = _group_inputs(g, (16, 16, 16), None, 2, 1, torch.bfloat16, cuda)
    store = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)
    view = store[1:].view(x.shape)
    view.copy_(x)
    assert view.data_ptr() % 16 != 0
    a_axis, b_axis, specs = groups[0]
    c = coef[:, :3].contiguous()
    got = fused_shear.shear_group(view, a_axis, b_axis, c, zoom, specs, 1, True)
    assert torch.equal(got, fused_shear.shear_group(x, a_axis, b_axis, c, zoom, specs, 1, True))
    assert torch.equal(got, fused_shear.shear_group_plain(x, a_axis, b_axis, c, zoom, specs, 1,
                                                          True))


def test_shear_group_plans_leave_two_blocks_per_sm_on_the_card(cuda):
    """The 144^3 -> 96^3 chain's three groups, every type: the resident blocks
    per SM the runtime counts (registers included) are at least two and no
    more than the plan's count by shared memory and threads."""
    _, _, _, groups = shear_resample.chain_plan((144,) * 3, 3, (96,) * 3, 0.4, 0.8)
    codes = {torch.float32: 0, torch.bfloat16: 1, torch.uint8: 2, torch.int32: 3}
    for dtype, code in codes.items():
        dims = (144, 144, 144)
        for a_axis, b_axis, specs in groups:
            p = fused_shear.group_plan(dims, a_axis, b_axis, specs, dtype, 5)
            for order in ((0, 1) if dtype.is_floating_point else (0,)):
                card = _cuda.query("segk_shear_group_blocks_per_sm", code, p.wc, p.cp, order,
                                   p.threads, p.smem_bytes)
                assert 2 <= card <= p.blocks_per_sm, (dtype, dims, order, card, p)
            dims = p.out_dims


def test_shear_group_global_plans_leave_two_blocks_per_sm_on_the_card(cuda):
    """The 2D flagship's 384^2 -> 256^2 group in bf16 and f32 keeps its plane
    in global scratch; the runtime counts at least two resident blocks per SM
    of that kernel, and no more than the plan does."""
    _, _, _, groups = shear_resample.chain_plan((384, 384), 1, (256, 256), 0.4, 0.8)
    a_axis, b_axis, specs = groups[0]
    for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
        p = fused_shear.group_plan((384, 384, 1), a_axis, b_axis, specs, dtype, 16)
        assert p.global_plane
        for order in (0, 1):
            card = _cuda.query("segk_shear_group_global_blocks_per_sm", code, order, p.threads,
                               p.smem_bytes)
            assert 2 <= card <= p.blocks_per_sm, (dtype, order, card, p)


def test_shear_launcher_refuses_a_plan_with_another_shared_memory_sum(cuda):
    import ctypes

    x = torch.zeros((1, 1, 16, 16, 16), dtype=torch.bfloat16, device=cuda)
    y = torch.zeros_like(x)
    coef, zoom = torch.zeros((1, 3), device=cuda), torch.ones((1,), device=cuda)
    specs = ((False, None, None),) * 3
    p = fused_shear.group_plan((16, 16, 16), 1, 2, specs, torch.bfloat16, 1)
    passes = (ctypes.c_int * 15)(*p.passes)
    strides = (ctypes.c_int * 8)(*p.in_strides, *p.out_strides)
    args = (x.data_ptr(), y.data_ptr(), coef.data_ptr(), zoom.data_ptr(), passes, strides,
            1, 1, 1, 16, p.wc, p.cp, 1, 1, p.row_units, int(p.block_lines), p.threads,
            int(p.vec_in), int(p.vec_out))
    _cuda.launch("segk_shear_group", *args, p.smem_bytes)
    with pytest.raises(RuntimeError, match="CUDA error"):
        _cuda.launch("segk_shear_group", *args, p.smem_bytes + 16)


def test_shear_group_refuses(cuda):
    g = torch.Generator().manual_seed(11)
    x, coef, zoom, groups = _group_inputs(g, (8, 8, 8), None, 2, 1, torch.uint8, cuda)
    a_axis, b_axis, specs = groups[0]
    with pytest.raises(TypeError):  # order 1 on an integer type
        fused_shear.shear_group(x, a_axis, b_axis, coef[:, :3].contiguous(), zoom, specs, 1)
    with pytest.raises(TypeError):
        fused_shear.shear_group(x.to(torch.float64), a_axis, b_axis,
                                coef[:, :3].contiguous(), zoom, specs, 0)


def _dice_inputs(g, shape, n_phase, classes, dtype, cuda):
    xp = _randn(g, *shape, n_phase * classes, scale=2.0).to(dtype)
    yp = torch.randint(0, classes, (*shape, n_phase), generator=g).to(cuda, torch.uint8)
    return xp, yp


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,n_phase,classes", [
    ((2, 6, 8, 10), 8, 8),  # the flagship's lanes: one 16-byte load per voxel in bf16
    ((3, 5, 7, 9), 8, 5),  # classes below a power of two
    ((1, 9, 11), 4, 3),  # 2D phases
    ((2, 24, 24, 24), 8, 16),  # several blocks per sample
    ((1, 3, 4, 5), 8, 32),
])
def test_dice_phase_sums(cuda, shape, n_phase, classes, dtype):
    g = torch.Generator().manual_seed(12)
    xp, yp = _dice_inputs(g, shape, n_phase, classes, dtype, cuda)
    phase_dice.sums_counter.reset()
    got = phase_dice.dice_phase_sums(xp, yp)
    torch.cuda.synchronize()
    assert phase_dice.sums_counter.count == 1
    want = phase_dice.dice_phase_sums_plain(xp, yp)
    for a, b in zip(got, want):
        assert a.shape == (shape[0], classes) and a.dtype == torch.float32
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    assert torch.equal(got[2], want[2])  # label counts are whole numbers
    again = phase_dice.dice_phase_sums(xp, yp)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_phase", [1, 4, 8])
@pytest.mark.parametrize("classes", [2, 3, 8, 32])
def test_dice_phase_ragged(cuda, classes, n_phase, dtype):
    """A voxel count that is no multiple of the unroll or of a block's run,
    several blocks per sample, every phase count and lane width: sums and dx."""
    g = torch.Generator().manual_seed(16)
    shape = (3, 37, 41, 5)  # 7585 coarse voxels a sample
    xp, yp = _dice_inputs(g, shape, n_phase, classes, dtype, cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = phase_dice.sums_plan(3, 7585 * n_phase, classes, sms)
    assert (7585 * n_phase) % (phase_dice.THREADS * plan.unroll) != 0
    got = phase_dice.dice_phase_sums(xp, yp)
    want = phase_dice.dice_phase_sums_plain(xp, yp)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * b.abs().max().item())
    assert torch.equal(got[2], want[2])
    assert all(torch.equal(a, b) for a, b in zip(got, phase_dice.dice_phase_sums(xp, yp)))
    hot = _randn(g, 3, n_phase * classes)
    cold = _randn(g, 3, n_phase * classes)
    dx = phase_dice.dice_phase_dx(xp, yp, hot, cold)
    _close(dx, phase_dice.dice_phase_dx_plain(xp, yp, hot, cold),
           1e-5 if dtype == torch.float32 else 2e-2)


def test_dice_sums_launcher_refuses_a_plan_with_another_unroll(cuda):
    g = torch.Generator().manual_seed(19)
    xp, yp = _dice_inputs(g, (1, 4, 4, 4), 8, 8, torch.float32, cuda)
    partial = torch.empty((1, 1, 3, 8), device=cuda)
    out = torch.empty((3, 1, 8), device=cuda)
    with pytest.raises(RuntimeError, match="segk_dice_phase_sums"):
        _cuda.launch("segk_dice_phase_sums", xp.data_ptr(), yp.data_ptr(), partial.data_ptr(),
                     out.data_ptr(), 0, 1, 8, 8, 512, 1024, 1, 3)


def test_dice_phase_dx_takes_a_phase_count_the_block_is_no_multiple_of(cuda):
    """P = 3: a thread's phase changes from voxel to voxel."""
    g = torch.Generator().manual_seed(17)
    xp, yp = _dice_inputs(g, (2, 11, 13, 17), 3, 5, torch.float32, cuda)
    hot, cold = _randn(g, 2, 15), _randn(g, 2, 15)
    _close(phase_dice.dice_phase_dx(xp, yp, hot, cold),
           phase_dice.dice_phase_dx_plain(xp, yp, hot, cold), 1e-5)


def test_dice_kernels_are_captured_in_a_cuda_graph(cuda):
    """The sums allocate their scratch and result inside the call: both
    record into a graph, and a replay sees new logits in the same storage."""
    g = torch.Generator().manual_seed(18)
    xp, yp = _dice_inputs(g, (2, 12, 12, 12), 8, 8, torch.bfloat16, cuda)
    hot, cold = _randn(g, 2, 64), _randn(g, 2, 64)
    phase_dice.dice_phase_sums(xp, yp)
    phase_dice.dice_phase_dx(xp, yp, hot, cold)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        sums = phase_dice.dice_phase_sums(xp, yp)
        dx = phase_dice.dice_phase_dx(xp, yp, hot, cold)
    xp.copy_(_randn(g, *xp.shape, scale=2.0))
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(sums, phase_dice.dice_phase_sums(xp, yp)):
        assert torch.equal(a, b)
    assert torch.equal(dx, phase_dice.dice_phase_dx(xp, yp, hot, cold))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape,n_phase,classes", [
    ((2, 6, 8, 10), 8, 8), ((3, 5, 7, 9), 8, 5), ((1, 9, 11), 4, 3),
    ((2, 24, 24, 24), 8, 16), ((1, 3, 4, 5), 8, 32),
])
def test_dice_phase_dx(cuda, shape, n_phase, classes, dtype, tol):
    g = torch.Generator().manual_seed(13)
    xp, yp = _dice_inputs(g, shape, n_phase, classes, dtype, cuda)
    hot = _randn(g, shape[0], n_phase * classes)
    cold = _randn(g, shape[0], n_phase * classes)
    phase_dice.dx_counter.reset()
    got = phase_dice.dice_phase_dx(xp, yp, hot, cold)
    assert phase_dice.dx_counter.count == 1 and got.dtype == dtype and got.shape == xp.shape
    _close(got, phase_dice.dice_phase_dx_plain(xp, yp, hot, cold), tol)
    assert torch.equal(got, phase_dice.dice_phase_dx(xp, yp, hot, cold))


def test_dice_phase_refuses(cuda):
    g = torch.Generator().manual_seed(14)
    xp, yp = _dice_inputs(g, (1, 2, 2, 2), 8, 33, torch.float32, cuda)
    with pytest.raises(ValueError, match="classes"):
        phase_dice.dice_phase_sums(xp, yp)
    xp, yp = _dice_inputs(g, (1, 2, 2, 2), 8, 4, torch.float64, cuda)
    with pytest.raises(TypeError):
        phase_dice.dice_phase_sums(xp, yp)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("include_background", [True, False])
def test_dice_loss_phase_function(cuda, dtype, tol, include_background):
    """The loss and its gradient through the kernels against autograd through
    the plain softmax Dice on the same phase voxels."""
    g = torch.Generator().manual_seed(15)
    xp, yp = _dice_inputs(g, (2, 6, 6, 6), 8, 8, dtype, cuda)
    xp.requires_grad_()
    phase_dice.sums_counter.reset()
    phase_dice.dx_counter.reset()
    loss = losses.dice_loss_phase(xp, yp, include_background=include_background)
    loss.backward()
    assert phase_dice.sums_counter.count == 1 and phase_dice.dx_counter.count == 1
    ref_x = xp.detach().clone().requires_grad_()
    onehot = torch.nn.functional.one_hot(yp.long(), 8).float()
    ref = losses.dice_loss(ref_x.reshape(2, 6, 6, 6, 8, 8), onehot,
                           include_background=include_background)
    ref.backward()
    torch.testing.assert_close(loss, ref, rtol=1e-5, atol=1e-6)
    _close(xp.grad, ref_x.grad, tol)


# the mid-channel bodies (csrc/conv3_mid.cuh, conv3_mid_dw.cuh): the forward
# at packed UNETR's phase-space rows with a 32-channel side (batch 2), the
# 24^3 / 12^3 x 32 convs, and ragged shapes (extents a multiple of no brick,
# C = 40 in chunks of 16, CO = 5 and 72, C = 8's paired taps, phase CO = 24);
# the dw at 24^3 x 64 and 128 -> 64 (the rule's rows, batch 8) and ragged
# shapes through its entry point
MID_ROWS = [("phase", (2, 48, 48, 48, 256), 16), ("phase", (2, 48, 48, 48, 128), 32),
            ("phase", (2, 24, 24, 24, 256), 32), ("phase", (2, 24, 24, 24, 512), 32),
            ("phase", (2, 24, 24, 24, 256), 64), ("dense", (8, 24, 24, 24, 32), 32),
            ("dense", (8, 12, 12, 12, 32), 32)]
MID_RAGGED = [("dense", (2, 5, 7, 9, 40), 24), ("dense", (1, 3, 9, 13, 48), 5),
              ("dense", (1, 4, 5, 70, 32), 72), ("dense", (2, 5, 7, 9, 8), 40),
              ("phase", (1, 3, 5, 7, 256), 24), ("phase", (2, 2, 3, 5, 128), 40)]


@pytest.mark.parametrize("layout,shape,co", MID_ROWS + MID_RAGGED)
def test_mid_channel_conv_body(cuda, layout, shape, co):
    """The forward on the mid-channel body: through the wrapper where the rule
    takes it (C + CO >= 48, H and W multiples of 8: bf16 and f32 output
    against the plain version, one counted launch of the body each), else
    through its entry point with its own plan (no epilogue); bit-equal on
    repeat either way."""
    g = torch.Generator().manual_seed(31)
    phase = layout == "phase"
    c = shape[-1] // (8 if phase else 1)
    x = _randn(g, *shape).to(torch.bfloat16)
    w = _randn(g, 3, 3, 3, c, co, scale=(27 * c) ** -0.5).to(torch.bfloat16)
    kw = dict(bias=_randn(g, co), scale=_randn(g, co).abs() + 0.5, shift=_randn(g, co),
              alpha=torch.tensor([0.2], device=cuda), relu_mode="prelu")
    mod = phase_conv if phase else fused_conv
    conv, plain = ((phase_conv.phase_conv, phase_conv.phase_conv_plain) if phase
                   else (fused_conv.conv3d, fused_conv.conv3d_plain))
    if fused_conv.conv_body(x, c, co, phase) == "mid_channels":
        for out_dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-2)):
            mod.counter.reset()
            fused_conv.mid_counter.reset()
            got = conv(x, w, out_dtype=out_dtype, **kw)
            assert mod.counter.count == fused_conv.mid_counter.count == 1
            assert got.dtype == out_dtype
            assert got.shape == shape[:4] + ((8 if phase else 1) * co,)
            _close(got, plain(x, w, out_dtype=out_dtype, **kw), tol)
            assert torch.equal(got, conv(x, w, out_dtype=out_dtype, **kw))
        return
    f = 2 if phase else 1
    dims = (shape[0], f * shape[1], f * shape[2], f * shape[3])
    p = fused_conv.mid_plan(dims, c, co, phase)
    packed = fused_conv.pack_weights_mid(w, p.nt, p.ck)
    s, t = fused_conv._epilogue_vectors(co, None, None, None, x.device)
    entry = "segk_phase_conv3_mid" if phase else "segk_fused_conv3_mid"

    def run():
        out = torch.empty(shape[:4] + ((8 if phase else 1) * co,), dtype=torch.bfloat16,
                          device=cuda)
        _cuda.launch(entry, x.data_ptr(), packed.data_ptr(), s.data_ptr(), t.data_ptr(), None, 0,
                     out.data_ptr(), *dims, c, co, 1, p.td, p.th, p.tw, p.ck, p.nt, p.spw,
                     p.nwg, p.grid_x, p.stages, p.smem_bytes)
        return out

    got = run()
    _close(got, plain(x, w), 2e-2)
    assert torch.equal(got, run())


MID_DW_ROWS = [((8, 24, 24, 24, 64), 64), ((8, 24, 24, 24, 128), 64)]
MID_DW_RAGGED = [((2, 24, 26, 30, 64), 64), ((1, 20, 30, 70, 128), 64), ((2, 5, 7, 9, 64), 64),
                 ((1, 3, 4, 70, 192), 64), ((3, 1, 1, 1, 64), 128)]


@pytest.mark.parametrize("shape,co", MID_DW_ROWS + MID_DW_RAGGED)
def test_mid_channel_dw_body(cuda, shape, co):
    """The weight gradient on the mid-channel body, 1e-3 * max|ref|, bit-equal
    on repeat: through the wrapper where the rule takes it (C, CO multiples
    of 64 below CO = 128, at least MID_DW_MIN_POSITIONS positions), else
    through its entry point with its own plan."""
    g = torch.Generator().manual_seed(32)
    c = shape[-1]
    x = _randn(g, *shape).to(torch.bfloat16)
    dy = _randn(g, *shape[:4], co).to(torch.bfloat16)
    want = fused_conv.conv3d_dw_plain(x, dy)
    if fused_conv.dw_body(x, c, co) == "mid_channels":
        fused_conv.mid_dw_counter.reset()
        got, again = fused_conv.conv3d_dw(x, dy), fused_conv.conv3d_dw(x, dy)
        assert fused_conv.mid_dw_counter.count == 2
    else:
        p = fused_conv.mid_dw_plan(tuple(shape[:4]), c, co)
        ws = torch.empty(max(p.workspace, 1), dtype=torch.float32, device=cuda)

        def entry():
            out = torch.empty((3, 3, 3, c, co), dtype=torch.float32, device=cuda)
            _cuda.launch("segk_fused_conv3_dw_mid", x.data_ptr(), dy.data_ptr(), ws.data_ptr(),
                         out.data_ptr(), *shape[:4], c, co, p.td, p.th, p.tw, p.tpw, p.nwg,
                         p.splits, p.stages, p.smem_bytes)
            return out

        got, again = entry(), entry()
    _close(got, want, 1e-3)
    assert torch.equal(got, again)


def test_mid_channel_launchers_refuse_plans_they_did_not_size(cuda):
    x = torch.zeros((1, 8, 8, 16, 32), dtype=torch.bfloat16, device=cuda)
    w = torch.zeros((3, 3, 3, 32, 32), dtype=torch.bfloat16, device=cuda)
    p = fused_conv.mid_plan((1, 8, 8, 16), 32, 32)
    packed = fused_conv.pack_weights_mid(w, p.nt, p.ck)
    s, t = fused_conv._epilogue_vectors(32, None, None, None, x.device)
    out = torch.empty_like(x)
    args = (x.data_ptr(), packed.data_ptr(), s.data_ptr(), t.data_ptr(), None, 0, out.data_ptr(),
            1, 8, 8, 16, 32, 32, 1, p.td, p.th, p.tw, p.ck, p.nt, p.spw, p.nwg, p.grid_x,
            p.stages)
    _cuda.launch("segk_fused_conv3_mid", *args, p.smem_bytes)
    with pytest.raises(RuntimeError, match="CUDA error"):
        _cuda.launch("segk_fused_conv3_mid", *args, p.smem_bytes + 16)
    x64 = torch.zeros((2, 8, 8, 16, 64), dtype=torch.bfloat16, device=cuda)
    q = fused_conv.mid_dw_plan((2, 8, 8, 16), 64, 64)
    dw = torch.empty((3, 3, 3, 64, 64), dtype=torch.float32, device=cuda)
    ws = torch.empty(max(q.workspace, 1), dtype=torch.float32, device=cuda)
    dargs = (x64.data_ptr(), x64.data_ptr(), ws.data_ptr(), dw.data_ptr(), 2, 8, 8, 16, 64, 64,
             q.td, q.th, q.tw, q.tpw, q.nwg, q.splits, q.stages)
    _cuda.launch("segk_fused_conv3_dw_mid", *dargs, q.smem_bytes)
    with pytest.raises(RuntimeError, match="CUDA error"):
        _cuda.launch("segk_fused_conv3_dw_mid", *dargs, q.smem_bytes + 1024)


# The phase forward's Hopper body (csrc/conv3_phase.cuh): bf16 with Ci = Co = 8
# or 16 and at least PHASE_FWD_MIN_POSITIONS block voxels, held against the
# plain version on the f32 upcasts of the same bf16 values (f32 out: 1e-4 *
# max|ref|, the same exact products summed in another order; bf16 out: 1e-2,
# one rounding); grids whose H and W are no multiple of 8, every relu mode
@pytest.mark.parametrize("relu_mode", ["none", "relu", "prelu"])
@pytest.mark.parametrize("shape,c", [
    ((2, 24, 24, 24, 64), 8),  # the top decoder stage at 48^3, batch 2
    ((1, 24, 24, 24, 128), 16),  # the second stage's L = 128
    ((2, 18, 22, 26, 64), 8),  # H and W no multiple of 8
    ((1, 20, 30, 14, 128), 16),
])
def test_phase_forward_hopper_body(cuda, shape, c, relu_mode):
    g = torch.Generator().manual_seed(7)
    p = _randn(g, *shape).to(torch.bfloat16)
    w = _randn(g, 3, 3, 3, c, c, scale=(27 * c) ** -0.5).to(torch.bfloat16)
    kw = dict(bias=_randn(g, c, scale=0.1), scale=_randn(g, c).abs() + 0.5,
              shift=_randn(g, c, scale=0.1), alpha=torch.tensor([0.3], device=cuda),
              relu_mode=relu_mode)
    assert fused_conv.conv_body(p, c, c, True) == "phase_lanes"
    phase_conv.counter.reset()
    fused_conv.phase_fwd_counter.reset()
    got = phase_conv.phase_conv(p, w, **kw)
    assert phase_conv.counter.count == 1 and fused_conv.phase_fwd_counter.count == 1
    _close(got, phase_conv.phase_conv_plain(p.float(), w.float(), **kw), 1e-2)
    assert torch.equal(got, phase_conv.phase_conv(p, w, **kw))  # bit-equal on repeat
    wide = phase_conv.phase_conv(p, w, out_dtype=torch.float32, **kw)
    _close(wide, phase_conv.phase_conv_plain(p.float(), w.float(), **kw), 1e-4)
    assert fused_conv.phase_fwd_counter.count == 3


def test_phase_forward_hopper_body_takes_the_grad_function(cuda):
    """The differentiable phase conv runs its forward and its input gradient
    (the forward on flipped, swapped weights) on the Hopper body."""
    g = torch.Generator().manual_seed(8)
    p0 = _randn(g, 2, 24, 24, 24, 64).to(torch.bfloat16)
    w0 = _randn(g, 3, 3, 3, 8, 8, scale=(27 * 8) ** -0.5).to(torch.bfloat16)
    gy = _randn(g, 2, 24, 24, 24, 64).to(torch.bfloat16)
    p, w = p0.clone().requires_grad_(), w0.clone().requires_grad_()
    fused_conv.phase_fwd_counter.reset()
    phase_conv.phase_conv_grad(p, w).backward(gy)
    assert fused_conv.phase_fwd_counter.count == 2
    pf, wf = p0.float().requires_grad_(), w0.float().requires_grad_()
    phase_conv.phase_conv_plain(pf, wf).backward(gy.float())
    _close(p.grad, pf.grad, 2e-2)
    _close(w.grad, wf.grad, 2e-2)


def test_phase_forward_launcher_refuses_plans_it_did_not_size(cuda):
    """The launcher refuses a shared-memory sum other than its own, a ring
    with fewer slots than warpgroups and channel counts it has no instance
    of."""
    p = torch.zeros((1, 8, 8, 8, 64), dtype=torch.bfloat16, device=cuda)
    w = torch.zeros((3, 3, 3, 8, 8), dtype=torch.bfloat16, device=cuda)
    q = fused_conv.phase_fwd_plan((1, 16, 16, 16), 8, 8)
    packed = fused_conv.pack_weights_phase(w)
    s, t = fused_conv._epilogue_vectors(8, None, None, None, p.device)
    out = torch.empty_like(p)
    head = (p.data_ptr(), packed.data_ptr(), s.data_ptr(), t.data_ptr(), None, 0,
            out.data_ptr(), 1, 16, 16, 16)
    _cuda.launch("segk_phase_conv3_lanes", *head, 8, 8, 1, q.grid_x, q.stages, q.smem_bytes)
    with pytest.raises(RuntimeError, match="CUDA error"):
        _cuda.launch("segk_phase_conv3_lanes", *head, 8, 8, 1, q.grid_x, q.stages,
                     q.smem_bytes + 1024)
    with pytest.raises(RuntimeError, match="CUDA error"):  # one slot for two warpgroups
        _cuda.launch("segk_phase_conv3_lanes", *head, 8, 8, 1, q.grid_x, 1,
                     fused_conv.phase_fwd_smem_bytes(8, 1))
    with pytest.raises(RuntimeError, match="CUDA error"):  # Ci != Co
        _cuda.launch("segk_phase_conv3_lanes", *head, 8, 16, 1, q.grid_x, q.stages,
                     q.smem_bytes)


# The dense Hopper bodies (csrc/conv3_dense.cuh, conv3_dense_dw.cuh): bf16 with
# C = CO = 8 or 16, W * C a multiple of 64, at least DENSE_MIN_POSITIONS[C]
# (the dw DENSE_DW_MIN_POSITIONS[C]) positions, held against the plain versions
# on the f32 upcasts of the same bf16 values (f32 out 1e-4 * max|ref|, bf16 out
# 1e-2; the dw 1e-3, exact products summed in another order); D and H no
# multiple of 8, lines of one row and of many, every relu mode
@pytest.mark.parametrize("relu_mode", ["none", "relu", "prelu"])
@pytest.mark.parametrize("shape", [
    (2, 48, 48, 48, 16),  # the flagship's 48^3 x 16 at a rank's batch of 2
    (1, 30, 37, 36, 16),  # D and H no multiple of 8
    (1, 48, 48, 48, 8),  # SegResNet's width at 48^3
    (2, 42, 45, 40, 8),
    (8, 33, 35, 4, 16),  # one row a line
])
def test_dense_hopper_bodies(cuda, shape, relu_mode):
    g = torch.Generator().manual_seed(9)
    c = shape[-1]
    x = _randn(g, *shape).to(torch.bfloat16)
    w = _randn(g, 3, 3, 3, c, c, scale=(27 * c) ** -0.5).to(torch.bfloat16)
    kw = dict(bias=_randn(g, c, scale=0.1), scale=_randn(g, c).abs() + 0.5,
              shift=_randn(g, c, scale=0.1), alpha=torch.tensor([0.3], device=cuda),
              relu_mode=relu_mode)
    assert fused_conv.conv_body(x, c, c) == "dense_rows"
    fused_conv.counter.reset()
    fused_conv.dense_counter.reset()
    got = fused_conv.conv3d(x, w, **kw)
    assert fused_conv.counter.count == 1 and fused_conv.dense_counter.count == 1
    _close(got, fused_conv.conv3d_plain(x.float(), w.float(), **kw), 1e-2)
    assert torch.equal(got, fused_conv.conv3d(x, w, **kw))  # bit-equal on repeat
    wide = fused_conv.conv3d(x, w, out_dtype=torch.float32, **kw)
    _close(wide, fused_conv.conv3d_plain(x.float(), w.float(), **kw), 1e-4)
    assert fused_conv.dense_counter.count == 3
    if relu_mode != "none":
        return
    dy = _randn(g, *shape).to(torch.bfloat16)
    taken = x.numel() // c >= fused_conv.DENSE_DW_MIN_POSITIONS[c]
    assert fused_conv.dw_body(x, c, c) == ("dense_rows" if taken else "tensor_cores")
    fused_conv.dense_dw_counter.reset()
    dw = fused_conv.conv3d_dw(x, dy)
    assert fused_conv.dense_dw_counter.count == int(taken)
    _close(dw, fused_conv.conv3d_dw_plain(x, dy), 1e-3)
    assert torch.equal(dw, fused_conv.conv3d_dw(x, dy))


def test_dense_hopper_bodies_take_the_grad_function(cuda):
    """The differentiable conv runs its forward, its input gradient (the
    forward on flipped, swapped weights) and its weight gradient on the
    dense Hopper bodies."""
    g = torch.Generator().manual_seed(10)
    x0 = _randn(g, 2, 48, 48, 48, 16).to(torch.bfloat16)
    w0 = _randn(g, 3, 3, 3, 16, 16, scale=(27 * 16) ** -0.5).to(torch.bfloat16)
    gy = _randn(g, 2, 48, 48, 48, 16).to(torch.bfloat16)
    x, w = x0.clone().requires_grad_(), w0.clone().requires_grad_()
    fused_conv.dense_counter.reset()
    fused_conv.dense_dw_counter.reset()
    fused_conv.conv3d_grad(x, w).backward(gy)
    assert fused_conv.dense_counter.count == 2 and fused_conv.dense_dw_counter.count == 1
    xf, wf = x0.float().requires_grad_(), w0.float().requires_grad_()
    fused_conv.conv3d_plain(xf, wf).backward(gy.float())
    _close(x.grad, xf.grad, 2e-2)
    _close(w.grad, wf.grad, 2e-2)


def test_dense_launchers_refuse_plans_they_did_not_size(cuda):
    """The launchers refuse a shared-memory sum other than their own, a ring
    shorter than they need, C != CO and W * C no multiple of 64."""
    x = torch.zeros((1, 16, 16, 16, 16), dtype=torch.bfloat16, device=cuda)
    w = torch.zeros((3, 3, 3, 16, 16), dtype=torch.bfloat16, device=cuda)
    q = fused_conv.dense_fwd_plan((1, 16, 16, 16), 16, 16)
    packed = fused_conv.pack_weights_dense(w)
    s, t = fused_conv._epilogue_vectors(16, None, None, None, x.device)
    out = torch.empty_like(x)
    head = (x.data_ptr(), packed.data_ptr(), s.data_ptr(), t.data_ptr(), None, 0,
            out.data_ptr(), 1, 16, 16)
    _cuda.launch("segk_fused_conv3_rows", *head, 16, 16, 16, 1, q.grid_x, q.stages, q.smem_bytes)
    for bad in ((16, 16, 16, 1, q.grid_x, q.stages, q.smem_bytes + 1024),
                (16, 16, 16, 1, q.grid_x, 1, fused_conv.dense_fwd_smem_bytes(16, 1)),
                (16, 16, 8, 1, q.grid_x, q.stages, q.smem_bytes),
                (14, 16, 16, 1, q.grid_x, q.stages, q.smem_bytes)):
        with pytest.raises(RuntimeError, match="CUDA error"):
            _cuda.launch("segk_fused_conv3_rows", *head, *bad)
    r = fused_conv.dense_dw_plan((1, 16, 16, 16), 16, 16)
    ws = torch.empty(r.workspace, dtype=torch.float32, device=cuda)
    dw = torch.empty((3, 3, 3, 16, 16), dtype=torch.float32, device=cuda)
    head = (x.data_ptr(), x.data_ptr(), ws.data_ptr(), dw.data_ptr(), 1, 16, 16, 16, 16, 16)
    _cuda.launch("segk_fused_conv3_dw_rows", *head, r.grid_x, r.stages, r.smem_bytes)
    with pytest.raises(RuntimeError, match="CUDA error"):
        _cuda.launch("segk_fused_conv3_dw_rows", *head, r.grid_x, r.stages, r.smem_bytes + 1024)
    with pytest.raises(RuntimeError, match="CUDA error"):  # the sums outgrow a short ring
        _cuda.launch("segk_fused_conv3_dw_rows", *head, r.grid_x, 2,
                     fused_conv.dense_dw_smem_bytes(2))
