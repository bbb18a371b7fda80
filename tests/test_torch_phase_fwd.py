"""The phase forward's Hopper body (``csrc/conv3_phase.cuh``: kernels 3 and 4
for bf16 phase-major p with Ci = Co = 8 or 16) on the CPU.

The kernel runs only on the card (``tests/test_torch_kernels_cuda.py``,
``chip_smoke.py``, ``probe_phase_fwd.py``). Here:

- ``fused_conv.phase_fwd_plan`` at the flagship's L = 64 / L = 128 rows
  (serving batch 4, training batch 8, a rank's batch 2 at four ranks),
  packed UNETR's p 48^3 x 128 and ragged shapes: the bricks tile the block
  grid, the blocks' warpgroups walk every brick once, every output lane of a
  voxel belongs to exactly one group, the ring has a slot a warpgroup, shared
  memory equals the header's sum (written out here) within the card's limit,
  and the timed rows fill the card;
- the rule (``conv_body``): which rows take the new body and which keep
  theirs (mid, few-channel, f32, tensor-core);
- the packed weights (``pack_weights_phase``): against the expanded
  block-space kernel of the JAX package's ``fast_conv.expand_s1_kernel``;
- :func:`emulate`, a plain PyTorch emulation of the body read as the card
  reads it: the TMA boxes of the halo brick's planes in block space (at L =
  128 each plane only along the z shifts the block's output z phase reads),
  zero outside the grid, written 128-byte swizzled into the ring slot; A of
  every k16 step and slab through its descriptor (the start of
  ``phase_fwd_a_offset``: plane, rows moved by the pair's shift, 32 bytes of
  the row; SBO the
  halo's row pitch; the address-based swizzle) and B through its
  descriptor (K-major tiles); the epilogue's rows to voxels and columns to
  output lanes with the per-true-channel scale and shift and the
  activation. Held in f32 against ``phase_conv_plain`` within 1e-5 *
  max|ref| (sums of a few hundred products in another order) and against
  the JAX package's ``phase_gemm.phase_conv_gemm`` (its Pallas kernels in
  interpret mode, as ``tests/test_torch_phase_conv.py``) within 1e-4
  absolute + relative.
"""

from __future__ import annotations

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmantic_tpu.ops import fast_conv as jfc
from segmantic_tpu.ops import phase_gemm
from segmantic_tpu_torch.ops import fused_conv, phase_conv
from segmantic_tpu_torch.ops.fused_conv import SMEM_LIMIT, PhaseFwdPlan, phase_fwd_plan

SMS = 132


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The emulation is many small tensor operations: one thread, or the
    workers' thread pools contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (full-resolution dims, C): the flagship's top two decoder stages at the
# serving batch (4) and the training batch (8), packed UNETR's 96^3 x 16 stage;
# a rank's batch of 2 at four ranks
ROWS = [((4, 96, 96, 96), 8), ((4, 48, 48, 48), 16), ((8, 96, 96, 96), 8),
        ((8, 48, 48, 48), 16), ((8, 96, 96, 96), 16)]
RANK_ROWS = [((2, 96, 96, 96), 8), ((2, 48, 48, 48), 16)]
RAGGED = [((1, 10, 14, 22), 8), ((3, 6, 6, 10), 16), ((1, 2, 2, 2), 8), ((2, 18, 4, 34), 16)]


def _round1024(n):
    return -(-n // 1024) * 1024


def _header_smem(p: PhaseFwdPlan, c: int) -> int:
    """``phase_fwd_smem_bytes`` of csrc/conv3_phase.cuh, written out: 96 KB of
    weights; a slot is one plane of 3 z planes of 10 x 10 rows (L = 64) or
    two of 1 and 2 (L = 128)."""
    depths = (3,) if c == 8 else (1, 2)
    slot = sum(_round1024(dz * 100 * 128) for dz in depths)
    return 2048 + 48 // 4 * 64 * 128 + p.stages * slot


def _walk(p: PhaseFwdPlan):
    """(block, warpgroup, ring index i, brick) of every brick a launch walks."""
    for bx in range(p.grid_x):
        for i, brick in enumerate(range(bx, p.nbricks, p.grid_x)):
            yield bx, i % p.nwg, i, brick


@pytest.mark.parametrize("dims,c", ROWS + RANK_ROWS + RAGGED)
def test_phase_fwd_plan_covers_every_voxel_and_lane_once(dims, c):
    p = phase_fwd_plan(dims, c, c)
    b, d, h, w = dims[0], dims[1] // 2, dims[2] // 2, dims[3] // 2
    nbz, nby, nbx = d, -(-h // 8), -(-w // 8)
    assert p.nbricks == b * nbz * nby * nbx and (p.td, p.th, p.tw, p.nwg) == (1, 8, 8, 2)
    walked = sorted(brick for *_, brick in _walk(p))
    assert walked == list(range(p.nbricks))  # every brick by exactly one warpgroup
    assert p.fill == pytest.approx(b * d * h * w / (p.nbricks * 64 * p.td))
    if b * d * h * w <= 20000:  # every voxel of the grid in exactly one brick's slabs
        hits = np.zeros((b, d, h, w), dtype=np.int64)
        for brick in range(p.nbricks):
            r, x0 = divmod(brick, nbx)
            r, y0 = divmod(r, nby)
            bb, z0 = divmod(r, nbz)
            for sl, row in itertools.product(range(p.td), range(64)):  # the epilogue's rows
                z, y, x = z0 * p.td + sl, y0 * 8 + row // 8, x0 * 8 + row % 8
                if z < d and y < h and x < w:
                    hits[bb, z, y, x] += 1
        assert np.all(hits == 1)
    # every output lane of a voxel in exactly one group's columns: lane az * 64 + n
    lanes = sorted(g * 64 * (p.groups == 2) + n for g in range(p.groups) for n in range(64))
    assert lanes == list(range(8 * c)) and p.groups == (1 if c == 8 else 2)
    assert p.grid == (p.grid_x, p.groups) and 1 <= p.grid_x <= p.nbricks
    assert p.nwg <= p.stages <= 8  # a slot a warpgroup at least
    assert p.smem_bytes == _header_smem(p, c) <= SMEM_LIMIT
    assert fused_conv.phase_fwd_smem_bytes(c, p.stages) == p.smem_bytes


@pytest.mark.parametrize("dims,c", ROWS)
def test_phase_fwd_plan_fills_the_card_at_the_rows(dims, c):
    p = phase_fwd_plan(dims, c, c)
    assert p.grid_x * p.groups == SMS, p  # one persistent block a multiprocessor
    assert p.nbricks >= p.grid_x * p.nwg  # every warpgroup has a brick
    assert p.fill == 1.0


@pytest.mark.parametrize("c,co", [(8, 16), (16, 8), (24, 24), (32, 32), (4, 4), (1, 1)])
def test_phase_fwd_plan_refuses_channels_it_cannot_run(c, co):
    assert not fused_conv.phase_fwd_eligible(c, co)
    with pytest.raises(ValueError, match="phase forward"):
        phase_fwd_plan((1, 8, 8, 8), c, co)


# ---- the rule ------------------------------------------------------------------------

def _probe(dims, c, dtype=torch.bfloat16, phase=True):
    b, d, h, w = dims
    shape = (b, d // 2, h // 2, w // 2, 8 * c) if phase else (b, d, h, w, c)
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("dims,c", ROWS + RANK_ROWS)
def test_the_rows_take_the_phase_body(dims, c):
    assert fused_conv.conv_body(_probe(dims, c), c, c, True) == "phase_lanes"
    # f32 keeps the register-tiled body; the dense layout never takes it (its
    # own Hopper body takes these channel counts there)
    assert fused_conv.conv_body(_probe(dims, c, torch.float32), c, c, True) == "f32_tiles"
    assert fused_conv.conv_body(_probe(dims, c, phase=False), c, c, False) == "dense_rows"


@pytest.mark.parametrize("dims,c,co,body", [
    ((8, 96, 96, 96), 32, 16, "mid_channels"),  # packed UNETR's 96^3 x 32 -> 16
    ((8, 96, 96, 96), 16, 32, "mid_channels"),  # and its input gradient
    ((8, 48, 48, 48), 32, 32, "mid_channels"),
    ((8, 96, 96, 96), 1, 16, "few_channels"),  # packed UNETR's one-channel input layer
    ((8, 96, 96, 96), 8, 16, "tensor_cores"),  # Ci != Co
    ((8, 96, 96, 96), 16, 8, "tensor_cores"),
    ((2, 16, 16, 16), 8, 8, "tensor_cores"),  # 1024 block voxels: below the least volume
    ((1, 24, 24, 24), 16, 16, "tensor_cores"),  # 1728
    ((1, 32, 32, 32), 8, 8, "phase_lanes"),  # 4096: the least volume
    ((8, 96, 96, 96), 8, 8, "phase_lanes"),
    ((8, 96, 96, 96), 12, 12, "f32_tiles"),
])
def test_other_phase_rows_keep_their_bodies(dims, c, co, body):
    assert fused_conv.conv_body(_probe(dims, c), c, co, True) == body


# ---- the packed weights --------------------------------------------------------------

_PAIRS = ((-1, 1), (0, 0), (0, 1), (1, 0))  # per axis: (shift e, input phase a')


@pytest.mark.parametrize("c", [8, 16])
def test_packed_weights_are_the_expanded_kernel(c):
    """Each packed value, unswizzled, is the JAX package's expanded block-space
    kernel (3, 3, 3, 8 c, 8 c) at the K row's (shift, input phase, ci) and the
    column's (output phase, co); every structural zero of a pair is zero."""
    rng = np.random.default_rng(c)
    w = rng.standard_normal((3, 3, 3, c, c)).astype(np.float32)
    big = np.asarray(jfc.expand_s1_kernel(jnp.asarray(w)))  # (3, 3, 3, 8c, 8c) by shift
    packed = fused_conv.pack_weights_phase(torch.from_numpy(w))
    groups = 1 if c == 8 else 2
    assert tuple(packed.shape) == (groups, 12, 64, 64)
    logical = fused_conv._swizzle128(packed).numpy()  # its own inverse
    for g, t, n, k in itertools.product(range(groups), range(12), range(64), range(64)):
        st, kk = (64 * t + k) // 16, k % 16
        if c == 8:  # the step (pz, py, ex), k = (a'x, ci)
            pz, py, ex, apx, ci = st // 12, st // 3 % 4, st % 3 - 1, kk // 8, kk % 8
            px = {(-1, 1): 0, (0, 0): 1, (0, 1): 2, (1, 0): 3}.get((ex, apx))
        else:  # the step (pz - g, py, px), k = ci
            pz, py, px, ci = st // 16 + g, st // 4 % 4, st % 4, kk
        lane_out = g * 64 * (groups == 2) + n
        if px is None:  # a'x the shift ex never reads: structural zeros
            assert logical[g, t, n, k] == 0, (g, t, n, k)
            continue
        (ez, az_), (ey, ay_), (ex, ax_) = _PAIRS[pz], _PAIRS[py], _PAIRS[px]
        lane_in = ((az_ * 2 + ay_) * 2 + ax_) * c + ci
        want = big[ez + 1, ey + 1, ex + 1, lane_in, lane_out]
        assert logical[g, t, n, k] == want, (g, t, n, k)


# ---- the emulation -------------------------------------------------------------------

def _swizzle(e: torch.Tensor) -> torch.Tensor:
    """128-byte swizzle of a bf16 element index inside a 1024-aligned region:
    the 16-byte unit (bits 3-5) XOR the row within the 1024 bytes (bits 6-8)."""
    return e ^ (((e >> 6) & 7) << 3)


def _box(t: torch.Tensor, b: int, c0: int, z0: int, y0: int, x0: int, bd: int, bh: int,
         bw: int) -> torch.Tensor:
    """A TMA box: lanes c0 .. c0 + 63 of t (B, D, H, W, L) over bd x bh x bw
    voxels at (z0, y0, x0) of sample b, zero outside the grid: (rows, 64) in
    (z, y, x) order."""
    out = torch.zeros(bd, bh, bw, 64, dtype=t.dtype)
    _, d, h, w, _ = t.shape
    zs, ys, xs = [range(max(0, -o), min(n, e - o)) for o, n, e in
                  ((z0, bd, d), (y0, bh, h), (x0, bw, w))]
    if len(zs) and len(ys) and len(xs):
        out[zs.start:zs.stop, ys.start:ys.stop, xs.start:xs.stop] = t[
            b, z0 + zs.start:z0 + zs.stop, y0 + ys.start:y0 + ys.stop,
            x0 + xs.start:x0 + xs.stop, c0:c0 + 64]
    return out.reshape(-1, 64)


def _step_table(c: int, az: int, plane1: int) -> torch.Tensor:
    """``phase_fwd_a_offset`` of csrc/conv3_phase.cuh for every k16 step: the
    byte offset of A's start in a slot (slab 0), 10 x 10 rows a z plane of a
    box, plane 1 ``plane1`` bytes in."""
    out = []
    for st in range(48):
        if c == 8:
            pz, py, ex = st // 12, st // 3 % 4, st % 3 - 1
            unit = (1 - (pz & 1)) * 2 + 1 - (py & 1)
        else:
            px = st & 3
            pz, py, ex = st // 16 + az, st // 4 % 4, ((px + 1) >> 1) - 1
            unit = ((1 - (pz & 1)) * 2 + 1 - (py & 1)) * 2 + 1 - (px & 1)
        ez, ey = ((pz + 1) >> 1) - 1, ((py + 1) >> 1) - 1
        plane = unit >> 2
        zs = -1 if c == 8 else (-1 if plane == 1 and az == 0 else 0)
        out.append((plane1 if plane else 0) + (((ez - zs) * 10 + 1 + ey) * 10 + 1 + ex) * 128
                   + (unit & 3) * 32)
    return torch.tensor(out)


def emulate(pt, w, dims, p: PhaseFwdPlan, scale, shift, alpha, relu_mode) -> torch.Tensor:
    """The phase forward's Hopper body on phase-major p (B, D/2, H/2, W/2, 8 c)
    (f32), weights (3, 3, 3, c, c), as the card computes it: returns the
    phase-major (B, D/2, H/2, W/2, 8 c) output in f32."""
    c = pt.shape[-1] // 8
    b_, d, h, w_ = dims[0], dims[1] // 2, dims[2] // 2, dims[3] // 2
    nbz, nby, nbx = -(-d // p.td), -(-h // 8), -(-w_ // 8)
    packed = fused_conv.pack_weights_phase(w).reshape(p.groups, -1)
    # B of k16 step st as its descriptor reads it: element (k, n) of the
    # K-major tile (st >> 2) at n * 128 + (st & 3) * 32 + 2 k bytes, swizzled
    st = torch.arange(48).view(-1, 1, 1)
    kk = torch.arange(16).view(1, -1, 1)
    nn = torch.arange(64).view(1, 1, -1)
    baddr = (st >> 2) * 64 * 128 + (st & 3) * 32 + nn * 128 + 2 * kk  # bytes
    # A of slab sl, row r (y = r // 8, x = r % 8), step st: its descriptor's
    # start + sl z planes + the row's line (SBO = 10 rows) and x (128 bytes)
    r = torch.arange(64)
    row_off = (r // 8) * 10 * 128 + (r % 8) * 128
    out = torch.zeros(b_, d, h, w_, 8 * c)
    s_t, t_t = scale.float().repeat(8), shift.float().repeat(8)
    for g in range(p.groups):
        bmat = packed[g][_swizzle(baddr // 2)].reshape(48 * 16, 64)
        # the planes' boxes: (first z relative to the brick, depth), plane 0 first
        boxes = [(-1, p.td + 2)] if c == 8 else \
            [(0, p.td + (g == 1)), (-1 if g == 0 else 0, p.td + (g == 0))]
        sizes = [_round1024(dz * 100 * 128) for _, dz in boxes]
        stab = _step_table(c, g, sizes[0])
        for brick in range(p.nbricks):
            rr, x0 = divmod(brick, nbx)
            rr, y0 = divmod(rr, nby)
            bb, z0 = divmod(rr, nbz)
            z0, y0, x0 = z0 * p.td, y0 * 8, x0 * 8
            logical = torch.cat([torch.cat([
                _box(pt, bb, 64 * k, z0 + zs, y0 - 1, x0 - 1, dz, 10, 10).reshape(-1),
                torch.zeros((size - dz * 100 * 128) // 2)])
                for k, ((zs, dz), size) in enumerate(zip(boxes, sizes))])
            slot = torch.zeros_like(logical)
            slot[_swizzle(torch.arange(logical.numel()))] = logical
            for sl in range(p.td):
                start = stab.view(1, 48, 1) + sl * 100 * 128 + row_off.view(64, 1, 1) \
                    + 2 * torch.arange(16).view(1, 1, 16)  # bytes
                amat = slot[_swizzle(start // 2)].reshape(64, 48 * 16)
                acc = amat @ bmat
                vz, vy, vx = z0 + sl, y0 + r // 8, x0 + r % 8
                real = (vz < d) & (vy < h) & (vx < w_)
                lanes = torch.arange(64) + 64 * g * (p.groups == 2)
                y = fused_conv.activation(acc * s_t[lanes] + t_t[lanes], relu_mode, alpha)
                vzr = torch.full_like(vy[real], vz)
                out[bb, vzr, vy[real], vx[real]] = out[bb, vzr, vy[real], vx[real]]. \
                    index_copy(1, lanes, y[real])
    return out


def _rand(rng, shape, scale=1.0):
    return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32))


@pytest.mark.parametrize("dims,c,relu_mode", [((1, 6, 18, 18), 8, "prelu"),
                                              ((2, 4, 6, 16), 16, "relu"),
                                              ((1, 2, 4, 34), 16, "none"),
                                              ((1, 10, 2, 4), 8, "none")])
def test_emulated_body_matches_plain(dims, c, relu_mode):
    rng = np.random.default_rng(c + dims[3])
    shape = (dims[0], dims[1] // 2, dims[2] // 2, dims[3] // 2)
    pt = _rand(rng, shape + (8 * c,))
    w = _rand(rng, (3, 3, 3, c, c), 0.2)
    bias, scale, shift = _rand(rng, (c,), 0.1), _rand(rng, (c,)).abs() + 0.5, \
        _rand(rng, (c,), 0.1)
    alpha = torch.tensor([0.25])
    want = phase_conv.phase_conv_plain(pt, w, bias, scale, shift, alpha, relu_mode)
    s, t = fused_conv._epilogue_vectors(c, bias, scale, shift, pt.device)
    got = emulate(pt, w, dims, phase_fwd_plan(dims, c, c), s, t, alpha, relu_mode)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    # the input gradient's use: the same body on flipped, swapped weights
    wf = fused_conv.flip_io(w)
    got = emulate(pt, wf, dims, phase_fwd_plan(dims, c, c), *fused_conv._epilogue_vectors(
        c, None, None, None, pt.device), None, "none")
    want = phase_conv.phase_conv_plain(pt, wf)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.parametrize("p_shape", [(1, 2, 4, 16, 64), (1, 3, 2, 4, 128)],
                         ids=["folded_L64", "direct_L128"])
def test_emulated_body_matches_pallas(p_shape):
    rng = np.random.default_rng(5)
    c = p_shape[-1] // 8
    p_in = rng.standard_normal(p_shape).astype(np.float32)
    w = (0.1 * rng.standard_normal((3, 3, 3, c, c))).astype(np.float32)
    assert phase_gemm._fold_ok(p_shape) == (c == 8)
    want = np.asarray(phase_gemm.phase_conv_gemm(jnp.asarray(p_in), jnp.asarray(w),
                                                 interpret=True))
    dims = (p_shape[0],) + tuple(2 * v for v in p_shape[1:4])
    s, t = fused_conv._epilogue_vectors(c, None, None, None, torch.device("cpu"))
    got = emulate(torch.from_numpy(p_in), torch.from_numpy(w), dims,
                  phase_fwd_plan(dims, c, c), s, t, None, "none")
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


def test_the_entry_point_has_its_ctypes_signature():
    """``segk_phase_conv3_lanes`` takes the arguments ``launch_conv3`` passes:
    seven pointers and the relu mode, ten ints, the stream."""
    import re
    from pathlib import Path

    from segmantic_tpu_torch.ops import _cuda

    text = (Path(_cuda._CSRC) / "phase_conv.cu").read_text()
    m = re.search(r'extern "C" int segk_phase_conv3_lanes\(([^)]*)\)', text)
    kinds = [_cuda._P if "*" in a else _cuda._I for a in m.group(1).split(",")]
    assert _cuda._SIGNATURES["segk_phase_conv3_lanes"] == kinds
    assert kinds == [_cuda._P] * 5 + [_cuda._I, _cuda._P] + [_cuda._I] * 10 + [_cuda._P]
