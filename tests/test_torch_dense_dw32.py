"""The dense pairs body of kernel 2 (``csrc/conv3_dense_pairs_dw.cuh``: the
weight gradient for bf16 NDHWC with C = CO = 32 and W even) on the CPU.

The kernel runs only on the card (``tests/test_torch_kernels_cuda.py``,
``chip_smoke.py``, ``probe_dense_rows.py``). Here:

- ``fused_conv.dense_pairs_plan`` at the 24^3 x 32 rows (batch 8, 4 and 2),
  12^3 and 48^3 x 32 (batch 8) and ragged shapes: the bricks (8 y x 8 z of
  one 128-byte row, two voxels) tile the grid and the blocks walk every brick
  once, shared memory equals the header's sum (written out here) within the
  card's limit, and the epilogue's map from a thread's accumulator entries to
  (tz, ty, tx, ci, co) writes every entry of a block's partial exactly once;
- the rule (``dw_body``): which rows take the new body and which keep theirs;
- :func:`emulate`, a plain PyTorch emulation of the body read as the card
  reads it: the four TMA boxes (x's windows from voxel -1 and 0 of the row
  with the 10 x 10 halo, dy's rows from the same voxels), zero outside the
  lines, written 128-byte swizzled into a ring slot; A and B of every k16
  step through their descriptors (the (tz, ty) shift and the z plane moving
  the start by whole rows, the voxel v = 0 / 1 groups a box apart); the
  epilogue's (o, s) blocks as taps; the partials summed in block order. Held
  in f32 against ``conv3d_dw_plain`` within 1e-5 * max|ref| and against the
  JAX package's ``pallas_conv.conv3d_packed_dw`` in interpret mode within
  1e-4 absolute + relative.
"""

from __future__ import annotations

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmantic_tpu.ops import pallas_conv
from segmantic_tpu_torch.ops import fused_conv
from segmantic_tpu_torch.ops.fused_conv import SMEM_LIMIT, dense_pairs_plan

SMS = 132


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The emulation is many small tensor operations: one thread, or the
    workers' thread pools contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the 24^3 x 32 dw of the flagship, SegResNet and UNETR at batch 8, a rank's
# batch 4 at two ranks and batch 2 at four; UNETR's 12^3 and 48^3 x 32 (batch 8)
ROWS = [(8, 24, 24, 24), (4, 24, 24, 24), (2, 24, 24, 24), (8, 12, 12, 12), (8, 48, 48, 48)]
RAGGED = [(1, 10, 9, 8), (2, 7, 12, 6), (1, 3, 17, 4), (1, 9, 2, 2)]


def _round1024(n):
    return -(-n // 1024) * 1024


BOX = _round1024(100 * 128)  # a window: 10 y x 10 z rows of 128 bytes
DY = 64 * 128  # a box of dy: 8 y x 8 z rows


def _header_smem(stages: int) -> int:
    """``dense_pairs_smem_bytes`` of csrc/conv3_dense_pairs_dw.cuh, written
    out: a slot two windows of x and two boxes of dy."""
    return 2048 + stages * (2 * BOX + 2 * DY)


def _origin(brick, nrows, nby, nbz):
    r, j = divmod(brick, nrows)
    r, yb = divmod(r, nby)
    b, zb = divmod(r, nbz)
    return b, zb * 8, yb * 8, j


@pytest.mark.parametrize("dims", ROWS + RAGGED)
def test_pairs_plan_covers_every_row_once(dims):
    b, d, h, w = dims
    p = dense_pairs_plan(dims, 32, 32)
    assert p.smem_bytes == _header_smem(p.stages) <= SMEM_LIMIT
    assert p.stages >= 2 and 1 <= p.grid_x <= SMS
    nby, nbz = -(-h // 8), -(-d // 8)
    assert p.nrows == w // 2 and p.nbricks == b * nbz * nby * p.nrows
    assert p.workspace == p.grid_x * 27 * 32 * 32
    seen = torch.zeros(b, nbz * 8, nby * 8, p.nrows, dtype=torch.int32)
    for bx in range(p.grid_x):
        for brick in range(bx, p.nbricks, p.grid_x):
            bb, z0, y0, j = _origin(brick, p.nrows, nby, nbz)
            seen[bb, z0:z0 + 8, y0:y0 + 8, j] += 1
    assert bool((seen == 1).all())
    assert p.fill == pytest.approx(b * d * h * p.nrows / (p.nbricks * 64))


@pytest.mark.parametrize("dims", ROWS[:3])
def test_pairs_plan_fills_the_card_at_the_rows(dims):
    assert dense_pairs_plan(dims, 32, 32).grid_x == SMS


def test_the_epilogue_writes_every_tap_once():
    """The kernel's map from a thread's accumulator entries (warpgroup tz,
    warp w, lane (g8, t4), ty, half, jj, e) to the partial's (tap, ci, co),
    written out as the kernel computes it: each entry of [27][32][32] once;
    the (o, s) = (-1, 0) blocks (tap 1 again) never."""
    seen = torch.zeros(27, 32, 32, dtype=torch.int32)
    for wg, w, lane, ty, half, jj in itertools.product(range(3), range(4), range(32), range(3),
                                                       range(2), range(8)):
        g8, t4 = lane >> 2, lane & 3
        o, sv = (w >> 1) - 1, jj >> 2
        if o == -1 and sv == 0:
            continue
        tx = o + 2 - sv
        ci, co = (16 * w + g8 + 8 * half) & 31, (8 * jj + 2 * t4) & 31
        # the rows and columns the entry holds: x voxel v + o, dy voxel v - 1 + s
        assert (16 * w + g8 + 8 * half) // 32 == o + 1 and (8 * jj + 2 * t4) // 32 == sv
        seen[(wg * 3 + ty) * 3 + tx, ci, co:co + 2] += 1
    assert bool((seen == 1).all())


@pytest.mark.parametrize("c,co,w", [(32, 32, 23), (32, 16, 24), (16, 16, 24), (64, 64, 24)])
def test_pairs_plan_refuses_what_it_cannot_run(c, co, w):
    assert not fused_conv.dense_pairs_eligible(c, co, w)
    with pytest.raises(ValueError, match="dense pairs"):
        dense_pairs_plan((1, 8, 8, w), c, co)


# ---- the rule ------------------------------------------------------------------------

def _probe(dims, c, dtype=torch.bfloat16):
    return torch.empty(tuple(dims) + (c,), dtype=dtype, device="meta")


@pytest.mark.parametrize("dims", ROWS)
def test_the_rows_take_the_pairs_body(dims):
    positions = dims[0] * dims[1] * dims[2] * dims[3]
    want = "dense_pairs" if positions >= fused_conv.DENSE_PAIRS_MIN_POSITIONS else "tensor_cores"
    assert fused_conv.dw_body(_probe(dims, 32), 32, 32) == want
    # f32 keeps the register-tiled body; the forward keeps its rule
    assert fused_conv.dw_body(_probe(dims, 32, torch.float32), 32, 32) == "f32_tiles"
    assert fused_conv.conv_body(_probe(dims, 32), 32, 32) != "dense_pairs"


def test_the_least_volume_lies_between_the_rows_timed():
    """The rule takes 24^3 x 32 from batch 4 (a rank's step at two ranks;
    PERF.md: faster than the tensor-core body there and above) and leaves 24^3
    at batch 2, 32^3 at batch 1 and UNETR's 12^3 x 32 at batch 8, where the
    card timed it slower, on the tensor-core body."""
    assert max(2 * 24 ** 3, 32 ** 3, 8 * 12 ** 3) < fused_conv.DENSE_PAIRS_MIN_POSITIONS \
        <= 4 * 24 ** 3


def test_the_least_volume():
    least = fused_conv.DENSE_PAIRS_MIN_POSITIONS  # lines of two voxels
    assert fused_conv.dw_body(_probe((1, 1, -(-least // 2), 2), 32), 32, 32) == "dense_pairs"
    assert fused_conv.dw_body(_probe((1, 1, least // 2 - 1, 2), 32), 32, 32) == "tensor_cores"


@pytest.mark.parametrize("dims,c,co,body", [
    ((8, 24, 24, 23), 32, 32, "tensor_cores"),  # W odd
    ((8, 24, 24, 24), 32, 16, "tensor_cores"),  # C != CO
    ((8, 24, 24, 24), 16, 32, "tensor_cores"),
    ((8, 24, 24, 24), 64, 64, "mid_channels"),
    ((8, 48, 48, 48), 16, 16, "dense_rows"),  # C = 16 and 8 keep the dense Hopper body
    ((8, 96, 96, 96), 8, 8, "dense_rows"),
])
def test_other_dense_rows_keep_their_bodies(dims, c, co, body):
    assert fused_conv.dw_body(_probe(dims, c), c, co) == body


def test_the_phase_layout_never_takes_the_pairs_body():
    p = torch.empty((8, 24, 24, 24, 256), dtype=torch.bfloat16, device="meta")  # p 24^3 x 256
    assert fused_conv.dw_body(p, 32, 32, True) == "phase_blocks"


# ---- the emulation -------------------------------------------------------------------

def _swizzle(e: torch.Tensor) -> torch.Tensor:
    """128-byte swizzle of a bf16 element index inside a 1024-aligned region:
    the 16-byte unit (bits 3-5) XOR the row within the 1024 bytes (bits 6-8)."""
    return e ^ (((e >> 6) & 7) << 3)


def _box(lines: torch.Tensor, b: int, lane0: int, y0: int, z0: int, bh: int,
         bd: int) -> torch.Tensor:
    """A TMA box of the 4-D map over (lanes, H, D, B): lanes lane0 .. lane0 +
    63 of the lines (B, D, H, W C), bh y x bd z at (y0, z0) of sample b, zero
    outside: (bd * bh rows, 64) in (z, y) order."""
    _, d, h, n = lines.shape
    out = torch.zeros(bd, bh, 64, dtype=lines.dtype)
    zs, ys, ls = [range(max(0, -o), min(e, lim - o)) for o, e, lim in
                  ((z0, bd, d), (y0, bh, h), (lane0, 64, n))]
    if len(zs) and len(ys) and len(ls):
        out[zs.start:zs.stop, ys.start:ys.stop, ls.start:ls.stop] = lines[
            b, z0 + zs.start:z0 + zs.stop, y0 + ys.start:y0 + ys.stop,
            lane0 + ls.start:lane0 + ls.stop]
    return out.reshape(-1, 64)


def _slot(boxes_and_sizes) -> torch.Tensor:
    """Boxes written one after another at their 1024-aligned offsets, each
    128-byte swizzled as TMA writes it."""
    parts, at = [], 0
    for box, size in boxes_and_sizes:
        logical = torch.cat([box.reshape(-1), torch.zeros(size // 2 - box.numel())])
        part = torch.zeros_like(logical)
        part[_swizzle(torch.arange(at, at + logical.numel())) - at] = logical
        parts.append(part)
        at += logical.numel()
    return torch.cat(parts)


def _mnmajor(buf: torch.Tensor, start: int, sbo: int) -> torch.Tensor:
    """An MN-major operand (64 m or n x k16, rows of 128 bytes, 128-byte
    swizzled) read through a descriptor at byte ``start``: k at (k // 8) SBO
    + (k % 8) 128, m at 2 m bytes. Returns (k16, 64)."""
    k = torch.arange(16).view(-1, 1)
    addr = start + (k // 8) * sbo + (k % 8) * 128 + 2 * torch.arange(64).view(1, -1)
    return buf[_swizzle(addr // 2)]


def emulate(x, dy, grid_x=None) -> torch.Tensor:
    """The dense pairs dw body on x, dy (B, D, H, W, 32) (f32), as the card
    computes it: per block its bricks' k16 steps (z plane q; k = 8 y at v =
    0, then 8 y at v = 1) into its three warpgroups' (tz) accumulators of
    three ty, the (o, s) blocks stored as taps, then the partials summed in
    block order. Returns (3, 3, 3, 32, 32) f32."""
    b_, d, h, w_, c = x.shape
    p = dense_pairs_plan((b_, d, h, w_), c, c)
    grid = p.grid_x if grid_x is None else grid_x
    xl, gl = x.reshape(b_, d, h, w_ * c), dy.reshape(b_, d, h, w_ * c)
    nby, nbz = -(-h // 8), -(-d // 8)
    parts = torch.zeros(grid, 27, c, c)
    for bx in range(grid):
        acc = torch.zeros(3, 3, 64, 64)  # [tz][ty][x lanes from voxel v - 1][dy lanes from v - 1]
        for brick in range(bx, p.nbricks, grid):
            bb, z0, y0, j = _origin(brick, p.nrows, nby, nbz)
            slot = _slot([(_box(xl, bb, 64 * j + 32 * (v - 1), y0 - 1, z0 - 1, 10, 10), BOX)
                          for v in range(2)]
                         + [(_box(gl, bb, 64 * j + 32 * (v - 1), y0, z0, 8, 8), DY)
                            for v in range(2)])
            for tz, q, ty in itertools.product(range(3), range(8), range(3)):
                amat = _mnmajor(slot, tz * 10 * 128 + (q * 10 + ty) * 128, BOX)
                bmat = _mnmajor(slot, 2 * BOX + q * 8 * 128, DY)
                acc[tz, ty] += amat.T @ bmat
        blk = acc.reshape(9, 2, 32, 2, 32)  # [tz ty][o + 1][ci][s][co]
        for o, s in ((-1, 1), (0, 1), (0, 0)):
            parts[bx, o + 2 - s::3] = blk[:, o + 1, :, s]
    out = parts[0].clone()
    for k in range(1, grid):  # the second launch: partials in block order
        out += parts[k]
    return out.reshape(3, 3, 3, c, c)


def _rand(rng, shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _bf16(t):
    return t.to(torch.bfloat16).float()  # the values the card reads


@pytest.mark.parametrize("dims", RAGGED)
def test_emulated_body_matches_plain(dims):
    rng = np.random.default_rng(dims[1] + dims[3])
    x, dy = _bf16(_rand(rng, dims + (32,))), _bf16(_rand(rng, dims + (32,)))
    want = fused_conv.conv3d_dw_plain(x, dy)
    for grid in (None, 1, 3):  # the plan's grid, one block, three
        got = emulate(x, dy, grid)
        assert (got - want).abs().max() <= 1e-5 * want.abs().max(), grid


def test_emulated_body_matches_pallas():
    rng = np.random.default_rng(11)
    dims = (2, 4, 6, 8)
    x = rng.standard_normal(dims + (32,)).astype(np.float32)
    dy = rng.standard_normal(dims + (32,)).astype(np.float32)
    want = np.asarray(pallas_conv.conv3d_packed_dw(jnp.asarray(x), jnp.asarray(dy),
                                                   interpret=True))
    got = emulate(torch.from_numpy(x), torch.from_numpy(dy))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
