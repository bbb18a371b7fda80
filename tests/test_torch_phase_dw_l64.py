"""The phase pieces body of kernel 5 (``csrc/conv3_phase_pieces_dw.cuh``: the
phase-space weight gradient for bf16 phase-major p and g with Ci = Co = 8,
the flagship's L = 64) on the CPU.

The kernel runs only on the card (``tests/test_torch_kernels_cuda.py``,
``chip_smoke.py``, ``probe_phase_dw.py``). Here:

- ``fused_conv.phase_pieces_plan`` at the L = 64 rows (96^3 x 8 at batch 8
  and a rank's batch 4) and ragged shapes: the bricks tile the block grid
  with an even count of k16 steps and the blocks walk every brick once,
  shared memory equals the header's sum (written out here) within the card's
  limit, the rows fill 132 blocks, and the epilogue's map from a thread's
  accumulator entries to (a'y, a'x, tap, ci, co) writes every entry of a
  block's four partials exactly once;
- the rule (``dw_body``): which phase rows take the new body and which keep
  theirs;
- :func:`emulate`, a plain PyTorch emulation of the body read as the card
  reads it: the TMA boxes of p (no halo) and g (one-voxel halo), zero outside
  the grid, written 128-byte swizzled into the ring slot; per k16 step, pass
  a'z and tile T, operand B read through its descriptor (32 lanes from 64
  a'z bytes into the row, SBO 1024) and each warp's A rows through the
  kernel's ldmatrix lane addresses (the y piece of the pair member, the
  warp's x piece, the z piece of (tz, a'z)); the accumulators in K order; the
  epilogue's map to (a'y, a'x, tap, ci, co); the 4 x splits partials summed
  in their fixed order. Held in f32 against ``phase_conv_dw_plain`` within
  1e-5 * max|ref| and against the JAX package's
  ``phase_gemm.phase_conv_gemm_dw`` (its folded Pallas kernel at L = 64 in
  interpret mode) within 1e-4 absolute + relative.
"""

from __future__ import annotations

import dataclasses
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmantic_tpu.ops import phase_gemm
from segmantic_tpu_torch.ops import fused_conv, phase_conv
from segmantic_tpu_torch.ops.fused_conv import SMEM_LIMIT, PhasePiecesPlan, phase_pieces_plan

SMS = 132


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The emulation is many small tensor operations: one thread, or the
    workers' thread pools contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# full-resolution dims: the flagship's L = 64 (96^3 x 8) at batch 8 and a
# rank's batch 4 at two ranks
ROWS = [(8, 96, 96, 96), (4, 96, 96, 96)]
RAGGED = [(2, 4, 6, 8), (1, 6, 10, 22), (3, 2, 2, 2), (1, 10, 4, 6)]

# the warps' x pieces (e_x, a_x) and tx = a'x + t0x
_EX = (0, 0, -1, 1)
_AX = (0, 1, 1, 0)
_T0X = tuple(1 - a - 2 * e for a, e in zip(_AX, _EX))


def _round1024(n):
    return -(-n // 1024) * 1024


def _header_smem(p: PhasePiecesPlan) -> int:
    """``phase_pieces_smem_bytes`` of csrc/conv3_phase_pieces_dw.cuh, written
    out: a slot the p brick's rows and the g halo's, rounded to 1024."""
    halo = (p.td + 2) * (p.th + 2) * (p.tw + 2)
    return 2048 + p.stages * (p.td * p.th * p.tw * 128 + _round1024(halo * 128))


@pytest.mark.parametrize("dims", ROWS + RAGGED)
def test_pieces_plan_covers_every_block_voxel_once(dims):
    p = phase_pieces_plan(dims, 8, 8)
    b, d, h, w = dims[0], dims[1] // 2, dims[2] // 2, dims[3] // 2
    assert p.smem_bytes == _header_smem(p) <= SMEM_LIMIT
    assert 2 <= p.stages <= 4 and 1 <= p.splits <= SMS
    assert (p.td * p.th * p.tw) % 32 == 0 and p.td * p.th * p.tw <= fused_conv.PHASE_DW_MAX_ROWS
    nbz, nby, nbx = -(-d // p.td), -(-h // p.th), -(-w // p.tw)
    assert p.nbricks == b * nbz * nby * nbx and p.splits == min(p.nbricks, SMS)
    assert p.workspace == 4 * p.splits * 27 * 64
    seen = torch.zeros(b, nbz * p.td, nby * p.th, nbx * p.tw, dtype=torch.int32)
    for split in range(p.splits):
        for brick in range(split, p.nbricks, p.splits):
            r, x0 = divmod(brick, nbx)
            r, y0 = divmod(r, nby)
            bb, z0 = divmod(r, nbz)
            seen[bb, z0 * p.td:(z0 + 1) * p.td, y0 * p.th:(y0 + 1) * p.th,
                 x0 * p.tw:(x0 + 1) * p.tw] += 1
    assert bool((seen == 1).all())
    assert p.fill == pytest.approx(b * d * h * w / (p.nbricks * p.td * p.th * p.tw))


@pytest.mark.parametrize("dims", ROWS)
def test_pieces_plan_fills_the_card_at_the_rows(dims):
    p = phase_pieces_plan(dims, 8, 8)
    assert p.splits == SMS and p.fill == 1.0 and p.stages >= 3


def test_the_epilogue_writes_every_entry_once():
    """The kernel's map from a thread's accumulator entries (warpgroup tz,
    warp w: x piece, lane (g8, t4), tile T, half, j, e) to the four partials'
    (a'y, a'x, tap, ci, co), written out as the kernel computes it: each
    entry once, every other accumulator entry a tap outside 0..2."""
    seen = torch.zeros(2, 2, 27, 8, 8, dtype=torch.int32)
    kept = 0
    for wg, w, lane, t, half, j, e in itertools.product(range(3), range(4), range(32), range(2),
                                                         range(2), range(4), range(2)):
        g8, t4 = lane >> 2, lane & 3
        sy = 2 * t + half - 1
        apy, apx = j >> 1, j & 1
        ty, tx = apy + 1 - sy, apx + _T0X[w]
        if not (0 <= ty <= 2 and 0 <= tx <= 2):
            continue
        kept += 1
        seen[apy, apx, (wg * 3 + ty) * 3 + tx, 2 * t4 + e, g8] += 1
    assert bool((seen == 1).all())
    assert kept == 4 * 27 * 64  # 9/16 of the 3 x 2 tiles' 64 x 32 products


@pytest.mark.parametrize("c,co", [(16, 16), (8, 16), (16, 8), (4, 4)])
def test_pieces_plan_refuses_what_it_cannot_run(c, co):
    assert not fused_conv.phase_pieces_eligible(c, co)
    with pytest.raises(ValueError, match="phase pieces"):
        phase_pieces_plan((1, 8, 8, 8), c, co)


# ---- the rule ------------------------------------------------------------------------

def _probe(dims, c, dtype=torch.bfloat16, phase=True):
    b, d, h, w = dims
    shape = (b, d // 2, h // 2, w // 2, 8 * c) if phase else (b, d, h, w, c)
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("dims", ROWS)
def test_the_rows_take_the_pieces_body(dims):
    assert fused_conv.dw_body(_probe(dims, 8), 8, 8, True) == "phase_pieces"
    # f32 keeps the register-tiled body; the dense layout never takes it
    assert fused_conv.dw_body(_probe(dims, 8, torch.float32), 8, 8, True) == "f32_tiles"
    assert fused_conv.dw_body(_probe(dims, 8, phase=False), 8, 8, False) == "dense_rows"


def test_the_least_volume_lies_between_the_rows_timed():
    """The rule takes L = 64 from 48^3 x 8 at batch 1 (13824 block voxels;
    PERF.md: faster than the tensor-core body there and at every larger row
    timed) and leaves 32^3 at batch 1 (4096, slower) on the tensor-core
    body."""
    assert 16 ** 3 < fused_conv.PHASE_PIECES_MIN_POSITIONS <= 24 ** 3


def test_the_least_volume():
    least = fused_conv.PHASE_PIECES_MIN_POSITIONS  # block voxels: lines of one
    assert fused_conv.dw_body(_probe((1, 2, 2 * least, 2), 8), 8, 8, True) == "phase_pieces"
    assert fused_conv.dw_body(_probe((1, 2, 2 * (least - 1), 2), 8), 8, 8, True) == \
        "tensor_cores"


@pytest.mark.parametrize("dims,c,co,body", [
    ((8, 96, 96, 96), 16, 16, "phase_blocks"),  # packed UNETR's p 48^3 x 128: Ci >= 16 unchanged
    ((8, 48, 48, 48), 16, 16, "phase_blocks"),  # the flagship's L = 128
    ((8, 96, 96, 96), 8, 16, "tensor_cores"),  # Co != 8
    ((8, 96, 96, 96), 1, 8, "few_channels"),
])
def test_other_phase_rows_keep_their_bodies(dims, c, co, body):
    assert fused_conv.dw_body(_probe(dims, c), c, co, True) == body


# ---- the emulation -------------------------------------------------------------------

def _swizzle(e: torch.Tensor) -> torch.Tensor:
    """128-byte swizzle of a bf16 element index inside a 1024-aligned region:
    the 16-byte unit (bits 3-5) XOR the row within the 1024 bytes (bits 6-8)."""
    return e ^ (((e >> 6) & 7) << 3)


def _box(t: torch.Tensor, b: int, z0: int, y0: int, x0: int, bd: int, bh: int,
         bw: int) -> torch.Tensor:
    """A TMA box: the 64 lanes of t (B, D, H, W, 64) over bd x bh x bw voxels
    at (z0, y0, x0) of sample b, zero outside the grid: (rows, 64) in (z, y, x)
    order."""
    out = torch.zeros(bd, bh, bw, 64, dtype=t.dtype)
    _, d, h, w, _ = t.shape
    zs, ys, xs = [range(max(0, -o), min(n, e - o)) for o, n, e in
                  ((z0, bd, d), (y0, bh, h), (x0, bw, w))]
    if len(zs) and len(ys) and len(xs):
        out[zs.start:zs.stop, ys.start:ys.stop, xs.start:xs.stop] = t[
            b, z0 + zs.start:z0 + zs.stop, y0 + ys.start:y0 + ys.stop,
            x0 + xs.start:x0 + xs.stop]
    return out.reshape(-1, 64)


# lane l of an ldmatrix.x4.trans: k row (l & 7) + 8 (l >> 4), pair member (l >> 3) & 1
_LANE = torch.arange(32)
_KROW = (_LANE & 7) + ((_LANE >> 4) << 3)
_MEM = (_LANE >> 3) & 1


def emulate(pt, gt, dims, p: PhasePiecesPlan) -> torch.Tensor:
    """The phase pieces body on phase-major p and g (B, D/2, H/2, W/2, 64)
    (f32), as the card computes it: returns the (3, 3, 3, 8, 8) gradient."""
    b_, d, h, w = dims[0], dims[1] // 2, dims[2] // 2, dims[3] // 2
    hp, wp = p.th + 2, p.tw + 2
    nrows = p.td * p.th * p.tw
    halo = (p.td + 2) * hp * wp
    q = torch.arange(nrows)
    qz, qr = q // (p.th * p.tw), q % (p.th * p.tw)
    qtab = ((qz + 1) * hp + qr // p.tw + 1) * wp + qr % p.tw + 1  # brick position -> halo row
    nbz, nby, nbx = -(-d // p.td), -(-h // p.th), -(-w // p.tw)
    part = torch.zeros(p.splits, 2, 2, 27, 8, 8)  # [split][a'y][a'x][tap][ci][co]
    kk = torch.arange(16).reshape(-1, 1)
    nn = torch.arange(32).reshape(1, -1)
    for split in range(p.splits):
        acc = torch.zeros(3, 2, 64, 32)  # [tz][T]
        for brick in range(split, p.nbricks, p.splits):
            r, x0 = divmod(brick, nbx)
            r, y0 = divmod(r, nby)
            b, z0 = divmod(r, nbz)
            logical = torch.cat([
                _box(pt, b, z0 * p.td, y0 * p.th, x0 * p.tw, p.td, p.th, p.tw).reshape(-1),
                _box(gt, b, z0 * p.td - 1, y0 * p.th - 1, x0 * p.tw - 1, p.td + 2, p.th + 2,
                     p.tw + 2).reshape(-1),
                torch.zeros((_round1024(halo * 128) - halo * 128) // 2)])
            slot = torch.zeros_like(logical)
            slot[_swizzle(torch.arange(logical.numel()))] = logical
            gbase = nrows * 128  # bytes
            for ks, tz, apz, t in itertools.product(range(nrows // 16), range(3), range(2),
                                                    range(2)):
                # B: p's 32 lanes of a'z, MN-major by descriptor
                addr = ks * 2048 + apz * 64 + 2 * nn + 128 * (kk % 8) + 1024 * (kk // 8)
                b_op = slot[_swizzle(addr // 2)]  # (16, 32)
                # A: each warp's 16 rows x 16 positions by its lanes' ldmatrix addresses
                sz, sy = apz + 1 - tz, 2 * t + _MEM - 1
                a_op = torch.zeros(64, 16)
                for wv in range(4):
                    hr = qtab[16 * ks + _KROW] + ((sz >> 1) * hp + (sy >> 1)) * wp + _EX[wv]
                    lo = ((sz & 1) * 4 + (sy & 1) * 2 + _AX[wv]) * 8
                    byte = gbase + hr * 128 + (((lo >> 3) ^ (hr & 7)) << 4)
                    vals = slot[(byte // 2).reshape(-1, 1) + torch.arange(8)]  # (32 lanes, 8 co)
                    rows = (16 * wv + 8 * _MEM).reshape(-1, 1) + torch.arange(8)
                    a_op[rows, _KROW.reshape(-1, 1).expand(-1, 8)] = vals
                acc[tz, t] += a_op @ b_op
        for tz, t, wv, r, col in itertools.product(range(3), range(2), range(4), range(16),
                                                   range(32)):
            sy = 2 * t + r // 8 - 1
            apy, apx, ci = col >> 4, (col >> 3) & 1, col & 7
            ty, tx = apy + 1 - sy, apx + _T0X[wv]
            if 0 <= ty <= 2 and 0 <= tx <= 2:
                part[split, apy, apx, (tz * 3 + ty) * 3 + tx, ci, r % 8] = \
                    acc[tz, t, 16 * wv + r, col]
    flat = part.reshape(4 * p.splits, 27 * 64)
    out = flat[0].clone()
    for k in range(1, 4 * p.splits):  # the second pass: partials in split, a'y, a'x order
        out += flat[k]
    return out.reshape(3, 3, 3, 8, 8)


def _rand(rng, shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _variants(dims):
    """The wrapper's plan and variants on other bricks and split counts."""
    p = phase_pieces_plan(dims, 8, 8)
    b, d, h, w = dims[0], dims[1] // 2, dims[2] // 2, dims[3] // 2
    out = [p]
    for brick, splits in (((1, 2, 16), 2), ((2, 2, 8), 3), ((1, 4, 8), 1)):
        nb = b * -(-d // brick[0]) * -(-h // brick[1]) * -(-w // brick[2])
        out.append(dataclasses.replace(p, td=brick[0], th=brick[1], tw=brick[2],
                                       splits=min(splits, nb), nbricks=nb))
    return out


@pytest.mark.parametrize("dims", RAGGED)
def test_emulated_body_matches_plain(dims):
    rng = np.random.default_rng(dims[1] + dims[3])
    shape = (dims[0], dims[1] // 2, dims[2] // 2, dims[3] // 2, 64)
    pt, gt = _rand(rng, shape), _rand(rng, shape)
    want = phase_conv.phase_conv_dw_plain(pt, gt)
    for p in _variants(dims):
        got = emulate(pt, gt, dims, p)
        assert (got - want).abs().max() <= 1e-5 * want.abs().max(), p


def test_emulated_body_matches_pallas():
    rng = np.random.default_rng(5)
    p_shape = (1, 2, 4, 8, 64)
    p_in = rng.standard_normal(p_shape).astype(np.float32)
    g = rng.standard_normal(p_shape).astype(np.float32)
    w = (0.1 * rng.standard_normal((3, 3, 3, 8, 8))).astype(np.float32)
    want = np.asarray(phase_gemm.phase_conv_gemm_dw(
        jnp.asarray(p_in), jnp.asarray(g), jnp.asarray(w), interpret=True))
    dims = (p_shape[0],) + tuple(2 * v for v in p_shape[1:4])
    got = emulate(torch.from_numpy(p_in), torch.from_numpy(g), dims,
                  phase_pieces_plan(dims, 8, 8))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
