"""The dense Hopper bodies of kernels 1 and 2 (``csrc/conv3_dense.cuh``,
``csrc/conv3_dense_dw.cuh``: bf16 NDHWC with C = CO = 8 or 16 and W * C a
multiple of 64) on the CPU.

The kernels run only on the card (``tests/test_torch_kernels_cuda.py``,
``chip_smoke.py``, ``probe_dense_rows.py``). Here:

- ``fused_conv.dense_fwd_plan`` / ``dense_dw_plan`` at the flagship's 48^3 x
  16 rows (serving batch 4, training batch 8), SegResNet's 96^3 x 8 and
  UNETR(pack=False)'s 96^3 x 16 (batch 8) and ragged shapes: the bricks (8 z x
  8 y of one 128-byte row) tile the grid, the blocks' warpgroups walk every
  brick once, every row and lane is written once, shared memory equals the
  headers' sums (written out here) within the card's limit, and the rows fill
  the card;
- the rule (``conv_body``, ``dw_body``): which rows take the new bodies and
  which keep the tensor-core, mid, deep, few-channel, phase or f32 body;
- the packed weights (``pack_weights_dense``) against the DHWIO weights;
- :func:`emulate_fwd` and :func:`emulate_dw`, plain PyTorch emulations of the
  bodies read as the card reads them: the TMA boxes (the forward's window of
  64 lanes and tail of 2 C, the dw's windows and dy's halves) at their lane
  starts, zero outside the lines, written swizzled at their rows' width (128,
  64 or 32 bytes) into a ring slot; A and B of every k16 step through their
  descriptors (starts moved by the (tz, ty) shift and the k16 step, SBO the
  box's row pitch; the dw's MN-major rows) and the address-based swizzles;
  the forward's epilogue (the tail's accumulator into the last 2 C columns,
  scale and shift of the true channel, the activation) and the dw's per-block
  sums of the diagonal blocks and the fixed-order sum of the partials. Held in f32
  against ``conv3d_plain`` / ``conv3d_dw_plain`` within 1e-5 * max|ref| (sums
  of a few hundred or thousand products in another order) and against the JAX
  package's ``pallas_conv.conv3d_pallas`` / ``conv3d_packed_dw`` in interpret
  mode within 1e-4 absolute + relative.
"""

from __future__ import annotations

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmantic_tpu.ops import pallas_conv
from segmantic_tpu_torch.ops import fused_conv
from segmantic_tpu_torch.ops.fused_conv import SMEM_LIMIT, dense_dw_plan, dense_fwd_plan

SMS = 132


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The emulation is many small tensor operations: one thread, or the
    workers' thread pools contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (dims, C): the flagship's 48^3 x 16 at the serving batch (4) and the training
# batch (8), SegResNet's 96^3 x 8 and UNETR(pack=False)'s 96^3 x 16 (batch 8)
ROWS = [((4, 48, 48, 48), 16), ((8, 48, 48, 48), 16), ((8, 96, 96, 96), 8),
        ((8, 96, 96, 96), 16)]
RAGGED = [((1, 10, 9, 8), 16), ((2, 7, 12, 24), 8), ((1, 3, 17, 4), 16), ((3, 9, 2, 16), 8)]


def _round1024(n):
    return -(-n // 1024) * 1024


def _fwd_header_smem(c: int, stages: int) -> int:
    """``dense_fwd_smem_bytes`` of csrc/conv3_dense.cuh, written out: the
    weights (9 tiles of 64 x 128 bytes; the tail's 9 c / 8 steps in tiles of
    2 c x 128 bytes, 4 steps a tile: 3 of 16 rows at c = 8, 5 of 32 at c =
    16); a slot the window's 10 x 10 rows of 128 bytes and the tail's of 4 c."""
    tail_tiles = {8: 3, 16: 5}[c]
    return (2048 + 9 * 64 * 128 + tail_tiles * 2 * c * 128
            + stages * (_round1024(100 * 128) + _round1024(100 * 4 * c)))


def _dw_header_smem(stages: int) -> int:
    """``dense_dw_smem_bytes`` of csrc/conv3_dense_dw.cuh, written out: a
    slot dy's two halves of 8 x 8 rows of 64 bytes and two windows of 10 x
    10 rows."""
    return 2048 + stages * (2 * 64 * 64 + 2 * _round1024(100 * 128))


def _origin(brick, nrows, nby, nbz):
    r, j = divmod(brick, nrows)
    r, yb = divmod(r, nby)
    b, zb = divmod(r, nbz)
    return b, zb * 8, yb * 8, j


@pytest.mark.parametrize("dims,c", ROWS + RAGGED)
def test_dense_plans_cover_every_row_and_lane_once(dims, c):
    b, d, h, w = dims
    p = dense_fwd_plan(dims, c, c)
    q = dense_dw_plan(dims, c, c)
    nrows, nby, nbz = w * c // 64, -(-h // 8), -(-d // 8)
    assert p.nbricks == q.nbricks == b * nbz * nby * nrows and p.nrows == q.nrows == nrows
    for grid_x, nwg in ((p.grid_x, p.nwg), (q.grid_x, 1)):
        walked = sorted(brick for bx in range(grid_x)
                        for brick in range(bx, p.nbricks, grid_x))
        assert walked == list(range(p.nbricks))  # every brick by exactly one block
        assert 1 <= grid_x <= p.nbricks
    # the forward's warpgroups take turns: brick k of a block to warpgroup k % 2
    per_wg = [sum(len(range(k, len(range(bx, p.nbricks, p.grid_x)), p.nwg))
                  for bx in range(p.grid_x)) for k in range(p.nwg)]
    assert sum(per_wg) == p.nbricks
    assert p.fill == pytest.approx(q.fill) == pytest.approx(b * d * h * nrows
                                                            / (p.nbricks * 64))
    if b * d * h * nrows <= 20000:  # every (row, lane) of the output stored once
        hits = np.zeros((b, d, h, nrows * 64), dtype=np.int64)
        for brick in range(p.nbricks):
            bb, z0, y0, j = _origin(brick, nrows, nby, nbz)
            for r in range(64):  # the epilogue's rows: (z, y) = (r // 8, r % 8)
                z, y = z0 + r // 8, y0 + r % 8
                if z < d and y < h:
                    hits[bb, z, y, 64 * j:64 * j + 64] += 1
        assert np.all(hits == 1)
    assert p.nwg <= p.stages <= 8
    assert p.smem_bytes == _fwd_header_smem(c, p.stages) <= SMEM_LIMIT
    assert fused_conv.dense_fwd_smem_bytes(c, p.stages) == p.smem_bytes
    assert p.ksteps == 36 + 9 * c // 8
    assert q.smem_bytes == _dw_header_smem(q.stages) <= SMEM_LIMIT
    assert q.stages * (8 * 1024 + 26 * 1024) >= 3 * 3 * 2 * 64 * 33 * 4  # the sums fit the ring
    assert q.workspace == q.grid_x * 27 * c * c


@pytest.mark.parametrize("dims,c", ROWS)
def test_dense_plans_fill_the_card_at_the_rows(dims, c):
    p, q = dense_fwd_plan(dims, c, c), dense_dw_plan(dims, c, c)
    assert p.grid_x == q.grid_x == SMS, (p, q)  # a block a multiprocessor
    assert p.nbricks >= p.grid_x * p.nwg  # every warpgroup has a brick
    assert p.fill == q.fill == 1.0 and (p.stages, q.stages) == ({8: 8, 16: 6}[c], 6)


@pytest.mark.parametrize("c,co,w", [(8, 16, 96), (16, 8, 96), (32, 32, 96), (4, 4, 96),
                                    (16, 16, 42), (8, 8, 12)])
def test_dense_plans_refuse_what_they_cannot_run(c, co, w):
    assert not fused_conv.dense_eligible(c, co, w)
    with pytest.raises(ValueError, match="dense Hopper"):
        dense_fwd_plan((1, 8, 8, w), c, co)
    with pytest.raises(ValueError, match="dense Hopper"):
        dense_dw_plan((1, 8, 8, w), c, co)


# ---- the rule ------------------------------------------------------------------------

def _probe(dims, c, dtype=torch.bfloat16):
    return torch.empty(tuple(dims) + (c,), dtype=dtype, device="meta")


@pytest.mark.parametrize("dims,c", ROWS)
def test_the_rows_take_the_dense_bodies(dims, c):
    x = _probe(dims, c)
    assert fused_conv.conv_body(x, c, c) == "dense_rows"
    assert fused_conv.dw_body(x, c, c) == "dense_rows"
    # f32 keeps the register-tiled bodies
    assert fused_conv.conv_body(_probe(dims, c, torch.float32), c, c) == "f32_tiles"
    assert fused_conv.dw_body(_probe(dims, c, torch.float32), c, c) == "f32_tiles"


@pytest.mark.parametrize("c", [8, 16])
def test_the_least_volumes_lie_between_the_rows_timed(c):
    """The least positions lie at or below the models' rows (48^3 x 16 at the
    serving batch and a rank's batch of 2; 96^3 x 8 at batch 8) and above the
    rows where the card timed the tensor-core body faster (PERF.md)."""
    conv, dw = fused_conv.DENSE_MIN_POSITIONS[c], fused_conv.DENSE_DW_MIN_POSITIONS[c]
    if c == 16:
        assert 16 ** 3 < conv <= 2 * 24 ** 3 and 2 * 24 ** 3 < dw <= 48 ** 3
        assert dw <= 2 * 48 ** 3  # a rank's step at four ranks
    else:
        assert 24 ** 3 < conv <= 48 ** 3 and 48 ** 3 < dw <= 8 * 96 ** 3


@pytest.mark.parametrize("dims,c,co,body", [
    ((8, 24, 24, 24), 32, 32, "mid_channels"),  # the flagship's 24^3 x 32
    ((8, 12, 12, 12), 32, 32, "tensor_cores"),  # 12^3 x 32: mid-eligible, not whole slabs
    ((8, 12, 12, 12), 64, 64, "deep_channels"),
    ((8, 96, 96, 96), 1, 8, "few_channels"),  # SegResNet's input layer
    ((8, 96, 96, 96), 8, 16, "tensor_cores"),  # C != CO
    ((8, 48, 48, 48), 16, 8, "tensor_cores"),
    ((8, 48, 48, 42), 16, 16, "tensor_cores"),  # W * C no multiple of 64
    ((8, 48, 48, 44), 8, 8, "tensor_cores"),
    ((8, 96, 96, 96), 12, 12, "f32_tiles"),
])
def test_other_dense_rows_keep_their_bodies(dims, c, co, body):
    assert fused_conv.conv_body(_probe(dims, c), c, co) == body


@pytest.mark.parametrize("c", [8, 16])
def test_the_least_volume(c):
    w = 64 // c  # one row a line: a line of H y at the least volume, and one less
    for least, body in ((fused_conv.DENSE_MIN_POSITIONS[c], fused_conv.conv_body),
                        (fused_conv.DENSE_DW_MIN_POSITIONS[c], fused_conv.dw_body)):
        assert body(_probe((1, 1, -(-least // w), w), c), c, c) == "dense_rows"
        assert body(_probe((1, 1, least // w - 1, w), c), c, c) == "tensor_cores"


def test_the_phase_layout_never_takes_the_dense_bodies():
    # the phase layout never takes the dense bodies
    p = torch.empty((8, 24, 24, 24, 128), dtype=torch.bfloat16, device="meta")
    assert fused_conv.conv_body(p, 16, 16, True) == "phase_lanes"
    assert fused_conv.dw_body(p, 16, 16, True) == "phase_blocks"


# ---- the packed weights --------------------------------------------------------------

@pytest.mark.parametrize("c", [8, 16])
def test_packed_weights_are_the_banded_kernel(c):
    """Each packed value, unswizzled, is w[tz, ty, tx, ci, co] at the tap tx
    = x' - x + 1 of its K lane's input voxel x' (counted from row j's first
    voxel: the window's from -1, the tail's u - 1 and u) and its column's
    output voxel x, zero where no tap exists and on the padding steps."""
    u, nt = 64 // c, 2 * c
    rng = np.random.default_rng(c)
    w = rng.standard_normal((3, 3, 3, c, c)).astype(np.float32)
    packed = fused_conv.pack_weights_dense(torch.from_numpy(w))
    assert packed.numel() * 2 == fused_conv.dense_w_bytes(c)
    main = fused_conv._swizzle128(packed[:9 * 64 * 64].view(9, 64, 64)).numpy()
    tail = fused_conv._swizzle128(packed[9 * 64 * 64:].view(-1, nt, 64)).numpy()
    assert tail.shape[0] == -(-9 * c // 8 // 4)

    def want(t, n, x_in, ci):
        x, co = divmod(n, c)
        tx = x_in - x + 1
        return w[t // 3, t % 3, tx, ci, co] if 0 <= tx <= 2 and t < 9 else 0.0

    for t, n, k in itertools.product(range(9), range(64), range(64)):
        assert main[t, n, k] == want(t, n, k // c - 1, k % c), (t, n, k)
    for tile, nn, k in itertools.product(range(tail.shape[0]), range(nt), range(64)):
        e, kk = 4 * tile + k // 16, k % 16  # step e = t c / 8 + q
        t, q = (e // (c // 8), e % (c // 8)) if e < 9 * c // 8 else (9, 0)
        lane = 16 * q + kk
        exp = want(t, 64 - nt + nn, u - 1 + lane // c, lane % c)
        assert tail[tile, nn, k] == exp, (tile, nn, k)
    # the window holds every tap but the tail's: tx = 2 of voxel u - 2 and tx
    # = 1, 2 of voxel u - 1
    nz = np.count_nonzero(main) + np.count_nonzero(tail)
    assert np.count_nonzero(tail) == 9 * 3 * c * c
    assert nz == 9 * 3 * u * c * c


# ---- the emulations ------------------------------------------------------------------

def _swizzle(e: torch.Tensor) -> torch.Tensor:
    """128-byte swizzle of a bf16 element index inside a 1024-aligned region:
    the 16-byte unit (bits 3-5) XOR the row within the 1024 bytes (bits 6-8)."""
    return e ^ (((e >> 6) & 7) << 3)


def _swizzle64(e: torch.Tensor) -> torch.Tensor:
    """64-byte swizzle of a bf16 element index inside a 512-aligned region:
    the 16-byte unit of a 64-byte row (bits 3-4) XOR bits 6-7 (the byte
    address's 4-5 XOR its 7-8)."""
    return e ^ (((e >> 6) & 3) << 3)


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


def _slot(boxes_and_sizes, swizzles=None) -> torch.Tensor:
    """Boxes written one after another at their 1024-aligned offsets, each
    swizzled as TMA writes it (128-byte unless ``swizzles`` names
    ``_swizzle64`` for it)."""
    parts, at = [], 0
    for k, (box, size) in enumerate(boxes_and_sizes):
        logical = torch.cat([box.reshape(-1), torch.zeros(size // 2 - box.numel())])
        swz = _swizzle if swizzles is None else swizzles[k]
        part = torch.zeros_like(logical)
        part[swz(torch.arange(at, at + logical.numel())) - at] = logical
        parts.append(part)
        at += logical.numel()
    return torch.cat(parts)


def _kmajor(buf: torch.Tensor, start: int, rows: int, sbo: int) -> torch.Tensor:
    """A K-major 128-byte-swizzled operand of ``rows`` rows x k16 read
    through a descriptor at byte ``start``: row r at (r // 8) SBO + (r % 8)
    128 bytes, k at 2 k bytes."""
    r = torch.arange(rows).view(-1, 1)
    addr = start + (r // 8) * sbo + (r % 8) * 128 + 2 * torch.arange(16).view(1, -1)
    return buf[_swizzle(addr // 2)]


def _mnmajor(buf: torch.Tensor, start: int, sbo: int, width: int = 64) -> torch.Tensor:
    """An MN-major operand (``width`` m or n x k16; 64: rows of 128 bytes,
    128-byte swizzled; 32: rows of 64 bytes, 64-byte swizzled) read through a
    descriptor at byte ``start``: k at (k // 8) SBO + (k % 8) row bytes, m at 2
    m bytes. Returns (k16, width)."""
    k = torch.arange(16).view(-1, 1)
    addr = start + (k // 8) * sbo + (k % 8) * 2 * width + 2 * torch.arange(width).view(1, -1)
    return buf[(_swizzle if width == 64 else _swizzle64)(addr // 2)]


BOX = _round1024(100 * 128)


def _swizzle32(e: torch.Tensor) -> torch.Tensor:
    """32-byte swizzle of a bf16 element index inside a 256-aligned region:
    the 16-byte half of a 32-byte row (bit 3) XOR bit 6 (the byte address's 4
    XOR its 7)."""
    return e ^ (((e >> 6) & 1) << 3)


def _rows(buf, start, rows, sbo, row_bytes, swizzle) -> torch.Tensor:
    """A K-major operand of ``rows`` rows x k16 read through a descriptor at
    byte ``start``: row r at (r // 8) SBO + (r % 8) row_bytes, k at 2 k bytes,
    the swizzle of the rows' width."""
    r = torch.arange(rows).view(-1, 1)
    addr = start + (r // 8) * sbo + (r % 8) * row_bytes + 2 * torch.arange(16).view(1, -1)
    return buf[swizzle(addr // 2)]


def emulate_fwd(x, w, scale, shift, alpha, relu_mode) -> torch.Tensor:
    """The dense Hopper conv body on x (B, D, H, W, C) (f32) with weights (3,
    3, 3, C, C), as the card computes it: returns (B, D, H, W, C) in f32."""
    b_, d, h, w_, c = x.shape
    p = dense_fwd_plan((b_, d, h, w_), c, c)
    lines = x.reshape(b_, d, h, w_ * c)
    nt, tb = 2 * c, 4 * c  # the tail's N and its rows' bytes
    tswz = _swizzle32 if c == 8 else _swizzle64
    wbuf = fused_conv.pack_weights_dense(w)
    wtail = fused_conv.DENSE_W_MAIN
    # B of every k16 step: the window's four per t, then the tail's c / 8
    bmain = [torch.cat([_kmajor(wbuf, t * 64 * 128 + 32 * q, 64, 1024).T for q in range(4)])
             for t in range(9)]  # (64 k, 64 n)
    btail = [torch.cat([_kmajor(wbuf, wtail + ((t * c // 8 + q) >> 2) * nt * 128
                                + ((t * c // 8 + q) & 3) * 32, nt, 1024).T
                        for q in range(c // 8)]) for t in range(9)]  # (2c k, 2c n)
    out = torch.zeros(b_, d, h, w_ * c)
    lanes_sc, lanes_sh = scale.float().repeat(64 // c), shift.float().repeat(64 // c)
    nby, nbz = -(-h // 8), -(-d // 8)
    tail_bytes = _round1024(100 * tb)
    for brick in range(p.nbricks):
        bb, z0, y0, j = _origin(brick, p.nrows, nby, nbz)
        window = _box(lines, bb, 64 * j - c, y0 - 1, z0 - 1, 10, 10)
        tail = _box(lines, bb, 64 * j + 64 - c, y0 - 1, z0 - 1, 10, 10)[:, :nt]
        slot = _slot([(window, BOX), (tail, tail_bytes)], [_swizzle, tswz])
        acc, acct = torch.zeros(64, 64), torch.zeros(64, nt)
        for t in range(9):
            row = (t // 3) * 10 + t % 3
            a = torch.cat([_kmajor(slot, row * 128 + 32 * q, 64, 1280) for q in range(4)], 1)
            acc += a @ bmain[t]
            at = torch.cat([_rows(slot, BOX + row * tb + 32 * q, 64, 10 * tb, tb, tswz)
                            for q in range(c // 8)], 1)
            acct += at @ btail[t]
        acc[:, 64 - nt:] += acct
        y = fused_conv.activation(acc * lanes_sc + lanes_sh, relu_mode, alpha)
        r = torch.arange(64)
        gz, gy = z0 + r // 8, y0 + r % 8
        real = (gz < d) & (gy < h)
        out[bb, gz[real], gy[real], 64 * j:64 * j + 64] = y[real]
    return out.reshape(b_, d, h, w_, c)


def emulate_dw(x, dy) -> torch.Tensor:
    """The dense Hopper dw body on x, dy (B, D, H, W, C) (f32), as the card
    computes it: per block its bricks' products into its three warpgroups'
    (tz) accumulators of the two halves of dy's row (each against its window
    of x) and three ty, the diagonal blocks summed in the kernel's order into
    its 27 taps, then the partials summed in block order. Returns (3, 3, 3, C,
    C) f32."""
    b_, d, h, w_, c = x.shape
    u = 64 // c
    uh = u // 2
    p = dense_dw_plan((b_, d, h, w_), c, c)
    xl, gl = x.reshape(b_, d, h, w_ * c), dy.reshape(b_, d, h, w_ * c)
    nby, nbz = -(-h // 8), -(-d // 8)
    half = 64 * 64  # bytes of a half of dy's brick: 64 rows of 64
    parts = torch.zeros(p.grid_x, 27, c, c)
    for bx in range(p.grid_x):
        g = torch.zeros(3, 3, 2, 64, 32)  # [tz][ty][half][x'' c + ci][x_l c + co]
        for brick in range(bx, p.nbricks, p.grid_x):
            bb, z0, y0, j = _origin(brick, p.nrows, nby, nbz)
            halves = [(_box(gl, bb, 64 * j + 32 * hh, y0, z0, 8, 8)[:, :32], half)
                      for hh in range(2)]
            windows = [(_box(xl, bb, 64 * j + (hh * uh - 1) * c, y0 - 1, z0 - 1, 10, 10), BOX)
                       for hh in range(2)]
            slot = _slot(halves + windows, [_swizzle64, _swizzle64, _swizzle, _swizzle])
            for q, hh, tz, ty in itertools.product(range(4), range(2), range(3), range(3)):
                bmat = _mnmajor(slot, hh * half + 2 * q * 8 * 64, 512, 32)  # (k, n)
                amat = _mnmajor(slot, 2 * half + hh * BOX + tz * 10 * 128
                                + (2 * q * 10 + ty) * 128, 1280)
                g[tz, ty, hh] += amat.T @ bmat
        blk = g.reshape(3, 3, 2, u, c, uh, c)  # [tz][ty][half][x''][ci][x_l][co]
        for tx in range(3):
            parts[bx, tx::3] = sum(blk[:, :, hh, xq + tx, :, xq] for hh in range(2)
                                   for xq in range(uh)).reshape(9, c, c)
    return parts.sum(0).reshape(3, 3, 3, c, c)


def _rand(rng, shape, scale=1.0):
    return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32))


def _bf16(t):
    return t.to(torch.bfloat16).float()  # the values the card reads


@pytest.mark.parametrize("dims,c,relu_mode", [((1, 10, 9, 8), 16, "prelu"),
                                              ((2, 7, 12, 24), 8, "relu"),
                                              ((1, 3, 17, 12), 16, "none"),
                                              ((1, 9, 2, 16), 8, "none")])
def test_emulated_forward_matches_plain(dims, c, relu_mode):
    rng = np.random.default_rng(c + dims[3])
    x = _bf16(_rand(rng, dims + (c,)))
    w = _bf16(_rand(rng, (3, 3, 3, c, c), 0.2))
    bias, scale, shift = _rand(rng, (c,), 0.1), _rand(rng, (c,)).abs() + 0.5, \
        _rand(rng, (c,), 0.1)
    alpha = torch.tensor([0.25])
    want = fused_conv.conv3d_plain(x, w, bias, scale, shift, alpha, relu_mode)
    s, t = fused_conv._epilogue_vectors(c, bias, scale, shift, x.device)
    got = emulate_fwd(x, w, s, t, alpha, relu_mode)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    # the input gradient's use: the same body on flipped, swapped weights
    wf = fused_conv.flip_io(w)
    s, t = fused_conv._epilogue_vectors(c, None, None, None, x.device)
    got = emulate_fwd(x, wf, s, t, None, "none")
    want = fused_conv.conv3d_plain(x, wf)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.parametrize("dims,c", [((1, 10, 9, 8), 16), ((2, 7, 12, 24), 8),
                                    ((1, 3, 17, 12), 16), ((1, 9, 2, 16), 8)])
def test_emulated_dw_matches_plain(dims, c):
    rng = np.random.default_rng(3 * c + dims[1])
    x, dy = _bf16(_rand(rng, dims + (c,))), _bf16(_rand(rng, dims + (c,)))
    want = fused_conv.conv3d_dw_plain(x, dy)
    got = emulate_dw(x, dy)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.parametrize("dims,c", [((2, 4, 6, 8), 16), ((1, 5, 4, 16), 8)])
def test_emulated_bodies_match_pallas(dims, c):
    rng = np.random.default_rng(7 + c)
    x = rng.standard_normal(dims + (c,)).astype(np.float32)
    w = (0.1 * rng.standard_normal((3, 3, 3, c, c))).astype(np.float32)
    dy = rng.standard_normal(dims + (c,)).astype(np.float32)
    want = np.asarray(pallas_conv.conv3d_pallas(jnp.asarray(x), jnp.asarray(w), interpret=True))
    s, t = fused_conv._epilogue_vectors(c, None, None, None, torch.device("cpu"))
    got = emulate_fwd(torch.from_numpy(x), torch.from_numpy(w), s, t, None, "none")
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
    want = np.asarray(pallas_conv.conv3d_packed_dw(jnp.asarray(x), jnp.asarray(dy),
                                                   interpret=True))
    got = emulate_dw(torch.from_numpy(x), torch.from_numpy(dy))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name,n_int", [("segk_fused_conv3_rows", 10),
                                        ("segk_fused_conv3_dw_rows", 9)])
def test_the_entry_points_have_their_ctypes_signatures(name, n_int):
    """The C entry points take the arguments ``launch_conv3`` /
    ``launch_conv3_dw`` pass: the pointers (and the forward's relu mode), the
    ints, the stream."""
    import re
    from pathlib import Path

    from segmantic_tpu_torch.ops import _cuda

    src = "fused_conv.cu" if name == "segk_fused_conv3_rows" else "fused_conv_dw.cu"
    text = (Path(_cuda._CSRC) / src).read_text()
    m = re.search(rf'extern "C" int {name}\(([^)]*)\)', text)
    kinds = [_cuda._P if "*" in a else _cuda._I for a in m.group(1).split(",")]
    assert _cuda._SIGNATURES[name] == kinds
    head = [_cuda._P] * 5 + [_cuda._I, _cuda._P] if n_int == 10 else [_cuda._P] * 4
    assert kinds == head + [_cuda._I] * n_int + [_cuda._P]
