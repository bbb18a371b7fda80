"""The register-tiled f32 conv and weight-gradient bodies
(``csrc/conv3_f32.cuh``, ``csrc/conv3_f32_dw.cuh``: f32 input, and bf16
input whose channel counts fit no tensor-core body) on the CPU.

The kernels run only on the card (``tests/test_torch_kernels_cuda.py``,
``chip_smoke.py``). Here:

- ``fused_conv.f32_plan`` / ``f32_dw_plan`` at the 3D i2i generator's rows,
  the flagship's f32 training shapes, packed UNETR's f32 one-channel input
  layer and ragged shapes: every output position covered by exactly one
  brick, every K unit (channel chunk, plane offset) by exactly one split,
  every (tap, ci, co) by exactly one dw block and every brick by exactly one
  position split, shared memory within the card's limit and equal to the C
  side's sum (written out here from the headers), the block counts at the
  i2i rows, and no accumulator chain of the weight gradient past
  ``F32_DW_CHAIN`` products;
- the rule (``conv_body``, ``dw_body``) over dtype x C x CO x layout: every
  input the CUDA-core bodies took before now names ``"f32_tiles"``, and
  every bf16 input that takes another body keeps it;
- :func:`emulate_conv` and :func:`emulate_dw`, plain PyTorch emulations of
  the two bodies: the bricks and N tiles, the halo staged per unit (zero
  outside the volume and past C), the K order (channel chunk, dz, then c,
  dy, dx) with a fresh partial per chunk added to the total, the split-K
  totals summed in split order with the epilogue after the sum; the dw's tap
  groups, channel tiles, bricks walked split, split + splits, ..., the
  position groups' shares summed in group order and the splits in split
  order. Held in f32 against ``conv3d_plain`` / ``conv3d_dw_plain`` (and the
  phase layout's plain versions) within 1e-5 * max|ref|, and against the
  JAX package's ``pallas_conv.conv3d_pallas`` (``conv3d_packed_p``) and
  ``conv3d_packed_dw`` in interpret mode at shapes ``pallas_conv.supported``
  admits, within 1e-4 absolute + relative as ``test_torch_fused_conv.py``.
"""

from __future__ import annotations

import dataclasses
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from segmantic_tpu.ops import pallas_conv
from segmantic_tpu_torch.ops import fused_conv, phase_conv
from segmantic_tpu_torch.ops.fast_conv import depth_to_space
from segmantic_tpu_torch.ops.fused_conv import (F32_DW_CHAIN, SMEM_LIMIT, F32DwPlan, F32Plan,
                                                f32_dw_plan, f32_plan)

SMS = 132


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The emulations are many small tensor operations: one thread each, or
    the workers' thread pools contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (dims, C, CO): the 3D i2i generator's block convs (the parity case, the
# CLI's width on 32^3 and 64^3 inputs), the flagship's f32 training shapes at
# batch 8 (and the input gradient of its CI != CO conv), packed UNETR's f32
# one-channel input layer at full resolution (96^3 x 1 -> 16)
I2I_ROWS = [((1, 8, 8, 8), 64, 64), ((2, 8, 8, 8), 256, 256), ((1, 16, 16, 16), 256, 256)]
ROWS = I2I_ROWS + [((8, 48, 48, 48), 16, 16), ((8, 24, 24, 24), 32, 32),
                   ((8, 12, 12, 12), 64, 64), ((8, 6, 6, 6), 128, 128),
                   ((8, 6, 6, 6), 128, 256), ((8, 6, 6, 6), 256, 256),
                   ((8, 6, 6, 6), 256, 128), ((8, 96, 96, 96), 1, 16)]
RAGGED = [((2, 5, 7, 9), 12, 20), ((1, 6, 6, 6), 3, 7), ((3, 1, 1, 1), 64, 64),
          ((1, 3, 4, 70), 16, 16), ((2, 3, 1, 1), 1, 1)]
# blocks of the chosen plans at the i2i rows (H100: 132 multiprocessors)
I2I_BLOCKS = {((1, 8, 8, 8), 64, 64): (192, 256), ((2, 8, 8, 8), 256, 256): (256, 256),
              ((1, 16, 16, 16), 256, 256): (256, 256)}


# ---- the plans ---------------------------------------------------------------

def _row_pitch(tw: int) -> int:
    """``f32_row_pitch``: >= tw + 2 and 4 mod 8."""
    p = tw + 2
    while p % 8 != 4:
        p += 1
    return p


def _c_side_smem(p: F32Plan) -> int:
    """``f32_smem_bytes``, written out from ``csrc/conv3_f32.cuh``: per ring
    slot the halo [td][th+2][tw+2][round4(ck)] and the weights [ck][9][nt],
    then the channel-major halo [ck][td][th+2][row pitch] and the halo
    positions' table (rounded to 4), 4 bytes each."""
    ckp = (p.ck + 3) // 4 * 4
    npos = p.td * (p.th + 2) * (p.tw + 2)
    return 4 * (p.stages * (npos * ckp + p.ck * 9 * p.nt)
                + p.ck * p.td * (p.th + 2) * _row_pitch(p.tw) + (npos + 3) // 4 * 4)


def _c_side_dw_smem(p: F32DwPlan) -> int:
    """``f32_dw_smem_bytes``, written out from ``csrc/conv3_f32_dw.cuh``: the
    tables of the halo's and the brick's positions (each rounded to 4), then
    the larger of the ring (per slot the tap group's halo at an odd number of
    channel quads and the dy brick [p][nt + 4]) and the position groups'
    tiles (threads x 64), 4 bytes each."""
    positions = p.td * p.th * p.tw
    ckp = (p.ci + 3) // 4 * 4
    ckp += 4 if ckp % 8 == 0 else 0
    nh = (p.td + (2 if p.taps == 27 else 0)) * (p.th + 2) * (p.tw + 2)
    ring = p.stages * (nh * ckp + positions * (p.nt + 4))
    red = p.threads * 64 if p.npg > 1 else 0
    return 4 * ((nh + 3) // 4 * 4 + (positions + 3) // 4 * 4 + max(ring, red))


def _bricks(p, dims):
    """(b, z0, y0, x0) of every brick in block order (x fastest)."""
    b, d, h, w = dims
    nbz, nby, nbx = -(-d // p.td), -(-h // p.th), -(-w // p.tw)
    for i in range(b * nbz * nby * nbx):
        bx, r = i % nbx, i // nbx
        by, r = r % nby, r // nby
        bz, bb = r % nbz, r // nbz
        yield bb, bz * p.td, by * p.th, bx * p.tw


def _covered_once(p, dims) -> bool:
    b, d, h, w = dims
    seen = torch.zeros(dims, dtype=torch.int32)
    for bb, z0, y0, x0 in _bricks(p, dims):
        seen[bb, z0:z0 + p.td, y0:y0 + p.th, x0:x0 + p.tw] += 1
    return bool((seen == 1).all())


def _tile(p: F32DwPlan, tile: int):
    """(tap group, first ci, first co) of dw tile ``tile`` (blockIdx.y), the
    tap group fastest."""
    return tile % p.n_tg, tile // p.n_tg % p.n_ci * p.ci, tile // p.n_tg // p.n_ci * p.nt


def _unit_range(split: int, units: int, splits: int):
    return split * units // splits, (split + 1) * units // splits


def _thread_count(p: F32Plan) -> int:
    """The brick's rows of 4 W positions x nt / 8 channel groups."""
    return p.td * p.th * (p.tw // 4) * (p.nt // 8)


@pytest.mark.parametrize("dims,c,co", ROWS + RAGGED)
def test_f32_plan_covers_every_position_and_k_unit_once(dims, c, co):
    p = f32_plan(dims, c, co)
    assert p.tw % 4 == 0 and p.nt in (16, 32, 64) and 1 <= p.ck <= 16
    assert p.threads == _thread_count(p) and p.threads % 32 == 0 and 128 <= p.threads <= 256
    assert p.nbricks == sum(1 for _ in _bricks(p, dims))
    if dims[0] * dims[1] * dims[2] * dims[3] <= 2 ** 16:
        assert _covered_once(p, dims)
    assert p.n_tiles == -(-co // p.nt) and p.n_tiles * p.nt < co + p.nt
    assert p.units == 3 * -(-c // p.ck)
    units = [u for s in range(p.splits) for u in range(*_unit_range(s, p.units, p.splits))]
    assert units == list(range(p.units))  # each unit in exactly one split, in order
    assert all(_unit_range(s, p.units, p.splits)[1] > _unit_range(s, p.units, p.splits)[0]
               for s in range(p.splits))
    assert p.smem_bytes == _c_side_smem(p) == fused_conv.f32_smem_bytes(
        p.td, p.th, p.tw, p.nt, p.ck, p.stages)
    assert p.smem_bytes + 1024 <= 233472 and p.smem_bytes <= SMEM_LIMIT
    assert p.blocks == p.nbricks * p.n_tiles * p.splits
    assert p.workspace == (p.splits * dims[0] * dims[1] * dims[2] * dims[3] * co
                           if p.splits > 1 else 0)


@pytest.mark.parametrize("dims,c,co", ROWS + RAGGED)
def test_f32_dw_plan_covers_every_output_and_brick_once(dims, c, co):
    p = f32_dw_plan(dims, c, co)
    assert p.taps in (9, 27) and p.nt in (8, 16, 32, 64) and 128 <= p.threads <= 256
    assert p.threads == p.npg * -(-p.taps * p.ci // 8) * (p.nt // 8)
    assert p.grid == (p.splits, p.n_tg * p.n_ci * p.n_co)
    seen = torch.zeros((27, c, co), dtype=torch.int32)
    for tile in range(p.grid[1]):  # the tap group fastest, as the kernel decodes blockIdx.y
        tg, ci0, co0 = _tile(p, tile)
        seen[tg * p.taps:(tg + 1) * p.taps, ci0:ci0 + p.ci, co0:co0 + p.nt] += 1
    assert bool((seen == 1).all())
    walked = sorted(k for s in range(p.splits) for k in range(s, p.nbricks, p.splits))
    assert walked == list(range(p.nbricks)) == list(range(sum(1 for _ in _bricks(p, dims))))
    assert p.npg <= p.td * p.th  # a position group takes whole (z, y) rows
    per_group = -(-p.td * p.th // p.npg) * p.tw
    assert p.chain == -(-p.nbricks // p.splits) * per_group <= F32_DW_CHAIN
    assert p.smem_bytes == _c_side_dw_smem(p) == fused_conv.f32_dw_smem_bytes(
        p.td, p.th, p.tw, p.taps, p.ci, p.nt, p.npg, p.stages)
    assert p.smem_bytes + 1024 <= 233472
    assert p.workspace == (p.splits * 27 * c * co if p.splits > 1 else 0)


@pytest.mark.parametrize("dims,c,co", I2I_ROWS)
def test_f32_plans_fill_the_card_at_the_i2i_rows(dims, c, co):
    """The i2i rows have 512-4,096 positions: K splits (forward) and small
    tap groups or position groups (dw) give every row at least 132 blocks."""
    p, q = f32_plan(dims, c, co, SMS), f32_dw_plan(dims, c, co, SMS)
    assert (p.blocks, q.grid[0] * q.grid[1]) == I2I_BLOCKS[(dims, c, co)]
    assert p.blocks >= SMS and q.grid[0] * q.grid[1] >= SMS


@pytest.mark.parametrize("c,co", [(0, 8), (8, 0)])
def test_f32_plans_refuse_empty_channel_counts(c, co):
    for fn in (f32_plan, f32_dw_plan):
        with pytest.raises(ValueError, match="C, CO >= 1"):
            fn((1, 4, 4, 8), c, co)


# ---- the rule -----------------------------------------------------------------

@pytest.mark.parametrize("phase", [False, True], ids=["dense", "phase"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c,co", list(itertools.product((1, 3, 8, 12, 16, 20, 64, 72, 256),
                                                        (1, 5, 16, 20, 64, 128, 256))))
def test_every_former_cuda_core_input_takes_the_f32_bodies(phase, dtype, c, co):
    """The parent's rule, written out: f32 and the bf16 channel counts no
    tensor-core body takes went to "cuda_cores"; those now name "f32_tiles",
    the other bodies keep what they had but for the convs the mid-channel
    body took later."""
    x = torch.zeros((1, 2, 2, 2, 8 * c if phase else c), dtype=dtype)
    deep = dtype == torch.bfloat16 and not phase and c % 8 == 0 and co % 8 == 0 and c >= 64
    if dtype == torch.float32:
        conv = dw = "cuda_cores"
    elif c < 8:
        conv = dw = "few_channels"
    else:
        conv = "tensor_cores" if c % 8 == 0 else "cuda_cores"
        dw = "tensor_cores" if c % 8 == 0 and co % 8 == 0 else "cuda_cores"
    if deep and co >= 64:
        conv = "deep_channels"
    elif (conv == "tensor_cores" and c + co >= 48 and fused_conv.mid_eligible(c, co, phase)
          and x.shape[2] % 8 == 0 and x.shape[3] % 8 == 0):
        conv = "mid_channels"  # the mid-channel body at C + CO >= 48 (x has too few positions
        # for its dw body)
    if deep and co >= 128:
        dw = "deep_channels"
    assert fused_conv.conv_body(x, c, co, phase) == conv.replace("cuda_cores", "f32_tiles")
    assert fused_conv.dw_body(x, c, co, phase) == dw.replace("cuda_cores", "f32_tiles")


# ---- the emulations -------------------------------------------------------------

def _act(y, relu_mode, alpha):
    if relu_mode == "relu":
        return y.clamp_min(0)
    if relu_mode == "prelu":
        return torch.where(y >= 0, y, alpha.reshape(()) * y)
    return y


def emulate_conv(x, w, dims, p: F32Plan, scale=None, shift=None, alpha=None,
                 relu_mode="none"):
    """The f32 conv body on full-resolution channel-last x (B, D, H, W, C):
    for each brick, N tile and split, the units [u0, u1) staged one by one
    (the td planes z0 + dz - 1 ... of the (th+2) x (tw+2) halo of ck
    channels, zero outside the volume), each channel's nine (dy, dx) taps
    added to the chunk's fresh partial in c, dy, dx order, the partial added
    to the split's total at the chunk's end (or the split's); the splits'
    totals summed in split order, then y = act(sum * scale + shift)."""
    b, d, h, wd = dims
    c, co = w.shape[-2:]
    pad = (p.td + 2, p.th + 2, p.tw + 2)
    xp = F.pad(x, (0, 0, 1, pad[2], 1, pad[1], 1, pad[0]))  # room for ragged bricks
    totals = torch.zeros((p.splits, b, d + p.td, h + p.th, wd + p.tw, co))
    for split in range(p.splits):
        u0, u1 = _unit_range(split, p.units, p.splits)
        for bb, z0, y0, x0 in _bricks(p, dims):
            for t in range(p.n_tiles):
                n0, n1 = t * p.nt, min(co, (t + 1) * p.nt)
                part = torch.zeros((p.td, p.th, p.tw, n1 - n0))
                tot = torch.zeros_like(part)
                for u in range(u0, u1):
                    c0, dz = (u // 3) * p.ck, u % 3
                    # staged: planes z0 + dz - 1 + [0, td), rows y0 - 1 + [0, th + 2), ...
                    halo = xp[bb, z0 + dz:z0 + dz + p.td, y0:y0 + p.th + 2, x0:x0 + p.tw + 2,
                              c0:c0 + p.ck]
                    for ci in range(halo.shape[-1]):
                        for dy, dx in itertools.product(range(3), range(3)):
                            a = halo[:, dy:dy + p.th, dx:dx + p.tw, ci].unsqueeze(-1)
                            part = part + a * w[dz, dy, dx, c0 + ci, n0:n1]
                    if u % 3 == 2 or u == u1 - 1:
                        tot, part = tot + part, torch.zeros_like(part)
                totals[split, bb, z0:z0 + p.td, y0:y0 + p.th, x0:x0 + p.tw, n0:n1] = tot
    s = totals[0]
    for k in range(1, p.splits):
        s = s + totals[k]
    s = s[:, :d, :h, :wd]
    scale = torch.ones(co) if scale is None else scale
    shift = torch.zeros(co) if shift is None else shift
    return _act(s * scale + shift, relu_mode, alpha)


def emulate_dw(x, dy, dims, p: F32DwPlan):
    """The f32 dw body on full-resolution channel-last x (B, D, H, W, C) and
    dy (B, D, H, W, CO): each block (tap group, ci tile, co tile) walks the
    bricks split, split + splits, ...; per brick the tap group's halo and the
    dy brick (zero outside the volume), position group pg taking the brick's
    (z, y) rows pg, pg + npg, ... and each row's positions in x order; the
    groups' tiles summed in group order, the splits' partials in split
    order."""
    b, d, h, wd = dims
    c, co = x.shape[-1], dy.shape[-1]
    xp = F.pad(x, (0, 0, 1, p.tw + 2, 1, p.th + 2, 1, p.td + 2))
    dyp = F.pad(dy, (0, 0, 0, p.tw, 0, p.th, 0, p.td))
    positions = p.td * p.th * p.tw
    pz, py, px = (torch.arange(positions) // (p.th * p.tw), torch.arange(positions) // p.tw % p.th,
                  torch.arange(positions) % p.tw)
    parts = torch.zeros((p.splits, 27, c, co))
    bricks = list(_bricks(p, dims))
    for tile in range(p.grid[1]):
        tg, ci0, co0 = _tile(p, tile)
        taps = range(tg * p.taps, (tg + 1) * p.taps)
        cs, ns = slice(ci0, min(c, ci0 + p.ci)), slice(co0, min(co, co0 + p.nt))
        for split in range(p.splits):
            acc = torch.zeros((p.npg, p.taps, cs.stop - cs.start, ns.stop - ns.start))
            for k in range(split, p.nbricks, p.splits):
                bb, z0, y0, x0 = bricks[k]
                g = dyp[bb, z0 + pz, y0 + py, x0 + px, ns]  # (positions, n)
                for ti, t in enumerate(taps):
                    kz, ky, kx = t // 9, t // 3 % 3, t % 3
                    a = xp[bb, z0 + pz + kz, y0 + py + ky, x0 + px + kx, cs]  # (positions, ci)
                    for pos in range(positions):  # row pos // tw of the brick
                        acc[pos // p.tw % p.npg, ti] += a[pos].unsqueeze(-1) * g[pos]
            s = acc[0]
            for grp in range(1, p.npg):
                s = s + acc[grp]
            parts[split, taps.start:taps.stop, cs, ns] = s
    out = parts[0]
    for k in range(1, p.splits):
        out = out + parts[k]
    return out.reshape(3, 3, 3, c, co)


def _rand(rng, shape, scale=1.0):
    return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32))


def _conv_plans(dims, c, co):
    """The chosen plan, the same with two and three K splits (mid-chunk
    ranges) and with the other thread tile where the brick allows it."""
    p = f32_plan(dims, c, co)
    plans = [p]
    for splits in (2, 3):
        if splits <= p.units and splits != p.splits:
            plans.append(dataclasses.replace(p, splits=splits))
    return plans


def _dw_plans(dims, c, co):
    """The chosen plan, one split and three, and the other tap group (27 or 9)."""
    p = f32_dw_plan(dims, c, co)
    plans = [p] + [dataclasses.replace(p, splits=s) for s in (1, 3)
                   if s <= p.nbricks and s != p.splits]
    for taps in (27, 9):
        if taps != p.taps:
            plans.append(dataclasses.replace(p, taps=taps, n_tg=27 // taps,
                                             grid=(p.splits, 27 // taps * p.n_ci * p.n_co)))
    return plans


@pytest.mark.parametrize("dims,c,co", [
    ((2, 5, 7, 9), 12, 20),  # ragged bricks, a partial chunk, CO past a 16 tile
    ((1, 4, 6, 8), 20, 16),  # two chunks of 16 / 4 channels
    ((1, 6, 6, 6), 3, 7),  # fewer channels than a quad
])
def test_emulated_conv_matches_plain(dims, c, co):
    rng = np.random.default_rng(40)
    x, w = _rand(rng, dims + (c,)), _rand(rng, (3, 3, 3, c, co), 0.1)
    scale, shift = _rand(rng, (co,)).abs() + 0.5, _rand(rng, (co,), 0.1)
    alpha = torch.tensor([0.2])
    want = fused_conv.conv3d_plain(x, w, None, scale, shift, alpha, relu_mode="prelu")
    for p in _conv_plans(dims, c, co):
        got = emulate_conv(x, w, dims, p, scale, shift, alpha, "prelu")
        assert (got - want).abs().max() <= 1e-5 * want.abs().max(), p


def test_emulated_conv_matches_plain_in_the_phase_layout():
    """The phase layout is the same arithmetic over the full-resolution grid:
    the emulation on depth_to_space(p), against phase_conv_plain."""
    rng = np.random.default_rng(41)
    p_in, w = _rand(rng, (1, 2, 3, 4, 8 * 2)), _rand(rng, (3, 3, 3, 2, 5), 0.1)
    dims = (1, 4, 6, 8)
    want = depth_to_space(phase_conv.phase_conv_plain(p_in, w), 5)
    got = emulate_conv(depth_to_space(p_in, 2), w, dims, f32_plan(dims, 2, 5))
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.parametrize("dims,c,co", [((1, 4, 5, 7), 12, 20), ((1, 3, 4, 8), 2, 8)])
def test_emulated_dw_matches_plain(dims, c, co):
    rng = np.random.default_rng(42)
    x, dy = _rand(rng, dims + (c,)), _rand(rng, dims + (co,))
    want = fused_conv.conv3d_dw_plain(x, dy)
    for p in _dw_plans(dims, c, co):
        got = emulate_dw(x, dy, dims, p)
        assert (got - want).abs().max() <= 1e-5 * want.abs().max(), p


def test_emulated_dw_matches_plain_in_the_phase_layout():
    rng = np.random.default_rng(43)
    p_in, g = _rand(rng, (1, 2, 2, 3, 8 * 3)), _rand(rng, (1, 2, 2, 3, 8 * 4))
    dims = (1, 4, 4, 6)
    want = phase_conv.phase_conv_dw_plain(p_in, g)
    got = emulate_dw(depth_to_space(p_in, 3), depth_to_space(g, 4), dims, f32_dw_plan(dims, 3, 4))
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.parametrize("x_shape,co", [((2, 3, 4, 8, 32), 16), ((1, 3, 4, 8, 64), 64)])
def test_emulated_bodies_match_pallas(x_shape, co):
    assert pallas_conv.supported(x_shape, co)
    rng = np.random.default_rng(44)
    c = x_shape[-1]
    x = rng.standard_normal(x_shape).astype(np.float32)
    w = (0.1 * rng.standard_normal((3, 3, 3, c, co))).astype(np.float32)
    dy = rng.standard_normal(x_shape[:4] + (co,)).astype(np.float32)
    bias = rng.standard_normal(co).astype(np.float32)
    dims = x_shape[:4]
    want = np.asarray(pallas_conv.conv3d_pallas(jnp.asarray(x), jnp.asarray(w),
                                                bias=jnp.asarray(bias), interpret=True))
    p = dataclasses.replace(f32_plan(dims, c, co), splits=4)  # the partials and their sum
    got = emulate_conv(torch.from_numpy(x), torch.from_numpy(w), dims, p,
                       shift=torch.from_numpy(bias))  # bias alone: shift with scale 1
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
    want_dw = np.asarray(pallas_conv.conv3d_packed_dw(jnp.asarray(x), jnp.asarray(dy),
                                                      interpret=True))
    got_dw = emulate_dw(torch.from_numpy(x), torch.from_numpy(dy), dims,
                        dataclasses.replace(f32_dw_plan(dims, c, co), splits=2))
    np.testing.assert_allclose(got_dw.numpy(), want_dw, atol=1e-4, rtol=1e-4)
