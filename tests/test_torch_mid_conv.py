"""The mid-channel conv and weight-gradient bodies (``csrc/conv3_mid.cuh``,
``csrc/conv3_mid_dw.cuh``: bf16, C a multiple of 8 in the dense layout and of
16 in the phase layout) on the CPU.

The kernels run only on the card (``tests/test_torch_kernels_cuda.py``,
``chip_smoke.py``). Here:

- ``fused_conv.mid_plan`` / ``mid_dw_plan`` at every row of SegResNet, UNETR
  (packed and unpacked) and the flagship that the rule sends to them, and at
  ragged shapes: every output position covered by exactly one brick and
  slab, every (tap, ci) row by exactly one tile group and every position by
  exactly one split, the staged planes holding every tile group's rows,
  shared memory within the card's limit and equal to the C side's sum
  (written out here from the headers);
- the rule between the bodies (``conv_body``, ``dw_body``) and which convs of
  the four models take the new bodies;
- the packed weights of the forward: K-major core matrices per k16 step (C =
  8: tap pairs (0, none), (1, 2), ...), and back;
- :func:`emulate_conv` and :func:`emulate_dw`, plain PyTorch emulations of
  the two bodies read as the card reads them: the planes staged as the
  producers lay them (8 lanes a 16-byte entry, zero outside the grid and
  past C; the phase layout's per-input-phase planes one block early where
  the phase is odd), the tap
  table, the slabs' rows in (output phase, z, y, x) order, every wgmma
  operand read through its descriptor's start, LBO and SBO (A and B K-major
  in the forward; the dw's A rows by ldmatrix.trans lane addresses and B
  MN-major), the epilogue from the accumulator layout, and the dw's split
  partials summed in split order. Held in f32 against ``conv3d_plain`` /
  ``phase_conv_plain`` / the dw plain versions within 1e-5 * max|ref| (sums
  of a few thousand products in another order), and against the JAX
  package's Pallas kernels in interpret mode (``pallas_conv.conv3d_pallas``,
  ``conv3d_packed_dw``, ``phase_gemm.phase_conv_gemm``,
  ``phase_conv_gemm_dw``) within 1e-4 absolute + relative, as
  ``test_torch_conv_dw.py``.
"""

from __future__ import annotations

import dataclasses
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmantic_tpu.ops import pallas_conv, phase_gemm
from segmantic_tpu_torch.models import unet as punet
from segmantic_tpu_torch.ops import fused_conv, phase_conv
from segmantic_tpu_torch.ops.fast_conv import depth_to_space
from segmantic_tpu_torch.ops.fused_conv import (SMEM_LIMIT, MidDwPlan, MidPlan, mid_dw_plan,
                                                mid_plan)

SMS = 132


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The emulations are many small tensor operations: one thread each, or
    the workers' thread pools contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (dims at full resolution, C, CO, phase) of the rows: packed UNETR's phase
# stages at batch 8 (forward, input gradient, weight gradient), SegResNet's
# and UNETR's dense rows, the flagship's narrow rows at batch 8 and 4
FWD_ROWS = [((8, 96, 96, 96), 16, 16, True), ((8, 96, 96, 96), 32, 16, True),
            ((8, 96, 96, 96), 16, 32, True), ((8, 48, 48, 48), 32, 32, True),
            ((8, 48, 48, 48), 64, 32, True), ((8, 48, 48, 48), 32, 64, True),
            ((8, 96, 96, 96), 8, 8, False), ((8, 24, 24, 24), 32, 32, False),
            ((8, 12, 12, 12), 32, 32, False), ((4, 48, 48, 48), 16, 16, False),
            ((4, 24, 24, 24), 32, 32, False)]
# the dense weight gradients with C and CO multiples of 64 below the deep
# body's CO >= 128: UNETR's 24^3 / 12^3 rows, SegResNet's and the flagship's
# 12^3 x 64 at batch 8 (training) and 4 (a rank at two ranks)
DW_ROWS = [((8, 24, 24, 24), 64, 64), ((8, 24, 24, 24), 128, 64), ((8, 12, 12, 12), 64, 64),
           ((4, 12, 12, 12), 64, 64), ((2, 5, 7, 9), 64, 64), ((1, 3, 4, 70), 192, 64),
           ((3, 1, 1, 1), 64, 64)]
RAGGED = [((2, 5, 7, 9), 8, 5, False), ((1, 3, 4, 70), 24, 40, False),
          ((2, 6, 10, 18), 16, 8, True), ((1, 2, 4, 6), 32, 72, True), ((3, 1, 1, 1), 8, 8, False)]


def _grid(dims, phase):
    b, d, h, w = dims
    return (b,) + ((d // 2, h // 2, w // 2) if phase else (d, h, w))


def _round128(n):
    return -(-n // 128) * 128


def _c_side_smem(p: MidPlan, phase: bool) -> int:
    """``mid_smem_bytes`` of csrc/conv3_mid.cuh, written out."""
    pts = ((p.td + 1) * (p.th + 1) * (p.tw + 1) if phase
           else (p.td + 2) * (p.th + 2) * (p.tw + 2))
    ksteps = 14 if p.ck == 8 else 27
    stage = (8 if phase else 1) * (p.ck // 8) * (_round128(pts * 16) + 16)
    return 128 + 1024 + p.nchunks * ksteps * p.nt * 32 + p.stages * stage


def _c_side_dw_smem(p: MidDwPlan) -> int:
    """``mid_dw_smem_bytes`` of csrc/conv3_mid_dw.cuh, written out."""
    halo = -(-(p.td + 2) * (p.th + 2) * (p.tw + 2) * 128 // 1024) * 1024
    dy = -(-p.td * p.th * p.tw * 128 // 1024) * 1024
    return 1024 + 1024 + p.stages * (halo + dy)


def _brick_origin(brick, g, p):
    nbz, nby, nbx = (-(-g[1] // p.td), -(-g[2] // p.th), -(-g[3] // p.tw))
    x0 = brick % nbx * p.tw
    brick //= nbx
    y0 = brick % nby * p.th
    brick //= nby
    return brick // nbz, brick % nbz * p.td, y0, x0


def _slabs(p, phase):
    """(output phase, z, y, x) of each slab's first row, q = wg * spw + i."""
    per_phase = p.td * (p.th // 8) * (p.tw // 8)
    out = []
    for q in range(p.nwg * p.spw):
        ph, r = divmod(q, per_phase)
        out.append((ph, r // ((p.tw // 8) * (p.th // 8)), (r // (p.tw // 8)) % (p.th // 8) * 8,
                    r % (p.tw // 8) * 8))
    return out


@pytest.mark.parametrize("dims,c,co,phase", FWD_ROWS + RAGGED)
def test_mid_plan_covers_every_position_once(dims, c, co, phase):
    p = mid_plan(dims, c, co, phase, SMS)
    g = _grid(dims, phase)
    nph = 8 if phase else 1
    assert p.smem_bytes == _c_side_smem(p, phase) <= SMEM_LIMIT
    assert p.spw * p.nwg == nph * p.td * (p.th // 8) * (p.tw // 8)  # the slabs are the rows
    assert p.spw * p.nt <= 128 and 2 <= p.stages <= 4 and p.th % 8 == 0 and p.tw % 8 == 0
    assert p.nt >= min(co, 64) and p.n_tiles * p.nt >= co and (not phase or c % p.ck == 0)
    assert p.nchunks * p.ck >= c and p.ck == (8 if c == 8 else 16)
    assert (p.nwg == 4) == (p.nt == 64 and p.spw * p.nwg == 8)
    assert p.grid_x == min(p.nbricks, SMS)
    # the slabs' rows cover one brick, (output phase, z, y, x), once each
    slabs = torch.tensor(_slabs(p, phase))  # (slabs, 4): phase, z, y, x of row 0
    m = torch.arange(64)
    ph, z = slabs[:, 0:1].expand(-1, 64), slabs[:, 1:2].expand(-1, 64)
    y, x = slabs[:, 2:3] + m // 8, slabs[:, 3:4] + m % 8
    assert bool((z < p.td).all() and (y < p.th).all() and (x < p.tw).all())
    flat = ((ph * p.td + z) * p.th + y) * p.tw + x
    assert torch.equal(torch.bincount(flat.reshape(-1), minlength=nph * p.td * p.th * p.tw),
                       torch.ones(nph * p.td * p.th * p.tw, dtype=torch.long))
    # and the bricks' origins tile the grid, each once
    per_axis = [-(-e // t) for e, t in zip(g[1:], (p.td, p.th, p.tw))]
    assert p.nbricks == g[0] * int(np.prod(per_axis))
    origins = {_brick_origin(k, g, p) for k in range(p.nbricks)}
    assert origins == {(b, zb * p.td, yb * p.th, xb * p.tw) for b in range(g[0])
                       for zb in range(per_axis[0]) for yb in range(per_axis[1])
                       for xb in range(per_axis[2])}
    assert p.fill == pytest.approx(int(np.prod(g)) / (p.nbricks * p.td * p.th * p.tw))


@pytest.mark.parametrize("dims,c,co", DW_ROWS)
def test_mid_dw_plan_covers_every_output_and_position_once(dims, c, co):
    p = mid_dw_plan(dims, c, co, SMS)
    assert p.smem_bytes == _c_side_dw_smem(p) <= SMEM_LIMIT
    assert p.td * p.th * p.tw // 16 in (8, 12, 16) and p.nwg in (2, 3) and p.tpw in (2, 3)
    assert p.tw == 16 or (p.tw == 8 and p.th % 2 == 0)
    assert p.grid == (p.splits, p.n_tg * p.n_ci * p.n_co)
    assert p.workspace == (p.splits * 27 * c * co if p.splits > 1 else 0)
    seen = torch.zeros(27, c, co, dtype=torch.int32)
    for tile in range(p.grid[1]):
        tg, rest = tile % p.n_tg, tile // p.n_tg
        c0, co0 = rest % p.n_ci * 64, rest // p.n_ci * 64
        for wg in range(p.nwg):
            for t in range((tg * p.nwg + wg) * p.tpw, (tg * p.nwg + wg + 1) * p.tpw):
                if t < 27:
                    seen[t, c0:c0 + 64, co0:co0 + 64] += 1
    assert torch.all(seen == 1)
    walked = torch.zeros(p.nbricks, dtype=torch.int32)
    for split in range(p.splits):
        walked[split::p.splits] += 1
    assert torch.all(walked == 1)
    b, d, h, w = dims
    assert p.fill == pytest.approx(b * d * h * w / (p.nbricks * p.td * p.th * p.tw))


@pytest.mark.parametrize("c,co,phase", [(4, 8, False), (12, 16, False), (8, 16, True),
                                        (24, 16, True)])
def test_mid_plan_refuses_channel_counts_it_cannot_stage(c, co, phase):
    with pytest.raises(ValueError):
        mid_plan((1, 8, 8, 8), c, co, phase)


@pytest.mark.parametrize("c,co", [(32, 64), (64, 32), (96, 64), (64, 72)])
def test_mid_dw_plan_refuses_channels_without_128_byte_rows(c, co):
    with pytest.raises(ValueError):
        mid_dw_plan((1, 8, 8, 16), c, co)


@pytest.mark.parametrize("c,co,nt,ck", [(8, 8, 8, 8), (8, 5, 8, 8), (16, 16, 16, 16),
                                        (32, 24, 32, 16), (24, 40, 64, 16), (64, 16, 16, 16)])
def test_mid_packed_weights_are_core_matrices_and_round_trip(c, co, nt, ck):
    w = torch.randn(3, 3, 3, c, co)
    packed = fused_conv.pack_weights_mid(w, nt, ck)
    nchunks = -(-c // ck)
    ksteps = fused_conv.mid_ksteps(ck)
    assert packed.shape == (-(-co // nt), nchunks * ksteps * 2 * nt * 8)
    assert torch.equal(fused_conv.unpack_weights_mid(packed, c, co, ck), w)
    cm = packed.reshape(-1, nchunks, ksteps, 2, nt // 8, 8, 8)  # (tile, chunk, step, kg, ng, n, k)
    taps = [(0, None)] + [(2 * k - 1, 2 * k) for k in range(1, 14)]
    for tile, chunk, step, kg, ng in itertools.product(range(cm.shape[0]), range(nchunks),
                                                       range(ksteps), range(2), range(nt // 8)):
        if ck == 8:
            tap, cis = taps[step][kg], range(8)
        else:
            tap = step
            cis = range(chunk * ck + kg * 8, chunk * ck + kg * 8 + 8)
        cos = range(tile * nt + ng * 8, tile * nt + ng * 8 + 8)
        want = torch.zeros(8, 8)
        for n, o in enumerate(cos):
            for k, i in enumerate(cis):
                if tap is not None and o < co and i < c:
                    want[n, k] = w.reshape(27, c, co)[tap, i, o]
        assert torch.equal(cm[tile, chunk, step, kg, ng], want)


# ---- emulations of the two bodies ------------------------------------------

def _tap_offset(phase: bool, ph: int, t: int, hp: int, wp: int, npl: int, plane16: int) -> int:
    """``mid_tap_offset`` of csrc/conv3_mid.cuh."""
    e = (t // 9, t // 3 % 3, t % 3)
    if not phase:
        return (e[0] * hp + e[1]) * wp + e[2]
    ip, o = 0, []
    for k in range(3):
        s = (ph >> (2 - k) & 1) + e[k] - 1
        ip |= (s & 1) << (2 - k)
        o.append((s + 1) >> 1)
    return ip * npl * plane16 + (o[0] * hp + o[1]) * wp + o[2]


def _staged(t: torch.Tensor, b: int, base: int, c0: int, c: int, z0: int, y0: int, x0: int,
            bd: int, bh: int, bw: int) -> torch.Tensor:
    """One staged plane: lanes base + c0 .. base + c0 + 7 of (B, D, H, W,
    lanes) tensor t over the bw x bh x bd points at (z0, y0, x0) of sample b,
    zero outside the grid and at channels c0 + k >= c, flattened to the (z,
    y, x) order of its 16-byte entries."""
    out = torch.zeros(bd, bh, bw, 8, dtype=t.dtype)
    _, d, h, w, _ = t.shape
    zs, ys, xs = [range(max(0, -o), min(n, e - o)) for o, n, e in
                  ((z0, bd, d), (y0, bh, h), (x0, bw, w))]
    k = max(0, min(8, c - c0))
    if len(zs) and len(ys) and len(xs) and k:
        out[zs.start:zs.stop, ys.start:ys.stop, xs.start:xs.stop, :k] = t[
            b, z0 + zs.start:z0 + zs.stop, y0 + ys.start:y0 + ys.stop,
            x0 + xs.start:x0 + xs.stop, base + c0:base + c0 + k]
    return out.reshape(-1, 8)


def _desc_k_major(smem, start, lbo, sbo, rows):
    """The (rows x 16) operand a no-swizzle K-major descriptor names: row m,
    k at unit start + (m // 8) sbo + (k // 8) lbo + m % 8, lane k % 8."""
    m = torch.arange(rows).reshape(-1, 1)
    k = torch.arange(16).reshape(1, -1)
    return smem[start + m // 8 * sbo + k // 8 * lbo + m % 8, k % 8]


def _desc_mn_major(smem, start, lbo, sbo, cols):
    """The (16 x cols) operand a no-swizzle MN-major descriptor names: k, n
    at unit start + (n // 8) sbo + (k // 8) lbo + k % 8, lane n % 8."""
    k = torch.arange(16).reshape(-1, 1)
    n = torch.arange(cols).reshape(1, -1)
    return smem[start + n // 8 * sbo + k // 8 * lbo + k % 8, n % 8]


def emulate_conv(x, w, dims, p: MidPlan, phase: bool, scale=None, shift=None, alpha=None,
                 relu_mode: str = "none") -> torch.Tensor:
    """The mid-channel conv body on x (dense (B, D, H, W, C); phase (B, D/2,
    H/2, W/2, 8 C)), f32, as the card computes it: returns x's layout with CO
    channels."""
    c, co = w.shape[-2:]
    g = _grid(dims, phase)
    nph, halo = (8, 1) if phase else (1, 2)
    hp, wp = p.th + halo, p.tw + halo
    plane16 = fused_conv.mid_plane_bytes(phase, p.td, p.th, p.tw) // 16
    npl, ksteps, ng = p.ck // 8, fused_conv.mid_ksteps(p.ck), p.nt // 8
    tab = [_tap_offset(phase, i // 27, i % 27, hp, wp, npl, plane16) for i in range(nph * 27)]
    packed = fused_conv.pack_weights_mid(w, p.nt, p.ck).reshape(p.n_tiles, -1, 8)
    s, t = fused_conv._epilogue_vectors(co, None, scale, shift, x.device)
    xt = x.reshape(g + (nph * c,))
    out = torch.zeros(g + (nph * co,))
    w_units = packed.shape[1]
    for tile, brick in itertools.product(range(p.n_tiles), range(p.nbricks)):
        b, z0, y0, x0 = _brick_origin(brick, (None,) + g[1:], p)
        acc = [torch.zeros(64, p.nt) for _ in range(p.nwg * p.spw)]
        for chunk in range(p.nchunks):
            stage = torch.zeros(nph * npl * plane16, 8)
            for ip, j in itertools.product(range(nph), range(npl)):
                lane = chunk * p.ck + 8 * j
                if phase:
                    box = _staged(xt, b, ip * c, lane, c, z0 - (ip >> 2), y0 - (ip >> 1 & 1),
                                  x0 - (ip & 1), p.td + 1, p.th + 1, p.tw + 1)
                else:
                    box = _staged(xt, b, 0, lane, c, z0 - 1, y0 - 1, x0 - 1, p.td + 2, p.th + 2,
                                  p.tw + 2)
                stage[(ip * npl + j) * plane16:][:box.shape[0]] = box
            smem = torch.cat([packed[tile], stage])  # weights, then the slot: units of 8 lanes
            wb = chunk * ksteps * p.nt * 2
            for q, (ph, zl, yl, xl) in enumerate(_slabs(p, phase)):
                a16 = w_units + (zl * hp + yl) * wp + xl
                tb = tab[ph * 27:]
                if p.ck == 8:
                    steps = [(a16 + tb[k and 2 * k - 1], tb[2 * k if k else 1] - tb[k and 2 * k - 1],
                              k) for k in range(14)]
                else:
                    steps = [(a16 + tb[tp], plane16, tp) for tp in range(27)]
                for start, lbo, k in steps:
                    a_op = _desc_k_major(smem, start, lbo, wp, 64)
                    b_op = _desc_k_major(smem, wb + k * p.nt * 2, ng * 8, 8, p.nt)
                    acc[q] += a_op @ b_op.T
        for q, (ph, zl, yl, xl) in enumerate(_slabs(p, phase)):
            for m in range(64):
                z, y, xx = z0 + zl, y0 + yl + m // 8, x0 + xl + m % 8
                if z >= g[1] or y >= g[2] or xx >= g[3]:
                    continue
                cos = range(tile * p.nt, min(co, (tile + 1) * p.nt))
                v = acc[q][m, :len(cos)] * s[cos.start:cos.stop] + t[cos.start:cos.stop]
                out[b, z, y, xx, ph * co + cos.start:ph * co + cos.stop] = v
    return fused_conv.activation(out, relu_mode, alpha)


def emulate_dw(x, dy, dims, p: MidDwPlan) -> torch.Tensor:
    """The mid-channel dw body on dense x and dy (f32) as the card computes
    it: the 128-byte rows of the x halo and the dy brick (64 channels a
    position, zero outside the volume and past C / CO; the swizzle is a
    bijection of the addresses both the TMA and the wgmma apply, so rows are
    read as laid out logically), A = the halo rows hrow + tap offset .. + 15
    read MN-major, B = dy rows 16 ks .. + 15, each warpgroup's taps, and the
    split partials summed in split order: the (3, 3, 3, C, CO) gradient."""
    b_, d, h, w = dims
    c, co = x.shape[-1], dy.shape[-1]
    hp, wp, n = p.th + 2, p.tw + 2, p.td * p.th * p.tw
    part = torch.zeros(p.splits, 27, c, co)
    for tile in range(p.grid[1]):
        tg, rest = tile % p.n_tg, tile // p.n_tg
        c0, co0 = rest % p.n_ci * 64, rest // p.n_ci * 64
        taps = [t for wg in range(p.nwg)
                for t in range((tg * p.nwg + wg) * p.tpw, (tg * p.nwg + wg + 1) * p.tpw) if t < 27]
        toff = {t: ((t // 9) * hp + t // 3 % 3) * wp + t % 3 for t in taps}
        for split in range(p.splits):
            acc = {t: torch.zeros(64, 64) for t in taps}
            for brick in range(split, p.nbricks, p.splits):
                b, z0, y0, x0 = _brick_origin(brick, (None, d, h, w), p)
                # 64 lanes a row: _staged's 8-lane planes side by side
                halo = torch.cat([_staged(x, b, 0, c0 + 8 * j, c, z0 - 1, y0 - 1, x0 - 1, p.td + 2,
                                          p.th + 2, p.tw + 2) for j in range(8)], dim=1)
                dyb = torch.cat([_staged(dy, b, 0, co0 + 8 * j, co, z0, y0, x0, p.td, p.th, p.tw)
                                 for j in range(8)], dim=1)
                # k rows: 8 consecutive positions, the two groups sbo rows apart
                pair = p.tw == 8
                sbo = wp if pair else 8
                k_rows = torch.cat([torch.arange(8), sbo + torch.arange(8)])
                for ks in range(n // 16):
                    zy, xq = (2 * ks, 0) if pair else divmod(ks, p.tw // 16)
                    hrow = ((zy // p.th) * hp + zy % p.th) * wp + xq * 16
                    b_op = dyb[16 * ks:16 * ks + 16]  # (k, n)
                    for t in taps:
                        a_op = halo[hrow + toff[t] + k_rows].T  # (m, k)
                        acc[t] += a_op @ b_op
            for t in taps:
                part[split, t, c0:c0 + 64, co0:co0 + 64] = acc[t][:c - c0, :co - co0]
    out = part[0].clone()
    for k in range(1, p.splits):
        out += part[k]
    return out.reshape(3, 3, 3, c, co)


def _rand(rng, shape, scale=1.0):
    return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32))


def _plans(dims, c, co, phase):
    """The wrapper's plan and variants that take the other chunks, bricks and
    slab splits the instances offer."""
    p = mid_plan(dims, c, co, phase)
    out = [p]
    if not phase:
        out.append(dataclasses.replace(p, td=1, th=16, tw=16, spw=2, nwg=2))
        out.append(dataclasses.replace(p, td=4, th=8, tw=8, spw=2, nwg=2))
        out.append(dataclasses.replace(p, td=1, th=8, tw=32, spw=2, nwg=2))
    else:
        out.append(dataclasses.replace(p, spw=2, nwg=4))
    return [dataclasses.replace(q, nbricks=dims[0] * int(np.prod(
        [-(-e // s) for e, s in zip(_grid(dims, phase)[1:], (q.td, q.th, q.tw))]))) for q in out]


@pytest.mark.parametrize("dims,c,co", [((1, 5, 9, 17), 8, 8), ((2, 3, 10, 9), 8, 5),
                                       ((1, 3, 8, 20), 24, 16), ((1, 2, 9, 8), 32, 40)])
def test_emulated_conv_matches_plain_dense(dims, c, co):
    rng = np.random.default_rng(c + co)
    x = _rand(rng, dims + (c,))
    w = _rand(rng, (3, 3, 3, c, co), 0.2)
    kw = dict(scale=_rand(rng, (co,)).abs() + 0.5, shift=_rand(rng, (co,), 0.1),
              alpha=torch.tensor([0.25]), relu_mode="prelu")
    want = fused_conv.conv3d_plain(x, w, **kw)
    for p in _plans(dims, c, co, False):
        got = emulate_conv(x, w, dims, p, False, **kw)
        assert (got - want).abs().max() <= 1e-5 * want.abs().max(), p


@pytest.mark.parametrize("p_shape,co", [((1, 2, 5, 9, 8 * 16), 16), ((1, 2, 4, 5, 8 * 32), 8)])
def test_emulated_conv_matches_plain_phase(p_shape, co):
    rng = np.random.default_rng(co)
    c = p_shape[-1] // 8
    p_in = _rand(rng, p_shape)
    w = _rand(rng, (3, 3, 3, c, co), 0.2)
    want = phase_conv.phase_conv_plain(p_in, w, relu_mode="relu")
    dims = (p_shape[0],) + tuple(2 * v for v in p_shape[1:4])
    for p in _plans(dims, c, co, True):
        got = emulate_conv(p_in, w, dims, p, True, relu_mode="relu")
        assert (got - want).abs().max() <= 1e-5 * want.abs().max(), p


def _dw_plans(dims, c, co):
    """The wrapper's plan and variants on the other instances, bricks of
    either row length and three splits."""
    p = mid_dw_plan(dims, c, co)
    out = [p, dataclasses.replace(p, splits=min(3, p.nbricks), grid=(min(3, p.nbricks), p.grid[1]))]
    for td, th, tw in ((2, 4, 16), (2, 8, 8), (4, 6, 8)):
        nb = dims[0] * -(-dims[1] // td) * -(-dims[2] // th) * -(-dims[3] // tw)
        out.append(dataclasses.replace(p, td=td, th=th, tw=tw, nbricks=nb,
                                       splits=min(p.splits, nb), grid=(min(p.splits, nb), p.grid[1])))
    for tpw, nwg in ((2, 2), (3, 3)):
        n_tg = -(-27 // (tpw * nwg))
        out.append(dataclasses.replace(p, tpw=tpw, nwg=nwg, n_tg=n_tg,
                                       grid=(p.splits, n_tg * p.n_ci * p.n_co)))
    return out


@pytest.mark.parametrize("dims,c,co", [((1, 3, 5, 17), 64, 64), ((2, 2, 3, 9), 128, 64),
                                       ((1, 2, 2, 16), 64, 128)])
def test_emulated_dw_matches_plain(dims, c, co):
    rng = np.random.default_rng(c + co)
    x = _rand(rng, dims + (c,))
    dy = _rand(rng, dims + (co,))
    want = fused_conv.conv3d_dw_plain(x, dy)
    for p in _dw_plans(dims, c, co):
        got = emulate_dw(x, dy, dims, p)
        assert (got - want).abs().max() <= 1e-5 * want.abs().max(), p


# ---- against the JAX package's Pallas kernels (interpret mode) ---------------

@pytest.mark.parametrize("x_shape,co", [((2, 3, 4, 8, 32), 32), ((2, 3, 4, 8, 40), 24)])
def test_emulated_dense_bodies_match_pallas(x_shape, co):
    assert pallas_conv.supported(x_shape, co)
    rng = np.random.default_rng(41)
    c = x_shape[-1]
    x = rng.standard_normal(x_shape).astype(np.float32)
    w = (0.1 * rng.standard_normal((3, 3, 3, c, co))).astype(np.float32)
    bias = rng.standard_normal(co).astype(np.float32)
    dims = x_shape[:4]
    want = np.asarray(pallas_conv.conv3d_pallas(jnp.asarray(x), jnp.asarray(w),
                                                bias=jnp.asarray(bias), interpret=True))
    got = emulate_conv(torch.from_numpy(x), torch.from_numpy(w), dims, mid_plan(dims, c, co),
                       False, shift=torch.from_numpy(bias))  # bias alone: shift with scale 1
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


def test_emulated_dw_matches_pallas():
    x_shape, co = (1, 2, 4, 8, 64), 64
    assert pallas_conv.supported(x_shape, co)
    rng = np.random.default_rng(42)
    x = rng.standard_normal(x_shape).astype(np.float32)
    dy = rng.standard_normal(x_shape[:4] + (co,)).astype(np.float32)
    want = np.asarray(pallas_conv.conv3d_packed_dw(jnp.asarray(x), jnp.asarray(dy),
                                                   interpret=True))
    got = emulate_dw(torch.from_numpy(x), torch.from_numpy(dy), x_shape[:4],
                     mid_dw_plan(x_shape[:4], 64, co))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("p_shape", [(1, 3, 4, 8, 128), (1, 2, 4, 8, 256)], ids=["C16", "C32"])
def test_emulated_phase_body_matches_pallas(p_shape):
    rng = np.random.default_rng(43)
    c = p_shape[-1] // 8
    p_in = rng.standard_normal(p_shape).astype(np.float32)
    w = (0.1 * rng.standard_normal((3, 3, 3, c, c))).astype(np.float32)
    want = np.asarray(phase_gemm.phase_conv_gemm(jnp.asarray(p_in), jnp.asarray(w),
                                                 interpret=True))
    dims = (p_shape[0],) + tuple(2 * v for v in p_shape[1:4])
    got = emulate_conv(torch.from_numpy(p_in), torch.from_numpy(w), dims,
                       mid_plan(dims, c, c, True), True)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


# ---- the slice: which convs of the four models take the new bodies ------------

def _conv_calls(monkeypatch, make):
    """(C, CO, phase, positions at the training batch) of every 3^3 conv a
    forward of the model sends to kernels 1-6, recorded at the two calls of
    ``models.unet.Conv`` on a 32^3 input; positions scaled to an 8 x 96^3
    batch (the stored tensor's points, block voxels in phase space)."""
    calls = []

    def record(phase, plain):
        def fn(x, w):
            points = x.numel() // x.shape[-1] * 8 * 27  # batch 1 -> 8, 32^3 -> 96^3
            calls.append((w.shape[-2], w.shape[-1], phase, points, 3 * x.shape[2]))
            return plain(x, w)
        return fn

    monkeypatch.setattr(punet, "conv3d_grad", record(False, fused_conv.conv3d_plain))
    monkeypatch.setattr(punet, "phase_conv_grad", record(True, phase_conv.phase_conv_plain))
    module = make()
    with torch.no_grad():
        module(torch.zeros((1, 32, 32, 32, 1)))
    return calls


# UNETR's transformer cut to one narrow layer: its 3^3 convs' channels follow
# feature_size (16) alone
_UNETR_NARROW = dict(hidden_size=48, num_layers=1, num_heads=12, mlp_dim=96)


def _model(name):
    from segmantic_tpu_torch.models.unetr import UNETR
    from segmantic_tpu_torch.train.trainer import SegmentationModel

    if name == "unetr-unpacked":
        return lambda: UNETR(spatial_size=(32, 32, 32), out_channels=8, pack=False,
                             **_UNETR_NARROW)
    kw = {"unet": {}, "segresnet": {"arch": "segresnet"},
          "unetr": {"arch": "unetr", "spatial_size": (32, 32, 32),
                    "arch_params": _UNETR_NARROW}}[name]
    return lambda: SegmentationModel.create(num_classes=8, device="cpu", **kw).module


@pytest.mark.parametrize("name", ["unet", "segresnet", "unetr", "unetr-unpacked"])
def test_the_rule_sends_exactly_these_convs_to_the_mid_bodies(monkeypatch, name):
    calls = _conv_calls(monkeypatch, _model(name))
    mid, mid_dw = set(), set()
    for c, o, ph, points, side in calls:
        for cc, oo in ((c, o), (o, c)) if c > 1 else ((c, o),):  # and the input gradient
            probe = torch.zeros((1, 1, side, side, (8 if ph else 1) * cc), dtype=torch.bfloat16)
            if fused_conv.conv_body(probe, cc, oo, ph) == "mid_channels":
                mid.add((cc, oo, ph, side))
        probe = torch.zeros((points, 1, 1, 1, (8 if ph else 1) * c), dtype=torch.bfloat16)
        if fused_conv.dw_body(probe, c, o, ph) == "mid_channels":
            mid_dw.add((c, o, points // 8))
    # (C, CO, phase, H of the stored tensor at 96^3): the 24^3 convs with a
    # 32-channel side and packed UNETR's phase stages with one; 12^3 stays
    assert mid == {
        "unet": {(32, 32, False, 24)},
        "segresnet": {(32, 32, False, 24)},
        "unetr": {(32, 16, True, 48), (16, 32, True, 48), (32, 32, False, 24),
                  (32, 32, True, 24), (64, 32, True, 24), (32, 64, True, 24)},
        "unetr-unpacked": {(32, 16, False, 96), (16, 32, False, 96), (32, 32, False, 48),
                           (32, 32, False, 24), (64, 32, False, 48), (32, 64, False, 48)},
    }[name]
    # the dw body: C, CO multiples of 64 below 128 at 24^3 (UNETR), not at 12^3
    assert mid_dw == {"unet": set(), "segresnet": set(),
                      "unetr": {(64, 64, 24 ** 3), (128, 64, 24 ** 3)},
                      "unetr-unpacked": {(64, 64, 24 ** 3), (128, 64, 24 ** 3)}}[name]
