"""The deep-channel conv and weight-gradient bodies (``csrc/conv3_wgmma.cuh``,
``csrc/conv3_dw_wgmma.cuh``: bf16, dense layout, C, CO >= 64) on the CPU.

The kernels run only on the card (``tests/test_torch_kernels_cuda.py``,
``chip_smoke.py``). Here:

- ``fused_conv.deep_plan`` / ``deep_dw_plan`` at every deep row of UNETR and
  the flagship (forward, input gradient, weight gradient) and at ragged
  shapes: every output position covered by exactly one brick, every K block
  by exactly one split, every (tap, ci, co) by exactly one block and
  warpgroup, shared memory within the card's limit and equal to the C side's
  sum (written out here from the headers), and at least 108 blocks of one a
  multiprocessor at the rows;
- the four-way rule between the bodies (``conv_body``, ``dw_body``) over
  dtype x C x CO x layout: the deep-channel bodies for bf16 in the dense
  layout with C >= 64 and CO >= 64, the weight gradient from CO = 128;
- the packed weights of the deep body: 128-byte swizzled (N, 64) tiles in the
  order chunk, tap, and back;
- :func:`emulate_conv` and :func:`emulate_dw`, plain PyTorch emulations of
  the two bodies: the halo staged as the TMA lays it (zero outside the
  volume and past C, 128-byte swizzled), the A rows read at the tap's offset
  through the same swizzle, the weight tiles read through the descriptor's
  K-major swizzle (the dw's dy brick MN-major, 64-channel blocks a brick
  apart), the K order chunk, tap, the split-K partials summed in split order
  with the epilogue after the sum, and the dw's reduction of position
  splits. Held in f32 against ``conv3d_plain`` / ``conv3d_dw_plain`` within
  1e-5 * max|ref| (sums of a few thousand products in another order), and
  against the JAX package's ``pallas_conv.conv3d_pallas``
  (``conv3d_packed_p``) and ``conv3d_packed_dw`` in interpret mode where
  ``pallas_conv.supported`` admits the shape (B * C <= 512, W a multiple of
  8), within 1e-4 absolute + relative as ``test_torch_fused_conv.py``;
- for the slice: the rule names the new conv body for exactly the convs
  (and input gradients) of the flagship UNet and of packed UNETR with
  C, CO >= 64, the new dw body for those with CO >= 128, and neither for a
  phase-space conv.
"""

from __future__ import annotations

import dataclasses
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmantic_tpu.ops import pallas_conv
from segmantic_tpu_torch.models import unet as punet
from segmantic_tpu_torch.ops import fused_conv
from segmantic_tpu_torch.ops.fused_conv import (SMEM_LIMIT, DeepDwPlan, DeepPlan, deep_dw_plan,
                                                deep_plan)

SMS = 132


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The emulations are many small tensor operations: one thread each, or
    the workers' thread pools contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# (dims, C, CO) of the deep rows: UNETR's 12^3 / 24^3 convs and the
# flagship's 6^3 / 12^3 stages at batch 8 (training) and 4 (serving), the
# input gradients of the CI != CO convs (CO -> C)
FWD_ROWS = [((8, 12, 12, 12), 256, 128), ((8, 12, 12, 12), 128, 128),
            ((8, 24, 24, 24), 128, 64), ((8, 24, 24, 24), 64, 64),
            ((8, 12, 12, 12), 64, 64), ((4, 12, 12, 12), 64, 64),
            ((4, 6, 6, 6), 128, 128), ((4, 6, 6, 6), 128, 256), ((4, 6, 6, 6), 256, 256),
            ((8, 6, 6, 6), 128, 128), ((8, 6, 6, 6), 128, 256), ((8, 6, 6, 6), 256, 256),
            ((8, 12, 12, 12), 128, 256), ((8, 24, 24, 24), 64, 128), ((8, 6, 6, 6), 256, 128)]
DW_ROWS = [((8, 12, 12, 12), 256, 128), ((8, 12, 12, 12), 128, 128),
           ((8, 24, 24, 24), 128, 64), ((8, 24, 24, 24), 64, 64), ((8, 12, 12, 12), 64, 64),
           ((8, 6, 6, 6), 128, 128), ((8, 6, 6, 6), 128, 256), ((8, 6, 6, 6), 256, 256)]
RAGGED = [((2, 5, 7, 9), 64, 192), ((2, 5, 7, 9), 96, 72), ((1, 6, 6, 6), 72, 64),
          ((1, 3, 4, 70), 64, 64), ((3, 1, 1, 1), 64, 64)]


def _halo(td, th, tw):
    return -(-(td + 2) * (th + 2) * (tw + 2) * 128 // 1024) * 1024


def _c_side_smem(p: DeepPlan) -> int:
    """``wgmma_smem_bytes``, written out from ``csrc/conv3_wgmma.cuh``."""
    return 2048 + 2 * _halo(p.td, p.th, p.tw) + p.stages * p.nt * 128


def _c_side_dw_smem(p: DeepDwPlan) -> int:
    """``dw_wgmma_smem_bytes``, written out from ``csrc/conv3_dw_wgmma.cuh``."""
    rows16 = -(-p.td * p.th * p.tw // 16) * 16
    return 2048 + p.stages * (_halo(p.td, p.th, p.tw) + p.nt // 64 * rows16 * 128)


def _bricks(p, dims):
    """(b, z0, y0, x0) of every brick in block order (x fastest)."""
    b, d, h, w = dims
    nbz, nby, nbx = -(-d // p.td), -(-h // p.th), -(-w // p.tw)
    for i in range(b * nbz * nby * nbx):
        bx, r = i % nbx, i // nbx
        by, r = r % nby, r // nby
        bz, bb = r % nbz, r // nbz
        yield bb, bz * p.td, by * p.th, bx * p.tw


def _brick_rows(p):
    """(z, y, x) inside the brick of every M / K row, flattened z, y, x."""
    r = torch.arange(p.td * p.th * p.tw)
    return r // (p.th * p.tw), r // p.tw % p.th, r % p.tw


def _kb_range(split, nkb, splits):
    return split * nkb // splits, (split + 1) * nkb // splits


def _covered_once(p, dims):
    b, d, h, w = dims
    seen = torch.zeros(dims, dtype=torch.int32)
    rz, ry, rx = _brick_rows(p)
    for bb, z0, y0, x0 in _bricks(p, dims):
        z, y, x = z0 + rz, y0 + ry, x0 + rx
        inside = (z < d) & (y < h) & (x < w)
        seen.index_put_((torch.full_like(z[inside], bb), z[inside], y[inside], x[inside]),
                        torch.ones(int(inside.sum()), dtype=torch.int32), accumulate=True)
    return bool((seen == 1).all())


@pytest.mark.parametrize("dims,c,co", FWD_ROWS + RAGGED)
def test_deep_plan_covers_every_position_and_k_block_once(dims, c, co):
    p = deep_plan(dims, c, co)
    b, d, h, w = dims
    assert (p.nt, p.spw, p.nwg) in ((64, 1, 2), (64, 2, 2), (128, 1, 2), (64, 1, 3),
                                    (128, 1, 3))  # the instances
    assert 32 * p.nwg * p.spw < p.td * p.th * p.tw <= 64 * p.nwg * p.spw
    assert p.n_tiles == -(-co // p.nt) and p.nkb == -(-c // 64) * 27
    assert p.smem_bytes == _c_side_smem(p) <= SMEM_LIMIT and 2 <= p.stages <= 6
    assert p.nbricks == len(list(_bricks(p, dims))) and _covered_once(p, dims)
    assert p.blocks == p.nbricks * p.n_tiles * p.splits
    kbs = [kb for s in range(p.splits) for kb in range(*_kb_range(s, p.nkb, p.splits))]
    assert kbs == list(range(p.nkb))  # each K block in exactly one split, in order
    assert all(_kb_range(s, p.nkb, p.splits)[1] > _kb_range(s, p.nkb, p.splits)[0]
               for s in range(p.splits))
    assert p.workspace == (p.splits * b * d * h * w * co if p.splits > 1 else 0)
    assert p.fill == pytest.approx(b * d * h * w / (p.nbricks * 64 * p.nwg * p.spw))


@pytest.mark.parametrize("dims,c,co", DW_ROWS + RAGGED)
def test_deep_dw_plan_covers_every_output_and_position_once(dims, c, co):
    p = deep_dw_plan(dims, c, co)
    b, d, h, w = dims
    assert p.nt in (64, 128) and (p.tpw, p.nwg) in ((1, 2), (2, 2), (1, 3))
    assert p.nt * p.tpw <= 128
    assert p.td * p.th * p.tw <= 128  # eight k16 steps of A fragments
    assert p.smem_bytes == _c_side_dw_smem(p) <= SMEM_LIMIT and 2 <= p.stages <= 4
    assert (p.n_ci, p.n_co, p.n_tg) == (-(-c // 64), -(-co // p.nt),
                                        -(-27 // (p.nwg * p.tpw)))
    assert p.grid == (p.splits, p.n_tg * p.n_ci * p.n_co) and p.grid[1] <= 65535
    seen = torch.zeros((27, c, co), dtype=torch.int32)
    for tile in range(p.grid[1]):  # the tap group fastest, as the kernel decodes blockIdx.y
        tg, r = tile % p.n_tg, tile // p.n_tg
        c0, co0 = (r % p.n_ci) * 64, (r // p.n_ci) * p.nt
        for wg, j in itertools.product(range(p.nwg), range(p.tpw)):
            tap = (tg * p.nwg + wg) * p.tpw + j
            if tap < 27:
                seen[tap, c0:c0 + 64, co0:co0 + p.nt] += 1
    assert bool((seen == 1).all())
    bricks = list(_bricks(p, dims))
    assert p.nbricks == len(bricks) and 1 <= p.splits <= p.nbricks and _covered_once(p, dims)
    assert p.workspace == (p.splits * 27 * c * co if p.splits > 1 else 0)
    rows16 = -(-p.td * p.th * p.tw // 16) * 16
    assert p.fill == pytest.approx(b * d * h * w / (p.nbricks * rows16))


@pytest.mark.parametrize("dims,c,co", FWD_ROWS)
def test_deep_plans_fill_the_card_at_the_rows(dims, c, co):
    """At every deep row the blocks fill at least 108 of the 132
    multiprocessors (one block a multiprocessor: 200 KB of shared memory)
    with at least 75% of their rows real: the forward's bricks x N tiles x K
    splits, 128 or more at two warpgroups (more than one block a
    multiprocessor at 24^3), 108 at three (4 x 4 x 12 bricks, 3 splits); the
    weight gradient's tap groups (9 at three warpgroups, 14 or 7 at two)
    times chunks, N tiles and splits, 108 or 112."""
    p = deep_plan(dims, c, co)
    assert p.blocks >= 108 and p.fill >= 0.75
    if (dims, c, co) in DW_ROWS:
        q = deep_dw_plan(dims, c, co)
        assert q.grid[0] * q.grid[1] >= 108 and q.fill >= 0.75


@pytest.mark.parametrize("c,co", [(0, 64), (64, 60), (60, 64), (4, 64)])
def test_deep_plans_refuse_channel_counts_without_16_byte_vectors(c, co):
    for fn in (deep_plan, deep_dw_plan):
        with pytest.raises(ValueError, match="C % 8 == 0 and CO % 8 == 0"):
            fn((1, 4, 4, 8), c, co)


@pytest.mark.parametrize("phase", [False, True], ids=["dense", "phase"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c,co", list(itertools.product((1, 8, 12, 56, 64, 72, 128, 256),
                                                        (5, 32, 56, 64, 72, 256))))
def test_four_way_route_rule(phase, dtype, c, co):
    x = torch.zeros((1, 2, 2, 2, 8 * c if phase else c), dtype=dtype)
    deep = (dtype == torch.bfloat16 and not phase and c % 8 == 0 and co % 8 == 0
            and c >= 64 and co >= 64)
    if dtype == torch.float32:
        conv = dw = "f32_tiles"
    elif c < 8:
        conv = dw = "few_channels"
    else:
        conv = "tensor_cores" if c % 8 == 0 else "f32_tiles"
        dw = "tensor_cores" if c % 8 == 0 and co % 8 == 0 else "f32_tiles"
    if deep:  # the dw body from CO = 128
        conv = "deep_channels"
        dw = "deep_channels" if co >= 128 else dw
    elif (conv == "tensor_cores" and c + co >= 48 and fused_conv.mid_eligible(c, co, phase)
          and x.shape[2] % 8 == 0 and x.shape[3] % 8 == 0):
        conv = "mid_channels"  # the mid-channel body (x has too few positions for its dw)
    assert fused_conv.conv_body(x, c, co, phase) == conv
    assert fused_conv.dw_body(x, c, co, phase) == dw


@pytest.mark.parametrize("c,co,nt", [(64, 64, 64), (128, 256, 128), (96, 72, 128),
                                     (256, 128, 64), (72, 64, 64), (64, 192, 256)])
def test_deep_packed_weights_are_swizzled_tiles_and_round_trip(c, co, nt):
    rng = np.random.default_rng(c + co + nt)
    w = torch.from_numpy(rng.standard_normal((3, 3, 3, c, co)).astype(np.float32))
    packed = fused_conv.pack_weights_deep(w, nt)
    nch, n_tiles = -(-c // 64), -(-co // nt)
    assert tuple(packed.shape) == (n_tiles, nch * 27, nt, 64) and packed.is_contiguous()
    flat = w.reshape(27, c, co)
    for tile, kb, n, k in [(0, 0, 0, 0), (n_tiles - 1, nch * 27 - 1, nt - 1, 63),
                           (0, 5, 3, 17), (n_tiles - 1, 27 + 26 if nch > 1 else 26, 9, 40)]:
        chunk, tap = divmod(kb, 27)
        ci, o = chunk * 64 + k, tile * nt + n
        want = flat[tap, ci, o] if ci < c and o < co else 0.0
        assert packed[tile, kb, n, ((k // 8) ^ (n % 8)) * 8 + k % 8] == want
    assert torch.equal(fused_conv.unpack_weights_deep(packed, c, co), w)


# ---- the bodies, emulated ---------------------------------------------------

def _swizzled(rows: int) -> torch.Tensor:
    """Element index of (row, value) of rows of 64 bf16 values in the 128-byte
    swizzle: the 16-byte piece j of row r at piece j ^ (r % 8)."""
    r, v = torch.arange(rows).unsqueeze(1), torch.arange(64).unsqueeze(0)
    return r * 64 + (((v // 8) ^ (r % 8)) * 8 + v % 8)


def _tma_box(t: torch.Tensor, b: int, c0: int, z0: int, y0: int, x0: int, bd: int, bh: int,
             bw: int) -> torch.Tensor:
    """A 5-D TMA box of 64 channels x bw x bh x bd positions of sample b of an
    NDHWC tensor at (c0, x0, y0, z0), zeros outside, laid out in shared
    memory: rows of 64 values, x fastest, 128-byte swizzled."""
    _, d, h, w, c = t.shape
    box = torch.zeros((bd, bh, bw, 64))
    zs, ys, xs = max(z0, 0), max(y0, 0), max(x0, 0)
    ze, ye, xe = min(z0 + bd, d), min(y0 + bh, h), min(x0 + bw, w)
    ce = min(c0 + 64, c)
    if zs < ze and ys < ye and xs < xe and c0 < ce:
        box[zs - z0:ze - z0, ys - y0:ye - y0, xs - x0:xe - x0, :ce - c0] = \
            t[b, zs:ze, ys:ye, xs:xe, c0:ce]
    rows = bd * bh * bw
    smem = torch.zeros(rows * 64)
    smem[_swizzled(rows).reshape(-1)] = box.reshape(-1)
    return smem


def _tap_offset(t: int, hp: int, wp: int) -> int:
    return ((t // 9) * hp + t // 3 % 3) * wp + t % 3


def _halo_rows(p, hp: int, wp: int) -> torch.Tensor:
    """Each brick row's halo row at tap (0, 0, 0)."""
    rz, ry, rx = _brick_rows(p)
    return (rz * hp + ry) * wp + rx


def _read_swizzled(smem: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """smem[(row, col)] through the swizzle, rows (R,) x cols (K,) -> (R, K)."""
    r, v = rows.unsqueeze(1), cols.unsqueeze(0)
    return smem[r * 64 + ((v // 8) ^ (r % 8)) * 8 + v % 8]


def _halos(t, p, bricks, c0: int, shift: int, extent) -> torch.Tensor:
    """The TMA boxes at channel c0 of every brick in ``bricks``, stacked:
    (bricks, box rows * 64)."""
    bd, bh, bw = extent
    return torch.stack([_tma_box(t, bb, c0, z0 - shift, y0 - shift, x0 - shift, bd, bh, bw)
                        for bb, z0, y0, x0 in bricks])


def emulate_conv(x, w, dims, p: DeepPlan, scale=None, shift=None, alpha=None,
                 relu_mode="none") -> torch.Tensor:
    """What ``conv3_wgmma_kernel`` (and with splits its reduce kernel)
    computes, in f32, every brick's block at once: x (B, D, H, W, C), w
    DHWIO."""
    b, d, h, wd = dims
    c, co = w.shape[-2:]
    x = x.float()
    packed = fused_conv.pack_weights_deep(w.float(), p.nt)  # (tiles, K blocks, nt, 64)
    hp, wp = p.th + 2, p.tw + 2
    prow = _halo_rows(p, hp, wp)
    rz, ry, rx = _brick_rows(p)
    k64 = torch.arange(64)
    bricks = list(_bricks(p, dims))
    halos = [_halos(x, p, bricks, ch * 64, 1, (p.td + 2, hp, wp)) for ch in range(p.nkb // 27)]
    # a K block's A rows of every brick: the halo rows at the tap's offset, swizzled
    a_kb = []
    for kb in range(p.nkb):
        chunk, tap = divmod(kb, 27)
        r = (prow + _tap_offset(tap, hp, wp)).unsqueeze(1)
        a_kb.append(halos[chunk][:, r * 64 + ((k64 // 8) ^ (r % 8)) * 8 + k64 % 8])
    idx = torch.stack([torch.tensor(t) for t in bricks])  # (bricks, 4): b, z0, y0, x0
    z, y, xx = idx[:, 1:2] + rz, idx[:, 2:3] + ry, idx[:, 3:4] + rx
    inside = (z < d) & (y < h) & (xx < wd)
    bb = idx[:, :1].expand_as(z)
    parts = torch.full((p.splits, b, d, h, wd, p.n_tiles * p.nt), float("nan"))
    for tile, split in itertools.product(range(p.n_tiles), range(p.splits)):
        acc = torch.zeros((len(bricks), len(prow), p.nt))
        for kb in range(*_kb_range(split, p.nkb, p.splits)):
            # the descriptor's K-major read of the tile: row n, k at piece (k / 8) ^ (n % 8)
            bt = _read_swizzled(packed[tile, kb].reshape(-1), torch.arange(p.nt), k64)
            for ks in range(4):  # the K block's four k16 steps, in order
                acc += a_kb[kb][..., 16 * ks:16 * ks + 16] @ bt[:, 16 * ks:16 * ks + 16].T
        cols = slice(tile * p.nt, (tile + 1) * p.nt)
        parts[split, bb[inside], z[inside], y[inside], xx[inside], cols] = acc[inside]
    total = parts[0]
    for s in range(1, p.splits):  # the reduce kernel: splits in order, then the epilogue
        total = total + parts[s]
    s_v, t_v = fused_conv._epilogue_vectors(co, None, scale, shift, torch.device("cpu"))
    y = total[..., :co] * s_v + t_v
    return fused_conv.activation(y, relu_mode, alpha)


def emulate_dw(x, dy, dims, p: DeepDwPlan) -> torch.Tensor:
    """What ``conv3_dw_wgmma_kernel`` and the reduce kernel compute, in f32:
    per block its taps' accumulators over its split's bricks, in brick
    order, the partials summed in the reduce kernel's order."""
    c, co = x.shape[-1], dy.shape[-1]
    x, dy = x.float(), dy.float()
    hp, wp = p.th + 2, p.tw + 2
    rows = p.td * p.th * p.tw
    rows16 = -(-rows // 16) * 16
    qtab = torch.zeros(rows16, dtype=torch.long)
    qtab[:rows] = _halo_rows(p, hp, wp)  # padding rows: row 0, their dy rows are zero
    k64 = torch.arange(64)
    bricks = list(_bricks(p, dims))
    # dy read MN-major: position q, channel n of 64-channel block n / 64, at its piece
    n = torch.arange(p.nt)
    q = torch.arange(rows16).unsqueeze(1)
    blk, nn = (n // 64).unsqueeze(0), (n % 64).unsqueeze(0)
    b_idx = blk * rows16 * 64 + q * 64 + ((nn // 8) ^ (q % 8)) * 8 + nn % 8
    parts = torch.zeros((p.splits, 27, p.n_ci * 64, p.n_co * p.nt))
    for tile in range(p.grid[1]):
        tg, r = tile % p.n_tg, tile // p.n_tg
        c0, co0 = (r % p.n_ci) * 64, (r // p.n_ci) * p.nt
        taps = [t for t in range(tg * p.nwg * p.tpw, (tg + 1) * p.nwg * p.tpw) if t < 27]
        halo = _halos(x, p, bricks, c0, 1, (p.td + 2, hp, wp))
        pad = torch.zeros((len(bricks), (rows16 - rows) * 64))  # the zeroed rows past the brick
        dyb = torch.cat([t for j in range(p.nt // 64)
                         for t in (_halos(dy, p, bricks, co0 + 64 * j, 0, (p.td, p.th, p.tw)),
                                   pad)], dim=1)
        bmat = dyb[:, b_idx]  # (bricks, rows16, nt)
        for t in taps:
            r_ = (qtab + _tap_offset(t, hp, wp)).unsqueeze(1)
            a = halo[:, r_ * 64 + ((k64 // 8) ^ (r_ % 8)) * 8 + k64 % 8].transpose(1, 2)
            for split in range(p.splits):
                acc = torch.zeros((64, p.nt))
                for i in range(split, len(bricks), p.splits):
                    for ks in range(rows16 // 16):
                        acc += a[i, :, 16 * ks:16 * ks + 16] @ bmat[i, 16 * ks:16 * ks + 16]
                parts[split, t, c0:c0 + 64, co0:co0 + p.nt] = acc
    parts = parts[:, :, :c, :co]
    if p.splits == 1:
        out = parts[0]
    elif p.splits < 16:
        out = torch.zeros_like(parts[0])
        for s in range(p.splits):
            out = out + parts[s]
    else:  # 8 lanes sum k = lane, lane + 8, ...; then the lanes in order
        lanes = []
        for lane in range(8):
            s_ = torch.zeros_like(parts[0])
            for k in range(lane, p.splits, 8):
                s_ = s_ + parts[k]
            lanes.append(s_)
        out = lanes[0]
        for s_ in lanes[1:]:
            out = out + s_
    return out.reshape(3, 3, 3, c, co)


def _rand(rng, shape, scale=1.0):
    return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32))


def _conv_plans(dims, c, co):
    """The chosen plan, the same with two or three K splits (one mid-chunk), and
    with a narrower N tile where CO leaves one."""
    p = deep_plan(dims, c, co)
    plans = [p]
    for splits in (2, 3):
        if splits <= p.nkb and splits != p.splits:
            plans.append(dataclasses.replace(p, splits=splits))
    if p.nt > 64:
        plans.append(dataclasses.replace(p, nt=64, n_tiles=-(-co // 64)))
    return plans


def _dw_plans(dims, c, co):
    """The chosen plan, and the same with two, three and 17 position splits
    (17: the eight-lane reduction), as far as the bricks go."""
    p = deep_dw_plan(dims, c, co)
    return [p] + [dataclasses.replace(p, splits=s) for s in (2, 3, 17)
                  if s <= p.nbricks and s != p.splits]


@pytest.mark.parametrize("dims,c,co", [
    ((2, 5, 7, 9), 64, 72),  # ragged bricks, CO past a 64 tile
    ((1, 6, 6, 6), 72, 64),  # two chunks, the second mostly padding
    ((1, 3, 4, 10), 128, 128),
])
def test_emulated_conv_matches_plain(dims, c, co):
    rng = np.random.default_rng(30)
    x, w = _rand(rng, dims + (c,)), _rand(rng, (3, 3, 3, c, co), 0.1)
    scale, shift = _rand(rng, (co,)).abs() + 0.5, _rand(rng, (co,), 0.1)
    alpha = torch.tensor([0.2])
    want = fused_conv.conv3d_plain(x, w, None, scale, shift, alpha, relu_mode="prelu")
    for p in _conv_plans(dims, c, co):
        got = emulate_conv(x, w, dims, p, scale, shift, alpha, "prelu")
        assert (got - want).abs().max() <= 1e-5 * want.abs().max(), p


@pytest.mark.parametrize("dims,c,co", [((2, 5, 7, 9), 64, 72), ((1, 6, 6, 6), 72, 64),
                                       ((1, 4, 6, 16), 64, 128)])
def test_emulated_dw_matches_plain(dims, c, co):
    rng = np.random.default_rng(31)
    x, dy = _rand(rng, dims + (c,)), _rand(rng, dims + (co,))
    want = fused_conv.conv3d_dw_plain(x, dy)
    for p in _dw_plans(dims, c, co):
        got = emulate_dw(x, dy, dims, p)
        assert (got - want).abs().max() <= 1e-5 * want.abs().max(), p


@pytest.mark.parametrize("x_shape,co", [((2, 3, 4, 8, 64), 64), ((1, 2, 4, 8, 128), 72)])
def test_emulated_bodies_match_pallas(x_shape, co):
    assert pallas_conv.supported(x_shape, co)
    rng = np.random.default_rng(32)
    c = x_shape[-1]
    x = rng.standard_normal(x_shape).astype(np.float32)
    w = (0.1 * rng.standard_normal((3, 3, 3, c, co))).astype(np.float32)
    dy = rng.standard_normal(x_shape[:4] + (co,)).astype(np.float32)
    bias = rng.standard_normal(co).astype(np.float32)
    dims = x_shape[:4]
    want = np.asarray(pallas_conv.conv3d_pallas(jnp.asarray(x), jnp.asarray(w),
                                                bias=jnp.asarray(bias), interpret=True))
    p = dataclasses.replace(deep_plan(dims, c, co), splits=2)  # the partials and their sum
    got = emulate_conv(torch.from_numpy(x), torch.from_numpy(w), dims, p,
                       shift=torch.from_numpy(bias))  # bias alone: shift with scale 1
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
    want_dw = np.asarray(pallas_conv.conv3d_packed_dw(jnp.asarray(x), jnp.asarray(dy),
                                                      interpret=True))
    got_dw = emulate_dw(torch.from_numpy(x), torch.from_numpy(dy), dims,
                        deep_dw_plan(dims, c, co))
    np.testing.assert_allclose(got_dw.numpy(), want_dw, atol=1e-4, rtol=1e-4)


# ---- the slice: which convs of the two models take the new bodies -----------

def _conv_calls(monkeypatch, arch: str, size: int, **create):
    """(C, CO, phase) of every 3^3 conv a forward of the model at full width
    sends to kernels 1-6, recorded at the two calls of ``models.unet.Conv``."""
    from segmantic_tpu_torch.train.trainer import SegmentationModel

    calls = []

    def dense(x, w):
        calls.append((w.shape[-2], w.shape[-1], False))
        return fused_conv.conv3d_plain(x, w)

    def phase(x, w):
        from segmantic_tpu_torch.ops import phase_conv
        calls.append((w.shape[-2], w.shape[-1], True))
        return phase_conv.phase_conv_plain(x, w)

    monkeypatch.setattr(punet, "conv3d_grad", dense)
    monkeypatch.setattr(punet, "phase_conv_grad", phase)
    model = SegmentationModel.create(num_classes=8, arch=arch, device="cpu", **create)
    with torch.no_grad():
        model.module(torch.zeros((1, size, size, size, 1)))
    return calls


# UNETR's transformer cut to one narrow layer: its 3^3 convs' channels follow
# feature_size (16) alone
_UNETR_NARROW = dict(hidden_size=48, num_layers=1, num_heads=12, mlp_dim=96)


@pytest.mark.parametrize("arch", ["unet", "unetr"])
def test_the_rule_sends_exactly_the_deep_convs_of_the_two_models(monkeypatch, arch):
    if arch == "unet":  # the flagship: 16-32-64-128-256, strides 2, two residual units
        calls = _conv_calls(monkeypatch, "unet", 32)
    else:  # packed UNETR, feature 16: 12^3 / 24^3 convs dense, 96^3 / 48^3 in phase space
        calls = _conv_calls(monkeypatch, "unetr", 32, spatial_size=(32, 32, 32),
                            arch_params=_UNETR_NARROW)
        assert any(ph for _, _, ph in calls)
    probe = torch.zeros((1, 2, 2, 2, 8), dtype=torch.bfloat16)
    deep, deep_dw = set(), set()
    for c, o, ph in calls:
        for cc, oo in ((c, o), (o, c)):  # the input gradient runs the conv CO -> C
            want = not ph and cc >= 64 and oo >= 64
            assert (fused_conv.conv_body(probe, cc, oo, ph) == "deep_channels") == want
            if want:
                deep.add((cc, oo))
        if fused_conv.dw_body(probe, c, o, ph) == "deep_channels":
            assert not ph and c >= 64 and o >= 128
            deep_dw.add((c, o))
        else:
            assert ph or c < 64 or o < 128
    assert deep == {"unet": {(64, 64), (128, 128), (128, 256), (256, 128), (256, 256)},
                    "unetr": {(64, 64), (128, 64), (64, 128), (128, 128), (256, 128),
                              (128, 256)}}[arch]
    assert deep_dw == {"unet": {(128, 128), (128, 256), (256, 256)},
                       "unetr": {(128, 128), (256, 128)}}[arch]
