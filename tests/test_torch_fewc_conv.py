"""The few-channel conv and weight-gradient bodies (``csrc/conv3_fewc.cuh``,
``csrc/conv3_fewc_dw.cuh``: bf16, C = 1..7) on the CPU.

The kernels run only on the card (``tests/test_torch_kernels_cuda.py``,
``chip_smoke.py``). Here:

- ``fused_conv.fewc_plan`` / ``fewc_dw_plan`` at the three rows of the 96^3
  one-channel input layer (8 x 96^3 x 1 -> 8, -> 16, and phase-major 48^3 x 8
  -> 16) and at ragged shapes: every output position covered by exactly one
  item and plane step, shared memory within the card's limit and equal to the
  C side's sum (written out here from the header), at least 132 blocks at the
  three rows;
- the three-way rule between the bodies (``conv_body``, ``dw_body``) over
  dtype x C x CO;
- the packed weights: K = 27 * C rows padded with zero rows to a multiple of
  16, and back;
- :func:`emulate_conv` and :func:`emulate_dw`, plain PyTorch emulations of
  the two bodies: the input planes staged along W in 16-byte pieces (or value
  by value where a dense row of W * C values is no whole number of pieces),
  the ring of six slots with its two mirrors filled in the kernel's order, the
  row tables, the lane's K offsets (the phase layout's depend on the output
  phase), the K order ``tap * C + c``, the epilogue, and for the weight
  gradient the warps' k16 steps, the warp-ordered block sum and the splits'
  reduction. Held in f32 against ``conv3d_plain`` / ``phase_conv_plain`` and
  their dw within 1e-5 * max|ref| (sums of at most 27 * 7 products, or of a
  few thousand, in another order), in both layouts at C in {1, 3} and ragged
  extents, and against the JAX package's ``pallas_conv.conv3d_pallas``
  (``conv3d_packed_p``) and ``conv3d_packed_dw`` in interpret mode where
  ``pallas_conv.supported`` admits the shape (C = 1 from 64 samples on, C = 3
  from 22), within 1e-4 absolute + relative as ``test_torch_fused_conv.py``.
  ``phase_gemm.supported`` admits no phase tensor of fewer than 64 lanes
  (Ci < 8), so the phase emulation is held against the JAX package's XLA
  phase conv (``fast_conv.phase_conv_s1``) instead, within the same tolerance.
"""

from __future__ import annotations

import dataclasses
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmantic_tpu.ops import fast_conv as jfc
from segmantic_tpu.ops import pallas_conv, phase_gemm
from segmantic_tpu_torch.ops import fast_conv, fused_conv, phase_conv
from segmantic_tpu_torch.ops.fused_conv import SMEM_LIMIT, FewcPlan, fewc_dw_plan, fewc_plan

SLOTS = 6  # FEWC_SLOTS: staged input planes, two more as mirrors
DY_SLOTS = 4  # FEWC_DY_SLOTS
MAX_ROWS = 512  # FEWC_MAX_ROWS
# (full-resolution dims, C, CO, phase) of the three rows the bodies were made for
ROWS = [((8, 96, 96, 96), 1, 8, False), ((8, 96, 96, 96), 1, 16, False),
        ((8, 96, 96, 96), 1, 16, True)]
RAGGED = [((2, 5, 7, 9), 1, 8, False), ((2, 5, 7, 9), 3, 5, False), ((1, 3, 20, 40), 7, 24, False),
          ((2, 6, 8, 10), 1, 16, True), ((1, 4, 14, 36), 3, 1, True), ((3, 2, 2, 2), 2, 3, True),
          ((1, 1, 1, 16), 1, 1, False)]


def _round_to(n, mod, rem):
    return n + (rem - n) % mod


def _pitch(n):  # mma_pitch: bytes per row of n bf16 values
    return 16 if n == 8 else 2 * n + 16


def _c_side_smem(p: FewcPlan, c: int, phase: bool, dw: bool) -> int:
    """``fewc_smem_bytes`` / ``fewc_dw_smem_bytes``, written out from the
    header's definitions."""
    rp = _round_to((p.tw // 2 + 2) * 8 * c if phase else p.tw * c + 16, 32, 16)
    rows = p.th // 2 + 2 if phase else p.th + 2
    sp = _round_to(rows * rp, 64, 32)
    tables = 3 * MAX_ROWS * 4
    if dw:
        return tables + (SLOTS + 2) * sp * 2 + DY_SLOTS * p.rows * p.nt * 2
    return tables + -(-27 * c // 16) * 16 * _pitch(p.nt) + (SLOTS + 2) * sp * 2


def _items(p: FewcPlan, dims, phase):
    """(b, p0, n, ty, tx) of every item in id order, decoded as ``fewc_item``."""
    b, d, h, w = dims
    planes = d // 2 if phase else d
    nty, ntx, nseg = -(-h // p.th), -(-w // p.tw), -(-planes // p.seg)
    for i in range(b * nty * ntx * nseg):
        tx, r = i % ntx, i // ntx
        ty, r = r % nty, r // nty
        sg, bb = r % nseg, r // nseg
        p0 = sg * p.seg
        yield bb, p0, min(p.seg, planes - p0), ty, tx


def _row_coords(p: FewcPlan, phase: bool):
    """Per row of a plane step its full-resolution (z, y, x) from the step's
    origin, in the order of the kernel's row tables."""
    r = torch.arange(p.rows)
    if phase:
        vw, v, ph = p.tw // 2, r // 8, r % 8
        return ph // 4, 2 * (v // vw) + ph // 2 % 2, 2 * (v % vw) + ph % 2
    return torch.zeros_like(r), r // p.tw, r % p.tw


@pytest.mark.parametrize("dims,c,co,phase", ROWS + RAGGED)
@pytest.mark.parametrize("dw", [False, True], ids=["conv", "dw"])
def test_plan_covers_every_position_once(dims, c, co, phase, dw):
    p = fewc_dw_plan(dims, c, co, phase) if dw else fewc_plan(dims, c, co, phase)
    b, d, h, w = dims
    assert p.rows in (256, 512)
    assert p.rows == (2 * p.th * p.tw if phase else p.th * p.tw)
    if phase:
        assert p.th % 2 == 0 and p.tw % 4 == 0  # whole block voxels, pairs of them a row
    else:
        assert p.tw % 16 == 0  # an m16 tile (k16 step) is 16 voxels of one row
    assert p.nt == (8 if co <= 8 else 16) and p.n_tiles == -(-co // p.nt)
    assert p.smem_bytes == _c_side_smem(p, c, phase, dw) <= SMEM_LIMIT
    items = list(_items(p, dims, phase))
    assert p.nitems == len(items) and 1 <= p.grid_x <= p.nitems
    assert p.workspace == (p.grid_x * 27 * c * co if dw and p.grid_x > 1 else 0)
    rz, ry, rx = _row_coords(p, phase)
    seen = torch.zeros(dims, dtype=torch.int32)
    for bb, p0, n, ty, tx in items:
        for j in range(n):
            z = (2 * (p0 + j) if phase else p0 + j) + rz
            y, x = ty * p.th + ry, tx * p.tw + rx
            inside = (y < h) & (x < w)
            seen.index_put_((torch.full_like(z[inside], bb), z[inside], y[inside], x[inside]),
                            torch.ones(int(inside.sum()), dtype=torch.int32), accumulate=True)
    assert bool((seen == 1).all())
    assert p.fill == pytest.approx(h * w / (-(-h // p.th) * p.th * -(-w // p.tw) * p.tw))


@pytest.mark.parametrize("dims,c,co,phase", ROWS)
def test_plans_fill_the_card_at_the_three_rows(dims, c, co, phase):
    for p in (fewc_plan(dims, c, co, phase), fewc_dw_plan(dims, c, co, phase)):
        assert p.grid_x * p.n_tiles >= 132 and p.fill == 1.0
        assert p.blocks_per_sm >= 2


@pytest.mark.parametrize("c,co", [(0, 8), (8, 8), (1, 0)])
def test_fewc_plans_refuse_other_channel_counts(c, co):
    for fn in (fewc_plan, fewc_dw_plan):
        with pytest.raises(ValueError, match="C = 1..7"):
            fn((1, 4, 4, 16), c, co)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c,co", list(itertools.product((1, 2, 3, 7, 8, 16), (1, 5, 8, 16))))
def test_three_way_route_rule(dtype, c, co):
    x = torch.zeros((1, 2, 2, 2, c), dtype=dtype)
    if dtype == torch.float32:
        conv, dw = "f32_tiles", "f32_tiles"  # f32 keeps its f32 FMAs
    elif c % 8 == 0:
        conv, dw = "tensor_cores", ("tensor_cores" if co % 8 == 0 else "f32_tiles")
    else:
        conv, dw = "few_channels", "few_channels"
    assert fused_conv.conv_body(x, c, co) == conv
    assert fused_conv.dw_body(x, c, co) == dw


@pytest.mark.parametrize("c,co,nt", [(1, 8, 8), (1, 16, 16), (1, 1, 8), (3, 5, 8), (7, 24, 16),
                                     (2, 16, 16)])
def test_packed_weights_round_trip(c, co, nt):
    rng = np.random.default_rng(c * 100 + co)
    w = torch.from_numpy(rng.standard_normal((3, 3, 3, c, co)).astype(np.float32))
    packed = fused_conv.pack_weights(w, nt)
    ck, nchunks, krows = fused_conv._chunking(c)
    assert (ck, nchunks) == (c, 1) and krows % 16 == 0 and 27 * c <= krows < 27 * c + 16
    assert tuple(packed.shape) == (-(-co // nt), 1, krows, nt) and packed.is_contiguous()
    assert not packed[:, :, 27 * c:].any()  # the padding rows of K are zero
    cols = packed.permute(1, 2, 0, 3).reshape(krows, -1)
    assert not cols[:, co:].any()  # and so are the padding columns
    assert torch.equal(cols[:27 * c, :co], w.reshape(27 * c, co))  # K row tap * C + c
    assert torch.equal(fused_conv.unpack_weights(packed, c, co), w)


# ---- the bodies, emulated ---------------------------------------------------

def _koff(k: int, ph: int, c: int, rp: int, sp: int, phase: bool) -> int:
    """``fewc_koff``: element offset of K column k = tap * C + c for an output
    of phase ph, from a row's rowin in the window's first plane."""
    if k >= 27 * c:
        k = 13 * c
    t, ch = divmod(k, c)
    dz, dy, dx = t // 9, t // 3 % 3, t % 3
    if not phase:
        return dz * sp + dy * rp + dx * c + ch
    uz, uy, ux = (ph >> 2) + dz - 1, (ph >> 1 & 1) + dy - 1, (ph & 1) + dx - 1
    return (((uz >> 1) + 1) * sp + ((uy >> 1) + 1) * rp + ((ux >> 1) + 1) * 8 * c
            + ((uz & 1) * 4 + (uy & 1) * 2 + (ux & 1)) * c + ch)


class _Staging:
    """The staged input planes of one sample as the kernels lay them out."""

    def __init__(self, x: torch.Tensor, dims, c: int, p: FewcPlan, phase: bool):
        self.x, self.c, self.p, self.phase = x, c, p, phase
        _, self.d, self.h, self.w = dims
        self.rp, self.sp = fused_conv.fewc_pitches(phase, c, p.th, p.tw)
        # the wrapper's rule: 16-byte pieces where a dense row is whole pieces
        self.vec = phase or (self.w * c) % 8 == 0

    def plane(self, b: int, pz: int, ty: int, tx: int) -> torch.Tensor:
        """The slot of input plane pz of tile column (ty, tx), zeros where
        the kernel stages nothing or zero-fills."""
        p, c, rp = self.p, self.c, self.rp
        slot = torch.zeros(self.sp)
        if self.phase:
            d2, h2, w2 = self.d // 2, self.h // 2, self.w // 2
            vox = p.tw // 2 + 2
            for yy in range(p.th // 2 + 2):
                by = ty * (p.th // 2) - 1 + yy
                for vx in range(vox):
                    bx = tx * (p.tw // 2) - 1 + vx
                    if 0 <= pz < d2 and 0 <= by < h2 and 0 <= bx < w2:
                        # C 16-byte pieces: the voxel's 8 * C values as they lie
                        slot[yy * rp + vx * 8 * c: yy * rp + (vx + 1) * 8 * c] = \
                            self.x[b, pz, by, bx]
            return slot
        wc = self.w * c
        for yy in range(p.th + 2):
            y = ty * p.th - 1 + yy
            if not (0 <= pz < self.d and 0 <= y < self.h):
                continue
            row = self.x[b, pz, y].reshape(-1)
            if self.vec:  # pieces of 8 values from element x0 * C - 8, whole or zero
                e0 = tx * p.tw * c - 8
                for pc in range(p.tw * c // 8 + 2):
                    e = e0 + 8 * pc
                    if e >= 0 and e + 8 <= wc:
                        slot[yy * rp + 8 * pc: yy * rp + 8 * pc + 8] = row[e: e + 8]
            else:  # value by value: the tile's positions and the one before and after
                for pos in range(p.tw + 2):
                    xx = tx * p.tw - 1 + pos
                    if 0 <= xx < self.w:
                        base = yy * rp + 8 - c + pos * c
                        slot[base: base + c] = row[xx * c: xx * c + c]
        return slot


def _tables(p: FewcPlan, c: int, rp: int, phase: bool):
    """``fewc_tables``: rowin of every row of a step, and the phase of its output."""
    r = torch.arange(p.rows)
    if phase:
        v, ph = r // 8, r % 8
        return (v // (p.tw // 2)) * rp + (v % (p.tw // 2)) * 8 * c, ph
    return (r // p.tw) * rp + 8 - c + (r % p.tw) * c, torch.zeros_like(r)


def _walk(p: FewcPlan, dims, phase: bool, block: int, staging: _Staging, on_step):
    """One block's loop: the loader's stream of planes into the ring of
    ``SLOTS`` slots (and two mirrors) and, per step, ``on_step(item, j,
    window)`` with the three window slots read as the kernel reads them:
    consecutive slots from the one of the window's first plane."""
    items = list(_items(p, dims, phase))
    stream = [(it, e) for it in items[block::p.grid_x] for e in range(it[2] + 2)]
    ring = [torch.full((staging.sp,), float("nan")) for _ in range(SLOTS + 2)]
    issued = 0

    def issue():
        nonlocal issued
        if issued < len(stream):
            (bb, p0, _, ty, tx), e = stream[issued]
            plane = staging.plane(bb, p0 - 1 + e, ty, tx)
            slot = issued % SLOTS
            ring[slot] = plane
            if slot < 2:
                ring[SLOTS + slot] = plane
        issued += 1

    while issued < SLOTS:
        issue()
    s = 0
    for it in items[block::p.grid_x]:
        for j in range(it[2]):
            while issued <= s + SLOTS - 1:  # after the step's barrier, before its work
                issue()
            on_step(it, j, torch.cat(ring[s % SLOTS: s % SLOTS + 3]), s)
            s += 1
        s += 2


def emulate_conv(x: torch.Tensor, w: torch.Tensor, dims, p: FewcPlan, phase: bool,
                 scale=None, shift=None, alpha=None, relu_mode="none") -> torch.Tensor:
    """What ``conv3_fewc_kernel`` computes, plane step by plane step, in f32:
    x the stored tensor (dense, or phase-major with ``dims`` the
    full-resolution grid); returns the stored output."""
    b, d, h, wd = dims
    c, co = w.shape[-2:]
    staging = _Staging(x.float(), dims, c, p, phase)
    rp, sp = staging.rp, staging.sp
    packed = fused_conv.pack_weights(w.float(), p.nt)  # (tiles, 1, K rows, nt)
    krows = packed.shape[2]
    rowin, ph = _tables(p, c, rp, phase)
    koff = torch.tensor([[_koff(k, q, c, rp, sp, phase) for k in range(krows)] for q in range(8)])
    a_idx = rowin[:, None] + koff[ph]  # (rows, K): the lane's offsets, per row's phase
    rz, ry, rx = _row_coords(p, phase)
    s_v, t_v = fused_conv._epilogue_vectors(co, None, scale, shift, torch.device("cpu"))
    neg = {"none": 1.0, "relu": 0.0}.get(relu_mode) if relu_mode != "prelu" else float(alpha)
    full = torch.full((b, d, h, wd, co), float("nan"))

    for tile in range(p.n_tiles):
        cols = slice(tile * p.nt, min(co, (tile + 1) * p.nt))
        wt = packed[tile, 0][:, : cols.stop - cols.start]

        def on_step(item, j, window, _s, wt=wt, cols=cols):
            bb, p0, _, ty, tx = item
            y = window[a_idx] @ wt  # the mma: rows x K times K x nt, f32
            y = y * s_v[cols] + t_v[cols]
            if relu_mode != "none":
                y = torch.where(y >= 0, y, y * neg + 0.0)
            z = (2 * (p0 + j) if phase else p0 + j) + rz
            yy, xx = ty * p.th + ry, tx * p.tw + rx
            inside = (yy < h) & (xx < wd)
            full[bb, z[inside], yy[inside], xx[inside], cols] = y[inside]

        for block in range(p.grid_x):
            _walk(p, dims, phase, block, staging, on_step)
    return fast_conv.space_to_depth(full) if phase else full


def emulate_dw(x: torch.Tensor, dy: torch.Tensor, dims, c: int, co: int, p: FewcPlan,
               phase: bool) -> torch.Tensor:
    """What ``conv3_fewc_dw_kernel`` and the reduce kernel compute, in f32:
    per block the eight warps' sums over their k16 steps (warp w: steps w,
    w + 8, ... of each plane), added in warp order, one partial a split, the
    partials summed in the reduce kernel's order."""
    b, d, h, wd = dims
    staging = _Staging(x.float(), dims, c, p, phase)
    rp, sp = staging.rp, staging.sp
    mrows = -(-27 * c // 32) * 32
    rowin, _ = _tables(p, c, rp, phase)
    # A offsets of a k16 step's 16 positions from its rowin[0]: dense, along W;
    # phase, two block voxels x 8 phases
    k = torch.arange(16)
    colbase = (k // 8) * 8 * c if phase else k * c
    ph = k % 8 if phase else torch.zeros_like(k)
    aoff = torch.tensor([[_koff(m, int(q), c, rp, sp, phase) for q in ph] for m in range(mrows)])
    aoff = aoff + colbase  # (M rows, 16)
    rz, ry, rx = _row_coords(p, phase)
    g_full = fast_conv.depth_to_space(dy.float(), co) if phase else dy.float()
    parts = torch.zeros((p.grid_x, 27 * c, co))
    for tile in range(p.n_tiles):
        co0 = tile * p.nt
        ncol = min(co, co0 + p.nt) - co0
        for block in range(p.grid_x):
            warps = torch.zeros((8, mrows, ncol))

            def on_step(item, j, window, _s, warps=warps, co0=co0, ncol=ncol):
                bb, p0, _, ty, tx = item
                z = (2 * (p0 + j) if phase else p0 + j) + rz
                yy, xx = ty * p.th + ry, tx * p.tw + rx
                inside = (yy < h) & (xx < wd)
                g = torch.zeros((p.rows, ncol))  # the staged dy rows, zero outside
                g[inside] = g_full[bb, z[inside], yy[inside], xx[inside], co0: co0 + ncol]
                for t in range(p.rows // 16):
                    a = window[rowin[16 * t] + aoff]  # (M rows, 16 positions)
                    warps[t % 8] += a @ g[16 * t: 16 * t + 16]

            _walk(p, dims, phase, block, staging, on_step)
            red = warps[0].clone()
            for wi in range(1, 8):
                red = red + warps[wi]
            parts[block, :, co0: co0 + ncol] = red[:27 * c]
    if p.grid_x == 1:
        out = parts[0]
    elif p.grid_x < 16:
        out = torch.zeros_like(parts[0])
        for k_ in range(p.grid_x):
            out = out + parts[k_]
    else:  # 8 lanes sum k = lane, lane + 8, ...; then the lanes in order
        lanes = []
        for lane in range(8):
            s_ = torch.zeros_like(parts[0])
            for k_ in range(lane, p.grid_x, 8):
                s_ = s_ + parts[k_]
            lanes.append(s_)
        out = lanes[0]
        for s_ in lanes[1:]:
            out = out + s_
    return out.reshape(3, 3, 3, c, co)


def _plans(plan: FewcPlan, dims, phase: bool, c: int):
    """The chosen plan, the other step size where a tile of it fits, and one
    walked by two blocks in segments of two planes (several items a block,
    the ring across items)."""
    plans = [plan]
    for th, tw, rows in fused_conv._fewc_tiles(phase):
        if rows != plan.rows and tw == plan.tw:
            plans.append(dataclasses.replace(plan, th=th, rows=rows))
            break
    planes = dims[1] // 2 if phase else dims[1]
    if planes > 2:
        seg2 = dataclasses.replace(plan, seg=2)
        n = len(list(_items(seg2, dims, phase)))
        plans.append(dataclasses.replace(seg2, grid_x=min(2, n), nitems=n))
    return plans


def _rand(rng, shape, scale=1.0):
    return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32))


@pytest.mark.parametrize("dims,c,co", [
    ((2, 5, 7, 9), 1, 8),  # W * C = 9: value by value; ragged tiles
    ((2, 4, 6, 32), 1, 16),  # 16-byte pieces, two plane steps a tile row
    ((1, 3, 5, 18), 3, 5),  # W * C = 54: value by value; CO below a tile
    ((1, 4, 3, 16), 3, 20),  # 16-byte pieces at C = 3; CO over two tiles
])
def test_emulated_conv_matches_plain_dense(dims, c, co):
    rng = np.random.default_rng(20)
    x, w = _rand(rng, dims + (c,)), _rand(rng, (3, 3, 3, c, co), 0.3)
    scale, shift = _rand(rng, (co,)).abs() + 0.5, _rand(rng, (co,), 0.1)
    alpha = torch.tensor([0.2])
    want = fused_conv.conv3d_plain(x, w, None, scale, shift, alpha, relu_mode="prelu")
    for p in _plans(fewc_plan(dims, c, co, False), dims, False, c):
        got = emulate_conv(x, w, dims, p, False, scale, shift, alpha, "prelu")
        assert (got - want).abs().max() <= 1e-5 * want.abs().max(), p


@pytest.mark.parametrize("p_shape,c,co", [
    ((2, 3, 4, 5, 8), 1, 16),  # packed UNETR's input layer, ragged
    ((1, 2, 3, 4, 24), 3, 3),
    ((1, 3, 2, 8, 8), 1, 1),  # a one-class UNet's 1 -> 1 top stage
])
def test_emulated_conv_matches_plain_phase(p_shape, c, co):
    rng = np.random.default_rng(21)
    x, w = _rand(rng, p_shape), _rand(rng, (3, 3, 3, c, co), 0.3)
    dims = (p_shape[0],) + tuple(2 * v for v in p_shape[1:4])
    want = phase_conv.phase_conv_plain(x, w, relu_mode="relu")
    for p in _plans(fewc_plan(dims, c, co, True), dims, True, c):
        got = emulate_conv(x, w, dims, p, True, relu_mode="relu")
        assert (got - want).abs().max() <= 1e-5 * want.abs().max(), p


@pytest.mark.parametrize("dims,c,co", [((2, 5, 7, 9), 1, 8), ((2, 4, 6, 32), 1, 16),
                                       ((1, 3, 5, 18), 3, 5), ((1, 4, 3, 16), 3, 20)])
def test_emulated_dw_matches_plain_dense(dims, c, co):
    rng = np.random.default_rng(22)
    x, dy = _rand(rng, dims + (c,)), _rand(rng, dims + (co,))
    want = fused_conv.conv3d_dw_plain(x, dy)
    for p in _plans(fewc_dw_plan(dims, c, co, False), dims, False, c):
        got = emulate_dw(x, dy, dims, c, co, p, False)
        assert (got - want).abs().max() <= 1e-5 * want.abs().max(), p


@pytest.mark.parametrize("p_shape,c,co", [((2, 3, 4, 5, 8), 1, 16), ((1, 2, 3, 4, 24), 3, 3),
                                          ((1, 3, 2, 8, 8), 1, 1)])
def test_emulated_dw_matches_plain_phase(p_shape, c, co):
    rng = np.random.default_rng(23)
    x, g = _rand(rng, p_shape), _rand(rng, p_shape[:4] + (8 * co,))
    dims = (p_shape[0],) + tuple(2 * v for v in p_shape[1:4])
    want = phase_conv.phase_conv_dw_plain(x, g)
    for p in _plans(fewc_dw_plan(dims, c, co, True), dims, True, c):
        got = emulate_dw(x, g, dims, c, co, p, True)
        assert (got - want).abs().max() <= 1e-5 * want.abs().max(), p


def test_emulated_dw_takes_the_eight_lane_reduction():
    """More than 16 splits: the reduce kernel's eight-lane order."""
    dims, c, co = (1, 40, 4, 16), 1, 8
    rng = np.random.default_rng(24)
    x, dy = _rand(rng, dims + (c,)), _rand(rng, dims + (co,))
    p = dataclasses.replace(fewc_dw_plan(dims, c, co), seg=2)
    n = len(list(_items(p, dims, False)))
    p = dataclasses.replace(p, grid_x=n, nitems=n)
    assert n > 16
    want = fused_conv.conv3d_dw_plain(x, dy)
    got = emulate_dw(x, dy, dims, c, co, p, False)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.parametrize("x_shape,co", [((64, 2, 4, 8, 1), 8), ((22, 2, 2, 8, 3), 5)])
def test_emulated_bodies_match_pallas_dense(x_shape, co):
    assert pallas_conv.supported(x_shape, co)
    rng = np.random.default_rng(25)
    c = x_shape[-1]
    x = rng.standard_normal(x_shape).astype(np.float32)
    w = (0.3 * rng.standard_normal((3, 3, 3, c, co))).astype(np.float32)
    dy = rng.standard_normal(x_shape[:4] + (co,)).astype(np.float32)
    bias = rng.standard_normal(co).astype(np.float32)
    dims = x_shape[:4]
    want = np.asarray(pallas_conv.conv3d_pallas(jnp.asarray(x), jnp.asarray(w),
                                                bias=jnp.asarray(bias), interpret=True))
    p = fewc_plan(dims, c, co, False)
    got = emulate_conv(torch.from_numpy(x), torch.from_numpy(w), dims, p, False,
                       shift=torch.from_numpy(bias))  # bias alone: shift with scale 1
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
    want_dw = np.asarray(pallas_conv.conv3d_packed_dw(jnp.asarray(x), jnp.asarray(dy),
                                                      interpret=True))
    got_dw = emulate_dw(torch.from_numpy(x), torch.from_numpy(dy), dims, c, co,
                        fewc_dw_plan(dims, c, co), False)
    np.testing.assert_allclose(got_dw.numpy(), want_dw, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("p_shape,c,co", [((1, 2, 3, 8, 8), 1, 16), ((1, 2, 2, 8, 24), 3, 5)])
def test_emulated_phase_bodies_match_jax(p_shape, c, co):
    """``phase_gemm.supported`` refuses fewer than 64 lanes, so the JAX side is
    its XLA phase conv; the weight gradient is JAX's gradient of it."""
    import jax

    assert not phase_gemm.supported(p_shape)
    rng = np.random.default_rng(26)
    x = rng.standard_normal(p_shape).astype(np.float32)
    w = (0.3 * rng.standard_normal((3, 3, 3, c, co))).astype(np.float32)
    g = rng.standard_normal(p_shape[:4] + (8 * co,)).astype(np.float32)
    dims = (p_shape[0],) + tuple(2 * v for v in p_shape[1:4])
    want = np.asarray(jfc.phase_conv_s1(jnp.asarray(x), jnp.asarray(w)))
    got = emulate_conv(torch.from_numpy(x), torch.from_numpy(w), dims,
                       fewc_plan(dims, c, co, True), True)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
    _, vjp = jax.vjp(lambda wv: jfc.phase_conv_s1(jnp.asarray(x), wv), jnp.asarray(w))
    want_dw = np.asarray(vjp(jnp.asarray(g))[0])
    got_dw = emulate_dw(torch.from_numpy(x), torch.from_numpy(g), dims, c, co,
                        fewc_dw_plan(dims, c, co, True), True)
    np.testing.assert_allclose(got_dw.numpy(), want_dw, atol=1e-4, rtol=1e-4)
