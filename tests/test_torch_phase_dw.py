"""The phase dw's Hopper body (``csrc/conv3_phase_dw.cuh``: kernels 5 and 6
for bf16 phase-major p and g with Ci in {8, 16, 32, 64}, Co = 8 or a
multiple of 16) on the CPU.

The kernel runs only on the card (``tests/test_torch_kernels_cuda.py``,
``chip_smoke.py``). Here:

- ``fused_conv.phase_dw_plan`` at packed UNETR's four phase dw rows and the
  flagship's L = 64 / L = 128 rows (batch 8, and 4 for a rank at two ranks)
  and at ragged shapes: the bricks tile the block grid and the splits walk
  every brick once, every tile (co chunk, tz, ty) belongs to exactly one
  (group, warpgroup, slot), the epilogue writes every (split, a'x, tap, ci,
  co) of the workspace exactly once, shared memory equals the header's sum
  (written out here) within the card's limit, and the six rows fill at least
  132 blocks;
- the rule (``dw_body``): which of those rows, the f32 and one-channel phase
  rows, small volumes and the dense rows take which body;
- :func:`emulate`, a plain PyTorch emulation of the body read as the card
  reads it: the TMA boxes of p (no halo) and g (one-voxel halo), zero outside
  the grid, written 128-byte swizzled into the ring slot; per k16 step and
  pass (a'z, a'y) operand B read through its descriptor (start inside the
  row, LBO, SBO, the address-based swizzle) and each warp's A rows through
  the kernel's ldmatrix lane addresses (piece shift and phase, swizzled 16-
  byte unit); the accumulators in K order; the epilogue's map to (a'x, tap,
  ci, co); the 2 x splits partials summed in their fixed order. Held in f32
  against ``phase_conv_dw_plain`` within 1e-5 * max|ref| (sums of a few
  thousand products in another order) and against the JAX package's
  ``phase_gemm.phase_conv_gemm_dw`` (its Pallas kernels in interpret mode,
  as ``tests/test_torch_conv_dw.py``) within 1e-4 absolute + relative.
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
from segmantic_tpu_torch.ops.fused_conv import SMEM_LIMIT, PhaseDwPlan, phase_dw_plan

SMS = 132


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The emulation is many small tensor operations: one thread, or the
    workers' thread pools contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (full-resolution dims, Ci, Co): packed UNETR's phase dw rows (p 48^3 x 128,
# p 48^3 x 256 -> 128, p 24^3 x 256, p 24^3 x 512 -> 256), the flagship's L =
# 64 / L = 128 rows, both at batch 8 and at a rank's batch 4
ROWS = [((8, 96, 96, 96), 16, 16), ((8, 96, 96, 96), 32, 16), ((8, 48, 48, 48), 32, 32),
        ((8, 48, 48, 48), 64, 32), ((8, 96, 96, 96), 8, 8), ((8, 48, 48, 48), 16, 16)]
RANK_ROWS = [((4, 96, 96, 96), 8, 8), ((4, 48, 48, 48), 16, 16)]
RAGGED = [((2, 6, 10, 18), 16, 16), ((1, 4, 6, 22), 8, 8), ((3, 2, 2, 2), 32, 48),
          ((1, 10, 4, 6), 64, 16)]

# the warps' x pieces (e_x, a_x) and tx = a'x + t0x
_EX = (0, 0, -1, 1)
_AX = (0, 1, 1, 0)
_T0X = tuple(1 - a - 2 * e for a, e in zip(_AX, _EX))


def _round1024(n):
    return -(-n // 1024) * 1024


def _header_smem(p: PhaseDwPlan, c: int, co: int) -> int:
    """``phase_dw_smem_bytes`` of csrc/conv3_phase_dw.cuh, written out."""
    halo = (p.td + 2) * (p.th + 2) * (p.tw + 2)
    return 2048 + p.stages * (c // 8 * p.td * p.th * p.tw * 128 + co // 8 * _round1024(halo * 128))


def _tiles(p: PhaseDwPlan):
    """(split-independent) tile of each (group, warpgroup, slot), None past the last."""
    out = {}
    for g, wg, i in itertools.product(range(p.groups), range(p.nwg), range(p.tpw)):
        t = (g * p.nwg + wg) * p.tpw + i
        out[g, wg, i] = t if t < p.n_tiles else None
    return out


def _epilogue_writes(p: PhaseDwPlan, c: int, co: int) -> np.ndarray:
    """How often the kernel's epilogue writes each (a'x, tap, ci, co) of one
    split's partials."""
    n = 2 * c
    hits = np.zeros((2, 27, c, co), dtype=np.int64)
    for (g, wg, i), t in _tiles(p).items():
        if t is None:
            continue
        co0, tz, ty = t // 9 * 16, t % 9 // 3, t % 3
        for w, lane, half, j in itertools.product(range(4), range(32), range(2), range(n // 8)):
            o = co0 + (lane >> 2) + 8 * half
            if (half and co < 16) or o >= co:
                continue
            col = 8 * j + 2 * (lane & 3)
            apx, ci = divmod(col, c)
            tx = _T0X[w] + apx
            if 0 <= tx <= 2:
                tap = (tz * 3 + ty) * 3 + tx
                hits[apx, tap, ci, o] += 1
                hits[apx, tap, ci + 1, o] += 1
    return hits


@pytest.mark.parametrize("dims,c,co", ROWS + RANK_ROWS + RAGGED)
def test_phase_dw_plan_covers_every_output_and_position_once(dims, c, co):
    p = phase_dw_plan(dims, c, co)
    b, d, h, w = dims[0], dims[1] // 2, dims[2] // 2, dims[3] // 2
    nb = b * -(-d // p.td) * -(-h // p.th) * -(-w // p.tw)
    assert p.nbricks == nb and 1 <= p.splits <= nb
    walked = sorted(k for s in range(p.splits) for k in range(s, nb, p.splits))
    assert walked == list(range(nb))  # every brick in exactly one split
    assert p.td * p.th * p.tw % 16 == 0 and p.td * p.th * p.tw <= fused_conv.PHASE_DW_MAX_ROWS
    assert p.fill == pytest.approx(b * d * h * w / (nb * p.td * p.th * p.tw))
    tiles = [t for t in _tiles(p).values() if t is not None]
    assert sorted(tiles) == list(range(9 * -(-co // 16))) == list(range(p.n_tiles))
    assert (p.tpw, p.nwg) in fused_conv._PHASE_DW_SHAPES[2 * c]
    assert p.grid == (p.splits, p.groups) and p.workspace == 2 * p.splits * 27 * c * co
    assert np.all(_epilogue_writes(p, c, co) == 1)
    assert 2 <= p.stages <= 4
    assert p.smem_bytes == _header_smem(p, c, co) <= SMEM_LIMIT
    assert fused_conv.phase_dw_smem_bytes(c, co, p.td, p.th, p.tw, p.stages) == p.smem_bytes


@pytest.mark.parametrize("dims,c,co", ROWS)
def test_phase_dw_plan_fills_the_card_at_the_rows(dims, c, co):
    p = phase_dw_plan(dims, c, co)
    assert p.splits * p.groups >= SMS, p
    assert p.fill == 1.0


@pytest.mark.parametrize("c,co", [(24, 16), (16, 24), (128, 16), (16, 40), (4, 16), (8, 12)])
def test_phase_dw_plan_refuses_channels_it_cannot_run(c, co):
    assert not fused_conv.phase_dw_eligible(c, co)
    with pytest.raises(ValueError, match="phase dw"):
        phase_dw_plan((1, 8, 8, 8), c, co)


# ---- the rule ------------------------------------------------------------------------

def _probe(dims, c, dtype=torch.bfloat16, phase=True):
    b, d, h, w = dims
    shape = (b, d // 2, h // 2, w // 2, 8 * c) if phase else (b, d, h, w, c)
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("dims,c,co", ROWS + RANK_ROWS)
def test_the_rows_take_the_phase_body(dims, c, co):
    want = "phase_blocks" if c >= fused_conv.PHASE_DW_MIN_C else "phase_pieces"
    assert fused_conv.dw_body(_probe(dims, c), c, co, True) == want  # L = 64: the pieces body
    # f32 keeps the register-tiled body, the dense layout never takes it
    assert fused_conv.dw_body(_probe(dims, c, torch.float32), c, co, True) == "f32_tiles"
    assert fused_conv.dw_body(_probe(dims, c, phase=False), c, co, False) != "phase_blocks"


@pytest.mark.parametrize("dims,c,co,body", [
    ((8, 96, 96, 96), 1, 16, "few_channels"),  # packed UNETR's one-channel input layer
    ((8, 96, 96, 96), 24, 16, "tensor_cores"),  # no (a'x, ci) run of 48 lanes
    ((8, 96, 96, 96), 16, 24, "tensor_cores"),  # co chunks of 16
    ((2, 16, 16, 16), 16, 16, "tensor_cores"),  # 1024 block voxels: below the least volume
    ((8, 96, 96, 96), 8, 16, "tensor_cores"),  # Ci = 8: below the least Ci
    ((8, 48, 48, 48), 128, 64, "tensor_cores"),
])
def test_other_phase_rows_keep_their_bodies(dims, c, co, body):
    assert fused_conv.dw_body(_probe(dims, c), c, co, True) == body


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


def _slot(pt, gt, b, z0, y0, x0, p: PhaseDwPlan, c, co):
    """The ring slot as the TMA writes it (bf16 elements, swizzled): c / 8
    planes of the p brick, then co / 8 planes of the g halo."""
    nrows = p.td * p.th * p.tw
    halo = (p.td + 2) * (p.th + 2) * (p.tw + 2)
    g_plane = _round1024(halo * 128) // 2
    planes = [_box(pt, b, 64 * k, z0, y0, x0, p.td, p.th, p.tw) for k in range(c // 8)]
    logical = [x.reshape(-1) for x in planes]
    for k in range(co // 8):
        rows = _box(gt, b, 64 * k, z0 - 1, y0 - 1, x0 - 1, p.td + 2, p.th + 2, p.tw + 2)
        logical.append(torch.cat([rows.reshape(-1), torch.zeros(g_plane - halo * 64)]))
    logical = torch.cat(logical)
    slot = torch.zeros_like(logical)
    slot[_swizzle(torch.arange(logical.numel()))] = logical
    return slot, nrows * 64, g_plane  # (elements; plane sizes in elements)


# lane l of an ldmatrix.x4.trans: k row (l & 7) + 8 (l >> 4), co half (l >> 3) & 1
_LANE = torch.arange(32)
_KROW = (_LANE & 7) + ((_LANE >> 4) << 3)
_HI = (_LANE >> 3) & 1


def emulate(pt, gt, dims, p: PhaseDwPlan) -> torch.Tensor:
    """The phase dw's Hopper body on phase-major p (B, D/2, H/2, W/2, 8 c) and
    g (B, D/2, H/2, W/2, 8 co) (f32), as the card computes it: returns the
    (3, 3, 3, c, co) gradient."""
    c, co = pt.shape[-1] // 8, gt.shape[-1] // 8
    b_, d, h, w = dims[0], dims[1] // 2, dims[2] // 2, dims[3] // 2
    n = 2 * c
    hp, wp = p.th + 2, p.tw + 2
    nrows = p.td * p.th * p.tw
    q = torch.arange(nrows)
    qz, qr = q // (p.th * p.tw), q % (p.th * p.tw)
    qtab = ((qz + 1) * hp + qr // p.tw + 1) * wp + qr % p.tw + 1  # brick position -> halo row
    nbz, nby, nbx = -(-d // p.td), -(-h // p.th), -(-w // p.tw)
    part = torch.zeros(p.splits, 2, 27, c, co)
    for split, (g_, wg, i) in itertools.product(range(p.splits), _tiles(p)):
        t = _tiles(p)[g_, wg, i]
        t0 = 0 if t is None else t  # past the last tile: tile 0 again, never stored
        co0, tz, ty = t0 // 9 * 16, t0 % 9 // 3, t0 % 3
        acc = torch.zeros(64, n)
        for brick in range(split, p.nbricks, p.splits):
            r, x0 = divmod(brick, nbx)
            r, y0 = divmod(r, nby)
            b, z0 = divmod(r, nbz)
            slot, p_plane, g_plane = _slot(pt, gt, b, z0 * p.td, y0 * p.th, x0 * p.tw, p, c, co)
            gbase = (c // 8) * p_plane  # elements
            for st in range(4 * (nrows // 16)):
                ks, apz, apy = st >> 2, (st >> 1) & 1, st & 1
                # B: the run (a'x, ci) of (a'z, a'y), MN-major by descriptor
                l0 = (apz * 4 + apy * 2) * c
                start = 2 * ((l0 >> 6) * p_plane) + ks * 2048 + (l0 & 63) * 2  # bytes
                kk = torch.arange(16).reshape(-1, 1)
                nn = torch.arange(n).reshape(1, -1)
                addr = start + 2 * (nn % 64) + 2 * p_plane * (nn // 64) + 128 * (kk % 8) \
                    + 1024 * (kk // 8)
                b_op = slot[_swizzle(addr // 2)]  # (16, n)
                # A: each warp's 16 co rows x 16 positions by its lanes' ldmatrix addresses
                hr0 = qtab[16 * ks + _KROW]
                cohi = 8 * _HI if co >= 16 else 0 * _HI
                sz, sy = apz + 1 - tz, apy + 1 - ty
                a_op = torch.zeros(64, 16)
                for wv in range(4):
                    hr = hr0 + (sz >> 1) * hp * wp + (sy >> 1) * wp + _EX[wv]
                    lo = ((sz & 1) * 4 + (sy & 1) * 2 + _AX[wv]) * co + co0 + cohi
                    byte = 2 * gbase + (lo >> 6) * 2 * g_plane + hr * 128 \
                        + ((((lo & 63) >> 3) ^ (hr & 7)) << 4)
                    vals = slot[(byte // 2).reshape(-1, 1) + torch.arange(8)]  # (32 lanes, 8)
                    for lane in range(32):
                        k, row0 = int(_KROW[lane]), 8 * int(_HI[lane])
                        a_op[16 * wv + row0:16 * wv + row0 + 8, k] = vals[lane]
                acc += a_op @ b_op
        if t is None:
            continue
        for wv, r, col in itertools.product(range(4), range(16), range(n)):
            o = co0 + r
            if (r >= 8 and co < 16) or o >= co:
                continue
            apx, ci = divmod(col, c)
            tx = _T0X[wv] + apx
            if 0 <= tx <= 2:
                part[split, apx, (tz * 3 + ty) * 3 + tx, ci, o] = acc[16 * wv + r, col]
    flat = part.reshape(2 * p.splits, 27 * c * co)
    out = flat[0].clone()
    for k in range(1, 2 * p.splits):  # the second pass: partials in split, a'x order
        out += flat[k]
    return out.reshape(3, 3, 3, c, co)


def _rand(rng, shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _variants(dims, c, co):
    """The wrapper's plan and variants on the other instances of its N, other
    bricks and split counts."""
    p = phase_dw_plan(dims, c, co)
    b, d, h, w = dims[0], dims[1] // 2, dims[2] // 2, dims[3] // 2
    out = [p]
    shapes = fused_conv._PHASE_DW_SHAPES[2 * c]
    for (tpw, nwg), brick, splits in zip(
            itertools.cycle(shapes),
            [(1, 2, 8), (2, 2, 4), (1, 1, 16)], (2, 3, 1)):
        nb = b * -(-d // brick[0]) * -(-h // brick[1]) * -(-w // brick[2])
        groups = -(-p.n_tiles // (tpw * nwg))
        s = min(splits, nb)
        out.append(dataclasses.replace(p, td=brick[0], th=brick[1], tw=brick[2], tpw=tpw, nwg=nwg,
                                       groups=groups, splits=s, grid=(s, groups),
                                       nbricks=nb))
    return out


@pytest.mark.parametrize("dims,c,co", [((1, 4, 6, 10), 16, 16), ((2, 2, 4, 6), 8, 8),
                                       ((1, 2, 6, 4), 32, 16), ((1, 2, 2, 6), 64, 32),
                                       ((1, 4, 2, 4), 16, 48)])
def test_emulated_body_matches_plain(dims, c, co):
    rng = np.random.default_rng(c + co)
    shape = (dims[0], dims[1] // 2, dims[2] // 2, dims[3] // 2)
    pt = _rand(rng, shape + (8 * c,))
    gt = _rand(rng, shape + (8 * co,))
    want = phase_conv.phase_conv_dw_plain(pt, gt)
    for p in _variants(dims, c, co):
        got = emulate(pt, gt, dims, p)
        assert (got - want).abs().max() <= 1e-5 * want.abs().max(), p


@pytest.mark.parametrize("p_shape", [(1, 2, 4, 8, 64), (1, 3, 2, 4, 128)],
                         ids=["folded_L64", "direct_L128"])
def test_emulated_body_matches_pallas(p_shape):
    rng = np.random.default_rng(3)
    c = p_shape[-1] // 8
    p_in = rng.standard_normal(p_shape).astype(np.float32)
    g = rng.standard_normal(p_shape).astype(np.float32)
    w = (0.1 * rng.standard_normal((3, 3, 3, c, c))).astype(np.float32)
    want = np.asarray(phase_gemm.phase_conv_gemm_dw(
        jnp.asarray(p_in), jnp.asarray(g), jnp.asarray(w), interpret=True))
    dims = (p_shape[0],) + tuple(2 * v for v in p_shape[1:4])
    got = emulate(torch.from_numpy(p_in), torch.from_numpy(g), dims, phase_dw_plan(dims, c, c))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


def test_every_c_entry_point_has_its_ctypes_signature():
    """Each ``extern "C"`` entry of ``csrc/*.cu`` takes the arguments its
    ``_cuda._SIGNATURES`` entry passes: a pointer for every pointer and the
    stream, a 32-bit int for every int, a 64-bit int for every long long."""
    import re
    from pathlib import Path

    from segmantic_tpu_torch.ops import _cuda

    found = {}
    for src in sorted(Path(_cuda._CSRC).glob("*.cu")):
        text = src.read_text()
        for m in re.finditer(r'extern "C" int (segk_\w+)\(([^)]*)\)', text):
            kinds = []
            for arg in m.group(2).split(","):
                arg = " ".join(arg.split())
                kinds.append(_cuda._P if "*" in arg else
                             _cuda._L if arg.startswith("long long") else _cuda._I)
            found[m.group(1)] = kinds
    assert set(found) == set(_cuda._SIGNATURES)
    for name, kinds in found.items():
        assert _cuda._SIGNATURES[name] == kinds, name
