"""The launch plan and the index maps of the tensor-core weight-gradient body
(``csrc/conv3_dw_mma.cuh``), on the CPU.

The kernel itself runs only on the card (``tests/test_torch_kernels_cuda.py``,
``chip_smoke.py``). Here:

- ``fused_conv.dw_plan`` at the ten dw shapes of one flagship train step
  (batch 8) and at ragged ones: shared memory within the card's limit and
  equal to the C side's sum, every brick walked by exactly one split, K fill,
  workspace size, grid limits;
- :func:`emulate_dw`, a plain PyTorch emulation of the body's tiling (bricks
  walked split by split, the halo staged with zero fill through the layout's
  index map, the K-row and tap tables, tap pairs at CK = 8, per-split
  partials summed in the second kernel's order), against ``conv3d_dw_plain``
  / ``phase_conv_dw_plain`` within 1e-5 * max|ref| in f32 (sums of a few
  thousand terms in another order) and against the JAX package's
  ``conv3d_packed_dw`` and ``phase_conv_gemm_dw`` in interpret mode on the
  same numpy-seeded inputs (1e-4 absolute + relative, as
  ``test_torch_train_ops.py``);
- the rule between the three bodies, cases of each branch (``dw_body``).
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmantic_tpu.ops import pallas_conv, phase_gemm
from segmantic_tpu_torch.ops import fused_conv, phase_conv
from segmantic_tpu_torch.ops.fused_conv import DwPlan, SMEM_LIMIT, dw_plan

FLAGSHIP = [  # (full-resolution dims, C, CO) of the dw launches of one step, batch 8
    ((8, 48, 48, 48), 16, 16), ((8, 24, 24, 24), 32, 32), ((8, 12, 12, 12), 64, 64),
    ((8, 6, 6, 6), 128, 128), ((8, 6, 6, 6), 128, 256), ((8, 6, 6, 6), 256, 256),
    ((8, 96, 96, 96), 8, 8),  # phase, L = 64
    ((8, 48, 48, 48), 16, 16),  # phase, L = 128 (the dense top shape again)
    ((8, 24, 24, 24), 32, 32), ((8, 12, 12, 12), 64, 64),  # the decoder's
]
RAGGED = [((2, 20, 22, 26), 16, 24), ((2, 5, 7, 9), 8, 8), ((1, 10, 14, 18), 8, 16),
          ((3, 7, 9, 50), 40, 16), ((1, 6, 6, 6), 8, 8), ((1, 2, 2, 2), 24, 8)]


def _pitch(n):
    return 16 if n == 8 else 2 * n + 16


def _c_side_smem(p: DwPlan) -> int:
    """``dw_mma_smem_bytes``, written out from the header's definitions."""
    halo = (p.td + 2) * (p.th + 2) * (p.tw + 2)
    rows16 = (p.td * p.th * p.tw + 15) // 16 * 16
    tables = 128 + ((halo + 2 * rows16) * 4 + 15) // 16 * 16
    return tables + p.stages * (halo * _pitch(p.ck) + rows16 * _pitch(p.nt))


@pytest.mark.parametrize("dims,c,co", FLAGSHIP + RAGGED)
def test_dw_plan_is_launchable(dims, c, co):
    p = dw_plan(dims, c, co)
    b, d, h, w = dims
    assert p.smem_bytes == _c_side_smem(p) <= SMEM_LIMIT
    assert (p.ck, p.nt) in {(k, n) for k in (8, 16, 32) for n in (8, 16, 32)}
    assert (p.ck == 8) == (c == 8)
    assert (p.warps, p.taps_per_warp) == ((7, 2) if p.ck == 8 else (9, 3))
    assert p.warps * p.taps_per_warp * (2 if p.ck == 8 else 1) >= 27  # every tap has a warp
    assert p.n_ci * p.ck >= c and p.n_co * p.nt >= co
    assert p.grid == (p.splits, p.n_ci * p.n_co) and p.grid[1] <= 65535
    assert p.nbricks == b * -(-d // p.td) * -(-h // p.th) * -(-w // p.tw)
    assert 1 <= p.splits <= p.nbricks and p.stages in (2, 3)
    assert p.workspace == (p.splits * 27 * c * co if p.splits > 1 else 0)
    assert p.tw % 2 == 0  # phase layout: a brick starts and ends on an even x
    rows16 = -(-p.td * p.th * p.tw // 16) * 16
    assert p.fill == pytest.approx(b * d * h * w / (p.nbricks * rows16))
    # every brick is walked by exactly one split
    walked = sorted(k for s in range(p.splits) for k in range(s, p.nbricks, p.splits))
    assert walked == list(range(p.nbricks))


@pytest.mark.parametrize("dims,c,co", FLAGSHIP + RAGGED[:1])
def test_dw_plan_fills_the_k16_steps(dims, c, co):
    assert dw_plan(dims, c, co).fill >= 0.75


def test_dw_plan_workspace_is_one_partial_per_split():
    """16 position groups a split are gone: the phase top stage's workspace is
    splits * 1728 floats."""
    p = dw_plan((8, 96, 96, 96), 8, 8)
    assert p.workspace == p.splits * 1728 and p.splits >= 132
    assert dw_plan((1, 6, 6, 6), 8, 8).splits == 1  # one brick: no second launch


@pytest.mark.parametrize("c,co", [(12, 16), (16, 20), (0, 8), (8, 0)])
def test_dw_plan_refuses_other_channel_counts(c, co):
    with pytest.raises(ValueError, match="% 8"):
        dw_plan((1, 4, 4, 4), c, co)


@pytest.mark.parametrize("dtype,c,co,expect", [
    (torch.bfloat16, 16, 16, "tensor_cores"), (torch.bfloat16, 8, 24, "tensor_cores"),
    (torch.float32, 16, 16, "f32_tiles"),  # f32 keeps its f32 FMAs
    (torch.bfloat16, 12, 16, "f32_tiles"), (torch.bfloat16, 16, 20, "f32_tiles"),
    (torch.bfloat16, 3, 5, "few_channels"),  # C = 1..7: the few-channel body, any CO
])
def test_route_rule(dtype, c, co, expect):
    x = torch.zeros((1, 2, 2, 2, max(c, 1)), dtype=dtype)
    assert fused_conv.dw_body(x, c, co) == expect


def test_cuda_launcher_refuses_cpu_tensors():
    x = torch.zeros((1, 2, 2, 2, 8), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        fused_conv.launch_conv3_dw("segk_fused_conv3_dw", x, x, (1, 2, 2, 2), 8, 8)


# ---- the body's tiling, emulated -------------------------------------------

def _inner(phase: bool, z, y, x, c, h, w, nc):
    """``DenseLayout::inner`` / ``PhaseLayout::inner``: offset of channel c of
    full-resolution voxel (z, y, x) inside one sample."""
    if not phase:
        return ((z * h + y) * w + x) * nc + c
    ph = ((z & 1) << 2) | ((y & 1) << 1) | (x & 1)
    return ((((z >> 1) * (h >> 1) + (y >> 1)) * (w >> 1) + (x >> 1)) * 8 + ph) * nc + c


def _stage(flat, phase, coords, c0, width, dims, nc):
    """Rows of ``width`` channels from c0 on, one per (z, y, x) of ``coords``,
    zero where the voxel lies outside the volume or the channel beyond nc: the
    zero-filling 16-byte copies, 8 channels a piece."""
    d, h, w = dims
    z, y, x = coords
    inside = (z >= 0) & (z < d) & (y >= 0) & (y < h) & (x >= 0) & (x < w)
    rows = torch.zeros((z.numel(), width), dtype=flat.dtype)
    for piece in range(width // 8):
        c = c0 + piece * 8
        if c >= nc:
            continue
        off = _inner(phase, z.clamp(0, d - 1), y.clamp(0, h - 1), x.clamp(0, w - 1), c, h, w, nc)
        vals = flat[off[:, None] + torch.arange(8)]
        rows[:, piece * 8: piece * 8 + 8] = torch.where(inside[:, None], vals, 0)
    return rows


def emulate_dw(x: torch.Tensor, dy: torch.Tensor, dims, c: int, co: int, p: DwPlan,
               phase: bool) -> torch.Tensor:
    """What ``conv3_dw_mma_kernel`` and the reduce kernel compute, block by
    block, in f32: x and dy are the stored tensors (dense, or phase-major with
    ``dims`` the full-resolution grid)."""
    b, d, h, w = dims
    hp_h, hp_w = p.th + 2, p.tw + 2
    halo_n = (p.td + 2) * hp_h * hp_w
    rows = p.td * p.th * p.tw
    rows16 = -(-rows // 16) * 16
    nbz, nby, nbx = -(-d // p.td), -(-h // p.th), -(-w // p.tw)
    # the tables at the head of shared memory
    tapoff = [((t // 9) * hp_h + (t // 3) % 3) * hp_w + t % 3 for t in range(27)]
    tapoff += [tapoff[26]] * 5
    i = torch.arange(halo_n)
    pos = (i // (hp_h * hp_w), i % (hp_h * hp_w) // hp_w, i % hp_w)
    r = torch.arange(rows16)
    rz, ry, rx = r // (p.th * p.tw), r % (p.th * p.tw) // p.tw, r % p.tw
    real = r < rows
    arow = torch.where(real, (rz * hp_h + ry) * hp_w + rx, 0)
    xf, gf = x.reshape(b, -1).float(), dy.reshape(b, -1).float()
    ws = torch.zeros((p.splits, 27, c, co))
    for split in range(p.splits):
        for tile in range(p.n_ci * p.n_co):
            c0, co0 = (tile % p.n_ci) * p.ck, (tile // p.n_ci) * p.nt
            acc = torch.zeros((28, p.ck, p.nt))
            for brick in range(split, p.nbricks, p.splits):
                bx, by = brick % nbx, brick // nbx % nby
                bz, bb = brick // (nbx * nby) % nbz, brick // (nbx * nby * nbz)
                z0, y0, x0 = bz * p.td, by * p.th, bx * p.tw
                halo = _stage(xf[bb], phase, (z0 - 1 + pos[0], y0 - 1 + pos[1], x0 - 1 + pos[2]),
                              c0, p.ck, (d, h, w), c)
                g = _stage(gf[bb], phase, (torch.where(real, z0 + rz, -1), y0 + ry, x0 + rx),
                           co0, p.nt, (d, h, w), co)
                if p.ck == 8:  # two taps share one m16: rows 0-7 tap 2k, rows 8-15 tap 2k + 1
                    for pair in range(p.warps * p.taps_per_warp):
                        a = torch.cat([halo[arow + tapoff[2 * pair]],
                                       halo[arow + tapoff[2 * pair + 1]]], 1)  # (rows16, 16)
                        acc[2 * pair: 2 * pair + 2] += (a.T @ g).reshape(2, 8, p.nt)
                else:
                    for tap in range(p.warps * p.taps_per_warp):
                        acc[tap] += halo[arow + tapoff[tap]].T @ g
            n_c, n_o = min(p.ck, c - c0), min(p.nt, co - co0)
            ws[split, :, c0: c0 + n_c, co0: co0 + n_o] = acc[:27, :n_c, :n_o]  # the 28th is dropped
    if p.splits == 1:
        out = ws[0]
    elif p.splits < 16:
        out = torch.zeros_like(ws[0])
        for k in range(p.splits):
            out = out + ws[k]
    else:  # 8 lanes sum k = lane, lane + 8, ...; then the lanes in order
        lanes = []
        for lane in range(8):
            s = torch.zeros_like(ws[0])
            for k in range(lane, p.splits, 8):
                s = s + ws[k]
            lanes.append(s)
        out = lanes[0]
        for s in lanes[1:]:
            out = out + s
    return out.reshape(3, 3, 3, c, co)


def _plans(dims, c, co):
    """The chosen plan, plus the cheapest candidate of every other (CK, NT)
    pair and one with several bricks per split."""
    chosen = dw_plan(dims, c, co)
    found = {(chosen.ck, chosen.nt): chosen}
    for _, p in sorted(fused_conv._dw_candidates(dims, c, co, 132), key=lambda kp: kp[0]):
        found.setdefault((p.ck, p.nt), p)
    plans = list(found.values())
    many = chosen
    if chosen.nbricks >= 3:
        splits = 2 if chosen.nbricks < 40 else 17  # 17: the reduce's eight-lane order
        many = dataclasses.replace(chosen, splits=splits, grid=(splits, chosen.grid[1]),
                                   workspace=splits * 27 * c * co)
    return plans + [many]


def _rand(rng, shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("dims,c,co", [
    ((2, 5, 7, 9), 8, 8),  # ragged bricks, tap pairs
    ((1, 6, 6, 6), 16, 24),  # CO over two tiles or a padded one
    ((2, 4, 6, 12), 24, 8),  # a C chunk padded to 32
    ((1, 3, 20, 40), 8, 16),  # many bricks along x
])
def test_emulated_body_matches_plain_dense(dims, c, co):
    rng = np.random.default_rng(10)
    x, dy = _rand(rng, dims + (c,)), _rand(rng, dims + (co,))
    want = fused_conv.conv3d_dw_plain(x, dy)
    for p in _plans(dims, c, co):
        got = emulate_dw(x, dy, dims, c, co, p, phase=False)
        assert (got - want).abs().max() <= 1e-5 * want.abs().max(), p


@pytest.mark.parametrize("p_shape,c,co", [
    ((1, 3, 4, 5, 64), 8, 8),  # L = 64: tap pairs through the depth-to-space map
    ((2, 2, 3, 4, 128), 16, 16),  # L = 128
    ((1, 2, 5, 3, 64), 8, 16),
])
def test_emulated_body_matches_plain_phase(p_shape, c, co):
    rng = np.random.default_rng(11)
    p_in, g = _rand(rng, p_shape), _rand(rng, p_shape[:4] + (8 * co,))
    dims = (p_shape[0],) + tuple(2 * v for v in p_shape[1:4])
    want = phase_conv.phase_conv_dw_plain(p_in, g)
    for p in _plans(dims, c, co):
        got = emulate_dw(p_in, g, dims, c, co, p, phase=True)
        assert (got - want).abs().max() <= 1e-5 * want.abs().max(), p


@pytest.mark.parametrize("x_shape,co", [((2, 4, 8, 8, 32), 16), ((4, 3, 6, 16, 16), 24)])
def test_emulated_body_matches_pallas_dense(x_shape, co):
    assert pallas_conv.supported(x_shape, co)
    rng = np.random.default_rng(0)
    x = rng.standard_normal(x_shape).astype(np.float32)
    dy = rng.standard_normal(x_shape[:4] + (co,)).astype(np.float32)
    want = np.asarray(pallas_conv.conv3d_packed_dw(jnp.asarray(x), jnp.asarray(dy),
                                                   interpret=True))
    dims, c = x_shape[:4], x_shape[-1]
    got = emulate_dw(torch.from_numpy(x), torch.from_numpy(dy), dims, c, co,
                     dw_plan(dims, c, co), phase=False)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("p_shape", [(1, 2, 4, 16, 64), (1, 3, 4, 8, 128)],
                         ids=["folded_L64", "direct_L128"])
def test_emulated_body_matches_pallas_phase(p_shape):
    rng = np.random.default_rng(2)
    c = p_shape[-1] // 8
    p_in = rng.standard_normal(p_shape).astype(np.float32)
    g = rng.standard_normal(p_shape).astype(np.float32)
    w = (0.1 * rng.standard_normal((3, 3, 3, c, c))).astype(np.float32)
    want = np.asarray(phase_gemm.phase_conv_gemm_dw(
        jnp.asarray(p_in), jnp.asarray(g), jnp.asarray(w), interpret=True))
    dims = (p_shape[0],) + tuple(2 * v for v in p_shape[1:4])
    got = emulate_dw(torch.from_numpy(p_in), torch.from_numpy(g), dims, c, c,
                     dw_plan(dims, c, c), phase=True)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
