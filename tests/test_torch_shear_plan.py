"""The shear-group kernel's launch plan and traversal, on the CPU.

``fused_shear.group_plan`` is held to what the kernel needs of it (one plane
buffer inside a block's shared memory, at least two resident blocks per SM at
the training chain's 144^3 shapes for every type, rows padded to an odd number
of 32-bit words, chunks of the third axis that cover it exactly once, 16-byte
rows only where every row is aligned). The kernel itself cannot run here, so
its traversal is emulated in plain PyTorch: one buffer per plane, the three
passes in place with every output window kept centered in its line, the
position split into the part an output index fixes (computed once per pass)
and the line's shift (once per line), every operation rounded on its own. The
emulation equals ``shear_group_plain`` bit for bit for order 0 and for order 1
with bf16 weights (two exact products and one sum have no order to differ in)
and within 1e-6 * max|ref| for order 1 in f32 (the plain version's matrix
product may fuse the multiply and add); ``test_torch_shear_resample.py`` ties
``shear_group_plain`` to the JAX passes.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from segmantic_tpu_torch.ops import fused_shear, shear_resample

FLAGSHIP = ((144, 144, 144), (96, 96, 96))
DTYPES = [torch.bfloat16, torch.float32, torch.uint8, torch.int32]


def _flagship_groups():
    """(input dims, a, b, specs) of the three groups of the 144^3 -> 96^3 chain."""
    _, _, _, groups = shear_resample.chain_plan(FLAGSHIP[0], 3, FLAGSHIP[1], 0.4, 0.8)
    dims = list(FLAGSHIP[0])
    out = []
    for a, b, specs in groups:
        out.append((tuple(dims), a, b, specs))
        dims = list(fused_shear.group_plan(tuple(dims), a, b, specs, torch.float32).out_dims)
    return out


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("group", [0, 1, 2])
def test_plan_at_the_flagship_groups(group, dtype):
    dims, a, b, specs = _flagship_groups()[group]
    p = fused_shear.group_plan(dims, a, b, specs, dtype, images=5)
    item = torch.empty((), dtype=dtype).element_size()
    assert p.smem_bytes <= 232448
    assert p.blocks_per_sm >= 2
    assert p.smem_bytes == (p.cp * p.passes[0] * p.row_units * p.unit_bytes
                            + 4 * sum(p.passes[2::5]))  # planes, then the position tables
    assert not p.block_lines and max(p.passes[2::5]) <= 256
    assert p.unit_bytes == p.wc * item <= 4
    assert p.row_units >= p.passes[1] and (p.row_units * p.unit_bytes) % 4 == 0
    assert (p.row_units * p.unit_bytes // 4) % 2 == 1  # odd words: no bank conflicts
    c_axis = 3 - a - b
    per_block = p.wc * p.cp
    assert p.chunks * per_block >= dims[c_axis] > (p.chunks - 1) * per_block  # exactly once
    assert p.grid == 5 * p.chunks and p.threads in (256, 512)
    # the third axis of the (D, H) plane is the memory-minor one: 4-byte units;
    # elsewhere two planes share their positions where two blocks still fit an SM
    assert p.wc == (max(1, 4 // item) if c_axis == 2 else 1)
    assert p.cp == (2 if c_axis != 2 and item <= 2 else 1)
    assert p.grid >= 2 * 132 or p.cp == 1
    # planes that hold W move 16 bytes a thread, in and out
    assert p.vec_in == p.vec_out == (c_axis != 2)
    if group == 2:
        assert p.out_dims == (96, 96, 96)


@pytest.mark.parametrize("dims,a,b,dtype,expect", [
    ((20, 22, 24), 1, 2, torch.bfloat16, dict(wc=1, vec_in=True, vec_out=True)),
    ((15, 18, 17), 1, 2, torch.bfloat16, dict(wc=1, vec_in=False, vec_out=False)),  # odd rows
    ((15, 18, 17), 0, 1, torch.uint8, dict(wc=4, chunks=5)),  # ragged last chunk
    ((15, 18, 17), 0, 1, torch.bfloat16, dict(wc=2, chunks=9)),
    ((16, 16, 1), 0, 1, torch.float32, dict(wc=1, chunks=1, vec_in=True)),  # 2D
    ((17, 19, 1), 0, 1, torch.uint8, dict(wc=1, chunks=1, vec_in=False)),
    ((300, 20, 4), 0, 1, torch.float32, dict(block_lines=True, threads=512)),  # long lines
    ((8, 8, 3), 0, 1, torch.uint8, dict(wc=2, chunks=2)),
    ((20, 22, 24), 1, 2, torch.bfloat16, dict(cp=1, chunks=20)),  # too few blocks for two planes
    ((133, 20, 24), 1, 2, torch.bfloat16, dict(cp=2, chunks=67, wc=1)),  # ragged last pair
    ((300, 20, 133), 0, 1, torch.float32, dict(cp=2, chunks=67, block_lines=True)),
])
def test_plan_at_ragged_odd_and_2d_shapes(dims, a, b, dtype, expect):
    specs = ((False, None, None),) * 3
    p = fused_shear.group_plan(dims, a, b, specs, dtype, images=4)
    for key, value in expect.items():
        assert getattr(p, key) == value, (key, p)
    assert p.smem_bytes <= 232448 and p.grid == 4 * p.chunks
    per_block = p.wc * p.cp
    assert p.chunks * per_block >= dims[3 - a - b] > (p.chunks - 1) * per_block
    assert p.scratch_units == (p.cp * max(p.passes[2::5]) if p.block_lines else 0)
    behind = p.scratch_units * p.unit_bytes if p.block_lines else 4 * sum(p.passes[2::5])
    assert p.smem_bytes == p.cp * p.passes[0] * p.row_units * p.unit_bytes + behind
    unaligned = fused_shear.group_plan(dims, a, b, specs, dtype, images=4, aligned=False)
    assert not unaligned.vec_in and unaligned.vec_out == p.vec_out


def test_plan_prefers_two_blocks_and_refuses_what_cannot_fit():
    specs = ((False, None, None),) * 3
    # a 232 x 232 plane of bf16: 4-byte units leave one block per SM, 2-byte units two
    p = fused_shear.group_plan((232, 232, 8), 0, 1, specs, torch.bfloat16)
    assert p.wc == 1 and p.blocks_per_sm == 2
    # nothing leaves two blocks: the widest unit that fits at all
    p = fused_shear.group_plan((256, 240, 8), 0, 1, specs, torch.bfloat16)
    assert p.wc == 1 and p.blocks_per_sm == 1 and p.smem_bytes <= 232448
    assert not p.global_plane and p.global_bytes == 0
    # a plane no block's shared memory holds lies in global scratch, one a
    # block; shared memory keeps the position tables (lines of 256 fit a warp)
    p = fused_shear.group_plan((256, 256, 4), 0, 1, specs, torch.float32, images=3)
    assert p.global_plane and (p.wc, p.cp, p.chunks, p.grid) == (1, 1, 4, 12)
    assert not p.block_lines and p.smem_bytes == 4 * 3 * 256
    assert p.global_bytes == 12 * 256 * p.row_units * 4 and p.row_units == 257
    # what cannot fit: a scratch line longer than a block's shared memory
    with pytest.raises(ValueError, match="shared memory"):
        fused_shear.group_plan((60000, 4, 1), 0, 1, specs, torch.float32)
    with pytest.raises(ValueError, match="center window"):
        fused_shear.group_plan((16, 16, 4), 0, 1, ((False, None, 11),) * 3, torch.float32)


def _hoisted_positions(p, s, zoom):
    """(S, lines, n_out) positions as the kernel forms them: the part output
    index o fixes (once per pass), minus the line's shift (once per line),
    minus the input window's offset in zoom passes."""
    n_in, n_other, n_out, use_zoom, frame = p
    o_glob = (torch.arange(n_out) + (n_in - n_out) // 2).to(torch.float32)
    if use_zoom:
        off_in = float((frame - n_in) // 2)
        c_f = 0.5 * (frame - 1)
        of_output = ((o_glob[None, :] + off_in) - c_f) / zoom[:, None] + c_f
    else:
        of_output = o_glob[None, :].expand(len(s), -1)
    rel = torch.arange(n_other, dtype=torch.float32) - 0.5 * (n_other - 1)
    shift = s[:, None] * rel[None, :]
    pos = of_output[:, None, :] - shift[:, :, None]
    return pos - off_in if use_zoom else pos


def _pass_in_place(view, p, s, zoom, order, round_w):
    """One pass over ``view`` (S, C, nc, n_in, lines): every line's outputs are
    read from the line, then written over its center window."""
    n_in, _, n_out, _, _ = p
    pos = _hoisted_positions(p, s, zoom).transpose(1, 2)[:, None, None]  # (S,1,1,n_out,lines)
    shape = (*view.shape[:3], n_out, view.shape[4])
    if order == 0:
        idx = torch.floor(pos + 0.5).to(torch.int64)
        valid = (idx >= 0) & (idx <= n_in - 1)
        got = view.gather(3, idx.clamp(0, n_in - 1).expand(shape))
        out = torch.where(valid, got, torch.zeros((), dtype=view.dtype))
    else:
        valid = (pos >= 0) & (pos <= n_in - 1)
        lo = torch.floor(pos).to(torch.int64).clamp(0, n_in - 2)
        w1 = pos - lo.to(torch.float32)
        w0 = 1.0 - w1
        x0 = view.gather(3, lo.expand(shape)).to(torch.float32)
        x1 = view.gather(3, (lo + 1).expand(shape)).to(torch.float32)
        if round_w:
            w0, w1, x0, x1 = (t.to(torch.bfloat16).to(torch.float32) for t in (w0, w1, x0, x1))
        out = torch.where(valid, w0 * x0 + w1 * x1, torch.zeros(())).to(view.dtype)
    off = (n_in - n_out) // 2
    view[:, :, :, off:off + n_out, :] = out


def emulate_group(x, a_axis, b_axis, coef, zoom, specs, order, bf16, sms=132):
    """The kernel's traversal: per chunk of the third axis one buffer of
    planes (rows padded as planned, filled with a sentinel), three passes in
    place, the result read from the centered window."""
    p = fused_shear.group_plan(tuple(x.shape[2:]), a_axis, b_axis, tuple(specs), x.dtype,
                               x.shape[0] * x.shape[1], True, sms)
    c_axis = 3 - a_axis - b_axis
    planes = x.permute(0, 1, 2 + c_axis, 2 + a_axis, 2 + b_axis)  # (S, C, nc, A0, B0)
    passes = [p.passes[5 * j: 5 * j + 5] for j in range(3)]
    (a0, b0, a1, _, _), (_, _, b1, _, _), (_, _, a2, _, _) = passes
    off_a, off_b = (a0 - a1) // 2, (b0 - b1) // 2
    out = torch.empty((*planes.shape[:3], a2, b1), dtype=x.dtype)
    written = torch.zeros(planes.shape[2], dtype=torch.int64)
    sentinel = 77 if not x.dtype.is_floating_point else float("nan")
    round_w = bool(bf16) and order == 1
    per_block = p.wc * p.cp
    for chunk in range(p.chunks):
        c0, c1 = chunk * per_block, min((chunk + 1) * per_block, planes.shape[2])
        buf = torch.full((*planes.shape[:2], c1 - c0, a0, p.row_units), sentinel, dtype=x.dtype)
        buf[..., :b0] = planes[:, :, c0:c1]
        _pass_in_place(buf[..., :b0], passes[0], coef[:, 0], zoom, order, round_w)
        rows = buf[:, :, :, off_a:off_a + a1]
        _pass_in_place(rows[..., :b0].transpose(3, 4), passes[1], coef[:, 1], zoom, order,
                       round_w)
        _pass_in_place(rows[..., off_b:off_b + b1], passes[2], coef[:, 2], zoom, order, round_w)
        lo = off_a + (a1 - a2) // 2
        out[:, :, c0:c1] = buf[:, :, :, lo:lo + a2, off_b:off_b + b1]
        written[c0:c1] += 1
    assert bool((written == 1).all())  # the chunks cover the third axis exactly once
    inverse = [0, 1, 0, 0, 0]
    inverse[2 + c_axis], inverse[2 + a_axis], inverse[2 + b_axis] = 2, 3, 4
    return out.permute(*inverse)


def _inputs(full, out_shape, samples, channels, dtype, seed):
    rng = np.random.default_rng(seed)
    passes, divz, _, groups = shear_resample.chain_plan(full, 3, out_shape, 0.4, 0.8)
    angles = torch.from_numpy(rng.uniform(-0.4, 0.4, (samples, 3)).astype(np.float32))
    zoom = torch.from_numpy(rng.uniform(0.8, 1.3, samples).astype(np.float32))
    coef = shear_resample.shear_coefficients(angles, zoom, passes, divz)
    if dtype.is_floating_point:
        x = torch.from_numpy(rng.standard_normal((samples, channels, *full))
                             .astype(np.float32)).to(dtype)
    else:
        x = torch.from_numpy(rng.integers(0, 9, (samples, channels, *full))).to(dtype)
    return x, coef, zoom, groups


@pytest.mark.parametrize("use_zoom", [False, True])
@pytest.mark.parametrize("n_in,n_other,n_out,frame", [
    (144, 144, 96, 144), (24, 20, 14, 24), (17, 15, 17, 17), (20, 9, 12, 26),
])
def test_hoisted_positions_are_shear_pass_positions(n_in, n_other, n_out, frame, use_zoom):
    rng = np.random.default_rng(3)
    s = torch.from_numpy(rng.uniform(-0.5, 0.5, 6).astype(np.float32))
    zoom = torch.from_numpy(rng.uniform(0.8, 1.3, 6).astype(np.float32))
    got = _hoisted_positions((n_in, n_other, n_out, use_zoom, frame), s, zoom)
    want = shear_resample.shear_positions(
        n_in, n_other, n_out, s, zoom if use_zoom else None, frame if use_zoom else None)
    assert torch.equal(got, want.transpose(1, 2))  # bit for bit


@pytest.mark.parametrize("dtype,order,bf16", [
    (torch.float32, 1, False), (torch.float32, 1, True), (torch.bfloat16, 1, True),
    (torch.float32, 0, False), (torch.bfloat16, 0, False), (torch.uint8, 0, False),
    (torch.int32, 0, False),
])
@pytest.mark.parametrize("full,out_shape,sms", [
    ((20, 22, 24), (12, 12, 14), 132),  # shrinking windows, folded zoom
    ((15, 18, 17), None, 132),  # full frame, odd extents, ragged chunks
    ((15, 18, 17), None, 1),  # two planes a block, a ragged last pair
])
def test_emulated_traversal_equals_the_plain_group(full, out_shape, sms, dtype, order, bf16):
    x, coef, zoom, groups = _inputs(full, out_shape, 3, 2, dtype, 10)
    for i, (a_axis, b_axis, specs) in enumerate(groups):
        c = coef[:, 3 * i: 3 * i + 3].contiguous()
        want = fused_shear.shear_group_plain(x, a_axis, b_axis, c, zoom, specs, order, bf16)
        got = emulate_group(x, a_axis, b_axis, c, zoom, specs, order, bf16, sms)
        assert got.shape == want.shape and got.dtype == want.dtype
        if order == 0 or bf16:
            assert torch.equal(got, want), (i, (got.float() - want.float()).abs().max())
        else:
            err = (got - want).abs().max().item()
            assert err <= 1e-6 * want.abs().max().item(), (i, err)
        x = want.contiguous()


def test_emulated_traversal_in_2d():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 3, 18, 21)).astype(np.float32))
    passes, divz, extents, groups = shear_resample.chain_plan((18, 21), 1, (12, 13), 0.4, 0.8)
    angles = torch.tensor([[0.3], [-0.25]])
    zoom = torch.tensor([0.9, 1.2])
    coef = shear_resample.shear_coefficients(angles, zoom, passes, divz)
    a_axis, b_axis, specs = groups[0]
    want = fused_shear.shear_group_plain(x, a_axis, b_axis, coef[:, :3], zoom, specs, 0, False)
    got = emulate_group(x.unsqueeze(-1), a_axis, b_axis, coef[:, :3], zoom, specs, 0, False)
    assert torch.equal(got.squeeze(-1), want)


@pytest.mark.parametrize("dtype,order,bf16,global_plane", [
    (torch.bfloat16, 1, True, True),  # the 2D flagship's image: 297 KB a plane
    (torch.float32, 1, False, True),
    (torch.uint8, 0, False, False),  # its labels: 148 KB, in shared memory
])
def test_emulated_traversal_of_the_2d_flagship_group(dtype, order, bf16, global_plane):
    """The 384^2 margin patch to 256^2: the plan keeps a plane in global
    scratch where no block's shared memory holds it, and the traversal (the
    same in either place) equals the plain group."""
    rng = np.random.default_rng(5)
    passes, divz, _, groups = shear_resample.chain_plan((384, 384), 1, (256, 256), 0.4, 0.8)
    angles = torch.tensor([[0.35], [-0.2]])
    zoom = torch.tensor([0.85, 1.25])
    coef = shear_resample.shear_coefficients(angles, zoom, passes, divz)
    if dtype.is_floating_point:
        x = torch.from_numpy(rng.standard_normal((2, 1, 384, 384)).astype(np.float32)).to(dtype)
    else:
        x = torch.from_numpy(rng.integers(0, 8, (2, 1, 384, 384))).to(dtype)
    a_axis, b_axis, specs = groups[0]
    specs = tuple(map(tuple, specs))
    p = fused_shear.group_plan((384, 384, 1), a_axis, b_axis, specs, dtype, 2)
    assert p.global_plane is global_plane and p.block_lines
    assert p.smem_bytes <= fused_shear._SMEM_LIMIT
    want = fused_shear.shear_group_plain(x, a_axis, b_axis, coef[:, :3], zoom, specs, order,
                                         bf16)
    got = emulate_group(x.unsqueeze(-1), a_axis, b_axis, coef[:, :3], zoom, specs, order,
                        bf16).squeeze(-1)
    assert got.shape == want.shape == (2, 1, 256, 256)
    if order == 0 or bf16:
        assert torch.equal(got, want)
    else:
        assert (got - want).abs().max().item() <= 1e-6 * want.abs().max().item()
