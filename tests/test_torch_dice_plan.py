"""The launch plan of the phase-Dice sums kernel and its traversal.

``ops/phase_dice.py::sums_plan`` sizes the grid to the card; the CUDA kernel
itself runs only on the card (``tests/test_torch_kernels_cuda.py``). Here the
plan's invariants are checked by enumerating every thread's voxels as the
kernel's two loops visit them (the unrolled rounds, then the tail), and
``sums_traversal_plain`` below (a plain PyTorch walk of the same traversal: per
thread in loop order, the warp's shuffle tree, the block's warps in order, the
finalize pass over the blocks) is held against ``dice_phase_sums_plain`` and
against the Pallas kernel of ``exp/pallas_dice_ab.py`` in interpret mode: f32
1e-5 relative to each sum's largest entry (sums over ~10^4 voxels in another
order), the label counts exact. The kernels' softmax multiplies by one
reciprocal per voxel: within 2 ulp of the divided one per probability.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from segmantic_tpu_torch.ops import _cuda, phase_dice
from segmantic_tpu_torch.ops.fused_conv import at_least_f32
from tests.test_torch_phase_dice import _inputs, pallas_dice  # noqa: F401  (fixture)

T = phase_dice.THREADS

# (batch, voxels per sample, classes, SMs)
CASES = [
    (8, 48 ** 3 * 8, 8, 132),   # the flagship step on an H100
    (2, 5000, 8, 4),            # no multiple of a round (1024) or of a block's run
    (3, 7585 * 8, 5, 132),      # more blocks asked for than rounds: one round a block
    (1, 4099, 16, 3),           # 16 lanes: two voxels a round
    (1, 777, 32, 2),            # 32 lanes: one voxel a round; less than one round
    (96, 48 ** 3 * 8, 8, 132),  # more samples than a third of the grid
    (500, 1024 * 9 + 1, 3, 132),  # more samples than resident blocks: one block each
    (2, 1, 2, 132),
]


def softmax_reciprocal(logits: torch.Tensor) -> torch.Tensor:
    """The kernels' softmax over the last axis: exp(x - max) times the rounded
    reciprocal of the sum, one reciprocal per voxel instead of a division per
    class (within 2 ulp of the divided one)."""
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    return e * (1.0 / e.sum(-1, keepdim=True))


def _butterfly(v: torch.Tensor) -> torch.Tensor:
    """The xor-shuffle tree over a last axis of 32 lanes; every lane ends with
    the warp's sum, added in the tree's order."""
    lane = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = v + v[..., lane ^ o]
    return v[..., 0]


def sums_traversal_plain(xp: torch.Tensor, yp: torch.Tensor, plan):
    """``dice_phase_sums`` by the kernel's traversal, in plain PyTorch: thread
    t of block k adds voxels k * vpb + t, + T, ... in that order, a warp
    sums its lanes by the shuffle tree, a block its warps in order, and the
    finalize pass lane i the blocks i, i + 32, ... before another tree."""
    batch, nvox, n_phase, num_classes = phase_dice._geometry(xp, yp)
    probs = softmax_reciprocal(at_least_f32(xp).reshape(batch, nvox, num_classes))
    labels = yp.reshape(batch, nvox).long()
    onehot = F.one_hot(labels, num_classes).bool()
    terms = torch.stack([torch.where(onehot, probs, 0.0), probs,
                         onehot.to(probs.dtype)], 1)  # (B, 3, nvox, C)
    vpb = plan.voxels_per_block
    rounds = vpb // T
    partial = torch.zeros((batch, -(-plan.blocks // 32) * 32, 3, num_classes),
                          dtype=probs.dtype)
    for blk in range(plan.blocks):
        v0, v1 = blk * vpb, min((blk + 1) * vpb, nvox)
        run = F.pad(terms[:, :, v0:v1], (0, 0, 0, vpb - (v1 - v0)))
        run = run.reshape(batch, 3, rounds, T, num_classes)
        acc = torch.zeros_like(run[:, :, 0])
        for r in range(rounds):  # a thread's voxels, in its loop's order
            acc = acc + run[:, :, r]
        warps = _butterfly(acc.reshape(batch, 3, T // 32, 32, num_classes)
                           .transpose(-1, -2))  # (B, 3, warps, C)
        block = torch.zeros_like(warps[:, :, 0])
        for w in range(T // 32):
            block = block + warps[:, :, w]
        partial[:, blk] = block
    lanes = torch.zeros_like(partial[:, :32])
    for i in range(0, partial.shape[1], 32):  # lane i: blocks i, i + 32, ...
        lanes = lanes + partial[:, i:i + 32]
    out = _butterfly(lanes.permute(0, 2, 3, 1))  # (B, 3, C)
    return out[:, 0], out[:, 1], out[:, 2]


def _visits(plan, nvox):
    """How often each voxel of one sample is visited by the kernel's loops."""
    seen = np.zeros(nvox, np.int64)
    for blk in range(plan.blocks):
        v0 = blk * plan.voxels_per_block
        v1 = min(v0 + plan.voxels_per_block, nvox)
        for tid in range(T):
            v = v0 + tid
            while v + (plan.unroll - 1) * T < v1:  # the unrolled rounds
                for u in range(plan.unroll):
                    seen[v + u * T] += 1
                v += plan.unroll * T
            while v < v1:  # the tail, one voxel at a time
                seen[v] += 1
                v += T
    return seen


@pytest.mark.parametrize("batch,nvox,classes,sms", CASES)
def test_sums_plan_invariants(batch, nvox, classes, sms):
    plan = phase_dice.sums_plan(batch, nvox, classes, sms)
    cp = phase_dice.lanes_padded(classes)
    assert plan.unroll == (4 if cp <= 8 else 2 if cp == 16 else 1)
    assert plan.voxels_per_block % (T * plan.unroll) == 0
    # the grid matches the voxels: no empty block, none missing
    assert plan.blocks == -(-nvox // plan.voxels_per_block)
    assert (plan.blocks - 1) * plan.voxels_per_block < nvox <= plan.blocks * plan.voxels_per_block
    # one wave: at most the resident blocks of the card, unless a sample needs its own
    resident = (3 if cp <= 8 else 1) * sms
    assert plan.blocks * batch <= max(resident, batch)
    assert plan.blocks == 1 or plan.blocks * batch > resident // 2 or \
        plan.voxels_per_block == T * plan.unroll


@pytest.mark.parametrize("batch,nvox,classes,sms", [c for c in CASES if c[1] < 10 ** 5])
def test_every_voxel_is_visited_exactly_once(batch, nvox, classes, sms):
    plan = phase_dice.sums_plan(batch, nvox, classes, sms)
    assert (_visits(plan, nvox) == 1).all()


def test_flagship_plan():
    plan = phase_dice.sums_plan(8, 48 ** 3 * 8, 8, 132)
    assert plan == phase_dice.SumsPlan(unroll=4, blocks=48, voxels_per_block=18432)
    assert plan.voxels_per_block // T >= 64  # the epilogue once per >= 64 voxels a thread
    assert 48 * 8 <= 3 * 132


@pytest.mark.parametrize("shape,n_phase,classes,sms", [
    ((2, 8, 8, 8), 8, 4, 132), ((2, 8, 8, 8), 8, 8, 3), ((3, 5, 9, 11), 8, 5, 2),
    ((1, 13, 17), 4, 3, 1), ((2, 6, 7, 9), 8, 16, 4), ((1, 5, 5, 5), 1, 32, 2),
])
def test_traversal_matches_the_plain_sums(shape, n_phase, classes, sms):
    xp, yp = _inputs(0, shape, n_phase, classes)
    xp, yp = torch.from_numpy(xp), torch.from_numpy(yp)
    nvox = int(np.prod(shape[1:])) * n_phase
    plan = phase_dice.sums_plan(shape[0], nvox, classes, sms)
    got = sums_traversal_plain(xp, yp, plan)
    want = phase_dice.dice_phase_sums_plain(xp, yp)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (shape[0], classes) and g.dtype == torch.float32
        assert (g - w).abs().max() <= 1e-5 * w.abs().max()
    assert torch.equal(got[2], want[2])  # label counts are whole numbers


@pytest.mark.parametrize("classes", [4, 8, 16])
def test_traversal_matches_pallas_interpret(pallas_dice, classes):  # noqa: F811
    xp, yp = _inputs(1, classes=classes)
    want = pallas_dice.dice_phase_sums(jnp.asarray(xp), jnp.asarray(yp), interpret=True)
    plan = phase_dice.sums_plan(2, 8 ** 3 * 8, classes, 6)
    assert plan.blocks > 1
    got = sums_traversal_plain(torch.from_numpy(xp), torch.from_numpy(yp), plan)
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max()
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_traversal_takes_bf16_logits_in_f32():
    xp, yp = _inputs(2, (2, 6, 6, 6), 8, 8)
    xb = torch.from_numpy(xp).to(torch.bfloat16)
    plan = phase_dice.sums_plan(2, 6 ** 3 * 8, 8, 2)
    got = sums_traversal_plain(xb, torch.from_numpy(yp), plan)
    want = phase_dice.dice_phase_sums_plain(xb, torch.from_numpy(yp))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and (g - w).abs().max() <= 1e-5 * w.abs().max()


@pytest.mark.parametrize("classes", [2, 3, 8, 32])
@pytest.mark.parametrize("scale", [0.5, 4.0, 30.0])
def test_reciprocal_softmax_is_within_2_ulp_of_the_divided_one(classes, scale):
    rng = np.random.default_rng(3)
    x = torch.from_numpy((rng.standard_normal((4096, classes)) * scale).astype(np.float32))
    got = softmax_reciprocal(x)
    e = torch.exp(x - x.amax(-1, keepdim=True))
    want = e / e.sum(-1, keepdim=True)
    ulp = torch.from_numpy(np.spacing(want.numpy()))
    assert ((got - want).abs() <= 2 * ulp).all()
    assert (got.sum(-1) - 1).abs().max() < 1e-6


def test_butterfly_is_the_warp_sum_on_every_lane():
    v = torch.arange(64, dtype=torch.float32).reshape(2, 32)
    assert torch.equal(_butterfly(v), v.sum(-1))


def test_library_name_covers_the_flags_and_nothing_of_the_environment(monkeypatch):
    """One build per tree: the library is named after the sources and the
    fixed flags, so no environment value selects another build."""
    default = _cuda.library_path()
    monkeypatch.setenv("SEGMANTIC_NVCC_FLAGS", "-use_fast_math")
    assert _cuda.library_path() == default
    monkeypatch.setattr(_cuda, "NVCC_FLAGS", _cuda.NVCC_FLAGS + ["-lineinfo"])
    assert _cuda.library_path() != default
