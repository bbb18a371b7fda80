"""Fused stride-1 SAME 3^3 convolution with the folded-norm epilogue, and
its gradients.

Port of ``segmantic_tpu/ops/pallas_conv.py``: ``conv3d_pallas`` and the
kernel it launches (``conv3d_packed_p``), the weight gradient
``conv3d_packed_dw`` and the differentiable ``conv3d_packed``; the same
functions on plain channel-last tensors, without the TPU's batch-into-lanes
packing.

``conv3d`` launches the CUDA kernel ``csrc/fused_conv.cu`` and
``conv3d_dw`` the kernel ``csrc/fused_conv_dw.cu`` for tensors on a CUDA
device; for tensors on the CPU they run :func:`conv3d_plain` and
:func:`conv3d_dw_plain`, the plain PyTorch versions. :func:`conv3d_grad` is
the ``torch.autograd.Function`` over both: forward and input gradient on the
conv kernel (the input gradient of a SAME stride-1 conv is the same conv with
spatially flipped, in/out-swapped weights), weight gradient on the dw kernel.

The conv kernel has seven bodies, the dw kernel nine. The conv kernel's,
named by :func:`conv_body` from the input's type, layout and channel counts:
bf16 input in the dense layout with C = CO = 8 or 16, W * C a multiple of 64
and at least ``DENSE_MIN_POSITIONS[C]`` positions runs the dense Hopper body
(``csrc/conv3_dense.cuh``: TMA rows of 64 / C voxels, ``wgmma`` with N = the
row's 64 output lanes and both operands by descriptor) with the geometry of
:func:`dense_fwd_plan` and the weights of :func:`pack_weights_dense`; bf16
input in the phase layout with C = CO = 8 or 16 and at least
``PHASE_FWD_MIN_POSITIONS`` block voxels runs the phase forward's Hopper body
(``csrc/conv3_phase.cuh``: TMA bricks of block voxels, ``wgmma`` with N =
output phases x CO and both operands by descriptor) with the geometry of
:func:`phase_fwd_plan` and the weights of :func:`pack_weights_phase`; bf16
input in the dense layout with C, CO >= 64 runs the deep-channel body
(``csrc/conv3_wgmma.cuh``:
``wgmma`` with the halo and the weight tiles brought by TMA, split-K at small
volumes) with the geometry of :func:`deep_plan` and the weights of
:func:`pack_weights_deep`; other bf16 input with C % 8 == 0 (phase layout: C %
16 == 0), C + CO >= ``MID_MIN_CHANNELS`` and H, W multiples of 8 the
mid-channel body
(``csrc/conv3_mid.cuh``: ``wgmma`` with A and B by no-swizzle descriptors on
8-channel planes of the halo, the whole CO tile a block) with the geometry of
:func:`mid_plan` and the weights of :func:`pack_weights_mid`; other bf16 input
whose channel count is a multiple of 8 the tensor-core body
(``csrc/conv3_mma.cuh``: ``mma.sync`` on a halo brick staged by ``cp.async``)
with the launch geometry of :func:`plan`; bf16 input with C = 1..7 (the
one-channel input layer of SegResNet and UNETR) the few-channel body
(``csrc/conv3_fewc.cuh``: ``mma.sync`` on input planes staged along W, a
rolling window of three along D) with the geometry of :func:`fewc_plan`; both
take the weights packed by :func:`pack_weights`. f32 input runs the
register-tiled f32 body (``csrc/conv3_f32.cuh``: an implicit GEMM on FFMA, the
K units staged by ``cp.async`` into a ring, split-K at small volumes) with the
geometry of :func:`f32_plan`, whose f32 FMAs agree with the CPU to ~1e-6 where
TF32 would not; bf16 input with any other channel count takes it too. Either
way the wrapper launches its kernel or raises.

The dw kernel's, named by :func:`dw_body`: bf16 input in the dense layout with
C = CO = 32, W even and at least ``DENSE_PAIRS_MIN_POSITIONS`` positions runs
the dense pairs body (``csrc/conv3_dense_pairs_dw.cuh``: K = (position, voxel
of the row), windows of x from voxel v - 1 against dy's lanes from voxel v -
1, ``wgmma`` m64n64 with both operands MN-major by descriptor) with the
geometry of :func:`dense_pairs_plan`; bf16 input in the dense layout with
C = CO = 8 or 16, W * C a multiple of 64 and at least
``DENSE_DW_MIN_POSITIONS[C]`` positions runs the dense Hopper dw body
(``csrc/conv3_dense_dw.cuh``: windows of x against the halves of dy's rows,
``wgmma`` with both operands MN-major by descriptor) with the geometry of
:func:`dense_dw_plan`; bf16 input in the dense layout with C >= 64 and CO >=
128 runs the deep-channel body (``csrc/conv3_dw_wgmma.cuh``:
``wgmma`` on a TMA-staged halo of x and brick of dy) with the geometry of
:func:`deep_dw_plan`; bf16 input in the dense layout with C and CO multiples of
64 below that (CO = 64) and at least ``MID_DW_MIN_POSITIONS`` positions the
mid-channel body (``csrc/conv3_mid_dw.cuh``: ``wgmma`` with both operands
MN-major by descriptor on a TMA-staged halo of x and brick of dy) with the
geometry of :func:`mid_dw_plan`; bf16 input in the phase layout with C in
(16, 32, 64), CO = 8 or a multiple of 16 and at least
``PHASE_DW_MIN_POSITIONS`` block voxels the phase dw's Hopper body
(``csrc/conv3_phase_dw.cuh``: TMA bricks of p and of g with its halo, K =
(block voxel, a'z, a'y), ``wgmma`` with g's fragments by ``ldmatrix`` and p's
(a'x, ci) runs by descriptor) with the geometry of :func:`phase_dw_plan`;
bf16 input in the phase layout with C = CO = 8 and at least
``PHASE_PIECES_MIN_POSITIONS`` block voxels the phase pieces body
(``csrc/conv3_phase_pieces_dw.cuh``: the y and x pieces of g in the rows of
a tile, p's (a'y, a'x, ci) lanes of a'z by descriptor) with the geometry of
:func:`phase_pieces_plan`;
other bf16 input with C % 8 == 0 and CO % 8 == 0 the tensor-core body (``csrc/conv3_dw_mma.cuh``: ``mma.sync`` on
``ldmatrix.trans`` operands, one staged halo brick of x and brick of dy per
step) with the launch geometry of :func:`dw_plan`; bf16 input with C = 1..7 and
any CO the few-channel body (``csrc/conv3_fewc_dw.cuh``) with the geometry of
:func:`fewc_dw_plan`; f32 input and every other channel count the
register-tiled f32 body (``csrc/conv3_f32_dw.cuh``: 8 x 8 tiles of (tap, ci) x
co on FFMA, position splits with one partial a block) with the geometry of
:func:`f32_dw_plan`.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import _cuda

__all__ = [
    "conv3d", "conv3d_plain", "conv3d_dw", "conv3d_dw_plain", "conv3d_grad",
    "counter", "dw_counter", "RELU_MODES", "ConvPlan", "plan", "pack_weights",
    "unpack_weights", "conv_body", "DwPlan", "dw_plan", "dw_body", "FewcPlan",
    "fewc_plan", "fewc_dw_plan", "deep_counter", "deep_dw_counter", "DeepPlan", "deep_plan",
    "DeepDwPlan", "deep_dw_plan", "pack_weights_deep", "unpack_weights_deep", "f32_counter",
    "f32_dw_counter", "F32Plan", "f32_plan", "F32DwPlan", "f32_dw_plan", "mid_counter",
    "mid_dw_counter", "MidPlan", "mid_plan", "MidDwPlan", "mid_dw_plan", "pack_weights_mid",
    "mid_eligible", "mid_dw_eligible",
    "unpack_weights_mid", "phase_dw_counter", "PhaseDwPlan", "phase_dw_plan", "phase_dw_eligible",
    "phase_fwd_counter", "PhaseFwdPlan", "phase_fwd_plan", "phase_fwd_eligible",
    "pack_weights_phase", "dense_counter", "dense_dw_counter", "DenseFwdPlan",
    "dense_fwd_plan", "DenseDwPlan", "dense_dw_plan", "dense_eligible", "pack_weights_dense",
    "dense_pairs_counter", "DensePairsPlan", "dense_pairs_plan", "dense_pairs_eligible",
    "phase_pieces_counter", "PhasePiecesPlan", "phase_pieces_plan", "phase_pieces_eligible",
]

RELU_MODES = {"none": 0, "relu": 1, "prelu": 2}
counter = _cuda.LaunchCounter("fused_conv")
dw_counter = _cuda.LaunchCounter("fused_conv_dw")
# the deep-channel bodies' own launches, also counted by the two above
deep_counter = _cuda.LaunchCounter("fused_conv_wgmma")
deep_dw_counter = _cuda.LaunchCounter("fused_conv_dw_wgmma")
# the register-tiled f32 bodies' launches (kernels 1-6), also counted by the
# kernels' own counters
f32_counter = _cuda.LaunchCounter("conv3_f32")
f32_dw_counter = _cuda.LaunchCounter("conv3_f32_dw")
# the mid-channel bodies' launches (kernels 1-6), also counted by the kernels'
# own counters
mid_counter = _cuda.LaunchCounter("conv3_mid")
mid_dw_counter = _cuda.LaunchCounter("conv3_mid_dw")
# the phase dw's Hopper body's launches (kernels 5-6), also counted by
# phase_conv.dw_counter
phase_dw_counter = _cuda.LaunchCounter("conv3_phase_dw")
# the phase forward's Hopper body's launches (kernels 3-4), also counted by
# phase_conv.counter
phase_fwd_counter = _cuda.LaunchCounter("conv3_phase")
# the dense Hopper bodies' launches (kernels 1 and 2), also counted by
# counter and dw_counter
dense_counter = _cuda.LaunchCounter("conv3_dense")
dense_dw_counter = _cuda.LaunchCounter("conv3_dense_dw")
# the dense pairs dw body's launches (kernel 2 at C = CO = 32), also counted
# by dw_counter
dense_pairs_counter = _cuda.LaunchCounter("conv3_dense_pairs_dw")
# the phase pieces dw body's launches (kernel 5 at Ci = Co = 8), also counted
# by phase_conv.dw_counter
phase_pieces_counter = _cuda.LaunchCounter("conv3_phase_pieces_dw")


def at_least_f32(t: torch.Tensor) -> torch.Tensor:
    """t in f32, or in its own dtype where that is wider (float64 on the CPU:
    the plain versions serve as an f64 reference)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def check_dtype(t: torch.Tensor, name: str) -> None:
    """Kernels take f32 or bf16; the plain versions also take f64 on the CPU."""
    if t.dtype in (torch.float32, torch.bfloat16):
        return
    if t.dtype == torch.float64 and t.device.type == "cpu":
        return
    raise TypeError(f"{name} must be float32 or bfloat16 (float64 on the CPU), "
                    f"got {t.dtype}")


@functools.lru_cache(maxsize=None)
def _unit_vectors(co: int, device):
    """(ones, zeros) of co f32 values on device, made once: never written to."""
    f32 = dict(dtype=torch.float32, device=device)
    return torch.ones(co, **f32), torch.zeros(co, **f32)


def _epilogue_vectors(co: int, bias, scale, shift, device):
    """(conv + bias) * scale + shift == conv * scale + (bias * scale + shift)."""
    f32 = dict(dtype=torch.float32, device=device)
    ones, zeros = _unit_vectors(co, device)
    s = ones if scale is None else scale.to(**f32).reshape(co)
    t = zeros if shift is None else shift.to(**f32).reshape(co)
    if bias is not None:
        t = bias.to(**f32).reshape(co) * s + t
    return s.contiguous(), t.contiguous()


def activation(y: torch.Tensor, relu_mode: str, alpha) -> torch.Tensor:
    if relu_mode == "prelu":
        return torch.where(y >= 0, y, alpha.to(y.dtype).reshape(()) * y)
    if relu_mode == "relu":
        return torch.clamp_min(y, 0)
    return y


def conv3d_plain(x, weights, bias=None, scale=None, shift=None, alpha=None,
                 relu_mode: str = "none", out_dtype=None) -> torch.Tensor:
    """Plain PyTorch version: ``F.conv3d`` in x's dtype, then the same
    epilogue as the kernel in f32 (f64 for f64 input).

    x (B, D, H, W, C); weights (3, 3, 3, C, CO) DHWIO; returns (B, D, H, W, CO)
    in ``out_dtype`` (default: x's dtype)."""
    out_dtype = out_dtype or x.dtype
    co = weights.shape[-1]
    y = at_least_f32(F.conv3d(
        x.permute(0, 4, 1, 2, 3), weights.permute(4, 3, 0, 1, 2), padding=1,
    ).permute(0, 2, 3, 4, 1))
    s, t = _epilogue_vectors(co, bias, scale, shift, x.device)
    y = y * s + t
    return activation(y, relu_mode, alpha).to(out_dtype)


def check_args(x, weights, relu_mode, alpha, out_dtype, weight_shape):
    if relu_mode not in RELU_MODES:
        raise ValueError(f"relu_mode must be one of {sorted(RELU_MODES)}")
    if relu_mode == "prelu" and alpha is None:
        raise ValueError("relu_mode='prelu' needs alpha")
    check_dtype(x, "x")
    if weights.dtype != x.dtype:
        raise TypeError(f"weights dtype {weights.dtype} != x dtype {x.dtype}")
    if out_dtype not in (x.dtype, torch.float32):
        raise TypeError(f"out_dtype must be {x.dtype} or float32")
    if tuple(weights.shape) != tuple(weight_shape):
        raise ValueError(f"weights shape {tuple(weights.shape)} != {weight_shape}")


SMEM_LIMIT = 232448  # bytes of shared memory one block may use on an H100
_SMS = 132  # streaming multiprocessors of an H100


# The deep-channel bodies' least channel counts, set from the rows timed on an
# H100 beside the tensor-core bodies (PERF.md): the conv body is faster at
# every row with C, CO >= 64; the dw body at every row from CO = 128, while at
# CO = 64 its 64-wide N tile was 13% slower at 12^3 and within 7% at 24^3.
DEEP_MIN_C = 64
DEEP_MIN_CO = 64
DEEP_DW_MIN_CO = 128
# The mid-channel conv body's least C + CO, set from the same rows: it was
# faster than the tensor-core body at every phase-space row of packed UNETR
# with a 32-channel side and at 24^3 x 32, slower at the 96^3 x 16 phase row,
# 96^3 x 8 and 48^3 x 16, where C + CO <= 32 makes the wgmma's N 8 or 16 and
# its shared-memory operand traffic, not the tensor cores, the bound. It
# takes a grid whose H and W are multiples of 8 (a slab's 8 x 8 rows all
# real): at 12^3 x 32, 56% of its rows real, it tied or lost.
MID_MIN_CHANNELS = 48
# The mid-channel dw body's least positions (B * D * H * W): at 8 x 24^3 it
# was 1.6x faster than the tensor-core body and ahead of cuDNN, at 8 x 12^3
# 16-23% slower (a block's pipeline fill and the split partials outweigh its
# products there).
MID_DW_MIN_POSITIONS = 32768
# The phase dw's Hopper body's least Ci and block voxels (B * D * H * W of
# p), set from the rows timed on an H100 beside the tensor-core body
# (PERF.md): it was faster at packed UNETR's four phase rows (Ci = 16,
# 32, 64: 1.1-1.8x) and the flagship's L = 128 (Ci = 16, 1.3x), slower at L
# = 64 (Ci = Co = 8, where the m64 tile is half padding rows); below the
# volume a launch of a handful of bricks is its pipeline fill and second pass.
PHASE_DW_MIN_C = 16
PHASE_DW_MIN_POSITIONS = 32768
# The phase forward's Hopper body's least block voxels (B * D * H * W of p),
# for Ci = Co = 8 or 16 (phase_fwd_eligible), set from the rows timed on an
# H100 beside the tensor-core body (PERF.md): it was faster at every
# row timed, the flagship's and packed UNETR's 1.5-1.7x, and down to the
# smallest, L = 64 on a 16^3 block grid x 1 (4096 block voxels: 64 bricks),
# 1.06-1.10x; smaller volumes were not timed.
PHASE_FWD_MIN_POSITIONS = 4096
# The dense Hopper bodies' least positions (B * D * H * W) by channel count,
# set from the rows timed on an H100 beside the tensor-core bodies (PERF.md).
# The conv body was faster at every row from 24^3 x 16 at batch 2 (27648
# positions; 1.5x) and 48^3 x 8 at batch 1 (110592; 1.2x) up to the models'
# rows (1.3-1.7x); at 16^3 x 16 its input gradient tied, at 24^3 x 8 it was
# 13-18% slower (a few bricks a block: its weights' bulk copy and ring fill).
# The dw body was faster from 48^3 x 16 at batch 1 (1.2x; the models' rows
# 1.5-1.7x) and from 48^3 x 8 at batch 4 (442368; 1.2x; SegResNet's 96^3 x 8
# at batch 8 1.3x), slower at 24^3 x 16 at batch 2 and 48^3 x 8 at batch 1
# (9-13%: its per-block sums and the reduce over 132 partials).
DENSE_MIN_POSITIONS = {8: 110592, 16: 27648}
DENSE_DW_MIN_POSITIONS = {8: 442368, 16: 110592}
# The dense pairs dw body's least positions (C = CO = 32), set from the rows
# timed on an H100 beside the tensor-core body (PERF.md): faster at 24^3 x 32
# at batch 8 (1.25x) and 48^3 x 32 at batch 8 (1.9x), a hair faster at 24^3
# at batch 4 (55296 positions; 1.02-1.03x in two runs), slower at 24^3 at
# batch 2 and 32^3 at batch 1 (its partial a block, 110 KB, and their
# reduce cost ~13 us whatever the volume).
DENSE_PAIRS_MIN_POSITIONS = 55296
# The phase pieces dw body's least block voxels (Ci = Co = 8): faster than the
# tensor-core body at every L = 64 row timed from 48^3 x 8 at batch 1 (13824
# block voxels; 1.15x) to the flagship's batch 8 (1.57x), slower at 32^3 at
# batch 1 (4096; 0.89x).
PHASE_PIECES_MIN_POSITIONS = 13824


def _dense(x: torch.Tensor, c: int, co: int, phase: bool, least: dict) -> bool:
    return (x.dtype == torch.bfloat16 and not phase and x.ndim == 5
            and dense_eligible(c, co, x.shape[3])
            and x.numel() // max(x.shape[-1], 1) >= least[c])


def _deep(x: torch.Tensor, c: int, co: int, phase: bool, min_co: int) -> bool:
    return (x.dtype == torch.bfloat16 and not phase and c % 8 == 0 and co % 8 == 0
            and c >= DEEP_MIN_C and co >= min_co)


def conv_body(x: torch.Tensor, c: int, co: int, phase: bool = False) -> str:
    """The body of the conv kernel that takes input x of a conv from c to co
    channels (``weights.shape[-2:]``; a phase-major tensor, ``phase=True``,
    carries 8 * c lanes): ``"deep_channels"`` for bf16 input in the dense
    layout with c, co >= 64 and both multiples of 8 (``csrc/conv3_wgmma.cuh``;
    the input gradient, the conv co -> c, takes the same rule),
    ``"mid_channels"`` (``csrc/conv3_mid.cuh``) for other bf16 input with c %
    8 == 0 (phase: c % 16 == 0), c + co >= ``MID_MIN_CHANNELS`` and x's H and
    W (block voxels in phase space) multiples of 8, ``"phase_lanes"``
    (``csrc/conv3_phase.cuh``) for bf16 phase-major input with c = co = 8 or
    16 (:func:`phase_fwd_eligible`) and at least ``PHASE_FWD_MIN_POSITIONS``
    block voxels, ``"dense_rows"`` (``csrc/conv3_dense.cuh``) for bf16 input
    in the dense layout with c = co = 8 or 16, W * c a multiple of 64
    (:func:`dense_eligible`) and at least ``DENSE_MIN_POSITIONS[c]`` positions,
    ``"tensor_cores"`` for any other bf16 input whose channel vector is a
    whole number of 16-byte pieces (c % 8 == 0), ``"few_channels"`` for bf16
    input with c = 1..7, ``"f32_tiles"`` (``csrc/conv3_f32.cuh``: register-tiled
    f32 FFMA) for f32 input and every other bf16 channel count."""
    if _deep(x, c, co, phase, DEEP_MIN_CO):
        return "deep_channels"
    if _dense(x, c, co, phase, DENSE_MIN_POSITIONS):
        return "dense_rows"
    if x.dtype == torch.bfloat16:
        if (phase and phase_fwd_eligible(c, co)
                and x.numel() // max(x.shape[-1], 1) >= PHASE_FWD_MIN_POSITIONS):
            return "phase_lanes"
        if c % 8 == 0:
            # the grid's rows (H, W: block voxels in phase space) whole slabs of 8 x 8
            whole = x.ndim == 5 and x.shape[2] % 8 == 0 and x.shape[3] % 8 == 0
            mid = whole and mid_eligible(c, co, phase) and c + co >= MID_MIN_CHANNELS
            return "mid_channels" if mid else "tensor_cores"
        if c < 8:
            return "few_channels"
    return "f32_tiles"


@dataclasses.dataclass(frozen=True)
class ConvPlan:
    """Launch geometry of the tensor-core conv body, as the C entry point
    takes it. One block of ``warps`` warps multiplies ``32 * warps`` M rows,
    of which the ``td * th * tw`` positions of its brick are real, by ``nt``
    output channels, in ``nchunks`` channel chunks of ``ck``."""

    td: int
    th: int
    tw: int
    warps: int
    nt: int  # output channels per block
    ck: int  # input channels per staged chunk
    nchunks: int
    n_tiles: int  # blocks along the output channels (grid.y)
    stages: int  # ring buffers of staged input (and weight) chunks
    resident: bool  # the block's whole weight slab stays in shared memory
    grid_x: int  # persistent blocks walking the bricks
    smem_bytes: int
    nbricks: int
    fill: float  # real output positions / M rows multiplied


def _pitch(n: int) -> int:
    """Shared-memory bytes between rows of n bf16 values (``mma_pitch``)."""
    return 16 if n == 8 else 2 * n + 16


def _chunking(c: int) -> Tuple[int, int, int]:
    """(ck, nchunks, K rows per chunk). C = 8 pairs two taps into one k16
    step: 28 taps of 8 rows, the last all zero. C = 1..7 (the few-channel
    body): one chunk of the 27 * C (tap, channel) rows, padded with zero rows
    to whole k16 steps (C = 1: 32)."""
    if c < 8:
        return c, 1, -(-27 * c // 16) * 16
    if c == 8:
        return 8, 1, 224
    ck = 16 if c == 16 else 32
    return ck, -(-c // ck), 27 * ck


def _smem_bytes(ck, krows, nt, brick, warps, nchunks, stages, resident, out_bytes) -> int:
    td, th, tw = brick
    a_bytes = (td + 2) * (th + 2) * (tw + 2) * _pitch(ck)
    w_bytes = krows * _pitch(nt)
    o_bytes = warps * 32 * (nt * out_bytes + 16)
    tables = 128 + -(-((td + 2) * (th + 2) * (tw + 2) + warps * 32) * 4 // 16) * 16
    return (tables + stages * (a_bytes + (0 if resident else w_bytes))
            + (nchunks * w_bytes if resident else 0) + o_bytes)


_BRICKS = [b for b in itertools.product((1, 2, 3, 4, 6, 8), (2, 3, 4, 6, 8), (4, 6, 8, 12, 16))
           if 32 < b[0] * b[1] * b[2] <= 256]


def _candidates(dims, c: int, co: int, out_bytes: int, sms: int):
    """Every (cost key, ConvPlan) :func:`plan` chooses among."""
    b, d, h, w = dims
    ck, nchunks, krows = _chunking(c)
    for nt in (8, 16, 32):
        if nt > 8 and nt >= 2 * co:
            continue  # a tile more than half padding columns
        n_tiles = -(-co // nt)
        if n_tiles > 65535:
            continue
        for brick in _BRICKS:
            td, th, tw = brick
            rows = td * th * tw
            warps = -(-rows // 32)
            nbricks = b * -(-d // td) * -(-h // th) * -(-w // tw)
            if nbricks >= 2 ** 31:
                continue
            fill = b * d * h * w / (nbricks * warps * 32)
            # resident weights pay where a block needs the whole slab at once
            # (one chunk) or walks several bricks with it
            keep = (True, False) if nchunks == 1 or nbricks * n_tiles > 2 * sms else (False,)
            # one chunk: the ring only runs ahead across bricks, where more blocks
            # on a multiprocessor did more than a third stage (H100, measured)
            depth = (2,) if nchunks == 1 else (3, 2)
            choice = None
            for resident, stages in itertools.product(keep, depth):
                smem = _smem_bytes(ck, krows, nt, brick, warps, nchunks, stages, resident,
                                   out_bytes)
                if smem <= SMEM_LIMIT:
                    choice = (resident, stages, smem)
                    break
            if choice is None:
                continue
            resident, stages, smem = choice
            per_sm = min(SMEM_LIMIT // smem, 2048 // (warps * 32))
            halo = (td + 2) * (th + 2) * (tw + 2)
            staged = halo * ck * nchunks + (0 if resident else krows * nt * nchunks)
            # a block's cycles on one multiprocessor, roughly (fitted to an H100):
            # the k16 steps are bound by ldmatrix traffic, 1024 bytes of input
            # rows and 32 * nt of weights per warp and step at 128 bytes a
            # cycle (rows that wrap inside a group of 8 collide on banks); the
            # staging moves ~8 values a cycle; few warps hide no latency
            steps = warps * (krows // 16) * nchunks * (8 + nt / 4) * (1.0 if tw % 8 == 0 else 1.1)
            cycles = (steps + staged / 8) * max(1.0, 4 / (warps * per_sm))
            blocks = nbricks * n_tiles
            rounds = blocks / sms if blocks >= 4 * sms else -(-blocks // sms)
            yield (fill < 0.75, rounds * cycles, -fill), ConvPlan(
                td=td, th=th, tw=tw, warps=warps, nt=nt, ck=ck, nchunks=nchunks,
                n_tiles=n_tiles, stages=stages, resident=resident,
                grid_x=min(nbricks, -(-sms * per_sm // n_tiles)), smem_bytes=smem,
                nbricks=nbricks, fill=fill)


@functools.lru_cache(maxsize=None)
def plan(dims: Tuple[int, int, int, int], c: int, co: int, out_bytes: int = 2,
         sms: int = _SMS) -> ConvPlan:
    """The brick, N tile and ring of one launch of the tensor-core body for a
    (B, D, H, W) grid of output positions (full resolution for the phase
    layout), C input and CO output channels, ``out_bytes`` per output value.

    Among the bricks of a fixed list and N tiles of 8, 16 or 32 it takes the
    cheapest by a rough count of a block's cycles (the shared-memory traffic
    of its k16 steps on all its M rows, padding included, plus the values it
    stages) times the rounds the blocks need on ``sms`` multiprocessors, among
    those whose M rows are at least 75% real output positions where any is. The weights stay
    resident where a block needs the whole slab at once (one chunk) or walks
    several bricks with it, if they fit; the ring has 3 stages where there
    are several chunks and they fit, else 2."""
    if c % 8:
        raise ValueError(f"the tensor-core conv body needs C % 8 == 0, got C = {c}")
    found = min(_candidates(dims, c, co, out_bytes, sms), key=lambda kp: kp[0], default=None)
    if found is None:
        raise ValueError(f"no launch plan for dims {dims}, C = {c}, CO = {co}")
    return found[1]


def pack_weights(weights: torch.Tensor, nt: int) -> torch.Tensor:
    """DHWIO weights (3, 3, 3, C, CO) in the order the tensor-core body (C %
    8 == 0) or the few-channel body (C = 1..7) reads: (N tiles, chunks, K
    rows, nt) with K row ``tap * ck + ci`` inside a chunk of ck input
    channels, CO padded with zero columns to a multiple of nt and C with zero
    rows to a multiple of ck; for C = 8 one chunk of 28 taps x 8 rows whose
    last tap is zero (K = 216 padded to a multiple of 16 here, not in the
    input); for C = 1..7 one chunk of the 27 * C rows and zero rows up to a
    multiple of 16."""
    c, co = weights.shape[-2:]
    ck, nchunks, krows = _chunking(c)
    n_tiles = -(-co // nt)
    w = weights.reshape(27, c, co)
    pad_c, pad_co = nchunks * ck - c, n_tiles * nt - co
    if pad_c or pad_co:
        w = F.pad(w, (0, pad_co, 0, pad_c))
    # (tap, chunk, ci, tile, n) -> (tile, chunk, tap, ci, n)
    w = w.reshape(27, nchunks, ck, n_tiles, nt).permute(3, 1, 0, 2, 4)
    w = w.reshape(n_tiles, nchunks, 27 * ck, nt)
    if krows != 27 * ck:
        w = F.pad(w, (0, 0, 0, krows - 27 * ck))
    return w.contiguous()


def unpack_weights(packed: torch.Tensor, c: int, co: int) -> torch.Tensor:
    """Inverse of :func:`pack_weights`: the DHWIO weights (3, 3, 3, c, co)."""
    n_tiles, nchunks, _, nt = packed.shape
    ck = _chunking(c)[0]
    w = packed[:, :, :27 * ck].reshape(n_tiles, nchunks, 27, ck, nt)
    w = w.permute(2, 1, 3, 0, 4).reshape(27, nchunks * ck, n_tiles * nt)
    return w[:, :c, :co].reshape(3, 3, 3, c, co).contiguous()


@dataclasses.dataclass(frozen=True)
class FewcPlan:
    """Launch geometry of the few-channel conv body (``csrc/conv3_fewc.cuh``)
    or weight-gradient body (``csrc/conv3_fewc_dw.cuh``), as the C entry
    points take it. A step multiplies the ``rows`` (256 or 512) output
    positions of one plane tile of ``th x tw`` full-resolution positions (the
    phase layout: a plane of block voxels, two full-resolution planes, of
    th / 2 x tw / 2 block voxels x 8 phases); an item is ``seg`` consecutive
    planes of one tile column of one sample, and ``grid_x`` persistent blocks
    (per N tile) walk the items ``blockIdx.x, blockIdx.x + grid_x, ...``. The
    weight gradient keeps one partial a block (``grid_x`` splits)."""

    th: int
    tw: int
    rows: int  # output positions of a plane step
    seg: int  # planes an item walks
    nt: int  # output channels per N tile
    n_tiles: int  # grid.y
    grid_x: int  # persistent blocks, the weight gradient's splits
    smem_bytes: int
    nitems: int
    blocks_per_sm: int
    fill: float  # real output positions / positions multiplied
    workspace: int  # weight gradient: f32 values of the partials (0: one split, or the conv)


_FEWC_MAX_ROWS = 512  # output positions of a plane step (csrc/conv3_fewc.cuh FEWC_MAX_ROWS)
_FEWC_SLOTS = 6  # staged input planes (FEWC_SLOTS), two more as mirrors
_FEWC_DY_SLOTS = 4
_FEWC_SEGS = (2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 256)


def _round_to(n: int, mod: int, rem: int) -> int:
    """n rounded up to the next value that leaves rem modulo mod (``fewc_round``)."""
    return n + (rem - n) % mod


def fewc_pitches(phase: bool, c: int, th: int, tw: int) -> Tuple[int, int]:
    """(row, plane) pitch in elements of a staged input plane
    (``fewc_row_pitch``, ``fewc_plane_pitch``): a dense row holds tw voxels
    and the voxel before and after inside two extra 16-byte pieces, a phase
    row tw / 2 + 2 block voxels of 8 * c values."""
    rp = _round_to((tw // 2 + 2) * 8 * c if phase else tw * c + 16, 32, 16)
    rows = th // 2 + 2 if phase else th + 2
    return rp, _round_to(rows * rp, 64, 32)


def fewc_smem_bytes(phase: bool, c: int, nt: int, th: int, tw: int) -> int:
    """``fewc_smem_bytes`` of ``csrc/conv3_fewc.cuh``: row tables, resident
    weights, the ring of input planes with its two mirrors."""
    sp = fewc_pitches(phase, c, th, tw)[1]
    return 3 * _FEWC_MAX_ROWS * 4 + _chunking(c)[2] * _pitch(nt) + (_FEWC_SLOTS + 2) * sp * 2


def fewc_dw_smem_bytes(phase: bool, c: int, nt: int, th: int, tw: int) -> int:
    """``fewc_dw_smem_bytes`` of ``csrc/conv3_fewc.cuh``: row tables, the ring
    of input planes, the ring of dy planes (which then holds the warps' sum)."""
    sp = fewc_pitches(phase, c, th, tw)[1]
    rows = 2 * th * tw if phase else th * tw
    return (3 * _FEWC_MAX_ROWS * 4 + (_FEWC_SLOTS + 2) * sp * 2
            + _FEWC_DY_SLOTS * rows * nt * 2)  # dy rows unpadded, swizzled


def _fewc_tiles(phase: bool):
    """Plane tiles (th, tw, rows) of 256 or 512 output positions: dense, tw a
    multiple of 16 (a k16 step or m16 tile is 16 voxels of one row); phase,
    th / 2 x tw / 2 block voxels x 8 phases with th even and tw / 2 even (two
    neighbouring block voxels of one row)."""
    if phase:
        return [(rows // 2 // tw, tw, rows) for rows in (256, 512) for tw in (4, 8, 16, 32, 64)
                if rows // 2 // tw % 2 == 0]
    return [(rows // tw, tw, rows) for rows in (256, 512) for tw in (16, 32, 64, 128, 256)]


def _fewc_plan(dims, c: int, co: int, phase: bool, per_sm: int, sms: int, smem_fn,
               workspace: bool) -> FewcPlan:
    b, d, h, w = dims
    if not 1 <= c <= 7 or co < 1:
        raise ValueError(f"the few-channel bodies take C = 1..7 and CO >= 1, got C = {c}, "
                         f"CO = {co}")
    if phase and (d % 2 or h % 2 or w % 2):
        raise ValueError(f"a phase-major tensor stands for even extents, got {dims}")
    nt = 8 if co <= 8 else 16
    n_tiles = -(-co // nt)
    planes = d // 2 if phase else d
    best = None
    for th, tw, rows in _fewc_tiles(phase):
        nty, ntx = -(-h // th), -(-w // tw)
        fill = h * w / (nty * th * ntx * tw)
        smem = smem_fn(phase, c, nt, th, tw)
        blocks = min(per_sm, _SM_SMEM // (smem + 1024))
        if blocks < 1 or smem > SMEM_LIMIT:
            continue
        for seg in sorted({s for s in _FEWC_SEGS if s < planes} | {planes}):
            nitems = b * nty * ntx * -(-planes // seg)
            if nitems >= 2 ** 31:
                continue
            grid_x = min(nitems, blocks * sms)
            # the busiest block's plane steps, in units of 256 positions plus half
            # a unit a step for its barrier and wait (H100, measured), and half a
            # unit an item for its two extra planes and the turn to a new column
            cost = -(-nitems // grid_x) * (min(seg, planes) * (rows / 256 + 0.5) + 0.5)
            key = (cost, -fill, -tw)
            if best is None or key < best[0]:
                best = key, FewcPlan(
                    th=th, tw=tw, rows=rows, seg=seg, nt=nt, n_tiles=n_tiles, grid_x=grid_x,
                    smem_bytes=smem, nitems=nitems, blocks_per_sm=blocks, fill=fill,
                    workspace=grid_x * 27 * c * co if workspace and grid_x > 1 else 0)
    if best is None:
        raise ValueError(f"no few-channel launch plan for dims {dims}, C = {c}, CO = {co}")
    return best[1]


@functools.lru_cache(maxsize=None)
def fewc_plan(dims: Tuple[int, int, int, int], c: int, co: int, phase: bool = False,
              sms: int = _SMS) -> FewcPlan:
    """The plane tile, step, segment length and grid of one launch of the
    few-channel conv body for a (B, D, H, W) grid of output positions (full
    resolution for the phase layout, ``phase=True``), C = 1..7 input and CO
    output channels: the N tile (8 for CO <= 8, else 16) and, among the tiles
    of 256 or 512 positions and a few segment lengths, the least work on the
    busiest block at three blocks a multiprocessor for C <= 2 and two above
    (``fewc_conv_blocks``), then the best fill, then the widest tile. The
    output type does not enter: the body stores from its registers."""
    return _fewc_plan(dims, c, co, phase, 3 if c <= 2 else 2, sms, fewc_smem_bytes,
                      workspace=False)


@functools.lru_cache(maxsize=None)
def fewc_dw_plan(dims: Tuple[int, int, int, int], c: int, co: int, phase: bool = False,
                 sms: int = _SMS) -> FewcPlan:
    """The same choice for the few-channel weight-gradient body, at two
    blocks a multiprocessor for C <= 2 and one above (``fewc_dw_blocks``: the
    accumulators of 27 * C rows take the registers); every block is one split
    with its partial in the workspace."""
    return _fewc_plan(dims, c, co, phase, 2 if c <= 2 else 1, sms, fewc_dw_smem_bytes,
                      workspace=True)


# -- the deep-channel bodies (csrc/conv3_wgmma.cuh, csrc/conv3_dw_wgmma.cuh) --

_WG_CHUNK = 64  # input channels of a K block: one 128-byte swizzled row
_DEEP_BRICKS = [b for b in itertools.product((1, 2, 3, 4, 6, 8), (2, 3, 4, 6, 8, 12),
                                             (4, 6, 8, 12, 16, 24))
                if 32 < b[0] * b[1] * b[2] <= 256]
# a block's tensor-core and L2 rates in its cost count, cycles of one H100
# multiprocessor: 4096 bf16 operations a cycle dense, of which the wgmma
# chains reach ~85%, the bytes the L2 feeds it a cycle when every
# multiprocessor loads, and each commit group's exposed latency (fitted to
# the bodies' times on an H100)
_MMA_EFF = 0.85
_L2_BYTES = 28
_GROUP_CYCLES = 250
_WGMMA_CYCLES = 16  # a wgmma's issue beyond its N / 2 cycles of work


def _round1024(n: int) -> int:
    return -(-n // 1024) * 1024


def deep_halo_bytes(td: int, th: int, tw: int) -> int:
    """``wgmma_halo_bytes``: 64 channels (128 bytes) of each halo position of
    a brick, rounded to the 128-byte swizzle's period of 1024 bytes."""
    return _round1024((td + 2) * (th + 2) * (tw + 2) * 128)


def deep_smem_bytes(nt: int, td: int, th: int, tw: int, stages: int) -> int:
    """``wgmma_smem_bytes`` of ``csrc/conv3_wgmma.cuh``: 1024 bytes to align
    the base, 1024 of barriers, two halo buffers, ``stages`` weight tiles of
    nt rows x 128 bytes."""
    return 2048 + 2 * deep_halo_bytes(td, th, tw) + stages * nt * 128


@dataclasses.dataclass(frozen=True)
class DeepPlan:
    """Launch geometry of the deep-channel conv body, as the C entry point
    takes it. A block of ``nwg`` consumer warpgroups (``spw`` slabs of 64 M
    rows each) multiplies the ``td * th * tw`` positions of one brick by ``nt``
    output channels over the K blocks ``[split * nkb // splits, (split + 1) *
    nkb // splits)`` of its split; grid (nbricks, n_tiles, splits)."""

    td: int
    th: int
    tw: int
    spw: int  # m64 slabs a consumer warpgroup multiplies
    nwg: int  # consumer warpgroups a block (2 or 3), besides the producer's
    nt: int  # output channels per block (the wgmma's N)
    n_tiles: int
    nkb: int  # K blocks: chunks of 64 input channels x 27 taps
    splits: int  # K splits, f32 partials summed by a second kernel
    stages: int  # ring of weight tiles
    nbricks: int
    smem_bytes: int
    workspace: int  # f32 values of the partials: splits * positions * CO, 0 with one split
    fill: float  # real output positions / M rows multiplied
    blocks: int


def _deep_candidates(dims, c: int, co: int, out_bytes: int, sms: int):
    """Every (cost key, DeepPlan) :func:`deep_plan` chooses among."""
    b, d, h, w = dims
    positions = b * d * h * w
    nkb = -(-c // _WG_CHUNK) * 27
    for nt in (64, 128):
        if nt > 64 and nt >= 2 * co:
            continue  # a tile more than half padding columns
        n_tiles = -(-co // nt)
        for spw, nwg in ((1, 2), (2, 2), (1, 3)):
            if nt * spw > 128:  # the spill-free instances: 64 accumulators a thread at most
                continue
            rows_max = 64 * nwg * spw
            for td, th, tw in _DEEP_BRICKS:
                rows = td * th * tw
                if not rows_max // 2 < rows <= rows_max:
                    continue
                nbricks = b * -(-d // td) * -(-h // th) * -(-w // tw)
                if nbricks >= 2 ** 31:
                    continue
                fill = positions / (nbricks * rows_max)
                stages = next((st for st in (6, 5, 4, 3, 2)
                               if deep_smem_bytes(nt, td, th, tw, st) <= SMEM_LIMIT), None)
                if stages is None:
                    continue
                smem = deep_smem_bytes(nt, td, th, tw, stages)
                halo = (td + 2) * (th + 2) * (tw + 2) * 128
                # a K block of a block, in cycles: its 4 x 2 x spw wgmma of nt / 2
                # cycles each, or the weight tile and its share of the halo from
                # the L2, plus the exposed wait of its commit group
                mma = 4 * spw * (nt / 2 + _WGMMA_CYCLES) * nwg / _MMA_EFF
                l2 = (nt * 128 + halo / 27) / _L2_BYTES
                per_kb = max(mma, l2) + _GROUP_CYCLES
                for splits in sorted({1, 2, 3, 4, 6, 8, 9, 12, 16, 18, 27} | {nkb}):
                    if splits > nkb:
                        continue
                    blocks = nbricks * n_tiles * splits
                    cycles = -(-blocks // sms) * (-(-nkb // splits) * per_kb + 2500)
                    if splits > 1:  # the partials out and back, and the second launch
                        cycles += (2 * splits * 4 + out_bytes) * positions * co / (sms * 32) + 4000
                    yield (fill < 0.7, cycles, -fill, splits), DeepPlan(
                        td=td, th=th, tw=tw, spw=spw, nwg=nwg, nt=nt, n_tiles=n_tiles, nkb=nkb,
                        splits=splits, stages=stages, nbricks=nbricks, smem_bytes=smem,
                        workspace=splits * positions * co if splits > 1 else 0, fill=fill,
                        blocks=blocks)


@functools.lru_cache(maxsize=None)
def deep_plan(dims: Tuple[int, int, int, int], c: int, co: int, out_bytes: int = 2,
              sms: int = _SMS) -> DeepPlan:
    """The brick, N tile, slabs, ring and K splits of one launch of the
    deep-channel conv body for a (B, D, H, W) grid of output positions, C
    input and CO output channels, ``out_bytes`` per output value.

    Among N tiles of 64 or 128, two consumer warpgroups of one or two slabs
    of 64 rows or three of one (at most 64 accumulators a thread: the
    spill-free instances), the bricks of a fixed list that fill more than
    half the block's rows, and a few split counts, it takes the
    cheapest by a rough count of cycles on the busiest of ``sms``
    multiprocessors (each K block's wgmma or its bytes from the L2, a block's
    start and end, and for more than one split the partials and the second
    launch), among those whose M rows are at least 70% real output positions
    where any is. The ring takes as many weight tiles (2-6) as fit."""
    if c % 8 or co % 8 or c < 8 or co < 8:
        raise ValueError(f"the deep-channel conv body needs C % 8 == 0 and CO % 8 == 0, got "
                         f"C = {c}, CO = {co}")
    found = min(_deep_candidates(dims, c, co, out_bytes, sms), key=lambda kp: kp[0],
                default=None)
    if found is None:
        raise ValueError(f"no deep-channel launch plan for dims {dims}, C = {c}, CO = {co}")
    return found[1]


def _swizzle128(w: torch.Tensor) -> torch.Tensor:
    """Rows of 64 bf16 values (..., n, 64) in the 128-byte swizzle: the
    16-byte piece j of row n lies at piece j ^ (n % 8). Its own inverse."""
    n = w.shape[-2]
    rows, cols = torch.arange(n, device=w.device), torch.arange(8, device=w.device)
    idx = cols.unsqueeze(0) ^ (rows % 8).unsqueeze(1)  # (n, 8), made on w's device
    pieces = w.reshape(*w.shape[:-1], 8, 8)
    idx = idx.reshape(n, 8, 1).expand(*pieces.shape)
    return torch.gather(pieces, -2, idx).reshape(w.shape)


@functools.lru_cache(maxsize=None)
def _deep_pack_index(c: int, co: int, nt: int, device: torch.device) -> torch.Tensor:
    """Where each value of :func:`pack_weights_deep`'s result comes from in
    the flattened DHWIO weights, 27 * c * co (the element past their end)
    for padding: the packing as one gather. Made on ``device``, once a
    shape."""
    nch, n_tiles = -(-c // _WG_CHUNK), -(-co // nt)
    src = torch.arange(27 * c * co, device=device).reshape(27, c, co)
    src = F.pad(src, (0, n_tiles * nt - co, 0, nch * _WG_CHUNK - c), value=27 * c * co)
    # (tap, chunk, k, tile, n) -> (tile, chunk, tap, n, k)
    src = src.reshape(27, nch, _WG_CHUNK, n_tiles, nt).permute(3, 1, 0, 4, 2)
    return _swizzle128(src.reshape(n_tiles, nch * 27, nt, _WG_CHUNK)).contiguous()


def pack_weights_deep(weights: torch.Tensor, nt: int) -> torch.Tensor:
    """DHWIO weights (3, 3, 3, C, CO) in the order the deep-channel conv body
    reads: (N tiles, K blocks, nt, 64), K block ``chunk * 27 + tap`` of 64
    input channels, each (tap, chunk) tile nt rows (output channels) of 64 k
    values, K-major and 128-byte swizzled as a wgmma descriptor reads it; C
    padded with zero rows to a multiple of 64, CO with zero columns to a
    multiple of nt. One gather by a cached index (the weights change every
    step and are packed at every call)."""
    c, co = weights.shape[-2:]
    index = _deep_pack_index(c, co, nt, weights.device)
    return F.pad(weights.reshape(-1), (0, 1))[index]


def unpack_weights_deep(packed: torch.Tensor, c: int, co: int) -> torch.Tensor:
    """Inverse of :func:`pack_weights_deep`: the DHWIO weights (3, 3, 3, c, co)."""
    n_tiles, nkb, nt, _ = packed.shape
    nch = nkb // 27
    w = _swizzle128(packed).reshape(n_tiles, nch, 27, nt, _WG_CHUNK).permute(2, 1, 4, 0, 3)
    w = w.reshape(27, nch * _WG_CHUNK, n_tiles * nt)
    return w[:, :c, :co].reshape(3, 3, 3, c, co).contiguous()


def _aligned(t: torch.Tensor) -> bool:
    return t.data_ptr() % 16 == 0


def launch_conv3(entry: str, x, weights, bias, scale, shift, alpha, relu_mode,
                 out, full_dims, packed_cache: Optional[dict] = None) -> None:
    """Shared launch of the two conv3 kernels (dense and phase layouts,
    ``entry`` ``segk_fused_conv3`` or ``segk_phase_conv3``) on the body
    :func:`conv_body` names: ``entry + "_f32"`` (f32, :func:`f32_plan`; counted
    by ``f32_counter`` too), ``entry + "_mid"`` (mid channels,
    :func:`mid_plan`; counted by ``mid_counter`` too), ``entry + "_mma"``
    (tensor cores, :func:`plan`), ``entry + "_fewc"`` (few channels,
    :func:`fewc_plan`), ``entry + "_wgmma"`` (deep channels, dense only,
    :func:`deep_plan`; counted by ``deep_counter`` too), ``entry +
    "_lanes"`` (the phase forward's Hopper body, phase only,
    :func:`phase_fwd_plan`; counted by ``phase_fwd_counter`` too) or ``entry +
    "_rows"`` (the dense Hopper body, dense only, :func:`dense_fwd_plan`;
    counted by ``dense_counter`` too). ``packed_cache``
    keeps the packed weights between calls with constant weights (serving),
    keyed by the N tile (and the body)."""
    for t, name in ((x, "x"), (weights, "weights"), (out, "out")):
        _cuda.check_cuda(t, name)
    b, d, h, w = full_dims
    c, co = weights.shape[-2:]
    s, t = _epilogue_vectors(co, bias, scale, shift, x.device)
    a = None
    if relu_mode == "prelu":
        a = alpha.to(device=x.device, dtype=torch.float32).reshape(1).contiguous()
    head = (x.data_ptr(), s.data_ptr(), t.data_ptr(),
            None if a is None else a.data_ptr(), RELU_MODES[relu_mode], out.data_ptr(),
            b, d, h, w, c, co)
    phase = entry == "segk_phase_conv3"
    body = conv_body(x, c, co, phase)
    if d * h * w * max(c, co) >= 2 ** 31:  # the kernel's offsets inside a sample are 32-bit
        raise ValueError(f"one sample of {d}x{h}x{w} positions x {max(c, co)} channels "
                         "exceeds 2^31 values")
    if body == "f32_tiles":
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        p = f32_plan((b, d, h, w), c, co, sms)
        ws = torch.empty(p.workspace, dtype=torch.float32, device=x.device) if p.splits > 1 \
            else out
        _cuda.launch(entry + "_f32", head[0], weights.data_ptr(), *head[1:6], ws.data_ptr(),
                     *head[6:], int(x.dtype == torch.bfloat16),
                     int(out.dtype == torch.bfloat16), p.td, p.th, p.tw, p.nt, p.ck, p.splits,
                     p.stages, p.smem_bytes)
        f32_counter.count += 1
        return
    out_bf16 = int(out.dtype == torch.bfloat16)
    if body == "deep_channels":
        if not _aligned(x):
            raise ValueError("the deep-channel body reads x by TMA: x must be 16-byte aligned")
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        p = deep_plan((b, d, h, w), c, co, out.element_size(), sms)
        key = ("deep", p.nt)
        packed = None if packed_cache is None else packed_cache.get(key)
        if packed is None:
            packed = pack_weights_deep(weights, p.nt)
            if packed_cache is not None:
                packed_cache[key] = packed
        ws = torch.empty(p.workspace, dtype=torch.float32, device=x.device) if p.splits > 1 \
            else out
        _cuda.launch(entry + "_wgmma", head[0], packed.data_ptr(), *head[1:6], ws.data_ptr(),
                     *head[6:], out_bf16, p.td, p.th, p.tw, p.nt, p.spw, p.nwg, p.splits,
                     p.stages, p.smem_bytes)
        deep_counter.count += 1
        return
    if body == "dense_rows":
        if not _aligned(x):
            raise ValueError("the dense Hopper body reads x by TMA: x must be 16-byte aligned")
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        p = dense_fwd_plan((b, d, h, w), c, co, sms)
        packed = None if packed_cache is None else packed_cache.get("dense_rows")
        if packed is None:
            packed = pack_weights_dense(weights)
            if packed_cache is not None:
                packed_cache["dense_rows"] = packed
        _cuda.launch(entry + "_rows", head[0], packed.data_ptr(), *head[1:], out_bf16,
                     p.grid_x, p.stages, p.smem_bytes)
        dense_counter.count += 1
        return
    if body == "phase_lanes":
        if not _aligned(x):
            raise ValueError("the phase forward's Hopper body reads p by TMA: p must be "
                             "16-byte aligned")
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        p = phase_fwd_plan((b, d, h, w), c, co, sms)
        packed = None if packed_cache is None else packed_cache.get("phase_lanes")
        if packed is None:
            packed = pack_weights_phase(weights)
            if packed_cache is not None:
                packed_cache["phase_lanes"] = packed
        _cuda.launch(entry + "_lanes", head[0], packed.data_ptr(), *head[1:], out_bf16,
                     p.grid_x, p.stages, p.smem_bytes)
        phase_fwd_counter.count += 1
        return
    if body == "mid_channels":
        if not _aligned(x):
            raise ValueError("the mid-channel body reads x by TMA: x must be 16-byte aligned")
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        p = mid_plan((b, d, h, w), c, co, phase, sms)
        key = ("mid", p.nt, p.ck)
        packed = None if packed_cache is None else packed_cache.get(key)
        if packed is None:
            packed = pack_weights_mid(weights, p.nt, p.ck)
            if packed_cache is not None:
                packed_cache[key] = packed
        _cuda.launch(entry + "_mid", head[0], packed.data_ptr(), *head[1:], out_bf16, p.td,
                     p.th, p.tw, p.ck, p.nt, p.spw, p.nwg, p.grid_x, p.stages, p.smem_bytes)
        mid_counter.count += 1
        return
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    p = (fewc_plan((b, d, h, w), c, co, phase, sms)
         if body == "few_channels" else plan((b, d, h, w), c, co, out.element_size(), sms))
    packed = None if packed_cache is None else packed_cache.get(p.nt)
    if packed is None:
        packed = pack_weights(weights, p.nt)
        if packed_cache is not None:
            packed_cache[p.nt] = packed
    if body == "few_channels":
        vec = int(_aligned(x) and (phase or (w * c) % 8 == 0))  # whole 16-byte pieces a row
        _cuda.launch(entry + "_fewc", head[0], packed.data_ptr(), *head[1:], out_bf16, p.th,
                     p.tw, p.seg, p.nt, p.grid_x, p.smem_bytes, vec)
        return
    _cuda.launch(entry + "_mma", head[0], packed.data_ptr(), *head[1:], out_bf16, p.td, p.th,
                 p.tw, p.warps, p.nt, p.ck, p.stages, int(p.resident), p.grid_x, p.smem_bytes)


def conv3d(
    x: torch.Tensor,  # (B, D, H, W, C) channel-last
    weights: torch.Tensor,  # (3, 3, 3, C, CO) DHWIO
    bias: Optional[torch.Tensor] = None,  # (CO,)
    scale: Optional[torch.Tensor] = None,  # (CO,) folded-norm scale
    shift: Optional[torch.Tensor] = None,  # (CO,) folded-norm shift
    alpha: Optional[torch.Tensor] = None,  # (1,) PReLU slope
    relu_mode: str = "none",  # none | relu | prelu
    out_dtype: Optional[torch.dtype] = None,
    packed_cache: Optional[dict] = None,  # see launch_conv3; constant weights only
) -> torch.Tensor:
    """Fused stride-1 SAME 3^3 conv: y = (conv(x) + bias) * scale + shift,
    then the activation. f32 accumulation; bf16 or f32 in, out in
    ``out_dtype`` (x's dtype or f32). On a CUDA device bf16 input with
    C, CO >= 64 runs the deep-channel body (one launch, or two with split-K),
    bf16 with C = CO = 8 or 16 the dense Hopper body at the rule's volumes,
    other bf16 with C % 8 == 0 the mid-channel body where C + CO >= 48, else
    the tensor-core body, bf16 with C = 1..7 the few-channel body, anything
    else the register-tiled f32 body (:func:`conv_body`)."""
    out_dtype = out_dtype or x.dtype
    if x.ndim != 5:
        raise ValueError(f"x must be (B, D, H, W, C), got {tuple(x.shape)}")
    c = x.shape[-1]
    co = weights.shape[-1]
    check_args(x, weights, relu_mode, alpha, out_dtype, (3, 3, 3, c, co))
    if x.device.type == "cpu":
        return conv3d_plain(x, weights, bias, scale, shift, alpha, relu_mode, out_dtype)
    b, d, h, w, _ = x.shape
    out = torch.empty((b, d, h, w, co), dtype=out_dtype, device=x.device)
    launch_conv3("segk_fused_conv3", x, weights, bias, scale, shift, alpha,
                 relu_mode, out, (b, d, h, w), packed_cache)
    counter.count += 1
    return out


def conv3d_dw_plain(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the weight gradient, in f32 (f64 for f64
    input): ``torch.nn.grad.conv3d_weight`` on the upcasts of x
    (B, D, H, W, C) and dy (B, D, H, W, CO); returns (3, 3, 3, C, CO) DHWIO."""
    c, co = x.shape[-1], dy.shape[-1]
    dw = torch.nn.grad.conv3d_weight(
        at_least_f32(x.permute(0, 4, 1, 2, 3)), (co, c, 3, 3, 3),
        at_least_f32(dy.permute(0, 4, 1, 2, 3)), padding=1,
    )
    return dw.permute(2, 3, 4, 1, 0).contiguous()


def check_dw_args(x, dy) -> None:
    check_dtype(x, "x")
    if dy.dtype != x.dtype:
        raise TypeError(f"dy dtype {dy.dtype} != x dtype {x.dtype}")
    if x.shape[:4] != dy.shape[:4]:
        raise ValueError(f"x and dy cover different grids: {tuple(x.shape)} vs "
                         f"{tuple(dy.shape)}")


def dw_body(x: torch.Tensor, c: int, co: int, phase: bool = False) -> str:
    """The body of the dw kernel that takes input x of a conv from c to co
    true channels: ``"deep_channels"`` for bf16 input in the dense layout with
    c >= 64, co >= 128 and both multiples of 8 (``csrc/conv3_dw_wgmma.cuh``),
    ``"mid_channels"`` (``csrc/conv3_mid_dw.cuh``) for bf16 input in the
    dense layout with c and co multiples of 64 below that and at least
    ``MID_DW_MIN_POSITIONS`` positions (x's numel over its channels),
    ``"phase_blocks"`` (``csrc/conv3_phase_dw.cuh``) for bf16 phase-major
    input whose channel counts :func:`phase_dw_eligible` takes, with c >=
    ``PHASE_DW_MIN_C`` and at least ``PHASE_DW_MIN_POSITIONS`` block voxels,
    ``"dense_rows"`` (``csrc/conv3_dense_dw.cuh``) for bf16 input in the
    dense layout with c = co = 8 or 16, W * c a multiple of 64 and at least
    ``DENSE_DW_MIN_POSITIONS[c]`` positions, ``"dense_pairs"``
    (``csrc/conv3_dense_pairs_dw.cuh``) for bf16 input in the dense layout
    with c = co = 32, W even (:func:`dense_pairs_eligible`) and at least
    ``DENSE_PAIRS_MIN_POSITIONS`` positions, ``"phase_pieces"``
    (``csrc/conv3_phase_pieces_dw.cuh``) for bf16 phase-major input with c =
    co = 8 and at least ``PHASE_PIECES_MIN_POSITIONS`` block voxels,
    ``"tensor_cores"`` for any other bf16 input whose
    two channel vectors are whole numbers of 16-byte pieces (c % 8 == 0 and
    co % 8 == 0), ``"few_channels"`` for bf16 input with c = 1..7 and any co,
    ``"f32_tiles"`` (``csrc/conv3_f32_dw.cuh``: register-tiled f32 FFMA) for
    f32 input and every other bf16 channel count."""
    if x.dtype == torch.bfloat16 and c > 0 and co > 0:
        if _deep(x, c, co, phase, DEEP_DW_MIN_CO):
            return "deep_channels"
        if _dense(x, c, co, phase, DENSE_DW_MIN_POSITIONS):
            return "dense_rows"
        positions = x.numel() // max(x.shape[-1], 1)  # (the phase layout: block voxels)
        if (not phase and x.ndim == 5 and dense_pairs_eligible(c, co, x.shape[3])
                and positions >= DENSE_PAIRS_MIN_POSITIONS):
            return "dense_pairs"
        if phase and phase_pieces_eligible(c, co) and positions >= PHASE_PIECES_MIN_POSITIONS:
            return "phase_pieces"
        if c % 8 == 0 and co % 8 == 0:
            if (phase and phase_dw_eligible(c, co) and c >= PHASE_DW_MIN_C
                    and positions >= PHASE_DW_MIN_POSITIONS):
                return "phase_blocks"
            mid = mid_dw_eligible(c, co, phase) and positions >= MID_DW_MIN_POSITIONS
            return "mid_channels" if mid else "tensor_cores"
        if c < 8:
            return "few_channels"
    return "f32_tiles"


@dataclasses.dataclass(frozen=True)
class DwPlan:
    """Launch geometry of the tensor-core dw body, as the C entry point takes
    it. A block of ``warps`` warps owns all 27 taps of ``ck`` input channels x
    ``nt`` output channels and walks the bricks ``split, split + splits, ...``
    of ``td * th * tw`` output positions, 16 positions to a k16 step."""

    td: int
    th: int
    tw: int
    ck: int  # input channels per block
    nt: int  # output channels per block
    n_ci: int  # chunks along C
    n_co: int  # tiles along CO
    warps: int
    taps_per_warp: int  # 3 taps; at ck = 8 two pairs of taps (one m16 each)
    splits: int  # position splits, one partial each
    stages: int  # ring buffers of staged bricks
    grid: Tuple[int, int]  # (splits, n_ci * n_co)
    smem_bytes: int
    workspace: int  # f32 values: splits * 27 * C * CO, 0 with one split
    nbricks: int
    fill: float  # real positions / K rows multiplied


def _dw_smem_bytes(ck: int, nt: int, brick, stages: int) -> int:
    """``dw_mma_smem_bytes`` of ``csrc/conv3_dw_mma.cuh``."""
    td, th, tw = brick
    halo = (td + 2) * (th + 2) * (tw + 2)
    rows16 = -(-td * th * tw // 16) * 16
    tables = 128 + -(-(halo + 2 * rows16) * 4 // 16) * 16
    return tables + stages * (halo * _pitch(ck) + rows16 * _pitch(nt))


_DW_BRICKS = [b for b in itertools.product((1, 2, 3, 4, 6, 8), (2, 3, 4, 6, 8, 12),
                                           (6, 8, 12, 16, 24))
              if 48 <= b[0] * b[1] * b[2] <= 768]
_SM_SMEM = 233472  # shared memory of one multiprocessor; a block reserves 1 KB more
_SM_REGS = 65536


def _dw_candidates(dims, c: int, co: int, sms: int):
    """Every (cost key, DwPlan) :func:`dw_plan` chooses among."""
    b, d, h, w = dims
    positions = b * d * h * w
    n_out = 27 * c * co
    for ck in ((8,) if c == 8 else tuple(k for k in (16, 32) if k < 2 * c)):
        warps, tpw, mt = (7, 2, 1) if ck == 8 else (9, 3, ck // 16)
        n_ci = -(-c // ck)
        for nt in (8, 16, 32):
            if nt > 8 and nt >= 2 * co:
                continue  # a tile more than half padding columns
            n_co = -(-co // nt)
            tiles = n_ci * n_co
            if tiles > 65535:
                continue
            nf = nt // 8
            regs = -(-(48 + tpw * mt * nf * 4) // 8) * 8  # accumulators + the rest (ptxas: 40-168)
            for brick in _DW_BRICKS:
                td, th, tw = brick
                nbricks = b * -(-d // td) * -(-h // th) * -(-w // tw)
                if nbricks >= 2 ** 31:
                    continue
                halo = (td + 2) * (th + 2) * (tw + 2)
                rows16 = -(-td * th * tw // 16) * 16
                fill = positions / (nbricks * rows16)
                stages = 2  # a third cost a resident block and time (H100, measured)
                smem = _dw_smem_bytes(ck, nt, brick, stages)
                if smem > SMEM_LIMIT:
                    continue
                per_sm = min(_SM_SMEM // (smem + 1024), 2048 // (warps * 32),
                             _SM_REGS // (warps * 32 * regs))
                if per_sm < 1:
                    continue
                slots = sms * per_sm
                # a k16 step of a block, in cycles of one multiprocessor: bound by
                # ldmatrix traffic (32 * nt bytes of dy rows and 512 bytes per m16 of
                # x rows, per warp, at 128 bytes a cycle; rows that wrap inside a group
                # of 8 collide on banks) or by the mma themselves
                step = max(warps * (32 * nt + tpw * mt * 512) / 128 * (1.0 if tw % 8 == 0 else 1.1),
                           warps * tpw * mt * nf * 1.2)
                staged = 0.3 * (halo * ck // 8 + rows16 * nt // 8)  # 16-byte pieces
                for splits in sorted({1, 2, 4, 8, slots // tiles // 2, slots // tiles,
                                      2 * slots // tiles}):
                    splits = max(1, min(splits, nbricks))
                    blocks = tiles * splits
                    on_sm = -(-blocks // sms)  # blocks of the busiest multiprocessor
                    hidden = 1 + 4 / (warps * min(per_sm, on_sm))  # few warps hide little
                    cycles = on_sm * (-(-nbricks // splits) * ((rows16 // 16) * step + staged)
                                      * hidden + 27 * ck * nt / 16)
                    cycles += 1500 * -(-on_sm // per_sm)  # a block's first loads, exposed
                    if splits > 1:  # the second launch: its gap, its chain of loads, its bytes
                        cycles += 4000 + 150 * -(-splits // (8 if splits >= 16 else 1)) \
                            + splits * n_out * 4 / 1500
                    yield (fill < 0.75, cycles, -fill), DwPlan(
                        td=td, th=th, tw=tw, ck=ck, nt=nt, n_ci=n_ci, n_co=n_co, warps=warps,
                        taps_per_warp=tpw, splits=splits, stages=stages, grid=(splits, tiles),
                        smem_bytes=smem, workspace=splits * n_out if splits > 1 else 0,
                        nbricks=nbricks, fill=fill)


@functools.lru_cache(maxsize=None)
def dw_plan(dims: Tuple[int, int, int, int], c: int, co: int, sms: int = _SMS) -> DwPlan:
    """The brick, channel chunk, N tile and position splits of one launch of
    the tensor-core dw body for a (B, D, H, W) grid of output positions (full
    resolution for the phase layout), C input and CO output channels.

    Among the bricks of a fixed list, chunks of 16 or 32 input channels (8 at
    C = 8), N tiles of 8, 16 or 32 and a few split counts it takes the cheapest
    by a rough count of cycles on the busiest of ``sms`` multiprocessors (the
    shared-memory traffic or the mma of its blocks' k16 steps, padding rows
    included, the pieces they stage, and for more than one split the second
    launch that sums the partials), among those whose K rows are at least 75%
    real positions where any is."""
    if c % 8 or co % 8 or c < 8 or co < 8:
        raise ValueError("the tensor-core dw body needs C % 8 == 0 and CO % 8 == 0, "
                         f"got C = {c}, CO = {co}")
    found = min(_dw_candidates(dims, c, co, sms), key=lambda kp: kp[0], default=None)
    if found is None:
        raise ValueError(f"no dw launch plan for dims {dims}, C = {c}, CO = {co}")
    return found[1]


def deep_dw_rows16(td: int, th: int, tw: int) -> int:
    """``dw_wgmma_rows16``: a brick's positions rounded up to whole k16 steps."""
    return -(-td * th * tw // 16) * 16


def deep_dw_smem_bytes(nt: int, td: int, th: int, tw: int, stages: int) -> int:
    """``dw_wgmma_smem_bytes`` of ``csrc/conv3_dw_wgmma.cuh``: 1024 bytes to
    align the base, 1024 of barriers and the K rows' table, ``stages`` slots of
    one x halo and nt / 64 blocks of rows16 dy rows of 128 bytes."""
    slot = deep_halo_bytes(td, th, tw) + nt // 64 * deep_dw_rows16(td, th, tw) * 128
    return 2048 + stages * slot


_DEEP_DW_MAX_ROWS = 128  # DW_WG_MAX_ROWS: eight k16 steps of A fragments in registers


@dataclasses.dataclass(frozen=True)
class DeepDwPlan:
    """Launch geometry of the deep-channel dw body, as the C entry point
    takes it. A block of ``nwg`` consumer warpgroups owns ``nwg * tpw`` taps
    (tap group ``tg``: taps ``tg * nwg * tpw ...``, none past 26), a chunk of 64
    input channels and ``nt`` output channels, and walks the bricks
    ``split, split + splits, ...`` of ``td * th * tw`` positions; grid
    (splits, n_tg * n_ci * n_co), the tap group fastest."""

    td: int
    th: int
    tw: int
    nt: int
    tpw: int  # taps a consumer warpgroup accumulates
    nwg: int  # consumer warpgroups a block (2 or 3), besides the producer's
    n_tg: int
    n_ci: int
    n_co: int
    splits: int
    stages: int
    grid: Tuple[int, int]
    smem_bytes: int
    workspace: int  # f32 values: splits * 27 * C * CO, 0 with one split
    nbricks: int
    fill: float  # real positions / K rows multiplied


def _deep_dw_candidates(dims, c: int, co: int, sms: int):
    """Every (cost key, DeepDwPlan) :func:`deep_dw_plan` chooses among."""
    b, d, h, w = dims
    positions = b * d * h * w
    n_ci = -(-c // _WG_CHUNK)
    for nt in (64, 128):
        if nt > 64 and nt >= 2 * co:
            continue
        n_co = -(-co // nt)
        for tpw, nwg in ((1, 2), (2, 2), (1, 3)):
            if nt * tpw > 128:  # the spill-free instances
                continue
            n_tg = -(-27 // (nwg * tpw))
            tiles = n_tg * n_ci * n_co
            if tiles > 65535:
                continue
            for td, th, tw in _DEEP_BRICKS:
                rows = td * th * tw
                if rows > _DEEP_DW_MAX_ROWS:
                    continue
                rows16 = deep_dw_rows16(td, th, tw)
                nbricks = b * -(-d // td) * -(-h // th) * -(-w // tw)
                if nbricks >= 2 ** 31:
                    continue
                fill = positions / (nbricks * rows16)
                stages = next((st for st in (4, 3, 2)
                               if deep_dw_smem_bytes(nt, td, th, tw, st) <= SMEM_LIMIT), None)
                if stages is None:
                    continue
                smem = deep_dw_smem_bytes(nt, td, th, tw, stages)
                # a brick of a block, in cycles: its halo and dy bytes from the L2,
                # or its taps' commit groups, each loaded, multiplied and drained
                # (~400 cycles exposed), a warpgroup's one after another and the
                # warpgroups' overlapping little on the shared tensor cores (1.1
                # each, fitted on an H100)
                group = (rows16 // 16) * (nt / 2 + _WGMMA_CYCLES) / _MMA_EFF + 400
                l2 = ((td + 2) * (th + 2) * (tw + 2) + nt // 64 * rows) * 128 / _L2_BYTES
                per_brick = max(l2, 1.1 * nwg * tpw * group)
                for splits in sorted({1, 2, 3, 4, 6, 8, 12, 16, 24, 32} | {nbricks}):
                    if splits > nbricks:
                        continue
                    blocks = tiles * splits
                    cycles = -(-blocks // sms) * (-(-nbricks // splits) * per_brick + 2500)
                    if splits > 1:
                        cycles += 2 * splits * 27 * c * co * 4 / (sms * 32) + 4000
                    yield (fill < 0.7, cycles, -fill, splits), DeepDwPlan(
                        td=td, th=th, tw=tw, nt=nt, tpw=tpw, nwg=nwg, n_tg=n_tg, n_ci=n_ci,
                        n_co=n_co,
                        splits=splits, stages=stages, grid=(splits, tiles), smem_bytes=smem,
                        workspace=splits * 27 * c * co if splits > 1 else 0, nbricks=nbricks,
                        fill=fill)


@functools.lru_cache(maxsize=None)
def deep_dw_plan(dims: Tuple[int, int, int, int], c: int, co: int, sms: int = _SMS) -> DeepDwPlan:
    """The brick, N tile, taps a warpgroup, ring and position splits of one
    launch of the deep-channel dw body for a (B, D, H, W) grid of positions,
    C input and CO output channels: among N tiles of 64 or 128 and one or two
    taps a warpgroup (at most 64 accumulators a thread), the bricks of a fixed list of at most 128 positions and
    a few split counts, the cheapest by a rough count of cycles on the
    busiest of ``sms`` multiprocessors (each brick's wgmma or its bytes from
    the L2, a block's start and end, and for more than one split the
    partials and the second launch), among those whose K rows are at least
    70% real positions where any is. The ring takes as many slots (2-4) as
    fit."""
    if c % 8 or co % 8 or c < 8 or co < 8:
        raise ValueError("the deep-channel dw body needs C % 8 == 0 and CO % 8 == 0, "
                         f"got C = {c}, CO = {co}")
    found = min(_deep_dw_candidates(dims, c, co, sms), key=lambda kp: kp[0], default=None)
    if found is None:
        raise ValueError(f"no deep-channel dw launch plan for dims {dims}, C = {c}, CO = {co}")
    return found[1]


# -- the mid-channel bodies (csrc/conv3_mid.cuh, csrc/conv3_mid_dw.cuh) --

_MID_NT = (8, 16, 32, 64)  # the instances' N tiles
# the forward's (slabs a warpgroup, consumer warpgroups) instances: at most
# 64 accumulators a thread
_MID_SLABS = ((2, 2), (4, 2), (2, 4))  # dense: 4 or 8 slabs; phase: (4, 2), NT = 64 (2, 4)
# a multiprocessor's shared-memory bytes a cycle, which feed the wgmma (A 2 KB
# and B NT * 32 bytes a k16 step), and the L2's bytes a cycle to one
# multiprocessor when all of them stage (as _L2_BYTES)
_SMEM_BYTES = 128
_MID_STEP_CYCLES = 300  # a ring slot's wait, commit and release, exposed


def _mid_nt(co: int) -> int:
    return next((nt for nt in _MID_NT if co <= nt), _MID_NT[-1])


def _round128(n: int) -> int:
    return -(-n // 128) * 128


def mid_halo_points(phase: bool, td: int, th: int, tw: int) -> int:
    """``mid_halo_points``: points of one staged plane, the dense halo or one
    input phase's share ((td + 1)(th + 1)(tw + 1) block voxels)."""
    return (td + 1) * (th + 1) * (tw + 1) if phase else (td + 2) * (th + 2) * (tw + 2)


def mid_pitch(n: int) -> int:
    """``mid_pitch``: bytes of a staged plane of n points, 16 past a multiple
    of 128 (the pieces of one point, staged by neighbouring threads, fall on
    different banks)."""
    return _round128(n * 16) + 16


def mid_plane_bytes(phase: bool, td: int, th: int, tw: int) -> int:
    return mid_pitch(mid_halo_points(phase, td, th, tw))


def mid_ksteps(ck: int) -> int:
    """k16 steps of a chunk: C = 8 pairs the taps (14), else 27 of ck = 16."""
    return 14 if ck == 8 else 27


def mid_smem_bytes(phase: bool, ck: int, nchunks: int, nt: int, td: int, th: int, tw: int,
                   stages: int) -> int:
    """``mid_smem_bytes`` of ``csrc/conv3_mid.cuh``: 128 bytes to align, 1024
    of barriers and the tap table, the resident weights of one N tile,
    ``stages`` slots of 8-channel planes (8 input phases of them in the
    phase layout)."""
    stage = (8 if phase else 1) * (ck // 8) * mid_plane_bytes(phase, td, th, tw)
    return 1152 + nchunks * mid_ksteps(ck) * nt * 32 + stages * stage


@dataclasses.dataclass(frozen=True)
class MidPlan:
    """Launch geometry of the mid-channel conv body, as the C entry point
    takes it. ``grid_x`` persistent blocks (one a multiprocessor: the launch
    bound leaves ptxas every register) of ``nwg`` consumer warpgroups
    walk bricks of ``td x th x tw`` grid points (dense positions; phase block
    voxels, eight output phases each), th and tw multiples of 8; a brick's M
    rows are ``nwg * spw`` slabs of 8 x 8 (y, x) rows, each slab a warpgroup's
    m64. Per (brick, chunk of ``ck`` input channels) the halo is staged into a
    ring of ``stages``; the ``nt``-wide N tile's weights stay resident."""

    td: int
    th: int
    tw: int
    ck: int
    nchunks: int
    nt: int
    n_tiles: int
    spw: int
    nwg: int
    stages: int
    grid_x: int
    nbricks: int
    smem_bytes: int
    fill: float  # real output positions / M rows multiplied


def _mid_bricks(phase: bool):
    """(td, th, tw) bricks and their slab counts: dense 4 or 8 slabs; phase
    one plane of 8 x 8 block voxels (8 slabs: the output phases)."""
    if phase:
        return [(1, 8, 8)]
    return [b for b in itertools.product((1, 2, 4, 8), (8, 16, 32), (8, 16, 32))
            if b[0] * (b[1] // 8) * (b[2] // 8) in (4, 8)]


def mid_eligible(c: int, co: int, phase: bool) -> bool:
    """Channel counts the mid-channel conv body can take: C a multiple of 8
    (phase: of 16, the channel chunks may not run into the next phase's
    lanes), and an N tile whose resident weights leave room for two slots
    of the smallest brick."""
    if c < 8 or c % (16 if phase else 8) or co < 1:
        return False
    ck = 8 if c == 8 else 16
    td, th, tw = min(_mid_bricks(phase), key=lambda b: mid_halo_points(phase, *b))
    return mid_smem_bytes(phase, ck, -(-c // ck), _mid_nt(co), td, th, tw, 2) <= SMEM_LIMIT


def _mid_candidates(dims, c: int, co: int, phase: bool, sms: int):
    b, d, h, w = dims
    g = (d // 2, h // 2, w // 2) if phase else (d, h, w)
    nph = 8 if phase else 1
    nt = _mid_nt(co)
    n_tiles = -(-co // nt)
    for ck in ((8,) if c == 8 else (16,)):
        nchunks = -(-c // ck)
        for td, th, tw in _mid_bricks(phase):
            slabs = nph * td * (th // 8) * (tw // 8)
            nbricks = b * -(-g[0] // td) * -(-g[1] // th) * -(-g[2] // tw)
            if nbricks >= 2 ** 31:
                continue
            fill = b * g[0] * g[1] * g[2] / (nbricks * td * th * tw)
            for spw, nwg in _MID_SLABS:
                if spw * nwg != slabs or spw * nt > 128 or (nwg == 4) != (nt == 64 and slabs == 8):
                    continue
                stages = next((st for st in (4, 3, 2) if mid_smem_bytes(
                    phase, ck, nchunks, nt, td, th, tw, st) <= SMEM_LIMIT), None)
                if stages is None:
                    continue
                smem = mid_smem_bytes(phase, ck, nchunks, nt, td, th, tw, stages)
                grid_x = min(nbricks, sms)
                # a (brick, chunk) step of a block, in cycles of its multiprocessor:
                # its k16 steps' operand bytes from shared memory, or its halo's
                # bytes from the L2, plus the exposed wait of its slot
                mma = slabs * mid_ksteps(ck) * (2048 + nt * 32) / _SMEM_BYTES
                l2 = nph * (ck // 8) * mid_halo_points(phase, td, th, tw) * 16 / _L2_BYTES
                step = max(mma, l2) + _MID_STEP_CYCLES
                cycles = -(-nbricks * n_tiles // sms) * nchunks * step
                yield (fill < 0.75, cycles, -fill), MidPlan(
                    td=td, th=th, tw=tw, ck=ck, nchunks=nchunks, nt=nt, n_tiles=n_tiles,
                    spw=spw, nwg=nwg, stages=stages, grid_x=grid_x, nbricks=nbricks,
                    smem_bytes=smem, fill=fill)


@functools.lru_cache(maxsize=None)
def mid_plan(dims: Tuple[int, int, int, int], c: int, co: int, phase: bool = False,
             sms: int = _SMS) -> MidPlan:
    """The brick, channel chunk, N tile, slabs and ring of one launch of the
    mid-channel conv body for a (B, D, H, W) grid of output positions (full
    resolution for the phase layout), C input and CO output channels: the N
    tile the least of 8, 16, 32, 64 that holds CO (64-wide tiles beyond),
    chunks of 16 channels (C = 8: one of 8, its taps paired), and among the
    bricks of 4 or 8 slabs (phase: one plane of 8 x 8 block voxels; two
    warpgroups of 2 or 4 slabs, four of 2 at N = 64 with 8), the cheapest by a rough
    count of cycles on the busiest of ``sms`` multiprocessors (each step's
    operand bytes from shared memory or its halo from the L2), among those
    whose rows are at least 75% real output positions where any is. The ring
    takes as many slots (2-4) as fit."""
    if not mid_eligible(c, co, phase):
        raise ValueError(f"the mid-channel conv body needs C % {16 if phase else 8} == 0, got "
                         f"C = {c}")
    if phase and any(v % 2 for v in dims[1:]):
        raise ValueError(f"a phase-major tensor stands for even extents, got {dims}")
    found = min(_mid_candidates(dims, c, co, phase, sms), key=lambda kp: kp[0], default=None)
    if found is None:
        raise ValueError(f"no mid-channel launch plan for dims {dims}, C = {c}, CO = {co}")
    return found[1]


@functools.lru_cache(maxsize=None)
def _mid_pack_index(c: int, co: int, nt: int, ck: int, device: torch.device) -> torch.Tensor:
    """Where each value of :func:`pack_weights_mid`'s result comes from in
    the flattened DHWIO weights, 27 * c * co (the element past their end)
    for padding. Made on ``device``, once a shape."""
    n_tiles, ng, zero = -(-co // nt), nt // 8, 27 * c * co
    src = torch.arange(zero, device=device).reshape(27, c, co)
    if ck == 8:  # k16 steps of tap pairs (0, none), (1, 2), ..., (25, 26)
        src = F.pad(src, (0, n_tiles * nt - co, 0, 0, 0, 1), value=zero)
        order = torch.tensor([0, 27] + list(range(1, 27)), device=device)
        # (step, kg, k, tile, ng, n) -> (tile, step, kg, ng, n, k)
        src = src[order].reshape(14, 2, 8, n_tiles, ng, 8).permute(3, 0, 1, 4, 5, 2)
        return src.reshape(n_tiles, -1).contiguous()
    nchunks = -(-c // ck)
    src = F.pad(src, (0, n_tiles * nt - co, 0, nchunks * ck - c), value=zero)
    # (tap, chunk, kg, k, tile, ng, n) -> (tile, chunk, tap, kg, ng, n, k)
    src = src.reshape(27, nchunks, 2, 8, n_tiles, ng, 8).permute(4, 1, 0, 2, 5, 6, 3)
    return src.reshape(n_tiles, -1).contiguous()


def pack_weights_mid(weights: torch.Tensor, nt: int, ck: int) -> torch.Tensor:
    """DHWIO weights (3, 3, 3, C, CO) in the order the mid-channel conv body
    reads: (N tiles, values) with, per chunk of ck = 16 input channels and
    k16 step (tap; C = 8, ck = 8: the tap pairs (0, none), (1, 2), ...,
    (25, 26)), two k halves x nt / 8 core matrices of 8 output
    channels x 8 k, K-major, as a no-swizzle wgmma descriptor reads them; C
    and CO padded with zeros. One gather by a cached index."""
    c, co = weights.shape[-2:]
    index = _mid_pack_index(c, co, nt, ck, weights.device)
    return F.pad(weights.reshape(-1), (0, 1))[index]


def unpack_weights_mid(packed: torch.Tensor, c: int, co: int, ck: int) -> torch.Tensor:
    """Inverse of :func:`pack_weights_mid`: the DHWIO weights (3, 3, 3, c, co)."""
    nt = packed.shape[1] // (-(-c // ck) * mid_ksteps(ck) * 16)
    index = _mid_pack_index(c, co, nt, ck, packed.device).reshape(-1)
    out = torch.zeros(27 * c * co + 1, dtype=packed.dtype, device=packed.device)
    out[index] = packed.reshape(-1)
    return out[:-1].reshape(3, 3, 3, c, co)


def mid_dw_smem_bytes(td: int, th: int, tw: int, stages: int) -> int:
    """``mid_dw_smem_bytes`` of ``csrc/conv3_mid_dw.cuh``: 1024 bytes to
    align the base, 1024 of barriers, ``stages`` slots of the x halo and the
    dy brick, 64 channels (128 bytes) a position, each rounded to 1024."""
    return 2048 + stages * (deep_halo_bytes(td, th, tw) + _round1024(td * th * tw * 128))


@dataclasses.dataclass(frozen=True)
class MidDwPlan:
    """Launch geometry of the mid-channel dw body, as the C entry point
    takes it. A block of ``nwg`` consumer warpgroups owns ``nwg * tpw`` taps
    (tap group ``tg``: taps ``tg * nwg * tpw ...``, none past 26), a chunk of 64
    input channels and a tile of 64 output channels, and walks the bricks
    ``split, split + splits, ...`` of ``td x th x tw`` positions (a k16 step
    is 16 positions of one row, tw = 16, or of two, tw = 8); grid (splits,
    n_tg * n_ci * n_co), the tap group fastest."""

    td: int
    th: int
    tw: int
    tpw: int  # taps a consumer warpgroup accumulates
    nwg: int  # consumer warpgroups a block (2 or 3), besides the producer's
    n_tg: int
    n_ci: int
    n_co: int
    splits: int
    stages: int
    grid: Tuple[int, int]
    smem_bytes: int
    workspace: int  # f32 values: splits * 27 * C * CO, 0 with one split
    nbricks: int
    fill: float  # real positions / positions walked


def mid_dw_eligible(c: int, co: int, phase: bool) -> bool:
    """Channel counts the mid-channel dw body takes: dense, C and CO whole
    128-byte rows (multiples of 64)."""
    return not phase and c >= 64 and c % 64 == 0 and co >= 64 and co % 64 == 0


_MID_DW_SHAPES = ((2, 2), (3, 2), (2, 3), (3, 3))  # (taps a warpgroup, consumer warpgroups)
# the instances' bricks: 8, 12 or 16 k16 steps of 16 positions, one row of
# 16 or two rows of 8
_MID_DW_BRICKS = [b for b in itertools.product((1, 2, 3, 4, 6, 8), (1, 2, 3, 4, 6, 8), (8, 16))
                  if b[0] * b[1] * b[2] // 16 in (8, 12, 16) and (b[2] == 16 or b[1] % 2 == 0)]


def _mid_dw_candidates(dims, c: int, co: int, sms: int):
    b, d, h, w = dims
    positions = b * d * h * w
    n_ci, n_co = c // 64, co // 64
    n_out = 27 * c * co
    for tpw, nwg in _MID_DW_SHAPES:
        n_tg = -(-27 // (nwg * tpw))
        tiles = n_tg * n_ci * n_co
        for td, th, tw in _MID_DW_BRICKS:
            p = td * th * tw
            nbricks = b * -(-d // td) * -(-h // th) * -(-w // tw)
            if nbricks >= 2 ** 31:
                continue
            fill = positions / (nbricks * p)
            stages = next((st for st in (4, 3, 2)
                           if mid_dw_smem_bytes(td, th, tw, st) <= SMEM_LIMIT), None)
            if stages is None:
                continue
            smem = mid_dw_smem_bytes(td, th, tw, stages)
            # a brick of a block, in cycles: its wgmma (A and B 2 KB each from
            # shared memory a k16 step and tap) or its halo and dy rows from the L2
            mma = nwg * tpw * p / 16 * 4096 / _SMEM_BYTES
            l2 = ((td + 2) * (th + 2) * (tw + 2) + p) * 128 / _L2_BYTES
            per_brick = max(mma, l2) + _MID_STEP_CYCLES
            for splits in sorted({s for s in _split_counts(min(nbricks, 256))}
                                 | {max(1, min(nbricks, k * sms // tiles)) for k in (1, 2)}):
                blocks = tiles * splits
                cycles = -(-blocks // sms) * (-(-nbricks // splits) * per_brick + 2500)
                if splits > 1:  # the partials out and back, and the second launch
                    cycles += 2 * splits * n_out * 4 / (sms * 32) + 4000
                yield (fill < 0.7, cycles, -fill, splits), MidDwPlan(
                    td=td, th=th, tw=tw, tpw=tpw, nwg=nwg, n_tg=n_tg, n_ci=n_ci, n_co=n_co,
                    splits=splits, stages=stages, grid=(splits, tiles), smem_bytes=smem,
                    workspace=splits * n_out if splits > 1 else 0, nbricks=nbricks, fill=fill)


@functools.lru_cache(maxsize=None)
def mid_dw_plan(dims: Tuple[int, int, int, int], c: int, co: int, sms: int = _SMS) -> MidDwPlan:
    """The brick, taps a warpgroup, warpgroups, ring and position splits of
    one launch of the mid-channel dw body for a (B, D, H, W) grid of
    positions, C and CO multiples of 64: among two or three taps for each of
    two or three consumer warpgroups, bricks of 128, 192 or 256 positions in
    rows 8 or 16 long, and a few split counts, the cheapest by a rough count of
    cycles on the busiest of ``sms`` multiprocessors (each brick's wgmma
    operands from shared memory or its rows from the L2; for more than one
    split the partials and the second launch), among those whose positions
    are at least 70% real where any is. The ring takes as many slots (2-4)
    as fit."""
    if not mid_dw_eligible(c, co, False):
        raise ValueError("the mid-channel dw body needs C and CO multiples of 64, got "
                         f"C = {c}, CO = {co}")
    found = min(_mid_dw_candidates(dims, c, co, sms), key=lambda kp: kp[0], default=None)
    if found is None:
        raise ValueError(f"no mid-channel dw launch plan for dims {dims}, C = {c}, CO = {co}")
    return found[1]


# -- the phase dw's Hopper body (csrc/conv3_phase_dw.cuh) --

PHASE_DW_MAX_ROWS = 192  # PHASE_DW_MAX_ROWS: brick positions, their halo rows in a table
# (N = 2 Ci) -> the (tiles a warpgroup, warpgroups) instances: three of
# three, the per-tz path (a group is a co chunk's 9 tiles), wherever its
# accumulators (3 x N / 2 floats a thread) and two sets of fragments fit the
# 168 registers ptxas gives at 384 threads; at N = 128 one tile a warpgroup
# (two of three, or three of two, spilled and ran 1.1-1.4x slower on an
# H100)
_PHASE_DW_SHAPES = {16: ((3, 3),), 32: ((3, 3),), 64: ((3, 3),), 128: ((1, 3),)}
_PHASE_DW_BRICKS = [b for b in itertools.product((1, 2, 3, 4), (1, 2, 3, 4, 6, 8), (4, 8, 16))
                    if b[0] * b[1] * b[2] % 16 == 0 and b[0] * b[1] * b[2] <= PHASE_DW_MAX_ROWS]
_PHASE_DW_STEP_CYCLES = 40  # a pass's fragment loads and wait, exposed once a warpgroup


def phase_dw_eligible(c: int, co: int) -> bool:
    """Channel counts the phase dw's Hopper body takes: Ci in {8, 16, 32, 64}
    (a run of the 2 Ci lanes (a'x, ci) is one wgmma N of 16, 32, 64 or 128
    inside one or two 128-byte rows) and Co = 8 or a multiple of 16 (its co
    chunks of 16)."""
    return c in (8, 16, 32, 64) and (co == 8 or (co >= 16 and co % 16 == 0))


def phase_dw_smem_bytes(c: int, co: int, td: int, th: int, tw: int, stages: int) -> int:
    """``phase_dw_smem_bytes`` of ``csrc/conv3_phase_dw.cuh``: 1024 bytes to
    align the base, 1024 of barriers and the halo-row table, ``stages``
    slots of the p brick (c / 8 planes of 128-byte rows) and the g halo (co
    / 8 planes, each rounded to 1024)."""
    p_bytes = c // 8 * td * th * tw * 128
    g_bytes = co // 8 * _round1024((td + 2) * (th + 2) * (tw + 2) * 128)
    return 2048 + stages * (p_bytes + g_bytes)


@dataclasses.dataclass(frozen=True)
class PhaseDwPlan:
    """Launch geometry of the phase dw's Hopper body, as the C entry point
    takes it. A block of ``nwg`` warpgroups owns ``nwg * tpw`` of the
    ``n_tiles`` tiles (co chunk of 16, tz, ty; grid.y = ``groups``) and walks
    the bricks ``split, split + splits, ...`` of ``td x th x tw`` block
    voxels; each split writes two partials (a'x = 0, 1) that a second kernel
    sums in a fixed order."""

    td: int
    th: int
    tw: int
    tpw: int  # tiles a warpgroup accumulates
    nwg: int  # warpgroups a block (thread 0 issues the copies too)
    n_tiles: int  # 9 x co chunks of 16
    groups: int
    splits: int
    stages: int
    grid: Tuple[int, int]  # (splits, groups)
    smem_bytes: int
    workspace: int  # f32 values: 2 * splits * 27 * C * CO
    nbricks: int
    fill: float  # real block voxels / block voxels walked


def _phase_dw_candidates(dims, c: int, co: int, sms: int):
    b, d, h, w = dims
    d, h, w = d // 2, h // 2, w // 2
    positions = b * d * h * w
    n = 2 * c
    n_tiles = 9 * -(-co // 16)
    n_out = 27 * c * co
    for tpw, nwg in _PHASE_DW_SHAPES[n]:
        reuse = (tpw, nwg) == (3, 3)  # the per-tz path
        groups = -(-n_tiles // (tpw * nwg))
        for td, th, tw in _PHASE_DW_BRICKS:
            p = td * th * tw
            nbricks = b * -(-d // td) * -(-h // th) * -(-w // tw)
            if nbricks >= 2 ** 31:
                continue
            fill = positions / (nbricks * p)
            stages = next((st for st in (4, 3, 2)
                           if phase_dw_smem_bytes(c, co, td, th, tw, st) <= SMEM_LIMIT), None)
            if stages is None:
                continue
            smem = phase_dw_smem_bytes(c, co, td, th, tw, stages)
            # a brick of a block, in cycles: its wgmma (N / 2 cycles of the
            # tensor cores each, or B's 32 N bytes and A's 2 KB by ldmatrix
            # from shared memory) or its staging from the L2
            wgmmas = 4 * (p // 16) * nwg * tpw
            # A's fragments: four of six loads and one commit group of two on the
            # per-tz path
            a_bytes = 2048 * (2 / 3 if reuse else 1)
            mma = wgmmas * max(n / 2, (a_bytes + 32 * n) / _SMEM_BYTES) \
                + (2 if reuse else 4) * (p // 16) * _PHASE_DW_STEP_CYCLES
            l2 = (c // 8 * p + co // 8 * (td + 2) * (th + 2) * (tw + 2)) * 128 / _L2_BYTES
            per_brick = max(mma, l2) + _MID_STEP_CYCLES
            for splits in sorted({s for s in _split_counts(min(nbricks, 256))}
                                 | {max(1, min(nbricks, k * sms // groups)) for k in (1, 2, 3)}):
                blocks = groups * splits
                cycles = -(-blocks // sms) * (-(-nbricks // splits) * per_brick + 2500)
                # the partials out and back, and the second launch
                cycles += 2 * 2 * splits * n_out * 4 / (sms * 32) + 4000
                yield (fill < 0.7, cycles, -fill, splits), PhaseDwPlan(
                    td=td, th=th, tw=tw, tpw=tpw, nwg=nwg, n_tiles=n_tiles, groups=groups,
                    splits=splits, stages=stages, grid=(splits, groups), smem_bytes=smem,
                    workspace=2 * splits * n_out, nbricks=nbricks, fill=fill)


@functools.lru_cache(maxsize=None)
def phase_dw_plan(dims: Tuple[int, int, int, int], c: int, co: int,
                  sms: int = _SMS) -> PhaseDwPlan:
    """The brick, tiles a warpgroup, warpgroups, ring and position splits of
    one launch of the phase dw's Hopper body for a (B, D, H, W) grid of
    full-resolution positions (p and g hold (B, D/2, H/2, W/2) block voxels),
    C input and CO output channels: among bricks of 16 to 192 block voxels
    and a few split counts, the cheapest by a rough count of cycles on the
    busiest of ``sms`` multiprocessors (each brick's wgmma or operand bytes
    from shared memory, or its staging from the L2; the partials and the
    second launch), among those whose voxels are at least 70% real where any
    is. The ring takes as many slots (2-4) as fit."""
    if not phase_dw_eligible(c, co):
        raise ValueError("the phase dw's Hopper body needs C in (8, 16, 32, 64) and CO = 8 or "
                         f"a multiple of 16, got C = {c}, CO = {co}")
    found = min(_phase_dw_candidates(dims, c, co, sms), key=lambda kp: kp[0], default=None)
    if found is None:
        raise ValueError(f"no phase dw launch plan for dims {dims}, C = {c}, CO = {co}")
    return found[1]


# -- the phase forward's Hopper body (csrc/conv3_phase.cuh) --

PHASE_FWD_N = 64  # PHASE_FWD_N: a wgmma's N, 8 output phases x 8 co or 4 x 16
PHASE_FWD_KSTEPS = 48  # k16 steps a brick (L = 64: 32 of them whole, 16 half zeros)
PHASE_FWD_W_BYTES = PHASE_FWD_KSTEPS // 4 * PHASE_FWD_N * 128  # one group's resident weights
PHASE_FWD_NWG = 2  # consumer warpgroups, taking turns to issue their bricks
PHASE_FWD_HALO = 10 * 10  # rows of a z plane of a brick's halo (8 x 8 block voxels)


def phase_fwd_eligible(c: int, co: int) -> bool:
    """Channel counts the phase forward's Hopper body takes: Ci = Co = 8 (L =
    64: all 8 output phases in a wgmma's N of 64) or 16 (L = 128: the 4 (y, x)
    phases of one output z phase)."""
    return c == co and c in (8, 16)


def phase_fwd_groups(c: int) -> int:
    """Blocks along N (``phase_fwd_groups``): one at L = 64, the two output z
    phases at L = 128 (the weights of all 8 phases, 256 KB, fit no block)."""
    return 1 if c == 8 else 2


def phase_fwd_depth(c: int, plane: int, az: int) -> int:
    """z planes of a 64-lane plane's staged box (``phase_fwd_depth``): L = 64
    three; L = 128 a halo plane only on the side the block's output z phase
    az reads from that plane (a'z = plane)."""
    return 3 if c == 8 else (2 if plane != az else 1)


def phase_fwd_slot_bytes(c: int) -> int:
    """One ring slot: the planes of the halo brick (128-byte rows), each
    rounded to 1024."""
    return sum(_round1024(phase_fwd_depth(c, k, 0) * PHASE_FWD_HALO * 128)
               for k in range(c // 8))


def phase_fwd_smem_bytes(c: int, stages: int) -> int:
    """``phase_fwd_smem_bytes`` of ``csrc/conv3_phase.cuh``: 1024 bytes to
    align the base, 1024 of barriers, the resident weights, ``stages``
    slots."""
    return 2048 + PHASE_FWD_W_BYTES + stages * phase_fwd_slot_bytes(c)


@dataclasses.dataclass(frozen=True)
class PhaseFwdPlan:
    """Launch geometry of the phase forward's Hopper body, as the C entry
    point takes it. A block of two consumer warpgroups and a producer warp
    holds one group's weights (``groups`` blocks along N: the output z phases
    at L = 128) and walks the bricks ``blockIdx.x + k * grid_x`` of 1 x 8 x 8
    block voxels (a wgmma's M) through a ring of ``stages`` slots; warpgroup
    wg takes the bricks k = wg, wg + 2, ..., issued in turn (brick k after
    brick k - 1)."""

    groups: int
    stages: int
    grid_x: int
    grid: Tuple[int, int]  # (grid_x, groups)
    smem_bytes: int
    nbricks: int
    fill: float  # real block voxels / block voxels multiplied
    td: int = 1
    th: int = 8
    tw: int = 8
    nwg: int = PHASE_FWD_NWG
    ksteps: int = PHASE_FWD_KSTEPS


@functools.lru_cache(maxsize=None)
def phase_fwd_plan(dims: Tuple[int, int, int, int], c: int, co: int,
                   sms: int = _SMS) -> PhaseFwdPlan:
    """The ring and grid of one launch of the phase forward's Hopper body for
    a (B, D, H, W) grid of full-resolution positions (p holds (B, D/2, H/2,
    W/2) block voxels), C input and CO output channels: bricks of one z plane
    of 8 x 8 block voxels, one persistent block a multiprocessor (``sms``
    blocks in all), the ring as many slots as fit (three: 96 KB of weights
    and 38 KB a slot). One geometry: on an H100 (PERF.md) bricks of
    two z planes (two 51-63 KB slots) ran 3-10% slower at every row, A from
    registers 1.1-1.7x slower, and the tensor cores' pace is shared memory's
    (A and B, 4 KB a m64n64k16), not the brick's halo."""
    if not phase_fwd_eligible(c, co):
        raise ValueError("the phase forward's Hopper body needs C = CO in (8, 16), got "
                         f"C = {c}, CO = {co}")
    b, d, h, w = dims
    d, h, w = d // 2, h // 2, w // 2
    nbricks = b * d * -(-h // 8) * -(-w // 8)
    stages = next((st for st in range(8, PHASE_FWD_NWG - 1, -1)
                   if phase_fwd_smem_bytes(c, st) <= SMEM_LIMIT), None)
    if nbricks < 1 or nbricks >= 2 ** 31 or stages is None:
        raise ValueError(f"no phase forward launch plan for dims {dims}, C = {c}, CO = {co}")
    groups = phase_fwd_groups(c)
    grid_x = min(nbricks, max(1, sms // groups))
    return PhaseFwdPlan(groups=groups, stages=stages, grid_x=grid_x, grid=(grid_x, groups),
                        smem_bytes=phase_fwd_smem_bytes(c, stages), nbricks=nbricks,
                        fill=b * d * h * w / (nbricks * 64))


def _phase_pair(p) -> Tuple:
    """Per axis the (shift e, input phase a') of pair p: P0 = (-1, 1), P1 =
    (0, 0), P2 = (0, 1), P3 = (+1, 0)."""
    return (p + 1) // 2 - 1, 1 - p % 2


@functools.lru_cache(maxsize=None)
def _phase_pack_index(c: int, device: torch.device) -> torch.Tensor:
    """Where each value of :func:`pack_weights_phase`'s result comes from in
    the flattened DHWIO weights, 27 * c * c (the element past their end) for
    a structural zero: the packing as one gather. Made on ``device``, once."""
    groups = phase_fwd_groups(c)
    ar = functools.partial(torch.arange, device=device)
    g = ar(groups).view(-1, 1, 1, 1)
    kr = ar(PHASE_FWD_KSTEPS // 4).view(1, -1, 1, 1) * 64 + ar(64).view(1, 1, 1, -1)  # K row
    n = ar(PHASE_FWD_N).view(1, 1, -1, 1)
    st, kk = kr // 16, kr % 16
    if c == 8:  # step (pz, py, ex): k = (a'x, ci); the x pair of (ex, a'x), -1 if none
        pz, py, ex, apx, ci = st // 12, st // 3 % 4, st % 3 - 1, kk // 8, kk % 8
        px = torch.where(ex == 0, 1 + apx, torch.where(ex < 0, 1 - apx, 3 - 4 * apx))
        px = torch.where((ex != 0) & (apx == (ex > 0).long()), -1, px)
    else:  # step (pz - az, py, px): k = ci
        pz, py, px, ci = st // 16 + g, st // 4 % 4, st % 4, kk
    ph, co = n // c, n % c  # L = 64: phase (az, ay, ax); L = 128: (ay, ax), az = the group
    az = ph >> 2 if groups == 1 else g

    def tap(p, a):
        e, ap = _phase_pair(p)
        return 2 * e + ap - a + 1

    tz, ty, tx = tap(pz, az), tap(py, ph >> 1 & 1), tap(px, ph & 1)
    valid = (px >= 0) & (tz >= 0) & (tz <= 2) & (ty >= 0) & (ty <= 2) & (tx >= 0) & (tx <= 2)
    src = torch.where(valid, ((tz * 3 + ty) * 3 + tx) * c * c + ci * c + co, 27 * c * c)
    src = src.expand(groups, PHASE_FWD_KSTEPS // 4, PHASE_FWD_N, 64)
    return _swizzle128(src.contiguous()).contiguous()


def pack_weights_phase(weights: torch.Tensor) -> torch.Tensor:
    """DHWIO weights (3, 3, 3, C, C), C = 8 or 16, in the order the phase
    forward's Hopper body reads them: (groups, 12 K tiles, 64 N rows, 64 k),
    per group (the output z phase at C = 16) and tile of 4 k16 steps the N
    rows (output phase, co) of 64 K rows, K-major and 128-byte swizzled as a
    wgmma descriptor reads it. A k16 step is, at C = 8, st = (pz * 4 + py) *
    3 + ex + 1 with k = (a'x, ci): the x pair of shift ex and input phase
    a'x, none (zeros) for a'x = 0 at ex = -1 and a'x = 1 at ex = +1; at C =
    16, st = ((pz - az) * 4 + py) * 4 + px with k = ci. Each value is the tap
    of its pairs for the column's output phase, zero where a pair serves no
    tap of it. One gather by a cached index."""
    c = weights.shape[-2]
    index = _phase_pack_index(c, weights.device)
    return F.pad(weights.reshape(-1), (0, 1))[index]


# -- the dense Hopper bodies (csrc/conv3_dense.cuh, csrc/conv3_dense_dw.cuh) --

DENSE_NWG = 2  # DENSE_NWG: consumer warpgroups, taking turns to issue their bricks
DENSE_HALO = 10  # DENSE_HALO: a brick's box is 10 y x 10 z rows (8 x 8 and one each side)
DENSE_BOX_BYTES = _round1024(DENSE_HALO * DENSE_HALO * 128)  # the window's box
DENSE_W_MAIN = 9 * 64 * 128  # a tile of 64 N rows x 64 k for each (tz, ty)
DENSE_DW_SLOT_BYTES = 2 * 8 * 8 * 64 + 2 * DENSE_BOX_BYTES  # dy's two halves, two windows
DENSE_DW_G_BYTES = 3 * 3 * 2 * 64 * 33 * 4  # the epilogue's sums, over the ring


def dense_eligible(c: int, co: int, w: int) -> bool:
    """Channel counts and widths the dense Hopper bodies take: C = CO = 8 or
    16 and W * C a multiple of 64 (whole 128-byte rows of 64 / C voxels a
    line)."""
    return c == co and c in (8, 16) and (w * c) % 64 == 0


def dense_slot_bytes(c: int) -> int:
    """``dense_slot_bytes``: the window's box and the tail's (10 x 10 rows of
    2 c lanes), each rounded to 1024."""
    return DENSE_BOX_BYTES + _round1024(DENSE_HALO * DENSE_HALO * 4 * c)


def dense_w_bytes(c: int) -> int:
    """``dense_w_bytes``: the window's 9 tiles and the tail's 9 c / 8 k16
    steps, 4 to a tile of 2 c N rows x 128 bytes."""
    return DENSE_W_MAIN + -(-(9 * c // 8) // 4) * 2 * c * 128


def dense_fwd_smem_bytes(c: int, stages: int) -> int:
    """``dense_fwd_smem_bytes`` of ``csrc/conv3_dense.cuh``: 1024 bytes to
    align the base, 1024 of barriers, the resident weights, ``stages``
    slots."""
    return 2048 + dense_w_bytes(c) + stages * dense_slot_bytes(c)


def dense_dw_smem_bytes(stages: int) -> int:
    """``dense_dw_smem_bytes`` of ``csrc/conv3_dense_dw.cuh``: 1024 bytes to
    align the base, 1024 of barriers, ``stages`` slots."""
    return 2048 + stages * DENSE_DW_SLOT_BYTES


def _dense_bricks(dims, c: int) -> int:
    b, d, h, w = dims
    return b * -(-d // 8) * -(-h // 8) * (w * c // 64)


@dataclasses.dataclass(frozen=True)
class DenseFwdPlan:
    """Launch geometry of the dense Hopper conv body, as the C entry point
    takes it. A block of two consumer warpgroups and a producer warp walks the
    bricks ``blockIdx.x + k * grid_x`` (8 z x 8 y of one 128-byte row j of
    the lines: a wgmma's M) through a ring of ``stages`` slots; warpgroup wg
    takes the bricks k = wg, wg + 2, ..., issued in turn."""

    stages: int
    grid_x: int
    smem_bytes: int
    nbricks: int
    nrows: int  # 128-byte rows a line: W * C / 64
    fill: float  # real rows / rows multiplied
    ksteps: int  # k16 steps a brick: 36 m64n64k16 and 9 C / 8 of the tail's N = 2 C
    nwg: int = DENSE_NWG


@functools.lru_cache(maxsize=None)
def dense_fwd_plan(dims: Tuple[int, int, int, int], c: int, co: int,
                   sms: int = _SMS) -> DenseFwdPlan:
    """The ring and grid of one launch of the dense Hopper conv body on a (B,
    D, H, W) grid: one persistent block a multiprocessor (``sms`` blocks, or
    one a brick), the ring as many slots as fit, at most eight (C = 8: eight
    of 17 KB beside 78 KB of weights; C = 16: six of 20 KB beside 92 KB)."""
    b, d, h, w = dims
    if not dense_eligible(c, co, w):
        raise ValueError("the dense Hopper body needs C = CO in (8, 16) and W * C a multiple "
                         f"of 64, got C = {c}, CO = {co}, W = {w}")
    nbricks = _dense_bricks(dims, c)
    stages = next((st for st in range(8, DENSE_NWG - 1, -1)
                   if dense_fwd_smem_bytes(c, st) <= SMEM_LIMIT), None)
    if nbricks < 1 or nbricks >= 2 ** 31 or stages is None:
        raise ValueError(f"no dense Hopper launch plan for dims {dims}, C = {c}, CO = {co}")
    nrows = w * c // 64
    return DenseFwdPlan(stages=stages, grid_x=min(nbricks, sms),
                        smem_bytes=dense_fwd_smem_bytes(c, stages), nbricks=nbricks, nrows=nrows,
                        fill=b * d * h * nrows / (nbricks * 64), ksteps=36 + 9 * c // 8)


@dataclasses.dataclass(frozen=True)
class DenseDwPlan:
    """Launch geometry of the dense Hopper dw body: ``grid_x`` blocks (three
    warpgroups: the tz), each walking the bricks ``blockIdx.x + k * grid_x``
    through a ring of ``stages`` slots, then a second launch that sums the
    ``grid_x`` partials of ``workspace`` floats in a fixed order."""

    stages: int
    grid_x: int
    smem_bytes: int
    nbricks: int
    nrows: int
    workspace: int  # floats: grid_x partials of 27 * C * C
    fill: float


@functools.lru_cache(maxsize=None)
def dense_dw_plan(dims: Tuple[int, int, int, int], c: int, co: int,
                  sms: int = _SMS) -> DenseDwPlan:
    """The ring and grid of one launch of the dense Hopper dw body: one block
    a multiprocessor (or one a brick), the ring as deep as fits (six slots of
    34 KB; the epilogue's sums, 149 KB, take it over)."""
    b, d, h, w = dims
    if not dense_eligible(c, co, w):
        raise ValueError("the dense Hopper dw body needs C = CO in (8, 16) and W * C a "
                         f"multiple of 64, got C = {c}, CO = {co}, W = {w}")
    nbricks = _dense_bricks(dims, c)
    stages = next((st for st in range(8, 1, -1) if dense_dw_smem_bytes(st) <= SMEM_LIMIT
                   and st * DENSE_DW_SLOT_BYTES >= DENSE_DW_G_BYTES), None)
    if nbricks < 1 or nbricks >= 2 ** 31 or stages is None:
        raise ValueError(f"no dense Hopper dw launch plan for dims {dims}, C = {c}, CO = {co}")
    grid_x = min(nbricks, sms)
    nrows = w * c // 64
    return DenseDwPlan(stages=stages, grid_x=grid_x, smem_bytes=dense_dw_smem_bytes(stages),
                       nbricks=nbricks, nrows=nrows, workspace=grid_x * 27 * c * c,
                       fill=b * d * h * nrows / (nbricks * 64))


@functools.lru_cache(maxsize=None)
def _dense_pack_index(c: int, device: torch.device) -> torch.Tensor:
    """Where each value of :func:`pack_weights_dense`'s result comes from in
    the flattened DHWIO weights, 27 * c * c (the element past their end) for
    a structural zero: the packing as one gather. Made on ``device``, once."""
    nt = 2 * c  # the tail's N: the row's last two output voxels
    ar = functools.partial(torch.arange, device=device)

    def src(t, n, d, ci):
        """(tz, ty) = divmod(t, 3), output column n, input voxel d from row j's
        first voxel, input channel ci -> flat index or 27 c c."""
        x, co = n // c, n % c
        tx = d - x + 1
        valid = (tx >= 0) & (tx <= 2) & (t < 9)
        return torch.where(valid, ((t * 3 + tx) * c + ci) * c + co, 27 * c * c)

    # the window's tiles (9, 64 n, 64 k): k the lanes from voxel u j - 1
    k = ar(64).view(1, 1, 64)
    main = src(ar(9).view(-1, 1, 1), ar(64).view(1, 64, 1), k // c - 1, k % c)
    # the tail's tiles (tiles, 2c n, 64 k): step e = 4 tile + k // 16 = t c / 8 + q,
    # its K the lanes 16 q .. of the two voxels u j + u - 1, u j + u; its N
    # rows the columns 64 - 2c ..
    steps = 9 * c // 8
    tiles = -(-steps // 4)
    e = ar(tiles).view(-1, 1, 1) * 4 + ar(64).view(1, 1, 64) // 16
    lane = (e % (c // 8)) * 16 + ar(64).view(1, 1, 64) % 16
    tail = src(torch.where(e < steps, e // (c // 8), 9), ar(nt).view(1, -1, 1) + 64 - nt,
               64 // c - 1 + lane // c, lane % c)
    return torch.cat([_swizzle128(main.contiguous()).reshape(-1),
                      _swizzle128(tail.contiguous()).reshape(-1)])


def pack_weights_dense(weights: torch.Tensor) -> torch.Tensor:
    """DHWIO weights (3, 3, 3, C, C), C = 8 or 16, in the order the dense
    Hopper conv body reads them (``dense_w_bytes`` in bf16): nine tiles (tz,
    ty) of 64 N rows (output lanes of a row: voxel n // C, channel n % C) x 64
    k (the window's lanes: voxel k // C - 1 from the row's first, channel k %
    C), the tap tx = x' - x + 1 of input voxel x' and output voxel x where it
    exists and zero elsewhere; then the tail's 9 C / 8 k16 steps t C / 8 + q,
    4 to a tile of 2 C N rows (the row's last two output voxels) x 64 k (lanes
    16 q .. of the voxels u and u + 1 from the row's first). K-major and
    128-byte swizzled as a wgmma descriptor reads them. One gather by a cached
    index."""
    c = weights.shape[-2]
    index = _dense_pack_index(c, weights.device)
    return F.pad(weights.reshape(-1), (0, 1))[index]


# -- the dense pairs dw body (csrc/conv3_dense_pairs_dw.cuh) --

DENSE_PAIRS_DY_BYTES = 8 * 8 * 128  # DENSE_PAIRS_DY_BYTES: a box of dy, 8 y x 8 z rows
# DENSE_PAIRS_SLOT_BYTES: x's two windows (10 y x 10 z rows), dy's two boxes
DENSE_PAIRS_SLOT_BYTES = 2 * DENSE_BOX_BYTES + 2 * DENSE_PAIRS_DY_BYTES


def dense_pairs_eligible(c: int, co: int, w: int) -> bool:
    """Channel counts and widths the dense pairs dw body takes: C = CO = 32 and
    W even (whole 128-byte rows of two voxels a line)."""
    return c == co == 32 and w % 2 == 0


def dense_pairs_smem_bytes(stages: int) -> int:
    """``dense_pairs_smem_bytes`` of ``csrc/conv3_dense_pairs_dw.cuh``: 1024
    bytes to align the base, 1024 of barriers, ``stages`` slots."""
    return 2048 + stages * DENSE_PAIRS_SLOT_BYTES


@dataclasses.dataclass(frozen=True)
class DensePairsPlan:
    """Launch geometry of the dense pairs dw body: ``grid_x`` blocks (three
    warpgroups: the tz), each walking the bricks ``blockIdx.x + k * grid_x``
    (8 y x 8 z positions of one 128-byte row j: two voxels) through a ring of
    ``stages`` slots, then a second launch that sums the ``grid_x`` partials
    of ``workspace`` floats in a fixed order."""

    stages: int
    grid_x: int
    smem_bytes: int
    nbricks: int
    nrows: int  # 128-byte rows a line: W / 2
    workspace: int  # floats: grid_x partials of 27 * 32 * 32
    fill: float  # real positions / positions walked


@functools.lru_cache(maxsize=None)
def dense_pairs_plan(dims: Tuple[int, int, int, int], c: int, co: int,
                     sms: int = _SMS) -> DensePairsPlan:
    """The ring and grid of one launch of the dense pairs dw body on a (B, D,
    H, W) grid: one block a multiprocessor (or one a brick), the ring as deep
    as fits (five slots of 42 KB)."""
    b, d, h, w = dims
    if not dense_pairs_eligible(c, co, w):
        raise ValueError("the dense pairs dw body needs C = CO = 32 and W even, got "
                         f"C = {c}, CO = {co}, W = {w}")
    nrows = w // 2
    nbricks = b * -(-d // 8) * -(-h // 8) * nrows
    stages = next((st for st in range(8, 1, -1) if dense_pairs_smem_bytes(st) <= SMEM_LIMIT),
                  None)
    if nbricks < 1 or nbricks >= 2 ** 31 or stages is None:
        raise ValueError(f"no dense pairs dw launch plan for dims {dims}, C = {c}, CO = {co}")
    grid_x = min(nbricks, sms)
    return DensePairsPlan(stages=stages, grid_x=grid_x, smem_bytes=dense_pairs_smem_bytes(stages),
                          nbricks=nbricks, nrows=nrows, workspace=grid_x * 27 * c * co,
                          fill=b * d * h * nrows / (nbricks * 64))


# -- the phase pieces dw body (csrc/conv3_phase_pieces_dw.cuh) --

# bricks of block voxels: an even count of k16 steps (32 | P), at most
# PHASE_DW_MAX_ROWS (the halo-row table)
_PHASE_PIECES_BRICKS = [b for b in _PHASE_DW_BRICKS if b[0] * b[1] * b[2] % 32 == 0]
_PHASE_PIECES_WGMMA_CYCLES = 32  # an m64n32k16 with A from registers, as timed at N = 32


def phase_pieces_eligible(c: int, co: int) -> bool:
    """Channel counts the phase pieces dw body takes: Ci = Co = 8 (L = 64:
    p's (a'y, a'x, ci) lanes of one a'z are one wgmma N of 32)."""
    return c == co == 8


def phase_pieces_smem_bytes(td: int, th: int, tw: int, stages: int) -> int:
    """``phase_pieces_smem_bytes`` of ``csrc/conv3_phase_pieces_dw.cuh``: 1024
    bytes to align the base, 1024 of barriers and the halo-row table,
    ``stages`` slots of the p brick and the g halo (rounded to 1024)."""
    return 2048 + stages * (td * th * tw * 128
                            + _round1024((td + 2) * (th + 2) * (tw + 2) * 128))


@dataclasses.dataclass(frozen=True)
class PhasePiecesPlan:
    """Launch geometry of the phase pieces dw body, as the C entry point
    takes it: ``splits`` blocks (three warpgroups: the tz) walk the bricks
    ``split, split + splits, ...`` of ``td x th x tw`` block voxels through a
    ring of ``stages``; each writes four partials (a'y, a'x) that a second
    kernel sums in a fixed order."""

    td: int
    th: int
    tw: int
    splits: int
    stages: int
    smem_bytes: int
    workspace: int  # f32 values: 4 * splits * 27 * 64
    nbricks: int
    fill: float  # real block voxels / block voxels walked


def _phase_pieces_candidates(dims, sms: int):
    b, d, h, w = dims
    d, h, w = d // 2, h // 2, w // 2
    positions = b * d * h * w
    for td, th, tw in _PHASE_PIECES_BRICKS:
        p = td * th * tw
        nbricks = b * -(-d // td) * -(-h // th) * -(-w // tw)
        if nbricks >= 2 ** 31:
            continue
        fill = positions / (nbricks * p)
        stages = next((st for st in (4, 3, 2)
                       if phase_pieces_smem_bytes(td, th, tw, st) <= SMEM_LIMIT), None)
        if stages is None:
            continue
        # a brick of a block, in cycles: its 12 wgmma a k16 step, or its
        # staging (the p brick and the g halo) from the L2
        mma = 12 * (p // 16) * _PHASE_PIECES_WGMMA_CYCLES
        l2 = (p + (td + 2) * (th + 2) * (tw + 2)) * 128 / _L2_BYTES
        per_brick = max(mma, l2) + _MID_STEP_CYCLES
        splits = min(nbricks, sms)
        cycles = -(-nbricks // splits) * per_brick + 2500
        yield (fill < 0.7, stages < 3, cycles, -fill), PhasePiecesPlan(
            td=td, th=th, tw=tw, splits=splits, stages=stages,
            smem_bytes=phase_pieces_smem_bytes(td, th, tw, stages),
            workspace=4 * splits * 27 * 64, nbricks=nbricks, fill=fill)


@functools.lru_cache(maxsize=None)
def phase_pieces_plan(dims: Tuple[int, int, int, int], c: int, co: int,
                      sms: int = _SMS) -> PhasePiecesPlan:
    """The brick, ring and splits of one launch of the phase pieces dw body
    for a (B, D, H, W) grid of full-resolution positions (p and g hold (B, D
    / 2, H / 2, W / 2) block voxels): one block a multiprocessor (or one a
    brick) and, among bricks of 32 to 192 block voxels, the cheapest by a
    rough count of cycles on the busiest multiprocessor (each brick's wgmma or
    its staging from the L2), among those whose voxels are at least 70% real
    where any is, then among those with a ring of three or four slots where
    any has one. The ring takes as many slots (2-4) as fit."""
    if not phase_pieces_eligible(c, co):
        raise ValueError(f"the phase pieces dw body needs C = CO = 8, got C = {c}, CO = {co}")
    found = min(_phase_pieces_candidates(dims, sms), key=lambda kp: kp[0], default=None)
    if found is None:
        raise ValueError(f"no phase pieces dw launch plan for dims {dims}")
    return found[1]


# -- the register-tiled f32 bodies (csrc/conv3_f32.cuh, csrc/conv3_f32_dw.cuh) --

_F32_MAX_THREADS = 256  # F32_MAX_THREADS; __launch_bounds__(256, 2): 128 registers a thread
_F32_BRICKS = [b for b in itertools.product((1, 2, 3, 4, 6, 8), (1, 2, 3, 4, 6, 8, 16),
                                            (4, 8, 12, 16, 24, 32))
               if 16 <= b[0] * b[1] * b[2] <= 512]
# The cost counts' constants, fitted to the times of 20 candidates at each of
# eight rows on an H100 (PERF.md; forward / weight gradient): a
# scheduler issues one warp instruction a cycle at an efficiency that grows
# with the warps it can pick from (0.2 / 0.15 of full a warp; a forward
# tap's 32 FMAs and 8 / 3 loads count 1 / 1.25 of that), a block's resident
# neighbours share its multiprocessor, a unit or brick exposes 100 / 400
# cycles a resident block (its barriers, the transposition, the loads the
# ring does not hide), a block 3000 / 1000 more (its first loads and its
# stores), and the L2 feeds a multiprocessor 5 bytes a cycle when all of them
# stage.
_F32_WARP_EFF, _F32_DW_WARP_EFF = 0.2, 0.15
_F32_TAP_ISSUE = (32 + 8 / 3) / 1.25  # a forward thread's cycles a (channel, tap)
_F32_UNIT_CYCLES, _F32_DW_BRICK_CYCLES = 100, 400
_F32_L2_BYTES = 5
_F32_BLOCK_CYCLES, _F32_DW_BLOCK_CYCLES = 3000, 1000
_F32_SPLIT_CYCLES = 3000  # the second launch that sums the splits
F32_DW_CHAIN = 2048  # products an accumulator of the weight gradient sums at most


def f32_row_pitch(tw: int) -> int:
    """``f32_row_pitch``: floats between rows of the channel-major halo, at
    least tw + 2 and 4 mod 8."""
    return tw + 2 + (4 - (tw + 2) % 8) % 8


def f32_smem_bytes(td: int, th: int, tw: int, nt: int, ck: int, stages: int) -> int:
    """``f32_smem_bytes`` of ``csrc/conv3_f32.cuh``: ``stages`` ring slots of
    the staged halo ([td][th+2][tw+2][ck], ck rounded to 4) and the weight
    slab ([ck][9][nt]), then one channel-major halo and the table of the halo
    positions' (z, y, x), 4 bytes each."""
    npos = td * (th + 2) * (tw + 2)
    raw = npos * (-(-ck // 4) * 4)
    return 4 * (stages * (raw + ck * 9 * nt) + ck * td * (th + 2) * f32_row_pitch(tw)
                + -(-npos // 4) * 4)


@dataclasses.dataclass(frozen=True)
class F32Plan:
    """Launch geometry of the register-tiled f32 conv body, as the C entry
    point takes it. A block of ``threads`` threads (the brick's rows of 4 W
    positions x nt / 8 channel groups: a 4 x 8 tile a thread) owns a
    ``td x th x tw`` brick, an N tile of ``nt`` output channels and the K
    units (channel chunk of ``ck``, plane offset) ``[split * units // splits,
    (split + 1) * units // splits)``; grid (nbricks, n_tiles, splits)."""

    td: int
    th: int
    tw: int
    nt: int
    ck: int  # input channels a staged unit
    n_tiles: int
    nbricks: int
    units: int  # 3 plane offsets x channel chunks
    splits: int
    stages: int
    threads: int
    smem_bytes: int
    workspace: int  # f32 values of the partials: splits * positions * CO, 0 with one split
    fill: float  # real output positions / positions multiplied
    blocks: int


def _f32_per_sm(threads: int, smem: int) -> int:
    return min(_SM_SMEM // (smem + 1024), 2048 // threads, _SM_REGS // (threads * 128))


def _issue_cycles(warp_instr: float, warps_per_smsp: float, eff: float) -> float:
    """Cycles a scheduler takes for ``warps_per_smsp`` warps of
    ``warp_instr`` instructions each, at ``eff`` of full issue a warp."""
    return warp_instr * warps_per_smsp / min(1.0, eff * warps_per_smsp)


def _split_counts(n: int):
    return sorted({s for s in (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96) if s <= n} | {n})


def _f32_candidates(dims, c: int, co: int, sms: int):
    """Every (cost key, F32Plan) :func:`f32_plan` chooses among."""
    b, d, h, w = dims
    positions = b * d * h * w
    for nt in (16, 32, 64):
        if nt > 16 and nt >= 2 * co:
            continue  # a tile more than half padding columns
        n_tiles = -(-co // nt)
        if n_tiles > 65535:
            continue
        for td, th, tw in _F32_BRICKS:
            if tw % 4:
                continue
            threads = td * th * (tw // 4) * (nt // 8)
            if threads % 32 or not 128 <= threads <= _F32_MAX_THREADS:  # as timed
                continue
            nbricks = b * -(-d // td) * -(-h // th) * -(-w // tw)
            if nbricks >= 2 ** 31:
                continue
            fill = positions / (nbricks * td * th * tw)
            for ck in ((4, 8, 16) if c >= 4 else (c,)):  # 16-byte pieces: a power of two
                if ck >= 2 * c and ck > 4:
                    continue
                nch = -(-c // ck)
                units = 3 * nch
                stages = next((st for st in (3, 2) if _f32_per_sm(
                    threads, f32_smem_bytes(td, th, tw, nt, ck, st)) >= 1), None)
                if stages is None:
                    continue
                smem = f32_smem_bytes(td, th, tw, nt, ck, stages)
                per_sm = _f32_per_sm(threads, smem)
                staged = (td * (th + 2) * (tw + 2) + 9 * nt) * ck * 4
                for splits in _split_counts(units):
                    blocks = nbricks * n_tiles * splits
                    if splits > 65535:
                        continue
                    on_sm = -(-blocks // sms)
                    resident = min(on_sm, per_sm)
                    per_block = -(-units // splits)
                    # a unit of a block: its FFMA and shared loads, issued beside the
                    # other resident blocks, or its bytes from the L2
                    unit = max(_issue_cycles(9 * ck * _F32_TAP_ISSUE, resident * threads / 128,
                                             _F32_WARP_EFF),
                               resident * staged / _F32_L2_BYTES) + _F32_UNIT_CYCLES * resident
                    # blocks past a full round fill the next one
                    cycles = max(1.0, on_sm / per_sm) * (per_block * unit + _F32_BLOCK_CYCLES)
                    if splits > 1:
                        cycles += (2 * splits * 4 + 4) * positions * co / (sms * 32) \
                            + _F32_SPLIT_CYCLES
                    yield (cycles, -fill, splits), F32Plan(
                        td=td, th=th, tw=tw, nt=nt, ck=ck, n_tiles=n_tiles, nbricks=nbricks,
                        units=units, splits=splits, stages=stages, threads=threads,
                        smem_bytes=smem, workspace=splits * positions * co if splits > 1 else 0,
                        fill=fill, blocks=blocks)


@functools.lru_cache(maxsize=None)
def f32_plan(dims: Tuple[int, int, int, int], c: int, co: int, sms: int = _SMS) -> F32Plan:
    """The brick, N tile, channel chunk, ring and K splits of one launch of
    the register-tiled f32 conv body for a (B, D, H, W) grid of output
    positions (full resolution for the phase layout), C input and CO output
    channels.

    Among N tiles of 16, 32 or 64, the bricks of a fixed list that give a
    block 128-256 threads, chunks of
    4, 8 or 16 channels and a few split counts, it takes the cheapest by a
    rough count of cycles on the busiest of ``sms`` multiprocessors (each
    unit's FFMA issue beside the other resident blocks, or its bytes from the
    L2, plus the unit's exposed barriers and loads; for more than one split
    the partials and the second launch). The ring takes 3 slots where a block
    still fits, else 2."""
    if c < 1 or co < 1:
        raise ValueError(f"the f32 conv body needs C, CO >= 1, got C = {c}, CO = {co}")
    found = min(_f32_candidates(dims, c, co, sms), key=lambda kp: kp[0], default=None)
    if found is None:
        raise ValueError(f"no f32 launch plan for dims {dims}, C = {c}, CO = {co}")
    return found[1]


def f32_dw_ci_pitch(ci: int) -> int:
    """``f32_dw_ci_pitch``: floats between the staged halo's positions, ci
    rounded to 4 and an odd number of quads."""
    r = -(-ci // 4) * 4
    return r + 4 if r % 8 == 0 else r


def f32_dw_threads(taps: int, ci: int, nt: int, npg: int) -> int:
    return npg * -(-taps * ci // 8) * (nt // 8)


def f32_dw_smem_bytes(td: int, th: int, tw: int, taps: int, ci: int, nt: int, npg: int,
                      stages: int) -> int:
    """``f32_dw_smem_bytes`` of ``csrc/conv3_f32_dw.cuh``: the tables of the
    halo and brick positions' (z, y, x), then ``stages`` slots of the tap
    group's x halo and the dy brick ([p][nt + 4]), which the position groups'
    sum (threads x 64 floats) reuses; 4 bytes each."""
    p = td * th * tw
    nh = (td + (2 if taps == 27 else 0)) * (th + 2) * (tw + 2)
    ring = stages * (nh * f32_dw_ci_pitch(ci) + p * (nt + 4))
    red = f32_dw_threads(taps, ci, nt, npg) * 64 if npg > 1 else 0
    return 4 * (-(-nh // 4) * 4 + -(-p // 4) * 4 + max(ring, red))


@dataclasses.dataclass(frozen=True)
class F32DwPlan:
    """Launch geometry of the register-tiled f32 dw body, as the C entry
    point takes it. A block of ``threads`` threads (``npg`` position groups x
    the row groups of ``taps * ci`` (tap, ci) rows x nt / 8 channel groups)
    owns a tap group, a tile of ``ci`` input and one of ``nt`` output
    channels, and walks the bricks ``split, split + splits, ...``; grid
    (splits, n_tg * n_ci * n_co), the tap group fastest."""

    td: int
    th: int
    tw: int
    taps: int  # taps a block: 9 (one kz) or 27
    ci: int
    nt: int
    npg: int  # position groups a block
    n_tg: int
    n_ci: int
    n_co: int
    splits: int
    stages: int
    threads: int
    grid: Tuple[int, int]
    smem_bytes: int
    workspace: int  # f32 values: splits * 27 * C * CO, 0 with one split
    nbricks: int
    chain: int  # products an accumulator sums
    fill: float  # real positions / positions walked


_F32_DW_BRICKS = [b for b in itertools.product((1, 2, 3, 4, 6, 8), (2, 3, 4, 6, 8, 16),
                                               (4, 6, 8, 12, 16, 24, 32))
                  if 32 <= b[0] * b[1] * b[2] <= 512]


def _f32_dw_candidates(dims, c: int, co: int, sms: int):
    """Every (cost key, F32DwPlan) :func:`f32_dw_plan` chooses among."""
    b, d, h, w = dims
    positions = b * d * h * w
    n_out = 27 * c * co
    for taps in (27, 9):
        n_tg = 27 // taps
        for ci in ((4, 8, 16, 32, 64) if c >= 4 else (c,)):  # a power of two
            if ci >= 2 * c and ci > 4:
                continue
            rows = -(-taps * ci // 8)
            n_ci = -(-c // ci)
            for nt in (8, 16, 32, 64):
                if nt > 8 and nt >= 2 * co:
                    continue
                n_co = -(-co // nt)
                tiles = n_tg * n_ci * n_co
                if tiles > 65535:
                    continue
                for npg in (1, 2, 4, 8, 16, 32):
                    threads = f32_dw_threads(taps, ci, nt, npg)
                    if not 128 <= threads <= _F32_MAX_THREADS:  # as timed
                        continue
                    for td, th, tw in _F32_DW_BRICKS:
                        p = td * th * tw
                        if npg > td * th:  # a position group takes whole (z, y) rows
                            continue
                        nbricks = b * -(-d // td) * -(-h // th) * -(-w // tw)
                        fill = positions / (nbricks * p)
                        stages = next((st for st in (3, 2) if _f32_per_sm(
                            threads, f32_dw_smem_bytes(td, th, tw, taps, ci, nt, npg, st)) >= 1),
                                      None)
                        if stages is None:
                            continue
                        smem = f32_dw_smem_bytes(td, th, tw, taps, ci, nt, npg, stages)
                        per_sm = _f32_per_sm(threads, smem)
                        staged = ((td + (2 if taps == 27 else 0)) * (th + 2) * (tw + 2) * ci
                                  + p * nt) * 4
                        per_group = -(-td * th // npg) * tw
                        # a brick of a block: 64 FFMA and 4-10 loads a position of
                        # each thread, issued beside the other resident blocks, or its
                        # bytes from the L2, plus its exposed barrier and loads
                        instr = per_group * (64 + (6 if ci % 4 == 0 else 12))
                        for splits in sorted({1, 2, 4, 8, 16, 32, 64, 128, 256, 512}
                                             | {max(1, sms * per_sm // tiles)}):
                            if splits > nbricks:
                                continue
                            chain = -(-nbricks // splits) * per_group
                            if chain > F32_DW_CHAIN:
                                continue
                            blocks = tiles * splits
                            on_sm = -(-blocks // sms)
                            resident = min(on_sm, per_sm)
                            brick = max(_issue_cycles(instr, resident * threads / 128,
                                                      _F32_DW_WARP_EFF),
                                        resident * staged / _F32_L2_BYTES) \
                                + _F32_DW_BRICK_CYCLES * resident
                            cycles = max(1.0, on_sm / per_sm) * (
                                -(-nbricks // splits) * brick + _F32_DW_BLOCK_CYCLES)
                            if splits > 1:
                                cycles += 2 * splits * n_out * 4 / (sms * 32) + _F32_SPLIT_CYCLES
                            yield (cycles, -fill, splits), F32DwPlan(
                                td=td, th=th, tw=tw, taps=taps, ci=ci, nt=nt, npg=npg,
                                n_tg=n_tg, n_ci=n_ci, n_co=n_co, splits=splits, stages=stages,
                                threads=threads, grid=(splits, tiles), smem_bytes=smem,
                                workspace=splits * n_out if splits > 1 else 0, nbricks=nbricks,
                                chain=chain, fill=fill)


@functools.lru_cache(maxsize=None)
def f32_dw_plan(dims: Tuple[int, int, int, int], c: int, co: int, sms: int = _SMS) -> F32DwPlan:
    """The brick, tap group, channel tiles, position groups, ring and
    position splits of one launch of the register-tiled f32 dw body for a
    (B, D, H, W) grid of positions (full resolution for the phase layout), C
    input and CO output channels: among tap groups of 27 or 9 taps, tiles of
    4-64 input and 8-64 output channels, 1-32 position groups (128-256
    threads a block), the
    bricks of a fixed list and a few split counts that keep an accumulator's
    chain within ``F32_DW_CHAIN`` products, the cheapest by a rough count of
    cycles on the busiest of ``sms`` multiprocessors (each brick's FFMA issue
    beside the other resident blocks, or its bytes from the L2, plus its
    exposed barrier; for more than one split the partials and the second
    launch). The ring takes 3 slots where a block still fits, else 2."""
    if c < 1 or co < 1:
        raise ValueError(f"the f32 dw body needs C, CO >= 1, got C = {c}, CO = {co}")
    found = min(_f32_dw_candidates(dims, c, co, sms), key=lambda kp: kp[0], default=None)
    if found is None:
        raise ValueError(f"no f32 dw launch plan for dims {dims}, C = {c}, CO = {co}")
    return found[1]


def launch_conv3_dw(entry: str, x, dy, full_dims, c: int, co: int) -> torch.Tensor:
    """Shared launch of the two dw kernels (dense and phase layouts, ``entry``
    ``segk_fused_conv3_dw`` or ``segk_phase_conv3_dw``) on the body
    :func:`dw_body` names: ``entry + "_wgmma"`` (deep channels, dense only,
    :func:`deep_dw_plan`; counted by ``deep_dw_counter`` too), ``entry +
    "_mid"`` (mid channels, dense only, :func:`mid_dw_plan`; counted by
    ``mid_dw_counter`` too), ``entry + "_wgmma"`` (the phase layout's Hopper
    body, :func:`phase_dw_plan`; counted by ``phase_dw_counter`` too), ``entry +
    "_rows"`` (the dense Hopper body, dense only, :func:`dense_dw_plan`;
    counted by ``dense_dw_counter`` too), ``entry + "_pairs"`` (the dense pairs
    body, dense only, :func:`dense_pairs_plan`; counted by
    ``dense_pairs_counter`` too), ``entry + "_pieces"`` (the phase pieces body,
    phase only, :func:`phase_pieces_plan`; counted by ``phase_pieces_counter``
    too), ``entry + "_mma"`` (tensor cores,
    :func:`dw_plan`), ``entry + "_fewc"`` (few
    channels, :func:`fewc_dw_plan`) or ``entry + "_f32"`` (f32,
    :func:`f32_dw_plan`; counted by ``f32_dw_counter`` too). With more than
    one split the partials go to a workspace and a second kernel sums them in
    a fixed order."""
    for t, name in ((x, "x"), (dy, "dy")):
        _cuda.check_cuda(t, name)
    b, d, h, w = full_dims
    out = torch.empty((3, 3, 3, c, co), dtype=torch.float32, device=x.device)
    phase = entry == "segk_phase_conv3_dw"
    body = dw_body(x, c, co, phase)
    if d * h * w * max(c, co) >= 2 ** 31:  # the kernel's offsets inside a sample are 32-bit
        raise ValueError(f"one sample of {d}x{h}x{w} positions x {max(c, co)} channels "
                         "exceeds 2^31 values")
    if body == "f32_tiles":
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        p = f32_dw_plan((b, d, h, w), c, co, sms)
        ws = torch.empty(p.workspace, dtype=torch.float32, device=x.device) if p.splits > 1 \
            else out
        _cuda.launch(entry + "_f32", x.data_ptr(), dy.data_ptr(), ws.data_ptr(), out.data_ptr(),
                     b, d, h, w, c, co, int(x.dtype == torch.bfloat16), p.td, p.th, p.tw,
                     p.taps, p.ci, p.nt, p.npg, p.splits, p.stages, p.smem_bytes)
        f32_dw_counter.count += 1
        return out
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    if body == "deep_channels":
        if not (_aligned(x) and _aligned(dy)):
            raise ValueError("the deep-channel dw body reads x and dy by TMA: both must be "
                             "16-byte aligned")
        p = deep_dw_plan((b, d, h, w), c, co, sms)
        ws = torch.empty(p.workspace, dtype=torch.float32, device=x.device) if p.splits > 1 \
            else out
        _cuda.launch(entry + "_wgmma", x.data_ptr(), dy.data_ptr(), ws.data_ptr(),
                     out.data_ptr(), b, d, h, w, c, co, p.td, p.th, p.tw, p.nt, p.tpw, p.nwg,
                     p.splits, p.stages, p.smem_bytes)
        deep_dw_counter.count += 1
        return out
    if body == "mid_channels":
        if not (_aligned(x) and _aligned(dy)):
            raise ValueError("the mid-channel dw body reads x and dy by TMA: both must be "
                             "16-byte aligned")
        p = mid_dw_plan((b, d, h, w), c, co, sms)
        ws = torch.empty(p.workspace, dtype=torch.float32, device=x.device) if p.splits > 1 \
            else out
        _cuda.launch(entry + "_mid", x.data_ptr(), dy.data_ptr(), ws.data_ptr(), out.data_ptr(),
                     b, d, h, w, c, co, p.td, p.th, p.tw, p.tpw, p.nwg, p.splits, p.stages,
                     p.smem_bytes)
        mid_dw_counter.count += 1
        return out
    if body == "dense_rows":
        if not (_aligned(x) and _aligned(dy)):
            raise ValueError("the dense Hopper dw body reads x and dy by TMA: both must be "
                             "16-byte aligned")
        p = dense_dw_plan((b, d, h, w), c, co, sms)
        ws = torch.empty(p.workspace, dtype=torch.float32, device=x.device)
        _cuda.launch(entry + "_rows", x.data_ptr(), dy.data_ptr(), ws.data_ptr(), out.data_ptr(),
                     b, d, h, w, c, co, p.grid_x, p.stages, p.smem_bytes)
        dense_dw_counter.count += 1
        return out
    if body == "dense_pairs":
        if not (_aligned(x) and _aligned(dy)):
            raise ValueError("the dense pairs dw body reads x and dy by TMA: both must be "
                             "16-byte aligned")
        p = dense_pairs_plan((b, d, h, w), c, co, sms)
        ws = torch.empty(p.workspace, dtype=torch.float32, device=x.device)
        _cuda.launch(entry + "_pairs", x.data_ptr(), dy.data_ptr(), ws.data_ptr(),
                     out.data_ptr(), b, d, h, w, c, co, p.grid_x, p.stages, p.smem_bytes)
        dense_pairs_counter.count += 1
        return out
    if body == "phase_pieces":
        if not (_aligned(x) and _aligned(dy)):
            raise ValueError("the phase pieces dw body reads p and g by TMA: both must be "
                             "16-byte aligned")
        p = phase_pieces_plan((b, d, h, w), c, co, sms)
        ws = torch.empty(p.workspace, dtype=torch.float32, device=x.device)
        _cuda.launch(entry + "_pieces", x.data_ptr(), dy.data_ptr(), ws.data_ptr(),
                     out.data_ptr(), b, d, h, w, c, co, p.td, p.th, p.tw, p.splits, p.stages,
                     p.smem_bytes)
        phase_pieces_counter.count += 1
        return out
    if body == "phase_blocks":
        if not (_aligned(x) and _aligned(dy)):
            raise ValueError("the phase dw's Hopper body reads p and g by TMA: both must be "
                             "16-byte aligned")
        p = phase_dw_plan((b, d, h, w), c, co, sms)
        ws = torch.empty(p.workspace, dtype=torch.float32, device=x.device)
        _cuda.launch(entry + "_wgmma", x.data_ptr(), dy.data_ptr(), ws.data_ptr(), out.data_ptr(),
                     b, d, h, w, c, co, p.td, p.th, p.tw, p.tpw, p.nwg, p.splits, p.stages,
                     p.smem_bytes)
        phase_dw_counter.count += 1
        return out
    if body == "few_channels":
        p = fewc_dw_plan((b, d, h, w), c, co, phase, sms)
        ws = torch.empty(p.workspace, dtype=torch.float32, device=x.device) if p.grid_x > 1 \
            else out
        vec_x = int(_aligned(x) and (phase or (w * c) % 8 == 0))
        vec_dy = int(_aligned(dy) and co % 8 == 0)
        _cuda.launch(entry + "_fewc", x.data_ptr(), dy.data_ptr(), ws.data_ptr(),
                     out.data_ptr(), b, d, h, w, c, co, p.th, p.tw, p.seg, p.nt, p.grid_x,
                     p.smem_bytes, vec_x, vec_dy)
        return out
    p = dw_plan((b, d, h, w), c, co, sms)
    ws = torch.empty(p.workspace, dtype=torch.float32, device=x.device) if p.splits > 1 else out
    _cuda.launch(entry + "_mma", x.data_ptr(), dy.data_ptr(), ws.data_ptr(), out.data_ptr(),
                 b, d, h, w, c, co, p.td, p.th, p.tw, p.ck, p.nt, p.splits, p.stages,
                 p.smem_bytes)
    return out


def conv3d_dw(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Weight gradient of the stride-1 SAME 3^3 conv:
    ``dw[t, ci, co] = sum_{b,p} x[b, p+t-1, ci] * dy[b, p, co]``, f32
    accumulation and result (3, 3, 3, C, CO); x (B, D, H, W, C) and
    dy (B, D, H, W, CO) both f32 or both bf16 (or f64 on the CPU). On a CUDA
    device bf16 input with C >= 64 and CO >= 128 runs the deep-channel body,
    C = CO = 8 or 16 at the rule's volumes the dense Hopper body,
    C = CO = 32 at the rule's volumes the dense pairs body,
    C and CO multiples of 64 below that at a large enough volume the
    mid-channel body, other bf16 with C % 8 == 0 and CO % 8 == 0 the
    tensor-core body, bf16 with C = 1..7 the few-channel body, anything else
    the register-tiled f32 body (:func:`dw_body`)."""
    if x.ndim != 5 or dy.ndim != 5:
        raise ValueError(f"x and dy must be 5-D, got {tuple(x.shape)}, {tuple(dy.shape)}")
    check_dw_args(x, dy)
    if x.device.type == "cpu":
        return conv3d_dw_plain(x, dy)
    out = launch_conv3_dw("segk_fused_conv3_dw", x, dy, tuple(x.shape[:4]),
                          x.shape[-1], dy.shape[-1])
    dw_counter.count += 1
    return out


def flip_io(w: torch.Tensor) -> torch.Tensor:
    """Weights of the input gradient of a SAME stride-1 conv: spatial flip,
    in/out swap (``pallas_conv._packed_bwd``, ``phase_gemm._flip_io``)."""
    return w.flip(0, 1, 2).transpose(-1, -2).contiguous()


class _Conv3dGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        x, w = x.contiguous(), w.contiguous()
        ctx.save_for_backward(x, w)
        return conv3d(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = conv3d(dy, flip_io(w), out_dtype=x.dtype)
        if ctx.needs_input_grad[1]:
            dw = conv3d_dw(x, dy).to(w.dtype)
        return dx, dw


def conv3d_grad(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Differentiable stride-1 SAME 3^3 conv without epilogue (the port of
    ``pallas_conv.conv3d_packed``): x (B, D, H, W, C), w (3, 3, 3, C, CO) in
    x's dtype. Add the bias outside, as the JAX package does."""
    return _Conv3dGrad.apply(x, w)
