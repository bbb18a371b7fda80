"""Chip smoke test of the PyTorch port: build the CUDA kernels, check each
against its plain PyTorch version on the card, serve three volumes through
the port's HTTP server with the flagship UNet, check the folded forward on
the card against the plain CPU forward, then train: the weight-gradient
kernels and both autograd Functions against their plain versions, the
shear-group and phase-Dice kernels against theirs, ``train()`` with the
flagship defaults on synthetic phantoms, step time and learning on one fixed
batch, one f32 train step on the card against the CPU, and ``train()`` with
the device augmentation (margin patches, rotation + zoom, intensity ops) with
the augmentation's own time beside the augmented step, and ``train()`` driven
by ``preprocessing`` / ``augmentation`` config dicts (the host pipeline's
milliseconds a batch beside the step's); the two other architectures at full
width, SegResNet and UNETR: their new conv shapes on kernels 1 and 2, each
trained by ``train()``, stepped on a fixed batch, predicted with labels and
served, with every launch of the kernels counted, and one f32 train step of
each on the card against the f64 CPU step; ``train()`` with
``accumulate_steps``, ``remat``, the constant validation blend and a
``profile_dir``; 2D segmentation at the flagship's full width: ``train()``
and the warm step of the 2D UNet (plain and augmented) and of the 2D
SegResNet, one f32 step of each against the f64 CPU step, a 1024 x 1024
image served and a labelled one predicted, each held against the CPU
forward; then evaluate: ``predict()`` with labels and metrics on two
phantoms, ``ensemble_creator()`` in its three modes over three checkpoints,
and ``cross_validate()`` over two folds trained in subprocesses of the
port's CLI; a 512 x 512 x 896 host volume whose accumulators pass
8 GiB, which the sliding window streams from host memory by itself, held
against the in-memory path on the card; last, image-to-image translation at
the i2i CLI's width: ``train_pix2pix`` and ``train_cyclegan`` on slices of
synthetic T1-like / T2-like volumes (losses falling, the warm iteration's
time and peak), ``translate_volume`` with both checkpoints, one f32 pix2pix
iteration on the card against the f64 CPU iteration in 2D and in 3D (the 3D
generator's block convs on the register-tiled f32 bodies of kernels 1 and 2),
and those bodies at the 3D generator's f32 shapes, the flagship's f32
training shapes and f32 packed UNETR's input layer. The rest of the
single-device package runs at full
size beside them: the surface distances of the served labels through the
native distance transform (``[distance]``, after ``[parity]``), the
augmented step with the labels' composed-affine gather against the shear
chain (``[label-gather]``), the patch sampler's native crop with its bf16
wire against the numpy route (``[sampler]``), the landmark heat maps on the
card (``[detect]``), and the models' share of the bf16 peak from the FLOP
counts (``[flops]``). Last, Parallel: the weight-gradient, shear-group and
Dice kernels at a rank's shapes at two ranks (``[local-kernels]``), the
flagship's train step with a mesh at a world of one over NCCL against the
mesh-less step (``[parallel-dp]``), the window- and volume-sharded sliding
window against the in-memory path (``[parallel-sw]``), a pix2pix iteration
through the mesh path (``[parallel-i2i]``), and two ranks sharing the card
over gloo: the data-parallel step at a local batch of 4 against one rank at
8, ZeRO-1 against the replicated update and tensor parallelism against data
parallelism (``[parallel-dp-2]``; NCCL refuses two ranks on one device),
and the JAX package's multi-host rule on two torchrun nodes of one rank each
sharing the card over gloo: each node's sampler draws its own rows and the
f32 step on both nodes is held against one process on the nodes' rows
(``[parallel-nodes]``). UNETR runs its default, lane-packed graph: its
narrow regions in phase space on kernels 3-6 and its loss on the Dice
kernels; ``[unetr-pack]`` holds kernels 3-6 at its phase-space conv shapes
against their plain versions, times them beside their bounds and cuDNN, and
runs the packed step against the unpacked one, interleaved.

    python3 chip_smoke.py
    python3 chip_smoke.py --phases unetr-pack,unetr

Without ``--phases`` every phase runs, in the order of the table ``PHASES``;
with it, the named phases and the phases whose results they read.

Needs one CUDA device, ``nvcc`` and the repository checkout around this file.
Every phase raises on failure; the last line of standard output is
``{"ok": true, "device": {...}}`` only when all of them passed. Imports
nothing of JAX and nothing of the JAX package.

The line before the last lists every kernel with its launches on the driven
paths, its error and time against the plain version, the time of one PyTorch
library call for the same function where there is one, and ``bound_ms``: the
least time the card could take for the same work, the larger of the bytes the
function must move (inputs read once, outputs written once) over the memory
rate and its operations over the peak rate of their type (NVIDIA's H100 SXM
data sheet, dense).
"""

from __future__ import annotations

import functools
import gzip
import json
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

ROOT = Path(__file__).resolve().parent
NUM_CLASSES = 8
ROI = (96, 96, 96)
SW_BATCH = 4
# kernel -> (its CUDA source, the pl.pallas_call it replaces)
KERNELS = {
    "fused_conv": ("segmantic_tpu_torch/csrc/fused_conv.cu",
                   "segmantic_tpu/ops/pallas_conv.py:173"),
    "phase_conv": ("segmantic_tpu_torch/csrc/phase_conv.cu",
                   "segmantic_tpu/ops/phase_gemm.py:266,327"),
    "blend": ("segmantic_tpu_torch/csrc/blend.cu",
              "segmantic_tpu/ops/pallas_blend.py:115"),
    "fused_conv_dw": ("segmantic_tpu_torch/csrc/fused_conv_dw.cu",
                      "segmantic_tpu/ops/pallas_conv.py:289"),
    "phase_conv_dw": ("segmantic_tpu_torch/csrc/phase_conv_dw.cu",
                      "segmantic_tpu/ops/phase_gemm.py:430,518"),
    "shear_group": ("segmantic_tpu_torch/csrc/shear_group.cu",
                    "exp/fused_shear_pallas.py:144"),
    "dice_phase_sums": ("segmantic_tpu_torch/csrc/phase_dice.cu",
                        "exp/pallas_dice_ab.py:110"),
    "dice_phase_dx": ("segmantic_tpu_torch/csrc/phase_dice.cu",
                      "exp/pallas_dice_ab.py:181"),
    # the deep-channel bodies of kernels 1 and 2 (bf16, C, CO >= 64), on their
    # own lines beside the kernels' totals above, which include them
    "fused_conv_wgmma": ("segmantic_tpu_torch/csrc/conv3_wgmma.cuh",
                         "segmantic_tpu/ops/pallas_conv.py:173"),
    "fused_conv_dw_wgmma": ("segmantic_tpu_torch/csrc/conv3_dw_wgmma.cuh",
                            "segmantic_tpu/ops/pallas_conv.py:289"),
    # the register-tiled f32 bodies of kernels 1-6 (f32 input and bf16 channel
    # counts no tensor-core body takes), beside the kernels' totals, which
    # include them
    "conv3_f32": ("segmantic_tpu_torch/csrc/conv3_f32.cuh",
                  "segmantic_tpu/ops/pallas_conv.py:173"),
    "conv3_f32_dw": ("segmantic_tpu_torch/csrc/conv3_f32_dw.cuh",
                     "segmantic_tpu/ops/pallas_conv.py:289"),
}
# the flagship's convs on the deep-channel bodies: 5 a forward (a step twice
# that, the input gradients) and 3 weight gradients a step (the dw body's rule
# takes CO >= 128)
FLAGSHIP_DEEP, FLAGSHIP_DEEP_DW = 5, 3
# published peaks of one H100 SXM (dense): memory bytes/s, FLOP/s by type
HBM_BYTES_PER_S = 3.35e12
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
MARGIN_PATCH = (144, 144, 144)  # 96 + 2 * (96 // 4), what the sampler crops
DICE_EXTENT = 48  # the phase grid of a 96^3 patch
TRAIN_PATCH = (96, 96, 96)
TRAIN_BATCH = 8  # batch_size 2 x num_samples 4, the train() defaults
DEVICE = "cuda"  # the evaluation phases' device (a CPU rehearsal sets "cpu")
EVAL_SHAPE = (256, 256, 176)  # the evaluation phases' phantoms, a head MRI's grid
EVAL_KERNELS = ("fused_conv", "phase_conv", "blend")  # the eval forward's and the blend
CLASS_NAMES = {"Background": 0, **{f"tissue{k}": k for k in range(1, 8)}}
CV_SIZE = 128
CV_SCENARIO = {"num_classes": 8, "max_epochs": 1, "device": "cuda"}  # flagship defaults
TRAIN_2D_PATCH = (256, 256)  # the 2D flagship's patch
TRAIN_2D_BATCH = 16
PHANTOM_2D = (512, 512)  # the 2D training phantoms
EVAL_2D_SHAPE = (1024, 1024)  # the 2D image served and predicted
SW_BATCH_2D = 16
STREAM_SHAPE = (512, 512, 896)  # a whole-body CT: 235 M voxels, 9.4 GB of accumulators
STREAM_SW_BATCH = 16
I2I_BASE, I2I_BLOCKS, I2I_BATCH = 64, 6, 16  # the i2i CLI's defaults
I2I_SLICE = 256  # the i2i volumes' in-plane size: 256^2 slices along axis 2
I2I_DEPTHS = (150, 144)  # two T1-like / T2-like pairs
I2I_STEPS = 20  # pix2pix iterations
I2I_CG_STEPS = 5  # CycleGAN iterations
I2I_PARITY_3D = 32  # the 3D parity generator's cube
# NIfTI-1 datatype codes
_NIFTI_DTYPES = {2: "u1", 4: "<i2", 8: "<i4", 16: "<f4", 64: "<f8", 256: "i1",
                 512: "<u2", 768: "<u4", 1024: "<i8"}


def _fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def _median_ms(torch, fn, n: int = 10, warmup: int = 3) -> float:
    """Median of ``n`` timed calls (CUDA events), after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _graph_ms(torch, fn, n: int = 10, launches: int = 10, warmup: int = 3) -> float:
    """Device time of one call of ``fn``: ``launches`` calls captured in one
    CUDA graph, median over ``n`` replays (CUDA events) per call. No host gap
    lies between the kernels, so a call that takes the card less time than its
    Python wrapper takes the host is still timed on the card; every kernel the
    call launches counts. The inputs stay in the L2 cache between replays
    (timed warm, as on the path, where the layer before has just written them)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    return _median_ms(torch, graph.replay, n=n, warmup=warmup) / launches


def _record(results, name, *, err, ms, plain_ms, nbytes, ops, peak, library_ms=None,
            echo=True):
    """Add one timed shape of kernel ``name`` to ``results``: times and bounds
    sum over a kernel's shapes, the error is the largest. ``nbytes``: every
    input read once and every output written once; ``ops``: floating-point
    operations on these inputs, at ``peak`` FLOP/s."""
    r = results.setdefault(name, {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                                  "bound_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0,
                                  "library_ms": None})
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / peak * 1e3
    r["max_abs_err"] = max(r["max_abs_err"], err)
    r["ms"] += ms
    r["plain_ms"] += plain_ms
    r["bound_ms"] += max(bytes_ms, ops_ms)
    r["bytes_ms"] += bytes_ms
    r["ops_ms"] += ops_ms
    if library_ms is not None:
        r["library_ms"] = (r["library_ms"] or 0.0) + library_ms
    if echo:
        print(f"    bound {max(bytes_ms, ops_ms):.4f} ms ({nbytes / 1e6:.1f} MB -> {bytes_ms:.4f}"
              f" ms, {ops / 1e9:.2f} GFLOP -> {ops_ms:.4f} ms)")


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def conv_body_text(x, c: int, co: int, dims, phase: bool, sms: int):
    """(body, text with its launch plan, tile fill) of the conv kernel on
    input x of a conv over c to co channels, full-resolution ``dims``."""
    from segmantic_tpu_torch.ops import fused_conv

    body = fused_conv.conv_body(x, c, co, phase)
    if body == "deep_channels":
        p = fused_conv.deep_plan(dims, c, co, 2, sms)
        return body, (f"deep-channel body (wgmma): brick {p.td}x{p.th}x{p.tw}, {p.nwg} "
                      f"warpgroups of {p.spw} m64 slab(s), N tile {p.nt}, {p.nbricks} bricks x "
                      f"{p.n_tiles} N "
                      f"tiles x {p.splits} K splits = {p.blocks} blocks, ring of {p.stages}, "
                      f"tile fill {p.fill:.3f}, "
                      f"{'one launch' if p.splits == 1 else 'kernel + reduce'}"), p.fill
    if body == "tensor_cores":
        p = fused_conv.plan(dims, c, co, 2, sms)
        return body, (f"tensor-core body: brick {p.td}x{p.th}x{p.tw} in {p.warps} warps, N tile "
                      f"{p.nt}, {p.nbricks} bricks x {p.n_tiles} N tiles, tile fill "
                      f"{p.fill:.3f}"), p.fill
    if body == "few_channels":
        p = fused_conv.fewc_plan(dims, c, co, phase, sms)
        return body, (f"few-channel body: plane tile {p.th}x{p.tw} ({p.rows} positions a "
                      f"step), {p.nitems} items of {p.seg} planes over {p.grid_x} blocks x "
                      f"{p.n_tiles} N tiles of {p.nt}, tile fill {p.fill:.3f}"), p.fill
    p = fused_conv.f32_plan(dims, c, co, sms)
    return body, (f"f32 body: 4x8 tiles, brick {p.td}x{p.th}x{p.tw} in "
                  f"{p.threads} threads, N tile {p.nt}, {p.nbricks} bricks x {p.n_tiles} N "
                  f"tiles x {p.splits} K splits of {p.units} units (ck {p.ck}) = {p.blocks} "
                  f"blocks, ring of {p.stages}, tile fill {p.fill:.3f}, "
                  f"{'one launch' if p.splits == 1 else 'kernel + reduce'}"), p.fill


def dw_body_text(x, c: int, co: int, dims, phase: bool, sms: int):
    """(body, text with its launch plan, K fill) of the dw kernel on input x
    of a conv over c to co channels, full-resolution ``dims``."""
    from segmantic_tpu_torch.ops import fused_conv

    body = fused_conv.dw_body(x, c, co, phase)
    if body == "deep_channels":
        p = fused_conv.deep_dw_plan(dims, c, co, sms)
        return body, (f"deep-channel body (wgmma): brick {p.td}x{p.th}x{p.tw}, N tile {p.nt}, "
                      f"{p.nwg * p.tpw} taps a block of {p.nwg} warpgroups, {p.splits} splits, "
                      f"{p.grid[0] * p.grid[1]} "
                      f"blocks, ring of {p.stages}, K fill {p.fill:.3f}, workspace "
                      f"{p.workspace * 4 / 1e6:.2f} MB, "
                      f"{'one launch' if p.splits == 1 else 'kernel + reduce'}"), p.fill
    if body == "tensor_cores":
        p = fused_conv.dw_plan(dims, c, co, sms)
        return body, (f"tensor-core body: brick {p.td}x{p.th}x{p.tw}, CK x NT {p.ck}x{p.nt}, "
                      f"{p.splits} splits, {p.grid[0] * p.grid[1]} blocks of {p.warps} warps, "
                      f"K fill {p.fill:.3f}, workspace {p.workspace * 4 / 1e6:.2f} MB, "
                      f"{'one launch' if p.splits == 1 else 'kernel + reduce'}"), p.fill
    if body == "few_channels":
        p = fused_conv.fewc_dw_plan(dims, c, co, phase, sms)
        return body, (f"few-channel body: plane tile {p.th}x{p.tw} ({p.rows} positions a "
                      f"step), {p.nitems} items of {p.seg} planes over {p.grid_x} splits x "
                      f"{p.n_tiles} N tiles of {p.nt}, K fill {p.fill:.3f}, "
                      f"{'one launch' if p.grid_x == 1 else 'kernel + reduce'}"), p.fill
    p = fused_conv.f32_dw_plan(dims, c, co, sms)
    return body, (f"f32 body: brick {p.td}x{p.th}x{p.tw}, {p.taps} taps x {p.ci} ci x {p.nt} "
                  f"co a block of {p.threads} threads ({p.npg} position groups), {p.splits} "
                  f"splits, {p.grid[0] * p.grid[1]} blocks, ring of {p.stages}, chain "
                  f"{p.chain}, K fill {p.fill:.3f}, workspace {p.workspace * 4 / 1e6:.2f} MB, "
                  f"{'one launch' if p.splits == 1 else 'kernel + reduce'}"), p.fill


def tensor_core_conv_ms(torch, x, w) -> float:
    """Device ms of the tensor-core conv body (``conv3_mma.cuh``, what kernel 1
    ran at every bf16 C % 8 == 0 shape before the deep-channel body) on the
    same tensors, called through its C entry point with its own plan; no
    epilogue, bf16 out."""
    from segmantic_tpu_torch.ops import _cuda, fused_conv

    b, d, h, w_ = x.shape[:4]
    c, co = w.shape[-2:]
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    p = fused_conv.plan((b, d, h, w_), c, co, 2, sms)
    packed = fused_conv.pack_weights(w, p.nt)
    s, t = fused_conv._epilogue_vectors(co, None, None, None, x.device)
    out = torch.empty((b, d, h, w_, co), dtype=torch.bfloat16, device=x.device)
    return _graph_ms(torch, lambda: _cuda.launch(
        "segk_fused_conv3_mma", x.data_ptr(), packed.data_ptr(), s.data_ptr(), t.data_ptr(),
        None, 0, out.data_ptr(), b, d, h, w_, c, co, 1, p.td, p.th, p.tw, p.warps, p.nt, p.ck,
        p.stages, int(p.resident), p.grid_x, p.smem_bytes))


def tensor_core_dw_ms(torch, x, dy) -> float:
    """Device ms of the tensor-core dw body (``conv3_dw_mma.cuh``) on the same
    tensors, called through its C entry point with its own plan (and its
    reduce launch)."""
    from segmantic_tpu_torch.ops import _cuda, fused_conv

    b, d, h, w_ = x.shape[:4]
    c, co = x.shape[-1], dy.shape[-1]
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    p = fused_conv.dw_plan((b, d, h, w_), c, co, sms)
    ws = torch.empty(max(p.workspace, 1), dtype=torch.float32, device=x.device)
    out = torch.empty((3, 3, 3, c, co), dtype=torch.float32, device=x.device)
    return _graph_ms(torch, lambda: _cuda.launch(
        "segk_fused_conv3_dw_mma", x.data_ptr(), dy.data_ptr(), ws.data_ptr(), out.data_ptr(),
        b, d, h, w_, c, co, p.td, p.th, p.tw, p.ck, p.nt, p.splits, p.stages, p.smem_bytes))


def deep_dw_entry_ms(torch, x, dy):
    """(max|d| over max|ref|, device ms) of the deep-channel dw body
    (``conv3_dw_wgmma.cuh``) on the same tensors, called through its C entry
    point with its own plan: the row's time on the new body where the rule
    (CO >= 128) keeps the tensor-core body."""
    from segmantic_tpu_torch.ops import _cuda, fused_conv

    b, d, h, w_ = x.shape[:4]
    c, co = x.shape[-1], dy.shape[-1]
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    p = fused_conv.deep_dw_plan((b, d, h, w_), c, co, sms)
    ws = torch.empty(max(p.workspace, 1), dtype=torch.float32, device=x.device)
    out = torch.empty((3, 3, 3, c, co), dtype=torch.float32, device=x.device)

    def run():
        _cuda.launch("segk_fused_conv3_dw_wgmma", x.data_ptr(), dy.data_ptr(), ws.data_ptr(),
                     out.data_ptr(), b, d, h, w_, c, co, p.td, p.th, p.tw, p.nt, p.tpw, p.nwg,
                     p.splits, p.stages, p.smem_bytes)

    run()
    want = fused_conv.conv3d_dw_plain(x, dy)
    torch.cuda.synchronize()
    rel = ((out - want).abs().max() / want.abs().max()).item()
    return rel, _graph_ms(torch, run)


def check_kernels(torch):
    """Each kernel against its plain version at the serving path's shapes.

    Returns {kernel: {"max_abs_err", "ms", "plain_ms", "bound_ms", ...}} with
    times and bounds summed over the kernel's shapes (bf16, the serving dtype)
    and the largest bf16 error; the blend's cases are :func:`check_blend`'s. The library call beside the convs is cuDNN's
    bf16 ``conv3d`` (bias only, no scale/shift/PReLU epilogue; for the phase
    conv on the depth-to-space tensor, the rearrangement not timed). The convs
    are timed by CUDA-graph replay (``_graph_ms``): on tensor cores a call
    takes the card less time than its wrapper takes the host. Each bf16 conv
    shape also prints its launch plan with the tile fill (>= 0.75 or the phase
    fails) and repeats its launch bit for bit; ragged and odd-channel shapes
    run once each, untimed."""
    import torch.nn.functional as F

    from segmantic_tpu_torch.ops import fused_conv, phase_conv
    from segmantic_tpu_torch.ops.fast_conv import depth_to_space

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(dev)

    results = {}

    def cudnn_conv_ms(x, w, bias=None):
        """cuDNN's conv3d on channel-last x (B, D, H, W, C), w (3, 3, 3, C, CO)."""
        xc = x.permute(0, 4, 1, 2, 3)
        wc = w.permute(4, 3, 0, 1, 2).contiguous(memory_format=torch.channels_last_3d)
        return _graph_ms(torch, lambda: F.conv3d(xc, wc, bias, padding=1))

    def compare(name, label, kernel, plain, dtype):
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        ref = want.float().abs().max().item()
        tol = (2e-2 if dtype == torch.bfloat16 else 1e-4) * ref
        ok = err <= tol
        print(f"  {name} {label} {str(dtype)[6:]}: max|d| {err:.3e} "
              f"(limit {tol:.3e} = {'2e-2' if dtype == torch.bfloat16 else '1e-4'}"
              f" * max|ref| {ref:.3e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            _fail(f"{name} {label} {dtype} disagrees with its plain version")
        return err

    def fill_of(dims, c, co):
        p = fused_conv.plan(dims, c, co, 2, sms)
        return (f"brick {p.td}x{p.th}x{p.tw} in {p.warps} warps, N tile {p.nt}, "
                f"{p.nbricks} bricks x {p.n_tiles} N tiles, tile fill {p.fill:.3f}"), p.fill

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    bf16 = torch.bfloat16
    # the six stride-1 3^3 convs of one 4 x 96^3 window batch of the flagship UNet
    dense_shapes = [((4, 48, 48, 48, 16), 16), ((4, 24, 24, 24, 32), 32),
                    ((4, 12, 12, 12, 64), 64), ((4, 6, 6, 6, 128), 128),
                    ((4, 6, 6, 6, 128), 256), ((4, 6, 6, 6, 256), 256)]
    for shape, co in dense_shapes:
        label = f"x{tuple(shape)}->{co}"
        for dtype in (torch.float32, bf16):
            x = randn(*shape).to(dtype)
            w = randn(3, 3, 3, shape[-1], co, scale=(27 * shape[-1]) ** -0.5).to(dtype)
            kw = dict(bias=randn(co, scale=0.1), scale=randn(co).abs() + 0.5,
                      shift=randn(co, scale=0.1), alpha=torch.tensor([0.25], device=dev),
                      relu_mode="prelu")
            cache = {}  # the packed weights, kept as the executor keeps them
            k = lambda: fused_conv.conv3d(x, w, packed_cache=cache, **kw)  # noqa: E731
            p = lambda: fused_conv.conv3d_plain(x, w, **kw)  # noqa: E731
            err = compare("fused_conv", label, k, p, dtype)
            if dtype == bf16:
                if not torch.equal(k(), k()):
                    _fail(f"fused_conv {label}: a repeated bf16 launch is not bit-equal")
                body, plan_text, fill = conv_body_text(x, shape[-1], co, tuple(shape[:4]),
                                                       False, sms)
                ms, pms = _graph_ms(torch, k), _graph_ms(torch, p)
                lms = cudnn_conv_ms(x, w, kw["bias"].to(dtype))
                print(f"    bf16, repeated launch bit-equal; {plan_text}")
                print(f"    bf16 time (CUDA graph replay, L2 warm): kernel {ms:.4f} ms, "
                      f"plain {pms:.4f} ms, cuDNN conv3d + bias {lms:.4f} ms")
                if body == "deep_channels":
                    print(f"    the tensor-core body (conv3_mma.cuh) on the same tensors: "
                          f"{tensor_core_conv_ms(torch, x, w):.4f} ms")
                if fill < 0.75:
                    _fail(f"fused_conv {label}: tile fill {fill:.3f} < 0.75")
                positions = x.numel() // shape[-1]
                for name in ("fused_conv",) + (("fused_conv_wgmma",)
                                               if body == "deep_channels" else ()):
                    _record(results, name, err=err, ms=ms, plain_ms=pms,
                            nbytes=_nbytes(x, w, k(),
                                           *(v for v in kw.values() if torch.is_tensor(v))),
                            ops=2 * 27 * shape[-1] * co * positions, peak=PEAK_BF16,
                            library_ms=lms, echo=name == "fused_conv")

    for shape, c in [((4, 48, 48, 48, 64), 8), ((4, 24, 24, 24, 128), 16)]:
        label = f"p{tuple(shape)} C={c}"
        for dtype in (torch.float32, bf16):
            p_in = randn(*shape).to(dtype)
            w = randn(3, 3, 3, c, c, scale=(27 * c) ** -0.5).to(dtype)
            cache = {}
            k = lambda: phase_conv.phase_conv(p_in, w, packed_cache=cache)  # noqa: E731
            p = lambda: phase_conv.phase_conv_plain(p_in, w)  # noqa: E731
            err = compare("phase_conv", label, k, p, dtype)
            if dtype == bf16:
                if not torch.equal(k(), k()):
                    _fail(f"phase_conv {label}: a repeated bf16 launch is not bit-equal")
                full = (shape[0],) + tuple(2 * v for v in shape[1:4])
                plan_text, fill = fill_of(full, c, c)
                # the plain version uploads its selection tensor: not capturable,
                # and long enough (> 1 ms) that the host does not pace it
                ms, pms = _graph_ms(torch, k), _median_ms(torch, p)
                lms = cudnn_conv_ms(depth_to_space(p_in, c), w)
                print(f"    bf16, repeated launch bit-equal; {plan_text}")
                print(f"    bf16 time (CUDA graph replay, L2 warm): kernel {ms:.4f} ms, "
                      f"cuDNN conv3d at full resolution {lms:.4f} ms; plain {pms:.4f} ms "
                      f"(eager calls)")
                if fill < 0.75:
                    _fail(f"phase_conv {label}: tile fill {fill:.3f} < 0.75")
                _record(results, "phase_conv", err=err, ms=ms, plain_ms=pms,
                        nbytes=_nbytes(p_in, w, p_in),  # the output has the input's shape
                        ops=2 * 27 * c * c * (p_in.numel() // c), peak=PEAK_BF16,
                        library_ms=lms)

    # ragged shapes, untimed: extents that are a multiple of no brick, CO = 5
    # (scalar stores), C = 24 (a chunk padded to 32), C = 12 (no 16-byte
    # channel vector above 8: the f32 body), bf16 -> f32 output, and
    # bf16 with C = 1, 2, 3, 7 (no 16-byte channel vector: the few-channel body
    # by the wrapper's rule; W * C whole 16-byte pieces or not) and CO = 1 (a
    # one-class UNet's 1 -> 1 top stage) in both layouts, each one launch
    for name, shape, c, co in [("fused_conv", (2, 5, 7, 9, 64), 64, 192),
                               ("fused_conv", (2, 5, 7, 9, 96), 96, 72),
                               ("fused_conv", (1, 6, 6, 6, 72), 72, 64),
                               ("fused_conv", (2, 20, 22, 26, 24), 24, 5),
                               ("fused_conv", (2, 20, 22, 26, 16), 16, 8),
                               ("fused_conv", (2, 5, 7, 9, 3), 3, 5),
                               ("fused_conv", (2, 5, 7, 9, 12), 12, 5),
                               ("fused_conv", (2, 5, 7, 9, 1), 1, 8),
                               ("fused_conv", (2, 6, 10, 32, 2), 2, 16),
                               ("fused_conv", (1, 4, 6, 17, 7), 7, 24),
                               ("fused_conv", (2, 5, 7, 16, 1), 1, 1),
                               ("phase_conv", (2, 10, 11, 13, 8 * 24), 24, 5),
                               ("phase_conv", (1, 5, 7, 9, 8 * 8), 8, 16),
                               ("phase_conv", (1, 3, 4, 5, 8 * 3), 3, 3),
                               ("phase_conv", (1, 3, 4, 5, 8 * 12), 12, 5),
                               ("phase_conv", (2, 3, 4, 5, 8), 1, 16),
                               ("phase_conv", (1, 3, 4, 8, 8 * 2), 2, 8),
                               ("phase_conv", (1, 2, 3, 4, 8 * 7), 7, 5),
                               ("phase_conv", (1, 3, 4, 5, 8), 1, 1)]:
        x = randn(*shape).to(bf16)
        w = randn(3, 3, 3, c, co, scale=(27 * c) ** -0.5).to(bf16)
        kw = dict(bias=randn(co, scale=0.1), scale=randn(co).abs() + 0.5,
                  shift=randn(co, scale=0.1), alpha=torch.tensor([0.25], device=dev),
                  relu_mode="prelu")
        mod, fn, plain = ((fused_conv, fused_conv.conv3d, fused_conv.conv3d_plain)
                          if name == "fused_conv"
                          else (phase_conv, phase_conv.phase_conv, phase_conv.phase_conv_plain))
        body = fused_conv.conv_body(x, c, co, name == "phase_conv")
        if body != ("few_channels" if c < 8 else
                    "deep_channels" if name == "fused_conv" and min(c, co) >= 64 else
                    "tensor_cores" if c % 8 == 0 else "f32_tiles"):
            _fail(f"{name} ragged {shape}: the rule sends C = {c} to the {body} body")
        for out_dtype in (bf16, torch.float32):
            before = mod.counter.count
            compare(name, f"ragged {tuple(shape)} C={c}->{co} out {str(out_dtype)[6:]} "
                          f"({body} body)",
                    lambda: fn(x, w, out_dtype=out_dtype, **kw),
                    lambda: plain(x, w, out_dtype=out_dtype, **kw), bf16)
            if mod.counter.count != before + 1:
                _fail(f"{name} ragged {shape}: expected one launch")
            if body in ("few_channels", "deep_channels", "f32_tiles") and not torch.equal(
                    fn(x, w, out_dtype=out_dtype, **kw), fn(x, w, out_dtype=out_dtype, **kw)):
                _fail(f"{name} ragged {shape}: a repeated launch is not bit-equal")

    check_blend(torch, results)
    return results


def check_blend(torch, results) -> None:
    """The blend kernel against the sequential loop, bit for bit: the smoke's
    chunk (the first 4 windows of the 256 x 256 x 176 grid, 8 classes), its
    first 16 windows (one sw-batch-16 chunk), the last chunk of the 200 x 168 x
    150 grid (every window snapped to an edge) whole and one window short, 5
    and 3 classes (the scalar route), 40 windows (two launches of at most
    ``MAX_WINDOWS``), and the weight map in the same pass. Each case fills the
    accumulator outside the windows' union with a sentinel that must survive,
    repeats its launch bit for bit and counts its launches. The 4- and
    16-window chunks are timed by CUDA-graph replay (which also shows that a
    call uploads nothing), kernel and plain, each beside the bound of its own
    union; the recorded entry is the 4-window chunk."""
    import numpy as np

    from segmantic_tpu_torch.infer.sliding_window import window_starts
    from segmantic_tpu_torch.ops import _cuda, blend

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(21)
    for classes in (NUM_CLASSES, 5):
        vec, block = blend.launch_shape(classes)
        threads = block[0] * block[1] * block[2]
        resident = _cuda.query("segk_blend_blocks_per_sm", vec, threads)
        print(f"  blend {'float4' if vec == 4 else 'scalar'} route ({classes} classes): block "
              f"{block} = {threads} threads, {resident} resident blocks per SM "
              f"({resident * threads // 32} warps), {blend.ROWS} independent loads a thread "
              f"before the first use")
        if resident < 2:
            _fail("the blend kernel leaves fewer than two resident blocks per SM")
    head, lps = (256, 256, 176), (200, 168, 150)
    head_starts = np.asarray(window_starts(head, ROI, 0.25))
    lps_starts = np.asarray(window_starts(lps, ROI, 0.25))
    sentinel = 12345.0
    cases = [  # (label, volume, starts, classes, timed)
        ("the served chunk", head, head_starts[:SW_BATCH], NUM_CLASSES, True),
        ("a 16-window chunk", head, head_starts[:16], NUM_CLASSES, True),
        ("last chunk of the 200x168x150 grid", lps, lps_starts[-4:], NUM_CLASSES, False),
        ("a short last chunk", lps, lps_starts[-3:], NUM_CLASSES, False),
        ("5 classes", lps, lps_starts[-4:], 5, False),
        ("3 classes", lps, lps_starts[-4:], 3, False),
        ("40 windows", head, head_starts[:40], NUM_CLASSES, False),
    ]
    imp = torch.rand(ROI, generator=g).to(dev)
    for label, volume, starts, classes, timed in cases:
        covered = torch.zeros(volume, dtype=torch.bool, device=dev)
        for s in starts:
            covered[tuple(slice(int(a), int(a) + r) for a, r in zip(s, ROI))] = True
        acc0 = torch.randn((*volume, classes), generator=g).to(dev)
        acc0[~covered] = sentinel
        logits = torch.randn((len(starts), *ROI, classes), generator=g).to(dev)
        vec, block = blend.launch_shape(classes)
        plan = blend.union_tiles(starts[:blend.MAX_WINDOWS], ROI, (blend.ROWS, block[2], block[1]))
        before = blend.counter.count
        got = blend.accumulate_windows(acc0.clone(), logits, imp, starts)
        launches = blend.counter.count - before
        want = blend.accumulate_windows_plain(acc0.clone(), logits, imp, starts)
        again = blend.accumulate_windows(acc0.clone(), logits, imp, starts)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        exact = torch.equal(got, want)
        outside = bool((got[~covered] == sentinel).all())
        repeat = torch.equal(got, again)
        ok = exact and outside and repeat and launches == -(-len(starts) // blend.MAX_WINDOWS)
        print(f"  blend {label}: acc{tuple(acc0.shape)}, {len(starts)} windows, "
              f"{'float4' if vec == 4 else 'scalar'} route, block {block}, "
              f"{len(plan.tiles)} of {int(np.prod(plan.grid))} tiles of "
              f"{plan.tile} in the union{' (first launch)' if launches > 1 else ''}, "
              f"{launches} launch{'es' if launches > 1 else ''}: bit-equal {exact} (max|d| "
              f"{err}), outside the union untouched {outside}, repeated launch bit-equal "
              f"{repeat} {'ok' if ok else 'FAIL'}")
        if not ok:
            _fail(f"blend {label} differs from its plain version")
        if not timed:
            continue
        acc = acc0.clone()
        ms = _graph_ms(torch, lambda: blend.accumulate_windows(acc, logits, imp, starts))
        pms = _graph_ms(torch, lambda: blend.accumulate_windows_plain(acc, logits, imp, starts),
                        launches=3)
        # the accumulator is read and written only where a window lies
        nbytes = _nbytes(logits, imp) + 2 * int(covered.sum().item()) * classes * 4
        print(f"    time (CUDA graph replay, L2 warm): kernel {ms:.4f} ms, plain {pms:.4f} ms; "
              f"union {int(covered.sum().item())} voxels")
        into = results if len(starts) == SW_BATCH else {}
        _record(into, "blend", err=err, ms=ms, plain_ms=pms, nbytes=nbytes,
                ops=2 * logits.numel(), peak=PEAK_F32)

    # the weight map in the same pass, at the served chunk
    starts = head_starts[:SW_BATCH]
    acc0 = torch.randn((*head, NUM_CLASSES), generator=g).to(dev)
    wacc0 = torch.rand((*head, 1), generator=g).to(dev)
    logits = torch.randn((SW_BATCH, *ROI, NUM_CLASSES), generator=g).to(dev)
    got, got_w = acc0.clone(), wacc0.clone()
    want, want_w = acc0.clone(), wacc0.clone()
    blend.accumulate_windows(got, logits, imp, starts, got_w)
    blend.accumulate_windows_plain(want, logits, imp, starts, want_w)
    torch.cuda.synchronize()
    ok = torch.equal(got, want) and torch.equal(got_w, want_w)
    ms = _graph_ms(torch, lambda: blend.accumulate_windows(got, logits, imp, starts, got_w))
    pms = _graph_ms(torch, lambda: blend.accumulate_windows_plain(want, logits, imp, starts,
                                                                  want_w))
    print(f"  blend with the weight map in the same pass: acc and wacc bit-equal {ok}; kernel "
          f"{ms:.4f} ms, plain (8 slice-adds) {pms:.4f} ms {'ok' if ok else 'FAIL'}")
    if not ok:
        _fail("blend with the weight map differs from its plain version")


def _ptxas_reports(lib: Path, name: str):
    """[(the "Compiling entry function" line, registers, stack bytes, spill
    bytes)] of every instantiation of kernel ``name``, from the build log
    beside the library; fails when the log holds none."""
    import re

    log = lib.with_name(lib.stem + ".log")
    lines = log.read_text().splitlines() if log.exists() else []
    found = []
    for i, line in enumerate(lines):
        if "Compiling entry function" not in line or name not in line:
            continue
        text = " ".join(lines[i + 1: i + 4])
        regs = re.search(r"Used (\d+) registers", text)
        stack = re.search(r"(\d+) bytes stack frame", text)
        found.append((line, int(regs.group(1)) if regs else -1,
                      int(stack.group(1)) if stack else 0,
                      sum(map(int, re.findall(r"(\d+) bytes spill", text)))))
    if not found:
        _fail(f"the build log holds no ptxas report for {name}")
    return found


def report_kernel_build(lib: Path, name: str) -> None:
    """ptxas' registers, stack and spills of every instantiation of kernel
    ``name``; spills fail."""
    import re

    found = _ptxas_reports(lib, name)
    args = [m.group(1) if (m := re.search(name + r"I(.*?)EEv", line)) else ""
            for line, _, _, _ in found]
    print(f"  ptxas, {name}: {len(found)} instantiations, registers "
          f"{min(f[1] for f in found)}-{max(f[1] for f in found)}, stack bytes "
          f"{max(f[2] for f in found)}, spill bytes {sum(f[3] for f in found)}; "
          + ", ".join(f"{a}:{f[1]}" for a, f in zip(args, found)))
    if sum(f[3] for f in found):
        _fail(f"{name} spills registers")


def report_dice_sass(lib: Path) -> None:
    """The SASS instruction counts of the flagship instantiations (bf16, 8
    class lanes) of the two Dice kernels, from the toolkit's ``cuobjdump``:
    all instructions of the function (the sums' round of four voxels, its
    one-voxel tail and its epilogue; dx's one voxel), and those of the
    special-function unit (MUFU: the exponentials and the reciprocal).
    Fails where the counts cannot be read."""
    import shutil

    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(cuobjdump).exists():
        _fail("cuobjdump not found: the Dice kernels' SASS cannot be counted")
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                          timeout=300).stdout
    names = ("dice_sums_kernelI13__nv_bfloat16Li8E", "dice_dx_kernelI13__nv_bfloat16Li8E")
    counts = {name: [0, 0] for name in names}
    inside = None
    for line in sass.splitlines():
        if "Function :" in line:
            inside = next((name for name in names if name in line), None)
        elif inside and "/*" in line and ";" in line:  # an instruction line
            counts[inside][0] += 1
            counts[inside][1] += " MUFU." in line
    for name, (total, mufu) in counts.items():
        print(f"  SASS of {name.split('I13')[0]}<bf16, 8>: {total} instructions in the "
              f"function, {mufu} MUFU")
        if not total or not mufu:
            _fail(f"no SASS of {name} in the library")


def report_conv_build(lib: Path) -> None:
    """What ptxas reports for the tensor-core kernels (the conv bodies
    ``conv3_mma_kernel`` and ``conv3_fewc_kernel``, the weight-gradient bodies
    ``conv3_dw_mma_kernel`` and ``conv3_fewc_dw_kernel``: registers and
    spills per instantiation, from the build log beside the library) and,
    where the toolkit has ``cuobjdump``, how many tensor-core (HMMA),
    ``ldmatrix`` (LDSM) and asynchronous copy (LDGSTS) opcodes their SASS
    holds. Spills fail nothing; a kernel without HMMA does."""
    import re
    import shutil

    names = ("conv3_mma_kernel", "conv3_dw_mma_kernel", "conv3_fewc_kernel",
             "conv3_fewc_dw_kernel")
    for name in names:
        found = []
        for line, regs, _, spill in _ptxas_reports(lib, name):
            m = re.search(name + r".*?(Dense|Phase)LayoutELi(\d+)ELi(\d+)", line)
            if m:
                found.append((m.group(1).lower(), int(m.group(2)), int(m.group(3)), regs, spill))
        params = "C, NT" if "fewc" in name else "CK, NT"
        print(f"  ptxas, {name}<layout, {params}>: {len(found)} instantiations, registers "
              f"{min(f[3] for f in found)}-{max(f[3] for f in found)}, spill bytes "
              f"{sum(f[4] for f in found)}, shared memory dynamic (the plan's smem_bytes); "
              + ", ".join(f"{lay[0]}{ck}x{nt}:{regs}" for lay, ck, nt, regs, _ in sorted(found)))
    deep = ("conv3_wgmma_kernel", "conv3_dw_wgmma_kernel")
    for name in deep:  # the deep-channel bodies: <NT, SPW, NWG> and <NT, TPW, NWG>
        found = set()  # a header's kernel is reported by each source that compiles it
        for line, regs, _, spill in _ptxas_reports(lib, name):
            m = re.search(name + r"ILi(\d+)ELi(\d+)ELi(\d+)", line)
            if m:
                found.add((int(m.group(1)), int(m.group(2)), int(m.group(3)), regs, spill))
        print(f"  ptxas, {name}<NT, {'TPW' if 'dw' in name else 'SPW'}, NWG>: {len(found)} "
              f"instantiations, registers {min(f[3] for f in found)}-{max(f[3] for f in found)}"
              f", spill bytes {sum(f[4] for f in found)}; "
              + ", ".join(f"{nt}x{k}x{g}:{regs}" for nt, k, g, regs, _ in sorted(found)))
    f32 = ("conv3_f32_kernel", "conv3_f32_dw_kernel")
    for name in f32:  # <Tin, Tout, Layout, PW> and <Tin, Layout, RV>
        found = {(line.split("'")[1] if "'" in line else line, regs, spill)
                 for line, regs, _, spill in _ptxas_reports(lib, name)}
        print(f"  ptxas, {name}: {len(found)} instantiations, registers "
              f"{min(f[1] for f in found)}-{max(f[1] for f in found)} (128 at most: two blocks of "
              f"256 threads a multiprocessor), spill bytes {sum(f[2] for f in found)}"
              + "".join(f"; {spill} in {inst[:90]}" for inst, _, spill in sorted(found) if spill))
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(cuobjdump).exists():
        print("  cuobjdump not found: SASS not inspected")
        return
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                          timeout=300).stdout
    f32_counts = {name: {"FFMA": 0, "LDGSTS": 0, "LDS.128": 0} for name in f32}
    inside = None
    for line in sass.splitlines():
        if "Function :" in line:
            inside = next((name for name in f32 if name in line), None)
        elif inside:
            for key in f32_counts[inside]:
                if f" {key}" in line:
                    f32_counts[inside][key] += 1
    for name, c in f32_counts.items():
        print(f"  SASS of the {name} instantiations: {c['FFMA']} FFMA, {c['LDGSTS']} LDGSTS "
              f"(cp.async), {c['LDS.128']} LDS.128")
        if not c["FFMA"] or not c["LDGSTS"] or not c["LDS.128"]:
            _fail(f"{name} holds no FFMA, no LDGSTS or no LDS.128 opcode")
    deep_counts = {name: {"HGMMA": 0, "LDSM": 0, "UTMALDG": 0, "UBLKCP": 0} for name in deep}
    inside = None
    for line in sass.splitlines():
        if "Function :" in line:
            inside = next((name for name in deep if name in line), None)
        elif inside:
            for key in deep_counts[inside]:
                if f" {key}." in line or f" {key} " in line:
                    deep_counts[inside][key] += 1
    for name, c in deep_counts.items():
        print(f"  SASS of the {name} instantiations: {c['HGMMA']} HGMMA (wgmma), {c['LDSM']} "
              f"LDSM (ldmatrix), {c['UTMALDG']} UTMALDG (TMA), {c['UBLKCP']} UBLKCP (bulk copy)")
        if not c["HGMMA"] or not c["LDSM"] or not c["UTMALDG"]:
            _fail(f"{name} holds no HGMMA, no LDSM or no UTMALDG opcode")
    counts = {name: {"HMMA": 0, "LDSM": 0, "LDGSTS": 0} for name in names}
    inside = None
    for line in sass.splitlines():
        if "Function :" in line:
            inside = next((name for name in names if name in line), None)
        elif inside:
            for key in counts[inside]:
                if f" {key}." in line or f" {key} " in line:
                    counts[inside][key] += 1
    for name, c in counts.items():
        print(f"  SASS of the {name} instantiations: {c['HMMA']} HMMA (tensor-core mma), "
              f"{c['LDSM']} LDSM (ldmatrix), {c['LDGSTS']} LDGSTS (cp.async)")
        if not c["HMMA"] or not c["LDSM"] or not c["LDGSTS"]:
            _fail(f"{name} holds no HMMA, no LDSM or no LDGSTS opcode")


def _deep_counters():
    """The deep-channel bodies' own counters (their launches also count in
    kernel 1's and 2's): read by the paths that run deep convs on purpose."""
    from segmantic_tpu_torch.ops import fused_conv

    return {"fused_conv_wgmma": fused_conv.deep_counter,
            "fused_conv_dw_wgmma": fused_conv.deep_dw_counter}


def _f32_counters():
    """The f32 bodies' own counters (their launches also count in kernels
    1-6's): read by the paths that run f32 convs."""
    from segmantic_tpu_torch.ops import fused_conv

    return {"conv3_f32": fused_conv.f32_counter, "conv3_f32_dw": fused_conv.f32_dw_counter}


def _counters():
    from segmantic_tpu_torch.ops import blend, fused_conv, fused_shear, phase_conv, phase_dice

    return {"fused_conv": fused_conv.counter, "phase_conv": phase_conv.counter,
            "blend": blend.counter, "fused_conv_dw": fused_conv.dw_counter,
            "phase_conv_dw": phase_conv.dw_counter, "shear_group": fused_shear.counter,
            "dice_phase_sums": phase_dice.sums_counter,
            "dice_phase_dx": phase_dice.dx_counter}


def check_deep_dx(torch, results, arch: str, x_shape, co: int, g, per_step: int) -> None:
    """The input gradient of a deep conv x_shape -> co: ``conv3d(dy,
    flip_io(w))``, a conv co -> C on the deep-channel body, against its plain
    version (2e-2 * max|ref|), bit-equal on repeat, timed beside the
    tensor-core body and cuDNN's bf16 dgrad (``conv3d_input``); recorded as
    kernel 1 and its deep body."""
    from segmantic_tpu_torch.ops import fused_conv

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    c = x_shape[-1]
    dy = torch.randn((*x_shape[:4], co), generator=g, device=g.device).to(dev, bf16)
    w = (torch.randn((3, 3, 3, c, co), generator=g, device=g.device)
         * (27 * c) ** -0.5).to(dev, bf16)
    wf = fused_conv.flip_io(w)
    label = f"{arch} dx of x{tuple(x_shape)}->{co}: dy{tuple(dy.shape)}->{c} ({per_step} a step)"
    body, text, fill = conv_body_text(dy, co, c, tuple(x_shape[:4]), False, sms)
    if body != "deep_channels":
        _fail(f"fused_conv {label}: the rule sends it to the {body} body")
    before = fused_conv.deep_counter.count
    cache = {}  # the packed weights, packed once: the kernel's time alone
    k = lambda: fused_conv.conv3d(dy, wf, packed_cache=cache)  # noqa: E731
    pl = lambda: fused_conv.conv3d_plain(dy, wf)  # noqa: E731
    got, want = k(), pl()
    torch.cuda.synchronize()
    if fused_conv.deep_counter.count != before + 1:
        _fail(f"fused_conv {label}: not one launch of the deep-channel body")
    err = (got.float() - want.float()).abs().max().item()
    ref = want.float().abs().max().item()
    print(f"  fused_conv {label}: max|d| {err:.3e} (limit {2e-2 * ref:.3e} = 2e-2 * max|ref| "
          f"{ref:.3e}) {'ok' if err <= 2e-2 * ref else 'FAIL'}")
    if err > 2e-2 * ref:
        _fail(f"fused_conv {label} disagrees with its plain version")
    if not torch.equal(got, k()):
        _fail(f"fused_conv {label}: a repeated launch is not bit-equal")
    xs = (x_shape[0], c, *x_shape[1:4])
    dyc = dy.permute(0, 4, 1, 2, 3)
    wc = w.permute(4, 3, 0, 1, 2).contiguous()
    ms, pms = _graph_ms(torch, k), _graph_ms(torch, pl)
    lms = _graph_ms(torch, lambda: torch.nn.grad.conv3d_input(xs, wc, dyc, padding=1))
    oms = tensor_core_conv_ms(torch, dy, wf)
    print(f"    {text}; bit-equal on repeat; kernel {ms:.4f} ms, tensor-core body {oms:.4f} "
          f"ms, plain {pms:.4f} ms, cuDNN bf16 dgrad {lms:.4f} ms")
    if fill < 0.75:
        _fail(f"fused_conv {label}: tile fill {fill:.3f} < 0.75")
    for name in ("fused_conv", "fused_conv_wgmma"):
        _record(results, name, err=err, ms=ms, plain_ms=pms, nbytes=_nbytes(dy, w, got),
                ops=2 * 27 * c * co * (dy.numel() // co), peak=PEAK_BF16, library_ms=lms,
                echo=name == "fused_conv")


def check_train_kernels(torch):
    """The two weight-gradient kernels and both autograd Functions against
    their plain versions at the train step's shapes (batch 8), f32 and bf16.

    Every dw shape of one flagship step: the six distinct dense ones (eight
    launches: 24^3 x 32 and 12^3 x 64 run in the encoder and in the decoder)
    and both phase stages. bf16 goes through the tensor-core body
    (``csrc/conv3_dw_mma.cuh``), f32 through the register-tiled f32 body
    (``csrc/conv3_f32_dw.cuh``).

    Limits: the dw kernels 1e-3 * max|ref| in f32 and with bf16 inputs (sums
    over up to 7 M positions in another order, TF32 off; with bf16 inputs
    both sides sum the same exactly upcast values in f32); the autograd
    Functions 1e-3 in f32 and 2e-2 in bf16 (their output and dx round to
    bf16). Each bf16 shape prints its launch plan and repeats its launch bit
    for bit. Times are device times by CUDA-graph replay (``_graph_ms``; the
    workspace comes from the graph's pool): the kernel, the plain version
    (cuDNN's f32 wgrad on the upcast inputs, TF32 off) and the library
    call, cuDNN's bf16 wgrad on the bf16 tensors (at full resolution for the
    phase kernel, the rearrangement not timed). Returns
    {kernel: {"max_abs_err", "ms", "plain_ms", "bound_ms", ...}}, times summed
    over the distinct shapes and the largest bf16 error. Ragged and
    odd-channel shapes run once each, untimed."""
    from segmantic_tpu_torch.ops import fused_conv, phase_conv
    from segmantic_tpu_torch.ops.fast_conv import depth_to_space

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(5)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    bf16 = torch.bfloat16

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(dev)

    def compare(name, got, want, dtype, limit):
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        ref = want.float().abs().max().item()
        tol = limit * ref
        ok = err <= tol
        print(f"  {name} {str(dtype)[6:]}: max|d| {err:.3e} (limit {tol:.3e} = "
              f"{limit:g} * max|ref| {ref:.3e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            _fail(f"{name} {dtype} disagrees with its plain version")
        return err

    def modules(name):
        if name == "fused_conv_dw":
            return fused_conv, fused_conv.conv3d_dw, fused_conv.conv3d_dw_plain
        return phase_conv, phase_conv.phase_conv_dw, phase_conv.phase_conv_dw_plain

    def geometry(name, x, dy):
        """(full-resolution dims, true C, true CO) of one dw call."""
        if name == "fused_conv_dw":
            return tuple(x.shape[:4]), x.shape[-1], dy.shape[-1]
        full = (x.shape[0],) + tuple(2 * v for v in x.shape[1:4])
        return full, x.shape[-1] // 8, dy.shape[-1] // 8

    results = {}
    B = TRAIN_BATCH
    # (kernel, stored shape of x, stored channels of dy, launches per step)
    cases = [
        ("fused_conv_dw", (B, 48, 48, 48, 16), 16, 1),
        ("fused_conv_dw", (B, 24, 24, 24, 32), 32, 2),
        ("fused_conv_dw", (B, 12, 12, 12, 64), 64, 2),
        ("fused_conv_dw", (B, 6, 6, 6, 128), 128, 1),
        ("fused_conv_dw", (B, 6, 6, 6, 128), 256, 1),
        ("fused_conv_dw", (B, 6, 6, 6, 256), 256, 1),
        ("phase_conv_dw", (B, 48, 48, 48, 64), 64, 1),  # L = 64: 96^3 x 8 -> 8
        ("phase_conv_dw", (B, 24, 24, 24, 128), 128, 1),  # L = 128: 48^3 x 16 -> 16
    ]
    for name, x_shape, co, per_step in cases:
        mod, kernel, plain = modules(name)
        x32 = randn(*x_shape)
        dy32 = randn(*x_shape[:4], co)
        dims, c_true, co_true = geometry(name, x32, dy32)
        label = (f"x{x_shape}->{co}" if name == "fused_conv_dw"
                 else f"p{x_shape} C={c_true}") + f" ({per_step} per step)"
        deep = name == "fused_conv_dw" and c_true >= 64 and co_true >= 128
        for dtype in (torch.float32, bf16):
            x, dy = x32.to(dtype), dy32.to(dtype)
            want_body = ("f32_tiles" if dtype != bf16 else
                         "deep_channels" if deep else "tensor_cores")
            if fused_conv.dw_body(x, c_true, co_true, name == "phase_conv_dw") != want_body:
                _fail(f"{name} {label}: the rule sends {dtype} to the wrong body")
            before = mod.dw_counter.count
            got = kernel(x, dy)
            if mod.dw_counter.count != before + 1:
                _fail(f"{name} {label}: expected one counted launch")
            err = compare(f"{name} {label}", got, plain(x, dy), dtype, 1e-3)
        if not torch.equal(got, kernel(x, dy)):
            _fail(f"{name} {label}: a repeated bf16 launch is not bit-equal")
        _, text, fill = dw_body_text(x, c_true, co_true, dims, name == "phase_conv_dw", sms)
        print(f"    bf16, repeated launch bit-equal; {text}")
        if fill < 0.75:
            _fail(f"{name} {label}: K fill {fill:.3f} < 0.75")
        ms = _graph_ms(torch, lambda: kernel(x, dy))
        # the plain f32 wgrad takes up to ~0.1 s at the top stages: fewer replays
        slow = x.numel() > 2 ** 25
        pms = _graph_ms(torch, lambda: plain(x, dy), n=3 if slow else 10,
                        launches=1 if slow else 10)
        # the library call, not the plain version: cuDNN's wgrad straight on the
        # bf16 (full-resolution) tensors, tensor cores allowed, output in bf16
        if name == "fused_conv_dw":
            xc, dyc = x, dy
        else:
            xc, dyc = depth_to_space(x, c_true), depth_to_space(dy, co_true)
        cms = _graph_ms(torch, lambda: torch.nn.grad.conv3d_weight(
            xc.permute(0, 4, 1, 2, 3), (co_true, c_true, 3, 3, 3),
            dyc.permute(0, 4, 1, 2, 3), padding=1))
        print(f"    bf16 time (CUDA graph replay, L2 warm): kernel {ms:.4f} ms, plain (f32) "
              f"{pms:.4f} ms, cuDNN bf16 wgrad {cms:.4f} ms")
        if deep:
            print(f"    the tensor-core body (conv3_dw_mma.cuh) on the same tensors: "
                  f"{tensor_core_dw_ms(torch, x, dy):.4f} ms")
        elif name == "fused_conv_dw" and min(c_true, co_true) >= 64:
            rel, dms = deep_dw_entry_ms(torch, x, dy)
            print(f"    the deep-channel body (conv3_dw_wgmma.cuh, left out by the rule at CO < "
                  f"128) on the same tensors: {dms:.4f} ms, max|d| / max|ref| {rel:.2e}")
            if rel > 1e-3:
                _fail(f"{name} {label}: the deep-channel body disagrees")
        for rec in (name,) + (("fused_conv_dw_wgmma",) if deep else ()):
            _record(results, rec, err=err, ms=ms, plain_ms=pms, nbytes=_nbytes(x, dy, got),
                    ops=2 * 27 * c_true * co_true * (xc.numel() // c_true), peak=PEAK_BF16,
                    library_ms=cms, echo=rec == name)

    # the input gradient of the flagship's one CI != CO deep conv (128 -> 256 at
    # 6^3): the conv 256 -> 128 with flipped weights, on the deep-channel body
    check_deep_dx(torch, results, "flagship", (B, 6, 6, 6, 128), 256, g, 1)

    # odd shapes, untimed, bf16: extents that are a multiple of no brick; CO = 24
    # (a padded or a third N tile); C = 12 and CO = 20 (no 16-byte channel vector:
    # the f32 body by the rule); one brick, so one split and no reduce
    # launch; a phase shape with ragged full-resolution bricks; C = 1, 2, 7 and a
    # 1 -> 1 weight gradient in both layouts (the few-channel body, any CO; CO
    # % 8 != 0 staged value by value)
    odd = [("fused_conv_dw", (2, 5, 7, 9, 64), 192), ("fused_conv_dw", (2, 5, 7, 9, 96), 72),
           ("fused_conv_dw", (1, 6, 6, 6, 72), 64),
           ("fused_conv_dw", (2, 20, 22, 26, 16), 16), ("fused_conv_dw", (2, 10, 11, 13, 16), 24),
           ("fused_conv_dw", (2, 10, 11, 13, 12), 16), ("fused_conv_dw", (2, 5, 7, 9, 16), 20),
           ("fused_conv_dw", (1, 6, 6, 6, 8), 8), ("phase_conv_dw", (1, 5, 7, 9, 8 * 8), 8 * 16),
           ("phase_conv_dw", (2, 10, 11, 13, 8 * 24), 8 * 8),
           ("fused_conv_dw", (2, 5, 7, 9, 1), 8), ("fused_conv_dw", (2, 6, 10, 32, 2), 16),
           ("fused_conv_dw", (1, 4, 6, 17, 7), 24), ("fused_conv_dw", (2, 5, 7, 16, 1), 1),
           ("phase_conv_dw", (2, 3, 4, 5, 8), 8 * 16), ("phase_conv_dw", (1, 3, 4, 8, 8 * 2), 8 * 8),
           ("phase_conv_dw", (1, 2, 3, 4, 8 * 7), 8 * 5), ("phase_conv_dw", (1, 3, 4, 5, 8), 8)]
    for name, x_shape, co in odd:
        mod, kernel, plain = modules(name)
        x, dy = randn(*x_shape).to(bf16), randn(*x_shape[:4], co).to(bf16)
        dims, c_true, co_true = geometry(name, x, dy)
        body, text, _ = dw_body_text(x, c_true, co_true, dims, name == "phase_conv_dw", sms)
        want_body = ("few_channels" if c_true < 8 else "deep_channels"
                     if name == "fused_conv_dw" and c_true >= 64 and co_true >= 128
                     else "tensor_cores"
                     if c_true % 8 == 0 and co_true % 8 == 0 else "f32_tiles")
        if body != want_body:
            _fail(f"{name} {x_shape}->{co}: the rule between the bodies")
        before = mod.dw_counter.count
        got = kernel(x, dy)
        compare(f"{name} odd {x_shape} C={c_true}->{co_true} ({text})", got, plain(x, dy),
                bf16, 1e-3)
        if mod.dw_counter.count != before + 1 or not torch.equal(got, kernel(x, dy)):
            _fail(f"{name} odd {x_shape}: one counted launch, bit-equal on repeat")
    if fused_conv.dw_plan((1, 6, 6, 6), 8, 8, sms).splits != 1:
        _fail("a single brick should take one split (no reduce launch)")

    def grads(fn, *args):
        args = [a.detach().clone().requires_grad_() for a in args]
        out = fn(*args)
        out.backward(torch.ones_like(out) * 0.01 + 0.1 * out.detach().sin())
        return [out] + [a.grad for a in args]

    functions = [
        ("conv3d_grad", fused_conv.conv3d_grad, fused_conv.conv3d_plain,
         (TRAIN_BATCH, 24, 24, 24, 32), (3, 3, 3, 32, 32)),
        ("phase_conv_grad", phase_conv.phase_conv_grad, phase_conv.phase_conv_plain,
         (TRAIN_BATCH, 24, 24, 24, 128), (3, 3, 3, 16, 16)),
    ]
    for name, fn, plain, x_shape, w_shape in functions:
        x32 = randn(*x_shape)
        w32 = randn(*w_shape, scale=(27 * w_shape[3]) ** -0.5)
        for dtype in (torch.float32, torch.bfloat16):
            got = grads(fn, x32.to(dtype), w32.to(dtype))
            want = grads(plain, x32.to(dtype), w32.to(dtype))
            for part, a, b in zip(("out", "dx", "dw"), got, want):
                compare(f"{name} {part} x{x_shape}", a, b, dtype,
                        2e-2 if dtype == torch.bfloat16 else 1e-3)
    return results


def check_aug_kernels(torch):
    """``shear_group`` against ``shear_group_plain`` for the three rotation
    groups of the flagship chain (144^3 margin patches to 96^3, rotations up
    to 0.4 rad, zoom from 0.8), 5 samples with distinct angles and zooms: order
    1 on bf16 with bf16 weights and order 0 on uint8 labels must equal the
    plain version bit for bit (two products and one sum have no order to
    differ in), order 1 in f32 within 1e-6 * max|ref| (the plain version's
    matrix product may fuse the multiply and add). Each group takes the
    plain version's output of the group before it, prints its launch plan
    beside the resident blocks per SM the card counts for it (at least two,
    or the phase fails) and repeats its launch bit for bit. Times are device
    times by CUDA-graph replay for the kernel (its wrapper takes the host as
    long as the kernel takes the card) and eager calls for the plain version
    (milliseconds long). The recorded time is one step's six launches: the
    bf16 image groups and the uint8 label groups. The 2D flagship's group
    (16 x 1 x 384^2 to 256^2: bf16 order 1 with its plane in global scratch,
    uint8 order 0) is held bit-equal too and timed, printed apart from that
    row. Ragged, odd, 2D and int32 shapes (and one with lines beyond a warp's
    registers) run once, untimed."""
    from segmantic_tpu_torch.ops import _cuda, fused_shear, shear_resample

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(7)
    samples = 5  # round(0.59 * 8): the subset the default probabilities give
    passes, divz, extents, groups = shear_resample.chain_plan(
        MARGIN_PATCH, 3, TRAIN_PATCH, 0.4, 0.8)
    angles = (torch.rand((samples, 3), generator=g) * 0.8 - 0.4).to(dev)
    zoom = torch.linspace(0.8, 1.3, samples).to(dev)
    coef = shear_resample.shear_coefficients(angles, zoom, passes, divz)
    print(f"  chain {[p[0] for p in passes]}, output extents {extents}")
    x32 = torch.randn((samples, 1, *MARGIN_PATCH), generator=g).to(dev)
    labels = torch.randint(0, NUM_CLASSES, (samples, 1, *MARGIN_PATCH), generator=g,
                           dtype=torch.uint8).to(dev)
    dtype_code = {torch.float32: 0, torch.bfloat16: 1, torch.uint8: 2, torch.int32: 3}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def plan_text(x, a_axis, b_axis, specs, order):
        p = fused_shear.group_plan(tuple(x.shape[2:]), a_axis, b_axis, tuple(specs), x.dtype,
                                   x.shape[0] * x.shape[1], x.data_ptr() % 16 == 0, sms)
        if p.global_plane:
            card = _cuda.query("segk_shear_group_global_blocks_per_sm", dtype_code[x.dtype],
                               order, p.threads, p.smem_bytes)
        else:
            card = _cuda.query("segk_shear_group_blocks_per_sm", dtype_code[x.dtype], p.wc,
                               p.cp, order, p.threads, p.smem_bytes)
        where = f"global scratch ({p.global_bytes} B)" if p.global_plane else "shared memory"
        text = (f"{p.cp} plane{'s' if p.cp > 1 else ''} {p.passes[0]}x{p.passes[1]} in {where}, "
                f"rows of {p.row_units} units of {p.unit_bytes} B (wc {p.wc}), "
                f"{p.smem_bytes} B shared, "
                f"{p.threads} threads, "
                f"{'a block' if p.block_lines else 'a warp'} per line, grid {p.grid}, 16-byte "
                f"rows in {p.vec_in} out {p.vec_out}, blocks per SM: plan {p.blocks_per_sm}, "
                f"card {card}")
        return p, card, text

    results = {}
    for label, x, order, bf16, timed in (("bf16 order 1", x32.bfloat16(), 1, True, True),
                                         ("f32 order 1", x32, 1, False, False),
                                         ("u8 order 0", labels, 0, False, True)):
        for gi, (a_axis, b_axis, specs) in enumerate(groups):
            c = coef[:, 3 * gi: 3 * gi + 3].contiguous()
            k = lambda: fused_shear.shear_group(  # noqa: E731
                x, a_axis, b_axis, c, zoom, specs, order, bf16)
            p = lambda: fused_shear.shear_group_plain(  # noqa: E731
                x, a_axis, b_axis, c, zoom, specs, order, bf16)
            got, want = k(), p()
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            ref = want.float().abs().max().item()
            exact = torch.equal(got, want)
            repeat = torch.equal(got, k())
            ok = (exact if (order == 0 or bf16) else err <= 1e-6 * ref) and repeat
            plan, card, text = plan_text(x, a_axis, b_axis, specs, order)
            ms, pms = _graph_ms(torch, k), _median_ms(torch, p)
            print(f"  shear_group {label} group {gi} plane ({a_axis},{b_axis}) "
                  f"{tuple(x.shape)} -> {tuple(got.shape)}: max|d| {err:.3e} of max|ref| "
                  f"{ref:.3e}, bit-equal {exact} "
                  f"(limit {'bit-equal' if order == 0 or bf16 else '1e-6 * max|ref|'}), "
                  f"repeated launch bit-equal {repeat} {'ok' if ok else 'FAIL'}; kernel "
                  f"{ms:.4f} ms (CUDA graph replay), plain {pms:.4f} ms (eager)")
            print(f"    {text}")
            if got.shape != want.shape or not ok:
                _fail(f"shear_group {label} group {gi} disagrees with its plain version")
            if min(plan.blocks_per_sm, card) < 2:
                _fail(f"shear_group {label} group {gi}: fewer than two resident blocks per SM")
            if timed:
                # per pass, two products and a sum per output voxel (order 1)
                dims, outputs = list(x.shape[2:]), 0
                for j, (_, _, out_ext) in enumerate(specs):
                    axis = b_axis if j == 1 else a_axis
                    dims[axis] = min(out_ext or dims[axis], dims[axis])
                    outputs += samples * dims[0] * dims[1] * dims[2]
                _record(results, "shear_group", err=err, ms=ms, plain_ms=pms,
                        nbytes=_nbytes(x, got, c, zoom), ops=3 * outputs * order,
                        peak=PEAK_F32)
            x = want.contiguous()

    # the 2D flagship's augmented step: 16 x 1 x 384^2 margin patches to
    # 256^2, one rotation group; the bf16 images (order 1, bf16 weights) keep
    # their 297 KB plane in global scratch, the uint8 labels theirs in shared
    # memory. Timed and printed beside the 3D row, not recorded in it.
    margin_2d = tuple(e + e // 2 for e in TRAIN_2D_PATCH)
    passes, divz, _, groups = shear_resample.chain_plan(margin_2d, 1, TRAIN_2D_PATCH, 0.4, 0.8)
    angles = (torch.rand((TRAIN_2D_BATCH, 1), generator=g) * 0.8 - 0.4).to(dev)
    zoom = torch.linspace(0.8, 1.3, TRAIN_2D_BATCH).to(dev)
    coef = shear_resample.shear_coefficients(angles, zoom, passes, divz)[:, :3].contiguous()
    a_axis, b_axis, specs = groups[0]
    images_2d = torch.randn((TRAIN_2D_BATCH, 1, *margin_2d), generator=g).to(dev, torch.bfloat16)
    labels_2d = torch.randint(0, NUM_CLASSES, (TRAIN_2D_BATCH, 1, *margin_2d), generator=g,
                              dtype=torch.uint8).to(dev)
    for label, x, order, bf16 in (("bf16 order 1", images_2d, 1, True),
                                  ("u8 order 0", labels_2d, 0, False)):
        k = lambda: fused_shear.shear_group(  # noqa: E731
            x, a_axis, b_axis, coef, zoom, specs, order, bf16)
        p = lambda: fused_shear.shear_group_plain(  # noqa: E731
            x, a_axis, b_axis, coef, zoom, specs, order, bf16)
        before = fused_shear.counter.count
        got, want = k(), p()
        torch.cuda.synchronize()
        launched = fused_shear.counter.count == before + 1
        err = (got.float() - want.float()).abs().max().item()
        exact, repeat = torch.equal(got, want), torch.equal(got, k())
        plan, card, text = plan_text(x.unsqueeze(-1), a_axis, b_axis, specs, order)
        ms, pms = _graph_ms(torch, k), _median_ms(torch, p)
        ok = exact and repeat and launched and got.shape == want.shape
        print(f"  shear_group 2D {label} {tuple(x.shape)} -> {tuple(got.shape)}: max|d| "
              f"{err:.3e}, bit-equal {exact} (limit bit-equal), repeated launch bit-equal "
              f"{repeat} {'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms (CUDA graph replay), "
              f"plain {pms:.4f} ms (eager)")
        print(f"    {text}")
        if not ok:
            _fail(f"shear_group 2D {label} disagrees with its plain version")
        if card < 1:  # 16 blocks for 132 SMs: two a SM are not needed here
            _fail(f"shear_group 2D {label}: the card cannot make a block resident")

    # odd shapes, untimed: ragged chunks of the third axis, odd extents (no
    # 16-byte rows), 2D, int32, shrinking windows with the zoom folded in,
    # lines beyond a warp's registers (a block per line), and an odd count of
    # planes taken two a block
    odd = [((20, 22, 24), (12, 12, 14), torch.bfloat16, 1, True),
           ((15, 18, 17), None, torch.bfloat16, 1, True),
           ((15, 18, 17), None, torch.uint8, 0, False),
           ((21, 19, 10), (13, 11, 6), torch.int32, 0, False),
           ((15, 18, 17), None, torch.float32, 1, False),
           ((18, 21), (12, 13), torch.float32, 0, False),
           ((300, 20, 6), None, torch.bfloat16, 1, True),
           ((133, 20, 24), None, torch.bfloat16, 1, True),  # two planes a block, ragged pair
           ((133, 20, 24), None, torch.uint8, 0, False)]
    for full, out_shape, dtype, order, bf16 in odd:
        n_rot = 3 if len(full) == 3 else 1
        o_passes, o_divz, _, o_groups = shear_resample.chain_plan(full, n_rot, out_shape, 0.4, 0.8)
        o_angles = (torch.rand((3, n_rot), generator=g) * 0.8 - 0.4).to(dev)
        o_zoom = (torch.rand((3,), generator=g) * 0.5 + 0.8).to(dev)
        o_coef = shear_resample.shear_coefficients(o_angles, o_zoom, o_passes, o_divz)
        if dtype.is_floating_point:
            x = torch.randn((3, 2, *full), generator=g).to(dev, dtype)
        else:
            x = torch.randint(0, 9, (3, 2, *full), generator=g).to(dev, dtype)
        for gi, (a_axis, b_axis, specs) in enumerate(o_groups):
            c = o_coef[:, 3 * gi: 3 * gi + 3].contiguous()
            before = fused_shear.counter.count
            got = fused_shear.shear_group(x, a_axis, b_axis, c, o_zoom, specs, order, bf16)
            want = fused_shear.shear_group_plain(x, a_axis, b_axis, c, o_zoom, specs, order, bf16)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            ref = want.float().abs().max().item()
            exact = torch.equal(got, want)
            ok = (exact if (order == 0 or bf16) else err <= 1e-6 * ref) \
                and fused_shear.counter.count == before + 1
            x5 = x if x.ndim == 5 else x.unsqueeze(-1)
            _, _, text = plan_text(x5, a_axis, b_axis, specs, order)
            print(f"  shear_group odd {str(dtype)[6:]} order {order} {tuple(x.shape)} -> "
                  f"{tuple(got.shape)} plane ({a_axis},{b_axis}): max|d| {err:.3e}, bit-equal "
                  f"{exact} {'ok' if ok else 'FAIL'}; {text}")
            if got.shape != want.shape or not ok:
                _fail(f"shear_group odd {dtype} {full} group {gi} disagrees with its plain "
                      "version")
            x = want.contiguous()
    return results


def check_dice_kernels(torch):
    """``dice_phase_sums`` and ``dice_phase_dx`` at the train step's shapes,
    xp (8, 48, 48, 48, 64) in f32 and bf16 with uint8 labels, against their
    plain versions (sums 1e-5 relative to each sum's largest entry, the counts
    exact; dx 1e-3 * max|ref| in f32, 2e-2 in bf16, whose output rounds once),
    a repeated launch bit-equal, one ragged shape (a voxel count that is no
    multiple of the unroll, of the block or of P), the 2D flagship's step
    (xp (16, 128, 128, 32) at 4 phases, f32 and bf16, same limits; timed and
    printed apart from the 3D rows), and the loss ``Function``
    against autograd through the plain sums (loss 1e-5 relative; gradient as
    dx). Times are the bf16 ones (the train step's type), by CUDA-graph replay
    (``_graph_ms``: the sums are two launches and two allocations a call, so an
    eager call times its wrapper; the eager figure is printed once beside it);
    the plain versions are timed eager."""
    from segmantic_tpu_torch.ops import phase_dice
    from segmantic_tpu_torch.train import losses

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator().manual_seed(8)
    shape, n_phase = (TRAIN_BATCH, DICE_EXTENT, DICE_EXTENT, DICE_EXTENT), 8
    lanes = n_phase * NUM_CLASSES
    x32 = (torch.randn((*shape, lanes), generator=g) * 2.0).to(dev)
    yp = torch.randint(0, NUM_CLASSES, (*shape, n_phase), generator=g,
                       dtype=torch.uint8).to(dev)
    hot = torch.randn((TRAIN_BATCH, lanes), generator=g).to(dev)
    cold = torch.randn((TRAIN_BATCH, lanes), generator=g).to(dev)
    plan = phase_dice.sums_plan(TRAIN_BATCH, DICE_EXTENT ** 3 * n_phase, NUM_CLASSES, sms)
    print(f"  dice_phase_sums plan on {sms} SMs: grid ({plan.blocks}, {TRAIN_BATCH}) of "
          f"{phase_dice.THREADS} threads, {plan.voxels_per_block} voxels a block "
          f"({plan.voxels_per_block // phase_dice.THREADS} a thread), {plan.unroll} a round")

    def check_sums(xp, yp, label):
        got = phase_dice.dice_phase_sums(xp, yp)
        want = phase_dice.dice_phase_sums_plain(xp, yp)
        torch.cuda.synchronize()
        rel = [((a - b).abs().max() / b.abs().max()).item() for a, b in zip(got, want)]
        err = max((a - b).abs().max().item() for a, b in zip(got, want))
        same = all(torch.equal(a, b) for a, b in zip(got, phase_dice.dice_phase_sums(xp, yp)))
        counts = torch.equal(got[2], want[2])
        ok = max(rel) <= 1e-5 and same and counts
        print(f"  dice_phase_sums {label}: rel diff (intersection, prob sum, count) "
              f"{[f'{r:.2e}' for r in rel]} (limit 1e-5), counts exact {counts}, repeated "
              f"launch bit-equal {same} {'ok' if ok else 'FAIL'}")
        if not ok:
            _fail(f"dice_phase_sums {label} disagrees with its plain version")
        return got, err

    def check_dx(xp, yp, hot, cold, label):
        got_dx = phase_dice.dice_phase_dx(xp, yp, hot, cold)
        want_dx = phase_dice.dice_phase_dx_plain(xp, yp, hot, cold)
        torch.cuda.synchronize()
        dx_err = (got_dx.float() - want_dx.float()).abs().max().item()
        ref = want_dx.float().abs().max().item()
        limit = 2e-2 if xp.dtype == torch.bfloat16 else 1e-3
        same = torch.equal(got_dx, phase_dice.dice_phase_dx(xp, yp, hot, cold))
        ok = dx_err <= limit * ref and same and got_dx.dtype == xp.dtype
        print(f"  dice_phase_dx {label}: max|d| {dx_err:.3e} (limit {limit:g} * max|ref| "
              f"{ref:.3e}), repeated launch bit-equal {same} {'ok' if ok else 'FAIL'}")
        if not ok:
            _fail(f"dice_phase_dx {label} disagrees with its plain version")
        return dx_err, got_dx

    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        xp = x32.to(dtype)
        name = str(dtype)[6:]
        sums = lambda: phase_dice.dice_phase_sums(xp, yp)  # noqa: E731
        sums_plain = lambda: phase_dice.dice_phase_sums_plain(xp, yp)  # noqa: E731
        got, err = check_sums(xp, yp, name)
        dx = lambda: phase_dice.dice_phase_dx(xp, yp, hot, cold)  # noqa: E731
        dx_plain = lambda: phase_dice.dice_phase_dx_plain(xp, yp, hot, cold)  # noqa: E731
        dx_err, got_dx = check_dx(xp, yp, hot, cold, name)
        if dtype == torch.bfloat16:
            ms, pms = _graph_ms(torch, sums), _median_ms(torch, sums_plain)
            print(f"    bf16 time: sums kernel {ms:.4f} ms by graph replay (sums + finalize; "
                  f"an eager call {_median_ms(torch, sums):.4f} ms), plain {pms:.4f} ms")
            # per class lane: exp, max, sum, multiply, and the three accumulations
            _record(results, "dice_phase_sums", err=err, ms=ms, plain_ms=pms,
                    nbytes=_nbytes(xp, yp, *got), ops=7 * xp.numel(), peak=PEAK_F32)
            ms, pms = _graph_ms(torch, dx), _median_ms(torch, dx_plain)
            print(f"    bf16 time: dx kernel {ms:.4f} ms by graph replay (an eager call "
                  f"{_median_ms(torch, dx):.4f} ms), plain {pms:.4f} ms")
            _record(results, "dice_phase_dx", err=dx_err, ms=ms, plain_ms=pms,
                    nbytes=_nbytes(xp, yp, hot, cold, got_dx), ops=9 * xp.numel(),
                    peak=PEAK_F32)

    # ragged: 3 x 37 x 41 x 43 coarse voxels of 8 phases: 521,848 voxels a
    # sample, no multiple of a round (1024) or of a block's run
    ragged = (3, 37, 41, 43)
    xr = (torch.randn((*ragged, lanes), generator=g) * 2.0).to(dev)
    yr = torch.randint(0, NUM_CLASSES, (*ragged, n_phase), generator=g,
                       dtype=torch.uint8).to(dev)
    for dtype in (torch.float32, torch.bfloat16):
        check_sums(xr.to(dtype), yr, f"ragged {ragged} {str(dtype)[6:]}")

    # the 2D flagship's step: 16 x 256^2 patches, a 128^2 phase grid of 4
    # phases, xp (16, 128, 128, 32) and yp (16, 128, 128, 4); timed and
    # printed, not recorded in the 3D rows
    shape = (TRAIN_2D_BATCH, TRAIN_2D_PATCH[0] // 2, TRAIN_2D_PATCH[1] // 2)
    lanes = 4 * NUM_CLASSES
    x2 = (torch.randn((*shape, lanes), generator=g) * 2.0).to(dev)
    y2 = torch.randint(0, NUM_CLASSES, (*shape, 4), generator=g, dtype=torch.uint8).to(dev)
    hot2 = torch.randn((TRAIN_2D_BATCH, lanes), generator=g).to(dev)
    cold2 = torch.randn((TRAIN_2D_BATCH, lanes), generator=g).to(dev)
    for dtype in (torch.float32, torch.bfloat16):
        xp = x2.to(dtype)
        label = f"2D 4 phases {tuple(xp.shape)} {str(dtype)[6:]}"
        check_sums(xp, y2, label)
        check_dx(xp, y2, hot2, cold2, label)
        if dtype == torch.bfloat16:
            times = [_graph_ms(torch, fn) for fn in (
                lambda: phase_dice.dice_phase_sums(xp, y2),
                lambda: phase_dice.dice_phase_dx(xp, y2, hot2, cold2))]
            plain = [_median_ms(torch, fn) for fn in (
                lambda: phase_dice.dice_phase_sums_plain(xp, y2),
                lambda: phase_dice.dice_phase_dx_plain(xp, y2, hot2, cold2))]
            print(f"    {label} time: sums {times[0]:.4f} ms, dx {times[1]:.4f} ms by graph "
                  f"replay; plain {plain[0]:.4f} ms, {plain[1]:.4f} ms")

    for dtype, limit in ((torch.float32, 1e-3), (torch.bfloat16, 2e-2)):
        for include_background in (True, False):
            xp = x32.to(dtype).clone().requires_grad_()
            loss = losses.dice_loss_phase(xp, yp, include_background=include_background)
            loss.backward()
            ref_x = x32.to(dtype).clone().requires_grad_()
            inter, prob_sum, count = phase_dice.dice_phase_sums_plain(ref_x, yp)
            first = 0 if include_background else 1
            dice = (2.0 * inter[:, first:] + 1e-5) / ((prob_sum + count)[:, first:] + 1e-5)
            ref_loss = (1.0 - dice).mean()
            ref_loss.backward()
            torch.cuda.synchronize()
            rel = abs(loss.item() - ref_loss.item()) / abs(ref_loss.item())
            g_err = (xp.grad.float() - ref_x.grad.float()).abs().max().item()
            g_ref = ref_x.grad.float().abs().max().item()
            ok = rel <= 1e-5 and g_err <= limit * g_ref and xp.grad.dtype == dtype
            print(f"  dice_loss_phase {str(dtype)[6:]} include_background="
                  f"{include_background}: loss {loss.item():.7f} vs {ref_loss.item():.7f} "
                  f"(rel {rel:.2e}, limit 1e-5), grad max|d| {g_err:.3e} (limit {limit:g} * "
                  f"max|ref| {g_ref:.3e}) {'ok' if ok else 'FAIL'}")
            if not ok:
                _fail(f"dice_loss_phase {dtype} disagrees with autograd through the "
                      "plain sums")
    return results


def write_nifti(path: Path, data, affine) -> None:
    """data (i, j, k) or (i, j) and its 4x4 RAS affine as a gzipped single-file NIfTI-1
    (sform), written here so the script holds the port's NIfTI I/O against
    an independent codec."""
    import numpy as np

    code = {np.dtype(v): k for k, v in _NIFTI_DTYPES.items()}[data.dtype]
    hdr = bytearray(348)
    struct.pack_into("<i", hdr, 0, 348)
    struct.pack_into("<8h", hdr, 40, data.ndim, *data.shape, *(1,) * (7 - data.ndim))
    struct.pack_into("<2h", hdr, 70, code, 8 * data.dtype.itemsize)
    struct.pack_into("<8f", hdr, 76, 1.0, *np.linalg.norm(affine[:3, :3], axis=0),
                     1.0, 1.0, 1.0, 1.0)
    struct.pack_into("<2f", hdr, 108, 352.0, 1.0)  # vox_offset, scl_slope
    struct.pack_into("<h", hdr, 254, 1)  # sform_code
    struct.pack_into("<12f", hdr, 280, *np.asarray(affine, np.float64)[:3].ravel())
    hdr[344:348] = b"n+1\0"
    payload = bytes(hdr) + bytes(4) + np.asarray(data).tobytes(order="F")
    path.write_bytes(gzip.compress(payload, compresslevel=1))


def read_nifti(path: Path):
    """A little-endian NIfTI-1 file with an sform and no intensity scaling
    (what the port writes) -> (data (i, j, k), 4x4 affine)."""
    import numpy as np

    blob = path.read_bytes()
    if blob[:2] == b"\x1f\x8b":
        blob = gzip.decompress(blob)
    ndim, *dims = struct.unpack_from("<8h", blob, 40)
    slope, inter = struct.unpack_from("<2f", blob, 112)
    if (struct.unpack_from("<i", blob, 0)[0] != 348 or blob[344:347] != b"n+1"
            or struct.unpack_from("<h", blob, 254)[0] <= 0
            or slope not in (0.0, 1.0) or inter != 0.0):
        _fail(f"{path.name}: not a plain single-file NIfTI-1 with an sform")
    dtype = np.dtype(_NIFTI_DTYPES[struct.unpack_from("<h", blob, 70)[0]])
    shape = tuple(dims[:ndim])
    data = np.frombuffer(blob, dtype, int(np.prod(shape)),
                         int(struct.unpack_from("<f", blob, 108)[0]))
    affine = np.eye(4)
    affine[:3] = np.reshape(struct.unpack_from("<12f", blob, 280), (3, 4))
    return data.reshape(shape, order="F"), affine


def spacing_affine(spacing, origin=(0.0, 0.0, 0.0)):
    """Axis-aligned 4x4 affine with the given voxel spacing and origin."""
    import numpy as np

    aff = np.diag([*map(float, spacing), 1.0])
    aff[:3, 3] = origin
    return aff


def labelled_phantom(shape, seed: int):
    """Nested ellipsoids (ellipses in 2D): label k inside the k-th shell (8
    classes), image 100 * k plus noise; returns (image f32, label u8) arrays."""
    import numpy as np

    rng = np.random.default_rng(seed)
    grid = np.stack(np.meshgrid(*[np.linspace(-1, 1, s) for s in shape], indexing="ij"))
    lbl = np.zeros(shape, np.uint8)
    for k, radius in enumerate((0.9, 0.75, 0.62, 0.5, 0.38, 0.27, 0.16)):
        center = rng.uniform(-0.05, 0.05, len(shape)).reshape((-1,) + (1,) * len(shape))
        lbl[(((grid - center) / radius) ** 2).sum(0) < 1.0] = k + 1
    img = (100.0 * lbl + 20.0 * rng.standard_normal(shape)).astype(np.float32)
    return img, lbl


def fixed_batch(torch, n: int, seed: int, size: int = 96, volume: int = 128, nd: int = 3):
    """n z-scored size^nd patches of volume^nd phantoms with their labels (host)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    images, labels = [], []
    for i in range(n):
        img, lbl = labelled_phantom((volume,) * nd, seed + i)
        s = rng.integers(0, volume - size + 1, nd)
        crop = tuple(slice(a, a + size) for a in s)
        im = img[crop]
        images.append(((im - im.mean()) / im.std())[..., None])
        labels.append(lbl[crop])
    return (torch.from_numpy(np.stack(images).astype(np.float32)),
            torch.from_numpy(np.stack(labels).astype(np.uint8)))


def warm_steps(torch, step, image, label, n: int = 17):
    """3 warm-up steps, then ``n`` timed ones (CUDA events) on one fixed
    batch: (median ms, the n times, the n + 3 losses, peak device MiB)."""
    loss_hist = [step(image, label).item() for _ in range(3)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loss = step(image, label)
        end.record()
        loss_hist.append(loss.item())
        times.append(start.elapsed_time(end))
    peak = torch.cuda.max_memory_allocated() / 2**20
    return statistics.median(times), times, loss_hist, peak


def run_train(torch, work: Path):
    """train() with the flagship defaults on 4 + 1 phantoms, then step time,
    memory and learning on one fixed 8 x 96^3 bf16 batch."""
    import numpy as np

    from segmantic_tpu_torch.train.augment import AugmentConfig
    from segmantic_tpu_torch.train.optim import make_optimizer
    from segmantic_tpu_torch.train.trainer import (
        SegmentationModel, make_train_step, train,
    )

    for sub in ("image", "label"):
        (work / sub).mkdir(parents=True)
    for i in range(5):
        img, lbl = labelled_phantom((128, 128, 128), 10 + i)
        write_nifti(work / "image" / f"case{i}.nii.gz", img, np.eye(4))
        write_nifti(work / "label" / f"case{i}.nii.gz", lbl, np.eye(4))
    counters = _reset_counters()
    t0 = time.perf_counter()
    result = train(image_dir=work / "image", labels_dir=work / "label",
                   output_dir=work / "run", num_classes=NUM_CLASSES, max_epochs=2,
                   device="cuda", seed=0)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: c.count for name, c in counters.items()}
    launches.update(_launches(_deep_counters()))  # the deep convs on the deep-channel bodies
    for rec in result.history:
        print(f"  epoch {rec['epoch']}: train_loss {rec['train_loss']:.5f} val_loss "
              f"{rec['val_loss']:.5f} val_dice {rec['val_dice']:.5f} "
              f"{rec['train_voxels_per_sec']:.4g} voxels/s (cold), {rec['seconds']:.2f} s")
    print(f"  train(): {seconds:.1f} s for 2 epochs of 2 steps + validation; "
          f"launches {launches}")
    finite = all(np.isfinite(v) for rec in result.history for v in rec.values())
    ckpts = sorted(p.name for p in (work / "run").glob("*.ckpt"))
    print(f"  checkpoints: {ckpts}; best {result.best_checkpoint.name if result.best_checkpoint else None}")
    if len(result.history) != 2 or not finite:
        _fail("train() history is not 2 finite epochs")
    if not (work / "run" / "last.ckpt").exists() or result.best_checkpoint is None \
            or not result.best_checkpoint.exists():
        _fail("train() did not write last.ckpt and a best checkpoint")
    if min(n for name, n in launches.items() if name != "shear_group") <= 0:
        _fail(f"a kernel of the training path was never launched: {launches}")
    if launches["shear_group"]:
        _fail("the shear kernel ran without the spatial augmentation")

    # one fixed batch: warm step time, throughput, peak memory, learning
    model = SegmentationModel.create(num_classes=NUM_CLASSES, seed=1, device="cuda")
    module = model.module.train().requires_grad_(True)
    opt = make_optimizer(module.parameters(), {"optimizer": "Adam", "lr": 1e-3})
    step = make_train_step(module, opt, AugmentConfig(flip_prob=0.0), TRAIN_PATCH,
                           mixed_precision=True)
    image, label = fixed_batch(torch, TRAIN_BATCH, 20)
    _reset_counters()
    deep = _deep_counters()
    step(image.cuda(), label.cuda())
    torch.cuda.synchronize()
    want = {"fused_conv_wgmma": 2 * FLAGSHIP_DEEP, "fused_conv_dw_wgmma": FLAGSHIP_DEEP_DW}
    print(f"  deep-channel bodies, one step: {_launches(deep)} (expected {want})")
    if _launches(deep) != want:
        _fail(f"the flagship's deep convs (fwd, dx, dw) did not all run on the deep-channel "
              f"bodies: {_launches(deep)}, expected {want}")
    ms, times, loss_hist, peak = warm_steps(torch, step, image.cuda(), label.cuda())
    voxels = TRAIN_BATCH * int(np.prod(TRAIN_PATCH))
    print(f"  fixed batch {TRAIN_BATCH}x96^3 bf16, Adam lr 1e-3: warm step median {ms:.2f} ms "
          f"(min {min(times):.2f}, max {max(times):.2f}, CUDA events over 17 steps), "
          f"{voxels / ms * 1e3:.4g} labelled voxels/s, peak device memory {peak:.0f} MiB")
    print(f"  loss over 20 steps: {[round(v, 5) for v in loss_hist]}")
    if not all(np.isfinite(loss_hist)) or not loss_hist[-1] < loss_hist[0] - 1e-3:
        _fail("the loss did not fall over 20 steps on a fixed batch")
    return launches, {"step_ms": ms, "voxels_per_s": voxels / ms * 1e3, "peak_mib": peak}


def run_train_aug(torch, data: Path, out: Path):
    """train() with the device augmentation on the phantoms of ``data``
    (144^3 margin patches, 5 of 8 samples through the shear chain, intensity
    ops, flips, Gibbs and spike on 2 of 8 each), then the augmentation alone
    and the whole augmented step on one fixed 8 x 144^3 margin batch."""
    import numpy as np

    from segmantic_tpu_torch.train.augment import AugmentConfig, augment_batch
    from segmantic_tpu_torch.train.optim import make_optimizer
    from segmantic_tpu_torch.train.trainer import (
        SegmentationModel, make_train_step, train,
    )

    counters = _counters()
    for c in counters.values():
        c.reset()
    t0 = time.perf_counter()
    result = train(image_dir=data / "image", labels_dir=data / "label", output_dir=out,
                   num_classes=NUM_CLASSES, max_epochs=2, augment_spatial=True,
                   augment_intensity=True, seed=0)  # device: the default, the card
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: c.count for name, c in counters.items()}
    for rec in result.history:
        print(f"  epoch {rec['epoch']}: train_loss {rec['train_loss']:.5f} val_loss "
              f"{rec['val_loss']:.5f} val_dice {rec['val_dice']:.5f} "
              f"{rec['train_voxels_per_sec']:.4g} voxels/s (cold), {rec['seconds']:.2f} s")
    print(f"  train(augment_spatial=True, augment_intensity=True): {seconds:.1f} s for 2 "
          f"epochs of 2 steps + validation; launches {launches}")
    finite = all(np.isfinite(v) for rec in result.history for v in rec.values())
    history = json.loads((out / "history.json").read_text())
    if len(result.history) != 2 or len(history) != 2 or not finite:
        _fail("augmented train() history is not 2 finite epochs, written to history.json")
    if not (out / "last.ckpt").exists():
        _fail("augmented train() did not write last.ckpt")
    if min(launches.values()) <= 0:
        _fail(f"a kernel of the augmented training path was never launched: {launches}")
    steps = 4
    if launches["shear_group"] != 6 * steps or launches["dice_phase_sums"] != steps \
            or launches["dice_phase_dx"] != steps:
        _fail(f"expected 6 shear-group launches (3 image, 3 label) and one of each Dice "
              f"kernel per step over {steps} steps: {launches}")

    # one fixed margin batch: the augmentation alone, then the whole step
    cfg = AugmentConfig(spatial=True, intensity=True)
    image, label = fixed_batch(torch, TRAIN_BATCH, 60, size=MARGIN_PATCH[0], volume=160)
    image, label = image.to(torch.bfloat16).cuda(), label.cuda()  # as train() uploads
    gen = torch.Generator().manual_seed(3)
    out_i, out_l = augment_batch(image, label, gen, cfg, TRAIN_PATCH)
    torch.cuda.synchronize()
    classes_in = set(label.unique().tolist())
    ok = (tuple(out_i.shape) == (TRAIN_BATCH, *TRAIN_PATCH, 1) and out_i.dtype == image.dtype
          and tuple(out_l.shape) == (TRAIN_BATCH, *TRAIN_PATCH) and out_l.dtype == label.dtype
          and bool(torch.isfinite(out_i.float()).all())
          and set(out_l.unique().tolist()) <= classes_in)
    print(f"  augment_batch {tuple(image.shape)} {str(image.dtype)[6:]} -> "
          f"{tuple(out_i.shape)} {str(out_i.dtype)[6:]}, labels {tuple(out_l.shape)} "
          f"{str(out_l.dtype)[6:]} with classes {sorted(set(out_l.unique().tolist()))}: "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        _fail("augment_batch output: shape, type, finiteness or label values")
    aug_ms = _median_ms(torch, lambda: augment_batch(image, label, gen, cfg, TRAIN_PATCH),
                        n=20)
    spatial_ms = _median_ms(torch, lambda: augment_batch(
        image, label, gen, AugmentConfig(spatial=True, flip_prob=0.0), TRAIN_PATCH), n=20)

    model = SegmentationModel.create(num_classes=NUM_CLASSES, seed=1, device="cuda")
    module = model.module.train().requires_grad_(True)
    opt = make_optimizer(module.parameters(), {"optimizer": "Adam", "lr": 1e-3})
    step = make_train_step(module, opt, cfg, TRAIN_PATCH, mixed_precision=True,
                           generator=torch.Generator().manual_seed(4))
    ms, times, loss_hist, peak = warm_steps(torch, step, image, label)
    voxels = TRAIN_BATCH * int(np.prod(TRAIN_PATCH))
    print(f"  fixed margin batch {TRAIN_BATCH}x144^3 bf16: augmentation alone median "
          f"{aug_ms:.2f} ms (rotation + zoom and crop alone {spatial_ms:.2f} ms; CUDA "
          f"events over 20 draws, host draws included), augmented warm step median "
          f"{ms:.2f} ms (min {min(times):.2f}, max {max(times):.2f}, 17 steps), "
          f"{voxels / ms * 1e3:.4g} labelled voxels/s, peak device memory {peak:.0f} MiB")
    print(f"  loss over 20 augmented steps: {[round(v, 5) for v in loss_hist]}")
    if not all(np.isfinite(loss_hist)) or not min(loss_hist[-5:]) < loss_hist[0] - 1e-3:
        _fail("the loss did not fall over 20 augmented steps on a fixed margin batch")
    return launches, {"augment_ms": aug_ms, "spatial_ms": spatial_ms, "step_ms": ms,
                      "voxels_per_s": voxels / ms * 1e3, "peak_mib": peak}


def run_train_config(torch, data: Path, out: Path, step_ms: float):
    """train() driven by config dicts on the phantoms of ``data``, at the
    flagship's full width: ``preprocessing`` spells out the default pipeline
    as ``_target_`` entries with ``@image_key`` / ``@label_key``;
    ``augmentation`` is a host pipeline (pad, class-balanced crop of 4 x 96^3
    a volume, flip, rotation, zoom, contrast, Gibbs, one disabled entry, one
    ``$`` expression), crop first so the numpy resampling acts on patches.
    The model, the step and validation run on the card (``device`` is left at
    its default); the pipeline runs on the host, as in the JAX package.
    Prints the host milliseconds a batch beside ``step_ms``, the warm step of
    the same 8 x 96^3 bf16 batch shape."""
    import numpy as np

    from segmantic_tpu_torch.train import trainer

    keys = ["@image_key", "@label_key"]
    preprocessing = {"_target_": "Compose", "transforms": [
        {"_target_": "LoadImaged", "keys": keys},
        {"_target_": "Orientationd", "keys": keys, "axcodes": "RAS"},
        {"_target_": "NormalizeIntensityd", "keys": "@image_key"},
        {"_target_": "CropForegroundd", "keys": keys, "source_key": "@label_key"},
        {"_target_": "EnsureTyped", "keys": keys},
    ]}
    size = list(TRAIN_PATCH)
    augmentation = {"_target_": "Compose", "transforms": [
        {"_target_": "SpatialPadd", "keys": keys, "spatial_size": size},
        {"_target_": "RandCropByLabelClassesd", "keys": keys, "label_key": "@label_key",
         "spatial_size": size, "num_classes": NUM_CLASSES, "num_samples": 4},
        {"_target_": "RandFlipd", "keys": keys, "prob": 0.5, "spatial_axis": 0},
        {"_target_": "RandFlipd", "keys": keys, "prob": 0.5, "spatial_axis": 1,
         "_disabled_": True},
        {"_target_": "RandRotated", "keys": keys, "prob": 0.25, "range_z": "$3.14159 / 12"},
        {"_target_": "RandZoomd", "keys": keys, "prob": 0.25, "min_zoom": 0.9,
         "max_zoom": 1.1},
        {"_target_": "RandAdjustContrastd", "keys": "@image_key", "prob": 0.5,
         "gamma": [0.7, 1.5]},
        {"_target_": "RandGibbsNoised", "keys": "@image_key", "prob": 0.25,
         "alpha": [0.0, 0.6]},
    ]}
    host_ms, shapes = [], []
    collate = trainer._host_augment_batch

    def timed(*args):
        t0 = time.perf_counter()
        batch = collate(*args)
        host_ms.append((time.perf_counter() - t0) * 1e3)
        shapes.append((batch[0].shape, batch[1].shape))
        return batch

    counters = _counters()
    for c in counters.values():
        c.reset()
    trainer._host_augment_batch = timed
    try:
        t0 = time.perf_counter()
        result = trainer.train(image_dir=data / "image", labels_dir=data / "label",
                               output_dir=out, num_classes=NUM_CLASSES, max_epochs=2,
                               preprocessing=preprocessing, augmentation=augmentation,
                               seed=0)  # device: the default, the card
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        trainer._host_augment_batch = collate
    launches = {name: c.count for name, c in counters.items()}
    for rec in result.history:
        print(f"  epoch {rec['epoch']}: train_loss {rec['train_loss']:.5f} val_loss "
              f"{rec['val_loss']:.5f} val_dice {rec['val_dice']:.5f} "
              f"{rec['train_voxels_per_sec']:.4g} voxels/s (host augmentation included), "
              f"{rec['seconds']:.2f} s")
    print(f"  train(preprocessing=<config>, augmentation=<config>): {seconds:.1f} s for 2 "
          f"epochs of 2 steps + validation; launches {launches}")
    print(f"  host augmentation (_host_augment_batch, numpy on the host): "
          f"{[round(m) for m in host_ms]} ms a batch of {TRAIN_BATCH} x 96^3, median "
          f"{statistics.median(host_ms):.0f} ms, beside a warm step of {step_ms:.2f} ms on "
          f"the card")
    finite = all(np.isfinite(v) for rec in result.history for v in rec.values())
    history = json.loads((out / "history.json").read_text())
    if len(result.history) != 2 or len(history) != 2 or not finite:
        _fail("config-driven train() history is not 2 finite epochs, written to history.json")
    if not (out / "last.ckpt").exists():
        _fail("config-driven train() did not write last.ckpt")
    steps = 4
    want = ((TRAIN_BATCH, *TRAIN_PATCH, 1), (TRAIN_BATCH, *TRAIN_PATCH))
    if len(shapes) != steps or any(s != want for s in shapes):
        _fail(f"the host batches were not {steps} of {want}: {shapes}")
    if min(n for name, n in launches.items() if name != "shear_group") <= 0:
        _fail(f"a kernel of the config-driven training path was never launched: {launches}")
    if launches["shear_group"] or launches["dice_phase_sums"] != steps \
            or launches["dice_phase_dx"] != steps:
        _fail(f"expected no shear-group launch (the host augments) and one of each Dice "
              f"kernel per step over {steps} steps: {launches}")
    return launches, {"host_augment_ms": statistics.median(host_ms)}


def train_parity(torch):
    """One train step (flips off, TF32 off) from the same weights and batch,
    batch 2 at full width, three times: f32 on the card with the kernels, f32
    on the CPU with the plain versions, and f64 on the CPU (the plain
    versions take f64 there), the reference both f32 runs are judged by. SGD
    at lr 0 leaves the weights as they were and the gradients in place.

    Limits, against the f64 step: loss 1e-5 relative; BN running statistics
    1e-4 * max|ref| of each buffer; each gradient tensor k within
    2 * e_cpu[k] + 1e-3 * max(max|g64[k]|, 1e-2 * max over all tensors of
    max|g64|), where e_cpu[k] is the CPU f32 step's own distance from f64.
    The first term is the rounding that f32 arithmetic brings to that tensor
    whatever computes it (behind a BatchNorm's backward it reaches ~1e-3 of
    the tensor's scale); the floor keeps the conv biases that feed a
    BatchNorm, whose true gradient is zero, from being judged against
    rounding noise."""
    image, label = fixed_batch(torch, 2, 40)
    step_parity(torch, dict(num_classes=NUM_CLASSES, seed=2), image, label, TRAIN_PATCH)


def step_parity(torch, create_kw, image, label, patch):
    """One f32 train step of ``SegmentationModel.create(**create_kw)`` on the
    card, f32 and f64 on the CPU, judged as :func:`train_parity` says."""
    from segmantic_tpu_torch.train.augment import AugmentConfig
    from segmantic_tpu_torch.train.trainer import SegmentationModel, make_train_step

    out = {}
    for device, dtype in (("cuda", torch.float32), ("cpu", torch.float32),
                          ("cpu", torch.float64)):
        model = SegmentationModel.create(device=device, **create_kw)
        module = model.module.to(dtype).train().requires_grad_(True)
        opt = torch.optim.SGD(module.parameters(), lr=0.0)
        step = make_train_step(module, opt, AugmentConfig(flip_prob=0.0), patch,
                               mixed_precision=False)
        t0 = time.perf_counter()
        loss = step(image.to(device, dtype), label.to(device)).item()
        print(f"  {device} {str(dtype)[6:]}: loss {loss:.9f} "
              f"({time.perf_counter() - t0:.1f} s)")
        out[device, dtype] = (loss, {k: p.grad.cpu().double()
                                     for k, p in module.named_parameters()},
                              {k: b.cpu().double() for k, b in module.named_buffers()})
    (lg, gg, bg) = out["cuda", torch.float32]
    (_, gc, _) = out["cpu", torch.float32]
    (l64, g64, b64) = out["cpu", torch.float64]
    rel = abs(lg - l64) / abs(l64)
    floor = 1e-2 * max(g.abs().max().item() for g in g64.values())
    rows = []
    for k, ref in g64.items():
        e_card = (gg[k] - ref).abs().max().item()
        e_cpu = (gc[k] - ref).abs().max().item()
        lim = 2 * e_cpu + 1e-3 * max(ref.abs().max().item(), floor)
        rows.append((e_card / lim, k, e_card, e_cpu, lim))
    rows.sort(reverse=True)
    worst_b = max(((bg[k] - b64[k]).abs().max().item() / b64[k].abs().max().item(), k)
                  for k in b64) if b64 else (0.0, "none (no BatchNorm)")
    print(f"  card vs f64: loss rel diff {rel:.3e} (limit 1e-5); worst BN statistic "
          f"{worst_b[0]:.3e} of max|ref| at {worst_b[1]} (limit 1e-4); gradients "
          f"(floor 1e-2 * max|g64| = {floor:.3e}), the 8 nearest their limits:")
    for ratio, k, e_card, e_cpu, lim in rows[:8]:
        print(f"    {k}: card {e_card:.3e}, CPU f32 {e_cpu:.3e} from f64; limit "
              f"{lim:.3e}; {ratio:.3f} of it")
    print(f"  {sum(r[0] <= 1.0 for r in rows)} of {len(rows)} gradient tensors within "
          f"their limits; card nearer f64 than the CPU for "
          f"{sum(r[2] <= r[3] for r in rows)}")
    if not (rel <= 1e-5 and worst_b[0] <= 1e-4 and rows[0][0] <= 1.0):
        _fail("f32 train-step parity, card vs the f64 step")


def make_checkpoint(torch, path: Path, seed: int = 0, metrics=None):
    """The flagship UNet from torch.Generator ``seed``, with non-trivial BN
    running statistics, written as an STPUCKP1 checkpoint."""
    from segmantic_tpu_torch.train.trainer import SegmentationModel

    model = SegmentationModel.create(num_classes=NUM_CLASSES, spatial_size=ROI, seed=seed,
                                     device="cpu")
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, buf in model.module.named_buffers():
            if name.endswith("running_var"):
                buf.copy_(0.5 + torch.rand(buf.shape, generator=g))
            elif name.endswith("running_mean"):
                buf.copy_(0.1 * torch.randn(buf.shape, generator=g))
        for name, p in model.module.named_parameters():
            if "Norm_0" in name:
                p.add_(0.1 * torch.randn(p.shape, generator=g))
    model.save(path, metrics)


@functools.lru_cache(maxsize=None)
def phantom(shape, seed: int):
    """Nested ellipsoids of distinct intensities over low-level noise (f32;
    read-only: the phases share one array for each (shape, seed))."""
    import numpy as np

    rng = np.random.default_rng(seed)
    grid = np.stack(np.meshgrid(*[np.linspace(-1, 1, s) for s in shape], indexing="ij"))
    img = 0.05 * rng.standard_normal(shape).astype(np.float32) + 0.1
    for k, radius in enumerate((0.9, 0.7, 0.5, 0.3, 0.15)):
        center = rng.uniform(-0.1, 0.1, 3)[:, None, None, None]
        inside = (((grid - center) / radius) ** 2).sum(0) < 1.0
        img[inside] = 100.0 * (k + 1) + 5.0 * rng.standard_normal(inside.sum())
    img.setflags(write=False)
    return img


def serve_requests(torch, ckpt: Path, work: Path,
                   required=("fused_conv", "phase_conv", "blend")):
    """Three requests through ``make_server(InferenceSession(ckpt))``; fails
    unless each kernel of ``required`` launched."""
    import numpy as np

    from segmantic_tpu_torch.serve import InferenceSession, make_server

    lps = spacing_affine((0.8, 0.9, 1.1), (10.0, -20.0, 5.0))
    lps[:2] *= -1
    cases = [
        ("phantom_a", phantom((256, 256, 176), 1), spacing_affine((1.0, 1.0, 1.2))),
        ("phantom_b", phantom((256, 256, 176), 2), spacing_affine((0.9, 0.9, 1.0))),
        # LPS: flipped on the way in and back on the way out; no axis is a
        # multiple of the window stride, so the last windows snap to the edges
        ("lps", phantom((200, 168, 150), 3), lps),
    ]
    session = InferenceSession(ckpt, device="cuda")
    server = make_server(session, host="127.0.0.1", port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    seconds = []
    try:
        with urllib.request.urlopen(f"{base}/v1/health", timeout=60) as r:
            health = json.loads(r.read())
        print(f"  GET /v1/health -> {health}")
        if health != {"status": "ok"}:
            _fail("health check")
        for c in _counters().values():
            c.reset()
        for name, img, affine in cases:
            path = work / f"{name}.nii.gz"
            write_nifti(path, img, affine)
            req = urllib.request.Request(f"{base}/v1/segment", data=path.read_bytes(),
                                         method="POST")
            t0 = time.perf_counter()
            with urllib.request.urlopen(req, timeout=600) as r:
                status, body = r.status, r.read()
            dt = time.perf_counter() - t0
            seconds.append(dt)
            out = work / f"{name}_pred.nii.gz"
            out.write_bytes(body)
            labels, pred_affine = read_nifti(out)
            affine_ok = np.allclose(pred_affine, affine, atol=1e-4)
            ok = (status == 200 and labels.shape == img.shape and affine_ok
                  and labels.min() >= 0 and labels.max() < NUM_CLASSES)
            counts = np.bincount(labels.astype(np.int64).ravel(), minlength=NUM_CLASSES)
            print(f"  POST {name} {img.shape}: HTTP {status}, {dt:.3f} s, "
                  f"grid {labels.shape}, affine match {affine_ok}, "
                  f"labels per class {counts.tolist()}")
            if not ok:
                _fail(f"request {name}: bad response")
    finally:
        server.shutdown()
        thread.join(timeout=60)
        server.server_close()
    if thread.is_alive():
        _fail("server thread did not stop")
    launches = {name: c.count for name, c in _counters().items()}
    print(f"  launches during the requests: {launches}")
    if min(launches[k] for k in required) <= 0:
        _fail(f"a kernel of the path was never launched: {launches}")
    return seconds, launches, session


def device_seconds_per_volume(torch, session, sw_batch: int) -> float:
    """The sliding window alone on one z-scored 256 x 256 x 176 phantom already
    on the host as an array: upload in bf16, 48 windows in chunks of
    ``sw_batch`` through the eval forward, blend; host clock around a run that
    ends in a synchronise, median of 5 after one warm-up."""
    import numpy as np

    from segmantic_tpu_torch.infer.sliding_window import sliding_window_inference

    vol = phantom((256, 256, 176), 5)
    vol = ((vol - vol.mean()) / vol.std())[..., None].astype(np.float32)
    times = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = sliding_window_inference(
            vol, ROI, sw_batch, session.val_forward, overlap=0.25,
            num_classes=NUM_CLASSES, device="cuda", wire_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    if tuple(logits.shape) != (256, 256, 176, NUM_CLASSES) or not bool(
            torch.isfinite(logits).all()):
        _fail("sliding window on the card: shape or finiteness of the logits")
    return statistics.median(times[1:])


def parity(torch, ckpt: Path, session):
    """One 4 x 96^3 window batch: folded forward on the card (kernels, f32;
    TF32 is off since main) vs the same forward on the CPU (plain, f32)."""
    import numpy as np

    from segmantic_tpu_torch.infer.executor import make_eval_forward
    from segmantic_tpu_torch.train.trainer import SegmentationModel

    vol = phantom((192, 96, 96), 4)
    vol = (vol - vol.mean()) / vol.std()
    windows = np.stack([vol[0:96], vol[96:192], vol[48:144], vol[24:120]])[..., None]
    x = torch.from_numpy(windows.astype(np.float32))

    cpu_model = SegmentationModel.load(ckpt, device="cpu")
    t0 = time.perf_counter()
    ref = make_eval_forward(cpu_model.module, torch.float32)(x)
    print(f"  CPU f32 forward (plain versions): {time.perf_counter() - t0:.1f} s")
    gpu = session.model.module
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        got = make_eval_forward(gpu, dtype)(x.cuda()).cpu()
        diff = (got - ref).abs().max().item()
        scale = ref.abs().max().item()
        agree = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
        results[dtype] = (diff, scale, agree)
        print(f"  {str(dtype)[6:]} on card vs f32 CPU: max|dlogit| {diff:.3e} "
              f"({diff / scale:.3e} of max|ref| {scale:.3e}), argmax agreement "
              f"{100 * agree:.4f}%")
    diff, scale, agree = results[torch.float32]
    if not (diff <= 1e-3 * scale and agree >= 0.999):
        _fail("f32 end-to-end parity (limit 1e-3 * max|ref|, >= 99.9% argmax)")
    print("  f32 parity ok (limit 1e-3 * max|ref|, >= 99.9% argmax agreement)")


def _reset_counters():
    """Every counter to 0, the deep and f32 bodies' too; returns the eight
    kernels'."""
    for c in (*_deep_counters().values(), *_f32_counters().values()):
        c.reset()
    counters = _counters()
    for c in counters.values():
        c.reset()
    return counters


def _windows(shape, roi, overlap: float) -> int:
    from segmantic_tpu_torch.infer.sliding_window import window_starts

    return len(window_starts([max(s, r) for s, r in zip(shape, roi)], roi, overlap))


def _labelled_cases(work: Path, names, shape, seed: int, spacing=(1.0, 1.0, 1.0)):
    """``labelled_phantom`` volumes written as image / label NIfTI pairs under
    ``work``; returns (image paths, label paths)."""
    for sub in ("image", "label"):
        (work / sub).mkdir(parents=True, exist_ok=True)
    images, labels = [], []
    for i, name in enumerate(names):
        img, lbl = labelled_phantom(shape, seed + i)
        affine = spacing_affine(spacing, (float(i), -2.0 * i, 0.5 * i))
        images.append(work / "image" / f"{name}.nii.gz")
        labels.append(work / "label" / f"{name}.nii.gz")
        write_nifti(images[-1], img, affine)
        write_nifti(labels[-1], lbl, affine)
    return images, labels


def run_predict(torch, ckpt: Path, work: Path):
    """predict() with labels on two labelled 256x256x176 phantoms on the card:
    per-case Dice and stage seconds, launches against the window count; each
    saved label map bit-equal to segment_volume's for the same volume, each
    confusion matrix (the port's, counted on the card) equal to a numpy
    bincount of the two maps, the Dice and metrics predict reports derived
    from that matrix, and mean_dice.txt two lines plus the mean."""
    import numpy as np

    from segmantic_tpu_torch.infer.predict import predict, segment_volume
    from segmantic_tpu_torch.metrics.overlap import (
        confusion_matrix, confusion_matrix_metrics, dice_from_confusion,
    )
    from segmantic_tpu_torch.train.trainer import (
        SegmentationModel, default_preprocessing, make_val_forward,
    )

    images, labels = _labelled_cases(work, ["scan_a", "scan_b"], EVAL_SHAPE, 60,
                                     spacing=(1.0, 1.0, 1.2))
    out = work / "pred"
    print("  confusion plots off (save_confusion_plots=False): the card's host may lack "
          "matplotlib")
    counters = _reset_counters()
    t0 = time.perf_counter()
    results = predict(ckpt, images, labels, output_dir=out, tissue_dict=CLASS_NAMES,
                      device=DEVICE, save_confusion_plots=False)
    seconds = time.perf_counter() - t0
    launches = {name: c.count for name, c in counters.items()}

    model = SegmentationModel.load(ckpt, device=DEVICE)
    forward = make_val_forward(model.module)
    pre = default_preprocessing(["image", "label"])
    chunks = 0
    for res, image, label in zip(results, images, labels):
        pred, sample = segment_volume(model, {"image": image, "label": label},
                                      val_forward=forward, pre=pre)
        shape = sample["image"].spatial_shape
        n_win = _windows(shape, model.spatial_size, 0.25)
        chunks += -(-n_win // SW_BATCH)
        print(f"  {image.name}: dice {res.dice:.5f}; preprocessed {tuple(shape)} (cropped to "
              f"the label's foreground), {n_win} windows; seconds "
              + ", ".join(f"{k} {v:.3f}" for k, v in res.seconds.items()))
        saved, _ = read_nifti(res.saved_to)
        ref = pred.numpy()[0]
        if saved.shape != ref.shape or not np.array_equal(saved, ref):
            _fail(f"{res.saved_to.name}: the saved map differs from segment_volume's")
        true = read_nifti(label)[0].astype(np.int64)
        ours = saved.astype(np.int64)
        cm = np.bincount(true.ravel() * NUM_CLASSES + ours.ravel(),
                         minlength=NUM_CLASSES ** 2).reshape(NUM_CLASSES, NUM_CLASSES)
        card = confusion_matrix(NUM_CLASSES, torch.from_numpy(true).to(DEVICE),
                                torch.from_numpy(ours).to(DEVICE))
        metrics = confusion_matrix_metrics(cm)
        ok = (np.array_equal(card.cpu().numpy(), cm) and cm.sum() == true.size
              and np.array_equal(res.per_class_dice, dice_from_confusion(cm))
              and all(np.array_equal(res.metrics[k], metrics[k]) for k in metrics))
        print(f"    saved map == segment_volume's bit for bit; confusion matrix on the card "
              f"== numpy bincount, sums to {cm.sum()} voxels: {ok}")
        if not ok:
            _fail(f"{image.name}: confusion matrix or the metrics derived from it")
    lines = (out / "mean_dice.txt").read_text().splitlines()
    mean = float(np.mean([r.dice for r in results]))
    if lines != [f"{r.dice:.6f}" for r in results] + [f"mean\t{mean:.6f}"]:
        _fail(f"mean_dice.txt is not two lines plus the mean: {lines}")
    print(f"  predict(): {seconds:.2f} s for 2 cases; mean_dice.txt {lines}; launches "
          f"{launches}")
    if launches["blend"] != chunks or min(launches[k] for k in EVAL_KERNELS) <= 0:
        _fail(f"expected {chunks} blend launches (one a chunk) and every eval kernel: "
              f"{launches}")
    return launches, {"seconds": seconds, "chunks": chunks}


def run_ensemble(torch, work: Path):
    """ensemble_creator() in mean, vote and select_best over three flagship
    checkpoints (seeds 0, 1, 2, named by checkpoint_filename) on one labelled
    phantom: seconds per case per mode, the sliding window's seconds per
    model; then three copies of one checkpoint, where vote and select_best
    must be bit-equal and mean agree with them on >= 99.99% of voxels."""
    import shutil

    import numpy as np

    from segmantic_tpu_torch.infer.ensemble import ensemble_creator, ensemble_evaluate
    from segmantic_tpu_torch.train.checkpoint import checkpoint_filename
    from segmantic_tpu_torch.train.trainer import SegmentationModel, default_preprocessing
    from segmantic_tpu_torch.utils import config

    images, labels = _labelled_cases(work / "data", ["scan_e"], EVAL_SHAPE, 70)
    models_dir, copies_dir = work / "models", work / "copies"
    models_dir.mkdir(parents=True)
    copies_dir.mkdir()
    ckpts, copies = [], []
    for seed, dice in enumerate((0.8125, 0.75, 0.78125)):
        ckpts.append(models_dir / checkpoint_filename(seed, 0.5, dice))
        make_checkpoint(torch, ckpts[-1], seed=seed, metrics={"val_dice": dice})
        copies.append(copies_dir / checkpoint_filename(seed, 0.5, dice))
        shutil.copyfile(ckpts[0], copies[-1])
    yml = work / "candidates.yml"
    config.dump({f"tissue{k}": (k - 1) % 3 for k in range(1, NUM_CLASSES)}, yml)

    models = [SegmentationModel.load(c, device=DEVICE) for c in ckpts]
    sample = default_preprocessing(["image", "label"])({"image": images[0], "label": labels[0]})
    n_win = _windows(sample["image"].spatial_shape, ROI, 0.5)
    per_model = []
    for model in models:
        ensemble_evaluate([model], sample, ROI)  # warm
        t0 = time.perf_counter()
        ensemble_evaluate([model], sample, ROI)  # ends in the logits' copy to the host
        per_model.append(time.perf_counter() - t0)
    print(f"  preprocessed {tuple(sample['image'].spatial_shape)}, {n_win} windows at overlap "
          f"0.5; sliding window (upload f32, windows, blend, logits to the host) per model: "
          f"{[round(s, 4) for s in per_model]} s")
    del models

    launches, seconds, maps = {}, {}, {}
    for tag, files in (("", ckpts), ("copies ", copies)):
        for mode in ("mean", "vote", "select_best"):
            counters = _reset_counters()
            t0 = time.perf_counter()
            saved = ensemble_creator(files, images, labels, output_dir=work / f"{tag}{mode}",
                                     tissue_dict=CLASS_NAMES, combination_mode=mode,
                                     candidate_per_tissue_path=yml, device=DEVICE)
            seconds[tag + mode] = time.perf_counter() - t0
            got = {name: c.count for name, c in counters.items()}
            for name, n in got.items():
                launches[name] = launches.get(name, 0) + n
            lbl, _ = read_nifti(saved[0])
            maps[tag + mode] = lbl
            print(f"  {tag}{mode}: {saved[0].name} {lbl.shape}, {seconds[tag + mode]:.2f} s "
                  f"for the case; labels per class "
                  f"{np.bincount(lbl.astype(np.int64).ravel(), minlength=NUM_CLASSES).tolist()};"
                  f" launches {got}")
            chunks = 3 * -(-n_win // SW_BATCH)
            if got["blend"] != chunks or min(got[k] for k in EVAL_KERNELS) <= 0:
                _fail(f"{tag}{mode}: expected {chunks} blend launches (3 models) and every "
                      f"eval kernel: {got}")
    same = np.array_equal(maps["copies vote"], maps["copies select_best"])
    agree = float((maps["copies mean"] == maps["copies vote"]).mean())
    print(f"  three copies of one checkpoint: vote == select_best bit for bit {same}; mean "
          f"agrees on {100 * agree:.5f}% of voxels (limit 99.99%)")
    if not same or agree < 0.9999:
        _fail("ensemble of three copies: vote / select_best / mean disagree")
    return launches, seconds


def run_cross_validate(torch, work: Path):
    """cross_validate() on four 128^3 labelled phantoms plus one test phantom:
    one scenario config (flagship defaults, max_epochs 1, device cuda), two
    folds trained one after the other in subprocesses of the port's CLI, then
    predict() on the card with each fold's checkpoints. Launches are this
    process's (the evaluation); the folds' training runs in the subprocesses.
    Prints the launch each fold took: torchrun on every card where
    ``fold_ranks`` counts more than one, the plain process at one card."""
    import numpy as np

    from segmantic_tpu_torch.image.labels import save_tissue_list
    from segmantic_tpu_torch.train.cross_validate import cross_validate, fold_ranks
    from segmantic_tpu_torch.utils import config

    _labelled_cases(work / "data", [f"case{i}" for i in range(4)], (CV_SIZE,) * 3, 80)
    _labelled_cases(work / "test", ["held_out"], (CV_SIZE,) * 3, 90)
    save_tissue_list({k: v for k, v in CLASS_NAMES.items() if v}, work / "tissues.txt")
    (work / "configs").mkdir(parents=True)
    config.dump(CV_SCENARIO, work / "configs" / "flagship.yml")
    counters = _reset_counters()
    t0 = time.perf_counter()
    runs = cross_validate(image_dir=work / "data" / "image",
                          labels_dir=work / "data" / "label",
                          tissue_list=work / "tissues.txt", output_dir=work / "cv",
                          config_files_dir=work / "configs",
                          test_image_dir=work / "test" / "image",
                          test_labels_dir=work / "test" / "label", num_splits=2,
                          device=DEVICE)
    seconds = time.perf_counter() - t0
    cards = fold_ranks(CV_SCENARIO["device"])
    for run in runs:
        torchrun = run.argv[2] == "torch.distributed.run"
        print(f"  fold {run.fold_dir.name} launch ({cards} card(s) counted): "
              f"{'torchrun ' + ' '.join(run.argv[3:6]) if torchrun else 'plain'}: "
              f"{' '.join(run.argv[1:])}")
    launches = {name: c.count for name, c in counters.items()}
    for run in runs:
        ckpts = sorted(p.name for p in run.fold_dir.glob("*.ckpt"))
        lines = ((run.fold_dir / "mean_dice.txt").read_text().splitlines()
                 if (run.fold_dir / "mean_dice.txt").exists() else [])
        print(f"  fold {run.fold_dir.name}: training subprocess exit {run.returncode}, "
              f"{run.train_seconds:.1f} s; evaluation {run.eval_seconds:.1f} s; checkpoints "
              f"{ckpts}; mean_dice.txt {lines}")
        evaluated = [c for c in ckpts if c != "last.ckpt"]
        if run.returncode != 0 or not evaluated or "last.ckpt" not in ckpts:
            _fail(f"fold {run.fold_dir.name}: training failed or wrote no checkpoints")
        if len(lines) != 2 or not np.isfinite(float(lines[0])) \
                or not (run.fold_dir / "held_out.nii.gz").exists():
            _fail(f"fold {run.fold_dir.name}: predict did not evaluate its checkpoint")
    print(f"  cross_validate(): {seconds:.1f} s for {len(runs)} folds; launches of the "
          f"evaluation {launches}")
    if len(runs) != 2 or min(launches[k] for k in EVAL_KERNELS) <= 0:
        _fail(f"expected two folds and every eval kernel in the evaluation: {launches}")
    return launches, {"seconds": seconds,
                      "train_s": [round(r.train_seconds, 3) for r in runs],
                      "eval_s": [round(r.eval_seconds, 3) for r in runs]}


# the two other architectures at full width: train() / create() keywords, the
# stride-1 3^3 convs of a forward on kernel 1 (``convs``) and in phase space on
# kernels 3-4 (``phase_convs``), and which kernel takes the image (its dx is
# skipped; packed UNETR's one-channel input conv runs in phase space): a step
# launches 2 * n (less the input layer's) of each conv kernel, n of its dw
# kernel, and the Dice kernels once each where the top runs in phase space
# (packed UNETR: the phase Dice); ``deep``: of kernel 1's convs, those on the
# deep-channel body a forward (twice that a step), and of kernel 2's a step
ARCHS = {
    "segresnet": {"train": {"arch": "segresnet"}, "create": {"arch": "segresnet"},
                  "convs": 25, "phase_convs": 0, "input": "fused_conv", "phase_dice": False,
                  "deep": (8, 0)},
    "unetr": {"train": {"arch": "unetr", "spatial_size": TRAIN_PATCH,
                        "val_roi_size": TRAIN_PATCH},
              "create": {"arch": "unetr", "spatial_size": TRAIN_PATCH}, "convs": 14,
              "phase_convs": 8, "input": "phase_conv", "phase_dice": True, "deep": (10, 4)},
    # UNETR(pack=False), launch counts only: [unetr-pack]'s A/B builds it
    # from the packed model's weights
    "unetr-unpacked": {"convs": 22, "phase_convs": 0, "input": "fused_conv",
                       "phase_dice": False, "deep": (10, 4)},
}
# (architecture, stored x shape at the training batch, CO, launches of the
# shape a forward): every stride-1 3^3 conv shape of the two on kernel 1 that
# no earlier phase times at batch 8 (packed UNETR's 96^3 and 48^3 convs run in
# phase space: UNETR_PACK_SHAPES), and UNETR(pack=False)'s one-channel input
# layer, which [unetr-pack]'s A/B runs (packed UNETR: 0 a forward)
ARCH_CONV_SHAPES = [
    ("segresnet", (TRAIN_BATCH, 96, 96, 96, 1), 8, 1),
    ("segresnet", (TRAIN_BATCH, 96, 96, 96, 8), 8, 4),
    ("unetr", (TRAIN_BATCH, 96, 96, 96, 1), 16, 0),
    ("unetr", (TRAIN_BATCH, 24, 24, 24, 32), 32, 2),
    ("unetr", (TRAIN_BATCH, 24, 24, 24, 64), 64, 3),
    ("unetr", (TRAIN_BATCH, 24, 24, 24, 128), 64, 1),
    ("unetr", (TRAIN_BATCH, 12, 12, 12, 32), 32, 2),
    ("unetr", (TRAIN_BATCH, 12, 12, 12, 64), 64, 2),
    ("unetr", (TRAIN_BATCH, 12, 12, 12, 128), 128, 3),
    ("unetr", (TRAIN_BATCH, 12, 12, 12, 256), 128, 1),
]


def check_arch_kernels(torch):
    """Kernels 1 and 2 at every new conv shape of SegResNet and UNETR, bf16 at
    the training batch: the forward (limit 2e-2 * max|ref|, as ``[kernels]``)
    and the weight gradient (1e-3 * max|ref|, as ``[train-kernels]``) against
    their plain versions once and bit-equal on a repeated launch, each with
    its body and launch plan (C = 1: the few-channel bodies), timed by
    CUDA-graph replay (the forward with its weights packed once, as
    ``[kernels]``) beside the plain version and
    cuDNN (``F.conv3d``; ``torch.nn.grad.conv3d_weight`` on the bf16
    tensors; median of 5 replays of 5 calls, the plain weight gradient at
    96^3 one replay of one call). Returns {kernel: {...}} as
    :func:`check_kernels`, times and bounds summed over the shapes the default
    paths launch (UNETR(pack=False)'s input layer is checked and timed but
    left out)."""
    import torch.nn.functional as F

    from segmantic_tpu_torch.ops import fused_conv

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(9)  # on the card: ~10^9 values here
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    bf16 = torch.bfloat16
    results = {}
    reps = dict(n=5, launches=5)  # the 96^3 calls take 0.2-3 ms: the host keeps up

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(bf16)

    def check(label, got, want, limit):
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        ref = want.float().abs().max().item()
        ok = err <= limit * ref
        print(f"  {label}: max|d| {err:.3e} (limit {limit * ref:.3e} = {limit:g} * max|ref| "
              f"{ref:.3e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            _fail(f"{label} disagrees with its plain version")
        return err

    for arch, shape, co, per_fwd in ARCH_CONV_SHAPES:
        c = shape[-1]
        x = randn(*shape)
        w = randn(3, 3, 3, c, co, scale=(27 * c) ** -0.5)
        dy = randn(*shape[:4], co)
        dims = tuple(shape[:4])
        label = f"{arch} x{shape}->{co} ({per_fwd} a forward)"
        if not per_fwd:
            label += " [the unpacked A/B's shape: checked, off the kernels line]"
        launched = results if per_fwd else {}  # an unlaunched shape stays out of the line
        # the plain f32 wgrad takes 60-320 ms at 96^3: one timed replay of one call
        slow = dict(n=1, launches=1, warmup=1) if x.numel() * co > 2 ** 28 else reps

        kind, body, _ = conv_body_text(x, c, co, dims, False, sms)
        deep = min(c, co) >= 64
        if kind != ("few_channels" if c < 8 else "deep_channels" if deep else "tensor_cores"):
            _fail(f"fused_conv {label}: the rule sends C = {c} to the {kind} body")
        cache = {}  # the packed weights, packed once: the kernel's time alone
        k = lambda: fused_conv.conv3d(x, w, packed_cache=cache)  # noqa: E731
        pl = lambda: fused_conv.conv3d_plain(x, w)  # noqa: E731
        got = k()
        err = check(f"fused_conv {label}", got, pl(), 2e-2)
        if not torch.equal(got, k()):
            _fail(f"fused_conv {label}: a repeated launch is not bit-equal")
        xc = x.permute(0, 4, 1, 2, 3)
        wc = w.permute(4, 3, 0, 1, 2).contiguous(memory_format=torch.channels_last_3d)
        ms, pms = _graph_ms(torch, k, **reps), _graph_ms(torch, pl, **reps)
        lms = _graph_ms(torch, lambda: F.conv3d(xc, wc, padding=1), **reps)
        print(f"    {body}; kernel {ms:.4f} ms, plain {pms:.4f} ms, cuDNN conv3d {lms:.4f} ms")
        if deep:
            print(f"    the tensor-core body (conv3_mma.cuh) on the same tensors: "
                  f"{tensor_core_conv_ms(torch, x, w):.4f} ms")
        for name in ("fused_conv",) + (("fused_conv_wgmma",) if deep else ()):
            _record(launched, name, err=err, ms=ms, plain_ms=pms,
                    nbytes=_nbytes(x, w, k()), ops=2 * 27 * c * co * (x.numel() // c),
                    peak=PEAK_BF16, library_ms=lms, echo=name == "fused_conv")

        body = dw_body_text(x, c, co, dims, False, sms)[1]
        k = lambda: fused_conv.conv3d_dw(x, dy)  # noqa: E731
        pl = lambda: fused_conv.conv3d_dw_plain(x, dy)  # noqa: E731
        got = k()
        err = check(f"fused_conv_dw {label}", got, pl(), 1e-3)
        if not torch.equal(got, k()):
            _fail(f"fused_conv_dw {label}: a repeated launch is not bit-equal")
        ms, pms = _graph_ms(torch, k, **reps), _graph_ms(torch, pl, **slow)
        lms = _graph_ms(torch, lambda: torch.nn.grad.conv3d_weight(
            xc, (co, c, 3, 3, 3), dy.permute(0, 4, 1, 2, 3), padding=1), **reps)
        print(f"    {body}; kernel {ms:.4f} ms, plain (f32) {pms:.4f} ms, cuDNN bf16 wgrad "
              f"{lms:.4f} ms")
        deep_dw = c >= 64 and co >= 128
        if deep_dw:
            print(f"    the tensor-core body (conv3_dw_mma.cuh) on the same tensors: "
                  f"{tensor_core_dw_ms(torch, x, dy):.4f} ms")
        elif deep:
            rel, dms = deep_dw_entry_ms(torch, x, dy)
            print(f"    the deep-channel body (conv3_dw_wgmma.cuh, left out by the rule at CO < "
                  f"128) on the same tensors: {dms:.4f} ms, max|d| / max|ref| {rel:.2e}")
            if rel > 1e-3:
                _fail(f"fused_conv_dw {label}: the deep-channel body disagrees")
        for name in ("fused_conv_dw",) + (("fused_conv_dw_wgmma",) if deep_dw else ()):
            _record(launched, name, err=err, ms=ms, plain_ms=pms,
                    nbytes=_nbytes(x, dy, got), ops=2 * 27 * c * co * (x.numel() // c),
                    peak=PEAK_BF16, library_ms=lms, echo=name == "fused_conv_dw")
        if deep and c != co:  # the input gradient: the conv co -> c with flipped weights
            check_deep_dx(torch, results, arch, shape, co, g, per_fwd)
    return results


def _launches(counters):
    return {name: c.count for name, c in counters.items()}


def _add_launches(total, got):
    for name, n in got.items():
        total[name] = total.get(name, 0) + n


def arch_launches(spec):
    """({kernel: launches} of a forward, of a train step) for an ``ARCHS``
    entry."""
    deep, deep_dw = spec["deep"]
    per_fwd = {"fused_conv": spec["convs"], "phase_conv": spec["phase_convs"],
               "fused_conv_wgmma": deep}
    per_step = {"fused_conv": 2 * spec["convs"], "phase_conv": 2 * spec["phase_convs"],
                "fused_conv_dw": spec["convs"], "phase_conv_dw": spec["phase_convs"],
                "dice_phase_sums": int(spec["phase_dice"]),
                "dice_phase_dx": int(spec["phase_dice"]),
                "fused_conv_wgmma": 2 * deep, "fused_conv_dw_wgmma": deep_dw}
    if spec["input"] is not None:
        per_step[spec["input"]] -= 1
    return per_fwd, per_step


def input_layer_route(torch, module) -> str:
    """Which kernel and body take the model's 3^3 conv of the one-channel
    image at the training batch, with the body's launch plan."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if hasattr(module, "conv_init"):  # SegResNet
        conv, phase = module.conv_init, False
    else:  # UNETR: its first block, in phase space where packed
        conv, phase = module.encoder1.conv_0, module.encoder1.phase
    c, co = conv.weight.shape[1], conv.weight.shape[0]
    dims = (TRAIN_BATCH,) + TRAIN_PATCH
    probe = torch.empty((1, 1, 1, 1, 1), dtype=torch.bfloat16)
    kernel = "phase_conv / phase_conv_dw" if phase else "fused_conv / fused_conv_dw"
    view = (f"p {tuple(v // 2 for v in TRAIN_PATCH)} x {8 * c}" if phase
            else f"{TRAIN_PATCH[0]}^3 x {c}")
    return (f"{view} -> {co}, {kernel}: conv {conv_body_text(probe, c, co, dims, phase, sms)[1]};"
            f" dw {dw_body_text(probe, c, co, dims, phase, sms)[1]}")


def run_arch(torch, arch: str, data: Path, work: Path):
    """One architecture at full width on the card, 8 classes: ``train()`` for
    two epochs on the phantoms of ``data`` (96^3 bf16 patches, batch 2 x 4,
    Adam 1e-4), the warm step on a fixed 8 x 96^3 batch (Adam 1e-3, CUDA
    events, median of 10) with its peak memory and the loss falling,
    ``predict()`` with labels on one 256x256x176 phantom with its stage
    seconds, three requests through ``make_server(InferenceSession(...))``
    and the sliding window alone on one volume. Each path's launches are
    counted from 0: kernels 1 and 3-4 ``convs`` / ``phase_convs`` a forward
    and twice that a step less the input layer's dx, kernels 2 and 5-6
    ``convs`` / ``phase_convs`` a step, the Dice kernels once a step with
    ``phase_dice``, kernel 7 once a chunk, no other kernel; of kernel 1's
    and 2's, ``deep`` a forward (twice a step) and ``deep`` weight gradients a
    step on the deep-channel bodies."""
    import numpy as np

    from segmantic_tpu_torch.infer.predict import predict
    from segmantic_tpu_torch.train.augment import AugmentConfig
    from segmantic_tpu_torch.train.optim import make_optimizer
    from segmantic_tpu_torch.train.trainer import (
        SegmentationModel, make_train_step, make_val_forward, train,
    )

    spec = ARCHS[arch]
    per_fwd, per_step = arch_launches(spec)
    total = {}

    def launched(counters):  # the eight kernels' and the deep bodies'
        return {**_launches(counters), **_launches(_deep_counters())}

    def expect(where, got, steps=0, chunks=0):
        want = {name: steps * per_step.get(name, 0) + chunks * per_fwd.get(name, 0)
                for name in got}
        want["blend"] = chunks
        print(f"  launches of {where}: {got}")
        if got != want:
            _fail(f"{arch} {where}: expected launches {want}, got {got}")
        _add_launches(total, got)

    counters = _reset_counters()
    t0 = time.perf_counter()
    result = train(image_dir=data / "image", labels_dir=data / "label", output_dir=work / "run",
                   num_classes=NUM_CLASSES, max_epochs=2, seed=0, **spec["train"])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    got = launched(counters)
    for rec in result.history:
        print(f"  epoch {rec['epoch']}: train_loss {rec['train_loss']:.5f} val_loss "
              f"{rec['val_loss']:.5f} val_dice {rec['val_dice']:.5f} "
              f"{rec['train_voxels_per_sec']:.4g} voxels/s (cold), {rec['seconds']:.2f} s")
    print(f"  train(arch={arch!r}): {train_s:.1f} s for 2 epochs of 2 steps + validation")
    finite = all(np.isfinite(v) for rec in result.history for v in rec.values())
    if len(result.history) != 2 or not finite or result.best_checkpoint is None \
            or not (work / "run" / "last.ckpt").exists():
        _fail(f"{arch} train(): not 2 finite epochs with last.ckpt and a best checkpoint")
    expect("train()", got, steps=4, chunks=got["blend"])
    if not got["blend"]:
        _fail(f"{arch} train(): validation launched no blend")

    model = SegmentationModel.create(num_classes=NUM_CLASSES, seed=1, device="cuda",
                                     **spec["create"])
    module = model.module.train().requires_grad_(True)
    opt = make_optimizer(module.parameters(), {"optimizer": "Adam", "lr": 1e-3})
    step = make_train_step(module, opt, AugmentConfig(flip_prob=0.0), TRAIN_PATCH,
                           mixed_precision=True)
    image, label = fixed_batch(torch, TRAIN_BATCH, 20)
    image, label = image.to(torch.bfloat16).cuda(), label.cuda()
    counters = _reset_counters()
    step(image, label)
    torch.cuda.synchronize()
    expect("one train step", launched(counters), steps=1)
    counters = _reset_counters()
    make_val_forward(module)(image[:SW_BATCH])
    torch.cuda.synchronize()
    got = launched(counters)
    print(f"  launches of one eval forward of {SW_BATCH} x 96^3 windows: {got}")
    want = {name: per_fwd.get(name, 0) for name in got}
    if got != want:
        _fail(f"{arch} eval forward: expected launches {want}, got {got}")
    _add_launches(total, got)
    ms, times, loss_hist, peak = warm_steps(torch, step, image, label, n=10)
    voxels = TRAIN_BATCH * int(np.prod(TRAIN_PATCH))
    print(f"  fixed batch {TRAIN_BATCH}x96^3 bf16, Adam lr 1e-3: warm step median {ms:.2f} ms "
          f"(min {min(times):.2f}, max {max(times):.2f}, CUDA events over 10 steps), "
          f"{voxels / ms * 1e3:.4g} labelled voxels/s, peak device memory {peak:.0f} MiB")
    print(f"  loss over 13 steps: {[round(v, 5) for v in loss_hist]}")
    if not all(np.isfinite(loss_hist)) or not loss_hist[-1] < loss_hist[0] - 1e-3:
        _fail(f"{arch}: the loss did not fall over 13 steps on a fixed batch")
    prof = _step_profile(torch, lambda: [step(image, label) for _ in range(3)])
    if not prof["device_ms"]:
        _fail("torch.profiler saw no kernel time on the card")
    kernel_ms, busy = prof["device_ms"] / 3, prof["device_ms"] / prof["wall_ms"]
    print(f"  torch.profiler over 3 steps: {kernel_ms:.2f} ms of kernels a step, busy share "
          f"{busy:.3f}")
    print(f"  the image's 3^3 input layer: {input_layer_route(torch, module)}")
    del module, opt, step, model

    ckpt = result.best_checkpoint
    images, labels = _labelled_cases(work / "data", ["scan"], EVAL_SHAPE, 100,
                                     spacing=(1.0, 1.0, 1.2))
    counters = _reset_counters()
    t0 = time.perf_counter()
    res = predict(ckpt, images, labels, output_dir=work / "pred", tissue_dict=CLASS_NAMES,
                  device=DEVICE, save_confusion_plots=False)[0]
    pred_s = time.perf_counter() - t0
    got = launched(counters)
    print(f"  predict(): {pred_s:.2f} s with the model's load; dice {res.dice:.5f}; seconds "
          + ", ".join(f"{k} {v:.3f}" for k, v in res.seconds.items()))
    saved, _ = read_nifti(res.saved_to)
    if saved.shape != EVAL_SHAPE or saved.max() >= NUM_CLASSES:
        _fail(f"{arch} predict(): the saved label map {saved.shape}")
    expect("predict()", got, chunks=got["blend"])

    (work / "serve").mkdir()
    required = tuple(name for name, n in per_fwd.items() if n and name in _counters())
    required += ("blend",)
    request_s, got, session = serve_requests(torch, ckpt, work / "serve", required=required)
    print(f"  seconds per request: {[round(s, 3) for s in request_s]}")
    expect("the three requests", got, chunks=got["blend"])
    sw_s = device_seconds_per_volume(torch, session, SW_BATCH)
    print(f"  sliding window on the card, one 256x256x176 volume (upload, 12 chunks of "
          f"{SW_BATCH} x 96^3, blend with the weight map): {sw_s:.4f} s (median of 5)")
    del session
    return total, {"train_s": train_s, "step_ms": ms, "kernel_ms": kernel_ms, "busy": busy,
                   "peak_mib": peak, "predict_s": pred_s, "request_s": request_s,
                   "sliding_window_s": sw_s}


# [arch-parity]: (create() keywords, patch) of each architecture's f32 step
# against the f64 CPU step, at full width and batch 1: the f64 CPU step took
# 8.7 s (SegResNet) and 16.1 s (UNETR) on the card's host, under the minute
# beyond which SegResNet would take a 64^3 patch and UNETR 4 layers
ARCH_PARITY = {
    "segresnet": ({"arch": "segresnet"}, TRAIN_PATCH),
    "unetr": ({"arch": "unetr", "spatial_size": TRAIN_PATCH}, TRAIN_PATCH),
}


def arch_parity(torch):
    """One f32 train step of SegResNet and UNETR on the card against the f64
    CPU step, judged per gradient tensor as ``[train-parity]``, batch 1."""
    for arch, (kw, patch) in ARCH_PARITY.items():
        image, label = fixed_batch(torch, 1, 41, size=patch[0])
        print(f"  {arch} {kw}, batch 1 x {patch}")
        step_parity(torch, dict(num_classes=NUM_CLASSES, seed=3, **kw), image, label, patch)


# [unetr-pack]: every phase-space conv shape of packed UNETR (feature 16) at the
# training batch: (stored phase tensor, true CI, CO, launches a forward, layers);
# the one-channel input conv runs on the few-channel bodies of kernels 3-6 (the
# faster of its two routes, both timed here) and takes no dx (the image needs
# none), every other conv does
UNETR_PACK_SHAPES = [
    ((TRAIN_BATCH, 48, 48, 48, 8), 1, 16, 1, "encoder1.conv_0"),
    ((TRAIN_BATCH, 48, 48, 48, 128), 16, 16, 2, "encoder1.conv_1, decoder2_conv.conv_1"),
    ((TRAIN_BATCH, 48, 48, 48, 256), 32, 16, 1, "decoder2_conv.conv_0"),
    ((TRAIN_BATCH, 24, 24, 24, 256), 32, 32, 3,
     "encoder2_conv_2.conv_0, encoder2_conv_2.conv_1, decoder3_conv.conv_1"),
    ((TRAIN_BATCH, 24, 24, 24, 512), 64, 32, 1, "decoder3_conv.conv_0"),
]
AB_ROUNDS, AB_STEPS = 4, 5  # the interleaved A/B: rounds of timed steps of each graph


def check_unetr_pack_kernels(torch):
    """Kernels 3-6 at every phase-space conv shape of packed UNETR, bf16 at
    the training batch: the forward (limit 2e-2 * max|ref|), the input
    gradient where CI differs from CO (the forward on the flipped, io-swapped
    kernel, another shape; a square conv's dx has its forward's shape; limit
    2e-2 * max|ref|) and the weight gradient (1e-3 * max|ref|) against
    ``phase_conv_plain`` / ``phase_conv_dw_plain`` once, each with its body
    and launch plan (CI = 1: the few-channel bodies) and a repeated launch
    bit-equal, timed by CUDA-graph replay (median of 5
    replays of 5 calls; the plain forward uploads its selection tensor, so it
    is timed eagerly) beside the plain version, the bound and cuDNN on the
    full-resolution view (the rearrangement not timed, as ``[kernels]``). For
    the convs whose CI differs from CO, which the JAX package leaves to XLA,
    the two routes a step could take are timed whole: the phase kernels
    (forward, dx and dw) against cuDNN's forward, dgrad and wgrad on the
    ``depth_to_space`` views with the rearrangements (the input layer takes no
    dx). Returns {kernel: {...}} as :func:`check_kernels`, times and bounds
    summed over the shapes the path launches, and {layers: (kernel route ms,
    cuDNN route ms)}; the input layer's f32 pair too (its CUDA-core phase
    bodies against cuDNN with TF32 off and on), under "<layers> f32"."""
    import torch.nn.functional as F

    from segmantic_tpu_torch.ops import fused_conv, phase_conv
    from segmantic_tpu_torch.ops.fast_conv import depth_to_space, space_to_depth

    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(12)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    bf16 = torch.bfloat16
    results, routes = {}, {}
    reps = dict(n=5, launches=5)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(bf16)

    def check(label, got, want, limit):
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        ref = want.float().abs().max().item()
        ok = err <= limit * ref
        print(f"  {label}: max|d| {err:.3e} (limit {limit * ref:.3e} = {limit:g} * max|ref| "
              f"{ref:.3e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            _fail(f"{label} disagrees with its plain version")
        return err

    def ncdhw(t):  # channel-last (B, D, H, W, C) -> the NCDHW view cuDNN takes
        return t.permute(0, 4, 1, 2, 3)

    def conv_body(t, c_in, c_out):  # the forward's body and launch plan on phase tensor t
        full = (t.shape[0],) + tuple(2 * v for v in t.shape[1:4])
        kind, text, _ = conv_body_text(t, c_in, c_out, full, True, sms)
        if kind != ("few_channels" if c_in < 8 else "tensor_cores"):
            _fail(f"phase_conv p{tuple(t.shape)}: the rule sends CI = {c_in} to the {kind} body")
        return text

    def check_conv(label, t, wk, library):
        """The forward kernel on phase tensor t and kernel wk against its plain
        version, on repeat and timed beside ``library``: (error, kernel ms,
        plain ms, library ms, bytes, operations)."""
        c_in, c_out = wk.shape[-2:]
        k = lambda: phase_conv.phase_conv(t, wk)  # noqa: E731
        pl = lambda: phase_conv.phase_conv_plain(t, wk)  # noqa: E731
        got = k()
        err = check(label, got, pl(), 2e-2)
        if not torch.equal(got, k()):
            _fail(f"{label}: a repeated launch is not bit-equal")
        ms, pms = _graph_ms(torch, k, **reps), _median_ms(torch, pl, n=3, warmup=1)
        lms = _graph_ms(torch, library, **reps)
        print(f"    {conv_body(t, c_in, c_out)}; kernel {ms:.4f} ms, plain {pms:.4f} ms "
              f"(eager), cuDNN at full resolution {lms:.4f} ms")
        return err, ms, pms, lms, _nbytes(t, wk, got), 2 * 27 * c_in * c_out * (t.numel() // c_in)

    for shape, ci, co, per_fwd, layers in UNETR_PACK_SHAPES:
        launched = results if per_fwd else {}  # an unlaunched shape stays out of the line
        p = randn(*shape)
        w = randn(3, 3, 3, ci, co, scale=(27 * ci) ** -0.5)
        gy = randn(*shape[:4], 8 * co)
        full = (shape[0],) + tuple(2 * v for v in shape[1:4])
        label = f"p{shape} CI {ci} -> CO {co} ({layers}; {per_fwd} a forward)"
        x_full, g_full = depth_to_space(p, ci), depth_to_space(gy, co)
        wc = w.permute(4, 3, 0, 1, 2).contiguous(memory_format=torch.channels_last_3d)
        err, ms, pms, lms, nbytes, ops = check_conv(
            f"phase_conv {label}", p, w, lambda: F.conv3d(ncdhw(x_full), wc, padding=1))
        _record(launched, "phase_conv", err=err, ms=ms, plain_ms=pms, nbytes=nbytes, ops=ops,
                peak=PEAK_BF16, library_ms=lms)

        with_dx = ci > 1  # the layer that takes the one-channel image has no dx
        wt = fused_conv.flip_io(w)
        if with_dx and ci != co:
            err, ms, pms, lms, nbytes, ops = check_conv(
                f"phase_conv dx (L {8 * co} -> {8 * ci}) {label}", gy, wt,
                lambda: torch.nn.grad.conv3d_input(ncdhw(x_full).shape, wc, ncdhw(g_full),
                                                   padding=1))
            _record(launched, "phase_conv", err=err, ms=ms, plain_ms=pms, nbytes=nbytes,
                    ops=ops, peak=PEAK_BF16, library_ms=lms)

        body = dw_body_text(p, ci, co, full, True, sms)[1]
        k = lambda: phase_conv.phase_conv_dw(p, gy)  # noqa: E731
        pl = lambda: phase_conv.phase_conv_dw_plain(p, gy)  # noqa: E731
        got = k()
        err = check(f"phase_conv_dw {label}", got, pl(), 1e-3)
        if not torch.equal(got, k()):
            _fail(f"phase_conv_dw {label}: a repeated launch is not bit-equal")
        slow = dict(n=1, launches=1, warmup=1)  # the plain f32 dw: 60-340 ms a call
        ms, pms = _graph_ms(torch, k, **reps), _graph_ms(torch, pl, **slow)
        wshape = (co, ci, 3, 3, 3)
        lms = _graph_ms(torch, lambda: torch.nn.grad.conv3d_weight(
            ncdhw(x_full), wshape, ncdhw(g_full), padding=1), **reps)
        print(f"    {body}; kernel {ms:.4f} ms, plain (f32) {pms:.4f} ms, cuDNN bf16 wgrad "
              f"{lms:.4f} ms")
        _record(launched, "phase_conv_dw", err=err, ms=ms, plain_ms=pms,
                nbytes=_nbytes(p, gy, got), ops=2 * 27 * ci * co * (p.numel() // ci),
                peak=PEAK_BF16, library_ms=lms)

        if ci == co:
            continue

        def kernel_route():
            phase_conv.phase_conv(p, w)
            if with_dx:
                phase_conv.phase_conv(gy, wt)
            phase_conv.phase_conv_dw(p, gy)

        def cudnn_route():
            xf, gf = ncdhw(depth_to_space(p, ci)), ncdhw(depth_to_space(gy, co))
            space_to_depth(F.conv3d(xf, wc, padding=1).permute(0, 2, 3, 4, 1))
            if with_dx:
                space_to_depth(torch.nn.grad.conv3d_input(
                    xf.shape, wc, gf, padding=1).permute(0, 2, 3, 4, 1))
            torch.nn.grad.conv3d_weight(xf, wshape, gf, padding=1)

        kms, cms = _graph_ms(torch, kernel_route, **reps), _graph_ms(torch, cudnn_route, **reps)
        routes[layers] = (kms, cms)
        print(f"    a step's {'forward, dx and dw' if with_dx else 'forward and dw'}: phase "
              f"kernels {kms:.4f} ms, cuDNN on the depth_to_space views with the "
              f"rearrangements {cms:.4f} ms ({'kernels' if kms <= cms else 'cuDNN'} faster)")
        if ci == 1:  # f32 (mixed_precision=False) takes the f32 phase bodies
            p32, gy32, w32, wc32 = p.float(), gy.float(), w.float(), wc.float()
            kind = conv_body_text(p32, ci, co, full, True, sms)[0]
            if kind != "f32_tiles" or fused_conv.dw_body(p32, ci, co, True) != "f32_tiles":
                _fail(f"phase_conv {label}: the rule sends f32 to the {kind} body")

            def kernel_f32():
                phase_conv.phase_conv(p32, w32)
                phase_conv.phase_conv_dw(p32, gy32)

            def cudnn_f32():
                xf, gf = ncdhw(depth_to_space(p32, ci)), ncdhw(depth_to_space(gy32, co))
                space_to_depth(F.conv3d(xf, wc32, padding=1).permute(0, 2, 3, 4, 1))
                torch.nn.grad.conv3d_weight(xf, wshape, gf, padding=1)

            kms, cms = _graph_ms(torch, kernel_f32, **reps), _graph_ms(torch, cudnn_f32, **reps)
            tf32 = torch.backends.cudnn.allow_tf32
            torch.backends.cudnn.allow_tf32 = True  # PyTorch's default for cuDNN
            try:
                tms = _graph_ms(torch, cudnn_f32, **reps)
            finally:
                torch.backends.cudnn.allow_tf32 = tf32
            routes[f"{layers} f32"] = (kms, cms, tms)
            print(f"    f32, a step's forward and dw: phase kernels (f32 bodies) "
                  f"{kms:.4f} ms, cuDNN on the depth_to_space views {cms:.4f} ms with "
                  f"TF32 off, {tms:.4f} ms with TF32 on")
    return results, routes


def unetr_pack_ab(torch):
    """The packed UNETR step against the unpacked one at full width (feature
    16, 8 classes), from the same weights on one fixed 8 x 96^3 bf16 batch
    (Adam 1e-3, flips off): the first step of each with its launches (packed:
    kernels 1-6 and the Dice kernels, ``ARCHS["unetr"]``; unpacked: kernels
    1-2 alone, 43 and 22) and the two losses; then, interleaved A B B A,
    ``AB_ROUNDS`` rounds of :func:`warm_steps` (3 warm-up and ``AB_STEPS``
    timed steps, CUDA events) of each with each graph's peak memory, and
    three steps of each under ``torch.profiler``: device kernel ms a step and
    the busy share (kernel ms over the profiled wall ms).
    Returns the packed step's launches and the numbers."""
    from segmantic_tpu_torch.models.unetr import UNETR
    from segmantic_tpu_torch.train.augment import AugmentConfig
    from segmantic_tpu_torch.train.optim import make_optimizer
    from segmantic_tpu_torch.train.trainer import SegmentationModel, make_train_step

    kw = ARCHS["unetr"]["create"]
    model = SegmentationModel.create(num_classes=NUM_CLASSES, seed=1, device=DEVICE, **kw)
    packed = model.module
    unpacked = UNETR(spatial_size=kw["spatial_size"], out_channels=NUM_CLASSES, pack=False,
                     **kw.get("arch_params", {}))
    unpacked.load_state_dict(packed.state_dict())
    if not packed.pack or not packed.phase_top_ok() or unpacked.phase_top_ok():
        _fail("create(arch='unetr') is not the packed graph")
    image, label = fixed_batch(torch, TRAIN_BATCH, 20)
    image, label = image.to(DEVICE, torch.bfloat16), label.to(DEVICE)
    steps, launches, losses = {}, {}, {}
    for name, module in (("packed", packed), ("unpacked", unpacked.to(DEVICE))):
        module = module.train().requires_grad_(True)
        opt = make_optimizer(module.parameters(), {"optimizer": "Adam", "lr": 1e-3})
        steps[name] = make_train_step(module, opt, AugmentConfig(flip_prob=0.0), TRAIN_PATCH,
                                      mixed_precision=True)
        counters = _reset_counters()
        losses[name] = steps[name](image, label).item()
        launches[name] = _launches(counters)
        print(f"  {name}: first-step loss {losses[name]:.6f}, launches {launches[name]}")
    for name, spec in (("packed", ARCHS["unetr"]), ("unpacked", ARCHS["unetr-unpacked"])):
        per_step = arch_launches(spec)[1]
        want = {k: per_step.get(k, 0) for k in launches[name]}
        if launches[name] != want:
            _fail(f"the {name} UNETR step launched {launches[name]}, expected {want}")
    rel = abs(losses["packed"] - losses["unpacked"]) / abs(losses["unpacked"])
    print(f"  first-step losses {rel:.3e} apart, relative (bf16; the same function)")
    if rel > 1e-2:
        _fail("the packed and unpacked UNETR steps disagree on the first loss")
    times = {name: [] for name in steps}
    peaks = {name: 0.0 for name in steps}
    order = list(steps)
    for r in range(AB_ROUNDS):
        for name in (order if r % 2 == 0 else order[::-1]):
            _, t, _, peak = warm_steps(torch, steps[name], image, label, n=AB_STEPS)
            times[name] += t
            peaks[name] = max(peaks[name], peak)
    numbers = {}
    for name in steps:
        prof = _step_profile(torch, lambda: [steps[name](image, label) for _ in range(3)])
        if not prof["device_ms"]:
            _fail("torch.profiler saw no kernel time on the card")
        ms = statistics.median(times[name])
        numbers[name] = {"step_ms": ms, "min_ms": min(times[name]), "max_ms": max(times[name]),
                         "kernel_ms": prof["device_ms"] / 3, "busy": prof["device_ms"] /
                         prof["wall_ms"], "peak_mib": peaks[name]}
        print(f"  {name}: warm step median {ms:.2f} ms (min {min(times[name]):.2f}, max "
              f"{max(times[name]):.2f}; {len(times[name])} steps in {AB_ROUNDS} interleaved "
              f"rounds), {image[..., 0].numel() / ms * 1e3:.4g} labelled voxels/s, peak "
              f"{peaks[name]:.0f} MiB; torch.profiler over 3 steps: {prof['device_ms'] / 3:.2f}"
              f" ms of kernels a step, busy share {numbers[name]['busy']:.3f}")
    ratio = numbers["packed"]["step_ms"] / numbers["unpacked"]["step_ms"]
    print(f"  packed / unpacked step: {ratio:.3f}; kernel ms "
          f"{numbers['packed']['kernel_ms'] / numbers['unpacked']['kernel_ms']:.3f}")
    return launches["packed"], numbers


def run_train_extras(torch, data: Path, out: Path):
    """The flagship ``train()`` with ``accumulate_steps=2``, ``remat=True``,
    ``val_blend_mode="constant"`` and a ``profile_dir`` on the phantoms of
    ``data``: two finite epochs and a trace file with the card's kernels in
    it; then the warm step on a fixed 8 x 96^3 batch with and without
    ``remat`` (CUDA events, median of 10) and the peak memory of each."""
    import numpy as np

    from segmantic_tpu_torch.train.augment import AugmentConfig
    from segmantic_tpu_torch.train.optim import make_optimizer
    from segmantic_tpu_torch.train.trainer import SegmentationModel, make_train_step, train

    counters = _reset_counters()
    t0 = time.perf_counter()
    result = train(image_dir=data / "image", labels_dir=data / "label", output_dir=out / "run",
                   num_classes=NUM_CLASSES, max_epochs=2, accumulate_steps=2, remat=True,
                   val_blend_mode="constant", profile_dir=out / "profile", seed=0)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _launches(counters)
    for rec in result.history:
        print(f"  epoch {rec['epoch']}: train_loss {rec['train_loss']:.5f} val_loss "
              f"{rec['val_loss']:.5f} val_dice {rec['val_dice']:.5f}, {rec['seconds']:.2f} s")
    print(f"  train(accumulate_steps=2, remat=True, val_blend_mode='constant', profile_dir=...)"
          f": {seconds:.1f} s for 2 epochs of 2 micro-batches + validation; launches {launches}")
    finite = all(np.isfinite(v) for rec in result.history for v in rec.values())
    if len(result.history) != 2 or not finite:
        _fail("train() with the extras: history is not 2 finite epochs")
    if min(n for name, n in launches.items() if name != "shear_group") <= 0:
        _fail(f"a kernel of the training path was never launched: {launches}")
    traces = sorted((out / "profile").glob("*.json"))
    kernels = 0
    for path in traces:
        events = json.loads(path.read_text()).get("traceEvents", [])
        kernels += sum(1 for e in events if e.get("cat") == "kernel")
    print(f"  profile_dir: {[p.name for p in traces]}, {kernels} kernel events on the card")
    if not traces or kernels <= 0:
        _fail("profile_dir holds no trace with kernel events")

    image, label = fixed_batch(torch, TRAIN_BATCH, 20)
    image, label = image.to(torch.bfloat16).cuda(), label.cuda()
    numbers = {}
    for remat in (False, True):
        model = SegmentationModel.create(num_classes=NUM_CLASSES, seed=1, device="cuda")
        module = model.module.train().requires_grad_(True)
        opt = make_optimizer(module.parameters(), {"optimizer": "Adam", "lr": 1e-3})
        step = make_train_step(module, opt, AugmentConfig(flip_prob=0.0), TRAIN_PATCH,
                               mixed_precision=True, remat=remat)
        ms, times, loss_hist, peak = warm_steps(torch, step, image, label, n=10)
        numbers[f"remat={remat}"] = {"step_ms": ms, "peak_mib": peak}
        print(f"  remat={remat}: warm step median {ms:.2f} ms (min {min(times):.2f}, max "
              f"{max(times):.2f}, 10 steps), peak device memory {peak:.0f} MiB, loss "
              f"{loss_hist[0]:.5f} -> {loss_hist[-1]:.5f}")
        if not all(np.isfinite(loss_hist)) or not loss_hist[-1] < loss_hist[0] - 1e-3:
            _fail(f"remat={remat}: the loss did not fall on a fixed batch")
        del module, opt, step, model
    return launches, numbers


# -- 2D segmentation ----------------------------------------------------------

# launches of kernels 9, 8 and 7 a 2D train step (PERF.md, section 6): the
# phase-major Dice's two sweeps; with the spatial augmentation the rotation
# groups of the bf16 images (a 384^2 plane of 297 KB, held in global scratch)
# and of the uint8 labels (148 KB, in shared memory); no blend outside
# validation. Every 2D conv is F.conv2d / F.conv_transpose2d (kernels 1-6
# are 3D).
STEP_2D = {"dice_phase_sums": 1, "dice_phase_dx": 1, "shear_group": 0, "blend": 0}
STEP_2D_AUG = dict(STEP_2D, shear_group=2)


def _expect_only(where, got, want):
    """``got`` launches equal ``want`` for the kernels it names and 0 for
    every other kernel."""
    full = {name: want.get(name, 0) for name in got}
    print(f"  launches of {where}: {got}")
    if got != full:
        _fail(f"{where}: expected launches {full}, got {got}")


def _validation_chunks(run: Path, roi, sw_batch: int = 4) -> int:
    """Blend launches of one validation epoch of ``train()``: the chunks of
    the validation volumes of ``run/Dataset.json`` after the default
    preprocessing."""
    from segmantic_tpu_torch.train.trainer import default_preprocessing

    pre = default_preprocessing(["image", "label"])
    chunks = 0
    for case in json.loads((run / "Dataset.json").read_text())["validation"]:
        sample = pre({"image": Path(case["image"]), "label": Path(case["label"])})
        chunks += -(-_windows(sample["image"].spatial_shape, roi, 0.25) // sw_batch)
    return chunks


def run_train_2d(torch, work: Path):
    """The flagship UNet in 2D at full width (16-32-64-128-256, strides 2^4,
    2 residual units, BatchNorm, PReLU, 8 classes, 256^2 patches): ``train()``
    for two epochs on 4 + 1 labelled 512^2 phantoms (its checkpoint feeds
    ``[serve-2d]`` and ``[predict-2d]``), then on a fixed 16 x 256^2 bf16
    batch with Adam the warm step plain and with the fused augmentation
    (16 x 384^2 margin patches in), and the 2D SegResNet's warm step, plain:
    CUDA events, median of 10, peak memory, labelled pixels per second, and
    the launches of kernels 9, 8 and 7 a step against ``STEP_2D``."""
    import numpy as np

    from segmantic_tpu_torch.train.augment import AugmentConfig, augment_batch
    from segmantic_tpu_torch.train.optim import make_optimizer
    from segmantic_tpu_torch.train.trainer import SegmentationModel, make_train_step, train

    data = work / "data"
    for sub in ("image", "label"):
        (data / sub).mkdir(parents=True)
    for i in range(5):
        img, lbl = labelled_phantom(PHANTOM_2D, 200 + i)
        write_nifti(data / "image" / f"slice{i}.nii.gz", img, np.eye(4))
        write_nifti(data / "label" / f"slice{i}.nii.gz", lbl, np.eye(4))
    counters = _reset_counters()
    t0 = time.perf_counter()
    result = train(image_dir=data / "image", labels_dir=data / "label", output_dir=work / "run",
                   num_classes=NUM_CLASSES, spatial_dims=2, spatial_size=TRAIN_2D_PATCH,
                   max_epochs=2, seed=0)  # device: the default, the card
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    total = _launches(counters)
    for rec in result.history:
        print(f"  epoch {rec['epoch']}: train_loss {rec['train_loss']:.5f} val_loss "
              f"{rec['val_loss']:.5f} val_dice {rec['val_dice']:.5f} "
              f"{rec['train_voxels_per_sec']:.4g} pixels/s (cold), {rec['seconds']:.2f} s")
    print(f"  train(spatial_dims=2): {train_s:.1f} s for 2 epochs of 2 steps + validation "
          f"(roi 160^2)")
    finite = all(np.isfinite(v) for rec in result.history for v in rec.values())
    if len(result.history) != 2 or not finite or result.best_checkpoint is None \
            or not (work / "run" / "last.ckpt").exists():
        _fail("2D train(): not 2 finite epochs with last.ckpt and a best checkpoint")
    val_chunks = 2 * _validation_chunks(work / "run", (160, 160))
    _expect_only("train() in 2D", total, {"dice_phase_sums": 4, "dice_phase_dx": 4,
                                          "blend": val_chunks})
    model = SegmentationModel.load(result.best_checkpoint, device="cpu")
    if model.spatial_dims != 2 or model.spatial_size != list(TRAIN_2D_PATCH):
        _fail(f"the 2D checkpoint reads back as {model.spatial_dims}D {model.spatial_size}")

    pixels = TRAIN_2D_BATCH * int(np.prod(TRAIN_2D_PATCH))
    numbers = {"train_s": train_s}
    size, volume = TRAIN_2D_PATCH[0], PHANTOM_2D[0]
    image, label = fixed_batch(torch, TRAIN_2D_BATCH, 20, size=size, volume=volume, nd=2)
    # the sampler's margin patches: 256 + 2 * (256 // 4) = 384
    margin_image, margin_label = fixed_batch(torch, TRAIN_2D_BATCH, 60, size=size + size // 2,
                                             volume=volume, nd=2)
    aug = AugmentConfig(spatial=True, intensity=True)
    for name, create, cfg, batch, per_step in (
            ("unet", {}, AugmentConfig(flip_prob=0.0), (image, label), STEP_2D),
            ("unet-augmented", {}, aug, (margin_image, margin_label), STEP_2D_AUG),
            ("segresnet", {"arch": "segresnet"}, AugmentConfig(flip_prob=0.0), (image, label),
             {})):
        model = SegmentationModel.create(num_classes=NUM_CLASSES, spatial_dims=2,
                                         spatial_size=TRAIN_2D_PATCH, seed=1, device="cuda",
                                         **create)
        module = model.module.train().requires_grad_(True)
        opt = make_optimizer(module.parameters(), {"optimizer": "Adam", "lr": 1e-3})
        step = make_train_step(module, opt, cfg, TRAIN_2D_PATCH, mixed_precision=True,
                               generator=torch.Generator().manual_seed(4))
        img, lbl = batch[0].to(torch.bfloat16).cuda(), batch[1].cuda()
        counters = _reset_counters()
        step(img, lbl)
        torch.cuda.synchronize()
        got = _launches(counters)
        _expect_only(f"one {name} step", got, per_step)
        _add_launches(total, got)
        ms, times, loss_hist, peak = warm_steps(torch, step, img, lbl, n=10)
        extra = ""
        if cfg.spatial:
            gen = torch.Generator().manual_seed(3)
            aug_ms = _median_ms(torch, lambda: augment_batch(img, lbl, gen, cfg, TRAIN_2D_PATCH),
                                n=10)
            numbers[f"{name}_augment_ms"] = aug_ms
            extra = f"; the augmentation alone {aug_ms:.2f} ms"
        numbers[name] = {"step_ms": ms, "pixels_per_s": pixels / ms * 1e3, "peak_mib": peak}
        print(f"  {name}: fixed batch {tuple(img.shape)} bf16, Adam lr 1e-3: warm step median "
              f"{ms:.2f} ms (min {min(times):.2f}, max {max(times):.2f}, 10 steps), "
              f"{pixels / ms * 1e3:.4g} labelled pixels/s, peak device memory {peak:.0f} MiB"
              f"{extra}; loss {loss_hist[0]:.5f} -> {loss_hist[-1]:.5f}")
        if not all(np.isfinite(loss_hist)) or not min(loss_hist[-5:]) < loss_hist[0] - 1e-3:
            _fail(f"2D {name}: the loss did not fall over 13 steps on a fixed batch")
        del module, opt, step, model
    return total, numbers, result.best_checkpoint


def train_parity_2d(torch):
    """One f32 train step of the 2D UNet and the 2D SegResNet at full width,
    batch 2 x 256^2, on the card against the f64 CPU step, judged per
    gradient tensor as ``[train-parity]``. Every 2D conv is cuDNN's, so this
    holds cuDNN to f32 as TF32 off does for the 3D phases: with its
    deterministic algorithms (``cudnn.deterministic``, for this phase only).
    Its default weight-gradient algorithm at the deepest 2D conv-transpose
    (384 -> 64 channels, 16^2 -> 32^2) lands 1.8e-6 from the f64 gradient,
    3.9 times that tensor's limit; the deterministic ones hold it to f32."""
    image, label = fixed_batch(torch, 2, 40, size=TRAIN_2D_PATCH[0], volume=PHANTOM_2D[0], nd=2)
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for arch in ("unet", "segresnet"):
            print(f"  {arch} 2D, batch 2 x {TRAIN_2D_PATCH} (cudnn.deterministic)")
            step_parity(torch, dict(num_classes=NUM_CLASSES, seed=2, spatial_dims=2,
                                    spatial_size=TRAIN_2D_PATCH, arch=arch),
                        image, label, TRAIN_2D_PATCH)
    finally:
        torch.backends.cudnn.deterministic = old


def parity_2d(torch, ckpt: Path, image):
    """The sliding window over one preprocessed 2D image (numpy (H, W, 1)) in
    f32, the checkpoint's forward on the card against the same on the CPU:
    logits within 1e-4 * max|ref|, and the argmax equal at every pixel whose
    two largest CPU logits lie further apart than that limit (closer ones are
    ties at f32's summation noise: their count is printed)."""
    from segmantic_tpu_torch.infer.sliding_window import sliding_window_inference
    from segmantic_tpu_torch.train.trainer import SegmentationModel, make_val_forward

    logits = {}
    for device in ("cuda", "cpu"):
        model = SegmentationModel.load(ckpt, device=device)
        t0 = time.perf_counter()
        logits[device] = sliding_window_inference(
            image, model.spatial_size, SW_BATCH_2D, make_val_forward(model.module,
                                                                    torch.float32),
            overlap=0.25, num_classes=model.num_classes, device=device).cpu()
        print(f"  f32 sliding window on the {device}: {time.perf_counter() - t0:.2f} s")
    got, ref = logits["cuda"], logits["cpu"]
    diff = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    limit = 1e-4 * scale
    top2 = ref.topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > limit
    same = got.argmax(-1) == ref.argmax(-1)
    agree = same.float().mean().item()
    agree_decided = same[decided].float().mean().item()
    print(f"  card vs CPU, f32: max|dlogit| {diff:.3e} ({diff / scale:.3e} of max|ref| "
          f"{scale:.3e}; limit 1e-4); argmax agreement {100 * agree:.5f}% of "
          f"{same.numel()} pixels, {100 * agree_decided:.5f}% of the "
          f"{int(decided.sum())} whose top two logits differ by more than the limit "
          f"({int((~decided).sum())} closer)")
    if not (diff <= limit and agree_decided == 1.0):
        _fail("2D card vs CPU parity (logits 1e-4 * max|ref|, argmax 100% where decided)")
    return agree


def run_serve_2d(torch, ckpt: Path, work: Path):
    """The 2D checkpoint of ``[train-2d]`` behind ``make_server`` with sw-batch
    16: one 1024 x 1024 single-channel image (roi the checkpoint's 256^2,
    overlap 0.25, 25 windows in 2 chunks); the served map must equal
    ``segment_volume``'s on the card (stage seconds printed), the blend
    launch once a chunk and nothing else, and the forward hold against the
    CPU (:func:`parity_2d`)."""
    import numpy as np

    from segmantic_tpu_torch.infer.predict import segment_volume
    from segmantic_tpu_torch.serve import InferenceSession, make_server

    work.mkdir(parents=True)
    img = labelled_phantom(EVAL_2D_SHAPE, 300)[0]
    affine = spacing_affine((0.5, 0.6, 1.0), (4.0, -3.0, 0.0))
    path = work / "image2d.nii.gz"
    write_nifti(path, img, affine)
    session = InferenceSession(ckpt, sw_batch_size=SW_BATCH_2D, device="cuda")
    server = make_server(session, host="127.0.0.1", port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    seconds = []
    try:
        with urllib.request.urlopen(f"{base}/v1/info", timeout=60) as r:
            info = json.loads(r.read())
        if info.get("spatial_dims") != 2:
            _fail(f"/v1/info of the 2D checkpoint: {info}")
        counters = _reset_counters()
        for _ in range(2):  # the first request is cold
            req = urllib.request.Request(f"{base}/v1/segment", data=path.read_bytes(),
                                         method="POST")
            t0 = time.perf_counter()
            with urllib.request.urlopen(req, timeout=600) as r:
                status, body = r.status, r.read()
            seconds.append(time.perf_counter() - t0)
        launches = _launches(counters)
    finally:
        server.shutdown()
        thread.join(timeout=60)
        server.server_close()
    out = work / "served.nii.gz"
    out.write_bytes(body)
    served, served_affine = read_nifti(out)
    chunks = -(-_windows(EVAL_2D_SHAPE, TRAIN_2D_PATCH, 0.25) // SW_BATCH_2D)
    print(f"  POST /v1/segment {EVAL_2D_SHAPE}: HTTP {status}, seconds "
          f"{[round(s, 3) for s in seconds]}, grid {served.shape}, labels per class "
          f"{np.bincount(served.astype(np.int64).ravel(), minlength=NUM_CLASSES).tolist()}")
    if status != 200 or served.shape != EVAL_2D_SHAPE or served.max() >= NUM_CLASSES \
            or not np.allclose(served_affine, affine, atol=1e-4):
        _fail("the 2D request: status, grid, affine or label values")
    _expect_only("the two 2D requests", launches, {"blend": 2 * chunks})
    stage = {}
    pred, sample = segment_volume(session.model, path, val_forward=session.val_forward,
                                  sw_batch_size=SW_BATCH_2D, seconds=stage)
    print("  segment_volume on the card, seconds " + ", ".join(
        f"{k} {v:.3f}" for k, v in stage.items()))
    if not np.array_equal(pred.numpy()[0], served):
        _fail("the served 2D map differs from segment_volume's")
    del session
    parity_2d(torch, ckpt, np.moveaxis(sample["image"].numpy(), 0, -1))
    return launches, {"request_s": seconds, "stage_s": stage}


def run_predict_2d(torch, ckpt: Path, work: Path):
    """``predict()`` with labels on a labelled 1024 x 1024 phantom with the 2D
    checkpoint (sw-batch 4): Dice and stage seconds, the saved map equal to
    ``segment_volume``'s on the card, its confusion matrix to a numpy
    bincount, the blend launched once a chunk and nothing else, and the
    forward held against the CPU (:func:`parity_2d`)."""
    import numpy as np

    from segmantic_tpu_torch.infer.predict import predict, segment_volume
    from segmantic_tpu_torch.metrics.overlap import dice_from_confusion
    from segmantic_tpu_torch.train.trainer import (
        SegmentationModel, default_preprocessing, make_val_forward,
    )

    images, labels = _labelled_cases(work, ["slice_a"], EVAL_2D_SHAPE, 400,
                                     spacing=(0.5, 0.5, 1.0))
    counters = _reset_counters()
    t0 = time.perf_counter()
    res = predict(ckpt, images, labels, output_dir=work / "pred", tissue_dict=CLASS_NAMES,
                  device=DEVICE, save_confusion_plots=False)[0]
    seconds = time.perf_counter() - t0
    launches = _launches(counters)
    print(f"  predict(): {seconds:.2f} s with the model's load; dice {res.dice:.5f}; seconds "
          + ", ".join(f"{k} {v:.3f}" for k, v in res.seconds.items()))
    model = SegmentationModel.load(ckpt, device=DEVICE)
    pred, sample = segment_volume(model, {"image": images[0], "label": labels[0]},
                                  val_forward=make_val_forward(model.module),
                                  pre=default_preprocessing(["image", "label"]))
    saved, _ = read_nifti(res.saved_to)
    true = read_nifti(labels[0])[0].astype(np.int64)
    cm = np.bincount(true.ravel() * NUM_CLASSES + saved.astype(np.int64).ravel(),
                     minlength=NUM_CLASSES ** 2).reshape(NUM_CLASSES, NUM_CLASSES)
    if saved.shape != EVAL_2D_SHAPE or not np.array_equal(saved, pred.numpy()[0]) \
            or not np.array_equal(res.per_class_dice, dice_from_confusion(cm)):
        _fail("2D predict(): the saved map differs from segment_volume's, or its Dice from "
              "the bincount's")
    chunks = -(-_windows(sample["image"].spatial_shape, TRAIN_2D_PATCH, 0.25) // SW_BATCH)
    _expect_only("predict() in 2D", launches, {"blend": chunks})
    parity_2d(torch, ckpt, np.moveaxis(sample["image"].numpy(), 0, -1))
    return launches, {"seconds": seconds, "stage_s": res.seconds, "dice": res.dice}


# -- the host-streamed sliding window ----------------------------------------


class _PeakRss:
    """The largest resident set of this process while the block runs, sampled
    every 20 ms from /proc/self/statm."""

    def __enter__(self):
        import os

        self.page = os.sysconf("SC_PAGE_SIZE")
        self.peak = self.start = self.read()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def read(self) -> int:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * self.page

    def _run(self):
        while not self._stop.wait(0.02):
            self.peak = max(self.peak, self.read())

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, self.read())


def stream_volume(shape, seed: int):
    """A z-scored single-channel host volume (numpy f32, (*shape, 1)): two
    nested ellipsoids over noise, made with broadcasting (no coordinate grid
    of the whole volume)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    axes = [np.linspace(-1, 1, s, dtype=np.float32) for s in shape]
    r2 = axes[0][:, None, None] ** 2 + axes[1][None, :, None] ** 2
    r2 = r2 + axes[2][None, None, :] ** 2 * np.float32(0.8)
    vol = rng.standard_normal(shape, dtype=np.float32)
    vol *= np.float32(0.3)
    vol += (r2 < 0.81).astype(np.float32)
    vol += (r2 < 0.25).astype(np.float32)
    del r2
    vol -= vol.mean(dtype=np.float64)
    vol /= vol.std(dtype=np.float64)
    return vol[..., None]


def run_streamed(torch, ckpt: Path):
    """The 3D flagship checkpoint on a 512 x 512 x 896 single-channel f32 host
    numpy volume, 8 classes, roi 96^3, overlap 0.25, sw-batch 16, through
    ``sliding_window_inference``: its accumulators (9.4 GB) pass the 8 GiB
    rule, so it must stream from host memory by itself (no blend launch; the
    eval forward's kernels once a chunk). Host seconds, device seconds (CUDA
    events around each forward), windows and the peak host RSS are printed.
    Then the same volume as a CUDA tensor runs in memory, the blend kernel
    once a chunk, and the two results agree: max|d| <= 1e-5 * max|ref|,
    argmax >= 99.99%. Both run the eval forward in f32 (bf16 would hold them
    to its rounding of their batch-dependent conv algorithms)."""
    import numpy as np

    from segmantic_tpu_torch.infer import sliding_window as sw
    from segmantic_tpu_torch.train.trainer import SegmentationModel, make_val_forward

    t0 = time.perf_counter()
    vol = stream_volume(STREAM_SHAPE, 7)
    make_s = time.perf_counter() - t0
    est = int(np.prod(STREAM_SHAPE)) * 4 * (NUM_CLASSES + 2)
    windows = _windows(STREAM_SHAPE, ROI, 0.25)
    chunks = -(-windows // STREAM_SW_BATCH)
    print(f"  volume {STREAM_SHAPE} f32 made on the host in {make_s:.1f} s; accumulators "
          f"{est / 1e9:.2f} GB ({est / 2**30:.2f} GiB, the rule 8 GiB); {windows} windows "
          f"in {chunks} chunks")
    if est <= sw._STREAM_BYTES or windows != 7 * 7 * 13:
        _fail("the streamed phase's volume does not pass the 8 GiB rule or has not 637 windows")
    model = SegmentationModel.load(ckpt, device="cuda")
    forward = make_val_forward(model.module, torch.float32)
    events = []

    def predictor(windows_d):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = forward(windows_d)
        end.record()
        events.append((start, end))
        return out

    with _PeakRss() as rss:
        counters = _reset_counters()
        t0 = time.perf_counter()
        host = sw.sliding_window_inference(vol, ROI, STREAM_SW_BATCH, predictor, overlap=0.25,
                                           num_classes=NUM_CLASSES, device="cuda")
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
        launches = _launches(counters)
    device_s = sum(s.elapsed_time(e) for s, e in events) / 1e3
    print(f"  streamed: host {host_s:.2f} s, device {device_s:.2f} s (the forwards of "
          f"{len(events)} chunks), {windows} windows; peak host RSS {rss.peak / 2**30:.2f} GiB "
          f"(at the start {rss.start / 2**30:.2f} GiB)")
    if host.device.type != "cpu" or tuple(host.shape) != STREAM_SHAPE + (NUM_CLASSES,):
        _fail(f"the streamed result: {host.device} {tuple(host.shape)}")
    per_forward = {"fused_conv": 8, "phase_conv": 2}  # the flagship's eval forward
    _expect_only("the streamed sliding window", launches,
                 {k: n * chunks for k, n in per_forward.items()})

    vol_d = torch.from_numpy(vol).cuda()
    counters = _reset_counters()
    t0 = time.perf_counter()
    ref = sw.sliding_window_inference(vol_d, ROI, STREAM_SW_BATCH, forward, overlap=0.25,
                                      num_classes=NUM_CLASSES, device="cuda")
    torch.cuda.synchronize()
    mem_s = time.perf_counter() - t0
    got = _launches(counters)
    print(f"  in memory on the card (volume as a CUDA tensor): {mem_s:.2f} s, peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    _expect_only("the in-memory comparison", got,
                 dict({k: n * chunks for k, n in per_forward.items()}, blend=chunks))
    del vol_d
    diff, scale, same = 0.0, 0.0, 0
    for z in range(0, STREAM_SHAPE[0], 64):
        a = host[z:z + 64].cuda()
        b = ref[z:z + 64]
        diff = max(diff, (a - b).abs().max().item())
        scale = max(scale, b.abs().max().item())
        same += int((a.argmax(-1) == b.argmax(-1)).sum())
    agree = same / int(np.prod(STREAM_SHAPE))
    print(f"  streamed vs in memory: max|d| {diff:.3e} ({diff / scale:.3e} of max|ref| "
          f"{scale:.3e}; limit 1e-5), argmax agreement {100 * agree:.5f}% (limit 99.99%)")
    if not (diff <= 1e-5 * scale and agree >= 0.9999):
        _fail("the streamed sliding window against the in-memory path")
    del ref, host
    torch.cuda.empty_cache()
    return launches, {"host_s": host_s, "device_s": device_s, "windows": windows,
                      "peak_rss_gib": rss.peak / 2**30, "in_memory_s": mem_s}


# -- i2i: pix2pix, CycleGAN, translate -----------------------------------------


def i2i_pair(shape, seed: int):
    """A T1-like volume and its T2-like twin over one anatomy: an ellipsoidal
    head of 8 nested shells with T1 levels per shell plus noise, air 0; T2 is a
    monotone (decreasing) remap of T1 inside the head, the checkable relation
    a pix2pix translator learns. f32 (i, j, k) arrays."""
    import numpy as np

    rng = np.random.default_rng(seed)
    ax = [np.linspace(-1, 1, s, dtype=np.float32) for s in shape]
    c = rng.uniform(-0.05, 0.05, 3).astype(np.float32)
    r = np.sqrt(((ax[0] - c[0]) / 0.92)[:, None, None] ** 2
                + ((ax[1] - c[1]) / 0.85)[None, :, None] ** 2
                + ((ax[2] - c[2]) / 0.95)[None, None, :] ** 2)
    shell = np.digitize(r, np.array([0.16, 0.27, 0.38, 0.5, 0.62, 0.75, 0.9, 1.0],
                                    np.float32))  # 0 innermost .. 8 air
    levels = np.array([650, 420, 800, 560, 900, 300, 720, 480, 0], np.float32)
    head = shell < 8
    t1 = levels[shell] + np.where(head, 25.0 * rng.standard_normal(shape, np.float32), 0.0)
    t1 = np.maximum(t1, 0.0).astype(np.float32)
    t2 = np.where(head, 1200.0 - 0.9 * t1 - 2e-4 * t1 ** 2, 0.0).astype(np.float32)
    return t1, t2


def write_i2i_pairs(work: Path):
    """The T1-like / T2-like NIfTI pairs of the i2i phases (1 mm in-plane,
    1.2 mm between slices), written once: [(t1 path, t2 path)]."""
    work.mkdir(parents=True, exist_ok=True)
    pairs = []
    for i, depth in enumerate(I2I_DEPTHS):
        t1, t2 = i2i_pair((I2I_SLICE, I2I_SLICE, depth), 60 + i)
        aff = spacing_affine((1.0, 1.0, 1.2))
        pair = (work / f"case{i}_t1.nii.gz", work / f"case{i}_t2.nii.gz")
        write_nifti(pair[0], t1, aff)
        write_nifti(pair[1], t2, aff)
        pairs.append(pair)
    return pairs


def _i2i_hparams(data):
    """The extra hparams the CLI stores with a generator checkpoint."""
    return {"slice_axis": 2, "source_window": list(data.source_window),
            "target_window": list(data.target_window)}


def _i2i_iteration_ms(torch, d_step, g_step, batch, n: int):
    """Median device ms of ``n`` iterations (D step + G step) on one fixed
    batch after 2 warm ones (CUDA events around each), and the peak device
    MiB of those ``n``."""
    a, b = (torch.as_tensor(v, device=DEVICE) for v in batch)

    def iteration():
        d_step(a, b)
        g_step(a, b)

    for _ in range(2):
        iteration()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = _median_ms(torch, iteration, n=n, warmup=0)
    return ms, torch.cuda.max_memory_allocated() / 2**20


def _falling(name, values):
    """Finite, and the last value below the first (and, over 10 or more, the
    mean of the last five below that of the first five)."""
    import math

    ok = all(math.isfinite(v) for v in values) and values[-1] < values[0]
    if len(values) >= 10:
        ok = ok and sum(values[-5:]) < sum(values[:5])
    if not ok:
        _fail(f"{name} is not finite and falling: {values}")


def run_i2i_pix2pix(torch, work: Path):
    """``train_pix2pix`` at the CLI's full width (base 64, 6 blocks, batch 16,
    lr 2e-4, lambda_l1 100) on a ``PairedSliceDataset`` of the T1-like /
    T2-like pairs (256^2 slices along axis 2), ``I2I_STEPS`` iterations with
    ``log_every=1``: the L1 trajectory must fall, every kernel launch count is
    0 (2D convs are cuDNN's). Then the warm iteration (D step + G step) on
    one fixed batch: median device ms over 10 (CUDA events), slices per
    second, the peak device memory; the TF32 switch it ran with."""
    from segmantic_tpu_torch.i2i import train as i2i_train
    from segmantic_tpu_torch.i2i.data import PairedSliceDataset

    t0 = time.perf_counter()
    pairs = write_i2i_pairs(work)
    data = PairedSliceDataset(pairs, batch_size=I2I_BATCH, axis=2, seed=0)
    print(f"  {len(pairs)} pairs {I2I_SLICE}x{I2I_SLICE}x{I2I_DEPTHS}: {data.num_slices} slices "
          f"@ {data.slice_shape}, {len(data)} batches/epoch, windows {data.source_window} -> "
          f"{data.target_window} ({time.perf_counter() - t0:.1f} s to write and load); "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    if data.slice_shape != (I2I_SLICE, I2I_SLICE):
        _fail(f"pix2pix slices {data.slice_shape}")
    counters = _reset_counters()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    result = i2i_train.train_pix2pix(
        data, steps=I2I_STEPS, base_features=I2I_BASE, n_blocks=I2I_BLOCKS, seed=0,
        output_dir=work / "pix2pix", log_every=1, extra_hparams=_i2i_hparams(data),
        device=DEVICE)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = _launches(counters)
    l1 = [r["l1"] for r in result.history]
    print(f"  train_pix2pix: {I2I_STEPS} iterations in {train_s:.1f} s (host clock, the "
          f"first's cuDNN planning included), peak {torch.cuda.max_memory_allocated() / 2**20:.0f}"
          f" MiB; L1 {[round(v, 4) for v in l1]}")
    _falling("pix2pix L1", l1)
    _expect_only("train_pix2pix", launches, {})

    src0, dst0 = next(iter(data))
    gen, disc = i2i_train._init_pix2pix(src0, dst0, I2I_BASE, I2I_BLOCKS, 0, DEVICE)
    g_opt = i2i_train._make_optim(gen.parameters(), 2e-4)
    d_opt = i2i_train._make_optim(disc.parameters(), 2e-4)
    steps = i2i_train.make_pix2pix_steps(gen, disc, g_opt, d_opt, 100.0)
    ms, peak = _i2i_iteration_ms(torch, *steps, (src0, dst0), n=10)
    print(f"  warm iteration, fixed {I2I_BATCH} x {I2I_SLICE}^2 batch: {ms:.2f} ms (D step + "
          f"G step, median of 10, CUDA events), {I2I_BATCH / ms * 1e3:.1f} slices/s, peak "
          f"{peak:.0f} MiB")
    return launches, {"iteration_ms": round(ms, 3), "peak_mib": round(peak), "l1": l1[::5] + l1[-1:],
                      "train_s": round(train_s, 1)}, result.checkpoint, pairs


def run_i2i_cyclegan(torch, work: Path, pairs):
    """``train_cyclegan`` at the CLI's defaults (base 64, 6 blocks, batch 16,
    lambda_cycle 10, lambda_identity 0.5) over an ``UnpairedSliceDataset`` of
    the same volumes (T1-like as domain A, T2-like as B), ``I2I_CG_STEPS``
    iterations: the cycle loss must be finite and falling, no kernel launch.
    Then the warm iteration on one fixed batch (median of 3) and its peak."""
    from segmantic_tpu_torch.i2i import train as i2i_train
    from segmantic_tpu_torch.i2i.data import UnpairedSliceDataset

    data = UnpairedSliceDataset([p for p, _ in pairs], [q for _, q in pairs],
                                batch_size=I2I_BATCH, axis=2, seed=0)
    counters = _reset_counters()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    result = i2i_train.train_cyclegan(
        data, steps=I2I_CG_STEPS, base_features=I2I_BASE, n_blocks=I2I_BLOCKS, seed=0,
        output_dir=work / "cyclegan", log_every=1, extra_hparams=_i2i_hparams(data),
        device=DEVICE)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = _launches(counters)
    cycle = [r["cycle"] for r in result.history]
    print(f"  train_cyclegan: {data.num_slices} slices a domain, {I2I_CG_STEPS} iterations in "
          f"{train_s:.1f} s, peak {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB; cycle "
          f"{[round(v, 4) for v in cycle]}")
    _falling("CycleGAN cycle loss", cycle)
    _expect_only("train_cyclegan", launches, {})

    a0, b0 = next(iter(data))
    nets = i2i_train._init_cyclegan(a0, b0, I2I_BASE, I2I_BLOCKS, 0, DEVICE)
    g_opt = i2i_train._make_optim([*nets["gen_ab"].parameters(),
                                   *nets["gen_ba"].parameters()], 2e-4)
    d_opt = i2i_train._make_optim([*nets["disc_a"].parameters(),
                                   *nets["disc_b"].parameters()], 2e-4)
    steps = i2i_train.make_cyclegan_steps(nets, g_opt, d_opt, 10.0, 0.5)
    ms, peak = _i2i_iteration_ms(torch, *steps, (a0, b0), n=3)
    print(f"  warm iteration, fixed {I2I_BATCH} x {I2I_SLICE}^2 batch per domain: {ms:.2f} ms "
          f"(median of 3, CUDA events), {I2I_BATCH / ms * 1e3:.1f} slices/s a domain, peak "
          f"{peak:.0f} MiB")
    del nets, g_opt, d_opt, steps
    return launches, {"iteration_ms": round(ms, 3), "peak_mib": round(peak), "cycle": cycle,
                      "train_s": round(train_s, 1)}, result.checkpoint


def run_i2i_translate(torch, p2p_ckpt: Path, cg_ckpt: Path, volume: Path):
    """``load_generator`` on both checkpoints just written, ``translate_volume``
    of one 256 x 256 x 150 volume with pix2pix and both CycleGAN directions
    (batch 16, the checkpoint's slice axis and output window, as the CLI
    does): the output keeps the input's shape and affine, lies in the window
    it was mapped to, and equals the window's unscaling of the raw tanh
    output (pix2pix; within 1e-5 of the window); seconds per volume on the
    host clock (the result back on the host), the second run of each."""
    import numpy as np

    from segmantic_tpu_torch.i2i.data import load_generator, translate_volume, unscale_from_tanh
    from segmantic_tpu_torch.io.nifti import read_volume

    vol = read_volume(volume)
    counters = _reset_counters()
    numbers = {}
    for label, ckpt, direction in (("pix2pix", p2p_ckpt, "ab"), ("cyclegan ab", cg_ckpt, "ab"),
                                   ("cyclegan ba", cg_ckpt, "ba")):
        apply, hp = load_generator(ckpt, direction=direction, device=DEVICE)
        window = tuple(hp["target_window" if direction == "ab" else "source_window"])
        seconds = []
        for _ in range(2):
            t0 = time.perf_counter()
            out = translate_volume(apply, vol, axis=int(hp["slice_axis"]), batch_size=I2I_BATCH,
                                   output_window=window)
            seconds.append(time.perf_counter() - t0)
        data = out.numpy()
        lo, hi = window
        ok = (out.spatial_shape == vol.spatial_shape and np.array_equal(out.affine, vol.affine)
              and np.isfinite(data).all() and lo - 1e-3 * (hi - lo) <= data.min()
              and data.max() <= hi + 1e-3 * (hi - lo) and data.std() > 0)
        print(f"  {label}: {vol.spatial_shape} -> {out.spatial_shape}, window "
              f"({lo:.1f}, {hi:.1f}), output [{data.min():.1f}, {data.max():.1f}]; "
              f"{seconds[0]:.3f} s cold, {seconds[1]:.3f} s warm a volume")
        if label == "pix2pix":
            raw = translate_volume(apply, vol, axis=int(hp["slice_axis"]),
                                   batch_size=I2I_BATCH).numpy()
            err = np.abs(unscale_from_tanh(raw, window) - data).max()
            print(f"  pix2pix: raw tanh output [{raw.min():.3f}, {raw.max():.3f}], unscaled "
                  f"by the window: max|d| {err:.3e} from the windowed output")
            ok = ok and np.abs(raw).max() <= 1.0 and err <= 1e-5 * (hi - lo)
        if not ok:
            _fail(f"translate_volume ({label}) lost the geometry or the output window")
        numbers[label] = round(seconds[1], 4)
    launches = _launches(counters)
    _expect_only("translate", launches, {})
    return launches, numbers


def _i2i_step_parity(torch, label, src, dst, base, blocks, counters):
    """One pix2pix iteration (D step, then G step; Adam at lr 0, so every
    gradient stays in place) from one set of weights: f32 on the card, f32 and
    f64 on the CPU. Judged as ``[train-parity]``: both losses 1e-5 relative
    to f64, each G and D gradient tensor within 2 * e_cpu + 1e-3 *
    max(max|g64|, 1e-2 * max over all tensors). Returns the card's launches."""
    from segmantic_tpu_torch.i2i import train as i2i_train

    out = []
    launches = None
    for device, dtype in ((DEVICE, torch.float32), ("cpu", torch.float32),
                          ("cpu", torch.float64)):
        gen, disc = i2i_train._init_pix2pix(src, dst, base, blocks, 0, "cpu")
        gen, disc = gen.to(device, dtype), disc.to(device, dtype)
        d_step, g_step = i2i_train.make_pix2pix_steps(
            gen, disc, i2i_train._make_optim(gen.parameters(), 0.0),
            i2i_train._make_optim(disc.parameters(), 0.0), 100.0)
        s, d = (torch.from_numpy(v).to(device, dtype) for v in (src, dst))
        for c in counters.values():
            c.reset()
        t0 = time.perf_counter()
        losses = (d_step(s, d).item(), g_step(s, d)[0].item())
        if launches is None:  # the card's run comes first
            launches = _launches(counters)
        print(f"  {label} {device} {str(dtype)[6:]}: D loss {losses[0]:.9f}, G loss "
              f"{losses[1]:.9f} ({time.perf_counter() - t0:.1f} s)")
        out.append((losses, {
            **{f"G.{k}": p.grad.cpu().double() for k, p in gen.named_parameters()},
            **{f"D.{k}": p.grad.cpu().double() for k, p in disc.named_parameters()}}))
    (lg, gg), (_, gc), (l64, g64) = out
    rel = max(abs(a - b) / abs(b) for a, b in zip(lg, l64))
    floor = 1e-2 * max(g.abs().max().item() for g in g64.values())
    rows = []
    for k, ref in g64.items():
        e_card = (gg[k] - ref).abs().max().item()
        e_cpu = (gc[k] - ref).abs().max().item()
        lim = 2 * e_cpu + 1e-3 * max(ref.abs().max().item(), floor)
        rows.append((e_card / lim, k, e_card, e_cpu, lim))
    rows.sort(reverse=True)
    print(f"  {label} card vs f64: losses rel diff {rel:.3e} (limit 1e-5); gradients (floor "
          f"{floor:.3e}), the 4 nearest their limits:")
    for ratio, k, e_card, e_cpu, lim in rows[:4]:
        print(f"    {k}: card {e_card:.3e}, CPU f32 {e_cpu:.3e}; limit {lim:.3e}; {ratio:.3f} of it")
    print(f"  {label}: {sum(r[0] <= 1.0 for r in rows)} of {len(rows)} gradient tensors within "
          f"their limits")
    if not (rel <= 1e-5 and rows[0][0] <= 1.0):
        _fail(f"i2i f32 iteration parity ({label}), card vs the f64 iteration")
    return launches


def i2i_parity(torch):
    """``[train-parity]`` for i2i, TF32 off and cuDNN's deterministic
    algorithms (as ``[train-parity-2d]``: every 2D i2i conv is cuDNN's): one
    pix2pix iteration at full width (base 64, 6 blocks) on 2 x 256^2 slices,
    then a 3D generator and discriminator (1 x 32^3, base 16, 2 blocks), whose
    ResNet blocks' stride-1 3^3 convs run kernels 1 and 2 on the card: 12
    launches of kernel 1 an iteration (4 convs: the D step's forward, the G
    step's forward and input gradients) and 4 of kernel 2, all on the f32
    bodies. Returns the 3D case's launches."""
    import numpy as np

    rng = np.random.default_rng(12)

    def pair(shape):
        src = rng.uniform(-1, 1, shape).astype(np.float32)
        return src, np.tanh(1.5 - 2.0 * src).astype(np.float32)

    counters = {**_counters(), **_f32_counters()}
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        src, dst = pair((2, I2I_SLICE, I2I_SLICE, 1))
        got = _i2i_step_parity(torch, f"2D base {I2I_BASE}", src, dst, I2I_BASE, I2I_BLOCKS,
                               counters)
        _expect_only("the 2D i2i iteration", got, {})
        src, dst = pair((1,) + (I2I_PARITY_3D,) * 3 + (1,))
        got = _i2i_step_parity(torch, f"3D {I2I_PARITY_3D}^3 base 16", src, dst, 16, 2,
                               counters)
        _expect_only("the 3D i2i iteration", got, {"fused_conv": 12, "fused_conv_dw": 4,
                                                   "conv3_f32": 12, "conv3_f32_dw": 4})
    finally:
        torch.backends.cudnn.deterministic = old
    return got


# (x shape, CO) of the 3D generator's ResNet-block convs (4 * base channels at
# a quarter of the input), f32 as i2i trains: the parity case (base 16 on
# 32^3) and the CLI's width on 64^3 and 32^3 inputs
I2I_CONV_SHAPES = [((1, 8, 8, 8, 64), 64), ((1, 16, 16, 16, 256), 256),
                   ((2, 8, 8, 8, 256), 256)]
# the flagship's stride-1 3^3 convs in f32 training (mixed_precision=False,
# batch 8), and packed UNETR's one-channel input layer in f32 (96^3 x 1 -> 16
# as the phase-major p 48^3 x 8): the f32 bodies' other rows
F32_TRAIN_SHAPES = [((8, 48, 48, 48, 16), 16, False), ((8, 24, 24, 24, 32), 32, False),
                    ((8, 12, 12, 12, 64), 64, False), ((8, 6, 6, 6, 256), 256, False),
                    ((8, 48, 48, 48, 8), 16, True)]


def check_i2i_kernels(torch):
    """Kernels 1-2 (and 3-6 at one phase row) on the register-tiled f32
    bodies (f32 keeps TF32 out): the 3D i2i generator's f32 shapes, the
    flagship's f32 training shapes and f32 packed UNETR's input layer, each
    against its plain version (forward 1e-4 * max|ref|, weight gradient 1e-3 *
    max|ref|, as the card tests hold f32), one launch of the f32 body each,
    bit-equal on repeat, with its launch plan, timed by CUDA-graph replay
    beside the plain versions and cuDNN's f32 ``F.conv3d`` / ``conv3d_weight``
    (on the full-resolution view for the phase row, the rearrangement not
    timed; the phase row's plain forward eagerly: it uploads its tap
    selection, which a graph cannot capture); bound at the f32 peak. Returns {kernel: {...}} as
    :func:`check_kernels`, the f32 bodies' lines beside kernels 1-6's."""
    from segmantic_tpu_torch.ops import fused_conv, phase_conv
    from segmantic_tpu_torch.ops.fast_conv import depth_to_space

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(21)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    results = {}

    def check(label, got, want, limit):
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        ref = want.float().abs().max().item()
        print(f"  {label}: max|d| {err:.3e} (limit {limit * ref:.3e} = {limit:g} * max|ref|)")
        if err > limit * ref:
            _fail(f"{label} disagrees with its plain version")
        return err

    def once(label, counter, fn):
        """fn's result, checked to launch the f32 body once and to repeat bit for bit."""
        before = counter.count
        got = fn()
        if counter.count != before + 1:
            _fail(f"{label}: not one launch of the f32 body")
        if not torch.equal(got, fn()):
            _fail(f"{label}: a repeated launch is not bit-equal")
        return got

    rows = [(shape, co, False) for shape, co in I2I_CONV_SHAPES] + F32_TRAIN_SHAPES
    for shape, co, phase in rows:
        c = shape[-1] // (8 if phase else 1)
        dims = (shape[0],) + tuple((2 if phase else 1) * v for v in shape[1:4])
        x = torch.randn(shape, generator=g, device=dev)
        w = torch.randn((3, 3, 3, c, co), generator=g, device=dev) * (27 * c) ** -0.5
        dy = torch.randn(shape[:4] + ((8 if phase else 1) * co,), generator=g, device=dev)
        if phase:
            conv, plain = phase_conv.phase_conv, phase_conv.phase_conv_plain
            dwk, dwp = phase_conv.phase_conv_dw, phase_conv.phase_conv_dw_plain
            xc = depth_to_space(x, c).permute(0, 4, 1, 2, 3)
            dyc = depth_to_space(dy, co).permute(0, 4, 1, 2, 3)
            label = f"p{shape}->{8 * co} ({dims[1]}^3 x {c} -> {co}) f32"
        else:
            conv, plain = fused_conv.conv3d, fused_conv.conv3d_plain
            dwk, dwp = fused_conv.conv3d_dw, fused_conv.conv3d_dw_plain
            xc, dyc = x.permute(0, 4, 1, 2, 3), dy.permute(0, 4, 1, 2, 3)
            label = f"x{shape}->{co} f32"
        wc = w.permute(4, 3, 0, 1, 2).contiguous()
        ops = 2 * 27 * c * co * (xc.numel() // c)
        # the plain f32 versions take up to ~0.1 s at the largest rows: fewer replays
        slow = dict(n=3, launches=1) if x.numel() > 2 ** 24 else dict(n=5, launches=5)
        reps = dict(n=5, launches=5)
        names = ("phase_conv", "phase_conv_dw") if phase else ("fused_conv", "fused_conv_dw")

        body, text, _ = conv_body_text(x, c, co, dims, phase, sms)
        if body != "f32_tiles" or fused_conv.dw_body(x, c, co, phase) != "f32_tiles":
            _fail(f"{label}: the rule sends f32 to the {body} body")
        k = lambda: conv(x, w)  # noqa: E731
        got = once(f"{names[0]} {label}", fused_conv.f32_counter, k)
        err = check(f"{names[0]} {label}", got, plain(x, w), 1e-4)
        ms = _graph_ms(torch, k, **reps)
        pms = (_median_ms(torch, lambda: plain(x, w)) if phase
               else _graph_ms(torch, lambda: plain(x, w), **slow))
        lms = _graph_ms(torch, lambda: torch.nn.functional.conv3d(xc, wc, padding=1), **reps)
        print(f"    {text}; bit-equal on repeat; kernel {ms:.4f} ms, plain {pms:.4f} ms"
              f"{' (eager)' if phase else ''}, cuDNN f32 conv3d {lms:.4f} ms")
        for name in (names[0], "conv3_f32"):
            _record(results, name, err=err, ms=ms, plain_ms=pms, nbytes=_nbytes(x, w, got),
                    ops=ops, peak=PEAK_F32, library_ms=lms, echo=name == names[0])

        text = dw_body_text(x, c, co, dims, phase, sms)[1]
        k = lambda: dwk(x, dy)  # noqa: E731
        got = once(f"{names[1]} {label}", fused_conv.f32_dw_counter, k)
        err = check(f"{names[1]} {label}", got, dwp(x, dy), 1e-3)
        ms = _graph_ms(torch, k, **reps)
        pms = _graph_ms(torch, lambda: dwp(x, dy), **slow)
        lms = _graph_ms(torch, lambda: torch.nn.grad.conv3d_weight(
            xc, (co, c, 3, 3, 3), dyc, padding=1), **slow)
        print(f"    {text}; bit-equal on repeat; kernel {ms:.4f} ms, plain {pms:.4f} ms, cuDNN "
              f"f32 wgrad {lms:.4f} ms")
        for name in (names[1], "conv3_f32_dw"):
            _record(results, name, err=err, ms=ms, plain_ms=pms, nbytes=_nbytes(x, dy, got),
                    ops=ops, peak=PEAK_F32, library_ms=lms, echo=name == names[1])
        torch.cuda.empty_cache()
    return results


# --- the rest of the single-device package ----------------------------------

SPINE_SHAPE = (192, 192, 384)  # a 1 mm spine crop
SPINE_LEVELS = 24  # vertebra labels (25 heat-map channels with the background)
DIST_SPACING = (0.9, 0.9, 1.2)
GATHER_TIE = 1e-4  # a position this close to a half-integer may round either way


def gather_ties(in_shape, out_shape, angles, zoom):
    """Output voxels of ``rotate_zoom_nn_gather`` whose source position,
    recomputed in f64, lies within ``GATHER_TIE`` of a half-integer along some
    axis: where f32 rounding may pick either neighbour."""
    import numpy as np

    from segmantic_tpu_torch.ops.shear_resample import rotation_matrix

    nd = len(in_shape)
    inv = rotation_matrix(nd, np.asarray(angles, np.float64)).T / float(zoom)
    grids = np.meshgrid(*[np.arange(o) + (n - o) // 2 - (n - 1) / 2.0
                          for n, o in zip(in_shape, out_shape)], indexing="ij", sparse=True)
    near = np.zeros(tuple(out_shape), bool)
    for a in range(nd):
        pos = sum(inv[a, b] * grids[b] for b in range(nd)) + (in_shape[a] - 1) / 2.0
        near |= np.abs(pos - np.floor(pos) - 0.5) < GATHER_TIE
    return near


def run_label_gather(torch):
    """The flagship's augmented step on a fixed 8 x 144^3 bf16 margin batch
    with the labels through the composed-affine gather and through the shear
    chain, interleaved: step and augmentation times, kernel 8's launches, and
    one draw's gathered labels on the card against the CPU's."""
    import dataclasses

    import numpy as np

    from segmantic_tpu_torch.ops.shear_resample import (
        center_crop, rotate_zoom_nn_gather, rotate_zoom_shear,
    )
    from segmantic_tpu_torch.train.augment import AugmentConfig, augment_batch, draw_params
    from segmantic_tpu_torch.train.optim import make_optimizer
    from segmantic_tpu_torch.train.trainer import SegmentationModel, make_train_step

    chain = AugmentConfig(spatial=True, intensity=True)
    routes = {"gather": dataclasses.replace(chain, label_affine_gather=True), "chain": chain}
    image, label = fixed_batch(torch, TRAIN_BATCH, 60, size=MARGIN_PATCH[0], volume=160)
    image, label = image.to(torch.bfloat16).cuda(), label.cuda()

    # one draw's labels: the card against the CPU on the same parameters
    params = draw_params(torch.Generator().manual_seed(5), routes["gather"], TRAIN_BATCH, 3)
    idx = torch.as_tensor(params.spatial_index, dtype=torch.int64)
    lbl_cf = label[:, None]
    got = rotate_zoom_nn_gather(lbl_cf[idx.cuda()], params.angles, params.zoom,
                                TRAIN_PATCH).cpu().numpy()
    want = rotate_zoom_nn_gather(lbl_cf.cpu()[idx], params.angles, params.zoom,
                                 TRAIN_PATCH).numpy()
    differ = ties = 0
    for s in range(len(idx)):
        diff = got[s, 0] != want[s, 0]
        near = gather_ties(MARGIN_PATCH, TRAIN_PATCH, params.angles[s], params.zoom[s])
        ties += int(near.sum())
        differ += int(diff.sum())
        if (diff & ~near).any():
            _fail(f"[label-gather] sample {s}: {int((diff & ~near).sum())} labels differ "
                  "from the CPU's off a half-integer tie")
    print(f"  gathered labels of {len(idx)} samples ({got.dtype}, {got.shape[2:]}): "
          f"{differ} of {got.size} differ from the CPU's, all at ties "
          f"({ties} outputs within {GATHER_TIE} of a half-integer)")

    # the labels' two routes alone on the same draw: the card's time (CUDA
    # events) beside the host's time to queue the call (no wait for the card)
    lbl_s = lbl_cf[idx.cuda()]
    angles = torch.as_tensor(params.angles, dtype=torch.float32, device="cuda")
    zoom = torch.as_tensor(params.zoom, dtype=torch.float32, device="cuda")
    chain_cfg = routes["chain"]
    label_routes = {
        "gather": lambda: rotate_zoom_nn_gather(lbl_s, params.angles, params.zoom, TRAIN_PATCH),
        "chain": lambda: center_crop(rotate_zoom_shear(
            lbl_s, angles, zoom, order=0, out_shape=TRAIN_PATCH, angle_max=chain_cfg.rotate_range,
            zoom_min=min(chain_cfg.zoom_range[0], 1.0)), TRAIN_PATCH),
    }
    labels_alone = {}
    for name, fn in label_routes.items():
        card_ms = _median_ms(torch, fn)
        queue = []
        for _ in range(10):
            t0 = time.perf_counter()
            fn()
            queue.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
        labels_alone[name] = {"labels_ms": card_ms, "labels_queue_ms": statistics.median(queue)}
        print(f"  labels alone, {name}: {card_ms:.3f} ms (CUDA events, median of 10), the host "
              f"{statistics.median(queue):.3f} ms to queue it (median of 10)")

    model = SegmentationModel.create(num_classes=NUM_CLASSES, seed=1, device="cuda")
    module = model.module.train().requires_grad_(True)
    opt = make_optimizer(module.parameters(), {"optimizer": "Adam", "lr": 1e-3})
    steps = {name: make_train_step(module, opt, cfg, TRAIN_PATCH, mixed_precision=True,
                                   generator=torch.Generator().manual_seed(4))
             for name, cfg in routes.items()}
    counters = _counters()
    launches = {}
    for name, step in steps.items():
        for c in counters.values():
            c.reset()
        step(image, label)
        torch.cuda.synchronize()
        launches[name] = _launches(counters)
    print(f"  launches of one step: gather {launches['gather']}, chain {launches['chain']}")
    if launches["gather"]["shear_group"] != 3 or launches["chain"]["shear_group"] != 6:
        _fail(f"[label-gather] expected kernel 8 three times a gather step (the image's "
              f"groups) and six times a chain step: {launches}")
    for step in steps.values():
        for _ in range(3):
            step(image, label)
    times = {name: [] for name in steps}
    for _ in range(10):  # interleaved
        for name, step in steps.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            loss = step(image, label)
            end.record()
            torch.cuda.synchronize()
            if not np.isfinite(loss.item()):
                _fail(f"[label-gather] {name} step: loss not finite")
            times[name].append(start.elapsed_time(end))
    numbers = {}
    for name, cfg in routes.items():
        gen = torch.Generator().manual_seed(3)
        aug_ms = _median_ms(torch, lambda: augment_batch(image, label, gen, cfg, TRAIN_PATCH))
        step_ms = statistics.median(times[name])
        numbers[name] = {"step_ms": step_ms, "augment_ms": aug_ms, **labels_alone[name]}
        print(f"  {name}: augmented step median {step_ms:.2f} ms (min {min(times[name]):.2f}, "
              f"max {max(times[name]):.2f}; 10 steps interleaved, CUDA events), augmentation "
              f"alone {aug_ms:.2f} ms (median of 10)")
    for c in counters.values():
        c.reset()
    return launches["gather"], numbers


def spine_labels(seed: int):
    """A synthetic spine on SPINE_SHAPE (1 mm voxels): SPINE_LEVELS vertebral
    bodies (elliptic slabs 36-52 x 28-40 mm, labels 1..24) stacked along
    axis 2 and drifting in the plane (uint8)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    scale = SPINE_SHAPE[0] / 192.0
    x, y = np.meshgrid(np.arange(SPINE_SHAPE[0]), np.arange(SPINE_SHAPE[1]), indexing="ij")
    lbl = np.zeros(SPINE_SHAPE, np.uint8)
    step = SPINE_SHAPE[2] // SPINE_LEVELS
    for k in range(SPINE_LEVELS):
        cx = SPINE_SHAPE[0] / 2 + scale * (10 * np.sin(k / 5.0) + rng.uniform(-2, 2))
        cy = SPINE_SHAPE[1] / 2 + scale * rng.uniform(-3, 3)
        rx, ry = scale * rng.uniform(18, 26), scale * rng.uniform(14, 20)
        disk = ((x - cx) / rx) ** 2 + ((y - cy) / ry) ** 2 < 1.0
        lbl[disk, k * step + 1:max((k + 1) * step - 2, k * step + 2)] = k + 1
    return lbl


def run_detect(torch):
    """``VertHeatMap`` on the card on a 1 mm spine crop: seconds per call
    warm, the host peak (the output is 25 channels of f32), and three classes'
    channels against the plain CPU path."""
    import tracemalloc

    import numpy as np

    from segmantic_tpu_torch.core.volume import Volume
    from segmantic_tpu_torch.detect import VertHeatMap

    lbl = spine_labels(7)
    names = [f"L{k}" for k in range(1, SPINE_LEVELS + 1)]
    vol = Volume(data=lbl[None], affine=spacing_affine((1.0, 1.0, 1.0)))
    heat = VertHeatMap("label", gamma=1000.0, label_names=names)  # device: the card
    counters = _reset_counters()
    tracemalloc.start()
    t0 = time.perf_counter()
    out = heat({"label": vol})["label"].numpy()
    cold = time.perf_counter() - t0
    _, peak = tracemalloc.get_traced_memory()
    tracemalloc.stop()
    seconds = []
    for _ in range(2):
        t0 = time.perf_counter()
        heat({"label": vol})
        seconds.append(time.perf_counter() - t0)
    launches = _launches(counters)
    print(f"  VertHeatMap {lbl.shape} uint8, {SPINE_LEVELS} labels, gamma 1000 -> "
          f"{out.shape} {out.dtype} ({out.nbytes / 1e9:.2f} GB): cold {cold:.3f} s, warm "
          f"{[round(s, 3) for s in seconds]} s a call (host clock, the output on the host); "
          f"host peak {peak / 2**30:.2f} GiB (tracemalloc, the cold call)")
    peaks = out.reshape(out.shape[0], -1).max(1)
    if out.shape != (SPINE_LEVELS + 1,) + SPINE_SHAPE or out.dtype != np.float32 \
            or not np.isfinite(out).all() or out[0].any() \
            or not np.allclose(peaks[1:], 1000.0, rtol=1e-6):
        _fail("[detect] heat maps: shape, type, finiteness, or a channel's peak not gamma")
    if any(launches.values()):
        _fail(f"[detect] launched a kernel: {launches}")
    picked = (1, 12, SPINE_LEVELS)
    only = np.where(np.isin(lbl, picked), lbl, 0)
    ref = VertHeatMap("label", gamma=1000.0, label_names=names, device="cpu")(
        {"label": only[None]})["label"]
    errs = [float(np.abs(out[c] - ref[c]).max() / np.abs(ref[c]).max()) for c in picked]
    print(f"  classes {picked} against the plain CPU path: max|diff| / max|ref| "
          f"{[f'{e:.2e}' for e in errs]} (limit 1e-6)")
    if max(errs) > 1e-6:
        _fail("[detect] heat maps differ from the CPU path")
    return {"cold_s": cold, "warm_s": min(seconds), "host_peak_gib": peak / 2**30}


def run_distance(torch, work: Path):
    """Both Hausdorff statistics for classes 1-7 between ``[serve]``'s served
    labels of phantom_a and the phantom's own labels (its intensity shells),
    spacing DIST_SPACING, on the host through the native distance transform;
    one class again through scipy's."""
    import numpy as np

    from segmantic_tpu_torch import native
    from segmantic_tpu_torch.metrics import distance

    pred, _ = read_nifti(work / "phantom_a_pred.nii.gz")
    ref = np.clip(np.rint(phantom((256, 256, 176), 1) / 100.0), 0, 5).astype(np.uint8)
    if pred.shape != ref.shape:
        _fail(f"[distance] served labels {pred.shape} vs the phantom's {ref.shape}")
    calls = []
    real = native.edt_distance_to_foreground

    def counted(*args, **kwargs):
        out = real(*args, **kwargs)
        calls.append(1)
        return out

    counters = _reset_counters()
    native.edt_distance_to_foreground = counted
    try:
        per_class, results = [], {}
        t_case = time.perf_counter()
        for c in range(1, 8):
            t0 = time.perf_counter()
            results[c] = (distance.hausdorff_surface_distance(pred == c, ref == c, DIST_SPACING),
                          distance.hausdorff_pointwise_distance(pred == c, ref == c,
                                                                DIST_SPACING))
            per_class.append(time.perf_counter() - t0)
        case_s = time.perf_counter() - t_case
        n_native = len(calls)
    finally:
        native.edt_distance_to_foreground = real
    for c, (surf, point) in results.items():
        print(f"  class {c}: surface {', '.join(f'{k} {v:.4g}' for k, v in surf.items())}; "
              f"pointwise max {point['max']:.4g} mean {point['mean']:.4g} (mm)")
    print(f"  host seconds per class {[round(s, 3) for s in per_class]}, {case_s:.2f} s the "
          f"case (7 classes, both statistics); {n_native} native distance transforms")
    empty = sum((not (pred == c).any()) + (not (ref == c).any()) for c in range(1, 8))
    if n_native != 4 * 7 - 2 * empty:
        _fail(f"[distance] the native distance transform ran {n_native} times")
    if any(_launches(counters).values()):
        _fail(f"[distance] launched a kernel: {_launches(counters)}")
    # one class through scipy's transform: the first that both label maps hold
    both = [c for c in range(1, 8) if (pred == c).any() and (ref == c).any()]
    if not both:
        _fail("[distance] no class is in both the served and the phantom's labels")
    c = both[0]

    def refuse(*args, **kwargs):
        raise RuntimeError("native distance transform refused")

    native.edt_distance_to_foreground = refuse
    try:
        t0 = time.perf_counter()
        scipy_res = (distance.hausdorff_surface_distance(pred == c, ref == c, DIST_SPACING),
                     distance.hausdorff_pointwise_distance(pred == c, ref == c, DIST_SPACING))
        scipy_s = time.perf_counter() - t0
    finally:
        native.edt_distance_to_foreground = real
    rel = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-12)
              for a, b in zip(results[c], scipy_res) for k in b)
    print(f"  class {c} through scipy's transform: {scipy_s:.2f} s (native {per_class[c - 1]:.2f}"
          f" s), largest relative difference {rel:.2e} (limit 1e-5)")
    if not rel <= 1e-5:
        _fail("[distance] the native and scipy routes disagree")
    return {"case_s": case_s, "class_s": per_class, "scipy_class_s": scipy_s}


def run_sampler(torch):
    """``PatchSampler`` drawing 8 x 144^3 margin batches (batch 2 x 4 samples,
    margin 24, bf16 wire) from one cached 256 x 256 x 176 volume: the native
    crop, then the numpy route and its cast; host ms a batch, bit-equal."""
    import numpy as np

    from segmantic_tpu_torch import native
    from segmantic_tpu_torch.core.volume import Volume
    from segmantic_tpu_torch.data.cache import PatchSampler, VolumeCache

    img = phantom((256, 256, 176), 1)
    lbl = np.clip(np.rint(img / 100.0), 0, 5).astype(np.uint8)
    t0 = time.perf_counter()
    cache = VolumeCache([{"image": Volume(data=img[None], affine=np.eye(4)),
                          "label": Volume(data=lbl[None], affine=np.eye(4))}],
                        lambda sample: sample, NUM_CLASSES)
    cache_s = time.perf_counter() - t0
    if not native.available():
        _fail("[sampler] the native library did not build")
    kw = dict(patch_size=TRAIN_PATCH, batch_size=TRAIN_BATCH, num_samples=4,
              margin=TRAIN_PATCH[0] // 4, seed=0, image_wire_dtype=torch.bfloat16)
    fast, slow = PatchSampler(cache, **kw), PatchSampler(cache, **kw)
    slow._native_ok = lambda picks: False
    counters = _reset_counters()
    ms = {"native": [], "numpy": []}
    for _ in range(10):
        for name, sampler in (("native", fast), ("numpy", slow)):
            t0 = time.perf_counter()
            img_b, lbl_b = sampler.sample_batch()
            ms[name].append((time.perf_counter() - t0) * 1e3)
            if name == "native":
                want = (img_b, lbl_b)
        if tuple(img_b.shape) != (TRAIN_BATCH, *MARGIN_PATCH, 1) \
                or img_b.dtype != torch.bfloat16 or lbl_b.dtype != np.uint8 \
                or not torch.equal(img_b.view(torch.int16), want[0].view(torch.int16)) \
                or not np.array_equal(lbl_b, want[1]):
            _fail("[sampler] the native and numpy routes differ")
    if any(_launches(counters).values()):
        _fail(f"[sampler] launched a kernel: {_launches(counters)}")
    med = {name: statistics.median(v) for name, v in ms.items()}
    print(f"  cache of one volume {cache_s:.2f} s; host ms a batch (median of 10, interleaved): "
          f"native crop + bf16 {med['native']:.1f} (min {min(ms['native']):.1f}), numpy route + "
          f"cast {med['numpy']:.1f} (min {min(ms['numpy']):.1f}); 10 batches bit-equal")
    return med


def report_flops(torch, step_ms) -> None:
    """The model's share of the card's dense bf16 peak in the warm steps of
    ``[train]``, ``[segresnet]`` and ``[unetr]`` (8 x 96^3). The augmentation
    is not credited: its FLOP count is the banded matmuls of the JAX
    package's rotation, which the port runs as kernel 8's line copies."""
    from segmantic_tpu_torch.utils import flops

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi: n/a"
    for arch, ms in step_ms.items():
        f = flops.flagship_step_flops(TRAIN_BATCH, TRAIN_PATCH, TRAIN_PATCH[0] // 4,
                                      NUM_CLASSES, arch=arch)
        share = f["model_fwd_bwd"] / (ms * 1e-3) / flops.H100_SXM_BF16_PEAK
        print(f"  {arch}: model fwd {f['model_fwd'] / 1e9:.1f} GFLOP, fwd+bwd "
              f"{f['model_fwd_bwd'] / 1e9:.1f} GFLOP a step (augment as banded matmuls "
              f"{f['augment'] / 1e9:.1f}, not credited); warm step {ms:.2f} ms -> "
              f"{f['model_fwd_bwd'] / (ms * 1e-3) / 1e12:.2f} TFLOP/s, {100 * share:.2f}% of "
              f"{flops.H100_SXM_BF16_PEAK / 1e12:.0f} TFLOP/s bf16 ({card})")
        if not 0 < share < 1:
            _fail(f"[flops] {arch}: a share of the peak outside (0, 1)")



# -- Parallel: the mesh paths (world of one over NCCL, two ranks over gloo) ----

LOCAL_BATCH = 4  # the flagship's rows a rank at two ranks


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _f32_step(torch, mesh, image, label, seed: int = 2):
    """One f32 flagship step on the card (flips off, SGD at lr 0, so the
    gradients stay in place), with or without a mesh: (loss, gradients,
    buffers, launches), tensors on the host in f64."""
    from segmantic_tpu_torch.train.augment import AugmentConfig
    from segmantic_tpu_torch.train.trainer import SegmentationModel, make_train_step

    model = SegmentationModel.create(num_classes=NUM_CLASSES, seed=seed, device="cuda")
    module = model.module.train().requires_grad_(True)
    step = make_train_step(module, torch.optim.SGD(module.parameters(), lr=0.0),
                           AugmentConfig(flip_prob=0.0), TRAIN_PATCH, False, mesh=mesh)
    counters = _reset_counters()
    loss = step(image, label).item()
    launches = _launches(counters)
    return (loss, {k: p.grad.cpu().double() for k, p in module.named_parameters()},
            {k: b.cpu().double() for k, b in module.named_buffers()}, launches)


def _judge_step(label, got, ref, other) -> None:
    """``[train-parity]``'s limits with the mesh-less card step as the
    reference: loss 1e-5 relative, BN statistics 1e-4 * max|ref| of each
    buffer, each gradient tensor k within 2 * e[k] + 1e-3 * max(max|g[k]|,
    1e-2 * the largest gradient anywhere). There e[k] is the f32 rounding of
    that tensor, measured on the card as the distance of ``other`` (the
    mesh-less step on the batch in reverse order: the same gradient summed in
    another order) from the reference, where ``[train-parity]`` measures the
    CPU's f32 step against f64."""
    (lg, gg, bg, _), (lr_, gr, br, _), (_, go, _, _) = got, ref, other
    rel = abs(lg - lr_) / abs(lr_)
    floor = 1e-2 * max(g.abs().max().item() for g in gr.values())
    worst_g = max(((gg[k] - g).abs().max().item()
                   / (2 * (go[k] - g).abs().max().item()
                      + 1e-3 * max(g.abs().max().item(), floor)), k)
                  for k, g in gr.items())
    worst_b = max(((bg[k] - b).abs().max().item() / b.abs().max().item(), k)
                  for k, b in br.items())
    print(f"  {label}: loss {lg:.9f} vs {lr_:.9f} (rel {rel:.3e}, limit 1e-5); worst BN "
          f"statistic {worst_b[0]:.3e} of max|ref| at {worst_b[1]} (limit 1e-4); worst "
          f"gradient {worst_g[0]:.3f} of its limit at {worst_g[1]}")
    if not (rel <= 1e-5 and worst_b[0] <= 1e-4 and worst_g[0] <= 1.0):
        _fail(f"{label}: the mesh step disagrees with the mesh-less step")


def _step_profile(torch, fn):
    """One call of ``fn`` under ``torch.profiler`` with CPU and CUDA activity:
    the host's ms to queue it and to finish it (a synchronise), the device ms
    of all its kernels, the NCCL kernels and their device ms, and each op's
    (calls, self host us)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        queued = time.perf_counter() - t0
        torch.cuda.synchronize()
        done = time.perf_counter() - t0
    out = {"queue_ms": queued * 1e3, "wall_ms": done * 1e3, "device_ms": 0.0,
           "nccl_kernels": 0, "nccl_ms": 0.0, "ops": {}}
    for e in prof.key_averages():
        on_card = str(getattr(e, "device_type", "")).endswith("CUDA")
        if on_card:
            out["device_ms"] += e.self_device_time_total / 1e3
            if "nccl" in e.key.lower():
                out["nccl_kernels"] += e.count
                out["nccl_ms"] += e.self_device_time_total / 1e3
        else:
            out["ops"][e.key] = (e.count, e.self_cpu_time_total)
    return out


def _profile_gap(profiles) -> None:
    """Print the host-side profile of the mesh-less and the mesh step, and
    the ops whose host time or calls the mesh step adds."""
    for name, p in profiles.items():
        print(f"  torch.profiler, one {name} step: queued in {p['queue_ms']:.2f} ms, done in "
              f"{p['wall_ms']:.2f} ms on the host; {p['device_ms']:.2f} ms of kernels on the "
              f"card; {p['nccl_kernels']} NCCL kernels, {p['nccl_ms']:.4f} ms")
    base, mesh = profiles["mesh-less"]["ops"], profiles["mesh"]["ops"]
    gap = sorted(((mesh.get(k, (0, 0.0))[1] - base.get(k, (0, 0.0))[1], k) for k in
                  set(base) | set(mesh)), reverse=True)
    total = sum(v[1] for v in mesh.values()) - sum(v[1] for v in base.values())
    print(f"  self host time the mesh step adds: {total / 1e3:.2f} ms in all; the largest:")
    for us, k in gap[:12]:
        print(f"    {k}: {us / 1e3:+.3f} ms, calls {base.get(k, (0, 0))[0]} -> "
              f"{mesh.get(k, (0, 0))[0]}")


def run_parallel_dp(torch):
    """``[parallel-dp]``: the flagship's step with a mesh at a world of one
    over NCCL against the mesh-less step. A data axis of 1 takes the
    mesh-less step (the JAX package's rule for its per-shard body), so a
    ``torchrun --nproc-per-node 1`` run costs what a run without torchrun
    does: one f32 step within ``[train-parity]``'s limits with the same
    kernel launches, then the warm bf16 step of each on 8 x 96^3 (5 timed
    after 3 warm), and one step of each under ``torch.profiler``: host and
    device ms, NCCL kernels, and the ops whose host time the mesh step adds."""
    from segmantic_tpu_torch.parallel import make_mesh
    from segmantic_tpu_torch.train.augment import AugmentConfig
    from segmantic_tpu_torch.train.optim import make_optimizer
    from segmantic_tpu_torch.train.trainer import SegmentationModel, make_train_step

    mesh = make_mesh()
    image, label = fixed_batch(torch, 2, 40)  # [train-parity]'s batch
    image, label = image.cuda(), label.cuda()
    ref = _f32_step(torch, None, image, label)
    other = _f32_step(torch, None, image.flip(0), label.flip(0))
    got = _f32_step(torch, mesh, image, label)
    _judge_step("f32 step, batch 2, mesh of one vs mesh-less", got, ref, other)
    if got[3] != ref[3]:
        _fail(f"the mesh step launched other kernels: {got[3]} vs {ref[3]}")
    print(f"  f32 step launches, both: {got[3]}")
    image, label = fixed_batch(torch, TRAIN_BATCH, 20)
    image, label = image.to("cuda", torch.bfloat16), label.cuda()
    numbers, launches, profiles = {}, {}, {}
    for name, m in (("mesh-less", None), ("mesh", mesh)):
        model = SegmentationModel.create(num_classes=NUM_CLASSES, seed=0, device="cuda")
        module = model.module.train().requires_grad_(True)
        step = make_train_step(module, make_optimizer(module.parameters(), {"lr": 1e-4}),
                               AugmentConfig(), TRAIN_PATCH, True,
                               generator=torch.Generator().manual_seed(0), mesh=m)
        ms, times, losses, peak = warm_steps(torch, step, image, label, n=5)
        counters = _reset_counters()
        step(image, label)
        torch.cuda.synchronize()
        launches[name] = _launches(counters)
        numbers[name] = ms
        print(f"  {name} bf16 step, 8 x 96^3, Adam 1e-4: warm median {ms:.2f} ms "
              f"({[round(t, 2) for t in times]}), peak {peak:.0f} MiB, losses "
              f"{[round(v, 4) for v in losses]}")
        profiles[name] = _step_profile(torch, lambda: step(image, label))
        del step, module, model
    _profile_gap(profiles)
    for key in ("queue_ms", "wall_ms", "device_ms"):
        numbers[f"profiled_{key}"] = {k: round(p[key], 3) for k, p in profiles.items()}
    numbers["nccl_kernels"] = profiles["mesh"]["nccl_kernels"]
    numbers["nccl_ms"] = profiles["mesh"]["nccl_ms"]
    if launches["mesh"] != launches["mesh-less"]:
        _fail(f"bf16 step launches differ: {launches}")
    print(f"  bf16 step launches, both: {launches['mesh']}")
    return launches["mesh"], numbers


def _sgd_steps(torch, mesh, image, label, n: int, zero: bool = False):
    """``n`` f32 flagship steps (flips off, SGD lr 1e-2 momentum 0.9) with
    ``mesh``: (losses, the whole parameters on the host, the optimizer's
    moment bytes on this rank, launches of the last step)."""
    from segmantic_tpu_torch.parallel import gather_params, shard_params
    from segmantic_tpu_torch.train.augment import AugmentConfig
    from segmantic_tpu_torch.train.optim import make_optimizer
    from segmantic_tpu_torch.train.trainer import SegmentationModel, make_train_step

    model = SegmentationModel.create(num_classes=NUM_CLASSES, seed=3, device="cuda")
    module = model.module.train().requires_grad_(True)
    if mesh.shape["model"] > 1:
        shard_params(mesh, module)
    opt = make_optimizer(module.parameters(), {"optimizer": "SGD", "lr": 1e-2,
                                               "momentum": 0.9})
    step = make_train_step(module, opt, AugmentConfig(flip_prob=0.0), TRAIN_PATCH, False,
                           mesh=mesh, zero=zero)
    losses = []
    for _ in range(n):
        counters = _reset_counters()
        losses.append(step(image, label).item())
    launches = _launches(counters)
    moments = sum(t.numel() * t.element_size() for st in opt.state.values()
                  for t in st.values() if torch.is_tensor(t) and t.ndim > 0)
    params = {k: v.detach().cpu() for k, v in gather_params(mesh, module).items()}
    return losses, params, moments, launches


def _dp2_rank(rank: int, port: int, out_dir: str) -> None:
    """One rank of ``[parallel-dp-2]``: both ranks on the card, over gloo."""
    sys.path.insert(0, str(ROOT))
    import torch
    import torch.distributed as dist

    from segmantic_tpu_torch.parallel import initialize_distributed, make_mesh
    from segmantic_tpu_torch.train.augment import AugmentConfig
    from segmantic_tpu_torch.train.optim import make_optimizer
    from segmantic_tpu_torch.train.trainer import SegmentationModel, make_train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    initialize_distributed(init_method=f"tcp://127.0.0.1:{port}", world_size=2, rank=rank,
                           backend="gloo")
    torch.cuda.set_device(0)
    mesh = make_mesh()
    host = {"calls": 0, "seconds": 0.0}
    real = {name: getattr(dist, name) for name in
            ("all_reduce", "reduce_scatter_tensor", "all_gather_into_tensor")}

    def timed(fn):
        def call(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            host["calls"] += 1
            host["seconds"] += time.perf_counter() - t0
            return out
        return call

    for name, fn in real.items():
        setattr(dist, name, timed(fn))
    out = {}
    try:
        image, label = fixed_batch(torch, TRAIN_BATCH, 40)  # the global batch
        image, label = image.cuda(), label.cuda()
        out["f32"] = _f32_step(torch, mesh, image, label)
        out["f32_host"] = dict(host)
        # ZeRO-1 against the replicated update, two steps on the batch of 8
        out["replicated"] = _sgd_steps(torch, mesh, image, label, 2)
        host.update(calls=0, seconds=0.0)
        out["zero"] = _sgd_steps(torch, mesh, image, label, 2, zero=True)
        out["zero_host"] = dict(host)
        # tensor parallelism (mesh (1, 2)) against data parallelism, batch 2
        out["dp_b2"] = _sgd_steps(torch, mesh, image[:2], label[:2], 2)
        host.update(calls=0, seconds=0.0)
        out["tp"] = _sgd_steps(torch, make_mesh(model=2), image[:2], label[:2], 2)
        out["tp_host"] = dict(host)
        # the augmented bf16 step at the local shapes: kernel 8 on this rank's rows
        host.update(calls=0, seconds=0.0)
        model = SegmentationModel.create(num_classes=NUM_CLASSES, seed=0, device="cuda")
        module = model.module.train().requires_grad_(True)
        step = make_train_step(module, make_optimizer(module.parameters(), {"lr": 1e-4}),
                               AugmentConfig(spatial=True, intensity=True), TRAIN_PATCH, True,
                               generator=torch.Generator().manual_seed(0), mesh=mesh)
        margin, margin_label = fixed_batch(torch, TRAIN_BATCH, 60, size=MARGIN_PATCH[0],
                                           volume=MARGIN_PATCH[0])
        margin = margin.to("cuda", torch.bfloat16)
        margin_label = margin_label.cuda()
        step(margin, margin_label)
        torch.cuda.synchronize()
        host.update(calls=0, seconds=0.0)
        counters = _reset_counters()
        out["aug_loss"] = step(margin, margin_label).item()
        torch.cuda.synchronize()
        out["aug_launches"] = _launches(counters)
        out["aug_host"] = dict(host)
        torch.save(out, Path(out_dir) / f"rank{rank}.pt")
    finally:
        for name, fn in real.items():
            setattr(dist, name, fn)
        dist.destroy_process_group()


def run_parallel_dp2(torch, work: Path):
    """``[parallel-dp-2]``: two ranks on the one card over gloo (NCCL refuses
    two ranks on one device; gloo takes CUDA tensors for ``all_reduce``,
    ``broadcast``, ``reduce_scatter_tensor`` and ``all_gather_into_tensor``,
    all that the data-parallel, ZeRO-1 and tensor-parallel steps use). The
    2-rank f32 step at a local batch of 4 against the 1-rank step on the batch
    of 8 within ``[train-parity]``'s limits; ZeRO-1 against the replicated
    update (two SGD steps, parameters within 1e-5 and half the moment bytes a
    rank) and tensor parallelism over both ranks against data parallelism (two
    SGD steps on 2 x 96^3, losses 2e-4 relative, parameters within 2e-4), the
    JAX tests' limits; each rank's launches of the kernels at the local
    shapes, in the f32 step and in an augmented bf16 step on 8 x 144^3 margin
    patches; the host seconds of the gloo collectives (gloo stages CUDA
    tensors through the host: no speed of the port)."""
    import torch.multiprocessing as mp

    image, label = fixed_batch(torch, TRAIN_BATCH, 40)
    ref = _f32_step(torch, None, image.cuda(), label.cuda())
    other = _f32_step(torch, None, image.flip(0).cuda(), label.flip(0).cuda())
    torch.cuda.empty_cache()
    work.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    mp.spawn(_dp2_rank, args=(_free_port(), str(work)), nprocs=2, join=True)
    print(f"  two ranks spawned, ran and joined in {time.perf_counter() - t0:.1f} s")
    ranks = [torch.load(work / f"rank{r}.pt") for r in range(2)]

    def host(h):
        return f"{h['calls']} gloo calls, {h['seconds'] * 1e3:.1f} ms host"

    for r, out in enumerate(ranks):
        _judge_step(f"rank {r}: f32 step, 2 ranks x 4 vs 1 rank x 8", out["f32"], ref, other)
        print(f"  rank {r}: f32 step launches {out['f32'][3]}; {host(out['f32_host'])}")
        print(f"  rank {r}: augmented bf16 step (4 local rows of 144^3) launches "
              f"{out['aug_launches']}; {host(out['aug_host'])}; loss {out['aug_loss']:.5f}")
        for name, base, atol, rtol, what in (
                ("zero", "replicated", 1e-5, 1e-5, "ZeRO-1 vs replicated, batch 8"),
                ("tp", "dp_b2", 2e-4, 2e-4, "TP (1, 2) vs DP (2, 1), batch 2")):
            (la, pa, ma, launch), (lb, pb, mb, _) = out[name], out[base]
            rel = max(abs(a - b) / abs(b) for a, b in zip(la, lb))
            worst = max(((pa[k] - v).abs().max().item(), k) for k, v in pb.items())
            ok = rel <= rtol and worst[0] <= atol
            print(f"  rank {r}: {what}: losses {la} vs {lb} (rel {rel:.3e}, limit {rtol:g}); "
                  f"worst parameter |d| {worst[0]:.3e} at {worst[1]} (limit {atol:g}); moment "
                  f"bytes {ma} vs {mb}; launches {launch}; {host(out[name + '_host'])} "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                _fail(f"[parallel-dp-2] {what} on rank {r}")
        if not 0.45 * ranks[r]["replicated"][2] < out["zero"][2] < 0.55 * out["replicated"][2]:
            _fail("[parallel-dp-2]: ZeRO-1 does not hold about half the moment bytes a rank")
    if ranks[0]["f32"][0] != ranks[1]["f32"][0]:
        _fail("the two ranks hold different losses")
    for name in ("fused_conv", "fused_conv_dw", "phase_conv", "phase_conv_dw",
                 "dice_phase_sums", "dice_phase_dx"):
        if min(out["f32"][3][name] for out in ranks) <= 0:
            _fail(f"{name} did not launch on every rank")
    if min(out["aug_launches"]["shear_group"] for out in ranks) <= 0:
        _fail("the shear-group kernel did not launch on every rank")
    launches = {}
    for out in ranks:
        _add_launches(launches, out["f32"][3])
        _add_launches(launches, out["aug_launches"])
    return launches


NODE_SEED = 30  # the nodes' samplers are seeded NODE_SEED + node, as train() seeds them
NODE_VOLUMES = 2  # 128^3 phantoms in each node's cache


def write_node_volumes(work: Path) -> None:
    """The nodes' training volumes: z-scored 128^3 labelled phantoms (what
    the default preprocessing would cache), as .npy files both nodes load."""
    import numpy as np

    work.mkdir(parents=True, exist_ok=True)
    for i in range(NODE_VOLUMES):
        img, lbl = labelled_phantom((128, 128, 128), 70 + i)
        np.save(work / f"image{i}.npy", ((img - img.mean()) / img.std()).astype(np.float32))
        np.save(work / f"label{i}.npy", lbl)


def node_sampler(torch, work: Path, node: int, margin: int = 0, bf16: bool = False):
    """Node ``node``'s ``PatchSampler`` over the phantoms of ``work``: 4 rows
    of 96^3 (+ 2 * margin) a batch, seeded ``NODE_SEED + node``."""
    import numpy as np

    from segmantic_tpu_torch.core.volume import Volume
    from segmantic_tpu_torch.data.cache import PatchSampler, VolumeCache

    files = [{"image": Volume(data=np.load(work / f"image{i}.npy")[None], affine=np.eye(4)),
              "label": Volume(data=np.load(work / f"label{i}.npy")[None], affine=np.eye(4))}
             for i in range(NODE_VOLUMES)]
    cache = VolumeCache(files, lambda sample: sample, NUM_CLASSES)
    return PatchSampler(cache, patch_size=TRAIN_PATCH, batch_size=LOCAL_BATCH, num_samples=4,
                        margin=margin, seed=NODE_SEED + node,
                        image_wire_dtype=torch.bfloat16 if bf16 else np.float32)


def _node_rank(rank: int, port: int, work: str) -> None:
    """One node of ``[parallel-nodes]``: a rank that torchrun would start with
    ``GROUP_RANK`` = rank, ``GROUP_WORLD_SIZE`` 2, ``LOCAL_WORLD_SIZE`` 1, on
    the one card over gloo."""
    sys.path.insert(0, str(ROOT))
    import torch
    import torch.distributed as dist

    from segmantic_tpu_torch.parallel import initialize_distributed, make_mesh
    from segmantic_tpu_torch.train.augment import AugmentConfig
    from segmantic_tpu_torch.train.optim import make_optimizer
    from segmantic_tpu_torch.train.trainer import SegmentationModel, make_train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    initialize_distributed(init_method=f"tcp://127.0.0.1:{port}", world_size=2, rank=rank,
                           backend="gloo", local_world_size=1)
    torch.cuda.set_device(0)
    work = Path(work)
    out = {}
    try:
        mesh = make_mesh()
        out["mesh"] = (mesh.process_index, mesh.process_count, mesh.shape["data"])
        # this node's own rows, drawn as train() draws them
        image, label = node_sampler(torch, work, mesh.process_index).sample_batch()
        out["rows"] = (torch.from_numpy(image), torch.from_numpy(label))
        out["f32"] = _f32_step(torch, mesh, torch.from_numpy(image).cuda(),
                               torch.from_numpy(label).cuda())
        # one augmented bf16 step on this node's margin rows: kernels 1-6, 8, 9
        model = SegmentationModel.create(num_classes=NUM_CLASSES, seed=0, device="cuda")
        module = model.module.train().requires_grad_(True)
        step = make_train_step(module, make_optimizer(module.parameters(), {"lr": 1e-4}),
                               AugmentConfig(spatial=True, intensity=True), TRAIN_PATCH, True,
                               generator=torch.Generator().manual_seed(0), mesh=mesh)
        margin, margin_label = node_sampler(torch, work, mesh.process_index,
                                            margin=TRAIN_PATCH[0] // 4, bf16=True).sample_batch()
        margin = margin.to("cuda")
        margin_label = torch.from_numpy(margin_label).cuda()
        step(margin, margin_label)
        torch.cuda.synchronize()
        counters = _reset_counters()
        t0 = time.perf_counter()
        out["aug_loss"] = step(margin, margin_label).item()
        out["aug_s"] = time.perf_counter() - t0
        out["aug_launches"] = _launches(counters)
        # one pix2pix iteration on this node's 8 of the 16 slices: i2i's
        # averaging over the data group of the two nodes
        src, dst = i2i_rows(torch)
        half = I2I_BATCH // 2
        rows = slice(mesh.process_index * half, (mesh.process_index + 1) * half)
        out["i2i"] = pix2pix_once(torch, mesh, src[rows], dst[rows])
        torch.save(out, work / f"node{rank}.pt")
    finally:
        dist.destroy_process_group()


def run_parallel_nodes(torch, work: Path):
    """``[parallel-nodes]``: the JAX package's multi-host rule on two torchrun
    nodes of one rank each, both on the one card over gloo. Each node's
    ``PatchSampler`` over 128^3 phantoms is seeded ``NODE_SEED + node`` and
    draws 4 rows of its own; the f32 step of the flagship on the two nodes
    (the global batch: node 0's rows, then node 1's) against the one-process
    f32 step on those 8 rows, within ``[train-parity]``'s limits; then one
    augmented bf16 step on each node's 4 margin rows of 144^3, with each
    rank's launches by kernel (kernels 1-6, 8 and 9 at the per-rank shapes)."""
    import torch.multiprocessing as mp

    write_node_volumes(work)
    rows = [node_sampler(torch, work, node).sample_batch() for node in range(2)]
    image = torch.cat([torch.from_numpy(r[0]) for r in rows])
    label = torch.cat([torch.from_numpy(r[1]) for r in rows])
    ref = _f32_step(torch, None, image.cuda(), label.cuda())
    other = _f32_step(torch, None, image.flip(0).cuda(), label.flip(0).cuda())
    src, dst = i2i_rows(torch)
    i2i_ref = pix2pix_once(torch, None, src, dst)
    i2i_other = pix2pix_once(torch, None, src[::-1].copy(), dst[::-1].copy())
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mp.spawn(_node_rank, args=(_free_port(), str(work)), nprocs=2, join=True)
    print(f"  two nodes spawned, ran and joined in {time.perf_counter() - t0:.1f} s")
    nodes = [torch.load(work / f"node{r}.pt") for r in range(2)]
    for r, out in enumerate(nodes):
        if out["mesh"] != (r, 2, 2):
            _fail(f"[parallel-nodes] rank {r} sees (node, nodes, data) {out['mesh']}")
        if not (torch.equal(out["rows"][0], torch.from_numpy(rows[r][0]))
                and torch.equal(out["rows"][1], torch.from_numpy(rows[r][1]))):
            _fail(f"[parallel-nodes] node {r} drew other rows than its sampler seeded "
                  f"{NODE_SEED + r}")
        _judge_step(f"node {r}: f32 step, 2 nodes x 4 rows vs 1 process x 8", out["f32"], ref,
                    other)
        print(f"  node {r}: f32 step launches {out['f32'][3]}")
        print(f"  node {r}: augmented bf16 step (4 rows of 144^3 -> 96^3) launches "
              f"{out['aug_launches']}; {out['aug_s'] * 1e3:.1f} ms host to .item(); loss "
              f"{out['aug_loss']:.5f}")
    if torch.equal(nodes[0]["rows"][1], nodes[1]["rows"][1]):
        _fail("[parallel-nodes] both nodes drew the same rows")
    if nodes[0]["f32"][0] != nodes[1]["f32"][0]:
        _fail("[parallel-nodes] the two nodes hold different losses")
    _judge_i2i_nodes(torch, [out["i2i"] for out in nodes], i2i_ref, i2i_other)
    for out in nodes:
        for name in ("fused_conv", "fused_conv_dw", "phase_conv", "phase_conv_dw",
                     "dice_phase_sums", "dice_phase_dx"):
            if min(out["f32"][3][name], out["aug_launches"][name]) <= 0:
                _fail(f"[parallel-nodes] {name} did not launch on every node")
        if out["aug_launches"]["shear_group"] <= 0:
            _fail("[parallel-nodes] the shear-group kernel did not launch on every node")
    launches = {}
    for out in nodes:
        _add_launches(launches, out["f32"][3])
        _add_launches(launches, out["aug_launches"])
        _add_launches(launches, out["i2i"][2])
    return launches


def _judge_i2i_nodes(torch, nodes, one, other):
    """The two nodes' pix2pix iteration (each on its 8 slices) against one
    process on the 16: both losses 1e-4 relative (``test_torch_i2i_train``'s
    limit); each gradient tensor k of the iteration (the D step's of the
    discriminator, the G step's of the generator) within ``[train-parity]``'s
    rule, 2 * e[k] + 1e-3 * max(max|g[k]|, 1e-2 * the largest gradient of its
    network), where e[k] is the distance of ``other`` (one process on the
    slices in reverse order) from ``one``; both nodes bit-equal. A gradient
    left unaveraged over the nodes is a half batch's, O(1) of it away. The
    parameters are not compared: Adam's first step moves an element by about
    lr * sign(g), so one whose gradient is rounding noise flips by 2 lr."""
    (l_one, _, _, g_one), g_other = one, other[3]
    floor = {net: 1e-2 * max(g.abs().max().item() for k, g in g_one.items()
                             if k.startswith(net + "."))
             for net in ("gen", "disc")}
    for r, (losses, _, launches, grads) in enumerate(nodes):
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, l_one))
        worst = max(((grads[k] - g).abs().max().item()
                     / (2 * (g_other[k] - g).abs().max().item()
                        + 1e-3 * max(g.abs().max().item(), floor[k.split(".")[0]])), k)
                    for k, g in g_one.items())
        print(f"  node {r}: pix2pix on 8 of 16 slices vs 1 process on 16: D loss "
              f"{losses[0]:.7f} vs {l_one[0]:.7f}, G loss {losses[1]:.7f} vs {l_one[1]:.7f} "
              f"(rel {rel:.3e}, limit 1e-4); worst gradient {worst[0]:.3f} of its limit at "
              f"{worst[1]}; launches {launches}")
        if not (rel <= 1e-4 and worst[0] <= 1.0):
            _fail(f"[parallel-nodes] node {r}'s pix2pix iteration disagrees with one process")
    if nodes[0][0] != nodes[1][0] or any(
            not torch.equal(nodes[0][3][k], nodes[1][3][k]) for k in nodes[0][3]):
        _fail("[parallel-nodes] the two nodes' pix2pix iterations differ")


def run_parallel_sw(torch, ckpt: Path):
    """``[parallel-sw]``: the served 256 x 256 x 176 phantom through the
    flagship, roi 96^3, sw-batch 4, at a world of one over NCCL: the
    window-sharded ``sliding_window_inference(mesh=)`` and
    ``sliding_window_inference_sharded`` against the in-memory path, <=
    1e-5 * max|ref| and every argmax equal; the device seconds of each (CUDA
    events around the call, the upload included) and kernel 7's launches."""
    import numpy as np

    from segmantic_tpu_torch.infer.sliding_window import (
        sliding_window_inference, sliding_window_inference_sharded,
    )
    from segmantic_tpu_torch.parallel import make_mesh
    from segmantic_tpu_torch.train.trainer import SegmentationModel, make_val_forward

    model = SegmentationModel.load(ckpt, device="cuda")
    fwd = make_val_forward(model.module)
    vol = phantom((256, 256, 176), 1)
    vol = ((vol - vol.mean()) / vol.std())[..., None].astype(np.float32)
    mesh = make_mesh()
    kw = dict(num_classes=NUM_CLASSES, device="cuda", wire_dtype=torch.bfloat16)
    runs = {
        "in memory": lambda: sliding_window_inference(vol, ROI, SW_BATCH, fwd, **kw),
        "window-sharded": lambda: sliding_window_inference(vol, ROI, SW_BATCH, fwd,
                                                           mesh=mesh, **kw),
        "volume-sharded": lambda: sliding_window_inference_sharded(vol, ROI, SW_BATCH, fwd,
                                                                   mesh, **kw),
    }
    out, launches, numbers = {}, {}, {}
    for name, fn in runs.items():
        fn()  # warm
        counters = _reset_counters()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out[name] = fn()
        end.record()
        torch.cuda.synchronize()
        numbers[name] = start.elapsed_time(end) / 1e3
        got = _launches(counters)
        if name != "in memory":
            _add_launches(launches, got)
        print(f"  {name}: {numbers[name]:.4f} s on the card, blend launches {got['blend']}, "
              f"launches {got}")
    ref = out["in memory"]
    scale = ref.abs().max().item()
    for name in ("window-sharded", "volume-sharded"):
        got = out[name]
        err = (got - ref).abs().max().item()
        agree = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
        ok = tuple(got.shape) == tuple(ref.shape) and err <= 1e-5 * scale and agree == 1.0
        print(f"  {name} vs in memory: max|d| {err:.3e} (limit 1e-5 * {scale:.3e}), argmax "
              f"agreement {agree:.6f} (limit 1) {'ok' if ok else 'FAIL'}")
        if not ok:
            _fail(f"[parallel-sw] {name} disagrees with the in-memory path")
    if min(launches.get(k, 0) for k in ("fused_conv", "phase_conv", "blend")) <= 0:
        _fail(f"[parallel-sw]: a kernel of the path did not launch: {launches}")
    return launches, numbers


I2I_LR = 2e-4  # the i2i CLI's Adam learning rate


def i2i_rows(torch):
    """The 16 slices of 256^2 that ``[parallel-i2i]`` and ``[parallel-nodes]``
    translate: (source, target) f32 channel-last arrays."""
    import numpy as np

    t1, t2 = i2i_pair((I2I_SLICE, I2I_SLICE, I2I_BATCH), 70)
    return tuple((np.moveaxis(t, 2, 0)[..., None] / 500.0 - 1.0).astype(np.float32)
                 for t in (t1, t2))


def pix2pix_once(torch, mesh, src, dst):
    """One pix2pix iteration at the CLI's width from the seed-0 networks,
    cuDNN's algorithms deterministic: ((D loss, G loss), the generator's
    parameters on the host, the launches by kernel, the gradients of the
    iteration on the host: the discriminator's of the D step and the
    generator's of the G step, keyed "disc." / "gen.")."""
    from segmantic_tpu_torch.i2i import train as i2i_train

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        gen, disc = i2i_train._init_pix2pix(src, dst, I2I_BASE, I2I_BLOCKS, 0, "cuda")
        d_step, g_step = i2i_train.make_pix2pix_steps(
            gen, disc, i2i_train._make_optim(gen.parameters(), I2I_LR),
            i2i_train._make_optim(disc.parameters(), I2I_LR), 100.0, mesh=mesh)
        counters = _reset_counters()
        losses = (d_step(src, dst).item(), g_step(src, dst)[0].item())
        torch.cuda.synchronize()
        grads = {f"{name}.{k}": p.grad.detach().cpu()
                 for name, net in (("gen", gen), ("disc", disc))
                 for k, p in net.named_parameters()}
        return (losses, {k: p.detach().cpu() for k, p in gen.named_parameters()},
                _launches(counters), grads)
    finally:
        torch.backends.cudnn.deterministic = deterministic


def run_parallel_i2i(torch):
    """``[parallel-i2i]``: one pix2pix iteration at the CLI's width (base
    64, 6 blocks, 16 x 256^2 slices, f32, Adam 2e-4) through the mesh path at
    a world of one over NCCL against the mesh-less iteration from the same
    weights, cuDNN's algorithms deterministic (as ``[i2i-parity]``): both
    losses 1e-5 relative, each generator tensor within 1e-6 * max|p|. A world
    of one differs from no mesh only by a flat copy of the gradients, an
    ``all_reduce`` over one rank and a division by 1, so the iteration is the
    same; an lr term would let any gradient through, since one Adam step
    moves an element by about lr whatever the gradient."""
    from segmantic_tpu_torch.parallel import make_mesh

    src, dst = i2i_rows(torch)
    out, launches = {}, {}
    for name, mesh in (("mesh-less", None), ("mesh", make_mesh())):
        if name == "mesh" and mesh.data_group is None:
            _fail("[parallel-i2i]: the mesh at a world of one has no data group")
        losses, params, launches[name], _ = pix2pix_once(torch, mesh, src, dst)
        out[name] = (losses, params)
        print(f"  {name}: D loss {losses[0]:.7f}, G loss {losses[1]:.7f}, launches "
              f"{launches[name]}")
    (lm, pm), (lr_, pr) = out["mesh"], out["mesh-less"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(lm, lr_))
    worst = max(((pm[k] - p).abs().max().item() / (1e-6 * p.abs().max().item() + 1e-30), k)
                for k, p in pr.items())
    print(f"  mesh vs mesh-less: losses rel {rel:.3e} (limit 1e-5); worst generator tensor "
          f"{worst[0]:.3f} of its limit at {worst[1]}")
    if not (rel <= 1e-5 and worst[0] <= 1.0):
        _fail("[parallel-i2i]: the mesh iteration disagrees with the mesh-less one")
    return launches["mesh"]


def check_local_kernels(torch):
    """``[local-kernels]``: kernels 2, 5-6, 8 and 9 at the shapes a rank's
    step gives them at two ranks (the flagship's local batch of 4), bf16, each
    against its plain version (the dw kernels 1e-3 * max|ref|; the shear
    group bit-equal; the Dice sums 1e-5 relative, dx 2e-2 * max|ref|), timed
    by CUDA-graph replay beside the plain version and, for the dw kernels,
    cuDNN's bf16 wgrad, with the bound. Returns {kernel: numbers} summed over
    its shapes, as ``_record`` sums them."""
    from segmantic_tpu_torch.ops import fused_conv, fused_shear, phase_conv, phase_dice
    from segmantic_tpu_torch.ops import shear_resample
    from segmantic_tpu_torch.ops.fast_conv import depth_to_space
    from segmantic_tpu_torch.train.augment import AugmentConfig, _subset_count

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(11)
    bf16 = torch.bfloat16
    B = LOCAL_BATCH
    results = {}

    def randn(*shape):
        return torch.randn(shape, generator=g).to(dev)

    def close(name, got, want, limit):
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        ref = want.float().abs().max().item()
        if err > limit * ref:
            _fail(f"[local-kernels] {name}: max|d| {err:.3e} > {limit:g} * {ref:.3e}")
        return err

    cases = [("fused_conv_dw", (B, 48, 48, 48, 16), 16), ("fused_conv_dw", (B, 24, 24, 24, 32), 32),
             ("fused_conv_dw", (B, 12, 12, 12, 64), 64), ("fused_conv_dw", (B, 6, 6, 6, 128), 128),
             ("fused_conv_dw", (B, 6, 6, 6, 128), 256), ("fused_conv_dw", (B, 6, 6, 6, 256), 256),
             ("phase_conv_dw", (B, 48, 48, 48, 64), 64), ("phase_conv_dw", (B, 24, 24, 24, 128), 128)]
    for name, x_shape, co in cases:
        dense = name == "fused_conv_dw"
        kernel = fused_conv.conv3d_dw if dense else phase_conv.phase_conv_dw
        plain = fused_conv.conv3d_dw_plain if dense else phase_conv.phase_conv_dw_plain
        x, dy = randn(*x_shape).to(bf16), randn(*x_shape[:4], co).to(bf16)
        c, cot = (x_shape[-1], co) if dense else (x_shape[-1] // 8, co // 8)
        got = kernel(x, dy)
        err = close(f"{name} {x_shape}->{co}", got, plain(x, dy), 1e-3)
        xc, dyc = (x, dy) if dense else (depth_to_space(x, c), depth_to_space(dy, cot))
        ms = _graph_ms(torch, lambda: kernel(x, dy))
        pms = _graph_ms(torch, lambda: plain(x, dy), n=5, launches=2)
        cms = _graph_ms(torch, lambda: torch.nn.grad.conv3d_weight(
            xc.permute(0, 4, 1, 2, 3), (cot, c, 3, 3, 3), dyc.permute(0, 4, 1, 2, 3),
            padding=1))
        print(f"  {name} x{x_shape}->{co}: max|d| {err:.3e}; kernel {ms:.4f} ms, plain "
              f"{pms:.4f} ms, cuDNN bf16 wgrad {cms:.4f} ms (CUDA graph replay)")
        _record(results, name, err=err, ms=ms, plain_ms=pms, nbytes=_nbytes(x, dy, got),
                ops=2 * 27 * c * cot * (xc.numel() // c), peak=PEAK_BF16, library_ms=cms)

    cfg = AugmentConfig(spatial=True)
    p_any = 1.0 - (1.0 - cfg.rotate_prob) ** 3 * (1.0 - cfg.zoom_prob)
    samples = _subset_count(p_any, B)
    passes, divz, _, groups = shear_resample.chain_plan(MARGIN_PATCH, 3, TRAIN_PATCH, 0.4, 0.8)
    angles = (torch.rand((samples, 3), generator=g) * 0.8 - 0.4).to(dev)
    zoom = torch.linspace(0.8, 1.3, samples).to(dev)
    coef = shear_resample.shear_coefficients(angles, zoom, passes, divz)
    for label, x, order, as_bf16 in (
            ("bf16 order 1", randn(samples, 1, *MARGIN_PATCH).to(bf16), 1, True),
            ("u8 order 0", torch.randint(0, NUM_CLASSES, (samples, 1, *MARGIN_PATCH),
                                         generator=g, dtype=torch.uint8).to(dev), 0, False)):
        for gi, (a_axis, b_axis, specs) in enumerate(groups):
            cg = coef[:, 3 * gi: 3 * gi + 3].contiguous()
            k = lambda: fused_shear.shear_group(  # noqa: E731
                x, a_axis, b_axis, cg, zoom, specs, order, as_bf16)
            p = lambda: fused_shear.shear_group_plain(  # noqa: E731
                x, a_axis, b_axis, cg, zoom, specs, order, as_bf16)
            got, want = k(), p()
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                _fail(f"[local-kernels] shear_group {label} group {gi}: not bit-equal")
            ms, pms = _graph_ms(torch, k), _median_ms(torch, p)
            dims, outputs = list(x.shape[2:]), 0
            for j, (_, _, out_ext) in enumerate(specs):
                axis = b_axis if j == 1 else a_axis
                dims[axis] = min(out_ext or dims[axis], dims[axis])
                outputs += samples * dims[0] * dims[1] * dims[2]
            print(f"  shear_group {label} group {gi} {tuple(x.shape)} -> {tuple(got.shape)}: "
                  f"bit-equal; kernel {ms:.4f} ms (graph replay), plain {pms:.4f} ms (eager)")
            _record(results, "shear_group", err=0.0, ms=ms, plain_ms=pms,
                    nbytes=_nbytes(x, got, cg, zoom), ops=3 * outputs * order, peak=PEAK_F32)
            x = want.contiguous()

    shape, lanes = (B, DICE_EXTENT, DICE_EXTENT, DICE_EXTENT), 8 * NUM_CLASSES
    xp = (randn(*shape, lanes) * 2.0).to(bf16)
    yp = torch.randint(0, NUM_CLASSES, (*shape, 8), generator=g, dtype=torch.uint8).to(dev)
    hot, cold = randn(B, lanes), randn(B, lanes)
    got = phase_dice.dice_phase_sums(xp, yp)
    want = phase_dice.dice_phase_sums_plain(xp, yp)
    torch.cuda.synchronize()
    rel = max(((a - b).abs().max() / b.abs().max()).item() for a, b in zip(got, want))
    if rel > 1e-5 or not torch.equal(got[2], want[2]):
        _fail(f"[local-kernels] dice_phase_sums: rel {rel:.3e}")
    err = max((a - b).abs().max().item() for a, b in zip(got, want))
    ms = _graph_ms(torch, lambda: phase_dice.dice_phase_sums(xp, yp))
    pms = _median_ms(torch, lambda: phase_dice.dice_phase_sums_plain(xp, yp))
    print(f"  dice_phase_sums xp{tuple(xp.shape)}: rel {rel:.2e}; kernel {ms:.4f} ms (graph "
          f"replay), plain {pms:.4f} ms")
    _record(results, "dice_phase_sums", err=err, ms=ms, plain_ms=pms,
            nbytes=_nbytes(xp, yp, *got), ops=7 * xp.numel(), peak=PEAK_F32)
    got_dx = phase_dice.dice_phase_dx(xp, yp, hot, cold)
    err = close("dice_phase_dx", got_dx, phase_dice.dice_phase_dx_plain(xp, yp, hot, cold), 2e-2)
    ms = _graph_ms(torch, lambda: phase_dice.dice_phase_dx(xp, yp, hot, cold))
    pms = _median_ms(torch, lambda: phase_dice.dice_phase_dx_plain(xp, yp, hot, cold))
    print(f"  dice_phase_dx xp{tuple(xp.shape)}: max|d| {err:.3e}; kernel {ms:.4f} ms (graph "
          f"replay), plain {pms:.4f} ms")
    _record(results, "dice_phase_dx", err=err, ms=ms, plain_ms=pms,
            nbytes=_nbytes(xp, yp, hot, cold, got_dx), ops=9 * xp.numel(), peak=PEAK_F32)
    return results


def run_parallel(torch, ckpt: Path, work: Path):
    """The four Parallel phases and the local-batch kernels; the world of one
    over NCCL lives from ``[parallel-dp]`` to ``[parallel-i2i]``. Returns
    {path: launches}."""
    import torch.distributed as dist

    from segmantic_tpu_torch.parallel import initialize_distributed

    t0 = time.perf_counter()
    print(f"[local-kernels] kernels 2, 5-6, 8 and 9 at a rank's shapes at two ranks (local "
          f"batch {LOCAL_BATCH}), bf16, vs their plain versions")
    local = check_local_kernels(torch)
    print("[local-kernels] " + json.dumps({k: {key: (round(v, 6) if isinstance(v, float) else v)
                                               for key, v in r.items()}
                                           for k, r in local.items()}))
    initialize_distributed(init_method=f"tcp://127.0.0.1:{_free_port()}", world_size=1,
                           rank=0, backend="nccl", local_rank=0)
    try:
        print("[parallel-dp] the flagship's step with make_train_step(mesh=make_mesh()) at a "
              "world of one over NCCL vs the mesh-less step")
        dp_launches, dp_numbers = run_parallel_dp(torch)
        print("[parallel-sw] window- and volume-sharded sliding window at a world of one "
              "over NCCL vs the in-memory path, flagship, 256x256x176, roi 96^3, sw-batch 4")
        sw_launches, sw_numbers = run_parallel_sw(torch, ckpt)
        print("[parallel-i2i] one pix2pix iteration through the mesh path at a world of one "
              "over NCCL vs the mesh-less iteration")
        i2i_launches = run_parallel_i2i(torch)
    finally:
        dist.destroy_process_group()
    print("[parallel-dp-2] two ranks on the one card over gloo: the data-parallel step at a "
          f"local batch of {LOCAL_BATCH} vs one rank at {TRAIN_BATCH}")
    dp2_launches = run_parallel_dp2(torch, work / "dp2")
    print(f"[parallel] the five Parallel phases: {time.perf_counter() - t0:.1f} s; step ms "
          f"{dp_numbers}; sliding window s {sw_numbers}")
    return {"parallel-dp": dp_launches, "parallel-sw": sw_launches,
            "parallel-i2i": i2i_launches, "parallel-dp-2 (both ranks)": dp2_launches}


def _card() -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi: n/a"


class Run:
    """What the phases of one run share: the scratch directory, the measured
    kernels ({kernel: {"max_abs_err", "ms", ...}}, summed over the phases
    that time them), each driven path's launches and numbers, and the
    flagship checkpoint (written when a phase first asks for it)."""

    def __init__(self, torch, work: Path):
        self.torch = torch
        self.work = work
        self.measured = {}
        self.launches = {}  # path -> {kernel: launches}
        self.numbers = {}  # path -> what it printed to keep
        self.done = {}  # phase -> its own result
        self.phase_s = {}
        self._ckpt = None

    def ckpt(self) -> Path:
        if self._ckpt is None:
            self._ckpt = self.work / "flagship.ckpt"
            make_checkpoint(self.torch, self._ckpt)
        return self._ckpt

    def measure(self, results) -> None:
        """Add a phase's kernel results: times and bounds summed, the largest
        error kept."""
        for name, r in results.items():
            m = self.measured.setdefault(name, {
                "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                "bytes_ms": 0.0, "ops_ms": 0.0, "library_ms": None})
            for key in ("ms", "plain_ms", "bound_ms", "bytes_ms", "ops_ms"):
                m[key] += r[key]
            if r["library_ms"] is not None:
                m["library_ms"] = (m["library_ms"] or 0.0) + r["library_ms"]
            m["max_abs_err"] = max(m["max_abs_err"], r["max_abs_err"])

    def path(self, name: str, launches, numbers=None) -> None:
        self.launches[name] = launches
        if numbers is not None:
            self.numbers[name] = numbers


# -- the phases, in the order of a whole run -----------------------------------


def phase_kernels(run: Run) -> None:
    print("[kernels] each kernel vs its plain version on the card "
          "(cudnn.allow_tf32=False, matmul precision 'highest')")
    run.measure(check_kernels(run.torch))


def phase_train_kernels(run: Run) -> None:
    print("[train-kernels] weight-gradient kernels and autograd Functions vs their "
          "plain versions, batch 8")
    run.measure(check_train_kernels(run.torch))


def phase_aug_kernels(run: Run) -> None:
    print("[aug-kernels] the shear-group kernel vs its plain version, three groups of the "
          "144^3 -> 96^3 chain, 5 samples, each with its launch plan; odd shapes once")
    run.measure(check_aug_kernels(run.torch))


def phase_dice_kernels(run: Run) -> None:
    print("[dice-kernels] the phase-Dice kernels vs their plain versions, "
          "xp (8,48,48,48,64), and the loss Function vs autograd")
    run.measure(check_dice_kernels(run.torch))


def phase_arch_kernels(run: Run) -> None:
    print("[arch-kernels] kernels 1 and 2 at the new conv shapes of SegResNet and UNETR, "
          "bf16, batch 8, vs their plain versions and cuDNN")
    run.measure(check_arch_kernels(run.torch))


def phase_serve(run: Run) -> None:
    torch = run.torch
    print("[serve] flagship UNet (16-32-64-128-256, 8 classes, roi 96^3, "
          "sw-batch 4, overlap 0.25) through the HTTP server")
    ckpt = run.ckpt()
    seconds, launches, session = serve_requests(torch, ckpt, run.work)
    print(f"  seconds per request: {[round(s, 3) for s in seconds]}")
    for sw_batch in (SW_BATCH, 16):  # the server's default, and the JAX benchmark's
        print(f"  sliding window on the card, one 256x256x176 volume (upload, "
              f"{-(-48 // sw_batch)} chunks of {sw_batch} x 96^3, blend with the weight "
              f"map): {device_seconds_per_volume(torch, session, sw_batch):.4f} s "
              f"(host clock to a synchronise, median of 5)")
    run.path("serve", launches)
    print("[parity] 4 x 96^3 windows: folded forward on the card vs the CPU")
    parity(torch, ckpt, session)


def phase_distance(run: Run) -> None:
    print("[distance] hausdorff_surface_distance and hausdorff_pointwise_distance, classes "
          "1-7, [serve]'s served 256x256x176 labels against the phantom's, spacing "
          f"{DIST_SPACING}, on the host through the native distance transform")
    run.numbers["distance"] = run_distance(run.torch, run.work)


def phase_train(run: Run) -> None:
    print("[train] train() with the flagship defaults (96^3 patches, batch 2 x 4 "
          "samples, bf16, Adam 1e-4, phase Dice, roi-160 validation, top-3 ckpts) "
          "on 4 + 1 phantoms of 128^3, 8 classes")
    launches, numbers = run_train(run.torch, run.work / "train")
    run.path("train", launches, numbers)


def phase_train_parity(run: Run) -> None:
    print("[train-parity] one f32 train step, batch 2 x 96^3: card vs CPU")
    train_parity(run.torch)


def phase_train_aug(run: Run) -> None:
    print("[train-aug] train(augment_spatial=True, augment_intensity=True) with the "
          "flagship defaults (144^3 margin patches -> 96^3) on the same phantoms")
    run.path("train-aug", *run_train_aug(run.torch, run.work / "train", run.work / "run_aug"))


def phase_label_gather(run: Run) -> None:
    print("[label-gather] the flagship's augmented step (8 x 144^3 bf16 margin patches -> "
          "96^3, spatial and intensity, spatial_subset) with label_affine_gather=True and "
          "False, interleaved")
    run.path("label-gather", *run_label_gather(run.torch))


def phase_sampler(run: Run) -> None:
    print("[sampler] PatchSampler, 8 x 144^3 margin batches (batch 2 x 4 samples, margin "
          "24, bf16 wire) from a cached 256x256x176 volume: the native crop vs the numpy "
          "route and its cast")
    run.numbers["sampler host ms"] = run_sampler(run.torch)


def phase_detect(run: Run) -> None:
    print(f"[detect] VertHeatMap on the card: a 1 mm spine crop {SPINE_SHAPE} uint8, "
          f"{SPINE_LEVELS} vertebra labels ({SPINE_LEVELS + 1} channels), gamma 1000")
    run.numbers["detect"] = run_detect(run.torch)


def phase_train_config(run: Run) -> None:
    print("[train-config] train(preprocessing=<config>, augmentation=<config>) with the "
          "flagship defaults: the default preprocessing spelled out as _target_ entries, "
          "a host augmentation pipeline (4 x 96^3 crops a volume), on the same phantoms")
    run.path("train-config", *run_train_config(run.torch, run.work / "train",
                                               run.work / "run_cfg",
                                               run.numbers["train"]["step_ms"]))


def _phase_arch(arch: str, title: str):
    def phase(run: Run) -> None:
        print(f"[{arch}] {title} at full width, 8 classes: train() on the same phantoms, "
              "the warm step, predict() on a labelled 256x256x176 phantom, three requests")
        run.path(arch, *run_arch(run.torch, arch, run.work / "train", run.work / arch))
    return phase


def phase_arch_parity(run: Run) -> None:
    print("[arch-parity] one f32 train step of SegResNet and UNETR: card vs the f64 CPU "
          "step")
    arch_parity(run.torch)


def phase_unetr_pack(run: Run) -> None:
    print("[unetr-pack] packed UNETR (feature 16, the default graph): kernels 3-6 at its "
          "phase-space conv shapes, bf16, batch 8, vs their plain versions, the bound and "
          "cuDNN, and the routes of the CI != CO convs; then the packed step vs the "
          "unpacked one, interleaved, on a fixed 8 x 96^3 bf16 batch")
    results, routes = check_unetr_pack_kernels(run.torch)
    run.measure(results)
    launches, numbers = unetr_pack_ab(run.torch)
    numbers["routes_ms"] = routes
    run.path("unetr-pack", launches, numbers)


def phase_train_extras(run: Run) -> None:
    print("[train-extras] flagship train() with accumulate_steps=2, remat=True, "
          "val_blend_mode='constant' and a profile_dir; the step with and without remat")
    run.path("train-extras", *run_train_extras(run.torch, run.work / "train",
                                               run.work / "extras"))


def phase_flops(run: Run) -> None:
    print("[flops] utils.flops.flagship_step_flops at 8 x 96^3 and the warm steps of "
          "[train], [segresnet] and [unetr]: the model's share of the bf16 peak")
    report_flops(run.torch, {"unet": run.numbers["train"]["step_ms"],
                             "segresnet": run.numbers["segresnet"]["step_ms"],
                             "unetr": run.numbers["unetr"]["step_ms"]})


def phase_train_2d(run: Run) -> None:
    print("[train-2d] the flagship UNet in 2D at full width (16-32-64-128-256, strides "
          "2^4, 2 residual units, BatchNorm, PReLU, 8 classes, 256^2 patches): train() "
          "on 4 + 1 labelled 512^2 phantoms; the warm step on a fixed 16 x 256^2 bf16 "
          "batch, Adam, plain and with the fused augmentation; the 2D SegResNet's, plain")
    launches, numbers, run.done["ckpt_2d"] = run_train_2d(run.torch, run.work / "train2d")
    run.path("train-2d", launches, numbers)


def phase_train_parity_2d(run: Run) -> None:
    print("[train-parity-2d] one f32 train step of the 2D UNet and the 2D SegResNet, "
          "batch 2 x 256^2: card vs the f64 CPU step")
    train_parity_2d(run.torch)


def phase_serve_2d(run: Run) -> None:
    print("[serve-2d] the 2D checkpoint behind make_server: a 1024 x 1024 image, roi "
          "256^2, overlap 0.25, sw-batch 16; against the CPU forward")
    run.path("serve-2d", *run_serve_2d(run.torch, run.done["ckpt_2d"], run.work / "serve2d"))


def phase_predict_2d(run: Run) -> None:
    print("[predict-2d] predict(test_labels=...) with the 2D checkpoint on a labelled "
          "1024 x 1024 phantom (sw-batch 4); against the CPU forward")
    run.path("predict-2d", *run_predict_2d(run.torch, run.done["ckpt_2d"],
                                           run.work / "predict2d"))


def phase_predict(run: Run) -> None:
    print("[predict] predict(test_labels=...) with the flagship checkpoint on two labelled "
          "256x256x176 phantoms (roi 96^3, sw-batch 4, overlap 0.25, bf16)")
    run.path("predict", *run_predict(run.torch, run.ckpt(), run.work / "predict"))


def phase_ensemble(run: Run) -> None:
    print("[ensemble] ensemble_creator() in mean, vote and select_best over three flagship "
          "checkpoints on one labelled 256x256x176 phantom (roi 96^3, overlap 0.5)")
    run.path("ensemble", *run_ensemble(run.torch, run.work / "ensemble"))


def phase_cross_validate(run: Run) -> None:
    print("[cross-validate] cross_validate() on four 128^3 phantoms plus one test "
          "phantom, one flagship scenario (max_epochs 1, device cuda), 2 folds")
    run.path("cross-validate", *run_cross_validate(run.torch, run.work / "cv"))


def phase_streamed(run: Run) -> None:
    print("[streamed] the flagship checkpoint on a 512 x 512 x 896 f32 host numpy volume, "
          "8 classes, roi 96^3, overlap 0.25, sw-batch 16: streamed from host memory by "
          "the sliding window's own rule; against the in-memory path on the card")
    run.path("streamed", *run_streamed(run.torch, run.ckpt()))


def phase_i2i_pix2pix(run: Run) -> None:
    print(f"[i2i-pix2pix] train_pix2pix at the CLI's width (base {I2I_BASE}, {I2I_BLOCKS} "
          f"blocks, batch {I2I_BATCH}, lr 2e-4, lambda_l1 100) on {I2I_SLICE}^2 slices of "
          f"{len(I2I_DEPTHS)} synthetic T1-like / T2-like pairs, {I2I_STEPS} iterations, f32")
    launches, numbers, run.done["p2p_ckpt"], run.done["i2i_pairs"] = run_i2i_pix2pix(
        run.torch, run.work / "i2i")
    run.path("i2i-pix2pix", launches, numbers)


def phase_i2i_cyclegan(run: Run) -> None:
    print(f"[i2i-cyclegan] train_cyclegan at the CLI's defaults (base {I2I_BASE}, "
          f"{I2I_BLOCKS} blocks, batch {I2I_BATCH}) over the same volumes unpaired, "
          f"{I2I_CG_STEPS} iterations, f32")
    launches, numbers, run.done["cg_ckpt"] = run_i2i_cyclegan(run.torch, run.work / "i2i",
                                                             run.done["i2i_pairs"])
    run.path("i2i-cyclegan", launches, numbers)


def phase_i2i_translate(run: Run) -> None:
    print("[i2i-translate] load_generator on both checkpoints, translate_volume of a "
          f"{I2I_SLICE}x{I2I_SLICE}x{I2I_DEPTHS[0]} volume: pix2pix and both CycleGAN "
          "directions")
    run.path("i2i-translate", *run_i2i_translate(run.torch, run.done["p2p_ckpt"],
                                                 run.done["cg_ckpt"],
                                                 run.done["i2i_pairs"][0][0]))


def phase_i2i_parity(run: Run) -> None:
    print("[i2i-parity] one f32 pix2pix iteration on the card against the f64 CPU iteration: "
          f"2D at full width (2 x {I2I_SLICE}^2), and a 3D generator and discriminator "
          f"(1 x {I2I_PARITY_3D}^3, base 16, 2 blocks) through kernels 1 and 2 on the f32 "
          "bodies; the f32 bodies at the 3D generator's conv shapes, the flagship's f32 "
          "training shapes and f32 packed UNETR's input layer")
    run.path("i2i-parity 3D", i2i_parity(run.torch))
    run.measure(check_i2i_kernels(run.torch))


def phase_parallel(run: Run) -> None:
    for name, launches in run_parallel(run.torch, run.ckpt(), run.work).items():
        run.path(name, launches)


def phase_parallel_nodes(run: Run) -> None:
    print("[parallel-nodes] two torchrun nodes of one rank each on the one card over gloo: "
          f"each node's sampler seeded {NODE_SEED} + node draws {LOCAL_BATCH} rows; the "
          "flagship's f32 step on both nodes vs one process on the 8 rows, node-major")
    run.path("parallel-nodes (both nodes)", run_parallel_nodes(run.torch,
                                                               run.work / "nodes"))


# name -> (function, the phases whose results it reads); a whole run runs
# every phase in this order, ``--phases`` the named ones and what they read
PHASES = {
    "kernels": (phase_kernels, ()),
    "train-kernels": (phase_train_kernels, ()),
    "aug-kernels": (phase_aug_kernels, ()),
    "dice-kernels": (phase_dice_kernels, ()),
    "arch-kernels": (phase_arch_kernels, ()),
    "serve": (phase_serve, ()),
    "distance": (phase_distance, ("serve",)),
    "train": (phase_train, ()),
    "train-parity": (phase_train_parity, ()),
    "train-aug": (phase_train_aug, ("train",)),
    "label-gather": (phase_label_gather, ()),
    "sampler": (phase_sampler, ()),
    "detect": (phase_detect, ()),
    "train-config": (phase_train_config, ("train",)),
    "segresnet": (_phase_arch("segresnet", "SegResNet (init_filters 8, blocks (1, 2, 2, 4) / "
                                           "(1, 1, 1), GroupNorm, ReLU)"), ("train",)),
    "unetr": (_phase_arch("unetr", "UNETR (hidden 768, 12 layers, 12 heads, MLP 3072, "
                                   "feature 16, patch 16, InstanceNorm, packed; val roi "
                                   "96^3)"), ("train",)),
    "arch-parity": (phase_arch_parity, ()),
    "unetr-pack": (phase_unetr_pack, ()),
    "train-extras": (phase_train_extras, ("train",)),
    "flops": (phase_flops, ("train", "segresnet", "unetr")),
    "train-2d": (phase_train_2d, ()),
    "train-parity-2d": (phase_train_parity_2d, ()),
    "serve-2d": (phase_serve_2d, ("train-2d",)),
    "predict-2d": (phase_predict_2d, ("train-2d",)),
    "predict": (phase_predict, ()),
    "ensemble": (phase_ensemble, ()),
    "cross-validate": (phase_cross_validate, ()),
    "streamed": (phase_streamed, ()),
    "i2i-pix2pix": (phase_i2i_pix2pix, ()),
    "i2i-cyclegan": (phase_i2i_cyclegan, ("i2i-pix2pix",)),
    "i2i-translate": (phase_i2i_translate, ("i2i-pix2pix", "i2i-cyclegan")),
    "i2i-parity": (phase_i2i_parity, ()),
    "parallel": (phase_parallel, ()),
    "parallel-nodes": (phase_parallel_nodes, ()),
}


def selected_phases(names) -> list:
    """The phases to run, in table order: all of them for ``None``, else the
    named ones and, transitively, the phases they read."""
    if names is None:
        return list(PHASES)
    unknown = [n for n in names if n not in PHASES]
    if unknown:
        _fail(f"unknown phases {unknown}; the phases are {list(PHASES)}")
    want, todo = set(), list(names)
    while todo:
        name = todo.pop()
        if name not in want:
            want.add(name)
            todo.extend(PHASES[name][1])
    return [n for n in PHASES if n in want]


def _kernel_line(run: Run) -> list:
    """Every kernel with its launches summed over the driven paths and its
    measured numbers (null where no phase of this run measured it)."""
    kernels = []
    for name, (src, replaces) in KERNELS.items():
        m = run.measured.get(name)
        row = {"name": name, "route": "cuda", "source": src, "replaces": replaces,
               "launches": sum(path.get(name, 0) for path in run.launches.values())}
        for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "library_ms"):
            row[key] = None if m is None else m[key]
        row["bound_by"] = None if m is None else (
            "bytes" if m["bytes_ms"] >= m["ops_ms"] else "operations")
        kernels.append(row)
    return kernels


def main(argv=None) -> None:
    import argparse

    parser = argparse.ArgumentParser(description="Chip smoke test of the PyTorch port "
                                     "(every phase by default).")
    parser.add_argument("--phases", help="comma-separated phases to run (with the phases "
                        "they read), of: " + ", ".join(PHASES))
    args = parser.parse_args(argv)
    names = None if args.phases is None else [n.strip() for n in args.phases.split(",")
                                              if n.strip()]
    phases = selected_phases(names)

    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is False: this smoke test needs a CUDA device")
    try:
        import segmantic_tpu_torch  # noqa: F401
        from segmantic_tpu_torch.ops import _cuda
    except ImportError as err:
        _fail(f"the repository is not around this script ({err})")

    print(_card())
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    if names is not None:
        print(f"[phases] {', '.join(phases)}")

    run_t0 = t0 = time.perf_counter()
    lib = _cuda.build()
    print(f"[build] {lib.name}: {time.perf_counter() - t0:.1f} s (nvcc, sm_90a)")
    report_conv_build(lib)
    report_kernel_build(lib, "blend_kernel")
    report_kernel_build(lib, "shear_group_kernel")
    report_kernel_build(lib, "dice_sums_kernel")
    report_kernel_build(lib, "dice_dx_kernel")
    report_dice_sass(lib)

    # f32 comparisons hold the plain versions to full f32: cuDNN would use
    # TF32 for f32 convs by default
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    with tempfile.TemporaryDirectory() as td:
        run = Run(torch, Path(td))
        for name in phases:
            t0 = time.perf_counter()
            PHASES[name][0](run)
            run.phase_s[name] = time.perf_counter() - t0

    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "segmantic_tpu"))
    if loaded:
        _fail(f"JAX or the JAX package was imported: {loaded[:5]}")
    print(f"[phase-seconds] { {k: round(v, 1) for k, v in run.phase_s.items()} }")
    for path, launches in run.launches.items():
        print(f"launches: {path} {launches}")
    for path, numbers in run.numbers.items():
        print(f"numbers: {path} {numbers}")
    kernels = _kernel_line(run)
    print(_card())  # again, in the output's tail beside the numbers
    print(f"[total] {time.perf_counter() - run_t0:.1f} s, the kernels' build included")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
