"""Probe of the dense Hopper bodies of kernels 1 and 2 (``csrc/conv3_dense.cuh``,
``csrc/conv3_dense_dw.cuh``) on the card.

``python3 probe_dense_rows.py [--small] [--rows i,j]`` (CUDA only; ``--rows``
times only those rows of ``ROWS``) builds the kernel library
(``segmantic_tpu_torch.ops._cuda``), prints ptxas' registers and spills of
every instantiation of the two bodies and its notes on their wgmma, then:

1. holds both bodies against ``conv3d_plain`` / ``conv3d_dw_plain`` on the f32
   upcasts of the same bf16 values (cuDNN's TF32 off; forward limit 1e-2 *
   max|ref| for bf16 out, 1e-4 for f32 out; dw 1e-3) at ragged shapes of every
   instance (C = CO = 8, 16; every relu mode, bf16 and f32 out, rings as short
   as a slot a warpgroup, a few blocks walking many bricks, grids whose D and H
   are no multiple of 8, lines of one row), each launched through its C entry
   point and repeated bit for bit, with sentinels past the output;
2. at the flagship's 48^3 x 16 (batch 4: serving; batch 8: training),
   SegResNet's 96^3 x 8 and UNETR(pack=False)'s 96^3 x 16 (batch 8): forward,
   input gradient (flipped, swapped weights) and weight gradient, the same
   check, then the body's time beside the tensor-core bodies
   (``conv3_mma.cuh``, ``conv3_dw_mma.cuh``, through their own entry points and
   plans), cuDNN's bf16 ``conv3d`` / ``conv3d_weight`` and the row's bound:
   CUDA-graph replay (``chip_smoke._graph_ms``), L2 warm;
3. with ``--small``: the same beside the tensor-core bodies at smaller
   volumes (where the rule's least volume lies);
4. with ``--variants``: where the bodies' time goes at each row. Patched
   copies of ``csrc/`` under ``build/probe/dense/`` (the library's own sources
   untouched), each ``fused_conv.cu`` / ``fused_conv_dw.cu`` alone built into
   its own library, are timed beside the bodies as they are: without their
   wgmma, without the forward's tail steps, without their staging (the
   producer arrives without copying), without the forward's stores, and the
   forward's warpgroups issuing without taking turns.

``python3 probe_dense_rows.py --pairs [--small] [--variants]`` probes the
dense pairs dw body (``csrc/conv3_dense_pairs_dw.cuh``, C = CO = 32) instead:
ragged shapes under the plan and other rings and grids, each against
``conv3d_dw_plain`` and repeated bit for bit with sentinels past the
workspace and the output; the 24^3 x 32 rows at batch 8, 4 and 2 and UNETR's
12^3 and 48^3 x 32 at batch 8 beside the tensor-core body, cuDNN's bf16 wgrad
and the bound; ``--small`` the volumes around
``fused_conv.DENSE_PAIRS_MIN_POSITIONS``; ``--variants`` patched copies
(``build/probe/dense_pairs/``, each ``fused_conv_dw_pairs.cu`` alone) without
its wgmma, without its staging, without the reduce launch after it, without
the partials' stores.

Every time is printed beside ``nvidia-smi --query-gpu=name,power.limit``.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

import chip_smoke
from segmantic_tpu_torch.ops import _cuda, fused_conv

ROWS = [((4, 48, 48, 48), 16, "flagship 48^3 x 16 B4 (serving)"),
        ((8, 48, 48, 48), 16, "flagship 48^3 x 16 B8 (training)"),
        ((8, 96, 96, 96), 8, "SegResNet 96^3 x 8 B8"),
        ((8, 96, 96, 96), 16, "UNETR(pack=False) 96^3 x 16 B8")]
SMALL = [((1, 48, 48, 48), 16, "48^3 x 16 B1"), ((2, 24, 24, 24), 16, "24^3 x 16 B2"),
         ((1, 16, 16, 16), 16, "16^3 x 16 B1"), ((1, 48, 48, 48), 8, "48^3 x 8 B1"),
         ((1, 24, 24, 24), 8, "24^3 x 8 B1"), ((1, 16, 16, 16), 8, "16^3 x 8 B1"),
         ((4, 48, 48, 48), 8, "48^3 x 8 B4"), ((1, 96, 96, 96), 8, "96^3 x 8 B1"),
         ((2, 96, 96, 96), 8, "96^3 x 8 B2")]
# (dims, C, stages, grid_x, relu, out dtype): rings of a slot a warpgroup and
# deeper, a few blocks walking many bricks (and a warpgroup with none), D and H
# no multiple of 8, one row a line
RAGGED = [((1, 10, 9, 8), 16, 3, 2, "prelu", torch.bfloat16),
          ((2, 7, 12, 24), 8, 2, 3, "relu", torch.float32),
          ((1, 3, 17, 4), 16, 3, 5, "none", torch.bfloat16),
          ((3, 9, 2, 16), 8, 2, 1, "prelu", torch.float32),
          ((2, 18, 20, 12), 16, 6, 7, "relu", torch.bfloat16),
          ((1, 16, 8, 8), 8, 8, 1, "none", torch.bfloat16)]
# (dims, C, stages, grid_x): the ring at least the epilogue's sums (five slots)
DW_RAGGED = [((1, 10, 9, 8), 16, 5, 2), ((2, 7, 12, 24), 8, 6, 3), ((1, 3, 17, 4), 16, 6, 5),
             ((3, 9, 2, 16), 8, 5, 1), ((2, 18, 20, 12), 16, 6, 7), ((1, 40, 33, 64), 8, 6, 132),
             ((2, 16, 24, 32), 16, 5, 20)]

ROOT = Path(__file__).resolve().parent
_FWD = "conv3_dense.cuh"
_DW = "conv3_dense_dw.cuh"
_NO_TAIL = [(_FWD, "        wgmma_ss<NT>(acct,", "        if (t == 99) wgmma_ss<NT>(acct,")]
_NO_MMA = [(_FWD, "        wgmma_ss_n64(acc, da0 + ((row * 128 + 32 * q) >> 4),",
            "        if (t == 99) wgmma_ss_n64(acc, da0 + ((row * 128 + 32 * q) >> 4),")] + _NO_TAIL
_NO_STAGE = [(_FWD, "        mbar_expect_tx(bar(s), DENSE_HALO * DENSE_HALO * (128 + TB));",
              "        mbar_arrive(bar(s));"),
             (_FWD, "        tma_load_4d(slot, &tm,", "        if (k < 0) tma_load_4d(slot, &tm,"),
             (_FWD, "        tma_load_4d(slot + BOX, &tmt,",
              "        if (k < 0) tma_load_4d(slot + BOX, &tmt,")]
_NO_STORE = [(_FWD, "        if (a.out_bf16) {", "        if (v0 == 1234.5f) {"),
             (_FWD, "        } else {\n          *reinterpret_cast<float2*>",
              "        } else if (v1 == 1234.5f) {\n          *reinterpret_cast<float2*>")]
_NO_TURNS = [(_FWD, "    turn_wait(wg, k > 0);", "    turn_wait(wg, false);"),
             (_FWD, "    turn_pass(wg, k + 1 < nk);", "    turn_pass(wg, false);")]
_DW_NO_MMA = [(_DW, "          wgmma_ss_n32_mn(\n              acc[h][ty],",
               "          if (k < 0) wgmma_ss_n32_mn(\n              acc[h][ty],")]
_DW_NO_STAGE = [(_DW, "        mbar_expect_tx(bar(s), 2 * 64 * 64 + 2 * DENSE_HALO * DENSE_HALO * 128);",
                 "        mbar_arrive(bar(s));"),
                (_DW, "        for (int h = 0; h < 2; ++h) {\n          tma_load_4d",
                 "        for (int h = 0; h < 0; ++h) {\n          tma_load_4d")]
VARIANTS = {"fwd no wgmma": _NO_MMA, "fwd no tail steps": _NO_TAIL,
            "fwd no staging": _NO_STAGE, "fwd no stores": _NO_STORE,
            "fwd wgmma alone": _NO_STAGE + _NO_STORE, "fwd no turns": _NO_TURNS,
            "dw no wgmma": _DW_NO_MMA, "dw no staging": _DW_NO_STAGE}


def build_variants() -> dict:
    """{name: C entry point} of the patched copies, built in parallel."""
    root = ROOT / "build" / "probe" / "dense"
    procs = {}
    for name, edits in VARIANTS.items():
        d = root / name.replace(" ", "_")
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_cuda._CSRC, d)
        for header, old, new in edits:
            text = (d / header).read_text()
            if old not in text:
                sys.exit(f"variant {name}: {old[:60]!r} is not in {header}")
            (d / header).write_text(text.replace(old, new))
        src = "fused_conv_dw.cu" if name.startswith("dw") else "fused_conv.cu"
        cmd = [_cuda.nvcc_path(), *_cuda.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
               str(d / src)]
        procs[name] = (d, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (d, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"variant {name}: nvcc failed\n{out[-2000:]}")
        entry = "segk_fused_conv3_dw_rows" if name.startswith("dw") else "segk_fused_conv3_rows"
        fn = getattr(ctypes.CDLL(str(d / "lib.so")), entry)
        fn.argtypes = _cuda._SIGNATURES[entry]
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


FAILED = []
SENTINELS = []


def fwd_run(x, w, kw, out_dtype, stages=None, grid_x=None, fn=None):
    """A closure launching the forward body through its C entry point (plan
    ``stages`` and ``grid_x`` where given), and its output tensor."""
    b, d, h, w_, c = x.shape
    p = fused_conv.dense_fwd_plan((b, d, h, w_), c, c)
    stages = stages or p.stages
    grid_x = min(grid_x or p.grid_x, p.nbricks)
    n = x.numel()
    out_all = torch.full((n + 4096,), 1232.0, dtype=out_dtype, device="cuda")
    out = out_all[:n].view(x.shape)
    SENTINELS.append(out_all[n:])
    s, t = fused_conv._epilogue_vectors(c, kw.get("bias"), kw.get("scale"), kw.get("shift"),
                                        x.device)
    alpha = kw.get("alpha")
    a = None if alpha is None else alpha.float().reshape(1).contiguous()
    packed = fused_conv.pack_weights_dense(w)
    args = (x.data_ptr(), packed.data_ptr(), s.data_ptr(), t.data_ptr(),
            None if a is None else a.data_ptr(),
            fused_conv.RELU_MODES[kw.get("relu_mode", "none")], out.data_ptr(), b, d, h, w_, c, c,
            int(out_dtype == torch.bfloat16), grid_x, stages,
            fused_conv.dense_fwd_smem_bytes(c, stages))

    def run(keep=(out_all, packed, s, t, a)):  # the closure holds what the kernel reads
        if fn is None:
            _cuda.launch("segk_fused_conv3_rows", *args)
        elif fn(*args, torch.cuda.current_stream().cuda_stream):
            sys.exit("probe: a variant failed to launch")
    return run, out


def dw_run(x, dy, stages=None, grid_x=None, fn=None):
    b, d, h, w_, c = x.shape
    p = fused_conv.dense_dw_plan((b, d, h, w_), c, c)
    stages = stages or p.stages
    grid_x = min(grid_x or p.grid_x, p.nbricks)
    ws = torch.empty(grid_x * 27 * c * c, dtype=torch.float32, device="cuda")
    out = torch.empty((3, 3, 3, c, c), dtype=torch.float32, device="cuda")
    args = (x.data_ptr(), dy.data_ptr(), ws.data_ptr(), out.data_ptr(), b, d, h, w_, c, c,
            grid_x, stages, fused_conv.dense_dw_smem_bytes(stages))

    def run(keep=(ws, out)):
        if fn is None:
            _cuda.launch("segk_fused_conv3_dw_rows", *args)
        elif fn(*args, torch.cuda.current_stream().cuda_stream):
            sys.exit("probe: a variant failed to launch")
    return run, out


def sentinels_intact() -> bool:
    torch.cuda.synchronize()
    return all(bool((t == 1232.0).all()) for t in SENTINELS)


def check(label, run, out, want, limit, repeats: int = 3) -> float:
    """The launch against the plain version, and ``repeats`` more launches
    bit-equal to the first; a failure is printed with where it lies and the
    probe goes on."""
    run()
    torch.cuda.synchronize()
    d = (out.float() - want).abs()
    err = (d.max() / want.abs().max()).item()
    first = out.clone()
    same = True
    for _ in range(repeats):
        run()
        torch.cuda.synchronize()
        same = same and torch.equal(out, first)
    print(f"  {label}: max|d| / max|ref| {err:.2e} (limit {limit:.0e}), {repeats} repeats "
          f"{'bit-equal' if same else 'DIFFER'}; sentinels "
          f"{'intact' if sentinels_intact() else 'OVERWRITTEN'}", flush=True)
    if err > limit:
        bad = (d > limit * want.abs().max()).nonzero()
        print(f"    wrong: {len(bad)} of {d.numel()}; first {bad[:8].tolist()}", flush=True)
    if err > limit or not same or not sentinels_intact():
        FAILED.append(label)
    return err


def bound_ms(x, ops_channels) -> float:
    """The larger of the bytes (x and an output of its size, or dy, read or
    written once) and the true products, at the card's published peaks."""
    nbytes = 2 * x.numel() * 2
    ops = 2 * 27 * ops_channels * x.numel()
    return max(nbytes / chip_smoke.HBM_BYTES_PER_S, ops / chip_smoke.PEAK_BF16) * 1e3


def row(dims, c, name, variants: dict) -> None:
    g = torch.Generator(device="cuda").manual_seed(dims[0] * 100 + c + dims[1])
    x = torch.randn(dims + (c,), generator=g, device="cuda").to(torch.bfloat16)
    w0 = torch.randn((3, 3, 3, c, c), generator=g, device="cuda") * (27 * c) ** -0.5
    p = fused_conv.dense_fwd_plan(dims, c, c)
    bound = bound_ms(x, c)
    for what, w in (("fwd", w0.to(torch.bfloat16)),
                    ("dx", fused_conv.flip_io(w0).to(torch.bfloat16))):
        want = fused_conv.conv3d_plain(x.float(), w.float())
        run, out = fwd_run(x, w, {}, torch.bfloat16)
        check(f"{name} {what}: {p.grid_x} blocks, ring {p.stages}, {p.nbricks} bricks", run, out,
              want, 1e-2)
        ms = chip_smoke._graph_ms(torch, run)
        tms = chip_smoke.tensor_core_conv_ms(torch, x, w)
        xc = x.permute(0, 4, 1, 2, 3)
        wc = w.permute(4, 3, 0, 1, 2).contiguous(memory_format=torch.channels_last_3d)
        lms = chip_smoke._graph_ms(torch, lambda: F.conv3d(xc, wc, padding=1))
        print(f"    dense body {ms:.4f} ms, tensor-core body {tms:.4f} ms, cuDNN bf16 conv3d "
              f"{lms:.4f} ms, bound {bound:.4f} ms; body / bound {ms / bound:.2f}, "
              f"tensor-core / body {tms / ms:.2f}", flush=True)
        for vname, fn in (variants.items() if what == "fwd" else ()):
            if vname.startswith("fwd"):
                vrun, _ = fwd_run(x, w, {}, torch.bfloat16, fn=fn)
                print(f"      variant {vname}: {chip_smoke._graph_ms(torch, vrun):.4f} ms",
                      flush=True)
    dy = torch.randn(dims + (c,), generator=g, device="cuda").to(torch.bfloat16)
    q = fused_conv.dense_dw_plan(dims, c, c)
    run, out = dw_run(x, dy)
    check(f"{name} dw: {q.grid_x} blocks, ring {q.stages}", run, out,
          fused_conv.conv3d_dw_plain(x, dy), 1e-3)
    ms = chip_smoke._graph_ms(torch, run)
    tms = chip_smoke.tensor_core_dw_ms(torch, x, dy)
    lms = chip_smoke._graph_ms(torch, lambda: torch.nn.grad.conv3d_weight(
        x.permute(0, 4, 1, 2, 3), (c, c, 3, 3, 3), dy.permute(0, 4, 1, 2, 3), padding=1))
    print(f"    dense dw body {ms:.4f} ms, tensor-core dw body {tms:.4f} ms, cuDNN bf16 wgrad "
          f"{lms:.4f} ms, bound {bound:.4f} ms; body / bound {ms / bound:.2f}, "
          f"tensor-core / body {tms / ms:.2f}", flush=True)
    for vname, fn in variants.items():
        if vname.startswith("dw"):
            vrun, _ = dw_run(x, dy, fn=fn)
            print(f"      variant {vname}: {chip_smoke._graph_ms(torch, vrun):.4f} ms", flush=True)


_PAIRS = "conv3_dense_pairs_dw.cuh"
PAIRS_VARIANTS = {
    "no wgmma": [("        wgmma_ss_n64_mn(acc[ty], da0",
                  "        if (k < 0) wgmma_ss_n64_mn(acc[ty], da0")],
    "no staging": [("        mbar_expect_tx(bar(s), 2 * DENSE_HALO * DENSE_HALO * 128 + "
                    "2 * DENSE_PAIRS_DY_BYTES);", "        mbar_arrive(bar(s));"),
                   ("        for (int v = 0; v < 2; ++v) {  // lanes from voxel v - 1 of row j",
                    "        for (int v = 0; v < 0; ++v) {  // lanes from voxel v - 1 of row j")],
    "no second launch": [("  const long long n = 27LL * 32 * 32;\n",
                          "  const long long n = 27LL * 32 * 32;\n"
                          "  if (n > 0) return static_cast<int>(cudaGetLastError());\n")],
    "no partial stores": [("        *reinterpret_cast<float2*>(part +",
                           "        if (acc[ty][0] == 1234.5f) *reinterpret_cast<float2*>(part +")],
}
PAIRS_ROWS = [((8, 24, 24, 24), "24^3 x 32 B8"), ((4, 24, 24, 24), "24^3 x 32 B4 (a rank)"),
              ((2, 24, 24, 24), "24^3 x 32 B2"), ((8, 12, 12, 12), "12^3 x 32 B8"),
              ((8, 48, 48, 48), "48^3 x 32 B8")]
PAIRS_SMALL = [((1, 24, 24, 24), "24^3 x 32 B1"), ((4, 12, 12, 12), "12^3 x 32 B4"),
               ((2, 16, 16, 16), "16^3 x 32 B2"), ((1, 32, 32, 32), "32^3 x 32 B1")]
# (dims, stages, grid_x): the plan's, short rings, a few blocks walking many
# bricks, D and H no multiple of 8, lines of one row
PAIRS_RAGGED = [((1, 10, 9, 8), None, None), ((2, 7, 12, 6), 2, 3), ((1, 3, 17, 4), 3, 5),
                ((3, 9, 2, 2), 2, 1), ((2, 18, 20, 12), 5, 7), ((1, 40, 33, 64), None, None),
                ((2, 16, 24, 32), 4, 20)]


def build_pairs_variants() -> dict:
    root = ROOT / "build" / "probe" / "dense_pairs"
    procs = {}
    for name, edits in PAIRS_VARIANTS.items():
        d = root / name.replace(" ", "_")
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_cuda._CSRC, d)
        text = (d / _PAIRS).read_text()
        for old, new in edits:
            if old not in text:
                sys.exit(f"variant {name}: {old[:60]!r} is not in {_PAIRS}")
            text = text.replace(old, new)
        (d / _PAIRS).write_text(text)
        cmd = [_cuda.nvcc_path(), *_cuda.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
               str(d / "fused_conv_dw_pairs.cu")]
        procs[name] = (d, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (d, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"variant {name}: nvcc failed\n{out[-2000:]}")
        fn = ctypes.CDLL(str(d / "lib.so")).segk_fused_conv3_dw_pairs
        fn.argtypes = _cuda._SIGNATURES["segk_fused_conv3_dw_pairs"]
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def pairs_run(x, dy, stages=None, grid_x=None, fn=None):
    """A closure launching the pairs body through its C entry point (the
    plan's ring and grid unless given), and its output tensor."""
    b, d, h, w_, c = x.shape
    p = fused_conv.dense_pairs_plan((b, d, h, w_), c, c)
    stages = stages or p.stages
    grid_x = min(grid_x or p.grid_x, p.nbricks)
    nws = grid_x * 27 * c * c
    ws_all = torch.full((nws + 4096,), 1232.0, dtype=torch.float32, device="cuda")
    out_all = torch.full((27 * c * c + 4096,), 1232.0, dtype=torch.float32, device="cuda")
    ws, out = ws_all[:nws], out_all[:27 * c * c].view(3, 3, 3, c, c)
    SENTINELS.extend([ws_all[nws:], out_all[27 * c * c:]])
    args = (x.data_ptr(), dy.data_ptr(), ws.data_ptr(), out.data_ptr(), b, d, h, w_, c, c,
            grid_x, stages, fused_conv.dense_pairs_smem_bytes(stages))

    def run(keep=(ws_all, out_all)):
        if fn is None:
            _cuda.launch("segk_fused_conv3_dw_pairs", *args)
        elif fn(*args, torch.cuda.current_stream().cuda_stream):
            sys.exit("probe: a variant failed to launch")
    return run, out


def pairs_main(card: str) -> None:
    lib = _cuda.build()
    for line in lib.with_name(lib.stem + ".log").read_text().splitlines():
        if "C75" in line and "pairs" in line:  # ptxas' notes about its wgmma
            print(f"  {line.strip()[:300]}")
    for line, regs, stack, spill in chip_smoke._ptxas_reports(lib, "conv3_dense_pairs_kernel"):
        print(f"  ptxas conv3_dense_pairs_kernel: {regs} registers, stack {stack}, "
              f"spill bytes {spill}")
    variants = build_pairs_variants() if "--variants" in sys.argv else {}
    print("[ragged] the pairs body against the plain version:")
    for k, (dims, stages, grid_x) in enumerate(PAIRS_RAGGED):
        g = torch.Generator(device="cuda").manual_seed(70 + k)
        x = torch.randn(dims + (32,), generator=g, device="cuda").to(torch.bfloat16)
        dy = torch.randn(dims + (32,), generator=g, device="cuda").to(torch.bfloat16)
        run, out = pairs_run(x, dy, stages, grid_x)
        check(f"dw {dims} C 32, ring {stages or 'plan'}, {grid_x or 'plan'} blocks", run, out,
              fused_conv.conv3d_dw_plain(x, dy), 1e-3)
    print(f"[rows] bf16, CUDA-graph replay, L2 warm ({card}):")
    rows = PAIRS_ROWS + (PAIRS_SMALL if "--small" in sys.argv else [])
    for k, (dims, name) in enumerate(rows):
        g = torch.Generator(device="cuda").manual_seed(90 + k)
        x = torch.randn(dims + (32,), generator=g, device="cuda").to(torch.bfloat16)
        dy = torch.randn(dims + (32,), generator=g, device="cuda").to(torch.bfloat16)
        q = fused_conv.dense_pairs_plan(dims, 32, 32)
        run, out = pairs_run(x, dy)
        check(f"{name}: {q.grid_x} blocks, ring {q.stages}, {q.nbricks} bricks", run, out,
              fused_conv.conv3d_dw_plain(x, dy), 1e-3)
        ms = chip_smoke._graph_ms(torch, run)
        tms = chip_smoke.tensor_core_dw_ms(torch, x, dy)
        lms = chip_smoke._graph_ms(torch, lambda: torch.nn.grad.conv3d_weight(
            x.permute(0, 4, 1, 2, 3), (32, 32, 3, 3, 3), dy.permute(0, 4, 1, 2, 3), padding=1))
        bound = bound_ms(x, 32)
        print(f"    pairs dw body {ms:.4f} ms, tensor-core dw body {tms:.4f} ms, cuDNN bf16 "
              f"wgrad {lms:.4f} ms, bound {bound:.4f} ms; body / bound {ms / bound:.2f}, "
              f"tensor-core / body {tms / ms:.2f}", flush=True)
        for vname, fn in variants.items():
            vrun, _ = pairs_run(x, dy, fn=fn)
            print(f"      variant {vname}: {chip_smoke._graph_ms(torch, vrun):.4f} ms", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("probe_dense_rows: CUDA is not available")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}")
    torch.backends.cudnn.allow_tf32 = False  # the plain versions in full f32
    if "--pairs" in sys.argv:
        pairs_main(card)
        print(f"card: {card}")
        if FAILED:
            sys.exit(f"probe: {len(FAILED)} checks failed: {FAILED}")
        return
    lib = _cuda.build()
    log = lib.with_name(lib.stem + ".log").read_text().splitlines()
    for line in log:  # ptxas' notes about the bodies' wgmma (C75xx)
        if ("C75" in line or "erializ" in line) and "dense" in line:
            print(f"  {line.strip()[:300]}")
    for name in ("conv3_dense_fwd_kernel", "conv3_dense_dw_kernel"):
        for line, regs, stack, spill in chip_smoke._ptxas_reports(lib, name):
            inst = line.split(name)[1].split("EEv")[0]
            print(f"  ptxas {name}{inst}: {regs} registers, stack {stack}, spill bytes {spill}")

    variants = build_variants() if "--variants" in sys.argv else {}
    print("[ragged] the bodies at every instance against the plain versions:")
    for k, (dims, c, stages, grid_x, relu, out_dtype) in enumerate(RAGGED):
        g = torch.Generator(device="cuda").manual_seed(k)
        x = torch.randn(dims + (c,), generator=g, device="cuda").to(torch.bfloat16)
        w = (torch.randn((3, 3, 3, c, c), generator=g, device="cuda") * 0.2).to(torch.bfloat16)
        kw = dict(bias=torch.randn(c, generator=g, device="cuda") * 0.1,
                  scale=torch.randn(c, generator=g, device="cuda").abs() + 0.5,
                  shift=torch.randn(c, generator=g, device="cuda") * 0.1,
                  alpha=torch.tensor([0.25], device="cuda"), relu_mode=relu)
        want = fused_conv.conv3d_plain(x.float(), w.float(), **kw)
        run, out = fwd_run(x, w, kw, out_dtype, stages, grid_x)
        check(f"fwd {dims} C {c}, ring {stages}, {grid_x} blocks, {relu}, out "
              f"{str(out_dtype)[6:]}", run, out, want, 1e-2 if out_dtype == torch.bfloat16
              else 1e-4)
    for k, (dims, c, stages, grid_x) in enumerate(DW_RAGGED):
        g = torch.Generator(device="cuda").manual_seed(50 + k)
        x = torch.randn(dims + (c,), generator=g, device="cuda").to(torch.bfloat16)
        dy = torch.randn(dims + (c,), generator=g, device="cuda").to(torch.bfloat16)
        run, out = dw_run(x, dy, stages, grid_x)
        check(f"dw {dims} C {c}, ring {stages}, {grid_x} blocks", run, out,
              fused_conv.conv3d_dw_plain(x, dy), 1e-3)

    print(f"[rows] bf16, CUDA-graph replay, L2 warm ({card}):")
    rows = ROWS + (SMALL if "--small" in sys.argv else [])
    if "--rows" in sys.argv:  # --rows i,j: only those of ROWS
        rows = [ROWS[int(k)] for k in sys.argv[sys.argv.index("--rows") + 1].split(",")]
    for dims, c, name in rows:
        row(dims, c, name, variants)
    print(f"card: {card}")
    if FAILED:
        sys.exit(f"probe: {len(FAILED)} checks failed: {FAILED}")


if __name__ == "__main__":
    main()
