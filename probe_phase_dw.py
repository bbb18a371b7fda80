"""Probe of the phase dw's Hopper body (``csrc/conv3_phase_dw.cuh``) on the card.

``python3 probe_phase_dw.py [--plans]`` (CUDA only) builds the kernel library
(``segmantic_tpu_torch.ops._cuda``), prints ptxas' registers and spills of
every instantiation of the body, then:

1. holds the body against ``phase_conv_dw_plain`` (f32 on the bf16 values,
   limit 1e-3 * max|ref|) at ragged shapes of every instance (Ci = 8, 16,
   32, 64; Co = 8, 16, 32, 48), each launched through its C entry point with
   its plan and repeated bit for bit;
2. at packed UNETR's four phase dw rows and the flagship's L = 64 / L = 128
   rows (bf16, batch 8) the same check, then the body's time beside the
   tensor-core body (``conv3_dw_mma.cuh``, through its own entry point and
   plan) and cuDNN's bf16 wgrad on the full-resolution views (the
   rearrangement not timed), and the row's bound: CUDA-graph replay
   (``chip_smoke._graph_ms``), L2 warm;
3. with ``--plans``: at each row the body under other bricks, instances and
   split counts than its plan's (``fused_conv._phase_dw_candidates``, the
   ten cheapest by the cost count and one of each instance), each timed the
   same way;
4. with ``--variants``: where the body's time goes at each row. Patched
   copies of ``csrc/`` under ``build/probe/phase_dw/`` (the library's own
   sources untouched), each ``phase_conv_dw.cu`` alone built into its own
   library, are timed beside the body as it is: without its wgmma, without
   its ldmatrix loads (the fragments from the lane's address), without its
   staging (the producer arrives without copying), and with the staging
   alone (neither loads nor wgmma).

``python3 probe_phase_dw.py --pieces [--small] [--plans] [--variants]``
probes the phase pieces body (``csrc/conv3_phase_pieces_dw.cuh``, Ci = Co = 8)
instead: ragged shapes under the plan and other bricks, splits and rings, each
against ``phase_conv_dw_plain`` and repeated bit for bit with sentinels past
the workspace and the output; the flagship's L = 64 at batch 8 and a rank's
batch 4 beside the tensor-core body, the phase Hopper body at Ci = 8, cuDNN's
bf16 wgrad and the bound; ``--small`` the block volumes around
``fused_conv.PHASE_PIECES_MIN_POSITIONS``; ``--plans`` other bricks at the
rows; ``--variants`` patched copies (``build/probe/phase_pieces/``, each
``phase_conv_dw_pieces.cu`` alone) without its wgmma, without its ldmatrix
loads, without its staging.

Every time is printed beside ``nvidia-smi --query-gpu=name,power.limit``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import shutil
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke
from segmantic_tpu_torch.ops import _cuda, fused_conv, phase_conv
from segmantic_tpu_torch.ops.fast_conv import depth_to_space

ROWS = [((8, 96, 96, 96), 16, 16, "UNETR p 48^3 x 128"),
        ((8, 96, 96, 96), 32, 16, "UNETR p 48^3 x 256 -> 128"),
        ((8, 48, 48, 48), 32, 32, "UNETR p 24^3 x 256"),
        ((8, 48, 48, 48), 64, 32, "UNETR p 24^3 x 512 -> 256"),
        ((8, 96, 96, 96), 8, 8, "flagship L = 64"),
        ((8, 48, 48, 48), 16, 16, "flagship L = 128")]
RAGGED = [((1, 6, 10, 18), 16, 16), ((2, 4, 6, 22), 8, 8), ((1, 6, 4, 10), 32, 16),
          ((1, 4, 6, 6), 32, 48), ((1, 6, 4, 6), 64, 32), ((2, 10, 2, 4), 16, 32),
          ((1, 2, 2, 2), 8, 16)]


ROOT = Path(__file__).resolve().parent
_NO_MMA = [("for (int i = 0; i < 3; ++i) wgmma_rs_mn<N>(acc[i], f[apy + 2 - i], db);",
            "for (int i = 0; i < 3; ++i) acc[i][0] += (float)(f[apy + 2 - i][0] & 1) "
            "+ (float)(db & 1);"),
           ("for (int i = 0; i < TPW; ++i) wgmma_rs_mn<N>(acc[i], f[i], db);",
            "for (int i = 0; i < TPW; ++i) acc[i][0] += (float)(f[i][0] & 1) + (float)(db & 1);")]
_NO_LOAD = [("      ldsm_x4_trans(gbase + (lo >> 6)",
             "      f[0] = f[1] = f[2] = f[3] = hr + lo;\n      if (false) ldsm_x4_trans(gbase + (lo >> 6)")]
_NO_STAGE = [("    mbar_expect_tx(bar(p_s), tx_bytes);", "    mbar_arrive(bar(p_s));"),
             ("    for (int c = 0; c < nck_p; ++c)\n      tma_load_5d",
              "    for (int c = 0; c < 0; ++c)\n      tma_load_5d"),
             ("    for (int c = 0; c < nck_g; ++c)\n      tma_load_5d",
              "    for (int c = 0; c < 0; ++c)\n      tma_load_5d")]
VARIANTS = {"no wgmma": _NO_MMA, "no ldmatrix": _NO_LOAD, "no staging": _NO_STAGE,
            "staging alone": _NO_MMA + _NO_LOAD}


def build_variants() -> dict:
    """{name: ctypes library} of the patched copies, built in parallel."""
    root = ROOT / "build" / "probe" / "phase_dw"
    procs = {}
    for name, edits in VARIANTS.items():
        d = root / name.replace(" ", "_")
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_cuda._CSRC, d)
        header = d / "conv3_phase_dw.cuh"
        text = header.read_text()
        for old, new in edits:
            if old not in text:
                sys.exit(f"variant {name}: {old[:50]!r} is not in the header")
            text = text.replace(old, new)
        header.write_text(text)
        cmd = [_cuda.nvcc_path(), *_cuda.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
               str(d / "phase_conv_dw.cu")]
        procs[name] = (d, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (d, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"variant {name}: nvcc failed\n{out[-2000:]}")
        lib = ctypes.CDLL(str(d / "lib.so"))
        fn = lib.segk_phase_conv3_dw_wgmma
        fn.argtypes = _cuda._SIGNATURES["segk_phase_conv3_dw_wgmma"]
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def body_run(p_in, g_in, dims, c, co, plan, fn=None):
    """A closure launching the body with ``plan`` (through ``fn``, a
    variant's entry point, where given) and its output tensor."""
    b, d, h, w = dims
    # sentinels past the workspace and the output: a write beyond them shows
    ws_all = torch.full((plan.workspace + 4096,), 1234.5, dtype=torch.float32, device="cuda")
    out_all = torch.full((27 * c * co + 4096,), 1234.5, dtype=torch.float32, device="cuda")
    ws, out = ws_all[:plan.workspace], out_all[:27 * c * co].view(3, 3, 3, c, co)
    SENTINELS.append((ws_all[plan.workspace:], out_all[27 * c * co:]))
    args = (p_in.data_ptr(), g_in.data_ptr(), ws.data_ptr(), out.data_ptr(), b, d, h, w, c, co,
            plan.td, plan.th, plan.tw, plan.tpw, plan.nwg, plan.splits, plan.stages,
            plan.smem_bytes)

    def run(keep=(ws_all, out_all)):  # the kernel writes both: the closure holds them
        if fn is None:
            _cuda.launch("segk_phase_conv3_dw_wgmma", *args)
        elif fn(*args, torch.cuda.current_stream().cuda_stream):
            sys.exit("probe: a variant failed to launch")
    return run, out


def tensor_core_run(p_in, g_in, dims, c, co):
    b, d, h, w = dims
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = fused_conv.dw_plan(dims, c, co, sms)
    ws = torch.empty(max(plan.workspace, 1), dtype=torch.float32, device="cuda")
    out = torch.empty((3, 3, 3, c, co), dtype=torch.float32, device="cuda")

    def run():
        _cuda.launch("segk_phase_conv3_dw_mma", p_in.data_ptr(), g_in.data_ptr(), ws.data_ptr(),
                     out.data_ptr(), b, d, h, w, c, co, plan.td, plan.th, plan.tw, plan.ck,
                     plan.nt, plan.splits, plan.stages, plan.smem_bytes)
    return run, out


FAILED = []
SENTINELS = []


def sentinels_intact() -> bool:
    torch.cuda.synchronize()
    return all(bool((t == 1234.5).all()) for pair in SENTINELS for t in pair)


def check(label, run, out, want, repeats: int = 4) -> float:
    """The launch against the plain version, and ``repeats`` more launches
    bit-equal to the first; a failure is printed with where it lies
    (taps, input and output channels that differ) and the probe goes on."""
    run()
    torch.cuda.synchronize()
    err = ((out - want).abs().max() / want.abs().max()).item()
    first = out.clone()
    apart, worst = 0.0, None
    for _ in range(repeats):
        run()
        torch.cuda.synchronize()
        d = (out - first).abs()
        if d.max().item() > apart:
            apart, worst = d.max().item(), (out - want).abs().reshape(27, *out.shape[3:])
    print(f"  {label}: max|d| / max|ref| {err:.2e}, {repeats} repeats "
          f"{'bit-equal' if apart == 0 else f'DIFFER by up to {apart:.2e}'}; sentinels "
          f"{'intact' if sentinels_intact() else 'OVERWRITTEN'}", flush=True)
    if worst is not None:
        bad = (worst > 1e-3 * want.abs().max()).nonzero()
        print(f"    wrong on repeat: {len(bad)} of {worst.numel()} entries; taps "
              f"{sorted(set(bad[:, 0].tolist()))}, ci {sorted(set(bad[:, 1].tolist()))[:12]}, "
              f"co {sorted(set(bad[:, 2].tolist()))[:20]}", flush=True)
    if err > 1e-3 or apart:
        FAILED.append(label)
    return err


def inputs(dims, c, co, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    shape = (dims[0], dims[1] // 2, dims[2] // 2, dims[3] // 2)
    p_in = torch.randn(shape + (8 * c,), generator=g, device="cuda").to(torch.bfloat16)
    g_in = torch.randn(shape + (8 * co,), generator=g, device="cuda").to(torch.bfloat16)
    return p_in, g_in


_PIECES_HDR = "conv3_phase_pieces_dw.cuh"
PIECES_VARIANTS = {
    "no wgmma": [("      wgmma_rs_n32_mn(acc[i & 1], f[i], desc_b128(",
                  "      if (ks < 0) wgmma_rs_n32_mn(acc[i & 1], f[i], desc_b128(")],
    "no ldmatrix": [("      ldsm_x4_trans(gbase + hr * 128",
                     "      f[i][0] = f[i][1] = f[i][2] = f[i][3] = hr;\n"
                     "      if (hr < -1000000) ldsm_x4_trans(gbase + hr * 128")],
    "no staging": [("        mbar_expect_tx(bar(s), (uint32_t)(P + halo_rows) * 128);",
                    "        mbar_arrive(bar(s));"),
                   ("        tma_load_5d(slot, &tmp,", "        if (k < 0) tma_load_5d(slot, &tmp,"),
                   ("        tma_load_5d(slot + p_plane, &tmg,",
                    "        if (k < 0) tma_load_5d(slot + p_plane, &tmg,")],
}
# the flagship's L = 64 (96^3 x 8) at batch 8 and a rank's batch 4; --small
# the block volumes around the rule's least
PIECES_ROWS = [((8, 96, 96, 96), "flagship L = 64 B8"), ((4, 96, 96, 96), "L = 64 B4 (a rank)")]
PIECES_SMALL = [((2, 96, 96, 96), "L = 64 B2"), ((1, 96, 96, 96), "L = 64 B1"),
                ((2, 64, 64, 64), "64^3 B2"), ((1, 64, 64, 64), "64^3 B1"),
                ((2, 48, 48, 48), "48^3 B2"), ((1, 48, 48, 48), "48^3 B1"),
                ((1, 32, 32, 32), "32^3 B1")]
# (dims, (td, th, tw), splits, stages): the plan's, short rings, a few blocks
# walking many bricks, ragged block grids
PIECES_RAGGED = [((2, 4, 6, 22), None, None, None), ((1, 6, 10, 18), (2, 2, 8), 3, 2),
                 ((3, 2, 2, 2), (1, 2, 16), 2, 3), ((1, 10, 4, 6), (2, 4, 4), 1, 4),
                 ((2, 18, 30, 34), (2, 4, 16), 7, 3), ((1, 40, 24, 64), None, None, None)]


def build_pieces_variants() -> dict:
    """{name: C entry point} of the pieces body's patched copies, built in
    parallel."""
    root = ROOT / "build" / "probe" / "phase_pieces"
    procs = {}
    for name, edits in PIECES_VARIANTS.items():
        d = root / name.replace(" ", "_")
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_cuda._CSRC, d)
        text = (d / _PIECES_HDR).read_text()
        for old, new in edits:
            if old not in text:
                sys.exit(f"variant {name}: {old[:50]!r} is not in the header")
            text = text.replace(old, new)
        (d / _PIECES_HDR).write_text(text)
        cmd = [_cuda.nvcc_path(), *_cuda.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
               str(d / "phase_conv_dw_pieces.cu")]
        procs[name] = (d, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (d, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"variant {name}: nvcc failed\n{out[-2000:]}")
        fn = ctypes.CDLL(str(d / "lib.so")).segk_phase_conv3_dw_pieces
        fn.argtypes = _cuda._SIGNATURES["segk_phase_conv3_dw_pieces"]
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def pieces_run(p_in, g_in, dims, plan, fn=None):
    """A closure launching the pieces body with ``plan`` (through ``fn``, a
    variant's entry point, where given) and its output tensor."""
    b, d, h, w = dims
    ws_all = torch.full((plan.workspace + 4096,), 1234.5, dtype=torch.float32, device="cuda")
    out_all = torch.full((27 * 64 + 4096,), 1234.5, dtype=torch.float32, device="cuda")
    ws, out = ws_all[:plan.workspace], out_all[:27 * 64].view(3, 3, 3, 8, 8)
    SENTINELS.append((ws_all[plan.workspace:], out_all[27 * 64:]))
    args = (p_in.data_ptr(), g_in.data_ptr(), ws.data_ptr(), out.data_ptr(), b, d, h, w, 8, 8,
            plan.td, plan.th, plan.tw, plan.splits, plan.stages, plan.smem_bytes)

    def run(keep=(ws_all, out_all)):
        if fn is None:
            _cuda.launch("segk_phase_conv3_dw_pieces", *args)
        elif fn(*args, torch.cuda.current_stream().cuda_stream):
            sys.exit("probe: a variant failed to launch")
    return run, out


def _pieces_plan(dims, brick, splits, stages, sms):
    plan = fused_conv.phase_pieces_plan(dims, 8, 8, sms)
    if brick is None:
        return plan
    td, th, tw = brick
    b, d, h, w = dims[0], dims[1] // 2, dims[2] // 2, dims[3] // 2
    nb = b * -(-d // td) * -(-h // th) * -(-w // tw)
    splits = min(splits, nb)
    return dataclasses.replace(plan, td=td, th=th, tw=tw, splits=splits, stages=stages,
                               smem_bytes=fused_conv.phase_pieces_smem_bytes(td, th, tw, stages),
                               workspace=4 * splits * 27 * 64, nbricks=nb)


def pieces_main(card: str, sms: int) -> None:
    lib = _cuda.build()
    for line in lib.with_name(lib.stem + ".log").read_text().splitlines():
        if "C75" in line and "pieces" in line:  # ptxas' notes about its wgmma
            print(f"  {line.strip()[:300]}")
    for line, regs, stack, spill in chip_smoke._ptxas_reports(lib, "conv3_phase_pieces_kernel"):
        print(f"  ptxas conv3_phase_pieces_kernel: {regs} registers, stack {stack}, "
              f"spill bytes {spill}")
    variants = build_pieces_variants() if "--variants" in sys.argv else {}
    print("[ragged] the pieces body against the plain version:")
    for k, (dims, brick, splits, stages) in enumerate(PIECES_RAGGED):
        p_in, g_in = inputs(dims, 8, 8, 200 + k)
        want = phase_conv.phase_conv_dw_plain(p_in, g_in)
        plan = _pieces_plan(dims, brick, splits, stages, sms)
        run, out = pieces_run(p_in, g_in, dims, plan)
        check(f"{dims}: brick {plan.td}x{plan.th}x{plan.tw}, {plan.splits} splits, ring "
              f"{plan.stages}", run, out, want)
    print(f"[rows] bf16, CUDA-graph replay, L2 warm ({card}):")
    rows = PIECES_ROWS + (PIECES_SMALL if "--small" in sys.argv else [])
    for k, (dims, name) in enumerate(rows):
        p_in, g_in = inputs(dims, 8, 8, 300 + k)
        want = phase_conv.phase_conv_dw_plain(p_in, g_in)
        plan = fused_conv.phase_pieces_plan(dims, 8, 8, sms)
        run, out = pieces_run(p_in, g_in, dims, plan)
        check(f"{name}: brick {plan.td}x{plan.th}x{plan.tw}, {plan.splits} splits, ring "
              f"{plan.stages}, {plan.nbricks} bricks", run, out, want)
        ms = chip_smoke._graph_ms(torch, run)
        trun, _ = tensor_core_run(p_in, g_in, dims, 8, 8)
        tms = chip_smoke._graph_ms(torch, trun)
        hrun, _ = body_run(p_in, g_in, dims, 8, 8, fused_conv.phase_dw_plan(dims, 8, 8, sms))
        hms = chip_smoke._graph_ms(torch, hrun)
        xf, gf = depth_to_space(p_in, 8), depth_to_space(g_in, 8)
        lms = chip_smoke._graph_ms(torch, lambda: torch.nn.grad.conv3d_weight(
            xf.permute(0, 4, 1, 2, 3), (8, 8, 3, 3, 3), gf.permute(0, 4, 1, 2, 3), padding=1))
        nbytes = (p_in.numel() + g_in.numel()) * 2 + out.numel() * 4
        ops = 2 * 27 * 64 * (p_in.numel() // 8)
        bound = max(nbytes / chip_smoke.HBM_BYTES_PER_S, ops / chip_smoke.PEAK_BF16) * 1e3
        print(f"    pieces body {ms:.4f} ms, tensor-core body {tms:.4f} ms, phase Hopper "
              f"body {hms:.4f} ms, cuDNN bf16 wgrad {lms:.4f} ms, bound {bound:.4f} ms; "
              f"pieces / bound {ms / bound:.2f}, tensor-core / pieces {tms / ms:.2f}", flush=True)
        for vname, fn in variants.items():
            vrun, _ = pieces_run(p_in, g_in, dims, plan, fn)
            print(f"      variant {vname}: {chip_smoke._graph_ms(torch, vrun):.4f} ms", flush=True)
        if "--plans" in sys.argv:
            cands = sorted(fused_conv._phase_pieces_candidates(dims, sms), key=lambda kp: kp[0])
            for key, q in cands[:8]:
                if q == plan:
                    continue
                qrun, qout = pieces_run(p_in, g_in, dims, q)
                qrun()
                torch.cuda.synchronize()
                err = ((qout - want).abs().max() / want.abs().max()).item()
                qms = chip_smoke._graph_ms(torch, qrun)
                print(f"      brick {q.td}x{q.th}x{q.tw} ring {q.stages}: {qms:.4f} ms (cost "
                      f"{key[2]:.0f}, err {err:.1e})", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("probe_phase_dw: CUDA is not available")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}")
    torch.backends.cudnn.allow_tf32 = False  # the plain version in full f32
    lib = _cuda.build()
    log = lib.with_name(lib.stem + ".log").read_text().splitlines()
    for line in log:  # ptxas' notes about the body's wgmma (C75xx)
        if "C75" in line and "conv3_phase_dw" in line:
            print(f"  {line.strip()[:300]}")
    for line, regs, stack, spill in chip_smoke._ptxas_reports(lib, "conv3_phase_dw_kernel"):
        inst = line.split("conv3_phase_dw_kernel")[1].split("EEv")[0]
        print(f"  ptxas {inst}: {regs} registers, stack {stack}, spill bytes {spill}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if "--pieces" in sys.argv:
        pieces_main(card, sms)
        print(f"card: {card}")
        if FAILED:
            sys.exit(f"probe: {len(FAILED)} checks failed: {FAILED}")
        return
    variants = build_variants() if "--variants" in sys.argv else {}

    print("[ragged] the body at every instance against the plain version:")
    for k, (dims, c, co) in enumerate(RAGGED):
        p_in, g_in = inputs(dims, c, co, k)
        want = phase_conv.phase_conv_dw_plain(p_in, g_in)
        for tpw, nwg in fused_conv._PHASE_DW_SHAPES[2 * c]:
            plan = fused_conv.phase_dw_plan(dims, c, co, sms)
            groups = -(-plan.n_tiles // (tpw * nwg))
            plan = dataclasses.replace(plan, tpw=tpw, nwg=nwg, groups=groups,
                                       grid=(plan.splits, groups))
            run, out = body_run(p_in, g_in, dims, c, co, plan)
            check(f"{dims} C {c} -> {co}, TPW {tpw} NWG {nwg}, brick {plan.td}x"
                  f"{plan.th}x{plan.tw}, {plan.splits} splits", run, out, want)

    print(f"[rows] bf16, CUDA-graph replay, L2 warm ({card}):")
    for k, (dims, c, co, name) in enumerate(ROWS):
        p_in, g_in = inputs(dims, c, co, 100 + k)
        want = phase_conv.phase_conv_dw_plain(p_in, g_in)
        plan = fused_conv.phase_dw_plan(dims, c, co, sms)
        run, out = body_run(p_in, g_in, dims, c, co, plan)
        check(f"{name}: brick {plan.td}x{plan.th}x{plan.tw}, TPW {plan.tpw} x NWG {plan.nwg}, "

              f"{plan.groups} groups x {plan.splits} splits, ring {plan.stages}", run, out, want)
        ms = chip_smoke._graph_ms(torch, run)
        trun, tout = tensor_core_run(p_in, g_in, dims, c, co)
        tms = chip_smoke._graph_ms(torch, trun)
        xf, gf = depth_to_space(p_in, c), depth_to_space(g_in, co)
        lms = chip_smoke._graph_ms(torch, lambda: torch.nn.grad.conv3d_weight(
            xf.permute(0, 4, 1, 2, 3), (co, c, 3, 3, 3), gf.permute(0, 4, 1, 2, 3), padding=1))
        nbytes = (p_in.numel() + g_in.numel()) * 2 + out.numel() * 4
        ops = 2 * 27 * c * co * (p_in.numel() // c)
        bound = max(nbytes / chip_smoke.HBM_BYTES_PER_S, ops / chip_smoke.PEAK_BF16) * 1e3
        print(f"    phase body {ms:.4f} ms, tensor-core body {tms:.4f} ms, cuDNN bf16 wgrad "
              f"{lms:.4f} ms, bound {bound:.4f} ms ({'bytes' if nbytes / 3.35e12 > ops / 989e12 else 'ops'});"
              f" phase / bound {ms / bound:.2f}", flush=True)
        for vname, fn in variants.items():
            vrun, _ = body_run(p_in, g_in, dims, c, co, plan, fn)
            print(f"      variant {vname}: {chip_smoke._graph_ms(torch, vrun):.4f} ms", flush=True)
        if "--plans" in sys.argv:
            cands = sorted(fused_conv._phase_dw_candidates(dims, c, co, sms), key=lambda kp: kp[0])
            seen, picks = set(), []
            for key, q in cands:
                if len(picks) < 10 or (q.tpw, q.nwg) not in seen:
                    picks.append((key, q))
                    seen.add((q.tpw, q.nwg))
            for key, q in picks:
                if q == plan:
                    continue
                qrun, qout = body_run(p_in, g_in, dims, c, co, q)
                qrun()
                torch.cuda.synchronize()
                err = ((qout - want).abs().max() / want.abs().max()).item()
                qms = chip_smoke._graph_ms(torch, qrun)
                print(f"      brick {q.td}x{q.th}x{q.tw} TPW {q.tpw} NWG {q.nwg} splits "
                      f"{q.splits} ring {q.stages}: {qms:.4f} ms (cost {key[1]:.0f}, "
                      f"err {err:.1e})", flush=True)
    print(f"card: {card}")
    if FAILED:
        sys.exit(f"probe: {len(FAILED)} checks failed: {FAILED}")


if __name__ == "__main__":
    main()
