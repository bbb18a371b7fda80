"""Probe of the phase forward's Hopper body (``csrc/conv3_phase.cuh``) on the card.

``python3 probe_phase_fwd.py [--small] [--variants] [--rows i,j]``
(CUDA only; ``--rows`` times only those rows of ``ROWS``) builds the
kernel library (``segmantic_tpu_torch.ops._cuda``), prints ptxas' registers
and spills of every instantiation of the body, then:

1. holds the body against ``phase_conv_plain`` on the f32 upcasts of the
   same bf16 values (cuDNN's TF32 off; limit 1e-2 * max|ref| for bf16 out,
   1e-4 for f32 out) at ragged shapes of every instance (Ci = Co = 8, 16;
   every relu mode, bf16 and f32 out, rings as short as a slot a warpgroup,
   a few blocks walking many bricks), each launched through its C entry
   point and repeated bit for bit, with sentinels past the output;
2. at the flagship's L = 64 / L = 128 rows (batch 4 and 8) and packed
   UNETR's p 48^3 x 128 (batch 8), forward and input gradient (flipped,
   swapped weights), the same check, then the body's time beside the
   tensor-core body (``conv3_mma.cuh``, through its own entry point and
   plan), cuDNN's bf16 ``conv3d`` on the full-resolution view (the
   rearrangement not timed) and the row's bound: CUDA-graph replay
   (``chip_smoke._graph_ms``), L2 warm;
3. with ``--small``: the same beside the tensor-core body at smaller
   volumes (where the rule's least volume lies);
4. with ``--variants``: where the body's time goes at each row. Patched
   copies of ``csrc/`` under ``build/probe/phase_fwd/`` (the library's own
   sources untouched), each ``phase_conv.cu`` alone built into its own
   library, are timed beside the body as it is: without its wgmma, without
   its staging (the producer arrives without copying), without its epilogue's
   stores, without its epilogue, with the wgmma alone (neither staging nor
   stores; nor epilogue), with the staging alone, and the skeleton (the
   ring's barriers and the loop, none of the three).

``python3 probe_phase_fwd.py --serve [--root DIR]`` times one served
volume of the flagship instead (:func:`serve`), with the package of the tree
at DIR (a parent commit unpacked beside this one: an A/B in one call).

Every time is printed beside ``nvidia-smi --query-gpu=name,power.limit``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import shutil
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

if "--root" in sys.argv:  # the package and chip_smoke.py of another tree (--serve's A/B)
    sys.path.insert(0, str(Path(sys.argv[sys.argv.index("--root") + 1]).resolve()))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke  # noqa: E402
from segmantic_tpu_torch.ops import _cuda, fused_conv, phase_conv  # noqa: E402
from segmantic_tpu_torch.ops.fast_conv import depth_to_space  # noqa: E402

ROWS = [((4, 96, 96, 96), 8, "flagship L = 64 B4 (serving)"),
        ((8, 96, 96, 96), 8, "flagship L = 64 B8 (training)"),
        ((4, 48, 48, 48), 16, "flagship L = 128 B4 (serving)"),
        ((8, 48, 48, 48), 16, "flagship L = 128 B8 (training)"),
        ((8, 96, 96, 96), 16, "UNETR p 48^3 x 128 B8")]
SMALL = [((1, 96, 96, 96), 8, "L = 64 B1"), ((2, 48, 48, 48), 8, "L = 64 at 24^3 B2"),
         ((1, 48, 48, 48), 16, "L = 128 B1"), ((2, 32, 32, 32), 16, "L = 128 at 16^3 B2"),
         ((1, 32, 32, 32), 8, "L = 64 at 16^3 B1")]
# (dims, C, stages, grid_x, relu, out dtype): rings of a slot a warpgroup
# and deeper, a few blocks walking many bricks (and a warpgroup with none),
# grids whose H and W are no multiple of 8
RAGGED = [((1, 10, 14, 22), 8, 3, 2, "prelu", torch.bfloat16),
          ((2, 6, 10, 34), 8, 2, 3, "relu", torch.float32),
          ((1, 18, 6, 18), 8, 3, 5, "none", torch.bfloat16),
          ((1, 2, 2, 2), 8, 2, 1, "prelu", torch.float32),
          ((3, 6, 6, 10), 16, 3, 2, "prelu", torch.bfloat16),
          ((2, 18, 4, 34), 16, 2, 3, "relu", torch.float32),
          ((1, 10, 20, 16), 16, 3, 1, "none", torch.bfloat16),
          ((2, 16, 32, 48), 16, 2, 7, "none", torch.bfloat16)]

ROOT = Path(__file__).resolve().parent
_NO_MMA = [("      wgmma_ss_n64(acc, da0 + (off >> 4), db);",
            "      acc[0] += (float)(da0 & 1) + (float)(db & 1);")]
_NO_STAGE = [("        mbar_expect_tx(bar(s), tx);", "        mbar_arrive(bar(s));"),
             ("        if (CI == 8) {\n          tma_load_5d", "        if (false) {\n          tma_load_5d"),
             ("        } else {  // tm0: boxes", "        } else if (false) {  // tm0: boxes")]
_NO_STORE = [("        if (a.out_bf16) {", "        if (v0 == 1234.5f) {"),
             ("        } else {\n          *reinterpret_cast<float2*>",
              "        } else if (v1 == 1234.5f) {\n          *reinterpret_cast<float2*>")]
_NO_EPILOGUE = [("      if (gy >= a.H2 || gx >= a.W2) continue;",
                 "      if (gy >= a.H2 || gx >= a.W2 || a.relu_mode != 77) continue;")]
VARIANTS = {"no wgmma": _NO_MMA, "no staging": _NO_STAGE, "no stores": _NO_STORE,
            "no epilogue": _NO_EPILOGUE,
            "wgmma alone": _NO_STAGE + _NO_EPILOGUE,
            "staging alone": _NO_MMA + _NO_EPILOGUE,
            "skeleton": _NO_MMA + _NO_STAGE + _NO_EPILOGUE}


def build_variants() -> dict:
    """{name: C entry point} of the patched copies, built in parallel."""
    root = ROOT / "build" / "probe" / "phase_fwd"
    procs = {}
    for name, edits in VARIANTS.items():
        d = root / name.replace(" ", "_")
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_cuda._CSRC, d)
        header = d / "conv3_phase.cuh"
        text = header.read_text()
        for old, new in edits:
            if old not in text:
                sys.exit(f"variant {name}: {old[:50]!r} is not in the header")
            text = text.replace(old, new)
        header.write_text(text)
        cmd = [_cuda.nvcc_path(), *_cuda.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
               str(d / "phase_conv.cu")]
        procs[name] = (d, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (d, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"variant {name}: nvcc failed\n{out[-2000:]}")
        fn = ctypes.CDLL(str(d / "lib.so")).segk_phase_conv3_lanes
        fn.argtypes = _cuda._SIGNATURES["segk_phase_conv3_lanes"]
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


FAILED = []
SENTINELS = []


def plan_of(dims, c, stages, grid_x):
    """The wrapper's plan with another ring depth and grid."""
    p = fused_conv.phase_fwd_plan(dims, c, c)
    g = min(grid_x, p.nbricks)
    return dataclasses.replace(p, stages=stages, grid_x=g, grid=(g, p.groups),
                               smem_bytes=fused_conv.phase_fwd_smem_bytes(c, stages))


def body_run(p_in, w, dims, plan, kw, out_dtype, fn=None):
    """A closure launching the body with ``plan`` (through ``fn``, a
    variant's entry point, where given) and its output tensor."""
    c = w.shape[-2]
    n = p_in.numel()  # Co = Ci: the output has p's shape
    out_all = torch.full((n + 4096,), 1232.0, dtype=out_dtype, device="cuda")
    out = out_all[:n].view(p_in.shape)
    SENTINELS.append(out_all[n:])
    s, t = fused_conv._epilogue_vectors(c, kw.get("bias"), kw.get("scale"), kw.get("shift"),
                                        p_in.device)
    alpha = kw.get("alpha")
    a = None if alpha is None else alpha.float().reshape(1).contiguous()
    packed = fused_conv.pack_weights_phase(w)
    b, d, h, w_ = dims
    args = (p_in.data_ptr(), packed.data_ptr(), s.data_ptr(), t.data_ptr(),
            None if a is None else a.data_ptr(),
            fused_conv.RELU_MODES[kw.get("relu_mode", "none")], out.data_ptr(), b, d, h, w_, c, c,
            int(out_dtype == torch.bfloat16), plan.grid_x, plan.stages, plan.smem_bytes)

    def run(keep=(out_all, packed, s, t, a)):  # the closure holds what the kernel reads
        if fn is None:
            _cuda.launch("segk_phase_conv3_lanes", *args)
        elif fn(*args, torch.cuda.current_stream().cuda_stream):
            sys.exit("probe: a variant failed to launch")
    return run, out


def sentinels_intact() -> bool:
    torch.cuda.synchronize()
    return all(bool((t == 1232.0).all()) for t in SENTINELS)


def check(label, run, out, want, repeats: int = 3) -> float:
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
    limit = 1e-2 if out.dtype == torch.bfloat16 else 1e-4
    print(f"  {label}: max|d| / max|ref| {err:.2e} (limit {limit:.0e}), {repeats} repeats "
          f"{'bit-equal' if same else 'DIFFER'}; sentinels "
          f"{'intact' if sentinels_intact() else 'OVERWRITTEN'}", flush=True)
    if err > limit:
        bad = (d > limit * want.abs().max()).nonzero()
        print(f"    wrong: {len(bad)} of {d.numel()}; voxels (first) {bad[:6, :4].tolist()}, "
              f"lanes {sorted(set(bad[:, 4].tolist()))[:32]}", flush=True)
    if err > limit or not same or not sentinels_intact():
        FAILED.append(label)
    return err


def row(dims, c, name, sms, variants: dict) -> None:
    g = torch.Generator(device="cuda").manual_seed(dims[0] * 100 + c)
    shape = (dims[0], dims[1] // 2, dims[2] // 2, dims[3] // 2, 8 * c)
    p_in = torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
    w0 = (torch.randn((3, 3, 3, c, c), generator=g, device="cuda") * (27 * c) ** -0.5)
    plan = fused_conv.phase_fwd_plan(dims, c, c, sms)
    for what, w in (("fwd", w0.to(torch.bfloat16)), ("dx", fused_conv.flip_io(w0).to(torch.bfloat16))):
        want = phase_conv.phase_conv_plain(p_in.float(), w.float())
        run, out = body_run(p_in, w, dims, plan, {}, torch.bfloat16)
        check(f"{name} {what}: {plan.grid_x} x {plan.groups} blocks, ring {plan.stages}, "
              f"{plan.nbricks} bricks", run, out, want)
        ms = chip_smoke._graph_ms(torch, run)
        tms = chip_smoke.tensor_core_conv_ms(torch, p_in, w, phase=True)
        xf = depth_to_space(p_in, c).permute(0, 4, 1, 2, 3)
        wc = w.permute(4, 3, 0, 1, 2).contiguous(memory_format=torch.channels_last_3d)
        lms = chip_smoke._graph_ms(torch, lambda: F.conv3d(xf, wc, padding=1))
        nbytes = 2 * p_in.numel() * 2 + w.numel() * 2
        ops = 2 * 27 * c * c * (p_in.numel() // c)
        bound = max(nbytes / chip_smoke.HBM_BYTES_PER_S, ops / chip_smoke.PEAK_BF16) * 1e3
        print(f"    Hopper body {ms:.4f} ms, tensor-core body {tms:.4f} ms, cuDNN bf16 conv3d "
              f"{lms:.4f} ms, bound {bound:.4f} ms "
              f"({'bytes' if nbytes / 3.35e12 > ops / 989e12 else 'ops'}); "
              f"body / bound {ms / bound:.2f}, tensor-core / body {tms / ms:.2f}", flush=True)
        for vname, fn in (variants.items() if what == "fwd" else ()):
            vrun, _ = body_run(p_in, w, dims, plan, {}, torch.bfloat16, fn)
            print(f"      variant {vname}: {chip_smoke._graph_ms(torch, vrun):.4f} ms", flush=True)


def serve(card: str) -> None:
    """One served 256 x 256 x 176 volume of the flagship (random weights,
    ``chip_smoke.make_checkpoint``; sw-batch 4, 12 chunks): the sliding
    window's seconds on the host clock to a synchronise
    (``chip_smoke.device_seconds_per_volume``, three medians of 5) and its
    kernels' device ms under ``torch.profiler`` (three volumes), with the
    phase convs' share, of the tree ``--root`` names (default: this one)."""
    import numpy as np

    from segmantic_tpu_torch.infer.sliding_window import sliding_window_inference
    from segmantic_tpu_torch.serve import InferenceSession

    with tempfile.TemporaryDirectory() as td:
        ckpt = Path(td) / "flagship.ckpt"
        chip_smoke.make_checkpoint(torch, ckpt)
        session = InferenceSession(ckpt, device="cuda")
        secs = [chip_smoke.device_seconds_per_volume(torch, session, 4) for _ in range(3)]
        vol = chip_smoke.phantom((256, 256, 176), 5)
        vol = ((vol - vol.mean()) / vol.std())[..., None].astype(np.float32)

        def window():
            sliding_window_inference(vol, chip_smoke.ROI, 4, session.val_forward, overlap=0.25,
                                     num_classes=chip_smoke.NUM_CLASSES, device="cuda",
                                     wire_dtype=torch.bfloat16)

        window()
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                window()
            torch.cuda.synchronize()
        total = phase = 0.0
        for e in prof.key_averages():
            if str(getattr(e, "device_type", "")).endswith("CUDA"):
                total += e.self_device_time_total / 3e3
                if "conv3_phase_fwd" in e.key or ("conv3_mma" in e.key and "Phase" in e.key):
                    phase += e.self_device_time_total / 3e3
    print(f"[serve] {chip_smoke.ROOT.name}: sliding window of one volume "
          f"{[round(x, 4) for x in secs]} s (host clock, medians of 5), kernels "
          f"{total:.3f} ms of device time a volume, of which the phase stages' convs "
          f"{phase:.3f} ms ({card})", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("probe_phase_fwd: CUDA is not available")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}")
    torch.backends.cudnn.allow_tf32 = False  # the plain version in full f32
    if "--serve" in sys.argv:
        serve(card)
        return
    lib = _cuda.build()
    log = lib.with_name(lib.stem + ".log").read_text().splitlines()
    for line in log:  # ptxas' notes about the body's wgmma (C75xx)
        if "C75" in line or "erializ" in line:
            print(f"  {line.strip()[:300]}")
    for line, regs, stack, spill in chip_smoke._ptxas_reports(lib, "conv3_phase_fwd_kernel"):
        inst = line.split("conv3_phase_fwd_kernel")[1].split("EEv")[0]
        print(f"  ptxas {inst}: {regs} registers, stack {stack}, spill bytes {spill}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    variants = build_variants() if "--variants" in sys.argv else {}

    print("[ragged] the body at every instance against the plain version:")
    for k, (dims, c, stages, grid_x, relu, out_dtype) in enumerate(RAGGED):
        g = torch.Generator(device="cuda").manual_seed(k)
        pshape = (dims[0], dims[1] // 2, dims[2] // 2, dims[3] // 2, 8 * c)
        p_in = torch.randn(pshape, generator=g, device="cuda").to(torch.bfloat16)
        w = (torch.randn((3, 3, 3, c, c), generator=g, device="cuda") * 0.2).to(torch.bfloat16)
        kw = dict(bias=torch.randn(c, generator=g, device="cuda") * 0.1,
                  scale=torch.randn(c, generator=g, device="cuda").abs() + 0.5,
                  shift=torch.randn(c, generator=g, device="cuda") * 0.1,
                  alpha=torch.tensor([0.25], device="cuda"), relu_mode=relu)
        want = phase_conv.phase_conv_plain(p_in.float(), w.float(), **kw)
        plan = plan_of(dims, c, stages, grid_x)
        run, out = body_run(p_in, w, dims, plan, kw, out_dtype)
        check(f"{dims} C {c}, ring {stages}, {plan.grid_x} blocks, {relu}, out "
              f"{str(out_dtype)[6:]}", run, out, want)

    print(f"[rows] bf16, CUDA-graph replay, L2 warm ({card}):")
    rows = ROWS + (SMALL if "--small" in sys.argv else [])
    if "--rows" in sys.argv:  # --rows i,j: only those of ROWS
        rows = [ROWS[int(k)] for k in sys.argv[sys.argv.index("--rows") + 1].split(",")]
    for dims, c, name in rows:
        row(dims, c, name, sms, variants)
    print(f"card: {card}")
    if FAILED:
        sys.exit(f"probe: {len(FAILED)} checks failed: {FAILED}")


if __name__ == "__main__":
    main()
