"""Probe of the wgmma forms of the mid-channel conv bodies on the card.

Builds ``segmantic_tpu_torch/csrc/probe/mid_wgmma_probe.cu`` with ``nvcc``
into ``build/probe/`` and runs it (CUDA only; ``python3 probe_mid_wgmma.py``):

1. which reading of a no-swizzle descriptor's LBO and SBO fields the card
   takes, for A and B K-major (``wgmma`` with both operands in shared
   memory, A rows a halo row pitch apart, the k halves a plane apart, and
   the k halves 16 bytes apart as the C = 8 tap pairs are) and for B
   MN-major under an A from registers (the dw's form): each D against the
   products of both readings;
2. the rate of the forward's inner loop, 27 tap windows of one slab a
   warpgroup, two warpgroups a block on every multiprocessor: A by
   descriptor straight from the staged halo (ss) against A by ldmatrix
   into registers (rs; its fragments are not double-buffered, so it is an
   upper bound on that route), N = 8, 16, 32, 64, one accumulator chain a
   warpgroup (27 dependent wgmma) or four interleaved, one to four warpgroups a
   multiprocessor, halo rows 8, 9 or 10 16-byte units apart (8: the core
   matrices contiguous), in TFLOP/s (989 the bf16 peak) and cycles a wgmma
   a multiprocessor at an assumed 1.755 GHz;
3. with ``--variants``: where the mid-channel bodies' time goes. Patched
   copies of ``csrc/`` under ``build/probe/variants/`` (the library's own
   sources untouched) are built and timed beside the bodies as they are:
   the forward without its wgmma, without its epilogue's stores, without
   its staging (and without both stores and staging), at packed UNETR's p
   48^3 x 128 and p 24^3 x 256 and SegResNet's 96^3 x 8 (batch 8); the dw at
   24^3 x 64 with its k16 loop left rolled (``#pragma unroll 1``: ptxas then
   serializes the wgmma) and with bricks 16 wide instead of its plan's 8.
   CUDA-graph replay (``chip_smoke._graph_ms``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import itertools
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "segmantic_tpu_torch" / "csrc" / "probe" / "mid_wgmma_probe.cu"
LIB = ROOT / "build" / "probe" / "libmid_wgmma_probe.so"


def build() -> ctypes.CDLL:
    from segmantic_tpu_torch.ops import _cuda

    LIB.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_cuda.nvcc_path(), *_cuda.NVCC_FLAGS, "-shared", "-o", str(LIB), str(SRC)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    print(res.stdout[-3000:], res.stderr[-3000:])
    if res.returncode:
        sys.exit("probe: nvcc failed")
    lib = ctypes.CDLL(str(LIB))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.probe_one.argtypes = [I, I, P, I, P] + [I] * 6 + [P]
    lib.probe_rate.argtypes = [I, I, I, I, I, I, I, P, P]
    lib.probe_tma.argtypes = [P] + [I] * 12 + [P, P]
    lib.probe_swz.argtypes = [P, I, I, P] + [I] * 6 + [P]
    lib.probe_swz_rate.argtypes = [I, I, I, I, P, P]
    return lib


def k_major(img, start, lbo, sbo, rows):
    """rows x 16 operand: row m, k at unit start + (m // 8) sbo + (k // 8) lbo + m % 8
    (units past the image read as NaN: no match)."""
    m, k = np.arange(rows)[:, None], np.arange(16)[None, :]
    unit = start + m // 8 * sbo + k // 8 * lbo + m % 8
    return np.where(unit < len(img), img[np.minimum(unit, len(img) - 1), k % 8], np.nan)


def mn_major(img, start, lbo, sbo, cols):
    """16 x cols operand: k, n at unit start + (n // 8) sbo + (k // 8) lbo + k % 8."""
    k, n = np.arange(16)[:, None], np.arange(cols)[None, :]
    unit = start + n // 8 * sbo + k // 8 * lbo + k % 8
    return np.where(unit < len(img), img[np.minimum(unit, len(img) - 1), n % 8], np.nan)


def descriptors(lib) -> bool:
    rng = np.random.default_rng(0)
    ok = True
    n = 16
    units = 2048
    img = rng.integers(-4, 5, size=(units, 8)).astype(np.float32)  # exact in bf16 and f32
    dev_img = torch.tensor(img, dtype=torch.bfloat16, device="cuda")
    out = torch.zeros(64 * n, device="cuda")
    frag = torch.tensor(rng.integers(-4, 5, size=(64, 16)), dtype=torch.float32, device="cuda")
    cases = [("ss, A rows 10 units apart, k halves a plane (400) apart", 1, (0, 400, 10),
              (1200, n, 8)),
             ("ss, A k halves 1 unit apart (the C = 8 tap pair)", 1, (37, 1, 10), (1200, n, 8)),
             ("rs, B MN-major: k halves 8 units apart, n-groups a plane (300) apart", 0, None,
              (100, 8, 300))]
    for label, ss, a, b in cases:
        args = (a or (0, 0, 0)) + b
        err = lib.probe_one(n, ss, dev_img.data_ptr(), units, frag.data_ptr(), *args,
                            out.data_ptr())
        torch.cuda.synchronize()
        if err:
            sys.exit(f"probe_one: CUDA error {err}")
        d = out.reshape(64, n).cpu().numpy()
        readings = {}
        for name, swap in (("LBO = the k direction", False), ("LBO = the m / n direction", True)):
            if ss:
                al, asb = (a[2], a[1]) if swap else (a[1], a[2])
                bl, bsb = (b[2], b[1]) if swap else (b[1], b[2])
                want = k_major(img, a[0], al, asb, 64) @ k_major(img, b[0], bl, bsb, n).T
            else:
                bl, bsb = (b[2], b[1]) if swap else (b[1], b[2])
                want = frag.cpu().numpy() @ mn_major(img, b[0], bl, bsb, n)
            readings[name] = bool(np.array_equal(d, want))
        print(f"  {label}: " + ", ".join(f"{k}: {'matches' if v else 'no'}"
                                         for k, v in readings.items()))
        ok &= readings["LBO = the k direction"]
    return ok


def rates(lib) -> None:
    blocks = torch.cuda.get_device_properties(0).multi_processor_count
    sink = torch.zeros(512, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    iters = 2000
    for n, ilp in itertools.product((8, 16, 32, 64), (1, 4)):
        for nwg in (1, 2, 4):
            row = []
            for ss, wpu in ((1, 8), (1, 9), (1, 10), (0, 10)):
                lib.probe_rate(n, ss, ilp, blocks, nwg, 10, wpu, sink.data_ptr(), stream)
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                err = lib.probe_rate(n, ss, ilp, blocks, nwg, iters, wpu, sink.data_ptr(), stream)
                end.record()
                torch.cuda.synchronize()
                if err:
                    sys.exit(f"probe_rate: CUDA error {err}")
                ms = start.elapsed_time(end)
                count = blocks * nwg * iters * 27 * ilp
                tflops = count * 2 * 64 * n * 16 / ms / 1e9
                cyc = ms * 1e-3 * CLOCK_HZ / (count / blocks)
                row.append(f"{'ss' if ss else 'rs'} pitch {wpu}: {tflops:.0f} TFLOP/s "
                           f"({cyc:.1f} cycles)")
            print(f"  N = {n}, {ilp} chain(s) a warpgroup, {nwg} warpgroup(s): " + "; ".join(row))


# the clock the printed "cycles a wgmma a multiprocessor" assume (not read from
# the card: nvidia-smi's clocks.sm under this load would say)
CLOCK_HZ = 1.755e9


def tma_rates(lib) -> None:
    """Staging rate of TMA boxes by inner width: bytes a cycle a
    multiprocessor, one thread keeping four boxes in flight."""
    blocks = torch.cuda.get_device_properties(0).multi_processor_count
    sink = torch.zeros(1, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    cases = [  # (label, (B, D, H, W, lanes), inner lanes, box (bw, bh, bd), lane step)
        ("8 lanes (16 B) of C = 8, dense 96^3: a position a row", (8, 96, 96, 96, 8), 8,
         (34, 18, 3), 0),
        ("8 lanes (16 B) of C = 16, dense: half of each position", (8, 96, 96, 96, 16), 8,
         (18, 18, 4), 8),
        ("8 lanes (16 B) of 8 x 16, phase 48^3: one phase's half", (8, 48, 48, 48, 128), 8,
         (9, 9, 2), 8),
        ("16 lanes (32 B) of 8 x 16, phase 48^3: one phase", (8, 48, 48, 48, 128), 16,
         (9, 9, 2), 16),
        ("32 lanes (64 B) of 8 x 32, phase 48^3: one phase", (8, 48, 48, 48, 256), 32,
         (9, 9, 2), 32),
        ("64 lanes (128 B) of C = 64, dense 24^3", (8, 24, 24, 24, 64), 64, (10, 10, 4), 0),
        ("C = 8 with W merged into the lanes: 8 x 34 lanes (544 B) a row",
         (8, 96, 96, 96 * 8 // 8, 8), 8 * 34, (1, 18, 3), 0),
    ]
    iters = 20000
    for label, shape, inner, (bw, bh, bd), step in cases:
        if "merged" in label or "W merged" in label:
            b, d, h, w, lanes = shape
            t = torch.zeros((b, d, h, w * lanes), dtype=torch.bfloat16, device="cuda")
            dims = (b, d, h, 1, w * lanes)
        else:
            t = torch.zeros(shape, dtype=torch.bfloat16, device="cuda")
            dims = shape
        args = (t.data_ptr(), *dims, inner, bw, bh, bd, blocks)
        err = lib.probe_tma(*args, 100, step, sink.data_ptr(), stream)
        torch.cuda.synchronize()
        if err:
            print(f"  {label}: error {err}")
            continue
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        lib.probe_tma(*args, iters, step, sink.data_ptr(), stream)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end)
        box = inner * 2 * bw * bh * bd
        per_cycle = box * iters / (ms * 1e-3 * CLOCK_HZ)
        rows = bw * bh * bd
        print(f"  {label}: box {box} B ({rows} rows), {per_cycle:.1f} B a cycle a "
              f"multiprocessor, {ms * 1e-3 * CLOCK_HZ / (iters * rows):.2f} cycles a row, "
              f"{blocks * box * iters / ms / 1e9:.2f} TB/s in all")


def swizzled_starts(lib) -> None:
    """A's start moved by whole rows inside a TMA-swizzled box: which base
    offset the descriptor needs for D to match."""
    rng = np.random.default_rng(1)
    n, rows = 16, 64 + 24
    for rowb in (32, 64, 128):
        data = rng.integers(-4, 5, size=(rows, rowb // 2)).astype(np.float32)
        dev = torch.tensor(data, dtype=torch.bfloat16, device="cuda")
        bimg = rng.integers(-4, 5, size=(64, 8)).astype(np.float32)  # B: n 16 x k 16, K-major
        dimg = torch.tensor(bimg, dtype=torch.bfloat16, device="cuda")
        b_op = k_major(bimg, 0, n, 8, n)
        out = torch.zeros(64 * n, device="cuda")
        res = []
        for r0, kb in ((0, 0), (1, 0), (3, 0), (8, 0), (5, 32 if rowb > 32 else 0)):
            want = data[r0:r0 + 64, kb // 2:kb // 2 + 16] @ b_op.T
            found = []
            for base in sorted({0, (r0 * rowb + kb) >> 7 & 7}):
                err = lib.probe_swz(dev.data_ptr(), rowb, rows, dimg.data_ptr(), 64, r0, kb,
                                    8 * rowb, base, n, out.data_ptr())
                torch.cuda.synchronize()
                if err:
                    sys.exit(f"probe_swz: error {err}")
                if np.array_equal(out.reshape(64, n).cpu().numpy(), want):
                    found.append(base)
            res.append(f"start row {r0} + {kb} B: base offset {found or 'none'} matches")
        print(f"  {rowb}-byte swizzle, rows of {rowb} B: " + "; ".join(res))


def swizzled_rates(lib) -> None:
    """m64n64k16 with both operands 128-byte swizzled in shared memory, each
    K-major or MN-major, two warpgroups a multiprocessor: TFLOP/s and cycles
    a wgmma a multiprocessor."""
    blocks = torch.cuda.get_device_properties(0).multi_processor_count
    sink = torch.zeros(512, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    iters = 2000
    row = []
    for ta, tb in ((0, 0), (0, 1), (1, 0), (1, 1)):
        lib.probe_swz_rate(ta, tb, blocks, 10, sink.data_ptr(), stream)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        err = lib.probe_swz_rate(ta, tb, blocks, iters, sink.data_ptr(), stream)
        end.record()
        torch.cuda.synchronize()
        if err:
            sys.exit(f"probe_swz_rate: CUDA error {err}")
        ms = start.elapsed_time(end)
        count = blocks * 2 * iters * 27
        tflops = count * 2 * 64 * 64 * 16 / ms / 1e9
        cyc = ms * 1e-3 * CLOCK_HZ / (count / blocks)
        row.append(f"A {'MN' if ta else 'K'}-major, B {'MN' if tb else 'K'}-major: "
                   f"{tflops:.0f} TFLOP/s ({cyc:.1f} cycles)")
    print("  " + "; ".join(row))


_NO_MMA = [("wgmma_ss<NT>(acc[i],", "wgmma_skip<NT>(acc[i],"),
           ("template <int NT>\n__device__ __forceinline__ void wgmma_ss(",
            "template <int NT>\n__device__ __forceinline__ void wgmma_skip(float (&d)[NT / 2], "
            "uint64_t da, uint64_t db) { d[0] += (float)(da & 1); }\n"
            "template <int NT>\n__device__ __forceinline__ void wgmma_ss(")]
_NO_STORE = [("          const long long pos = (((long long)b * a.D + gz)",
              "          if (a.relu_mode >= 0) continue;\n"
              "          const long long pos = (((long long)b * a.D + gz)")]
_NO_STAGE = [("  while (p < npts) {", "  while (p < 0) {")]
VARIANTS = {  # name -> (header, [(text, replacement)])
    "as is": ("conv3_mid.cuh", []),
    "no wgmma": ("conv3_mid.cuh", _NO_MMA),
    "no stores": ("conv3_mid.cuh", _NO_STORE),
    "no staging": ("conv3_mid.cuh", _NO_STAGE),
    "staging alone": ("conv3_mid.cuh", _NO_MMA + _NO_STORE),
    "wgmma alone": ("conv3_mid.cuh", _NO_STAGE + _NO_STORE),
    "dw k16 loop rolled": ("conv3_mid_dw.cuh", [
        ("#pragma unroll\n      for (int ks = 0; ks < KS; ++ks) {",
         "#pragma unroll 1\n      for (int ks = 0; ks < KS; ++ks) {")]),
}


def build_variants() -> dict:
    """{name: library} of the patched copies, built in parallel."""
    from segmantic_tpu_torch.ops import _cuda

    root = ROOT / "build" / "probe" / "variants"
    flags = [f for f in _cuda.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    jobs = {}
    for name, (header, subs) in VARIANTS.items():
        d = root / name.replace(" ", "_")
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(SRC.parents[1], d)
        text = (d / header).read_text()
        for old, new in subs:
            if old not in text:
                sys.exit(f"variant {name}: {old[:40]!r} is not in {header}")
            text = text.replace(old, new)
        (d / header).write_text(text)
        srcs = ["fused_conv.cu", "phase_conv.cu"] if header == "conv3_mid.cuh" else \
            ["fused_conv_dw.cu"]
        jobs[name] = (d, subprocess.Popen(
            [_cuda.nvcc_path(), *flags, "-shared", "-o", str(d / "lib.so"),
             *(str(d / f) for f in srcs)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (d, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"variant {name}: nvcc failed\n{out[-2000:]}")
        lib = ctypes.CDLL(str(d / "lib.so"))
        names = (("segk_fused_conv3_mid", "segk_phase_conv3_mid")
                 if VARIANTS[name][0] == "conv3_mid.cuh" else ("segk_fused_conv3_dw_mid",))
        for fn in names:
            getattr(lib, fn).argtypes = _cuda._SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def variants() -> None:
    import chip_smoke
    from segmantic_tpu_torch.ops import _cuda, fused_conv

    libs = build_variants()
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    for label, shape, c, co, phase in (("p 48^3 x 128 (96^3 x 16)", (8, 48, 48, 48, 128), 16,
                                        16, True),
                                       ("96^3 x 8", (8, 96, 96, 96, 8), 8, 8, False),
                                       ("p 24^3 x 256 (48^3 x 32)", (8, 24, 24, 24, 256), 32, 32,
                                        True)):
        x = torch.randn(shape, device=dev).to(bf16)
        w = (0.1 * torch.randn(3, 3, 3, c, co, device=dev)).to(bf16)
        full = (shape[0],) + tuple((2 if phase else 1) * v for v in shape[1:4])
        p = fused_conv.mid_plan(full, c, co, phase, sms)
        packed = fused_conv.pack_weights_mid(w, p.nt, p.ck)
        s, t = fused_conv._epilogue_vectors(co, None, None, None, dev)
        out = torch.empty(shape[:4] + ((8 if phase else 1) * co,), dtype=bf16, device=dev)
        entry = "segk_phase_conv3_mid" if phase else "segk_fused_conv3_mid"
        row = []
        for name, lib in libs.items():
            if VARIANTS[name][0] != "conv3_mid.cuh":
                continue
            fn = getattr(lib, entry)

            def run():
                err = fn(x.data_ptr(), packed.data_ptr(), s.data_ptr(), t.data_ptr(), None, 0,
                         out.data_ptr(), *full, c, co, 1, p.td, p.th, p.tw, p.ck, p.nt, p.spw,
                         p.nwg, p.grid_x, p.stages, p.smem_bytes, stream())
                if err:
                    sys.exit(f"{name}: CUDA error {err}")

            row.append(f"{name} {chip_smoke._graph_ms(torch, run, n=5, launches=5):.4f}")
        print(f"  forward {label}: " + ", ".join(row) + " ms")
    dims, c, co = (8, 24, 24, 24), 64, 64
    x = torch.randn(dims + (c,), device=dev).to(bf16)
    dy = torch.randn(dims + (co,), device=dev).to(bf16)
    plan = fused_conv.mid_dw_plan(dims, c, co, sms)
    wide = dataclasses.replace(plan, td=3, th=4, tw=16, nbricks=8 * 8 * 6 * 2)
    row = []
    for name, p in (("as is", plan), ("dw k16 loop rolled", plan), ("bricks 16 wide", wide)):
        ws = torch.empty(max(p.splits * 27 * c * co, 1), dtype=torch.float32, device=dev)
        dw = torch.empty((3, 3, 3, c, co), dtype=torch.float32, device=dev)
        args = (x.data_ptr(), dy.data_ptr(), ws.data_ptr(), dw.data_ptr(), *dims, c, co, p.td,
                p.th, p.tw, p.tpw, p.nwg, p.splits, p.stages,
                fused_conv.mid_dw_smem_bytes(p.td, p.th, p.tw, p.stages))

        def run_dw():
            if name == "dw k16 loop rolled":
                err = libs[name].segk_fused_conv3_dw_mid(*args, stream())
                if err:
                    sys.exit(f"{name}: CUDA error {err}")
            else:
                _cuda.launch("segk_fused_conv3_dw_mid", *args)

        row.append(f"{name} {chip_smoke._graph_ms(torch, run_dw, n=5, launches=5):.4f}")
    print(f"  dw 24^3 x 64 (plan {plan.td}x{plan.th}x{plan.tw}): " + ", ".join(row) + " ms")



def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("probe_mid_wgmma: needs a CUDA card")
    print(torch.cuda.get_device_name(0))
    lib = build()
    print("[descriptors] no-swizzle LBO / SBO readings (D against each reading's product):")
    if not descriptors(lib):
        sys.exit("probe: the bodies' reading of LBO (the k direction) does not hold")
    print("[swizzled] A's start moved inside a TMA-swizzled box:")
    swizzled_starts(lib)
    print("[swizzled-rate] m64n64k16, 128-byte swizzled operands, by major:")
    swizzled_rates(lib)
    print("[tma] staging rate by box width:")
    tma_rates(lib)
    if "--rates" in sys.argv:
        print("[rate] the forward's tap loop, 27 windows a slab:")
        rates(lib)
    if "--variants" in sys.argv:
        print("[variants] the mid-channel bodies with parts of their work cut out:")
        variants()


if __name__ == "__main__":
    main()
