"""Chip smoke test of the PyTorch port: build the CUDA kernels, check each
against its plain PyTorch version on the card, serve three volumes through
the port's HTTP server with the flagship UNet, check the folded forward on
the card against the plain CPU forward, then train: the weight-gradient
kernels and both autograd Functions against their plain versions,
``train()`` with the flagship defaults on synthetic phantoms, step time and
learning on one fixed batch, and one f32 train step on the card against the
CPU.

    python3 chip_smoke.py

Needs one CUDA device, ``nvcc`` and the repository checkout around this file.
Every phase raises on failure; the last line of standard output is
``{"ok": true, "device": {...}}`` only when all of them passed. Imports
nothing of JAX.
"""

from __future__ import annotations

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
}
TRAIN_PATCH = (96, 96, 96)
TRAIN_BATCH = 8  # batch_size 2 x num_samples 4, the train() defaults
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


def check_kernels(torch):
    """Each kernel against its plain version at the serving path's shapes.

    Returns {kernel: {"max_abs_err", "ms", "plain_ms"}} with times summed over
    the kernel's shapes (bf16, the serving dtype) and the largest bf16 error."""
    from segmantic_tpu_torch.infer.sliding_window import window_starts
    from segmantic_tpu_torch.ops import blend, fused_conv, phase_conv

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(dev)

    results = {}

    def record(name, err, ms, plain_ms):
        r = results.setdefault(name, {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["ms"] += ms
        r["plain_ms"] += plain_ms

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

    for shape, co in [((4, 48, 48, 48, 16), 16), ((4, 24, 24, 24, 32), 32)]:
        label = f"x{tuple(shape)}->{co}"
        for dtype in (torch.float32, torch.bfloat16):
            x = randn(*shape).to(dtype)
            w = randn(3, 3, 3, shape[-1], co, scale=(27 * shape[-1]) ** -0.5).to(dtype)
            kw = dict(bias=randn(co, scale=0.1), scale=randn(co).abs() + 0.5,
                      shift=randn(co, scale=0.1), alpha=torch.tensor([0.25], device=dev),
                      relu_mode="prelu")
            k = lambda: fused_conv.conv3d(x, w, **kw)  # noqa: E731
            p = lambda: fused_conv.conv3d_plain(x, w, **kw)  # noqa: E731
            err = compare("fused_conv", label, k, p, dtype)
            if dtype == torch.bfloat16:
                ms, pms = _median_ms(torch, k), _median_ms(torch, p)
                print(f"    bf16 time: kernel {ms:.4f} ms, plain {pms:.4f} ms")
                record("fused_conv", err, ms, pms)

    for shape, c in [((4, 48, 48, 48, 64), 8), ((4, 24, 24, 24, 128), 16)]:
        label = f"p{tuple(shape)} C={c}"
        for dtype in (torch.float32, torch.bfloat16):
            p_in = randn(*shape).to(dtype)
            w = randn(3, 3, 3, c, c, scale=(27 * c) ** -0.5).to(dtype)
            k = lambda: phase_conv.phase_conv(p_in, w)  # noqa: E731
            p = lambda: phase_conv.phase_conv_plain(p_in, w)  # noqa: E731
            err = compare("phase_conv", label, k, p, dtype)
            if dtype == torch.bfloat16:
                ms, pms = _median_ms(torch, k), _median_ms(torch, p)
                print(f"    bf16 time: kernel {ms:.4f} ms, plain {pms:.4f} ms")
                record("phase_conv", err, ms, pms)

    # one chunk of the served grid: 4 overlapping 96^3 windows, 8 classes
    starts = window_starts((256, 256, 176), ROI, 0.25)[:SW_BATCH]
    acc0 = randn(256, 256, 176, NUM_CLASSES)
    logits = randn(SW_BATCH, *ROI, NUM_CLASSES)
    imp = torch.rand(ROI, generator=g).to(dev)
    got = blend.accumulate_windows(acc0.clone(), logits, imp, starts)
    want = blend.accumulate_windows_plain(acc0.clone(), logits, imp, starts)
    torch.cuda.synchronize()
    exact = torch.equal(got, want)
    err = (got - want).abs().max().item()
    print(f"  blend acc(256,256,176,8) starts {starts}: bit-equal {exact} (max|d| {err})")
    if not exact:
        _fail("blend differs from its plain version")
    acc = acc0.clone()
    ms = _median_ms(torch, lambda: blend.accumulate_windows(acc, logits, imp, starts))
    pms = _median_ms(torch, lambda: blend.accumulate_windows_plain(acc, logits, imp, starts))
    print(f"    time: kernel {ms:.4f} ms, plain {pms:.4f} ms")
    record("blend", err, ms, pms)
    return results


def _counters():
    from segmantic_tpu_torch.ops import blend, fused_conv, phase_conv

    return {"fused_conv": fused_conv.counter, "phase_conv": phase_conv.counter,
            "blend": blend.counter, "fused_conv_dw": fused_conv.dw_counter,
            "phase_conv_dw": phase_conv.dw_counter}


def check_train_kernels(torch):
    """The two weight-gradient kernels and both autograd Functions against
    their plain versions at the train step's shapes (batch 8), f32 and bf16.

    Limits: the dw kernels 1e-3 * max|ref| in f32 and with bf16 inputs (sums
    over up to 7 M positions in another order, TF32 off; with bf16 inputs
    both sides sum the same exactly upcast values in f32); the autograd
    Functions 1e-3 in f32 and 2e-2 in bf16 (their output and dx round to
    bf16). Returns {kernel: {"max_abs_err", "ms", "plain_ms"}}, times summed
    over shapes (bf16 inputs; the plain version is cuDNN's f32 wgrad on the
    upcast inputs, TF32 off) and the largest bf16 error."""
    from segmantic_tpu_torch.ops import fused_conv, phase_conv
    from segmantic_tpu_torch.ops.fast_conv import depth_to_space

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(5)

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

    results = {}
    cases = [
        ("fused_conv_dw", f"x{(TRAIN_BATCH, 48, 48, 48, 16)}->16",
         (TRAIN_BATCH, 48, 48, 48, 16), 16),
        ("fused_conv_dw", f"x{(TRAIN_BATCH, 24, 24, 24, 32)}->32",
         (TRAIN_BATCH, 24, 24, 24, 32), 32),
        ("fused_conv_dw", f"x{(TRAIN_BATCH, 6, 6, 6, 128)}->256",
         (TRAIN_BATCH, 6, 6, 6, 128), 256),
        ("phase_conv_dw", f"p{(TRAIN_BATCH, 48, 48, 48, 64)} C=8",
         (TRAIN_BATCH, 48, 48, 48, 64), 64),
        ("phase_conv_dw", f"p{(TRAIN_BATCH, 24, 24, 24, 128)} C=16",
         (TRAIN_BATCH, 24, 24, 24, 128), 128),
    ]
    for name, label, x_shape, co in cases:
        kernel, plain = ((fused_conv.conv3d_dw, fused_conv.conv3d_dw_plain)
                         if name == "fused_conv_dw"
                         else (phase_conv.phase_conv_dw, phase_conv.phase_conv_dw_plain))
        x32 = randn(*x_shape)
        dy32 = randn(*x_shape[:4], co)
        for dtype in (torch.float32, torch.bfloat16):
            x, dy = x32.to(dtype), dy32.to(dtype)
            err = compare(f"{name} {label}", kernel(x, dy), plain(x, dy), dtype, 1e-3)
        ms = _median_ms(torch, lambda: kernel(x, dy))
        pms = _median_ms(torch, lambda: plain(x, dy))
        # context, not the plain version: cuDNN's wgrad straight on the bf16
        # (full-resolution) tensors, tensor cores allowed, output in bf16
        if name == "fused_conv_dw":
            xc, dyc, ci = x, dy, x_shape[-1]
        else:
            ci = x_shape[-1] // 8
            xc, dyc = depth_to_space(x, ci), depth_to_space(dy, co // 8)
        cms = _median_ms(torch, lambda: torch.nn.grad.conv3d_weight(
            xc.permute(0, 4, 1, 2, 3), (dyc.shape[-1], ci, 3, 3, 3),
            dyc.permute(0, 4, 1, 2, 3), padding=1))
        print(f"    bf16 time: kernel {ms:.4f} ms, plain (f32) {pms:.4f} ms; "
              f"for context cuDNN bf16 wgrad {cms:.4f} ms")
        r = results.setdefault(name, {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["ms"] += ms
        r["plain_ms"] += pms

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


def write_nifti(path: Path, data, affine) -> None:
    """data (i, j, k) and its 4x4 RAS affine as a gzipped single-file NIfTI-1
    (sform), written here so the script holds the port's NIfTI I/O against
    an independent codec."""
    import numpy as np

    code = {np.dtype(v): k for k, v in _NIFTI_DTYPES.items()}[data.dtype]
    hdr = bytearray(348)
    struct.pack_into("<i", hdr, 0, 348)
    struct.pack_into("<8h", hdr, 40, 3, *data.shape, 1, 1, 1, 1)
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
    """Nested ellipsoids: label k inside the k-th shell (8 classes), image
    100 * k plus noise; returns (image f32, label u8) arrays."""
    import numpy as np

    rng = np.random.default_rng(seed)
    grid = np.stack(np.meshgrid(*[np.linspace(-1, 1, s) for s in shape], indexing="ij"))
    lbl = np.zeros(shape, np.uint8)
    for k, radius in enumerate((0.9, 0.75, 0.62, 0.5, 0.38, 0.27, 0.16)):
        center = rng.uniform(-0.05, 0.05, 3)[:, None, None, None]
        lbl[(((grid - center) / radius) ** 2).sum(0) < 1.0] = k + 1
    img = (100.0 * lbl + 20.0 * rng.standard_normal(shape)).astype(np.float32)
    return img, lbl


def fixed_batch(torch, n: int, seed: int):
    """n z-scored 96^3 patches of 128^3 phantoms with their labels (host)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    images, labels = [], []
    for i in range(n):
        img, lbl = labelled_phantom((128, 128, 128), seed + i)
        s = rng.integers(0, 33, 3)
        crop = tuple(slice(a, a + 96) for a in s)
        im = img[crop]
        images.append(((im - im.mean()) / im.std())[..., None])
        labels.append(lbl[crop])
    return (torch.from_numpy(np.stack(images).astype(np.float32)),
            torch.from_numpy(np.stack(labels).astype(np.uint8)))


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
    counters = _counters()
    for c in counters.values():
        c.reset()
    t0 = time.perf_counter()
    result = train(image_dir=work / "image", labels_dir=work / "label",
                   output_dir=work / "run", num_classes=NUM_CLASSES, max_epochs=2,
                   device="cuda", seed=0)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: c.count for name, c in counters.items()}
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
    if min(launches.values()) <= 0:
        _fail(f"a kernel of the training path was never launched: {launches}")

    # one fixed batch: warm step time, throughput, peak memory, learning
    model = SegmentationModel.create(num_classes=NUM_CLASSES, seed=1, device="cuda")
    module = model.module.train().requires_grad_(True)
    opt = make_optimizer(module.parameters(), {"optimizer": "Adam", "lr": 1e-3})
    step = make_train_step(module, opt, AugmentConfig(flip_prob=0.0), TRAIN_PATCH,
                           mixed_precision=True)
    image, label = fixed_batch(torch, TRAIN_BATCH, 20)
    image, label = image.cuda(), label.cuda()
    loss_hist = [step(image, label).item() for _ in range(3)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(17):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loss = step(image, label)
        end.record()
        loss_hist.append(loss.item())
        times.append(start.elapsed_time(end))
    peak = torch.cuda.max_memory_allocated() / 2**20
    ms = statistics.median(times)
    voxels = TRAIN_BATCH * int(np.prod(TRAIN_PATCH))
    print(f"  fixed batch {TRAIN_BATCH}x96^3 bf16, Adam lr 1e-3: warm step median {ms:.2f} ms "
          f"(min {min(times):.2f}, max {max(times):.2f}, CUDA events over 17 steps), "
          f"{voxels / ms * 1e3:.4g} labelled voxels/s, peak device memory {peak:.0f} MiB")
    print(f"  loss over 20 steps: {[round(v, 5) for v in loss_hist]}")
    if not all(np.isfinite(loss_hist)) or not loss_hist[-1] < loss_hist[0] - 1e-3:
        _fail("the loss did not fall over 20 steps on a fixed batch")
    return launches, {"step_ms": ms, "voxels_per_s": voxels / ms * 1e3, "peak_mib": peak}


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
    from segmantic_tpu_torch.train.augment import AugmentConfig
    from segmantic_tpu_torch.train.trainer import SegmentationModel, make_train_step

    image, label = fixed_batch(torch, 2, 40)
    out = {}
    for device, dtype in (("cuda", torch.float32), ("cpu", torch.float32),
                          ("cpu", torch.float64)):
        model = SegmentationModel.create(num_classes=NUM_CLASSES, seed=2, device=device)
        module = model.module.to(dtype).train().requires_grad_(True)
        opt = torch.optim.SGD(module.parameters(), lr=0.0)
        step = make_train_step(module, opt, AugmentConfig(flip_prob=0.0), TRAIN_PATCH,
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
                  for k in b64)
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


def make_checkpoint(torch, path: Path):
    """The flagship UNet from torch.Generator seed 0, with non-trivial BN
    running statistics, written as an STPUCKP1 checkpoint."""
    from segmantic_tpu_torch.train.trainer import SegmentationModel

    model = SegmentationModel.create(num_classes=NUM_CLASSES, spatial_size=ROI, seed=0)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, buf in model.module.named_buffers():
            if name.endswith("running_var"):
                buf.copy_(0.5 + torch.rand(buf.shape, generator=g))
            elif name.endswith("running_mean"):
                buf.copy_(0.1 * torch.randn(buf.shape, generator=g))
        for name, p in model.module.named_parameters():
            if "Norm_0" in name:
                p.add_(0.1 * torch.randn(p.shape, generator=g))
    model.save(path)


def phantom(shape, seed: int):
    """Nested ellipsoids of distinct intensities over low-level noise (f32)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    grid = np.stack(np.meshgrid(*[np.linspace(-1, 1, s) for s in shape], indexing="ij"))
    img = 0.05 * rng.standard_normal(shape).astype(np.float32) + 0.1
    for k, radius in enumerate((0.9, 0.7, 0.5, 0.3, 0.15)):
        center = rng.uniform(-0.1, 0.1, 3)[:, None, None, None]
        inside = (((grid - center) / radius) ** 2).sum(0) < 1.0
        img[inside] = 100.0 * (k + 1) + 5.0 * rng.standard_normal(inside.sum())
    return img


def serve_requests(torch, ckpt: Path, work: Path):
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
    if min(launches[k] for k in ("fused_conv", "phase_conv", "blend")) <= 0:
        _fail(f"a kernel of the path was never launched: {launches}")
    return seconds, launches, session


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


def main() -> None:
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is False: this smoke test needs a CUDA device")
    try:
        import segmantic_tpu_torch  # noqa: F401
        from segmantic_tpu_torch.ops import _cuda
    except ImportError as err:
        _fail(f"the repository is not around this script ({err})")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi: n/a")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    lib = _cuda.build()
    print(f"[build] {lib.name}: {time.perf_counter() - t0:.1f} s (nvcc, sm_90a)")

    # f32 comparisons hold the plain versions to full f32: cuDNN would use
    # TF32 for f32 convs by default
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    print("[kernels] each kernel vs its plain version on the card "
          "(cudnn.allow_tf32=False, matmul precision 'highest')")
    measured = check_kernels(torch)
    print("[train-kernels] weight-gradient kernels and autograd Functions vs their "
          "plain versions, batch 8")
    measured.update(check_train_kernels(torch))

    print("[serve] flagship UNet (16-32-64-128-256, 8 classes, roi 96^3, "
          "sw-batch 4, overlap 0.25) through the HTTP server")
    with tempfile.TemporaryDirectory() as td:
        work = Path(td)
        ckpt = work / "flagship.ckpt"
        make_checkpoint(torch, ckpt)
        seconds, launches, session = serve_requests(torch, ckpt, work)
        print(f"  seconds per request: {[round(s, 3) for s in seconds]}")
        print("[parity] 4 x 96^3 windows: folded forward on the card vs the CPU")
        parity(torch, ckpt, session)
        del session
        print("[train] train() with the flagship defaults (96^3 patches, batch 2 x 4 "
              "samples, bf16, Adam 1e-4, phase Dice, roi-160 validation, top-3 ckpts) "
              "on 4 + 1 phantoms of 128^3, 8 classes")
        train_launches, train_numbers = run_train(torch, work / "train")
        print("[train-parity] one f32 train step, batch 2 x 96^3: card vs CPU")
        train_parity(torch)

    if any(m.split(".")[0] in ("jax", "flax", "optax") for m in sys.modules):
        _fail("JAX was imported")
    print(f"launches: serve {launches}, train {train_launches}; train step "
          f"{train_numbers}")
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": launches[name] + train_launches[name],
         "max_abs_err": measured[name]["max_abs_err"],
         "ms": measured[name]["ms"], "plain_ms": measured[name]["plain_ms"]}
        for name, (src, replaces) in KERNELS.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
