"""Where the time of one training step of the PyTorch port goes on the card:
the flagship UNet (16-32-64-128-256, 8 classes) on one fixed 8 x 96^3 bf16
batch, Adam, the phase-major Dice, as ``train()`` runs it by default; with
``--arch segresnet`` or ``--arch unetr`` that architecture at full width
(the JAX package's defaults, 8 classes; SegResNet with the plain Dice,
UNETR packed, with the phase-major Dice on its phase-space head); with
``--augment`` the step ``train(augment_spatial=True, augment_intensity=True)``
runs, on one fixed 8 x 144^3 bf16 margin batch (rotation + zoom through the
shear-group kernel, intensity ops, flips, Gibbs and spike); with ``--f32`` the
step ``train(mixed_precision=False)`` runs, in f32 (its 3^3 convs on the
register-tiled f32 bodies); with ``--i2i3d`` one 3D pix2pix iteration (D
step, then G step, Adam) of the i2i CLI's generator and discriminator (base
64, 6 blocks, f32) on a 1 x 64^3 pair, whose block convs (16^3 x 256) run on
the f32 bodies of kernels 1 and 2, timed and profiled in place of the step.

    python3 profile_train_step.py [--steps 3] [--arch unet|segresnet|unetr] [--augment] [--f32]
    python3 profile_train_step.py --i2i3d

Prints the card's name and power limit; for the UNet and UNETR the two phase-Dice
kernels alone at the step's shape by CUDA-graph replay; forward + loss,
backward and the
optimizer step timed apart (CUDA events, median of 10); the whole step
through ``make_train_step`` (median of 10); then, over ``--steps`` steps
under ``torch.profiler``, the device kernel time per step by group, the busy
share (kernel time over the unprofiled step, and over the profiled steps'
span on CUDA events) and the largest kernels; and the peak device memory.
Needs one CUDA device and ``nvcc``; imports nothing of JAX and nothing of
the JAX package. Raises if the profiler records no device time.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
BATCH, PATCH, NUM_CLASSES = 8, (96, 96, 96), 8
# (group, substrings of the kernel name), first match wins
GROUPS = [
    ("shear-group kernel (augmentation)", ("shear_group_kernel",)),
    ("Dice sums kernel", ("dice_sums_kernel",)),
    ("Dice sums finalize", ("dice_sums_finalize",)),
    ("Dice dx kernel", ("dice_dx_kernel",)),
    ("FFTs (Gibbs, spike)", ("fft",)),
    ("dw kernels (fused_conv_dw, phase_conv_dw)",
     ("conv3_f32_dw_kernel", "conv3_dw_mma_kernel", "conv3_dw_wgmma_kernel",
      "conv3_fewc_dw_kernel")),
    ("dw reduce", ("dw_reduce_kernel", "dw_reduce_lanes_kernel")),
    ("conv kernels fwd+dx (fused_conv, phase_conv)",
     ("conv3_f32_kernel", "conv3_mma_kernel", "conv3_wgmma_kernel", "conv3_fewc_kernel",
      "wgmma_reduce_kernel", "conv3_f32_reduce_kernel")),
    ("cuDNN convs (strided, transposed, 1x1)",
     ("cudnn", "implicit_gemm", "wgrad", "dgrad", "fprop", "convolve")),
    ("GEMMs (cuBLAS: attention, MLP)", ("gemm", "cutlass", "xmma", "nvjet")),
    ("optimizer", ("multi_tensor_apply", "adam")),
    ("reductions (norm statistics, Dice sums)", ("reduce_kernel", "welford", "batch_norm")),
    ("copies / layout", ("copy", "memcpy", "memset", "cat", "transpose", "permute", "index")),
    ("elementwise (BN, PReLU, casts, intensity ops)", ("elementwise",)),
]


def median_ms(torch, fn, n: int = 10, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> None:
    sys.path.insert(0, str(ROOT))
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--arch", choices=("unet", "segresnet", "unetr"), default="unet",
                        help="the architecture, at full width")
    parser.add_argument("--augment", action="store_true",
                        help="profile the augmented step on a 8 x 144^3 margin batch")
    parser.add_argument("--f32", action="store_true",
                        help="profile the f32 step (mixed_precision=False)")
    parser.add_argument("--i2i3d", action="store_true",
                        help="profile a 3D pix2pix iteration (base 64, 6 blocks, 1 x 64^3)")
    args = parser.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        sys.exit("profile_train_step: needs a CUDA device")
    from chip_smoke import _graph_ms, fixed_batch
    from segmantic_tpu_torch.ops import phase_dice
    from segmantic_tpu_torch.ops import _cuda
    from segmantic_tpu_torch.ops.fast_conv import space_to_depth
    from segmantic_tpu_torch.train.augment import AugmentConfig, augment_batch
    from segmantic_tpu_torch.train.losses import dice_loss, dice_loss_phase
    from segmantic_tpu_torch.train.optim import make_optimizer
    from segmantic_tpu_torch.train.trainer import SegmentationModel, make_train_step

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip() or "nvidia-smi: n/a")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    _cuda.build()
    if args.i2i3d:
        step, step_ms = i2i_iteration(torch)
        profile_steps(torch, profile, ProfilerActivity, step, step_ms, args.steps, "iteration")
        return

    arch_kw = {"arch": args.arch}
    if args.arch == "unetr":
        arch_kw["spatial_size"] = PATCH
    model = SegmentationModel.create(num_classes=NUM_CLASSES, seed=1, device="cuda", **arch_kw)
    module = model.module.train().requires_grad_(True)
    print(f"{args.arch}: {sum(p.numel() for p in module.parameters())} parameters")
    opt = make_optimizer(module.parameters(), {"optimizer": "Adam", "lr": 1e-4})
    image32, label = fixed_batch(torch, BATCH, 20)
    image32, label = image32.cuda(), label.cuda()
    image = image32 if args.f32 else image32.to(torch.bfloat16)
    target = space_to_depth(label[..., None])
    phase = module.phase_top_ok()  # the UNet's top stage, packed UNETR's head
    if phase != (args.arch != "segresnet"):
        sys.exit("profile_train_step: the top runs in phase space for the UNet and UNETR only")

    def forward():
        if not phase:
            return dice_loss(module(image), label)
        return dice_loss_phase(module(image, phase_logits=True), target)

    if phase:
        with torch.no_grad():
            xp = module(image, phase_logits=True)
        hot, cold = (torch.randn((BATCH, xp.shape[-1]), device="cuda") for _ in range(2))
        print(f"Dice kernels alone, xp {tuple(xp.shape)} {str(xp.dtype)[6:]}, CUDA-graph "
              f"replay (median of 10 replays of 10 calls): sums + finalize "
              f"{_graph_ms(torch, lambda: phase_dice.dice_phase_sums(xp, target)):.4f} ms, dx "
              f"{_graph_ms(torch, lambda: phase_dice.dice_phase_dx(xp, target, hot, cold)):.4f}"
              f" ms")

    def backward():
        opt.zero_grad(set_to_none=True)
        forward().backward()

    fwd = median_ms(torch, forward)
    fwd_bwd = median_ms(torch, backward)
    adam = median_ms(torch, opt.step)
    print(f"forward+loss {fwd:.2f} ms, backward {fwd_bwd - fwd:.2f} ms (forward + "
          f"backward {fwd_bwd:.2f}), optimizer {adam:.2f} ms (CUDA events, median of 10)")

    cfg = AugmentConfig(flip_prob=0.0)
    if args.augment:  # the margin batch, uploaded in bf16 as train() does
        cfg = AugmentConfig(spatial=True, intensity=True)
        image32, label = fixed_batch(torch, BATCH, 60, size=144, volume=160)
        image32, label = image32.to(torch.bfloat16).cuda(), label.cuda()
        gen = torch.Generator().manual_seed(3)
        aug = median_ms(torch, lambda: augment_batch(image32, label, gen, cfg, PATCH))
        print(f"augmentation alone {aug:.2f} ms (8 x 144^3 -> 96^3, median of 10 draws)")
    step = make_train_step(module, opt, cfg, PATCH, mixed_precision=not args.f32,
                           generator=torch.Generator().manual_seed(4))
    step_ms = median_ms(torch, lambda: step(image32, label))
    print(f"whole {'augmented ' if args.augment else ''}{'f32 ' if args.f32 else ''}step via "
          f"make_train_step {step_ms:.2f} ms (median of 10), "
          f"{BATCH * 96 ** 3 / step_ms * 1e3:.4g} labelled voxels/s")
    profile_steps(torch, profile, ProfilerActivity, lambda: step(image32, label), step_ms,
                  args.steps, "step")


def i2i_iteration(torch):
    """(one 3D pix2pix iteration, its median ms): the i2i CLI's generator and
    discriminator (base 64, 6 blocks) in f32 on one 64^3 pair, Adam."""
    import numpy as np

    from segmantic_tpu_torch.i2i import train as i2i_train

    rng = np.random.default_rng(12)
    src = rng.uniform(-1, 1, (1, 64, 64, 64, 1)).astype(np.float32)
    dst = np.tanh(1.5 - 2.0 * src).astype(np.float32)
    gen, disc = i2i_train._init_pix2pix(src, dst, 64, 6, 0, "cuda")
    d_step, g_step = i2i_train.make_pix2pix_steps(
        gen, disc, i2i_train._make_optim(gen.parameters(), 2e-4),
        i2i_train._make_optim(disc.parameters(), 2e-4), 100.0)
    s, d = (torch.from_numpy(v).cuda() for v in (src, dst))

    def iteration():
        d_step(s, d)
        g_step(s, d)

    ms = median_ms(torch, iteration)
    print(f"3D pix2pix iteration (base 64, 6 blocks, 1 x 64^3, f32) {ms:.2f} ms (median of 10)")
    return iteration, ms


def profile_steps(torch, profile, ProfilerActivity, step, step_ms: float, steps: int,
                  what: str) -> None:
    """Device kernel time per ``what`` by group under ``torch.profiler`` over
    ``steps`` calls of ``step``, the busy share, the largest kernels and the
    peak device memory."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(steps):
            step()
        end.record()
        torch.cuda.synchronize()
    span = start.elapsed_time(end) / steps
    peak = torch.cuda.max_memory_allocated() / 2**20

    # device-side events, less the annotations that mirror host ops on the
    # device's timeline (``Optimizer.step#Adam.step``, autograd nodes)
    events = prof.key_averages()
    host_ops = {e.key for e in events if e.device_type == torch.autograd.DeviceType.CPU}
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
               and e.key not in host_ops]
    total = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    if total <= 0:
        sys.exit("profile_train_step: the profiler recorded no device time")
    groups = {name: 0.0 for name, _ in GROUPS} | {"other": 0.0}
    for e in kernels:
        key = e.key.lower()
        name = next((g for g, subs in GROUPS if any(s in key for s in subs)), "other")
        groups[name] += e.self_device_time_total / 1e3 / steps
    print(f"profiled {steps} {what}s: device kernel time {total:.2f} ms/{what} over "
          f"{len(kernels)} kernel names; busy share {total / step_ms:.3f} of the "
          f"unprofiled {what} ({step_ms:.2f} ms), {total / span:.3f} of the profiled span "
          f"({span:.2f} ms/{what} on CUDA events: the profiler's host cost stretches a "
          f"{what} whose launches the host paces)")
    for name, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {ms:8.3f} ms/{what}  {name}")
    others = [e for e in kernels
              if not any(sub in e.key.lower() for _, subs in GROUPS for sub in subs)]
    for e in sorted(others, key=lambda e: -e.self_device_time_total)[:5]:
        print(f"    other: {e.self_device_time_total / 1e3 / steps:8.3f} ms/{what}  "
              f"{e.key[:90]}")
    print("largest kernels:")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"  {e.self_device_time_total / 1e3 / steps:8.3f} ms/{what}  "
              f"x{e.count // steps:4d}  {e.key[:100]}")
    print(f"peak device memory {peak:.0f} MiB (profiled steps)")


if __name__ == "__main__":
    main()
