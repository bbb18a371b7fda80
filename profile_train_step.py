"""Where the time of one training step of the PyTorch port goes on the card:
the flagship UNet (16-32-64-128-256, 8 classes) on one fixed 8 x 96^3 bf16
batch, Adam, the phase-major Dice, as ``train()`` runs it by default.

    python3 profile_train_step.py [--steps 3]

Prints the card's name and power limit; forward + loss, backward and the
optimizer step timed apart (CUDA events, median of 10); the whole step
through ``make_train_step`` (median of 10); then, over ``--steps`` steps
under ``torch.profiler``, the device kernel time per step by group, the busy
share (kernel time over the unprofiled step, and over the profiled steps'
span on CUDA events) and the largest kernels; and the peak device memory.
Needs one CUDA device and ``nvcc``; imports nothing of JAX. Raises if the
profiler records no device time.
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
    ("dw kernels (fused_conv_dw, phase_conv_dw)", ("conv3_dw_kernel",)),
    ("dw reduce", ("dw_reduce_kernel",)),
    ("conv kernels fwd+dx (fused_conv, phase_conv)", ("conv3_kernel",)),
    ("cuDNN convs (strided, transposed, 1x1)",
     ("xmma", "cudnn", "implicit_gemm", "wgrad", "dgrad", "fprop", "convolve")),
    ("GEMMs", ("gemm", "cutlass")),
    ("optimizer", ("multi_tensor_apply", "adam")),
    ("reductions (BN stats, Dice sums)", ("reduce_kernel", "welford", "batch_norm")),
    ("copies / layout", ("copy", "memcpy", "memset", "cat", "transpose", "permute", "index")),
    ("elementwise (BN, PReLU, casts, Dice)", ("elementwise",)),
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
    args = parser.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        sys.exit("profile_train_step: needs a CUDA device")
    from chip_smoke import fixed_batch
    from segmantic_tpu_torch.ops import _cuda
    from segmantic_tpu_torch.ops.fast_conv import space_to_depth
    from segmantic_tpu_torch.train.augment import AugmentConfig
    from segmantic_tpu_torch.train.losses import dice_loss_phase
    from segmantic_tpu_torch.train.optim import make_optimizer
    from segmantic_tpu_torch.train.trainer import SegmentationModel, make_train_step

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip() or "nvidia-smi: n/a")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    _cuda.build()

    model = SegmentationModel.create(num_classes=NUM_CLASSES, seed=1, device="cuda")
    module = model.module.train().requires_grad_(True)
    opt = make_optimizer(module.parameters(), {"optimizer": "Adam", "lr": 1e-4})
    image32, label = fixed_batch(torch, BATCH, 20)
    image32, label = image32.cuda(), label.cuda()
    image = image32.to(torch.bfloat16)
    target = space_to_depth(label[..., None])
    if not module.phase_top_ok():
        sys.exit("profile_train_step: the flagship top stage should run in phase space")

    def forward():
        return dice_loss_phase(module(image, phase_logits=True), target)

    def backward():
        opt.zero_grad(set_to_none=True)
        forward().backward()

    fwd = median_ms(torch, forward)
    fwd_bwd = median_ms(torch, backward)
    adam = median_ms(torch, opt.step)
    print(f"forward+loss {fwd:.2f} ms, backward {fwd_bwd - fwd:.2f} ms (forward + "
          f"backward {fwd_bwd:.2f}), optimizer {adam:.2f} ms (CUDA events, median of 10)")

    step = make_train_step(module, opt, AugmentConfig(flip_prob=0.0), PATCH,
                           mixed_precision=True)
    step_ms = median_ms(torch, lambda: step(image32, label))
    print(f"whole step via make_train_step {step_ms:.2f} ms (median of 10), "
          f"{BATCH * 96 ** 3 / step_ms * 1e3:.4g} labelled voxels/s")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(args.steps):
            step(image32, label)
        end.record()
        torch.cuda.synchronize()
    span = start.elapsed_time(end) / args.steps
    peak = torch.cuda.max_memory_allocated() / 2**20

    # device-side events, less the annotations that mirror host ops on the
    # device's timeline (``Optimizer.step#Adam.step``, autograd nodes)
    events = prof.key_averages()
    host_ops = {e.key for e in events if e.device_type == torch.autograd.DeviceType.CPU}
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
               and e.key not in host_ops]
    total = sum(e.self_device_time_total for e in kernels) / 1e3 / args.steps
    if total <= 0:
        sys.exit("profile_train_step: the profiler recorded no device time")
    groups = {name: 0.0 for name, _ in GROUPS} | {"other": 0.0}
    for e in kernels:
        key = e.key.lower()
        name = next((g for g, subs in GROUPS if any(s in key for s in subs)), "other")
        groups[name] += e.self_device_time_total / 1e3 / args.steps
    print(f"profiled {args.steps} steps: device kernel time {total:.2f} ms/step over "
          f"{len(kernels)} kernel names; busy share {total / step_ms:.3f} of the "
          f"unprofiled step ({step_ms:.2f} ms), {total / span:.3f} of the profiled span "
          f"({span:.2f} ms/step on CUDA events: the profiler's host cost stretches a "
          f"step whose launches the host paces)")
    for name, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {ms:8.3f} ms/step  {name}")
    print("largest kernels:")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"  {e.self_device_time_total / 1e3 / args.steps:8.3f} ms/step  "
              f"x{e.count // args.steps:4d}  {e.key[:100]}")
    print(f"peak device memory {peak:.0f} MiB (profiled steps)")


if __name__ == "__main__":
    main()
