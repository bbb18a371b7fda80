"""Chip smoke test of the PyTorch port: build the CUDA kernels, check each
against its plain PyTorch version on the card, serve three volumes through
the port's HTTP server with the flagship UNet, and check the folded forward
on the card against the plain CPU forward.

    python3 chip_smoke.py

Needs one CUDA device, ``nvcc`` and the repository checkout around this file.
Every phase raises on failure; the last line of standard output is
``{"ok": true, "device": {...}}`` only when all of them passed. Imports
nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
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
}


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


def phantom(shape, seed: int, affine):
    """Nested ellipsoids of distinct intensities over low-level noise."""
    import numpy as np

    from segmantic_tpu.core.volume import Volume

    rng = np.random.default_rng(seed)
    grid = np.stack(np.meshgrid(*[np.linspace(-1, 1, s) for s in shape], indexing="ij"))
    img = 0.05 * rng.standard_normal(shape).astype(np.float32) + 0.1
    for k, radius in enumerate((0.9, 0.7, 0.5, 0.3, 0.15)):
        center = rng.uniform(-0.1, 0.1, 3)[:, None, None, None]
        inside = (((grid - center) / radius) ** 2).sum(0) < 1.0
        img[inside] = 100.0 * (k + 1) + 5.0 * rng.standard_normal(inside.sum())
    return Volume(data=img[None], affine=affine)


def serve_requests(torch, ckpt: Path, work: Path):
    import numpy as np

    from segmantic_tpu.core.volume import affine_from_spacing_origin
    from segmantic_tpu.io.nifti import read_volume, write_volume
    from segmantic_tpu_torch.ops import blend, fused_conv, phase_conv
    from segmantic_tpu_torch.serve import InferenceSession, make_server

    lps = affine_from_spacing_origin((0.8, 0.9, 1.1), (10.0, -20.0, 5.0))
    lps[:2] *= -1
    cases = [
        ("phantom_a", phantom((256, 256, 176), 1, affine_from_spacing_origin((1.0, 1.0, 1.2)))),
        ("phantom_b", phantom((256, 256, 176), 2, affine_from_spacing_origin((0.9, 0.9, 1.0)))),
        # LPS: flipped on the way in and back on the way out; no axis is a
        # multiple of the window stride, so the last windows snap to the edges
        ("lps", phantom((200, 168, 150), 3, lps)),
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
        for c in (fused_conv.counter, phase_conv.counter, blend.counter):
            c.reset()
        for name, vol in cases:
            path = work / f"{name}.nii.gz"
            write_volume(path, vol)
            req = urllib.request.Request(f"{base}/v1/segment", data=path.read_bytes(),
                                         method="POST")
            t0 = time.perf_counter()
            with urllib.request.urlopen(req, timeout=600) as r:
                status, body = r.status, r.read()
            dt = time.perf_counter() - t0
            seconds.append(dt)
            out = work / f"{name}_pred.nii.gz"
            out.write_bytes(body)
            pred = read_volume(out)
            labels = pred.numpy()
            ok = (status == 200 and pred.spatial_shape == vol.spatial_shape
                  and np.allclose(pred.affine, vol.affine, atol=1e-4)
                  and labels.min() >= 0 and labels.max() < NUM_CLASSES)
            counts = np.bincount(labels.astype(np.int64).ravel(), minlength=NUM_CLASSES)
            print(f"  POST {name} {vol.spatial_shape}: HTTP {status}, {dt:.3f} s, "
                  f"grid {pred.spatial_shape}, affine match "
                  f"{np.allclose(pred.affine, vol.affine, atol=1e-4)}, "
                  f"labels per class {counts.tolist()}")
            if not ok:
                _fail(f"request {name}: bad response")
    finally:
        server.shutdown()
        thread.join(timeout=60)
        server.server_close()
    if thread.is_alive():
        _fail("server thread did not stop")
    launches = {"fused_conv": fused_conv.counter.count,
                "phase_conv": phase_conv.counter.count, "blend": blend.counter.count}
    print(f"  launches during the requests: {launches}")
    if min(launches.values()) <= 0:
        _fail(f"a kernel of the path was never launched: {launches}")
    return seconds, launches, session


def parity(torch, ckpt: Path, session):
    """One 4 x 96^3 window batch: folded forward on the card (kernels, f32;
    TF32 is off since main) vs the same forward on the CPU (plain, f32)."""
    import numpy as np

    from segmantic_tpu_torch.infer.executor import make_eval_forward
    from segmantic_tpu_torch.train.trainer import SegmentationModel

    vol = phantom((192, 96, 96), 4, np.eye(4)).numpy()[0]
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

    if any(m.split(".")[0] in ("jax", "flax", "optax") for m in sys.modules):
        _fail("JAX was imported")
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": launches[name], "max_abs_err": measured[name]["max_abs_err"],
         "ms": measured[name]["ms"], "plain_ms": measured[name]["plain_ms"]}
        for name, (src, replaces) in KERNELS.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
