"""Build, load and launch the hand-written CUDA kernels of ``csrc/``.

The sources are compiled with ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, bound with ``ctypes`` (no PyTorch headers,
so a build takes seconds, not minutes). The library is named after a hash of
the sources and flags and lives in ``build/kernels/`` at the repository root;
it is built at first use, so any process that launches a kernel builds it.

Nothing here runs at import: the CPU tests import every module of the port,
and a CPU tensor never reaches a kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

import torch

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# name -> argtypes; every pointer and the stream are c_void_p
_SIGNATURES = {
    "segk_fused_conv3_mma": [_P, _P, _P, _P, _P, _I, _P] + [_I] * 17 + [_P],
    "segk_phase_conv3_mma": [_P, _P, _P, _P, _P, _I, _P] + [_I] * 17 + [_P],
    "segk_fused_conv3_wgmma": [_P, _P, _P, _P, _P, _I, _P, _P] + [_I] * 16 + [_P],
    "segk_fused_conv3_f32": [_P, _P, _P, _P, _P, _I, _P, _P] + [_I] * 16 + [_P],
    "segk_phase_conv3_f32": [_P, _P, _P, _P, _P, _I, _P, _P] + [_I] * 16 + [_P],
    "segk_fused_conv3_fewc": [_P, _P, _P, _P, _P, _I, _P] + [_I] * 14 + [_P],
    "segk_fused_conv3_mid": [_P, _P, _P, _P, _P, _I, _P] + [_I] * 17 + [_P],
    "segk_phase_conv3_mid": [_P, _P, _P, _P, _P, _I, _P] + [_I] * 17 + [_P],
    "segk_phase_conv3_fewc": [_P, _P, _P, _P, _P, _I, _P] + [_I] * 14 + [_P],
    "segk_phase_conv3_lanes": [_P, _P, _P, _P, _P, _I, _P] + [_I] * 10 + [_P],
    "segk_fused_conv3_rows": [_P, _P, _P, _P, _P, _I, _P] + [_I] * 10 + [_P],
    "segk_blend": [_P] * 5 + [_I] * 17 + [_P],
    "segk_blend_blocks_per_sm": [_I] * 2,
    "segk_fused_conv3_dw_mma": [_P, _P, _P, _P] + [_I] * 14 + [_P],
    "segk_phase_conv3_dw_mma": [_P, _P, _P, _P] + [_I] * 14 + [_P],
    "segk_fused_conv3_dw_wgmma": [_P, _P, _P, _P] + [_I] * 15 + [_P],
    "segk_fused_conv3_dw_mid": [_P, _P, _P, _P] + [_I] * 14 + [_P],
    "segk_fused_conv3_dw_rows": [_P, _P, _P, _P] + [_I] * 9 + [_P],
    "segk_fused_conv3_dw_pairs": [_P, _P, _P, _P] + [_I] * 9 + [_P],
    "segk_fused_conv3_dw_f32": [_P, _P, _P, _P] + [_I] * 17 + [_P],
    "segk_phase_conv3_dw_f32": [_P, _P, _P, _P] + [_I] * 17 + [_P],
    "segk_phase_conv3_dw_wgmma": [_P, _P, _P, _P] + [_I] * 14 + [_P],
    "segk_phase_conv3_dw_pieces": [_P, _P, _P, _P] + [_I] * 12 + [_P],
    "segk_fused_conv3_dw_fewc": [_P, _P, _P, _P] + [_I] * 14 + [_P],
    "segk_phase_conv3_dw_fewc": [_P, _P, _P, _P] + [_I] * 14 + [_P],
    "segk_shear_group": [_P] * 6 + [_I] * 14 + [_P],
    "segk_shear_group_blocks_per_sm": [_I] * 6,
    "segk_shear_group_global": [_P] * 7 + [_I] * 12 + [_P],
    "segk_shear_group_global_blocks_per_sm": [_I] * 4,
    "segk_dice_phase_sums": [_P] * 4 + [_I] * 4 + [_L, _L, _I, _I, _P],
    "segk_dice_phase_dx": [_P] * 5 + [_I] * 5 + [_L, _I, _I, _P],
}


class LaunchCounter:
    """Counts a wrapper's kernel launches (not its plain-version calls)."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0

    def reset(self) -> None:
        self.count = 0


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels of "
        "segmantic_tpu_torch cannot be built"
    )


def _sources():
    return sorted(_CSRC.glob("*.cu")), sorted(_CSRC.glob("*.cuh"))


def library_path() -> Path:
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in cu + cuh:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libsegmantic_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile every ``csrc/*.cu`` (in parallel) and link the library.

    Returns its path; a library already built from the same sources is
    reused. ptxas' register/shared-memory report goes to ``<lib>.log``."""
    lib = library_path()
    if lib.exists():
        return lib
    nvcc = nvcc_path()
    cu, _ = _sources()
    work = BUILD_DIR / f"{lib.stem}.tmp{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    procs = []
    t0 = time.perf_counter()
    for src in cu:
        obj = work / f"{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        # each unit's report to a file of its own: through a pipe, a unit
        # whose report outgrew the pipe waited for the units read before it
        with open(work / f"{src.stem}.log", "w") as out:
            procs.append((src, obj, subprocess.Popen(cmd, stdout=out,
                                                     stderr=subprocess.STDOUT)))
    ended = {}
    while len(ended) < len(procs):
        for src, _, proc in procs:
            if src.name not in ended and proc.poll() is not None:
                ended[src.name] = time.perf_counter() - t0
        time.sleep(0.05)
    log = []
    failed = []
    for src, _, proc in procs:
        out = (work / f"{src.stem}.log").read_text()
        log.append(f"== {src.name} ({ended[src.name]:.1f} s)\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    (BUILD_DIR / f"{lib.stem}.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    tmp_lib = work / lib.name
    link = [nvcc, "-shared", "-Xcompiler", "-fPIC", "-o", str(tmp_lib)]
    link += [str(obj) for _, obj, _ in procs]
    res = subprocess.run(link, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{res.stdout}\n{res.stderr}")
    os.replace(tmp_lib, lib)  # atomic: a reader never sees a partial file
    shutil.rmtree(work, ignore_errors=True)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int  # an error code, or the value a query asks for
            _lib = lib
        return _lib


def launch(name: str, *args) -> None:
    """Call one C entry point on the current stream; raise on a launch error."""
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(library(), name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def query(name: str, *args) -> int:
    """Call one host-only C entry point (no stream) and return its value."""
    return getattr(library(), name)(*args)


def resolve_device(device) -> torch.device:
    """The requested device; asking for CUDA without CUDA raises (the port
    never moves to the CPU on its own)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but CUDA is not available "
            "(torch.cuda.is_available() is False); pass device='cpu' explicitly "
            "to run on the CPU"
        )
    return device


def check_cuda(t: torch.Tensor, name: str) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be on a CUDA device, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
