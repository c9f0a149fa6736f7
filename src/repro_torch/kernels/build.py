"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain ``extern "C"`` entry point and
compiles on first use into a shared library under ``build/repro_torch/``
at the root of the checkout, named by a hash of its source and its
flags, so an edited source rebuilds and an unchanged one loads at
once. A plain C interface builds in seconds, where an extension that
includes PyTorch's headers takes minutes. Nothing here runs at import
time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Tuple

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
KERNELS = ("schedule_step", "flash_attention", "ssd_chunk", "lru_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# Per-kernel flags on top of NVCC_FLAGS. schedule_step is bit-exact with
# its plain version only if no multiply-add is contracted.
KERNEL_FLAGS: Dict[str, Tuple[str, ...]] = {
    "schedule_step": ("-fmad=false",),
    "flash_attention": (),
    "ssd_chunk": (),
    "lru_scan": (),
}

# Kernel launches by kernel name, raised by each CUDA wrapper after a
# successful launch and nowhere else (``ops.LAUNCHES`` is this dict).
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}
# FLOPs of the kernel calls made on meta tensors (the dry-run's shape
# route: a meta output, no arithmetic, no launch), by kernel name
META_FLOPS: Dict[str, int] = {name: 0 for name in KERNELS}

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return path


def flags(name: str) -> Tuple[str, ...]:
    return NVCC_FLAGS + KERNEL_FLAGS[name]


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(flags(name)).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all(names: Iterable[str] = KERNELS) -> Dict[str, dict]:
    """Compile every named kernel that is not built yet, one ``nvcc``
    per source, all started together. Returns ``{name: {"seconds",
    "log", "cached"}}``; raises with the compiler's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    report = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            report[name] = {"seconds": 0.0, "log": "", "cached": True}
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in started.items():
        log, _ = proc.communicate()    # waits: no compiler outlives us
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu "
                          f"(exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        report[name] = {"seconds": time.perf_counter() - t0, "log": log,
                        "cached": False}
    if failed:
        raise RuntimeError("\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build_all([name])
        lib = _LIBS[name] = ctypes.CDLL(str(path))
    return lib
