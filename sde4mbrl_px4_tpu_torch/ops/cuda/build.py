"""Build the port's CUDA sources into a shared library and load it.

Each library is compiled with ``nvcc`` at first use into
``build/torch_kernels/`` at the root of the checkout, under a name keyed
by a hash of its sources and flags, so a fresh checkout builds itself and
an edited source rebuilds. The library exposes plain C entry points and is
loaded with ``ctypes``. A file lock serialises concurrent builds.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "build_library", "find_nvcc"]

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): "
                           "the CUDA kernels need the CUDA toolkit to build")
    return nvcc


def build_library(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` (with every ``csrc/*.cuh`` and the ``.cu``
    sources it includes) unless a build of the same sources exists; returns
    the library path. The compiler's output (``-Xptxas -v``: registers,
    shared memory, spills) is kept beside it as ``.log``;
    ``build_library.seconds[name]`` is the time the
    last call for ``name`` spent compiling (0 when the build was reused).
    Builds of different libraries may run in parallel threads."""
    src = CSRC / f"{name}.cu"
    # every header, and a source the library includes whole (apg_solve_bf16.cu)
    included = re.findall(r'#include "(\w+\.cu)"', src.read_text())
    deps = [src] + [CSRC / n for n in included] + sorted(CSRC.glob("*.cuh"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in deps:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    out = BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"
    build_library.seconds[name] = 0.0
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f".{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():                     # a peer built it meanwhile
            return out
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        t0 = time.perf_counter()
        r = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o",
                            str(tmp), str(src)], capture_output=True, text=True)
        build_library.seconds[name] = time.perf_counter() - t0
        log = r.stdout + r.stderr
        if r.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed for {src.name}:\n{log}")
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    return out


build_library.seconds = {}


def load_library(name: str) -> ctypes.CDLL:
    return ctypes.CDLL(str(build_library(name)))
