"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each library is compiled on first use into ``build/pf_kernels/`` at the root
of the checkout, under a name keyed by a hash of its sources, the shared
headers (``csrc/*.cuh``) and the flags, so a changed source rebuilds and an
unchanged one loads at once. The sources have
a plain ``extern "C"`` interface and include no PyTorch headers, which keeps
a build to seconds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Sequence

__all__ = ["CSRC_DIR", "BUILD_DIR", "load_library"]

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "pf_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def load_library(name: str, sources: Sequence[str]) -> ctypes.CDLL:
    """Compile ``sources`` (file names under ``csrc/``) into one shared
    library, unless a build of the same sources exists, and load it. The
    library carries ``build_log`` (the compiler's output, with ptxas's
    register and spill report) and ``build_seconds`` (0.0 when an earlier
    build was loaded)."""
    paths = [CSRC_DIR / s for s in sources]
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    # the shared headers too: a changed header rebuilds every library
    for p in paths + sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    out = BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"
    log, seconds = "", 0.0
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, paths)]
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed building {name}:\n{res.stdout}{res.stderr}")
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        log, seconds = res.stdout + res.stderr, time.perf_counter() - t0
    lib = ctypes.CDLL(str(out))
    lib.build_log, lib.build_seconds = log, seconds
    return lib
