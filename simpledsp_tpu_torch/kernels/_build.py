"""Build the package's CUDA sources at first use and load them with ctypes.

Each library is compiled by ``nvcc`` from ``simpledsp_tpu_torch/csrc/`` into
``build/`` at the root of the checkout (listed in ``.gitignore``), under a
name that carries a hash of the sources and flags: an edited source builds
anew, an unchanged one loads the library already there.  The sources have a
plain C interface (``extern "C"``), so no PyTorch header is compiled and a
build takes seconds.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Sequence

__all__ = ["CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "load_library", "build_seconds"]

_PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = _PACKAGE_DIR / "csrc"
BUILD_DIR = _PACKAGE_DIR.parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

# Seconds spent in nvcc, by library name (0.0 when it was already built).
build_seconds: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if path.is_file():
        return str(path)
    raise RuntimeError("nvcc not found (searched PATH and CUDA_HOME); the CUDA "
                       "kernels are built from source at first use")


@functools.lru_cache(maxsize=None)
def load_library(name: str, sources: Sequence[str],
                 headers: Sequence[str] = ()) -> ctypes.CDLL:
    """Compile ``sources`` (file names under ``csrc/``) into one shared
    library, unless a build of the same sources, ``headers`` (the files
    under ``csrc/`` they include, hashed but not compiled on their own) and
    flags exists, and load it.  Raises RuntimeError with nvcc's output when
    the build fails."""
    paths = [CSRC_DIR / s for s in sources]
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in paths + [CSRC_DIR / h for h in headers]:
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    lib_path = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
    if lib_path.exists():
        build_seconds[name] = 0.0
    else:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, paths)]
        start = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_seconds[name] = time.perf_counter() - start
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed for {name} ({' '.join(cmd)}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib_path)  # atomic: a concurrent loader sees all or nothing
    return ctypes.CDLL(str(lib_path))
