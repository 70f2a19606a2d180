"""Build the package's native sources at first use and load them with ctypes.

Each CUDA library is compiled by ``nvcc`` from ``simpledsp_tpu_torch/csrc/``
into ``build/`` at the root of the checkout (listed in ``.gitignore``), under
a name that carries a hash of the sources and flags: an edited source builds
anew, an unchanged one loads the library already there.  The sources have a
plain C interface (``extern "C"``), so no PyTorch header is compiled and a
build takes seconds.  The host runtime's library (``runtime/stream.py``,
g++ over ``native/sdsp_io.cpp``) is built the same way by
:func:`build_shared`.  Nothing here runs at import time.
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
from typing import Callable, Sequence

__all__ = ["CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "build_shared", "load_library",
           "build_seconds"]

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


def build_shared(name: str, compiler: Callable[[], str],
                 flags: Sequence[str], sources: Sequence[Path],
                 headers: Sequence[Path] = (), salt: bytes = b"") -> Path:
    """Compile ``sources`` with ``compiler()`` and ``flags`` into
    ``build/lib<name>-<hash>.so`` unless that file exists, and return its
    path.  The hash covers the flags, ``salt``, and the names and bytes of
    the sources and ``headers``.  The library is written to a temporary
    file and renamed, so processes that build it at once each see all of
    it or nothing.  Raises RuntimeError with the compiler's output when the
    build fails."""
    digest = hashlib.sha256(" ".join(flags).encode() + salt)
    for p in list(sources) + list(headers):
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    lib_path = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
    if lib_path.exists():
        build_seconds[name] = 0.0
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [compiler(), *flags, "-o", tmp, *map(str, sources)]
    start = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds[name] = time.perf_counter() - start
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"the build of {name} failed ({' '.join(cmd)}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib_path)  # atomic: a concurrent loader sees all or nothing
    return lib_path


@functools.lru_cache(maxsize=None)
def load_library(name: str, sources: Sequence[str],
                 headers: Sequence[str] = ()) -> ctypes.CDLL:
    """Compile ``sources`` (file names under ``csrc/``) with nvcc into one
    shared library, unless a build of the same sources, ``headers`` (the
    files under ``csrc/`` they include, hashed but not compiled on their
    own) and flags exists, and load it.  Raises RuntimeError with nvcc's
    output when the build fails."""
    return ctypes.CDLL(str(build_shared(
        name, _nvcc, NVCC_FLAGS, [CSRC_DIR / s for s in sources],
        [CSRC_DIR / h for h in headers])))
