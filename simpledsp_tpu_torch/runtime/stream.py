"""Host-side streaming runtime: ctypes bindings to the native C++ library.

Port of ``simpledsp_tpu/runtime/stream.py``.  The compute path runs on the
card; this module is the host half of the pipeline: a lock-free SPSC ring
buffer, SDR sample-format converters that deinterleave IQ bytes straight
into the (re, im) float32 planes the device path consumes, and background
file reader and writer threads, so Python never loops over samples.

The shared library is built at first use from ``native/sdsp_io.cpp`` with
g++ and the flags of ``native/Makefile``, into the port's own ``build/``
(``kernels/_build.build_shared``), never into ``native/build``.  Its name
carries a hash of the source, the flags and the target that
``-march=native`` resolves to, so a checkout copied to another host builds
anew.  There is no Python fallback: a failed build raises with g++'s
output.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from simpledsp_tpu_torch.kernels import _build

__all__ = ["RingBuffer", "FileSource", "FileSink", "iq16_to_planes",
           "iqu8_to_planes", "i16_to_f32", "f32_to_i16", "load_library"]

SOURCE = Path(__file__).resolve().parents[2] / "native" / "sdsp_io.cpp"
GXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-Wall", "-Wextra", "-fPIC",
             "-shared", "-pthread")

_lib = None
_lib_lock = threading.Lock()


def _gxx() -> str:
    found = shutil.which("g++")
    if not found:
        raise RuntimeError("g++ not found on PATH; the native IO library is "
                           "built from native/sdsp_io.cpp at first use")
    return found


def _target() -> bytes:
    """What ``-march=native`` means on this host, for the library's hash."""
    proc = subprocess.run([_gxx(), "-march=native", "-Q", "--help=target"],
                          capture_output=True, timeout=60)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ -march=native -Q --help=target failed:\n"
                           f"{proc.stderr.decode(errors='replace')}")
    return proc.stdout


def load_library() -> ctypes.CDLL:
    """Load the native IO library, building it first if needed."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(_build.build_shared(
            "sdsp_io", _gxx, GXX_FLAGS, [SOURCE], salt=_target())))

        lib.sdsp_ring_create.restype = ctypes.c_void_p
        lib.sdsp_ring_create.argtypes = [ctypes.c_size_t]
        lib.sdsp_ring_destroy.restype = None
        lib.sdsp_ring_destroy.argtypes = [ctypes.c_void_p]
        for fn in ("sdsp_ring_capacity", "sdsp_ring_readable",
                   "sdsp_ring_writable"):
            getattr(lib, fn).restype = ctypes.c_size_t
            getattr(lib, fn).argtypes = [ctypes.c_void_p]
        for fn in ("sdsp_ring_push", "sdsp_ring_pop"):
            getattr(lib, fn).restype = ctypes.c_size_t
            getattr(lib, fn).argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                         ctypes.c_size_t]

        planes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                  ctypes.c_size_t, ctypes.c_float, ctypes.c_int]
        flat = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
                ctypes.c_float, ctypes.c_int]
        for fn, args in (("sdsp_cvt_iq16_planes_mt", planes),
                         ("sdsp_cvt_iqu8_planes_mt", planes),
                         ("sdsp_cvt_i16_f32_mt", flat),
                         ("sdsp_cvt_f32_i16_mt", flat)):
            getattr(lib, fn).restype = None
            getattr(lib, fn).argtypes = args

        for kind in ("source", "sink"):
            start = getattr(lib, f"sdsp_file_{kind}_start")
            start.restype = ctypes.c_void_p
            start.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                              ctypes.c_size_t]
            state = getattr(lib, f"sdsp_file_{kind}_state")
            state.restype = ctypes.c_int
            state.argtypes = [ctypes.c_void_p]
            getattr(lib, f"sdsp_file_{kind}_stop").argtypes = [ctypes.c_void_p]
        lib.sdsp_file_source_stop.restype = None
        lib.sdsp_file_sink_written.restype = ctypes.c_uint64
        lib.sdsp_file_sink_written.argtypes = [ctypes.c_void_p]
        lib.sdsp_file_sink_stop.restype = ctypes.c_uint64

        u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        lib.sdsp_mls.restype = None
        lib.sdsp_mls.argtypes = [
            ctypes.c_int32, np.ctypeslib.ndpointer(np.int32,
                                                   flags="C_CONTIGUOUS"),
            ctypes.c_int32, u8, u8, ctypes.c_int64, u8]

        _lib = lib
        return lib


def _as_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


class RingBuffer:
    """Lock-free SPSC byte ring buffer (native).  Capacity rounds up to a
    power of two.  ``push`` / ``pop`` do not block and return counts;
    ``pop_exact`` waits, up to a timeout, until a whole block is there: the
    consumer interface of a pipeline with a fixed block size."""

    def __init__(self, capacity: int):
        self._lib = load_library()
        self._h = self._lib.sdsp_ring_create(capacity)
        if not self._h:
            raise MemoryError("ring allocation failed")
        self._pending = b""  # partial-element remainder from short pops

    def close(self):
        if self._h:
            self._lib.sdsp_ring_destroy(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass

    @property
    def capacity(self) -> int:
        return self._lib.sdsp_ring_capacity(self._h)

    @property
    def readable(self) -> int:
        return self._lib.sdsp_ring_readable(self._h)

    def push(self, data: np.ndarray) -> int:
        data = np.ascontiguousarray(data)
        return self._lib.sdsp_ring_push(self._h, _as_ptr(data), data.nbytes)

    def pop(self, nbytes: int, dtype=np.uint8) -> np.ndarray:
        """Pop up to ``nbytes`` without waiting.  Returns whole ``dtype``
        elements only; a partial element from a short read is kept and
        returned by the next pop (no data loss)."""
        itemsize = np.dtype(dtype).itemsize
        out = np.empty(nbytes, dtype=np.uint8)
        got = self._lib.sdsp_ring_pop(self._h, _as_ptr(out), nbytes)
        buf = self._pending + out[:got].tobytes()
        keep = len(buf) - len(buf) % itemsize
        self._pending = buf[keep:]
        return np.frombuffer(buf[:keep], dtype=dtype)

    def pop_exact(self, nbytes: int, dtype=np.uint8, timeout: float = 10.0,
                  poll: float = 0.0005) -> Optional[np.ndarray]:
        """Wait until ``nbytes`` are there and return them, or None after
        ``timeout`` seconds.

        Bytes a previous :meth:`pop` kept are returned first, and on a
        timeout the bytes read so far go back to the head of the stream,
        so mixing pop and pop_exact never skips or reorders bytes."""
        out = np.empty(nbytes, dtype=np.uint8)
        filled = min(len(self._pending), nbytes)
        if filled:
            out[:filled] = np.frombuffer(self._pending[:filled],
                                         dtype=np.uint8)
            self._pending = self._pending[filled:]
        deadline = time.monotonic() + timeout
        ptr_base = out.ctypes.data
        while filled < nbytes:
            got = self._lib.sdsp_ring_pop(
                self._h, ctypes.c_void_p(ptr_base + filled), nbytes - filled)
            filled += got
            if filled < nbytes:
                if time.monotonic() > deadline:
                    self._pending = out[:filled].tobytes() + self._pending
                    return None
                if got == 0:
                    time.sleep(poll)
        return out.view(dtype)


class FileSource:
    """Background native thread streaming a file into a RingBuffer."""

    RUNNING, EOF, STOPPED, ERROR = 0, 1, 2, 3

    def __init__(self, path: os.PathLike, ring: RingBuffer,
                 chunk: int = 1 << 16):
        self._lib = load_library()
        self.ring = ring
        self._h = self._lib.sdsp_file_source_start(
            str(path).encode(), ring._h, chunk)
        if not self._h:
            raise FileNotFoundError(path)

    @property
    def state(self) -> int:
        return self._lib.sdsp_file_source_state(self._h)

    def stop(self):
        if self._h:
            self._lib.sdsp_file_source_stop(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()


class FileSink:
    """Background native thread draining a RingBuffer into a file, the
    output mirror of :class:`FileSource`.  ``stop()`` drains what is left
    in the ring before closing, so "push then stop" never loses bytes; it
    returns the bytes written in all."""

    RUNNING, ERROR = 0, 3

    def __init__(self, path: os.PathLike, ring: RingBuffer,
                 chunk: int = 1 << 16):
        self._lib = load_library()
        self.ring = ring
        self._h = self._lib.sdsp_file_sink_start(
            str(path).encode(), ring._h, chunk)
        if not self._h:
            raise OSError(f"cannot open {path} for writing")

    @property
    def state(self) -> int:
        return self._lib.sdsp_file_sink_state(self._h)

    @property
    def written(self) -> int:
        return self._lib.sdsp_file_sink_written(self._h)

    def stop(self) -> int:
        if not self._h:
            return 0
        total = self._lib.sdsp_file_sink_stop(self._h)
        self._h = None
        return total

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()


def iq16_to_planes(raw: np.ndarray, scale: float = 1.0 / 32768.0, *,
                   threads: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Interleaved int16 IQ -> (re, im) float32 planes (native, fork-join
    threads for large blocks; ``threads=0`` picks the count, ``1`` is
    serial)."""
    raw = np.ascontiguousarray(raw, dtype=np.int16)
    npairs = raw.size // 2
    re = np.empty(npairs, dtype=np.float32)
    im = np.empty(npairs, dtype=np.float32)
    load_library().sdsp_cvt_iq16_planes_mt(_as_ptr(raw), _as_ptr(re),
                                           _as_ptr(im), npairs, scale,
                                           threads)
    return re, im


def iqu8_to_planes(raw: np.ndarray, scale: float = 1.0 / 127.5, *,
                   threads: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Interleaved uint8 IQ (RTL-SDR convention) -> (re, im) float32
    planes."""
    raw = np.ascontiguousarray(raw, dtype=np.uint8)
    npairs = raw.size // 2
    re = np.empty(npairs, dtype=np.float32)
    im = np.empty(npairs, dtype=np.float32)
    load_library().sdsp_cvt_iqu8_planes_mt(_as_ptr(raw), _as_ptr(re),
                                           _as_ptr(im), npairs, scale,
                                           threads)
    return re, im


def i16_to_f32(raw: np.ndarray, scale: float = 1.0 / 32768.0, *,
               threads: int = 0) -> np.ndarray:
    raw = np.ascontiguousarray(raw, dtype=np.int16)
    out = np.empty(raw.size, dtype=np.float32)
    load_library().sdsp_cvt_i16_f32_mt(_as_ptr(raw), _as_ptr(out), raw.size,
                                       scale, threads)
    return out


def f32_to_i16(x: np.ndarray, scale: float = 32767.0, *,
               threads: int = 0) -> np.ndarray:
    x = np.ascontiguousarray(x, dtype=np.float32)
    out = np.empty(x.size, dtype=np.int16)
    load_library().sdsp_cvt_f32_i16_mt(_as_ptr(x), _as_ptr(out), x.size,
                                       scale, threads)
    return out
