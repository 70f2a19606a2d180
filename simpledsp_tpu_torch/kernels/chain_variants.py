"""The half-spectrum chain's layouts other than "reg" / "k1".

Port of ``simpledsp_tpu/kernels/chain_variants.py``: the TPU layouts of the
packed half-spectrum chain kernel, measured and rejected on the TPU, each
with a Hopper counterpart here so that the card can measure them against
the chain kernel.  Every layout computes the function of
:func:`simpledsp_tpu_torch.kernels.chain.chain_frames_reference`; they differ
in scheduling only, so that is their plain version, with one exception:
"regs", whose step 1 is the exact split-bf16 product
(:func:`chain_frames_regs_reference`).

- "regs": step 1 as bf16 x bf16 -> fp32 tensor-core products of three-way
  split factors (``csrc/chain_tc.cu``), float32 only.
- "reg2" / "reg4" / "regp" / "pair": the chain kernel
  (``chain.cu`` ``chain_natural_kernel``) with the layout's g frames a CUDA
  block, their rows stacked.  The TPU variants fed a block-diagonal step-1
  table to the matrix unit; here the group is only the block's frames.  g
  as the JAX package resolves it, then halved until the block fits
  (:func:`group_frames`).
- "regw" / "fmajor": the chain kernel with another store, its planes
  staged in shared memory: 16-byte stores of the natural-order planes, or
  each frame's (n1, n2/2) rows k1-major (the caller transposes, as the JAX
  package does outside its kernel).

Each kernel launches through a wrapper with a ``launches`` count; on CPU
tensors the wrappers run the plain version, and there is no fallback from
a kernel to its plain version.  Nothing here imports JAX: ``_bf16_split3``
is this package's own, bit for bit the JAX package's.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from simpledsp_tpu_torch.kernels import _build
from simpledsp_tpu_torch.kernels import chain as _chain
from simpledsp_tpu_torch.kernels.chain import ChainTables
from simpledsp_tpu_torch.ops.fft import _dft_mats_f64
from simpledsp_tpu_torch.precision import ieee_fp32

__all__ = ["chain_frames_grouped", "chain_frames_regs",
           "chain_frames_regs_reference", "chain_frames_store",
           "chain_grouped_kernel", "chain_regs_kernel", "chain_store_kernel",
           "group_frames"]

def _bf16_round(a: np.ndarray) -> np.ndarray:
    """float64 -> bfloat16 as the JAX package casts (ml_dtypes): rounded to
    float32 first, then to bfloat16, each to nearest, ties to even;
    returned as float64.  The two roundings are kept on purpose: a single
    rounding differs just above a bfloat16 tie, where the float32 step
    lands on the tie (seen on near-tie values against ml_dtypes 0.5.4).
    Exact for float32's normal range and zero."""
    u = np.ascontiguousarray(a, dtype=np.float64).astype(np.float32).view(
        np.uint32)
    lsb = (u >> np.uint32(16)) & np.uint32(1)
    r = (u + np.uint32(0x7FFF) + lsb) & np.uint32(0xFFFF0000)
    return r.view(np.float32).astype(np.float64)


def _bf16_split3(a: np.ndarray) -> np.ndarray:
    """Exact 3-way bf16 decomposition of a float64 table, a = h + m + l with
    each part a bfloat16 value, stacked as the JAX package stacks it:
    [h h h; m m m; l l l] (each part tiled three times along axis 1).
    Returned as float64 holding the bfloat16 values."""
    h = _bf16_round(a)
    r1 = a - h
    m = _bf16_round(r1)
    low = _bf16_round(r1 - m)
    return np.concatenate([np.tile(p, (1, 3)) for p in (h, m, low)], axis=0)


def _regw_qf(n1: int, n2h: int) -> int:
    """Largest lane-packing factor: qf*n1 <= 128, qf divides n2h."""
    qf = max(1, 128 // n1)
    while qf > 1 and n2h % qf:
        qf -= 1
    return qf


def group_frames(layout: str, n1: int, n2: int, r: int, d: int) -> int:
    """Frames a block for a grouped layout, as the JAX package resolves
    them from its tile of r frames (``chain.py:755-762``): "reg2" 2, "reg4"
    4, "regp" 128 // n1, each halved until it divides r; "pair" 2 where r
    is even, else 1.  Then halved until the chain kernel's block fits
    (``chain._natural_fits``: shared memory, and at most 8192 FFT values)."""
    if layout in ("reg2", "reg4"):
        g = int(layout[3:])
    elif layout == "regp":
        g = max(1, 128 // n1)
    elif layout == "pair":
        g = 2 if r % 2 == 0 else 1
    else:
        raise ValueError(f"{layout!r} is not a grouped layout")
    while g > 1 and r % g:
        g //= 2
    while g > 1 and not _chain._natural_fits(n1, n2, d, g):
        g //= 2
    return g


@functools.lru_cache(maxsize=None)
def _w1_split3(n1: int) -> np.ndarray:
    """The step-1 table [W1c; W1s] split from its float64 values: (3, 2 n1,
    n1), the h, m and l parts, as float64."""
    w1c, w1s = _dft_mats_f64(n1)
    parts = _bf16_split3(np.concatenate([w1c, w1s], axis=0))
    return parts.reshape(3, 2 * n1, 3 * n1)[:, :, :n1].copy()


def _split3(v: torch.Tensor):
    """Three-way bf16 split of float32 v, as the TPU kernel splits y."""
    vh = v.to(torch.bfloat16).to(v.dtype)
    r1 = v - vh
    vm = r1.to(torch.bfloat16).to(v.dtype)
    return vh, vm, (r1 - vm).to(torch.bfloat16).to(v.dtype)


def chain_frames_regs_reference(x3: torch.Tensor, s3: torch.Tensor,
                                tables: ChainTables
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the "regs" kernel: the chain with step 1 as the
    exact split product.  y and the table are split into three bfloat16
    parts each; the nine products, exact in float32, are summed in float32
    as the JAX kernel sums them (one K-stacked product per table part, the
    three added).  Everything else as :func:`chain_frames_reference`."""
    n1 = x3.shape[1]
    y = _chain._iir_block(x3, s3, tables)
    y3 = torch.cat(_split3(y), dim=1)                       # (F, 3 n1, n2)
    w3 = torch.as_tensor(_w1_split3(n1), dtype=y.dtype, device=y.device)
    with ieee_fp32():
        cs3 = [torch.einsum("kp,fpt->fkt", w.repeat(1, 3), y3) for w in w3]
    cs = cs3[0] + cs3[1] + cs3[2]
    return _chain._packed_spectrum(*_chain._twiddled(cs, tables), tables)


@functools.lru_cache(maxsize=None)
def _tc_library() -> ctypes.CDLL:
    """``csrc/chain_tc.cu`` built and loaded, its entry point typed."""
    lib = _build.load_library("sdsp_chain_tc", ("chain_tc.cu",),
                              ("chain_common.cuh",))
    fn = lib.sdsp_chain_regs_f32
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


class _RegsKernel:
    """The tensor-core chain kernel (``csrc/chain_tc.cu``); ``launches``
    counts its launches."""

    def __init__(self):
        self.launches = 0
        self._w3 = {}

    def library(self) -> ctypes.CDLL:
        return _tc_library()

    def split_table(self, n1: int, device: torch.device) -> torch.Tensor:
        """The kernel's (3, 2 n1p, K16) bfloat16 step-1 table: the parts of
        :func:`_w1_split3`, cos rows at 0, sin rows at n1p, zero-padded."""
        key = (n1, device)
        if key not in self._w3:
            n1p = -(-n1 // 8) * 8
            k16 = -(-n1p // 16) * 16
            w = np.zeros((3, 2 * n1p, k16))
            parts = _w1_split3(n1)
            w[:, :n1, :n1] = parts[:, :n1]
            w[:, n1p:n1p + n1, :n1] = parts[:, n1:]
            self._w3[key] = torch.as_tensor(w, dtype=torch.float32).to(
                device=device, dtype=torch.bfloat16)
        return self._w3[key]

    def __call__(self, x3: torch.Tensor, s3: torch.Tensor,
                 tables: ChainTables) -> Tuple[torch.Tensor, torch.Tensor]:
        nf, n1, n2 = x3.shape
        if not _chain.kernel_supports(n1, n2):
            raise ValueError(f"the CUDA regs kernel needs frames of n1 x n2 "
                             f"samples, n1 <= 128 and n2 <= 128 even; got "
                             f"{tuple(x3.shape)}")
        _chain._check_operands(x3, s3, tables, 2 * n2, "regs")
        w3 = self.split_table(n1, x3.device)
        tables = _chain._padded_tables(tables, n1, n2)
        spec_re = torch.empty((nf, n1 * n2 // 2), dtype=x3.dtype,
                              device=x3.device)
        spec_im = torch.empty_like(spec_re)
        rc = self.library().sdsp_chain_regs_f32(
            x3.data_ptr(), s3.data_ptr(), tables.HT.data_ptr(),
            tables.PhiT.data_ptr(), w3.data_ptr(), tables.Tc.data_ptr(),
            tables.Ts.data_ptr(), tables.PQT.data_ptr(), spec_re.data_ptr(),
            spec_im.data_ptr(), nf, n1, n2, s3.shape[1], x3.device.index,
            _chain._stream(x3))
        if rc != 0:
            raise RuntimeError(f"regs kernel launch failed: CUDA error {rc}")
        self.launches += 1
        return spec_re, spec_im


class _GroupedKernel:
    """The chain kernel (``chain_natural_kernel`` in ``csrc/chain.cu``) with
    the caller's g frames a block; ``launches`` counts its launches and
    ``last_g`` holds the frames a block of the last launch."""

    def __init__(self):
        self.launches = 0
        self.last_g = None

    def library(self) -> ctypes.CDLL:
        return _chain._library()

    def __call__(self, x3: torch.Tensor, s3: torch.Tensor,
                 tables: ChainTables, g: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        if g < 1:
            raise ValueError(f"{g} frames of {x3.shape[1]} rows do not fit "
                             f"a block")
        out = _chain._launch_natural(self.library, x3, s3, tables,
                                     "natural", g)
        self.launches += 1
        self.last_g = g
        return out


chain_regs_kernel = _RegsKernel()
chain_grouped_kernel = _GroupedKernel()
chain_store_kernel = _chain._ChainKernel("wide", "fmajor")


def chain_frames_regs(x3: torch.Tensor, s3: torch.Tensor, tables: ChainTables
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Layout "regs": the tensor-core kernel on CUDA tensors, its plain
    version on CPU tensors.  (F, N/2) natural-order planes."""
    return _chain._on_device(x3, chain_regs_kernel,
                             chain_frames_regs_reference, x3, s3, tables)


def chain_frames_grouped(x3: torch.Tensor, s3: torch.Tensor,
                         tables: ChainTables, g: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Layouts "reg2" / "reg4" / "regp" / "pair": the chain kernel with g
    frames a block on CUDA tensors, the plain version on CPU tensors.
    (F, N/2) natural-order planes."""
    return _chain._on_device(
        x3, lambda: chain_grouped_kernel(x3, s3, tables, g),
        lambda: _chain.chain_frames_reference(x3, s3, tables))


def _fmajor_reference(x3: torch.Tensor, s3: torch.Tensor,
                      tables: ChainTables) -> Tuple[torch.Tensor, torch.Tensor]:
    nf, n1, n2 = x3.shape
    return tuple(p.reshape(nf, n2 // 2, n1).transpose(1, 2)
                 for p in _chain.chain_frames_reference(x3, s3, tables))


def chain_frames_store(x3: torch.Tensor, s3: torch.Tensor, tables: ChainTables,
                       mode: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Layouts "regw" (mode "wide": (F, N/2) natural-order planes) and
    "fmajor" (mode "fmajor": (F, n1, n2/2) rows, k1-major): the chain kernel
    with that store on CUDA tensors, the plain version on CPU tensors."""
    if mode not in ("wide", "fmajor"):
        raise ValueError(f"unknown store {mode!r}")
    reference = (_fmajor_reference if mode == "fmajor"
                 else _chain.chain_frames_reference)
    return _chain._on_device(
        x3, lambda: chain_store_kernel(x3, s3, tables, mode),
        lambda: reference(x3, s3, tables))
