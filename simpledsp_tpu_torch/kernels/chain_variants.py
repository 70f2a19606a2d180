"""The half-spectrum chain's layouts other than "reg" / "k1".

Port of ``simpledsp_tpu/kernels/chain_variants.py``: the TPU layouts of the
packed half-spectrum chain kernel, measured and rejected on the TPU, each
with a Hopper counterpart here so that the card can measure them against
the chain kernel.  Every layout computes the function of
:func:`simpledsp_tpu_torch.kernels.chain.chain_frames_reference`; they differ
in scheduling only, so that is their plain version, with one exception:
"regs", whose IIR block is the exact split-bf16 product
(:func:`chain_frames_regs_reference`).

- "regs": the chain kernel (``chain_natural_kernel``, built as
  ``csrc/chain_tc.cu``) with its IIR block y = [x | starts^T] [H^T; Phi^T]
  as bf16 x bf16 -> fp32 tensor-core products of three-way split factors,
  float32 only.  The JAX variant split step 1 of its four-step FFT, its
  matrix unit's product; on the FFT core the IIR block is the one product
  left, so that is what is split here.
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
import weakref
from typing import Tuple

import numpy as np
import torch

from simpledsp_tpu_torch.kernels import _build
from simpledsp_tpu_torch.kernels import chain as _chain
from simpledsp_tpu_torch.kernels.chain import ChainTables
from simpledsp_tpu_torch.kernels.fft import _kernel_tables
from simpledsp_tpu_torch.precision import ieee_fp32
from simpledsp_tpu_torch.utils import tracing

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


def iir_split3(ht: np.ndarray, phit: np.ndarray) -> np.ndarray:
    """The "regs" IIR block's table T = [H^T; Phi^T] ((n2 + D, n2), float64)
    as its three bfloat16 parts split from the float64 values
    (:func:`_bf16_split3`): (3, n2 + D, n2) float64 holding bfloat16
    values, h + m + l = T within 2^-24 |T| entry by entry."""
    t = np.concatenate([ht, phit], axis=0)
    k, n2 = t.shape
    return _bf16_split3(t).reshape(3, k, 3 * n2)[:, :, :n2].copy()


def _split3(v: torch.Tensor):
    """Three-way bf16 split of float32 v, as the kernel splits its operand:
    v_h, v_m, v_l, each the bfloat16 rounding (nearest, ties to even) of
    what the parts before it leave, held as float32."""
    vh = v.to(torch.bfloat16).to(v.dtype)
    r1 = v - vh
    vm = r1.to(torch.bfloat16).to(v.dtype)
    return vh, vm, (r1 - vm).to(torch.bfloat16).to(v.dtype)


def _split_operands(x3: torch.Tensor, s3: torch.Tensor):
    """A = [x | starts^T] (F, n1, n2 + D), the IIR block's left operand, as
    its three bfloat16 parts (:func:`_split3`)."""
    return _split3(torch.cat([x3, s3.transpose(1, 2)], dim=2))


def _split_iir_block(x3: torch.Tensor, s3: torch.Tensor,
                     t3: torch.Tensor) -> torch.Tensor:
    """The "regs" IIR block y = A T as exact split products: A's three
    bfloat16 parts against the table's (t3), the nine products exact in
    float32 and summed in float32, as the JAX kernel sums its split step 1:
    one K-stacked product per table part, the three added (h + m) + l."""
    a3 = torch.cat(_split_operands(x3, s3), dim=2)           # (F, n1, 3 K)
    with ieee_fp32():
        parts = [a3 @ t.repeat(3, 1) for t in t3]
    return (parts[0] + parts[1]) + parts[2]


def chain_frames_regs_reference(x3: torch.Tensor, s3: torch.Tensor,
                                tables: ChainTables
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the "regs" kernel: the chain with its IIR block as
    the exact split product (:func:`_split_iir_block` of ``tables.T3``),
    everything after it as :func:`chain_frames_reference`."""
    y = _split_iir_block(x3, s3, tables.T3)
    return _chain._packed_spectrum(
        *_chain._twiddled(_chain._step1(y, tables), tables), tables)


def _regs_fragments(t3: np.ndarray) -> np.ndarray:
    """The "regs" kernel's table: T's three bfloat16 parts (t3, (3, K0, n2),
    K0 = n2 + D) in ``mma.sync.m16n8k16`` B-fragment order.  T is padded
    with zeros to K = K0 rounded up to 16 rows and 8 ceil(n2 / 8) columns;
    for each N tile nt (columns 8 nt ..) and K step ks (rows 16 ks ..), 192
    words: lane l = 4 gid + tig's (h.b0, h.b1, m.b0, m.b1) at 4 l, then its
    (l.b0, l.b1) at 128 + 2 l, where part p's b0 packs rows 16 ks + 2 tig
    (low half) and + 1 of column 8 nt + gid, and b1 the same 8 rows on.
    Flat uint32, (nt, ks) blocks in order."""
    _, k0, n2 = t3.shape
    kp = -(-k0 // 16) * 16
    ntiles, ksteps = -(-n2 // 8), kp // 16
    b = np.zeros((3, kp, 8 * ntiles), np.float32)
    b[:, :k0, :n2] = t3
    u = b.view(np.uint32)
    if (u & np.uint32(0xFFFF)).any():
        raise ValueError("T3 holds values that are not bfloat16")
    bits = u >> np.uint32(16)
    lane = np.arange(32)
    n = 8 * np.arange(ntiles)[:, None, None] + (lane >> 2)      # (NT, 1, 32)
    k = 16 * np.arange(ksteps)[None, :, None] + 2 * (lane & 3)  # (1, KS, 32)

    def reg(p, kk):
        return bits[p, kk, n] | (bits[p, kk + 1, n] << np.uint32(16))

    hm = np.stack([reg(0, k), reg(0, k + 8), reg(1, k), reg(1, k + 8)], -1)
    lo = np.stack([reg(2, k), reg(2, k + 8)], -1)
    words = np.concatenate([hm.reshape(ntiles, ksteps, 128),
                            lo.reshape(ntiles, ksteps, 64)], -1)
    return np.ascontiguousarray(words, dtype=np.uint32).reshape(-1)


def _regs_smem_bytes(n1: int, n2: int, d: int) -> int:
    """Shared memory of a block of the "regs" kernel (``split_smem_bytes``
    in ``csrc/chain_natural.cuh``): the kernel's own g frames, their rows
    rounded up to 16; A's three bfloat16 planes at a row stride of
    (n2 + d rounded up to 16) + 8, and y at 132 floats a row."""
    rows = -(-_chain._natural_frames(n1, n2) * n1 // 16) * 16
    lda = -(-(n2 + d) // 16) * 16 + 8
    return 6 * rows * lda + 4 * rows * 132


# id -> (weak reference, version, device table) of each T3 the kernel took:
# the table is built, and H^T's triangle checked, once a tensor and version.
_FRAGMENTS = {}


def _fragments_on(t3: torch.Tensor) -> torch.Tensor:
    """:func:`_regs_fragments` of ``t3`` on its device (int32 words).
    Raises ValueError unless t3's H^T rows are upper-triangular (H
    lower-triangular): the kernel skips, for each N tile, the K steps of H^T
    after the tile's last column."""
    key = id(t3)
    seen = _FRAGMENTS.get(key)
    if seen is not None and seen[0]() is t3 and seen[1] == t3._version:
        return seen[2]
    h = t3[:, :t3.shape[2]]
    if not torch.equal(h, torch.triu(h)):
        raise ValueError("T3: the CUDA regs kernel needs H^T upper-triangular "
                         "(H lower-triangular)")
    words = _regs_fragments(t3.detach().cpu().numpy())
    table = torch.as_tensor(words.view(np.int32), device=t3.device)
    _FRAGMENTS[key] = (weakref.ref(t3, lambda _, key=key: _FRAGMENTS.pop(
        key, None)), t3._version, table)
    return table


@functools.lru_cache(maxsize=None)
def _tc_library() -> ctypes.CDLL:
    """``csrc/chain_tc.cu`` built and loaded, its entry point typed."""
    lib = _build.load_library("sdsp_chain_tc", ("chain_tc.cu",),
                              _chain._HEADERS)
    fn = lib.sdsp_chain_regs_f32
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


class _RegsKernel:
    """The "regs" form of the chain kernel (``csrc/chain_tc.cu``: the IIR
    block as split-bf16 products on the tensor cores); ``launches`` counts
    its launches."""

    launches = tracing.Launches()

    def __init__(self):
        self.launch_counter = tracing.kernel_counter("chain_regs")

    def library(self) -> ctypes.CDLL:
        return _tc_library()

    def __call__(self, x3: torch.Tensor, s3: torch.Tensor,
                 tables: ChainTables) -> Tuple[torch.Tensor, torch.Tensor]:
        """(F, N/2) natural-order planes.  Checks every operand, and that a
        block fits, before ``library()`` builds or loads the kernel."""
        nf, n1, n2 = x3.shape
        if not _chain.kernel_supports(n1, n2):
            raise ValueError(f"the CUDA regs kernel needs frames of n1 x n2 "
                             f"samples, n1 <= 128 and n2 <= 128 even; got "
                             f"{tuple(x3.shape)}")
        _chain._check_operands(x3, s3, tables, "regs", split=True)
        d = s3.shape[1]
        if _regs_smem_bytes(n1, n2, d) > _chain._MAX_SMEM:
            raise ValueError(f"frames of {n1} x {n2} samples with a state of "
                             f"{d} do not fit a block")
        tc = _fragments_on(tables.T3)
        n = n1 * n2
        tab, plan, npass = _kernel_tables(n // 2, x3.device)
        split = _chain._split_table(n, x3.device)
        spec_re = torch.empty((nf, n // 2), dtype=x3.dtype, device=x3.device)
        spec_im = torch.empty_like(spec_re)
        rc = self.library().sdsp_chain_regs_f32(
            x3.data_ptr(), s3.data_ptr(), tc.data_ptr(),
            ctypes.cast(plan, ctypes.c_void_p), npass, tab.data_ptr(),
            split.data_ptr(), spec_re.data_ptr(), spec_im.data_ptr(), nf, n1,
            n2, d, x3.device.index, _chain._stream(x3))
        if rc != 0:
            raise RuntimeError(f"regs kernel launch failed: CUDA error {rc}")
        self.launches += 1
        return spec_re, spec_im


class _GroupedKernel:
    """The chain kernel (``chain_natural_kernel`` in ``csrc/chain.cu``) with
    the caller's g frames a block; ``launches`` counts its launches and
    ``last_g`` holds the frames a block of the last launch."""

    launches = tracing.Launches()

    def __init__(self):
        self.launch_counter = tracing.kernel_counter("chain_grouped")
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
