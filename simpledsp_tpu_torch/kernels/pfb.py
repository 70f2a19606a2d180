"""Fused polyphase filter-bank receiver kernels: channelize -> demod ->
decimate in one pass.

Port of ``simpledsp_tpu/kernels/pfb.py``.  Per output frame n and channel c
(the math of ``ops/channelizer.py``, with the branch flip folded into the
tables as in the JAX package):

    u[n, m]  = sum_{j<K} taps_t[m, j] x[n + K-1-j, m]       branch FIR
    y[c, n]  = sum_m (wfc + i wfs)[c, m] u[n, m]             inverse DFT
    FM       d[n] = gain * atan2(Im q, Re q), q = y[n] conj(y[n-1])
    AM       d[n] = |y[n]|
    decim    audio[t] = sum_{j<kd} h[j] ext[kd-1 + t decim - j],
             ext = [ahist (kd-1) | d]

where frame f of a stream is its samples [f M, (f+1) M) of the
history-prefixed input.  Two input layouts, as in the JAX package:

- flat (``pfb_fm_flat``, ``pfb_am_flat``, what the receiver banks run):
  the stream in two sources, the carried history's (B, h) planes and the
  call's (B, T) planes that follow it, each read in place at its own row
  stride (``hist=``); element j of the stream is ``hist[j]`` below h and
  ``x[j - h]`` past it, and no prefixed plane is made.  Given (B, W)
  history-prefixed planes instead (as the JAX package's callers pass
  them), the entries take their first M K - 1 samples as the history and
  the rest as x: views of the same buffer, the same launch;
- frames (``pfb_fm_frames``, ``pfb_am_frames``, ``pfb_channelize_frames``):
  channel-major (B, M, nfr) planes (``PFBChannelizer.frames_t``).

The kernel is ``csrc/pfb.cu``: the public entries launch it for CUDA
tensors (``pfb_flat_kernel`` / ``pfb_frames_kernel`` count the launches)
and run the plain versions :func:`pfb_flat_reference` /
:func:`pfb_frames_reference` for CPU tensors.  There is no fallback from
the kernel to the plain version.  The kernel computes the inverse DFT as a
radix-2 FFT across branches and the decimator by phase, from host tables
built here beside the operators: :func:`fft_order` (which row feeds each
FFT input, which channel each output holds), :func:`fft_twiddles_f64` and
:func:`decimator_phase_index`.

The JAX kernels' Mosaic-only machinery has no counterpart: no in-register
re-layout of 128-sample rows, no stream packing (``packed_tables`` is kept
as a host table only), no 128-lane halo or 8-row rounding, no polynomial
atan2 (the kernel calls ``atan2f``, the plain version ``torch.atan2``).
The flat layout's padded width is the JAX package's interpret-mode width
(:func:`flat_pad_to`); the tail past the last frame a kernel reads is never
read.
"""

from __future__ import annotations

import ctypes
import functools
import math
import weakref
from typing import NamedTuple, Optional

import numpy as np
import torch

from simpledsp_tpu_torch.kernels import _build
from simpledsp_tpu_torch.precision import ieee_fp32
from simpledsp_tpu_torch.utils import tracing

__all__ = ["PFBOperators", "PFBTables", "decimator_phase_index",
           "fft_order", "fft_twiddles_f64", "flat_pad_to", "kernel_supports",
           "pfb_flat_reference", "pfb_frames_reference", "pfb_flat_kernel",
           "pfb_frames_kernel", "pfb_fm_flat", "pfb_am_flat", "pfb_fm_frames",
           "pfb_am_frames", "pfb_channelize_frames"]

MODES = ("fm", "fm_dec", "am", "am_dec", "chan")
_MODE_ID = {name: i for i, name in enumerate(MODES)}
_SUM_CHUNK = 16          # frames per emit_sum partial (csrc/pfb.cu)
_SMEM_TARGET = 113 << 10  # two blocks per SM (228 KB, 1 KB reserved each)
_SMEM_MAX = 227 << 10     # one block per SM (H100)
_TILE_TOP = 1024          # default tile: at most this many output frames


def kernel_supports(m: int, k: int) -> bool:
    """(M, K) the CUDA kernel takes: what the JAX flat kernel compiles,
    M | 128 (M <= 128) and K up to 32 taps per branch."""
    return 1 <= m <= 128 and 128 % m == 0 and 1 <= k <= 32


class PFBTables(NamedTuple):
    """The operators as tensors on one device: the plain version reads the
    first three, the kernel the last three (``csrc/pfb.cu``)."""

    taps_t: torch.Tensor    # (M, K)
    wfc: torch.Tensor       # (M, M) [c, m]
    wfs: torch.Tensor       # (M, M)
    fir_taps: torch.Tensor  # (K, M) [j, e]: taps_t[order[0, e], j]
    order: torch.Tensor     # (2, M) int32: FFT input e's row, output e's channel
    fft_tw: torch.Tensor    # (log2 M, M, 2): FFT stage twiddles (re, im)


def fft_order(m: int) -> np.ndarray:
    """The kernel's FFT orders, (2, M) int: row ``order[0, e]`` of the frame
    (its branch M-1-row; the flip of ``wfc`` / ``wfs``) feeds FFT input e,
    and output position e holds channel ``order[1, e]`` = bitrev(e)."""
    lg = m.bit_length() - 1
    e = np.arange(m)
    rev = np.zeros(m, dtype=np.int64)
    for bit in range(lg):
        rev |= ((e >> bit) & 1) << (lg - 1 - bit)
    return np.stack([m - 1 - e, rev])


def fft_twiddles_f64(m: int) -> np.ndarray:
    """The kernel's inverse-FFT twiddles, (log2 M, M, 2) float64 (re, im).
    Stage s has half size h = M >> (s + 1); position e with e & h (the
    bottom of its pair) holds exp(+2 pi i (e mod h) / 2h), the phase an
    exact integer (e mod h) M / 2h mod M before the one trig evaluation;
    the top holds 1."""
    lg = m.bit_length() - 1
    e = np.arange(m, dtype=np.int64)
    tw = np.zeros((lg, m, 2))
    tw[..., 0] = 1.0
    for s in range(lg):
        h = m >> (s + 1)
        bot = (e & h) != 0
        ph = ((e % h) * (m // (2 * h))) % m
        ang = 2.0 * np.pi * ph[bot] / m
        tw[s, bot, 0] = np.cos(ang)
        tw[s, bot, 1] = np.sin(ang)
    return tw


def decimator_phase_index(kd: int, decim: int) -> np.ndarray:
    """The kernel's per-phase decimator taps as indices into h (kd,):
    (decim, ceil(kd / decim) rounded up to 4, for 16-byte rows) int,
    [ph, o] = kd-1 - ph - decim o, or -1 where phase ph has no o-th tap.
    Output t sums, phase by phase, h[idx[ph, o]] d[(t + o) decim + ph]."""
    nph = -(-(-(-kd // decim)) // 4) * 4
    ph = np.arange(decim)[:, None]
    o = np.arange(nph)[None, :]
    idx = kd - 1 - ph - decim * o
    return np.where(idx >= 0, idx, -1)


class PFBOperators:
    """Host-precomputed tables for one (M, K) prototype filter, in the
    kernel's flipped-row layout: the JAX package's tables, built by the
    same float64 code and cast to ``dtype``."""

    def __init__(self, branch_taps: np.ndarray, dtype=torch.float32):
        branch = np.asarray(branch_taps, dtype=np.float64)  # (M, K)
        m = branch.shape[0]
        npdt = torch.empty((), dtype=dtype).numpy().dtype
        self.m, self.k = m, branch.shape[1]
        # Row m of the transposed frame is branch M-1-m's lag line.
        self.taps_t = np.ascontiguousarray(branch[::-1]).astype(npdt)
        # Unscaled inverse DFT with the same row flip folded in.
        c = np.arange(m)[:, None]
        r = (m - 1 - np.arange(m))[None, :]
        ang = 2.0 * np.pi * (c * r % m) / m   # exact mod-M phase reduction
        self.wfc = np.cos(ang).astype(npdt)
        self.wfs = np.sin(ang).astype(npdt)
        self.dtype = dtype
        self._packed = {}
        self._tables = {}

    def packed_tables(self, p: int):
        """The JAX kernel's P-stream tables (taps tiled to (P M, K), the
        stacked block-diagonal DFT (2 P M, P M)).  Host tables only: the
        CUDA kernel packs no streams."""
        if p in self._packed:
            return self._packed[p]
        m = self.m
        wc = np.zeros((p * m, p * m), dtype=self.wfc.dtype)
        ws = np.zeros((p * m, p * m), dtype=self.wfs.dtype)
        for q in range(p):
            wc[q * m:(q + 1) * m, q * m:(q + 1) * m] = self.wfc
            ws[q * m:(q + 1) * m, q * m:(q + 1) * m] = self.wfs
        tabs = (np.ascontiguousarray(np.tile(self.taps_t, (p, 1))),
                np.ascontiguousarray(np.concatenate([wc, ws], axis=0)))
        self._packed[p] = tabs
        return tabs

    def tables(self, device=None) -> PFBTables:
        """The tables as ``dtype`` tensors on ``device``, cached."""
        device = torch.device(device if device is not None else "cpu")
        if device not in self._tables:
            def t(a):
                return torch.as_tensor(np.ascontiguousarray(a), device=device)
            order = fft_order(self.m)
            tw = fft_twiddles_f64(self.m).astype(self.taps_t.dtype)
            self._tables[device] = PFBTables(
                t(self.taps_t), t(self.wfc), t(self.wfs),
                t(self.taps_t[order[0]].T), t(order.astype(np.int32)), t(tw))
        return self._tables[device]


def _flat_halo(ops: PFBOperators) -> int:
    if 128 % ops.m:
        raise ValueError(f"flat kernels need M | 128, got {ops.m}")
    return -(-(ops.k - 1) // (128 // ops.m)) * 128


def flat_pad_to(ops: PFBOperators, g: int) -> int:
    """Flat prefixed-stream width (samples) for g output frames: M g plus
    the JAX package's interpret-mode halo of ceil((K-1) / (128/M)) rows of
    128 samples.  The kernels read the first (g + K - 1) M samples."""
    return ops.m * g + _flat_halo(ops)


# -- plain versions ------------------------------------------------------

def _reference(mode, tabs: PFBTables, fr, fi, prev_r, prev_i, ahist, dtaps,
               gain, g, decim, emit_sum):
    """Plain PyTorch body on frame-major (B, g + K - 1, M) planes."""
    dt = fr.dtype
    taps = tabs.taps_t.to(dt)
    k = taps.shape[1]
    ur = ui = None
    for j in range(k):
        lag = k - 1 - j
        tr = taps[:, j] * fr[:, lag:lag + g]
        ti = taps[:, j] * fi[:, lag:lag + g]
        ur = tr if ur is None else ur + tr
        ui = ti if ui is None else ui + ti
    wfc, wfs = tabs.wfc.to(dt), tabs.wfs.to(dt)
    with ieee_fp32():
        yr = (torch.einsum("cm,bgm->bcg", wfc, ur)
              - torch.einsum("cm,bgm->bcg", wfs, ui))
        yi = (torch.einsum("cm,bgm->bcg", wfc, ui)
              + torch.einsum("cm,bgm->bcg", wfs, ur))
    if mode == "chan":
        return yr, yi
    if mode.startswith("fm"):
        sr = torch.cat([prev_r.to(dt), yr[..., :-1]], -1)
        si = torch.cat([prev_i.to(dt), yi[..., :-1]], -1)
        dr = yr * sr + yi * si
        di = yi * sr - yr * si
        sig = torch.atan2(di, dr) * gain
        carry = (yr[..., -1:].contiguous(), yi[..., -1:].contiguous())
    else:
        sig = torch.sqrt(yr * yr + yi * yi)
    if mode == "fm":
        return sig, carry
    if mode == "am":
        return sig
    h = dtaps.to(dt)
    kd = h.numel()
    ext = torch.cat([ahist.to(dt), sig], -1)
    audio = None
    for j in range(kd):
        s = kd - 1 - j
        term = h[j] * ext[..., s:s + g:decim]
        audio = term if audio is None else audio + term
    ahist_out = ext[..., ext.shape[-1] - (kd - 1):].contiguous()
    if mode == "fm_dec":
        return audio, carry, ahist_out
    if emit_sum:
        return audio, ahist_out, sig.sum(-1)
    return audio, ahist_out


def pfb_flat_reference(mode: str, tables: PFBTables, xpr, xpi, prev_r=None,
                       prev_i=None, ahist=None, dec_taps=None, *,
                       gain: float = 1.0, g: int, decim: int = 1,
                       emit_sum: bool = False, hist=None):
    """Plain version of the flat-layout kernel: (B, W) planes, frame f =
    samples [f M, (f+1) M); with ``hist`` = (hist_r, hist_i), (B, h)
    planes that precede them, the stream [hist | x] joined here.  Returns
    what the matching public entry returns."""
    if hist is not None:
        xpr = torch.cat([hist[0], xpr], -1)
        xpi = torch.cat([hist[1], xpi], -1)
    b = xpr.shape[0]
    m, k = tables.taps_t.shape
    nfr = g + k - 1
    return _reference(mode, tables, xpr[:, :nfr * m].reshape(b, nfr, m),
                      xpi[:, :nfr * m].reshape(b, nfr, m), prev_r, prev_i,
                      ahist, dec_taps, gain, g, decim, emit_sum)


def pfb_frames_reference(mode: str, tables: PFBTables, xtr, xti, prev_r=None,
                         prev_i=None, ahist=None, dec_taps=None, *,
                         gain: float = 1.0, g: int, decim: int = 1,
                         emit_sum: bool = False):
    """Plain version of the frames-layout kernel: (B, M, nfr) planes."""
    k = tables.taps_t.shape[1]
    nfr = g + k - 1
    return _reference(mode, tables, xtr[..., :nfr].transpose(1, 2),
                      xti[..., :nfr].transpose(1, 2), prev_r, prev_i, ahist,
                      dec_taps, gain, g, decim, emit_sum)


# -- the CUDA kernel -------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """``csrc/pfb.cu`` built and loaded, its entry points typed."""
    lib = _build.load_library("sdsp_pfb", ("pfb.cu",))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    ll = ctypes.c_longlong
    lib.sdsp_pfb_f32.argtypes = ([i32, i32, vp, vp, ll, ll, vp, vp, ll, i32]
                                 + [vp] * 14 + [i32] * 8
                                 + [ctypes.c_float, i32, vp])
    lib.sdsp_pfb_f32.restype = i32
    lib.sdsp_pfb_smem_bytes.argtypes = [i32] * 6
    lib.sdsp_pfb_smem_bytes.restype = ctypes.c_longlong
    return lib


@functools.lru_cache(maxsize=None)
def _tile(mode: str, m: int, k: int, kd: int, decim: int, g: int,
          emit_sum: bool, tile: Optional[int] = None) -> int:
    """Output frames per block: a multiple of decim (and of the 16-frame
    emit_sum chunk).  Default: of the tiles up to 1024 frames whose shared
    memory allows two blocks per SM (else one), the one that computes the
    fewest frames per output frame, counting the halo and the frames of the
    FIR's last, partial round (:func:`_frames_computed`); the larger on a
    tie."""
    align = decim if mode.endswith("_dec") else 1
    if emit_sum:
        align = align * _SUM_CHUNK // math.gcd(align, _SUM_CHUNK)
    smem = _library().sdsp_pfb_smem_bytes
    mid = _MODE_ID[mode]
    if tile is not None:
        if tile < 1 or tile % align:
            raise ValueError(f"tile={tile} must be a positive multiple of "
                             f"{align}")
        if smem(mid, m, k, kd, decim, tile) > _SMEM_MAX:
            raise ValueError(f"tile={tile} needs more shared memory than a "
                             f"block has")
        return tile
    top = max(align, min(_TILE_TOP, -(-g // align) * align) // align * align)
    fits = [t for t in range(top, 0, -align)
            if smem(mid, m, k, kd, decim, t) <= _SMEM_MAX]
    if not fits:
        raise ValueError(f"no tile fits in shared memory for M={m}, K={k}, "
                         f"kd={kd}")
    two = [t for t in fits if smem(mid, m, k, kd, decim, t) <= _SMEM_TARGET]
    return min(two or fits[:1],
               key=lambda t: (_frames_computed(mode, m, kd, t) / t, -t))


def _frames_computed(mode: str, m: int, kd: int, tile: int) -> int:
    """Frames a block of ``tile`` output frames computes in ``csrc/pfb.cu``:
    the tile and its halo, rounded up to the FIR's rounds of
    256 / min(M, 32) groups of R frames (R = 9, 4, 2 for M <= 32, 64,
    128)."""
    halo = (kd - 1 if mode.endswith("_dec") else 0) + mode.startswith("fm")
    r = 9 if m <= 32 else 4 if m == 64 else 2
    per_round = 256 // min(m, 32) * r
    return -(-(tile + halo) // per_round) * per_round


# id -> (weak reference, version, {decim: table}) of each decimator taps
# tensor: the banks pass the same buffer every call, so its per-phase table
# is gathered once, not once a launch.
_PHASE_TAPS = {}


def _phase_taps(dtaps: torch.Tensor, decim: int) -> torch.Tensor:
    """The kernel's per-phase decimator taps (decim, ceil(kd / decim) to 4):
    ``dtaps`` gathered by :func:`decimator_phase_index`, 0 where a phase
    has no tap (never read)."""
    key = id(dtaps)
    seen = _PHASE_TAPS.get(key)
    if seen is None or seen[0]() is not dtaps or seen[1] != dtaps._version:
        seen = (weakref.ref(dtaps, lambda _, key=key: _PHASE_TAPS.pop(key, None)),
                dtaps._version, {})
        _PHASE_TAPS[key] = seen
    if decim not in seen[2]:
        idx = decimator_phase_index(dtaps.numel(), decim)
        table = dtaps[torch.as_tensor(np.maximum(idx, 0), device=dtaps.device)]
        seen[2][decim] = torch.where(
            torch.as_tensor(idx >= 0, device=dtaps.device), table,
            torch.zeros((), dtype=dtaps.dtype, device=dtaps.device)).contiguous()
    return seen[2][decim]


def _row_stride(name: str, planes, b: int) -> int:
    """The row stride of a flat operand's (re, im) planes, two (B, n)
    float tensors of unit sample stride and one row stride; raises on any
    other."""
    re, im = planes
    rs, js = re.stride(), im.stride()
    if (len(rs) != 2 or re.shape != im.shape or re.shape[0] != b
            or (re.shape[1] > 1 and (rs[1] != 1 or js[1] != 1))
            or (b > 1 and rs[0] != js[0])):
        raise ValueError(f"{name}: expected two ({b}, n) planes of unit "
                         f"sample stride and one row stride, got "
                         f"{tuple(re.shape)} {rs} and {tuple(im.shape)} {js}")
    return rs[0]


class _PFBKernel:
    """The CUDA PFB kernel in one input layout, built from ``csrc/pfb.cu``
    at first launch.  ``launches`` counts its launches.  ``tile`` sets the
    output frames per block (default: chosen from the shared memory a
    block needs); outputs do not depend on it, bit for bit.  Flat: ``hist``
    = (hist_r, hist_i) are the (B, h) history planes that precede x; without
    it x holds history-prefixed planes, split at M K - 1 into the same two
    sources."""

    launches = tracing.Launches()

    def __init__(self, layout: str):
        self.layout = layout
        self.launch_counter = tracing.kernel_counter(f"pfb_{layout}")

    def library(self) -> ctypes.CDLL:
        return _library()

    def __call__(self, mode: str, tables: PFBTables, xr, xi, prev_r, prev_i,
                 ahist, dtaps, *, gain: float, g: int, decim: int,
                 emit_sum: bool, tile: Optional[int], hist=None):
        m, k = tables.taps_t.shape
        if not kernel_supports(m, k):
            raise ValueError(f"the CUDA PFB kernel takes M | 128 and K <= 32, "
                             f"got M={m}, K={k}")
        flat = self.layout == "flat"
        b, h, x_at = xr.shape[0], 0, 0   # x starts x_at floats into xr, xi
        if flat and hist is None:
            # Prefixed planes: the history is their first M K - 1 samples
            # and x the rest, both read from the one buffer.
            h = x_at = min(m * k - 1, xr.shape[1])
            hist = (xr, xi)
        elif flat:
            h = hist[0].shape[-1]
        dec = mode.endswith("_dec")
        kd = dtaps.numel() if dec else 1
        frames = ((h + xr.shape[-1] - x_at) // m if flat
                  else xr.shape[2] if xr.shape[1] == m else -1)
        if g < 1 or frames < g + k - 1 or (dec and g % decim):
            got = (f"{h} + {xr.shape[-1] - x_at} samples a stream" if flat
                   else tuple(xr.shape))
            raise ValueError(f"g={g} (decim={decim}) output frames need "
                             f"{g + k - 1} input frames of {m} samples; "
                             f"got {got}")
        operands = {"fir_taps": (tables.fir_taps, (k, m)),
                    "fft_tw": (tables.fft_tw, (m.bit_length() - 1, m, 2))}
        if flat:   # planes read in place at their row strides
            ld, ld_m = _row_stride("x", (xr, xi), b), 0
            ld_h = ld if x_at else _row_stride("hist", hist, b)
            operands.update(xr=(xr, None), xi=(xi, None),
                            hist_r=(hist[0], None), hist_i=(hist[1], None))
        else:
            ld, ld_m, ld_h = m * xr.shape[2], xr.shape[2], 0
            operands.update(xr=(xr, tuple(xr.shape)), xi=(xi, tuple(xr.shape)))
        if mode.startswith("fm"):
            operands["prev_r"] = (prev_r, (b, m, 1))
            operands["prev_i"] = (prev_i, (b, m, 1))
        if dec:
            operands["ahist"] = (ahist, (b, m, kd - 1))
            operands["dec_taps"] = (dtaps, (kd,))
        if (tables.order.dtype != torch.int32
                or tuple(tables.order.shape) != (2, m)
                or tables.order.device != xr.device):
            raise ValueError(f"order: expected int32 (2, {m}) on {xr.device}")
        for name, (t, shape) in operands.items():
            if t.device != xr.device or t.dtype != torch.float32:
                raise ValueError(f"{name}: the CUDA PFB kernel takes float32 "
                                 f"on {xr.device}, got {t.dtype} on {t.device}")
            if shape is not None and (tuple(t.shape) != shape
                                      or not t.is_contiguous()):
                raise ValueError(f"{name}: expected a contiguous {shape}, got "
                                 f"{tuple(t.shape)}")
        gt = _tile(mode, m, k, kd, decim, g, emit_sum, tile)

        def empty(*shape):
            return torch.empty(shape, dtype=xr.dtype, device=xr.device)

        n_out = g // decim if dec else g
        out0 = empty(b, m, n_out)
        out1 = empty(b, m, g) if mode == "chan" else None
        pr_o = empty(b, m, 1) if mode.startswith("fm") else None
        pi_o = empty(b, m, 1) if mode.startswith("fm") else None
        ah_o = empty(b, m, kd - 1) if dec else None
        parts = empty(b, m, -(-g // _SUM_CHUNK)) if emit_sum else None
        esum = empty(b, m) if emit_sum else None
        hist_r, hist_i = hist if h else (None, None)

        def ptr(t):
            return None if t is None else t.data_ptr()

        fn = self.library().sdsp_pfb_f32
        stream = torch.cuda.current_stream(xr.device).cuda_stream
        rc = fn(int(not flat), _MODE_ID[mode], ptr(xr) + 4 * x_at,
                ptr(xi) + 4 * x_at, ld, ld_m,
                ptr(hist_r), ptr(hist_i), ld_h, h, ptr(tables.fir_taps),
                ptr(tables.order), ptr(tables.fft_tw),
                ptr(_phase_taps(dtaps, decim) if dec else None),
                ptr(prev_r), ptr(prev_i), ptr(ahist if dec else None),
                ptr(out0), ptr(out1), ptr(pr_o), ptr(pi_o), ptr(ah_o),
                ptr(parts), ptr(esum), b, m, k, g, gt, kd, decim,
                int(emit_sum), float(gain), xr.device.index, stream)
        if rc != 0:
            raise RuntimeError(f"PFB kernel launch failed: CUDA error {rc}")
        self.launches += 1
        if mode == "chan":
            return out0, out1
        if mode == "fm":
            return out0, (pr_o, pi_o)
        if mode == "am":
            return out0
        if mode == "fm_dec":
            return out0, (pr_o, pi_o), ah_o
        if emit_sum:
            return out0, ah_o, esum
        return out0, ah_o


pfb_flat_kernel = _PFBKernel("flat")
pfb_frames_kernel = _PFBKernel("frames")


def _run(layout: str, mode: str, ops: PFBOperators, xr, xi, prev=None, *,
         gain: float = 1.0, g: Optional[int] = None, dec_taps=None,
         decim: int = 1, ahist=None, emit_sum: bool = False, hist=None):
    """Check the arguments, then run the kernel on CUDA tensors or its
    plain version on CPU tensors."""
    with tracing.span("sdsp.pfb.launch"):
        m, k = ops.m, ops.k
        b = xr.shape[0]
        kw = {}
        if layout == "flat" and hist is not None:
            w = xr.shape[-1]
            if g is None:
                g = w // m
            have = (hist[0].shape[-1] + w) // m
            if hist[1].shape != hist[0].shape:
                raise ValueError(f"re/im history planes differ: "
                                 f"{tuple(hist[0].shape)} and "
                                 f"{tuple(hist[1].shape)}")
            kw["hist"] = hist
        elif layout == "flat":
            w = xr.shape[1]
            if g is None:
                g = (w - _flat_halo(ops)) // m
            have = w // m
        else:
            if xr.shape[1] != m:
                raise ValueError(f"input has {xr.shape[1]} rows, operators "
                                 f"expect {m}")
            have = xr.shape[2]
            if g is None:
                g = have - (k - 1)
        if g < 1 or have < g + k - 1:
            raise ValueError(f"g={g} output frames need {g + k - 1} input "
                             f"frames of {m} samples; the input has {have}")
        if xi.shape != xr.shape:
            raise ValueError(f"re/im planes differ: {tuple(xr.shape)} and "
                             f"{tuple(xi.shape)}")
        dtaps = None
        if dec_taps is not None:
            if g % decim:
                raise ValueError(f"g={g} not a multiple of decim={decim}")
            dtaps = torch.as_tensor(dec_taps, device=xr.device)
            if dtaps.dtype == torch.float64 and xr.dtype != torch.float64:
                dtaps = dtaps.to(xr.dtype)
            if ahist is None or ahist.shape != (b, m, dtaps.numel() - 1):
                raise ValueError(f"ahist must be (B, M, kd - 1) = "
                                 f"{(b, m, dtaps.numel() - 1)}")
        prev_r, prev_i = prev if prev is not None else (None, None)
        kw.update(gain=gain, g=g, decim=decim, emit_sum=emit_sum)
        tables = ops.tables(xr.device)
        if xr.device.type == "cuda":
            kernel = pfb_flat_kernel if layout == "flat" else pfb_frames_kernel
            return kernel(mode, tables, xr, xi, prev_r, prev_i, ahist, dtaps,
                          tile=None, **kw)
        if xr.device.type == "cpu":
            ref = (pfb_flat_reference if layout == "flat"
                   else pfb_frames_reference)
            return ref(mode, tables, xr, xi, prev_r, prev_i, ahist, dtaps,
                       **kw)
        raise ValueError(f"the PFB kernels run on CUDA or CPU tensors, got "
                         f"{xr.device}")


def pfb_fm_flat(ops: PFBOperators, xpr, xpi, prev_r, prev_i, *,
                gain: float = 1.0, g: Optional[int] = None, dec_taps=None,
                decim: int = 1, ahist=None, hist=None):
    """Flat-input channelize + FM discriminator (+ the fused decimator with
    dec_taps).  xpr/xpi: (B, W) history-prefixed planes, W >= (g + K - 1) M
    (:func:`flat_pad_to`; default g = (W - halo) / M), or with ``hist`` =
    (hist_r, hist_i), the (B, h) history planes, the (B, T) samples that
    follow it (default g = T / M), each read where it lies; prev_r/prev_i:
    (B, M, 1) phase carry.  Returns (disc (B, M, g), (prev_r, prev_i)), or
    with dec_taps (kd,) and ahist (B, M, kd - 1): (audio (B, M, g/decim),
    (prev_r, prev_i), ahist)."""
    mode = "fm" if dec_taps is None else "fm_dec"
    return _run("flat", mode, ops, xpr, xpi, (prev_r, prev_i), gain=gain, g=g,
                dec_taps=dec_taps, decim=decim, ahist=ahist, hist=hist)


def pfb_am_flat(ops: PFBOperators, xpr, xpi, *, g: Optional[int] = None,
                dec_taps=None, decim: int = 1, ahist=None,
                emit_sum: bool = False, hist=None):
    """Flat-input channelize + AM envelope: env (B, M, g), or with dec_taps
    (audio, ahist), plus the per-call envelope sums (B, M) with emit_sum
    (the banks' exact block-mean DC removal).  The input as in
    :func:`pfb_fm_flat`."""
    if emit_sum and dec_taps is None:
        raise ValueError("emit_sum needs the fused decimator (dec_taps)")
    mode = "am" if dec_taps is None else "am_dec"
    return _run("flat", mode, ops, xpr, xpi, g=g, dec_taps=dec_taps,
                decim=decim, ahist=ahist, emit_sum=emit_sum, hist=hist)


def pfb_fm_frames(ops: PFBOperators, xtr, xti, prev_r, prev_i, *,
                  gain: float = 1.0, g: Optional[int] = None, dec_taps=None,
                  decim: int = 1, ahist=None):
    """:func:`pfb_fm_flat` on channel-major (B, M, nfr) frame planes
    (default g = nfr - (K - 1))."""
    mode = "fm" if dec_taps is None else "fm_dec"
    return _run("frames", mode, ops, xtr, xti, (prev_r, prev_i), gain=gain,
                g=g, dec_taps=dec_taps, decim=decim, ahist=ahist)


def pfb_am_frames(ops: PFBOperators, xtr, xti, *, g: Optional[int] = None,
                  dec_taps=None, decim: int = 1, ahist=None):
    """:func:`pfb_am_flat` (without emit_sum) on (B, M, nfr) planes."""
    mode = "am" if dec_taps is None else "am_dec"
    return _run("frames", mode, ops, xtr, xti, g=g, dec_taps=dec_taps,
                decim=decim, ahist=ahist)


def pfb_channelize_frames(ops: PFBOperators, xtr, xti, *,
                          g: Optional[int] = None):
    """Bare channelizer on (B, M, nfr) planes: (yr, yi) each (B, M, g),
    channel-major, as ``PFBChannelizer.process_ri_cm``."""
    return _run("frames", "chan", ops, xtr, xti, g=g)
