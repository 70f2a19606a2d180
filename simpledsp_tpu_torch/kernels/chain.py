"""Fused north-star chain: block IIR + framed FFT, one kernel per call.

Port of ``simpledsp_tpu/kernels/chain.py`` (``fused_chain_frames``).  Each
frame of N = n1 * n2 samples (n2 <= 128, the IIR sub-block; ``_best_split``)
is viewed as x (n1, n2).  A prepass of plain matmuls gives every sub-block
its incoming IIR state (the "starts"); then one kernel computes, per frame
and without writing the filtered signal to device memory,

    y   = x H^T + starts^T Phi^T                 (IIR block)
    c,s = [W1c; W1s] y                           (four-step FFT, step 1)
    tr  = c Tc - s Ts,   ti = s Tc + c Ts        (twiddle)
    out = tr P^T + ti Q^T                        (step 3, packed [Re | Im])

and writes the packed one-sided spectrum in natural bin order, with the
Nyquist bin X[N/2].re in the imaginary plane's bin-0 slot; or, with the
full-spectrum step 3 (Re X = tr W2c^T - ti W2s^T, Im X = ti W2c^T +
tr W2s^T), the full complex spectrum, the JAX function's default.

The kernel is ``chain_natural_kernel`` (``csrc/chain_natural.cuh``),
built as ``csrc/chain.cu`` (:func:`chain_frames`, :func:`chain_frames_full`
and the layouts of ``kernels/chain_variants.py``) and as ``csrc/chain_tc.cu``
("regs", its IIR block as split-bf16 products on the tensor cores).  It
computes the same spectra with a radix FFT in place of the DFT products:
the N/2-point complex FFT of z[t] = y[2t] + i y[2t+1] on the FFT core (``csrc/fft_core.cuh``, plan and table from
``kernels/fft.py``), then the split into the one-sided spectrum
(:func:`kernels.fft._split_table_f64`), which the full spectrum completes
with X[N - k] = conj X[k]; an odd N (full spectrum only, up to 127 x 127)
takes the N-point complex FFT of the frame.
:func:`chain_frames_reference` and
:func:`chain_frames_full_reference` are the same functions in plain
PyTorch, used for CPU tensors and as the kernels' oracles on the card.

All operator tables are built on the host in float64 (carried over verbatim
from the JAX package) and cast once to the working dtype.  The prepass
matmuls run in IEEE float32 (:func:`simpledsp_tpu_torch.precision.ieee_fp32`):
the two-step projection loses about 37 dB at reduced matmul precision.
"""

from __future__ import annotations

import ctypes
import functools
import weakref
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from simpledsp_tpu_torch.design.biquad import BiquadCascadeDesign
from simpledsp_tpu_torch.device import resolve_device
from simpledsp_tpu_torch.kernels import _build
from simpledsp_tpu_torch.kernels.fft import (_best_split, _consts,
                                             _kernel_tables, _split_table_f64)
from simpledsp_tpu_torch.ops.iir import block_operators_f64
from simpledsp_tpu_torch.precision import ieee_fp32

__all__ = ["ChainTables", "FusedNorthStarOperators", "LAYOUTS",
           "chain_frames", "chain_frames_full", "chain_frames_full_reference",
           "chain_frames_reference", "chain_full_kernel", "chain_kernel",
           "chain_prepass", "fused_chain_frames", "kernel_supports",
           "resolve_layout"]

# The half-spectrum layouts of the JAX function.  "reg" and "k1" differ on
# the TPU only in output layout; here both are the natural-order kernel.
LAYOUTS = ("reg", "regp", "regs", "regw", "reg2", "reg4", "k1", "fmajor",
           "pair")


def kernel_supports(n1: int, n2: int) -> bool:
    """Frames the half-spectrum CUDA kernels take: every split
    ``_best_split`` yields (n1, n2 <= 128) with n2 even, which the one-sided
    packing needs.  The full-spectrum kernel also takes odd n2."""
    return 1 <= n1 <= 128 and 2 <= n2 <= 128 and n2 % 2 == 0


class ChainTables(NamedTuple):
    """Constant tables of the per-frame chain, in the layouts the kernel
    reads (each product's right-hand operand row-major over n2 columns)."""

    HT: torch.Tensor     # (n2, n2)    H^T, H lower-triangular Toeplitz
    PhiT: torch.Tensor   # (D, n2)     Phi^T
    W1cs: torch.Tensor   # (2 n1, n1)  [W1c; W1s], step-1 DFT
    Tc: torch.Tensor     # (n1, n2)    twiddle cos
    Ts: torch.Tensor     # (n1, n2)    twiddle -sin
    PQT: torch.Tensor    # (2 n2, n2)  [P^T; Q^T], packed step-3 DFT; for
    #                      the full spectrum (4 n2, n2), [W2c^T; -W2s^T;
    #                      W2s^T; W2c^T] (Re rows, then Im rows)
    T3: torch.Tensor     # (3, n2 + D, n2) [H^T; Phi^T] as three bfloat16
    #                      parts h, m, l split from its float64 values
    #                      ("regs": the IIR block as split products)


class FusedNorthStarOperators(nn.Module):
    """Host-built float64 operators for one design and frame size, held as
    buffers in ``dtype`` on ``device`` (``None``: CUDA, raising where there
    is none; CPU callers pass ``device="cpu"``).

    Same tables, built by the same float64 code, as the JAX package's
    ``FusedNorthStarOperators``, plus the full-spectrum step-3 table ``FT``.
    The JAX package's grouped ``KTg`` table (a block-diagonal copy of ``KT``
    that only shrank TPU lane padding) is not carried: the two-step
    projection multiplies by ``KT`` directly.
    """

    def __init__(self, design: BiquadCascadeDesign, fft_size: int,
                 dtype=torch.float32, device=None):
        super().__init__()
        split = _best_split(fft_size)
        if split is None:
            raise ValueError(
                f"fused chain needs fft_size = n1 * n2 with factors <= 128; "
                f"got {fft_size}")
        device = resolve_device(device)
        self.n1, self.n2 = split
        self.fft_size = int(fft_size)
        self.design = design
        nb, n2 = self.n1, self.n2

        H, Phi, K, F64, *_ = block_operators_f64(design, n2)
        D = F64.shape[0]
        self.state_dim = D

        # Powers of the n2-sample transition.
        pw = np.empty((nb + 1, D, D))
        pw[0] = np.eye(D)
        for i in range(1, nb + 1):
            pw[i] = F64 @ pw[i - 1]
        self._Ff64 = pw[nb]                    # frame transition, float64

        # Dense projection: x_flat (F, N) @ TKt -> [starts_x (n1 D, D-major)
        # | k_frame (D)], with column d*n1 + p of the starts part holding
        # (sum_{j<p} F^{p-1-j} K x_j)[d] and column n1 D + d the frame's
        # input-driven end state.
        TKt = np.zeros((nb * n2, (nb + 1) * D))
        for p in range(1, nb):
            for j in range(p):
                TKt[j * n2:(j + 1) * n2,
                    [d * nb + p for d in range(D)]] = (pw[p - 1 - j] @ K).T
        for j in range(nb):
            TKt[j * n2:(j + 1) * n2, nb * D:] = (pw[nb - 1 - j] @ K).T
        # Two-step projection: kb = K x per sub-block, then the F-power
        # block-Toeplitz combine TO, same D-major column order as TKt.
        TO = np.zeros((nb * D, (nb + 1) * D))
        for p in range(1, nb):
            for j in range(p):
                TO[j * D:(j + 1) * D,
                   [d * nb + p for d in range(D)]] = pw[p - 1 - j].T
        for j in range(nb):
            TO[j * D:(j + 1) * D, nb * D:] = pw[nb - 1 - j].T
        # State part of the start expansion: starts[f, d*n1 + p] +=
        # (F^p s_frame[f])[d].
        FpT = np.zeros((D, nb * D))
        for p in range(nb):
            FpT[:, [d * nb + p for d in range(D)]] = pw[p].T

        _, _, w1c, w1s, w2c, w2s, tc, ts = _consts(self.fft_size, False,
                                                    "float64")
        h = n2 // 2
        p_tab = np.concatenate([w2c[:h], w2s[:h]], 0)     # (n2, n2)
        q_tab = np.concatenate([-w2s[:h], w2c[:h]], 0)

        # chain_variants imports this module: its split comes in here.
        from simpledsp_tpu_torch.kernels.chain_variants import iir_split3
        host = dict(
            H=H, Phi=Phi, K=K, Ff=pw[nb], TKt=TKt, KT=K.T, TO=TO, FpT=FpT,
            HT=H.T, PhiT=Phi.T, W1cs=np.concatenate([w1c, w1s], 0),
            Tc=tc.T, Ts=ts.T, PQT=np.concatenate([p_tab.T, q_tab.T], 0),
            FT=np.concatenate([w2c.T, -w2s.T, w2s.T, w2c.T], 0),
            T3=iir_split3(H.T, Phi.T))
        npdt = torch.empty((), dtype=dtype).numpy().dtype
        for name, a in host.items():
            self.register_buffer(name, torch.as_tensor(
                np.ascontiguousarray(a).astype(npdt), device=device))
        self._ptabs = {}

    def shard_powers(self, frames_per_shard: int,
                     n_shards: int) -> np.ndarray:
        """(n_shards + 1, D, D) stack of Fs^p with Fs = Ff^{frames_per_shard}
        in float64: the cross-shard transition powers of the
        sequence-parallel chain (``fused_chain_frames(..., group=,
        shard_powers=)``)."""
        from simpledsp_tpu_torch.parallel.iir import transition_powers
        return transition_powers(self._Ff64, frames_per_shard, n_shards)

    def tables(self, full: bool = False) -> ChainTables:
        """The kernel's tables: packed half-spectrum step 3, or with
        ``full`` the full-spectrum one."""
        return ChainTables(self.HT, self.PhiT, self.W1cs, self.Tc, self.Ts,
                           self.FT if full else self.PQT, self.T3)

    def frame_prefix_tables(self, F: int) -> dict:
        """Tables for the two-level frame-state prefix over F frames (see
        :func:`_frame_prefix_start`): frames split into G groups of
        bg ~ sqrt(F); one block-Toeplitz matmul expands each group, a second
        resolves the state entering each group.  Cached per F, and per the
        buffers' device and dtype."""
        key = (F, self.H.device, self.H.dtype)
        if key in self._ptabs:
            return self._ptabs[key]
        D = self.state_dim
        Ff = self._Ff64
        bg = 1 << min(7, max(0, int(round(np.log2(max(F, 2)) / 2))))
        bg = min(bg, F)
        G = -(-F // bg)
        pwf = [np.eye(D)]
        for _ in range(bg):
            pwf.append(Ff @ pwf[-1])
        LTfT = np.zeros((bg * D, bg * D))     # inclusive: power p - j, j <= p
        for p in range(bg):
            for j in range(p + 1):
                LTfT[j * D:(j + 1) * D, p * D:(p + 1) * D] = pwf[p - j].T
        Fg = pwf[bg]
        pwg = [np.eye(D)]
        for _ in range(G):
            pwg.append(Fg @ pwg[-1])
        LTgT = np.zeros((G * D, G * D))       # strict: power q - 1 - r, r < q
        for q in range(G):
            for r_ in range(q):
                LTgT[r_ * D:(r_ + 1) * D, q * D:(q + 1) * D] = \
                    pwg[q - 1 - r_].T
        FgPT = np.zeros((D, G * D))           # s_in -> group starts
        for q in range(G):
            FgPT[:, q * D:(q + 1) * D] = pwg[q].T
        FpLT = np.zeros((D, bg * D))          # group start -> after-frame p
        for p in range(bg):
            FpLT[:, p * D:(p + 1) * D] = pwf[p + 1].T
        q_l, p_l = divmod(F - 1, bg)

        def t(a):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=self.H.dtype,
                                   device=self.H.device)

        tabs = dict(bg=bg, G=G, q_l=q_l, p_l=p_l, LTfT=t(LTfT), LTgT=t(LTgT),
                    FgPT=t(FgPT), FpLT=t(FpLT), FfpT=t(pwf[p_l + 1].T))
        self._ptabs[key] = tabs
        return tabs


def _frame_prefix_start(tabs: dict, kf_t: torch.Tensor):
    """Input-driven half of the frame-state prefix s' = Ff s + k.

    kf_t: (F, C, D) frame-k vectors.  Returns (L, W, vc_last):
      L (G C, bg D): inclusive within-group prefix values,
        L[(q, c), (p, d)] = (sum_{j<=p} Ff^{p-j} k[q bg + j])[d]
      W (C, G D): input-driven state entering each group,
        W[c, (q, d)] = (sum_{r<q} Fg^{q-1-r} kgrp[r])[d]
      vc_last (C, D): input-driven state after frame F-1.
    F is zero-padded up to bg G frames.
    """
    F, C, D = kf_t.shape
    bg, G = tabs["bg"], tabs["G"]
    ft = bg * G
    kp = kf_t if ft == F else torch.nn.functional.pad(
        kf_t, (0, 0, 0, 0, 0, ft - F))
    kgq = kp.reshape(G, bg, C, D).permute(0, 2, 1, 3).reshape(G * C, bg * D)
    L = kgq @ tabs["LTfT"]                                # (G C, bg D)
    kgrp = L[:, -D:].reshape(G, C, D).permute(1, 0, 2)
    W = kgrp.reshape(C, G * D) @ tabs["LTgT"]
    q_l, p_l = tabs["q_l"], tabs["p_l"]
    vc_last = (W[:, q_l * D:(q_l + 1) * D] @ tabs["FfpT"]
               + L.reshape(G, C, bg * D)[q_l, :, p_l * D:(p_l + 1) * D])
    return L, W, vc_last


def _frame_prefix_finish(tabs: dict, L: torch.Tensor, W: torch.Tensor,
                         s_in: torch.Tensor, F: int) -> torch.Tensor:
    """States after every frame given the true incoming state s_in (C, D):
    s_after[c, f = q bg + p] = Ff^{p+1} (Fg^q s_in + W[q]) + L_q[p]."""
    C, D = s_in.shape
    bg, G = tabs["bg"], tabs["G"]
    S = W + s_in @ tabs["FgPT"]                           # (C, G D)
    term = S.reshape(C * G, D) @ tabs["FpLT"]
    Lr = L.reshape(G, C, bg * D).permute(1, 0, 2)
    s_after = (term.reshape(C, G, bg * D) + Lr).reshape(C, G * bg, D)
    return s_after[:, :F]                                 # (C, F, D)


def _iir_block(x3: torch.Tensor, s3: torch.Tensor,
               tables: ChainTables) -> torch.Tensor:
    """The IIR block of every frame: y (F, n1, n2) = x H^T + starts^T Phi^T."""
    with ieee_fp32():
        return (torch.einsum("fpj,ji->fpi", x3, tables.HT)
                + torch.einsum("fep,ei->fpi", s3, tables.PhiT))


def _twiddled(cs: torch.Tensor, tables: ChainTables):
    """Step 2 on the step-1 output cs (F, 2 n1, n2): (tr, ti)."""
    n1 = cs.shape[1] // 2
    c, s = cs[:, :n1], cs[:, n1:]
    return c * tables.Tc - s * tables.Ts, s * tables.Tc + c * tables.Ts


def _step1(y: torch.Tensor, tables: ChainTables) -> torch.Tensor:
    with ieee_fp32():
        return torch.einsum("kp,fpt->fkt", tables.W1cs, y)


def _packed_spectrum(tr: torch.Tensor, ti: torch.Tensor, tables: ChainTables
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed step 3 and the Nyquist bin: (F, N/2) planes, natural order."""
    nf, n1, n2 = tr.shape
    h = n2 // 2
    with ieee_fp32():
        out = (torch.einsum("fkt,tl->fkl", tr, tables.PQT[:n2])
               + torch.einsum("fkt,tl->fkl", ti, tables.PQT[n2:]))
    alt = torch.ones(n2, dtype=tr.dtype, device=tr.device)
    alt[1::2] = -1.0
    nyq = (tr[:, 0] * alt).sum(-1)
    # (F, k1, k2) -> (F, k2, k1): bin k = k1 + n1 k2 in natural order.
    spec_re = out[:, :, :h].transpose(1, 2).reshape(nf, h * n1)
    spec_im = out[:, :, h:].transpose(1, 2).reshape(nf, h * n1)
    spec_im[:, 0] = nyq
    return spec_re, spec_im


def chain_frames_reference(x3: torch.Tensor, s3: torch.Tensor,
                           tables: ChainTables
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the half-spectrum chain kernel.

    x3 (F, n1, n2) frames, s3 (F, D, n1) sub-block starts (D-major).
    Returns (spec_re, spec_im), each (F, N/2), packed one-sided spectra in
    natural bin order with X[N/2].re in spec_im[:, 0].
    """
    y = _iir_block(x3, s3, tables)
    return _packed_spectrum(*_twiddled(_step1(y, tables), tables), tables)


def chain_frames_full_reference(x3: torch.Tensor, s3: torch.Tensor,
                                tables: ChainTables
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the full-spectrum chain kernel.

    As :func:`chain_frames_reference`, with ``tables.PQT`` the full table
    (``FusedNorthStarOperators.tables(full=True)``).  Returns (re, im),
    each (F, N): the complex spectrum of every frame in natural bin order.
    """
    nf, n1, n2 = x3.shape
    tr, ti = _twiddled(_step1(_iir_block(x3, s3, tables), tables), tables)
    t = tables.PQT
    with ieee_fp32():
        yr = (torch.einsum("fkt,tl->fkl", tr, t[:n2])
              + torch.einsum("fkt,tl->fkl", ti, t[n2:2 * n2]))
        yi = (torch.einsum("fkt,tl->fkl", tr, t[2 * n2:3 * n2])
              + torch.einsum("fkt,tl->fkl", ti, t[3 * n2:]))
    return (yr.transpose(1, 2).reshape(nf, n1 * n2),
            yi.transpose(1, 2).reshape(nf, n1 * n2))


# The headers ``csrc/chain.cu`` and ``csrc/chain_tc.cu`` include.
_HEADERS = ("chain_common.cuh", "chain_natural.cuh", "fft_core.cuh")


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """``csrc/chain.cu`` built and loaded, its entry point typed."""
    lib = _build.load_library("sdsp_chain", ("chain.cu",), _HEADERS)
    fn = lib.sdsp_chain_natural_f32
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


# The half spectrum's stores (enum Store in chain.cu): natural order
# straight from the split, the same in 16-byte stores, k1-major rows.
_STORES = ("natural", "wide", "fmajor")
# The shared memory a block may have (kMaxSmem in chain_common.cuh).
_MAX_SMEM = 232448


def _natural_frames(n1: int, n2: int) -> int:
    """Frames a block as the kernel picks them (``g = 0`` in
    ``sdsp_chain_natural_f32``): as many as keep the block's FFT at 4096
    values (N/2 a frame, N for an odd N) and its rows at 64."""
    n = n1 * n2
    per = n if n % 2 else n // 2
    g = 1
    while 2 * g * per <= 4096 and -(-2 * g * n1 // 8) * 8 <= 64:
        g *= 2
    return g


def _natural_smem_bytes(n1: int, n2: int, d: int,
                        g: Optional[int] = None) -> int:
    """Shared memory of a block of the natural-order kernel
    (``sdsp_chain_natural_f32`` in chain.cu) with g frames (default: the
    kernel's own choice): the rows of g frames stacked and rounded up to a
    multiple of 8, each row of x and y kLdx = 132 floats wide, and the
    starts (rows, d rounded up to 4)."""
    rows = -(-(g or _natural_frames(n1, n2)) * n1 // 8) * 8
    return 4 * rows * (2 * 132 + -(-d // 4) * 4)


def _natural_fits(n1: int, n2: int, d: int, g: int) -> bool:
    """Whether g frames of n1 x n2 samples (N even) fit a block of the
    natural-order kernel: 1 <= g <= 128, its shared memory within the
    card's, and at most 8192 FFT values (32 a thread, the largest
    instance)."""
    return (1 <= g <= 128 and g * n1 * n2 // 2 <= 8192
            and _natural_smem_bytes(n1, n2, d, g) <= _MAX_SMEM)


@functools.lru_cache(maxsize=64)
def _split_table(n: int, device: torch.device) -> torch.Tensor:
    """The natural-order kernel's split twiddles for N = n, float32 on
    ``device``."""
    return torch.as_tensor(_split_table_f64(n).astype(np.float32),
                           device=device)


def _check_operands(x3: torch.Tensor, s3: torch.Tensor, tables: ChainTables,
                    what: str, split: bool = False) -> None:
    """Raises ValueError unless every operand the kernel reads is contiguous
    float32 on x3's device in the shape it reads: x3, s3, and HT and PhiT,
    or with ``split`` (the "regs" form) T3 in their place."""
    nf, n1, n2 = x3.shape
    d = s3.shape[1]
    expect = {"x3": (x3, (nf, n1, n2)), "s3": (s3, (nf, d, n1))}
    if split:
        expect.update(T3=(tables.T3, (3, n2 + d, n2)))
    else:
        expect.update(HT=(tables.HT, (n2, n2)), PhiT=(tables.PhiT, (d, n2)))
    for name, (t, shape) in expect.items():
        if t.device != x3.device or t.dtype != torch.float32:
            raise ValueError(f"{name}: the CUDA {what} kernel takes float32 "
                             f"on {x3.device}, got {t.dtype} on {t.device}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous {shape}, got "
                             f"{tuple(t.shape)}")


# id -> (weak reference, version) of each H^T found upper-triangular: the
# check waits on the card, so it runs once a tensor and version, not once a
# launch.
_UPPER = {}


def _require_upper(ht: torch.Tensor) -> None:
    """Raises ValueError unless ``ht`` (H^T) is upper-triangular, H
    lower-triangular as the chain's block operator is: the natural-order
    kernel reads, for each band of 16 output columns, the rows of H^T up to
    the band's last column only."""
    key = id(ht)
    seen = _UPPER.get(key)
    if seen is not None and seen[0]() is ht and seen[1] == ht._version:
        return
    if not torch.equal(ht, torch.triu(ht)):
        raise ValueError("HT: the CUDA chain kernel needs H^T "
                         "upper-triangular (H lower-triangular)")
    _UPPER[key] = (weakref.ref(ht, lambda _, key=key: _UPPER.pop(key, None)),
                   ht._version)


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _launch_natural(library, x3: torch.Tensor, s3: torch.Tensor,
                    tables: ChainTables, mode: str, g: int = 0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of ``chain_natural_kernel`` (``sdsp_chain_natural_f32``):
    the half spectrum in one of :data:`_STORES`, or the full spectrum
    ("full"), with g frames a block (0: the kernel's choice).  Checks every
    operand before ``library()`` builds or loads the kernel.  Returns
    (re, im): (F, N/2) natural-order planes, (F, n1, n2/2) k1-major rows for
    "fmajor", (F, N) for "full"."""
    nf, n1, n2 = x3.shape
    d = s3.shape[1]
    full = mode == "full"
    if full:
        if not (1 <= n1 <= 128 and 1 <= n2 <= 128):
            raise ValueError(f"the CUDA chain kernel needs frames of n1 x "
                             f"n2 samples, n1 <= 128 and n2 <= 128; got "
                             f"{tuple(x3.shape)}")
    elif not kernel_supports(n1, n2):
        raise ValueError(f"the CUDA chain kernel needs frames of n1 x n2 "
                         f"samples, n1 <= 128 and n2 <= 128 even; got "
                         f"{tuple(x3.shape)}")
    if g and not _natural_fits(n1, n2, d, g):
        raise ValueError(f"{g} frames of {n1} rows do not fit a block")
    if not g and _natural_smem_bytes(n1, n2, d) > _MAX_SMEM:
        raise ValueError(f"frames of {n1} x {n2} samples with a state of "
                         f"{d} do not fit a block")
    _check_operands(x3, s3, tables, "chain")
    _require_upper(tables.HT)
    shape = {"full": (nf, n1 * n2), "fmajor": (nf, n1, n2 // 2)}.get(
        mode, (nf, n1 * n2 // 2))
    spec_re = torch.empty(shape, dtype=x3.dtype, device=x3.device)
    spec_im = torch.empty_like(spec_re)
    # The real FFT of N points as the complex FFT of N/2 on the FFT core,
    # then the split (and for the full spectrum its conjugate mirror); an
    # odd N as the complex FFT of N points.  Only H^T and Phi^T are read,
    # their rows 128 wide.
    ht, phit = tables.HT, tables.PhiT
    if n2 < 128:
        ht, phit = (torch.nn.functional.pad(t, (0, 128 - n2))
                    for t in (ht, phit))
    n = n1 * n2
    odd = n % 2 == 1
    tab, plan, npass = _kernel_tables(n if odd else n // 2, x3.device)
    split = None if odd else _split_table(n, x3.device).data_ptr()
    rc = library().sdsp_chain_natural_f32(
        x3.data_ptr(), s3.data_ptr(), ht.data_ptr(), phit.data_ptr(),
        ctypes.cast(plan, ctypes.c_void_p), npass, tab.data_ptr(), split,
        spec_re.data_ptr(), spec_im.data_ptr(), nf, n1, n2, d, int(full), g,
        0 if full else _STORES.index(mode), x3.device.index, _stream(x3))
    if rc != 0:
        raise RuntimeError(f"chain kernel launch failed: CUDA error {rc}")
    return spec_re, spec_im


class _ChainKernel:
    """A form of ``chain_natural_kernel`` in ``csrc/chain.cu`` (``modes``:
    the outputs it launches, :data:`_STORES` or "full"), built at first
    launch; ``launches`` counts its launches."""

    def __init__(self, *modes: str):
        self.modes = modes
        self.launches = 0

    def library(self) -> ctypes.CDLL:
        return _library()

    def __call__(self, x3: torch.Tensor, s3: torch.Tensor,
                 tables: ChainTables, mode: Optional[str] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Launch in ``mode`` (default: the first of ``modes``), the
        kernel's own frames a block; see :func:`_launch_natural`."""
        mode = mode or self.modes[0]
        if mode not in self.modes:
            raise ValueError(f"this kernel launches {self.modes}, not {mode!r}")
        out = _launch_natural(self.library, x3, s3, tables, mode)
        self.launches += 1
        return out


chain_kernel = _ChainKernel("natural")
chain_full_kernel = _ChainKernel("full")


def _on_device(x3: torch.Tensor, kernel, reference, *args):
    """The kernel on CUDA tensors, its plain version on CPU tensors; any
    other device raises.  There is no fallback from a kernel to its plain
    version."""
    if x3.device.type == "cuda":
        return kernel(*args)
    if x3.device.type == "cpu":
        return reference(*args)
    raise ValueError(f"the chain runs on CUDA or CPU tensors, got "
                     f"{x3.device}")


def chain_frames(x3: torch.Tensor, s3: torch.Tensor, tables: ChainTables
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-frame half-spectrum chain: the CUDA kernel on CUDA tensors,
    its plain version on CPU tensors."""
    return _on_device(x3, chain_kernel, chain_frames_reference, x3, s3, tables)


def chain_frames_full(x3: torch.Tensor, s3: torch.Tensor, tables: ChainTables
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-frame full-spectrum chain (``tables`` from
    ``ops.tables(full=True)``): the CUDA kernel on CUDA tensors, its plain
    version on CPU tensors."""
    return _on_device(x3, chain_full_kernel, chain_frames_full_reference,
                      x3, s3, tables)


def chain_prepass(ops: FusedNorthStarOperators, x: torch.Tensor,
                  s0: torch.Tensor, projection: Optional[str] = None,
                  group=None, shard_powers=None):
    """The matmuls before the kernel: every sub-block's incoming IIR state.

    x is (C, T), T a multiple of fft_size, or pre-framed (C, F, n1, n2);
    s0 is the flat incoming state (C, D).  projection: "two_step" (default:
    kb = K x per sub-block, then the F-power block-Toeplitz combine) or
    "dense" (one x @ TKt matmul); the two agree to rounding.

    group, shard_powers: x is one time shard of a stream sharded over the
    ranks of the process group ``group`` (the ``sp`` axis of a mesh,
    ``mesh.get_group("sp")``); s0 and s_final are the stream's global
    states.  Between the input-driven half of the frame prefix and
    its finish, the shard's input-driven final state goes through the
    closed form of ``parallel/iir.py`` (one all_gather, one all_reduce)
    with ``shard_powers`` (``ops.shard_powers``, a numpy array or a tensor
    on x's device) to give the state entering the shard.

    Returns (x3 (C F, n1, n2) frames, s3 (C F, D, n1) D-major sub-block
    starts, s_final (C, D)).
    """
    n1, n2, N = ops.n1, ops.n2, ops.fft_size
    if x.ndim == 4:
        c, nf = x.shape[:2]
    else:
        c, t = x.shape
        nf = t // N
    D = ops.state_dim
    f_total = c * nf
    xsub = x.reshape(c, nf, n1, n2)
    x_flat = xsub.reshape(f_total, N)
    projection = projection or "two_step"
    with ieee_fp32():
        if projection == "two_step":
            kb = x_flat.reshape(f_total * n1, n2) @ ops.KT       # (F n1, D)
            big = kb.reshape(f_total, n1 * D) @ ops.TO
        elif projection == "dense":
            big = x_flat @ ops.TKt                          # (F, (n1 + 1) D)
        else:
            raise ValueError(f"unknown projection {projection!r}")
        kxs = big[:, : n1 * D]                         # starts, input part
        k_frame = big[:, n1 * D:].reshape(c, nf, D)

        # Frame-level state chain: two-level block-Toeplitz prefix.
        tabs = ops.frame_prefix_tables(nf)
        L_, W_, vc_last = _frame_prefix_start(tabs, k_frame.transpose(0, 1))
        s_in = s0
        if group is not None:
            # vc_last is this shard's input-driven final state.
            s_in, s_glob = _shard_states(group, shard_powers, s0, vc_last)
        s_after = _frame_prefix_finish(tabs, L_, W_, s_in, nf)
        s_fin = s_after[:, -1] if group is None else s_glob
        s_frames = torch.cat([s_in[:, None], s_after[:, :-1]], dim=1)

        # Sub-block starts: state part + input part, D-major, so the
        # (F, n1 D) -> (F, D, n1) view is free.
        starts = s_frames.reshape(f_total, D) @ ops.FpT + kxs
    return xsub.reshape(f_total, n1, n2), starts.reshape(f_total, D, n1), s_fin


def _shard_states(group, shard_powers, s0: torch.Tensor,
                  k_shard: torch.Tensor):
    """(state entering the shard, global final state) of a chain sharded
    over the ranks of ``group``: :func:`parallel.iir.shard_states`."""
    if shard_powers is None:
        raise ValueError("group requires shard_powers")
    from simpledsp_tpu_torch.parallel.iir import shard_states
    apow = torch.as_tensor(shard_powers, dtype=s0.dtype, device=s0.device)
    return shard_states(group, apow, s0, k_shard)


def resolve_layout(n1: int) -> str:
    """The JAX package's default half-spectrum layout for a step-1 factor
    n1: "reg" at n1 >= 32, else "k1".  Both run the same natural-order
    kernel here; the name decides only the shape ``flat_out`` gives."""
    return "reg" if n1 >= 32 else "k1"


def _tile_frames(f_total: int, n: int, itemsize: int,
                 frames_per_tile: int) -> int:
    """The JAX kernel's frames per grid step r (``chain.py:675-689``): the
    grouped layouts take their group size from it."""
    max_r = max(1, (13 << 20) // (6 * n * itemsize))
    r = min(frames_per_tile, 1 << (max_r.bit_length() - 1), 64)
    if r < 1:
        raise ValueError(f"frames_per_tile must be positive, got "
                         f"{frames_per_tile}")
    while f_total % r:
        r //= 2
    return r


def fused_chain_frames(ops: FusedNorthStarOperators, x: torch.Tensor,
                       s0: torch.Tensor, *, frames_per_tile: int = 64,
                       half_spectrum: bool = False,
                       layout: Optional[str] = None, flat_out: bool = False,
                       projection: Optional[str] = None, group=None,
                       shard_powers=None):
    """Run the fused chain (:func:`chain_prepass`, then one kernel launch)
    over x (C, T), T a multiple of fft_size, or pre-framed (C, F, n1, n2),
    from the flat state s0 (C, D).  The JAX function's signature and shapes.

    half_spectrum: False (default) gives the full complex spectrum of every
      frame; True the packed one-sided spectrum (bins k < N/2, X[N/2].re in
      the imaginary plane's bin 0), which needs an even n2.
    layout: the half-spectrum kernel variant, one of :data:`LAYOUTS`
      (default :func:`resolve_layout`).  Every layout computes the same
      function; they differ in how the kernel is scheduled:
      "reg" / "k1" the chain kernel; "regs" the IIR block as exact
      split-bf16 products on the tensor cores (float32 only); "reg2" / "reg4" /
      "regp" / "pair" the chain kernel with g frames a block
      (:func:`chain_variants.group_frames`); "regw" the chain kernel with
      16-byte stores; "fmajor" with k1-major rows, reordered here by a
      transpose as the JAX package does outside its kernel.
    frames_per_tile: the JAX kernel's tile, from which the grouped layouts
      take their group size.
    flat_out: half spectrum with "reg*" or "k1": (C F, n2/2/qf, qf n1)
      planes, qf = ``chain_variants._regw_qf`` for "regw", else 1.
    projection: "two_step" (default) or "dense", see :func:`chain_prepass`.
    group, shard_powers: the sequence-parallel chain.  x is one time shard
      of a stream sharded over the ranks of the process group ``group``
      (``mesh.get_group("sp")``), s0 and s_final the stream's global
      states, and ``shard_powers`` the (n_shards + 1, D, D) transition
      powers of :meth:`FusedNorthStarOperators.shard_powers`; the state
      entering the shard comes from one all_gather and the global final
      state from one all_reduce (see :func:`chain_prepass`).  JAX names the
      mesh axis (``axis_name``) inside its ``shard_map``; the port has no
      ambient axis and takes its group.

    Returns ((re, im), s_final (C, D)): re and im (C, F, n2, n1) for the
    full spectrum, (C, F, n2/2, n1) for the half one (or the flat form);
    flattening the last two axes gives natural bin order k = k1 + n1 k2.

    Not taken from the JAX signature: ``axis_name`` (``group`` in its
    place), and the TPU hooks ``precision`` (IEEE float32 only),
    ``interpret``, ``_debug_stage`` and ``_proj_prec``.
    """
    n1, n2, N = ops.n1, ops.n2, ops.fft_size
    if layout is None:
        layout = resolve_layout(n1)
    if half_spectrum:
        if n2 % 2:
            raise ValueError(f"half_spectrum requires even n2, got {n2}")
        if layout not in LAYOUTS:
            raise ValueError(f"unknown layout {layout!r}")
        if layout == "regs" and x.dtype != torch.float32:
            raise ValueError("layout 'regs' requires float32 (the split "
                             "targets a 24-bit significand)")
    c = x.shape[0]
    x3, s3, s_fin = chain_prepass(ops, x, s0, projection, group,
                                  shard_powers)
    f_total = x3.shape[0]
    nf = f_total // c
    if not half_spectrum:
        yr, yi = chain_frames_full(x3, s3, ops.tables(full=True))
        return (yr.reshape(c, nf, n2, n1), yi.reshape(c, nf, n2, n1)), s_fin

    from simpledsp_tpu_torch.kernels import chain_variants as cv
    h = n2 // 2
    tables = ops.tables()
    if layout in ("reg", "k1"):
        zr, zi = chain_frames(x3, s3, tables)
    elif layout == "regs":
        zr, zi = cv.chain_frames_regs(x3, s3, tables)
    elif layout in ("regw", "fmajor"):
        zr, zi = cv.chain_frames_store(
            x3, s3, tables, "wide" if layout == "regw" else "fmajor")
        if layout == "fmajor":     # (F, n1, n2/2) -> (F, n2/2, n1)
            zr, zi = zr.transpose(1, 2), zi.transpose(1, 2)
    else:
        r = _tile_frames(f_total, N, x3.element_size(), frames_per_tile)
        g = cv.group_frames(layout, n1, n2, r, ops.state_dim)
        zr, zi = cv.chain_frames_grouped(x3, s3, tables, g)
    if flat_out and layout not in ("pair", "fmajor"):
        qf = cv._regw_qf(n1, h) if layout == "regw" else 1
        shape = (f_total, h // qf, qf * n1)
    else:
        shape = (c, nf, h, n1)
    return (zr.reshape(shape), zi.reshape(shape)), s_fin
