"""Fused north-star chain: block IIR + framed half-spectrum FFT, one kernel.

Port of ``simpledsp_tpu/kernels/chain.py`` (``fused_chain_frames`` with
``half_spectrum=True``).  Each frame of N = n1 * n2 samples (n2 <= 128 even,
the IIR sub-block; ``_best_split``) is viewed as x (n1, n2).  A prepass of plain matmuls gives
every sub-block its incoming IIR state (the "starts"); then one kernel per
frame computes, without writing the filtered signal to device memory,

    y   = x H^T + starts^T Phi^T                 (IIR block)
    c,s = [W1c; W1s] y                           (four-step FFT, step 1)
    tr  = c Tc - s Ts,   ti = s Tc + c Ts        (twiddle)
    out = tr P^T + ti Q^T                        (step 3, packed [Re | Im])

and writes the packed one-sided spectrum in natural bin order, with the
Nyquist bin X[N/2].re in the imaginary plane's bin-0 slot.

The kernel is ``csrc/chain.cu`` (:func:`chain_frames` launches it on CUDA
tensors); :func:`chain_frames_reference` is the same function in plain
PyTorch, used for CPU tensors and as the kernel's oracle on the card.

All operator tables are built on the host in float64 (carried over verbatim
from the JAX package) and cast once to the working dtype.  The prepass
matmuls run in IEEE float32 (:func:`simpledsp_tpu_torch.precision.ieee_fp32`):
the two-step projection loses about 37 dB at reduced matmul precision.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from simpledsp_tpu_torch.design.biquad import BiquadCascadeDesign
from simpledsp_tpu_torch.kernels import _build
from simpledsp_tpu_torch.kernels.fft import _best_split, _consts
from simpledsp_tpu_torch.ops.iir import block_operators_f64
from simpledsp_tpu_torch.precision import ieee_fp32

__all__ = ["ChainTables", "FusedNorthStarOperators", "chain_frames",
           "chain_frames_reference", "chain_kernel", "chain_prepass",
           "fused_chain_frames", "kernel_supports"]


def kernel_supports(n1: int, n2: int) -> bool:
    """Frames the CUDA kernel takes: every split ``_best_split`` yields
    (n1, n2 <= 128) with n2 even, which the one-sided packing needs."""
    return 1 <= n1 <= 128 and 2 <= n2 <= 128 and n2 % 2 == 0


def _padded_tables(tables: ChainTables, n1: int, n2: int) -> ChainTables:
    """The tables in the kernel's padded shapes (``csrc/chain.cu``): rows
    128 wide and n1 rounded up to n1p, a multiple of 8, with zeros.  The
    tables of an n1 % 8 == 0, n2 == 128 frame are returned as they are."""
    n1p = -(-n1 // 8) * 8
    if n1p == n1 and n2 == 128:
        return tables
    pad = torch.nn.functional.pad

    def cols(t):
        return pad(t, (0, 128 - t.shape[1]))

    def rows(t):
        return pad(t, (0, 0, 0, n1p - t.shape[0]))

    w1 = [pad(w, (0, n1p - n1, 0, n1p - n1))
          for w in (tables.W1cs[:n1], tables.W1cs[n1:])]
    return ChainTables(cols(tables.HT), cols(tables.PhiT),
                       torch.cat(w1).contiguous(), rows(cols(tables.Tc)),
                       rows(cols(tables.Ts)), cols(tables.PQT))


class ChainTables(NamedTuple):
    """Constant tables of the per-frame chain, in the layouts the kernel
    reads (each product's right-hand operand row-major over n2 columns)."""

    HT: torch.Tensor     # (n2, n2)    H^T, H lower-triangular Toeplitz
    PhiT: torch.Tensor   # (D, n2)     Phi^T
    W1cs: torch.Tensor   # (2 n1, n1)  [W1c; W1s], step-1 DFT
    Tc: torch.Tensor     # (n1, n2)    twiddle cos
    Ts: torch.Tensor     # (n1, n2)    twiddle -sin
    PQT: torch.Tensor    # (2 n2, n2)  [P^T; Q^T], packed step-3 DFT


class FusedNorthStarOperators(nn.Module):
    """Host-built float64 operators for one design and frame size, held as
    buffers in ``dtype`` on ``device``.

    Same tables, built by the same float64 code, as the JAX package's
    ``FusedNorthStarOperators``.  The JAX package's grouped ``KTg`` table
    (a block-diagonal copy of ``KT`` that only shrank TPU lane padding) is
    not carried: the two-step projection multiplies by ``KT`` directly.
    """

    def __init__(self, design: BiquadCascadeDesign, fft_size: int,
                 dtype=torch.float32, device=None):
        super().__init__()
        split = _best_split(fft_size)
        if split is None:
            raise ValueError(
                f"fused chain needs fft_size = n1 * n2 with factors <= 128; "
                f"got {fft_size}")
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

        host = dict(
            H=H, Phi=Phi, K=K, Ff=pw[nb], TKt=TKt, KT=K.T, TO=TO, FpT=FpT,
            HT=H.T, PhiT=Phi.T, W1cs=np.concatenate([w1c, w1s], 0),
            Tc=tc.T, Ts=ts.T, PQT=np.concatenate([p_tab.T, q_tab.T], 0))
        npdt = torch.empty((), dtype=dtype).numpy().dtype
        for name, a in host.items():
            self.register_buffer(name, torch.as_tensor(
                np.ascontiguousarray(a).astype(npdt), device=device))
        self._ptabs = {}

    def tables(self) -> ChainTables:
        return ChainTables(self.HT, self.PhiT, self.W1cs, self.Tc, self.Ts,
                           self.PQT)

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


def chain_frames_reference(x3: torch.Tensor, s3: torch.Tensor,
                           tables: ChainTables
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the chain kernel.

    x3 (F, n1, n2) frames, s3 (F, D, n1) sub-block starts (D-major).
    Returns (spec_re, spec_im), each (F, N/2), packed one-sided spectra in
    natural bin order with X[N/2].re in spec_im[:, 0].
    """
    nf, n1, n2 = x3.shape
    h = n2 // 2
    with ieee_fp32():
        y = (torch.einsum("fpj,ji->fpi", x3, tables.HT)
             + torch.einsum("fep,ei->fpi", s3, tables.PhiT))
        cs = torch.einsum("kp,fpt->fkt", tables.W1cs, y)
        c, s = cs[:, :n1], cs[:, n1:]
        tr = c * tables.Tc - s * tables.Ts
        ti = s * tables.Tc + c * tables.Ts
        out = (torch.einsum("fkt,tl->fkl", tr, tables.PQT[:n2])
               + torch.einsum("fkt,tl->fkl", ti, tables.PQT[n2:]))
    alt = torch.ones(n2, dtype=x3.dtype, device=x3.device)
    alt[1::2] = -1.0
    nyq = (tr[:, 0] * alt).sum(-1)
    # (F, k1, k2) -> (F, k2, k1): bin k = k1 + n1 k2 in natural order.
    spec_re = out[:, :, :h].transpose(1, 2).reshape(nf, h * n1)
    spec_im = out[:, :, h:].transpose(1, 2).reshape(nf, h * n1)
    spec_im[:, 0] = nyq
    return spec_re, spec_im


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """``csrc/chain.cu`` built and loaded, its entry point typed."""
    lib = _build.load_library("sdsp_chain", ("chain.cu",))
    fn = lib.sdsp_chain_frames_f32
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


class _ChainKernel:
    """The CUDA chain kernel: built from ``csrc/chain.cu`` at first launch;
    ``launches`` counts the launches made through :func:`chain_frames`."""

    def __init__(self):
        self.launches = 0

    def library(self) -> ctypes.CDLL:
        return _library()

    def __call__(self, x3: torch.Tensor, s3: torch.Tensor,
                 tables: ChainTables) -> Tuple[torch.Tensor, torch.Tensor]:
        nf, n1, n2 = x3.shape
        if not kernel_supports(n1, n2):
            raise ValueError(f"the CUDA chain kernel needs frames of n1 x n2 "
                             f"samples, n1 <= 128 and n2 <= 128 even; got "
                             f"{tuple(x3.shape)}")
        d = s3.shape[1]
        expect = {"x3": (x3, (nf, n1, n2)), "s3": (s3, (nf, d, n1)),
                  "HT": (tables.HT, (n2, n2)), "PhiT": (tables.PhiT, (d, n2)),
                  "W1cs": (tables.W1cs, (2 * n1, n1)),
                  "Tc": (tables.Tc, (n1, n2)), "Ts": (tables.Ts, (n1, n2)),
                  "PQT": (tables.PQT, (2 * n2, n2))}
        for name, (t, shape) in expect.items():
            if t.device != x3.device or t.dtype != torch.float32:
                raise ValueError(f"{name}: the CUDA chain kernel takes float32 "
                                 f"on {x3.device}, got {t.dtype} on {t.device}")
            if tuple(t.shape) != shape or not t.is_contiguous():
                raise ValueError(f"{name}: expected a contiguous {shape}, got "
                                 f"{tuple(t.shape)}")
        tables = _padded_tables(tables, n1, n2)
        spec_re = torch.empty((nf, n1 * n2 // 2), dtype=x3.dtype,
                              device=x3.device)
        spec_im = torch.empty_like(spec_re)
        fn = self.library().sdsp_chain_frames_f32
        stream = torch.cuda.current_stream(x3.device).cuda_stream
        rc = fn(x3.data_ptr(), s3.data_ptr(), tables.HT.data_ptr(),
                tables.PhiT.data_ptr(), tables.W1cs.data_ptr(),
                tables.Tc.data_ptr(), tables.Ts.data_ptr(),
                tables.PQT.data_ptr(), spec_re.data_ptr(), spec_im.data_ptr(),
                nf, n1, n2, d, x3.device.index, stream)
        if rc != 0:
            raise RuntimeError(f"chain kernel launch failed: CUDA error {rc}")
        self.launches += 1
        return spec_re, spec_im


chain_kernel = _ChainKernel()


def chain_frames(x3: torch.Tensor, s3: torch.Tensor, tables: ChainTables
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-frame chain: the CUDA kernel on CUDA tensors, its plain
    version on CPU tensors.  Any other device raises; there is no fallback
    from the kernel to the plain version."""
    if x3.device.type == "cuda":
        return chain_kernel(x3, s3, tables)
    if x3.device.type == "cpu":
        return chain_frames_reference(x3, s3, tables)
    raise ValueError(f"chain_frames runs on CUDA or CPU tensors, got "
                     f"{x3.device}")


def chain_prepass(ops: FusedNorthStarOperators, x: torch.Tensor,
                  s0: torch.Tensor, projection: Optional[str] = None):
    """The matmuls before the kernel: every sub-block's incoming IIR state.

    x is (C, T), T a multiple of fft_size, or pre-framed (C, F, n1, n2);
    s0 is the flat incoming state (C, D).  projection: "two_step" (default:
    kb = K x per sub-block, then the F-power block-Toeplitz combine) or
    "dense" (one x @ TKt matmul); the two agree to rounding.

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
        L_, W_, _ = _frame_prefix_start(tabs, k_frame.transpose(0, 1))
        s_after = _frame_prefix_finish(tabs, L_, W_, s0, nf)
        s_fin = s_after[:, -1]
        s_frames = torch.cat([s0[:, None], s_after[:, :-1]], dim=1)

        # Sub-block starts: state part + input part, D-major, so the
        # (F, n1 D) -> (F, D, n1) view is free.
        starts = s_frames.reshape(f_total, D) @ ops.FpT + kxs
    return xsub.reshape(f_total, n1, n2), starts.reshape(f_total, D, n1), s_fin


def fused_chain_frames(ops: FusedNorthStarOperators, x: torch.Tensor,
                       s0: torch.Tensor, *, projection: Optional[str] = None):
    """Run the fused chain (:func:`chain_prepass`, then :func:`chain_frames`)
    over x (C, T) or (C, F, n1, n2) from the flat state s0 (C, D).

    Returns ((spec_re, spec_im) each (C, F, N/2), s_final (C, D)).
    """
    c = x.shape[0]
    x3, s3, s_fin = chain_prepass(ops, x, s0, projection)
    spec_re, spec_im = chain_frames(x3, s3, ops.tables())
    h = ops.fft_size // 2
    return (spec_re.reshape(c, -1, h), spec_im.reshape(c, -1, h)), s_fin
