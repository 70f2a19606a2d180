"""Cascaded second-order-section IIR filtering on torch tensors.

Port of ``simpledsp_tpu/ops/iir.py``.  Two interchangeable formulations:

1. **Scan oracle** (:func:`sosfilt_scan`): a Python loop over samples
   carrying the explicit :class:`IIRState`.  Exact under any block split;
   the semantic definition every fast path is compared with.

2. **Block state-space path** (:class:`BlockIIR`): the cascade is an LTI
   system of order D = 2(M+1).  Condensing B samples at a time gives

       y_block = H @ x_block + Phi @ s_in      (matmuls, parallel over blocks)
       s_next  = F @ s_in    + K   @ x_block   (D-dim chain, one step a block)

   with H the B-by-B lower-triangular Toeplitz of the impulse response and
   F = A^B.  The operators are built once on the host in float64 (NumPy,
   carried over verbatim) and held as module buffers.

:func:`sosfiltfilt` runs either one forward and backward over the
odd-reflected signal, each pass started in its first sample's steady
state; :func:`sosfilt_zi` gives scipy's form of that state.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from simpledsp_tpu_torch.design.biquad import BiquadCascadeDesign
from simpledsp_tpu_torch.device import resolve_device
from simpledsp_tpu_torch.precision import ieee_fp32

__all__ = [
    "CascadeCoeffs",
    "IIRState",
    "coeffs_from_design",
    "iir_init",
    "iir_preload",
    "sosfilt_scan",
    "sosfilt_zi",
    "BlockIIR",
    "block_operators_f64",
    "block_operators_from_ss_f64",
    "run_state_blocks",
    "sosfilt",
    "sosfiltfilt",
]


class CascadeCoeffs(NamedTuple):
    """Coefficients of a cascade of M biquads (b0 == a0 == 1) as tensors."""

    b1: torch.Tensor  # (M,)
    b2: torch.Tensor  # (M,)
    a1: torch.Tensor  # (M,)
    a2: torch.Tensor  # (M,)
    gain: torch.Tensor  # scalar

    @property
    def nsections(self) -> int:
        return self.b1.shape[0]


class IIRState(NamedTuple):
    """Carried filter state: last two outputs of each cascade node.

    ``y_hist[..., j, 0]`` is node j's output at n-1, ``[..., j, 1]`` at n-2.
    Node 0 is the gained input; node j >= 1 is the output of section j.
    """

    y_hist: torch.Tensor  # (..., M+1, 2)


def coeffs_from_design(design: BiquadCascadeDesign, dtype=torch.float32,
                       device=None) -> CascadeCoeffs:
    def t(v):
        return torch.as_tensor(np.asarray(v), dtype=dtype, device=device)

    return CascadeCoeffs(b1=t(design.b[:, 1]), b2=t(design.b[:, 2]),
                         a1=t(design.a[:, 1]), a2=t(design.a[:, 2]),
                         gain=t(design.gain))


def iir_init(nsections: int, batch_shape: Tuple[int, ...] = (),
             dtype=torch.float32, device=None) -> IIRState:
    """Zero state (cold start), batched over `batch_shape` channels."""
    return IIRState(torch.zeros(tuple(batch_shape) + (nsections + 1, 2),
                                dtype=dtype, device=device))


def _preload_levels_f64(design: BiquadCascadeDesign) -> np.ndarray:
    """Per-node steady-state levels for a UNIT constant input: node 0 holds
    the gain, node j the running product of section DC gains (float64)."""
    v = design.gain
    levels = [v]
    for k in range(design.nsections):
        v = v * design.b[k].sum() / design.a[k].sum()
        levels.append(v)
    return np.asarray(levels, dtype=np.float64)


def sosfilt_zi(sos) -> np.ndarray:
    """Steady-state DF2T initial conditions for a unit-step input through
    an (n, 6) SOS cascade (scipy.signal.sosfilt_zi semantics): section
    k's lfilter_zi scaled by the DC gain of the sections before it.
    Host float64, the scipy counterpart of :func:`iir_preload`."""
    from simpledsp_tpu_torch.ops.lfilter import lfilter_zi

    sos = np.asarray(sos, dtype=np.float64)
    if sos.ndim != 2 or sos.shape[1] != 6:
        raise ValueError(f"sos must be (n, 6), got {sos.shape}")
    n = sos.shape[0]
    zi = np.empty((n, 2))
    scale = 1.0
    for k in range(n):
        b, a = sos[k, :3], sos[k, 3:]
        zi[k] = scale * lfilter_zi(b, a)
        scale *= b.sum() / a.sum()
    return zi


def iir_preload(design: BiquadCascadeDesign, value: float,
                batch_shape: Tuple[int, ...] = (), dtype=torch.float32,
                device=None) -> IIRState:
    """Steady-state preload: constant input `value` produces zero transient.

    Node 0 holds value*gain and each later node the running product of
    section DC gains (0 after the first section for HP/BP).
    """
    hist = np.repeat(float(value) * _preload_levels_f64(design)[:, None],
                     2, axis=1)
    full = np.broadcast_to(hist, tuple(batch_shape) + hist.shape)
    return IIRState(torch.as_tensor(np.ascontiguousarray(full), dtype=dtype,
                                    device=device))


def _odd_extend(x: torch.Tensor, padlen: int) -> torch.Tensor:
    """Odd reflection of ``padlen`` samples about both ends (scipy's
    filtfilt padding):
    2 x[0] - x[padlen:0:-1]  |  x  |  2 x[-1] - x[-2:-padlen-2:-1]."""
    if padlen == 0:
        return x
    T = x.shape[-1]
    head = 2.0 * x[..., :1] - x[..., 1: padlen + 1].flip(-1)
    tail = 2.0 * x[..., -1:] - x[..., T - padlen - 1: T - 1].flip(-1)
    return torch.cat([head, x, tail], dim=-1)


def _preload_from_values(design: BiquadCascadeDesign,
                         values: torch.Tensor) -> IIRState:
    """Batched preload: steady state for per-signal constant inputs
    ``values`` (...,), scipy's ``zi * x[0]`` edge initialization."""
    lev = torch.as_tensor(_preload_levels_f64(design), dtype=values.dtype,
                          device=values.device)
    hist = values[..., None, None] * lev[:, None]       # (..., M+1, 1)
    return IIRState(hist.expand(values.shape + (design.nsections + 1, 2)))


# ---------------------------------------------------------------------------
# 1. Scan oracle — semantic ground truth
# ---------------------------------------------------------------------------

def sosfilt_scan(coeffs: CascadeCoeffs, x: torch.Tensor,
                 state: IIRState) -> Tuple[torch.Tensor, IIRState]:
    """Filter `x` (time on the last axis) one sample at a time.

    Exact under any block split (the streaming contract).  Serial: use
    :class:`BlockIIR` for throughput.
    """
    m = coeffs.nsections
    b1, b2 = coeffs.b1.unbind(), coeffs.b2.unbind()
    a1, a2 = coeffs.a1.unbind(), coeffs.a2.unbind()
    prev1 = list(state.y_hist[..., 0].unbind(-1))  # node j at n-1
    prev2 = list(state.y_hist[..., 1].unbind(-1))  # node j at n-2
    out = []
    for xn in x.unbind(-1):
        v = xn * coeffs.gain
        nodes = [v]
        for j in range(m):
            v = (v + b1[j] * prev1[j] + b2[j] * prev2[j]
                 - a1[j] * prev1[j + 1] - a2[j] * prev2[j + 1])
            nodes.append(v)
        prev2, prev1 = prev1, nodes
        out.append(v)
    if out:
        y = torch.stack(out, dim=-1)
    else:
        y = x[..., :0]
    y_hist = torch.stack([torch.stack(prev1, -1), torch.stack(prev2, -1)], -1)
    return y, IIRState(y_hist)


# ---------------------------------------------------------------------------
# 2. Block state-space path — matmuls
# ---------------------------------------------------------------------------

def _state_space_f64(design: BiquadCascadeDesign):
    """Derive the one-step LTI form  s' = A s + p x,  y = c.s + d x  in f64.

    Probes the (linear) cascade step with unit vectors — consistent with the
    scan oracle by construction.
    """
    m = design.nsections
    d_dim = 2 * (m + 1)

    b1 = design.b[:, 1]
    b2 = design.b[:, 2]
    a1 = design.a[:, 1]
    a2 = design.a[:, 2]
    gain = design.gain

    def step_np(y_hist, x):
        # y_hist: (m+1, 2) float64
        v = x * gain
        nodes = [v]
        for j in range(m):
            v = (v + b1[j] * y_hist[j, 0] + b2[j] * y_hist[j, 1]
                 - a1[j] * y_hist[j + 1, 0] - a2[j] * y_hist[j + 1, 1])
            nodes.append(v)
        y_new = np.asarray(nodes)
        nxt = np.stack([y_new, y_hist[:, 0]], axis=-1)
        return nxt, nodes[-1]

    A = np.zeros((d_dim, d_dim))
    c = np.zeros(d_dim)
    for i in range(d_dim):
        e = np.zeros(d_dim)
        e[i] = 1.0
        nxt, y = step_np(e.reshape(m + 1, 2), 0.0)
        A[:, i] = nxt.reshape(-1)
        c[i] = y
    nxt, y = step_np(np.zeros((m + 1, 2)), 1.0)
    p = nxt.reshape(-1)
    d = y
    return A, p, c, d


def block_operators_from_ss_f64(A: np.ndarray, p: np.ndarray,
                                c: np.ndarray, d: float, block_size: int):
    """Block-condensation operators for ANY one-step LTI quadruple
    ``s' = A s + p x, y = c.s + d x`` (float64 host math).

    Returns (H, Phi, K, F):
      H   (B, B)  lower-triangular Toeplitz of the impulse response
      Phi (B, D)  initial-state response of each in-block output
      K   (D, B)  input-to-final-state map
      F   (D, D)  B-step state transition A^B
    """
    B = int(block_size)
    D = A.shape[0]

    powers = np.empty((B + 1, D, D))
    powers[0] = np.eye(D)
    for i in range(1, B + 1):
        powers[i] = A @ powers[i - 1]

    h = np.empty(B)
    h[0] = d
    for k in range(1, B):
        h[k] = c @ powers[k - 1] @ p
    idx = np.subtract.outer(np.arange(B), np.arange(B))
    H = np.where(idx >= 0, h[np.clip(idx, 0, B - 1)], 0.0)

    Phi = np.stack([c @ powers[i] for i in range(B)])
    K = np.stack([powers[B - 1 - j] @ p for j in range(B)], axis=1)
    F = powers[B]
    return H, Phi, K, F


def block_operators_f64(design: BiquadCascadeDesign, block_size: int):
    """Host-side float64 block-condensation operators for a B-sample block
    of the biquad cascade (see :func:`block_operators_from_ss_f64`).

    Returns (H, Phi, K, F, A, p, c, d) with D = 2(M+1)."""
    A, p, c, d = _state_space_f64(design)
    H, Phi, K, F = block_operators_from_ss_f64(A, p, c, d, block_size)
    return H, Phi, K, F, A, p, c, d


def run_state_blocks(xb: torch.Tensor, s0: torch.Tensor, H: torch.Tensor,
                     Phi: torch.Tensor, K: torch.Tensor, F: torch.Tensor):
    """Apply the block operators of :func:`block_operators_from_ss_f64` to
    xb (..., nblocks, B) full blocks from the state s0 (..., D), in IEEE
    float32 for float32 operands.  Returns (y (..., nblocks, B),
    s_final (..., D))."""
    with ieee_fp32():
        conv = torch.matmul(xb, H.T)                    # (..., nb, B)
        kx = torch.matmul(xb, K.T)                      # (..., nb, D)
        # The D-dim state chain, one block at a time (the block count is the
        # only serial dimension left).
        s = s0
        starts = []
        for kxk in kx.unbind(-2):
            starts.append(s)
            s = torch.matmul(s, F.T) + kxk
        s_starts = torch.stack(starts, dim=-2)          # (..., nb, D)
        y = conv + torch.matmul(s_starts, Phi.T)
    return y, s


class BlockIIR(nn.Module):
    """Block-parallel IIR for one design, operators held as buffers.

    Usage::

        f = BlockIIR(design, block_size=256, dtype=torch.float32, device="cuda")
        y, state = f(x, state)          # x: (..., T), T % block_size free

    Splitting the signal at multiples of `block_size` gives the same result;
    the sub-block tail runs through the scan oracle.
    """

    def __init__(self, design: BiquadCascadeDesign, block_size: int = 256,
                 dtype=torch.float32, device=None):
        super().__init__()
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        device = resolve_device(device)
        self.design = design
        self.block_size = int(block_size)
        H, Phi, K, F, *_ = block_operators_f64(design, self.block_size)
        for name, a in (("H", H), ("Phi", Phi), ("K", K), ("F", F)):
            self.register_buffer(
                name, torch.as_tensor(a, dtype=dtype, device=device))

    def run_blocks(self, xb: torch.Tensor, s0: torch.Tensor):
        """xb: (..., nblocks, B) full blocks; s0: (..., D) flat state.
        Returns (y (..., nblocks, B), s_final (..., D))."""
        return run_state_blocks(xb, s0, self.H, self.Phi, self.K, self.F)

    def forward(self, x: torch.Tensor, state: Optional[IIRState] = None
                ) -> Tuple[torch.Tensor, IIRState]:
        m = self.design.nsections
        if state is None:
            state = iir_init(m, x.shape[:-1], dtype=self.H.dtype,
                             device=x.device)
        T = x.shape[-1]
        B = self.block_size
        nfull = T // B
        rem = T - nfull * B

        s0 = state.y_hist.reshape(state.y_hist.shape[:-2] + (-1,))
        if nfull > 0:
            xb = x[..., : nfull * B].reshape(x.shape[:-1] + (nfull, B))
            yb, s_end = self.run_blocks(xb, s0)
            y_main = yb.reshape(x.shape[:-1] + (nfull * B,))
            state = IIRState(s_end.reshape(s_end.shape[:-1] + (m + 1, 2)))
        else:
            y_main = x[..., :0]

        if rem:
            coeffs = coeffs_from_design(self.design, dtype=self.H.dtype,
                                        device=x.device)
            y_tail, state = sosfilt_scan(coeffs, x[..., nfull * B:], state)
            return torch.cat([y_main, y_tail], dim=-1), state
        return y_main, state


def sosfiltfilt(design: BiquadCascadeDesign, x: torch.Tensor, *,
                padlen: Optional[int] = None, method: str = "auto",
                block_size: int = 256, dtype=None) -> torch.Tensor:
    """Zero-phase forward-backward cascade filtering
    (scipy.signal.sosfiltfilt semantics: odd-reflection padding, each
    pass started in the steady state of its first sample through the
    preload levels).  x: (..., T) -> (..., T)."""
    m = design.nsections
    nzero = min(int(np.sum(design.b[:, 2] == 0.0)),
                int(np.sum(design.a[:, 2] == 0.0)))
    if padlen is None:
        padlen = 3 * (2 * m + 1 - nzero)
    T = x.shape[-1]
    if padlen >= T:
        raise ValueError(f"padlen={padlen} must be less than the signal "
                         f"length {T}")
    dtype = dtype or x.dtype
    x = x.to(dtype)
    def one_pass(sig):
        s0 = _preload_from_values(design, sig[..., 0])
        y, _ = sosfilt(design, sig, s0, method=method,
                       block_size=block_size, dtype=dtype)
        return y.flip(-1)

    return one_pass(one_pass(_odd_extend(x, padlen)))[..., padlen: padlen + T]


def sosfilt(design: BiquadCascadeDesign, x: torch.Tensor,
            state: Optional[IIRState] = None, *, method: str = "auto",
            block_size: int = 256, dtype=None) -> Tuple[torch.Tensor, IIRState]:
    """One-shot convenience wrapper.

    method: 'scan' (oracle), 'block' (matmul path), or 'auto'.
    For hot loops, construct a `BlockIIR` once and reuse it.
    """
    dtype = dtype or x.dtype
    if method not in ("auto", "scan", "block"):
        raise ValueError(f"unknown method {method!r}")
    x = x.to(dtype)
    if state is None:
        state = iir_init(design.nsections, x.shape[:-1], dtype=dtype,
                         device=x.device)
    if method == "scan" or (method == "auto" and x.shape[-1] < 4 * block_size):
        coeffs = coeffs_from_design(design, dtype=dtype, device=x.device)
        return sosfilt_scan(coeffs, x, state)
    return BlockIIR(design, block_size=block_size, dtype=dtype,
                    device=x.device)(x, state)
