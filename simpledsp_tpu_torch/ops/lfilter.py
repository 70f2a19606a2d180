"""Generic transfer-function IIR/FIR filtering on torch tensors: lfilter /
filtfilt.

Port of ``simpledsp_tpu/ops/lfilter.py``.  Two interchangeable formulations
of scipy.signal's ``lfilter`` for an arbitrary (b, a):

1. **Scan oracle** (:func:`lfilter_scan`): direct-form II transposed, one
   sample at a time in a Python loop carrying scipy's ``zi`` state vector.
   Exact under any block split; the semantic definition.
2. **Block state-space path** (:class:`BlockLFilter`): the DF2T companion
   form condensed over B-sample blocks into dense matmuls
   (``ops/iir.block_operators_from_ss_f64``), the machinery of ``BlockIIR``:
   the serial dimension left is the block count.

``filtfilt`` (zero-phase forward-backward with odd-reflection padding and
steady-state edge initialization) matches scipy.signal.filtfilt defaults.
The coefficient analysis (``tf_state_space_f64``, the ``freq*`` family,
``lfilter_zi``, ``lfiltic``) is host float64 NumPy, carried verbatim.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from simpledsp_tpu_torch.device import resolve_device
from simpledsp_tpu_torch.ops.iir import (_odd_extend,
                                         block_operators_from_ss_f64,
                                         run_state_blocks)

__all__ = ["lfilter", "lfilter_scan", "lfilter_zi", "lfiltic",
           "BlockLFilter", "filtfilt", "freqz", "freqs", "freqs_zpk",
           "freqz_zpk", "tf_state_space_f64"]


def _normalize_ba(b, a) -> Tuple[np.ndarray, np.ndarray]:
    b = np.atleast_1d(np.asarray(b, dtype=np.float64))
    a = np.atleast_1d(np.asarray(a, dtype=np.float64))
    if b.ndim != 1 or a.ndim != 1:
        raise ValueError("b and a must be 1-D coefficient vectors")
    if a.size == 0 or a[0] == 0.0:
        raise ValueError("a[0] must be nonzero")
    return b / a[0], a / a[0]


def tf_state_space_f64(b, a):
    """DF2T companion-form state space of H(z) = B(z)/A(z), float64.

    With D = max(len(a), len(b)) - 1 and coefficients zero-padded to
    D + 1:  s' = A s + p x,  y = c.s + d x  where the state s IS scipy's
    lfilter `zi` vector (direct-form II transposed delays):

        y    = b0 x + z0
        z_i' = z_{i+1} + b_{i+1} x - a_{i+1} y
    """
    b, a = _normalize_ba(b, a)
    D = max(b.size, a.size) - 1
    if D == 0:
        return (np.zeros((0, 0)), np.zeros(0), np.zeros(0), float(b[0]))
    bp = np.zeros(D + 1)
    bp[: b.size] = b
    ap = np.zeros(D + 1)
    ap[: a.size] = a
    A = np.zeros((D, D))
    A[:, 0] = -ap[1:]
    A[: D - 1, 1:] = np.eye(D - 1)
    p = bp[1:] - ap[1:] * bp[0]
    c = np.zeros(D)
    c[0] = 1.0
    return A, p, c, float(bp[0])


def freqz(b, a=1.0, n: int = 512, *, fs: float = 2.0 * np.pi
          ) -> Tuple[np.ndarray, np.ndarray]:
    """Frequency response of B(z)/A(z) on n points of [0, fs/2)
    (scipy.signal.freqz(worN=n) semantics; host float64)."""
    b64, a64 = _normalize_ba(b, a)
    w = np.linspace(0.0, np.pi, n, endpoint=False)
    z = np.exp(-1j * w)
    h = np.polynomial.polynomial.polyval(z, b64) / \
        np.polynomial.polynomial.polyval(z, a64)
    return w * (fs / (2.0 * np.pi)), h


def freqs(b, a, worN=200) -> Tuple[np.ndarray, np.ndarray]:
    """Analog (s-domain) frequency response of B(s)/A(s)
    (scipy.signal.freqs semantics, including the POSITIONAL worN
    convention): an integer picks that many log-spaced points around the
    system's interesting range; an array evaluates H(jw) at those rad/s
    points."""
    b64 = np.atleast_1d(np.asarray(b, dtype=np.float64))
    a64 = np.atleast_1d(np.asarray(a, dtype=np.float64))
    worN_arr = np.asarray(worN)
    if worN_arr.ndim == 0 and np.issubdtype(worN_arr.dtype, np.integer):
        roots = np.concatenate([np.roots(a64) if a64.size > 1 else [],
                                np.roots(b64) if b64.size > 1 else []])
        mags = np.abs(roots[np.abs(roots) > 0]) if roots.size else []
        center = np.median(mags) if len(mags) else 1.0
        w = np.logspace(np.log10(center) - 2, np.log10(center) + 2,
                        int(worN))
    else:
        w = np.atleast_1d(worN_arr.astype(np.float64))
    s = 1j * w
    h = np.polyval(b64, s) / np.polyval(a64, s)
    return w, h


def freqs_zpk(z, p, k: float, worN) -> Tuple[np.ndarray, np.ndarray]:
    """Analog frequency response from zeros/poles/gain
    (scipy.signal.freqs_zpk semantics, explicit ``worN``): evaluated as
    a product over roots, so high orders stay well-conditioned."""
    w = np.atleast_1d(np.asarray(worN, dtype=np.float64))
    s = 1j * w
    h = np.full(w.shape, complex(k))
    for zi in np.atleast_1d(z):
        h *= s - zi
    for pi in np.atleast_1d(p):
        h /= s - pi
    return w, h


def freqz_zpk(z, p, k: float, n=512, *, fs: float = 2.0 * np.pi
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Digital frequency response from zeros/poles/gain
    (scipy.signal.freqz_zpk semantics): product over roots on the unit
    circle.  ``n`` is a point count over [0, fs/2), or an explicit array
    of frequencies in the units of ``fs`` (scipy's worN array form)."""
    n_arr = np.asarray(n)
    if n_arr.ndim == 0 and np.issubdtype(n_arr.dtype, np.integer):
        w = np.linspace(0.0, np.pi, int(n), endpoint=False)
    else:
        w = np.atleast_1d(n_arr.astype(np.float64)) * (2.0 * np.pi / fs)
    zv = np.exp(1j * w)
    h = np.full(w.shape, complex(k))
    for zi in np.atleast_1d(z):
        h *= zv - zi
    for pi in np.atleast_1d(p):
        h /= zv - pi
    return w * (fs / (2.0 * np.pi)), h


def lfilter_zi(b, a) -> np.ndarray:
    """Steady-state DF2T state for unit step input
    (scipy.signal.lfilter_zi): the zi that makes a constant input produce
    its DC-gain output with zero transient."""
    A, p, c, d = tf_state_space_f64(b, a)
    D = A.shape[0]
    if D == 0:
        return np.zeros(0)
    return np.linalg.solve(np.eye(D) - A, p)


def lfiltic(b, a, y, x=None) -> np.ndarray:
    """Initial lfilter state reproducing given past outputs ``y`` (and
    past inputs ``x``): scipy.signal.lfiltic semantics, returning the
    direct-form-II-transposed ``zi`` this module's lfilter consumes.

    z[i] carries sum_{j>i} (b[j] x[t-(j-i)] - a[j] y[t-(j-i)]); with
    scipy's ordering y[-1], y[-2], ... = y[0], y[1], ... each state entry
    is a finite double sum over the known history, zero beyond the
    provided samples."""
    b64, a64 = _normalize_ba(b, a)
    n = max(b64.size, a64.size)
    bp = np.zeros(n)
    bp[: b64.size] = b64
    ap = np.zeros(n)
    ap[: a64.size] = a64
    y = np.atleast_1d(np.asarray(y, dtype=np.float64))
    x = (np.zeros(0) if x is None
         else np.atleast_1d(np.asarray(x, dtype=np.float64)))
    zi = np.zeros(n - 1)
    for i in range(n - 1):
        acc = 0.0
        for j in range(i + 1, n):
            lag = j - i - 1          # y[-1 - lag] == y[lag] in scipy order
            if lag < x.size:
                acc += bp[j] * x[lag]
            if lag < y.size:
                acc -= ap[j] * y[lag]
        zi[i] = acc
    return zi


def _padded_ba(b, a) -> Tuple[np.ndarray, np.ndarray, int]:
    b, a = _normalize_ba(b, a)
    D = max(b.size, a.size) - 1
    bp = np.zeros(D + 1)
    bp[: b.size] = b
    ap = np.zeros(D + 1)
    ap[: a.size] = a
    return bp, ap, D


def _as_state(zi, shape, dtype, device) -> torch.Tensor:
    if zi is None:
        return torch.zeros(shape, dtype=dtype, device=device)
    return torch.as_tensor(zi, dtype=dtype, device=device)


def lfilter_scan(b, a, x: torch.Tensor, zi: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Direct-form II transposed sample loop (scipy.signal.lfilter
    semantics, always returning (y, zf)).  x: (..., T); zi: (..., D).

    Serial, a few small ops a sample: :class:`BlockLFilter` is the
    throughput path."""
    bp, ap, D = _padded_ba(b, a)
    bj = torch.as_tensor(bp, dtype=x.dtype, device=x.device)
    aj = torch.as_tensor(ap, dtype=x.dtype, device=x.device)
    z = _as_state(zi, x.shape[:-1] + (D,), x.dtype, x.device)
    if D == 0:
        return bj[0] * x, z
    b0, b_rest, a_rest = bj[0], bj[1:], aj[1:]
    pad = torch.zeros_like(z[..., :1])
    out = []
    for xs in x.unbind(-1):
        y = b0 * xs + z[..., 0]
        z_shift = torch.cat([z[..., 1:], pad], dim=-1)
        z = z_shift + b_rest * xs[..., None] - a_rest * y[..., None]
        out.append(y)
    y = torch.stack(out, dim=-1) if out else x[..., :0]
    return y, z


class BlockLFilter(nn.Module):
    """Block state-space path for an arbitrary (b, a) transfer function:
    the DF2T recurrence condensed over B-sample blocks into dense matmuls
    (the machinery of :class:`~simpledsp_tpu_torch.ops.iir.BlockIIR`;
    operators built in float64 on the host and held as buffers in
    ``dtype`` on ``device``; ``device=None`` means CUDA).

    The state is scipy's ``zi`` vector, so results (and streaming splits
    at multiples of ``block_size``) are interchangeable with
    :func:`lfilter_scan` up to float reassociation within full blocks.
    """

    def __init__(self, b, a, block_size: int = 256, dtype=torch.float32,
                 device=None):
        super().__init__()
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        device = resolve_device(device)
        self.b, self.a = _normalize_ba(b, a)
        self.block_size = int(block_size)
        self.dtype = dtype
        A, p, c, d = tf_state_space_f64(self.b, self.a)
        self.state_dim = A.shape[0]
        ops = block_operators_from_ss_f64(A, p, c, d, self.block_size)
        for name, m in zip(("H", "Phi", "K", "F"), ops):
            self.register_buffer(
                name, torch.as_tensor(m, dtype=dtype, device=device))

    def run_blocks(self, xb: torch.Tensor, s0: torch.Tensor):
        """xb: (..., nblocks, B) full blocks; s0: (..., D) state.
        Returns (y (..., nblocks, B), s_final (..., D))."""
        return run_state_blocks(xb, s0, self.H, self.Phi, self.K, self.F)

    def forward(self, x: torch.Tensor, zi: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        D = self.state_dim
        x = x.to(self.dtype)
        zi = _as_state(zi, x.shape[:-1] + (D,), self.dtype, x.device)
        if D == 0:
            return float(self.b[0]) * x, zi
        T = x.shape[-1]
        B = self.block_size
        nfull = T // B
        rem = T - nfull * B
        if nfull > 0:
            xb = x[..., : nfull * B].reshape(x.shape[:-1] + (nfull, B))
            yb, zi = self.run_blocks(xb, zi)
            y_main = yb.reshape(x.shape[:-1] + (nfull * B,))
        else:
            y_main = x[..., :0]
        if rem:
            y_tail, zi = lfilter_scan(self.b, self.a, x[..., nfull * B:], zi)
            return torch.cat([y_main, y_tail], dim=-1), zi
        return y_main, zi


def lfilter(b, a, x: torch.Tensor, zi: Optional[torch.Tensor] = None, *,
            method: str = "auto", block_size: int = 256,
            dtype=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Filter x along its last axis with the transfer function B(z)/A(z)
    (scipy.signal.lfilter semantics; ALWAYS returns (y, zf), the explicit
    state of a stream).

    method: 'scan' (oracle), 'block' (matmul path) or 'auto' (the block
    path from 4 blocks up).  The block path is built on ``x.device``.
    """
    if method not in ("auto", "scan", "block"):
        raise ValueError(f"unknown method {method!r}")
    dtype = dtype or x.dtype
    x = x.to(dtype)
    if method == "scan" or (method == "auto"
                            and x.shape[-1] < 4 * block_size):
        return lfilter_scan(b, a, x, zi)
    return BlockLFilter(b, a, block_size=block_size, dtype=dtype,
                        device=x.device)(x, zi)


def filtfilt(b, a, x: torch.Tensor, *, padlen: Optional[int] = None,
             method: str = "auto", dtype=None) -> torch.Tensor:
    """Zero-phase forward-backward filtering (scipy.signal.filtfilt with
    the default odd-reflection padding and steady-state edge init)."""
    b64, a64 = _normalize_ba(b, a)
    ntaps = max(b64.size, a64.size)
    if padlen is None:
        padlen = 3 * ntaps
    T = x.shape[-1]
    if padlen >= T:
        raise ValueError(f"padlen={padlen} must be less than the signal "
                         f"length {T}")
    dtype = dtype or x.dtype
    x = x.to(dtype)
    ext = _odd_extend(x, padlen)
    zi = torch.as_tensor(lfilter_zi(b64, a64), dtype=dtype, device=x.device)
    y, _ = lfilter(b64, a64, ext, zi * ext[..., :1], method=method,
                   dtype=dtype)
    y = y.flip(-1)
    y, _ = lfilter(b64, a64, y, zi * y[..., :1], method=method, dtype=dtype)
    return y.flip(-1)[..., padlen: padlen + T]
