"""B-spline interpolation family (scipy.signal parity, host-side f64).

Port of ``simpledsp_tpu/ops/splines.py``.  The spline PREFILTERS — the
inverse-basis first-order filters run forward and backward with exact
mirror-symmetric initialization, and the smoothing branch's second-order
recurrences (``symiirorder2``, ``cspline1d(lamb > 0)``,
``cspline2d(lamb > 1/144)``, ``spline_filter``) — and the basis
evaluation are the JAX package's NumPy code, copied: they give its bits.
A signal given as a tensor, on any device, is fetched to the host first,
and these functions return NumPy arrays, as there.

Two functions work on tensors, on their device: ``gauss_spline``
(elementwise) and ``sepfir2d``, whose two 1-D passes are one ``F.conv2d``
each, with a (1, k) or (k, 1) filter, over the mirror-symmetric padded
planes (numpy's 'symmetric' rule, built as one gather), in IEEE float32.
The boundary series of the smoothing prefilters are truncated by the
coefficient-magnitude rule pinned against scipy's compiled
symiirorder2_ic_fwd/bwd (default precision 1e-11 for float64 input and
1e-6 for float32).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from simpledsp_tpu_torch.ops.conv2d import _extend_index
from simpledsp_tpu_torch.precision import ieee_fp32
from simpledsp_tpu_torch.utils.host import to_numpy

__all__ = ["gauss_spline", "cspline1d", "qspline1d", "cspline1d_eval",
           "qspline1d_eval", "sepfir2d", "symiirorder1", "symiirorder2",
           "cspline2d", "qspline2d", "spline_filter"]

_NOCONV = "Sum to find symmetric boundary conditions did not converge."


def _default_precision(dtype) -> float:
    """scipy's compiled spline routines default the boundary-series
    truncation to 1e-11 in double and 1e-6 in single precision."""
    return 1e-6 if np.dtype(dtype) in (np.float32, np.complex64) else 1e-11


def gauss_spline(x, n: int) -> torch.Tensor:
    """Gaussian approximation of an order-``n`` B-spline
    (scipy.signal.gauss_spline semantics), elementwise on ``x``'s
    device."""
    x = torch.as_tensor(x)
    sigsq = (n + 1) / 12.0
    return torch.exp(-x * x / (2.0 * sigsq)) / math.sqrt(2.0 * np.pi * sigsq)


def _iir1_np(x: np.ndarray, z1: float, y_prev: np.ndarray) -> np.ndarray:
    """First-order recurrence y[k] = x[k] + z1 y[k-1] over the LAST axis
    in pure NumPy float64 (these are host-side design/analysis filters:
    no JAX backend, no x64 flag dependence, no device dispatch).  Chunked
    lower-triangular Toeplitz matmuls — O(n L) with L = 64, ~vectorized.
    ``y_prev``: (...,) carried value y[-1]."""
    n = x.shape[-1]
    L = 64
    powers = z1 ** np.arange(1, L + 1)
    tt = np.zeros((L, L))
    for d in range(L):
        tt[np.arange(d, L), np.arange(L - d)] = z1 ** d
    out = np.empty_like(x)
    carry = np.asarray(y_prev, dtype=np.float64)
    for s0 in range(0, n, L):
        chunk = x[..., s0: s0 + L]
        m = chunk.shape[-1]
        y = np.einsum("kj,...j->...k", tt[:m, :m], chunk) \
            + carry[..., None] * powers[:m]
        out[..., s0: s0 + L] = y
        carry = y[..., -1]
    return out


def _spline_coeff(signal: np.ndarray, zi: float, gain: float) -> np.ndarray:
    """Forward+backward first-order inverse-basis filter with the exact
    mirror-symmetric initialization (scipy's _cubic_coeff/_quadratic_coeff
    recurrences), in host NumPy float64."""
    x0 = np.asarray(to_numpy(signal))
    if np.iscomplexobj(x0):
        raise ValueError("complex signals are carried as RI planes "
                         "framework-wide; spline prefilters take real "
                         "arrays")
    x = x0.astype(np.float64)
    k = x.size
    powers = zi ** np.arange(k)
    if k == 1:
        # scipy's single-sample branch returns BEFORE its gain multiply
        # (an upstream quirk) — replicated for exact parity.
        yplus = x[0] + zi * np.sum(powers * x)
        return np.atleast_1d(zi / (zi - 1.0) * yplus)
    # Forward: yplus[n] = x[n] + zi yplus[n-1], seeded by the mirror sum.
    y0 = np.sum(powers * x)
    yplus = _iir1_np(x, zi, np.asarray(y0))
    # Backward: out[k] = zi (out[k+1] - yplus[k]), anchored at the end.
    out_last = zi / (zi - 1.0) * yplus[-1]
    rev = _iir1_np(-zi * yplus[-2::-1], zi, np.asarray(out_last))
    out = np.concatenate([rev[::-1], [out_last]])
    return (out * gain).astype(x0.dtype, copy=False) \
        if np.issubdtype(x0.dtype, np.floating) else out * gain


def cspline1d(signal, lamb: float = 0.0) -> np.ndarray:
    """Cubic-spline coefficients of equally spaced samples
    (scipy.signal.cspline1d semantics): the exact inverse-basis
    prefilter at lamb = 0, or the smoothing-spline prefilter for
    lamb > 0 (batched over leading axes)."""
    if lamb != 0.0:
        x0 = np.asarray(to_numpy(signal))
        if np.iscomplexobj(x0):
            raise ValueError("complex signals are carried as RI planes "
                             "framework-wide; spline prefilters take "
                             "real arrays")
        out = _cubic_smooth_coeff(x0, lamb)
        return out.astype(x0.dtype, copy=False) \
            if np.issubdtype(x0.dtype, np.floating) else out
    return _spline_coeff(signal, -2.0 + math.sqrt(3.0), 6.0)


def qspline1d(signal, lamb: float = 0.0) -> np.ndarray:
    """Quadratic-spline coefficients (scipy.signal.qspline1d semantics)."""
    if lamb != 0.0:
        raise ValueError("smoothing quadratic splines not supported")
    return _spline_coeff(signal, -3.0 + 2.0 * math.sqrt(2.0), 8.0)


def _bspline3(x: np.ndarray) -> np.ndarray:
    """Cubic B-spline basis (closed form)."""
    ax = np.abs(x)
    out = np.where(ax <= 1.0, 2.0 / 3.0 - ax * ax + ax ** 3 / 2.0, 0.0)
    mid = (ax > 1.0) & (ax < 2.0)
    out = np.where(mid, (2.0 - ax) ** 3 / 6.0, out)
    return out


def _bspline2(x: np.ndarray) -> np.ndarray:
    """Quadratic B-spline basis (closed form)."""
    ax = np.abs(x)
    out = np.where(ax <= 0.5, 0.75 - ax * ax, 0.0)
    mid = (ax > 0.5) & (ax < 1.5)
    out = np.where(mid, (ax - 1.5) ** 2 / 2.0, out)
    return out


def _mirror_fold(t: np.ndarray, n: int) -> np.ndarray:
    """Fold arbitrary sample positions into [0, n-1] by mirror symmetry
    about both ends (one modular step instead of scipy's recursion)."""
    period = 2.0 * (n - 1)
    if period <= 0:
        return np.zeros_like(t)
    t = np.abs(t) % period
    return np.minimum(t, period - t)


def _spline_eval(cj, newx, dx: float, x0: float, basis, support: int
                 ) -> np.ndarray:
    cj = np.asarray(to_numpy(cj), dtype=np.float64)
    if cj.size == 0:
        raise ValueError("spline coefficients must not be empty")
    t = _mirror_fold((np.asarray(to_numpy(newx), dtype=np.float64) - x0)
                     / float(dx), cj.size)
    if support == 4:
        jlower = np.floor(t - 2.0).astype(np.int64) + 1
    else:
        jlower = np.floor(t - 1.5).astype(np.int64) + 1
    res = np.zeros_like(t)
    for i in range(support):
        thisj = jlower + i
        indj = np.clip(thisj, 0, cj.size - 1)
        res += cj[indj] * basis(t - thisj)
    return res


def cspline1d_eval(cj, newx, dx: float = 1.0, x0: float = 0.0) -> np.ndarray:
    """Evaluate a cubic spline at ``newx`` from its coefficients
    (scipy.signal.cspline1d_eval semantics: mirror-symmetric extension
    beyond the knots, handled here by one modular fold instead of
    recursion)."""
    return _spline_eval(cj, newx, dx, x0, _bspline3, 4)


def qspline1d_eval(cj, newx, dx: float = 1.0, x0: float = 0.0) -> np.ndarray:
    """Evaluate a quadratic spline (scipy.signal.qspline1d_eval
    semantics)."""
    return _spline_eval(cj, newx, dx, x0, _bspline2, 3)


def sepfir2d(x: torch.Tensor, hrow, hcol) -> torch.Tensor:
    """Separable 2-D FIR with mirror-symmetric boundaries and same-size
    output (scipy.signal.sepfir2d semantics; odd-length filters).
    Batched over leading axes; each 1-D pass is one ``F.conv2d`` with a
    (1, k) or (k, 1) filter over the planes padded by numpy's 'symmetric'
    rule (the edge sample repeated, period 2n: any filter length)."""
    hrow = np.asarray(to_numpy(hrow), dtype=np.float64)
    hcol = np.asarray(to_numpy(hcol), dtype=np.float64)
    if hrow.ndim != 1 or hcol.ndim != 1 or not (hrow.size % 2) \
            or not (hcol.size % 2):
        raise ValueError("hrow and hcol must be 1-D with odd length")
    x = torch.as_tensor(x)
    if x.ndim < 2:
        raise ValueError("sepfir2d needs at least 2 dims")
    return _sep_pass(_sep_pass(x, hrow, -1), hcol, -2)


@functools.lru_cache(maxsize=64)
def _pass_weight(taps: tuple, axis: int, dtype: torch.dtype,
                 device: torch.device) -> torch.Tensor:
    """The conv2d weight of a pass: (1, 1, 1, k) along -1, (1, 1, k, 1)
    along -2; cached on ``device``, so a call uploads nothing."""
    shape = (1, 1, 1, len(taps)) if axis == -1 else (1, 1, len(taps), 1)
    return torch.tensor(taps, dtype=dtype, device=device).reshape(shape)


def _sep_pass(img: torch.Tensor, taps: np.ndarray, axis: int
              ) -> torch.Tensor:
    """One same-size pass of ``taps`` along ``axis`` (-1 or -2) of the
    planes, symmetric-padded by taps.size // 2: a gather, then one VALID
    ``F.conv2d`` (a correlation, so the taps go in reversed)."""
    half = taps.size // 2
    if half:
        img = img.index_select(axis, _extend_index(
            img.shape[axis], half, "symm", img.device))
    weight = _pass_weight(tuple(taps[::-1].tolist()), axis, img.dtype,
                          img.device)
    lead = img.shape[:-2]
    with ieee_fp32():
        out = F.conv2d(img.reshape(-1, 1, *img.shape[-2:]), weight)
    return out.reshape(*lead, *out.shape[-2:])


def symiirorder1(signal, c0: float, z1: float,
                 precision: float = -1.0) -> np.ndarray:
    """First-order mirror-symmetric IIR c0 / ((1 - z1 z^-1)(1 - z1 z))
    (scipy.signal.symiirorder1 semantics), batched over leading axes:
    forward and backward first-order passes through the framework's own
    lfilter, with the initial condition x[0] + z1 sum_k z1^k x[k]
    truncated at the first k with |z1|^k < precision (raises if the
    truncated sum has not converged within the signal — scipy's rule,
    pinned empirically)."""
    xin = np.asarray(to_numpy(signal))
    if np.iscomplexobj(xin):
        raise ValueError("complex signals are carried as RI planes "
                         "framework-wide; symiirorder1 takes real arrays")
    x = xin.astype(np.float64)
    if abs(z1) >= 1.0:
        raise ValueError("|z1| must be less than 1.0")
    if x.ndim == 0 or x.shape[-1] < 2:
        raise ValueError("signal must have at least 2 samples")
    n = x.shape[-1]
    if precision <= 0.0 or precision >= 1.0:
        precision = _default_precision(xin.dtype)
    k_conv = int(np.ceil(np.log(precision) / np.log(abs(z1)))) \
        if abs(z1) > 0 else 1
    if k_conv > n:
        raise ValueError("Sum to find symmetric boundary conditions "
                         "did not converge.")
    powers = z1 ** np.arange(k_conv)
    y0 = x[..., 0] + z1 * np.einsum("k,...k->...", powers,
                                    x[..., :k_conv])
    y1_tail = _iir1_np(x[..., 1:], z1, np.asarray(y0))
    y1 = np.concatenate([y0[..., None], y1_tail], axis=-1)
    out_last = -c0 / (z1 - 1.0) * y1[..., -1]
    rev = _iir1_np(c0 * y1[..., -2::-1], z1, np.asarray(out_last))
    out = np.concatenate([rev[..., ::-1], out_last[..., None]], axis=-1)
    return out.astype(xin.dtype, copy=False) \
        if np.issubdtype(xin.dtype, np.floating) else out


def _iir2_np(x: np.ndarray, a2: float, a3: float, y1, y2) -> np.ndarray:
    """Second-order recurrence y[k] = x[k] + a2 y[k-1] + a3 y[k-2] over
    the last axis in host NumPy float64 — the order-2 analog of
    :func:`_iir1_np` (chunked lower-triangular Toeplitz matmuls).
    ``y1``/``y2``: carried values y[-1] and y[-2]."""
    n = x.shape[-1]
    L = 64
    h = np.zeros(L)
    h[0] = 1.0
    if L > 1:
        h[1] = a2
    for d in range(2, L):
        h[d] = a2 * h[d - 1] + a3 * h[d - 2]
    tt = np.zeros((L, L))
    for d in range(L):
        tt[np.arange(d, L), np.arange(L - d)] = h[d]
    hm1 = np.concatenate([[0.0], h[:-1]])
    f1 = a2 * h + a3 * hm1         # coefficient of y[-1] at offset d
    f2 = a3 * h                    # coefficient of y[-2]
    out = np.empty_like(x)
    c1 = np.asarray(y1, dtype=np.float64)
    c2 = np.asarray(y2, dtype=np.float64)
    for s0 in range(0, n, L):
        chunk = x[..., s0: s0 + L]
        m = chunk.shape[-1]
        y = np.einsum("kj,...j->...k", tt[:m, :m], chunk) \
            + c1[..., None] * f1[:m] + c2[..., None] * f2[:m]
        out[..., s0: s0 + L] = y
        c1, c2 = y[..., -1], (y[..., -2] if m >= 2 else c1)
    return out


def _hc_np(k, cs: float, r: float, omega: float) -> np.ndarray:
    """Causal impulse response of cs / (1 - a2 z^-1 - a3 z^-2):
    hc(k) = cs r^k sin(omega (k+1)) / sin(omega) for k >= 0, else 0."""
    k = np.asarray(k, dtype=np.float64)
    kp = np.maximum(k, 0.0)
    return np.where(k > -1.0,
                    cs / math.sin(omega) * r ** kp
                    * np.sin(omega * (kp + 1.0)), 0.0)


def _hs_np(k, cs: float, rsq: float, omega: float) -> np.ndarray:
    """Symmetric (two-sided) impulse response of the full cascade
    cs^2 / ((1 - a2 z^-1 - a3 z^-2)(1 - a2 z - a3 z^2))."""
    c0 = (cs * cs * (1.0 + rsq) / (1.0 - rsq)
          / (1.0 - 2.0 * rsq * math.cos(2.0 * omega) + rsq * rsq))
    gamma = (1.0 - rsq) / (1.0 + rsq) / math.tan(omega)
    ak = np.abs(np.asarray(k, dtype=np.float64))
    return c0 * rsq ** (ak / 2.0) * (np.cos(omega * ak)
                                     + gamma * np.sin(omega * ak))


def _trunc_series(coefs: np.ndarray, x: np.ndarray,
                  precision: float) -> np.ndarray:
    """sum_k coefs[k] x[..., k], truncated AFTER the first coefficient
    whose magnitude falls to |coefs[k]| <= precision (that term is still
    included — the compiled-scipy loop rule, pinned empirically); raises
    scipy's convergence error if no coefficient within the signal
    qualifies."""
    small = np.nonzero(coefs * coefs <= precision * precision)[0]
    if small.size == 0:
        raise ValueError(_NOCONV)
    kstop = int(small[0]) + 1
    return np.einsum("k,...k->...", coefs[:kstop], x[..., :kstop])


def symiirorder2(input, r: float, omega: float,
                 precision: float = -1.0) -> np.ndarray:
    """Second-order mirror-symmetric smoothing IIR
    cs^2 / ((1 - a2 z^-1 - a3 z^-2)(1 - a2 z - a3 z^2)) with
    a2 = 2 r cos(omega), a3 = -r^2, cs = 1 - 2 r cos(omega) + r^2
    (scipy.signal.symiirorder2 semantics), batched over leading axes:
    a forward and a reversed second-order pass through the framework's
    chunked host recurrence, with boundary conditions from the
    precision-truncated hc/hs series."""
    xin = np.asarray(to_numpy(input))
    if np.iscomplexobj(xin):
        raise ValueError("complex signals are carried as RI planes "
                         "framework-wide; symiirorder2 takes real arrays")
    if r >= 1.0:
        raise ValueError("r must be less than 1.0")
    x = xin.astype(np.float64)
    if x.ndim == 0 or x.shape[-1] < 2:
        raise ValueError("signal must have at least 2 samples")
    if precision <= 0.0 or precision >= 1.0:
        precision = _default_precision(xin.dtype)
    n = x.shape[-1]
    rsq = r * r
    a2 = 2.0 * r * math.cos(omega)
    a3 = -rsq
    cs = 1.0 - 2.0 * r * math.cos(omega) + rsq
    ks = np.arange(n, dtype=np.float64)
    # Forward starting values y[0], y[1] from the causal response over
    # the mirrored input.
    y0 = _hc_np(0, cs, r, omega) * x[..., 0] \
        + _trunc_series(_hc_np(ks + 1.0, cs, r, omega), x, precision)
    y1 = _hc_np(0, cs, r, omega) * x[..., 1] \
        + _hc_np(1, cs, r, omega) * x[..., 0] \
        + _trunc_series(_hc_np(ks + 2.0, cs, r, omega), x, precision)
    y_fwd = np.concatenate(
        [y0[..., None], y1[..., None],
         _iir2_np(cs * x[..., 2:], a2, a3, y1, y0)], axis=-1)
    # Backward end values y[N-1], y[N-2] from the symmetric response.
    # scipy's compiled backward loop compares the SQUARED term against
    # the unsquared precision — an effective sqrt(precision) threshold
    # (pinned empirically across r/omega/precision grids); replicated
    # for exact parity.
    xr = x[..., ::-1]
    prec_b = math.sqrt(precision)
    e1 = _trunc_series(_hs_np(ks, cs, rsq, omega)
                       + _hs_np(ks + 1.0, cs, rsq, omega), xr, prec_b)
    e2 = _trunc_series(_hs_np(ks - 1.0, cs, rsq, omega)
                       + _hs_np(ks + 2.0, cs, rsq, omega), xr, prec_b)
    rev = _iir2_np(cs * y_fwd[..., -3::-1], a2, a3, e2, e1)
    out = np.concatenate(
        [rev[..., ::-1], e2[..., None], e1[..., None]], axis=-1)
    return out.astype(xin.dtype, copy=False) \
        if np.issubdtype(xin.dtype, np.floating) else out


def _coeff_smooth(lam: float):
    """Pole radius and angle of the cubic smoothing-spline prefilter for
    fall-off ``lam`` (valid for lam > 1/144, where the poles go
    complex)."""
    xi = 1.0 - 96.0 * lam + 24.0 * lam * math.sqrt(3.0 + 144.0 * lam)
    omega = math.atan2(math.sqrt(144.0 * lam - 1.0), math.sqrt(xi))
    rho = (24.0 * lam - 1.0 - math.sqrt(xi)) / (24.0 * lam)
    rho = rho * math.sqrt(
        (48.0 * lam + 24.0 * lam * math.sqrt(3.0 + 144.0 * lam)) / xi)
    return rho, omega


def _cubic_smooth_coeff(signal: np.ndarray, lamb: float) -> np.ndarray:
    """Smoothing cubic-spline coefficients (scipy's rank-1
    _cubic_smooth_coeff recurrences, batched over leading axes; the
    boundary sums here are UNtruncated, as in scipy's Python path —
    including its quirk of seeding the second forward value from
    hc(0) x[0] + hc(1) x[1] rather than the compiled path's swap)."""
    x = signal.astype(np.float64)
    rho, omega = _coeff_smooth(lamb)
    cs = 1.0 - 2.0 * rho * math.cos(omega) + rho * rho
    rsq = rho * rho
    a2 = 2.0 * rho * math.cos(omega)
    a3 = -rsq
    n = x.shape[-1]
    ks = np.arange(n, dtype=np.float64)
    hc0 = _hc_np(0, cs, rho, omega)
    y0 = hc0 * x[..., 0] \
        + np.einsum("k,...k->...", _hc_np(ks + 1.0, cs, rho, omega), x)
    y1 = hc0 * x[..., 0] + _hc_np(1, cs, rho, omega) * x[..., 1] \
        + np.einsum("k,...k->...", _hc_np(ks + 2.0, cs, rho, omega), x)
    y_fwd = np.concatenate(
        [y0[..., None], y1[..., None],
         _iir2_np(cs * x[..., 2:], a2, a3, y1, y0)], axis=-1)
    xr = x[..., ::-1]
    e1 = np.einsum("k,...k->...",
                   _hs_np(ks, cs, rsq, omega)
                   + _hs_np(ks + 1.0, cs, rsq, omega), xr)
    e2 = np.einsum("k,...k->...",
                   _hs_np(ks - 1.0, cs, rsq, omega)
                   + _hs_np(ks + 2.0, cs, rsq, omega), xr)
    rev = _iir2_np(cs * y_fwd[..., -3::-1], a2, a3, e2, e1)
    return np.concatenate(
        [rev[..., ::-1], e2[..., None], e1[..., None]], axis=-1)


def _spline2d(signal, c0: float, z1: float, precision: float) -> np.ndarray:
    if precision <= 0.0 or precision >= 1.0:
        # scipy's dtype rule, applied BEFORE the symiir passes.
        dt = np.asarray(signal).dtype
        precision = 1e-3 if dt in (np.float32, np.complex64) else 1e-6
    out = symiirorder1(signal, c0, z1, precision)
    out = np.moveaxis(symiirorder1(np.moveaxis(out, -2, -1), c0, z1,
                                   precision), -1, -2)
    return out


def _root_from_lambda(lamb: float):
    """Pole radius/angle used by the 2-D smoothing branch (same poles
    as :func:`_coeff_smooth`, scipy's compute_root_from_lambda form)."""
    tmp = math.sqrt(3.0 + 144.0 * lamb)
    xi = 1.0 - 96.0 * lamb + 24.0 * lamb * tmp
    omega = math.atan(math.sqrt((144.0 * lamb - 1.0) / xi))
    r = ((24.0 * lamb - 1.0 - math.sqrt(xi)) / (24.0 * lamb)
         * math.sqrt(48.0 * lamb + 24.0 * lamb * tmp) / math.sqrt(xi))
    return r, omega


def cspline2d(signal, lamb: float = 0.0,
              precision: float = -1.0) -> np.ndarray:
    """2-D cubic-spline coefficients (scipy.signal.cspline2d semantics):
    separable symiirorder1 prefilter along both trailing axes for the
    exact regime lamb <= 1/144, separable symiirorder2 smoothing
    prefilter above it."""
    signal = to_numpy(signal)
    if lamb > 1.0 / 144.0:
        if precision <= 0.0 or precision >= 1.0:
            dt = np.asarray(signal).dtype
            precision = 1e-3 if dt in (np.float32, np.complex64) else 1e-6
        r, omega = _root_from_lambda(lamb)
        out = symiirorder2(signal, r, omega, precision)
        out = np.moveaxis(symiirorder2(np.moveaxis(out, -2, -1), r, omega,
                                       precision), -1, -2)
        return out
    r = -2.0 + math.sqrt(3.0)
    return _spline2d(signal, -r * 6.0, r, precision)


def qspline2d(signal, lamb: float = 0.0,
              precision: float = -1.0) -> np.ndarray:
    """2-D quadratic-spline coefficients (scipy.signal.qspline2d
    semantics; lamb must be 0, as in scipy)."""
    signal = to_numpy(signal)
    if lamb > 0.0:
        raise ValueError("lambda must be negative or zero")
    r = -3.0 + 2.0 * math.sqrt(2.0)
    return _spline2d(signal, -r * 8.0, r, precision)


def spline_filter(Iin, lmbda: float = 5.0):
    """Smoothing-spline (cubic) filter of a rank-2 array
    (scipy.signal.spline_filter semantics): the 2-D smoothing prefilter
    followed by the mirror-symmetric [1, 4, 1]/6 reconstruction in both
    axes.  As in scipy, the reconstruction taps are single-precision
    constants and complex input is processed in single precision
    (complex double downcast); complex data is carried through the
    framework's real machinery as two planes — identical arithmetic,
    since every coefficient is real."""
    x = np.asarray(to_numpy(Iin))
    if x.dtype not in (np.float32, np.float64, np.complex64,
                       np.complex128):
        raise TypeError(f"Invalid data type for Iin: {x.dtype}")
    intype = x.dtype
    hcol = np.array([1.0, 4.0, 1.0], np.float32) / 6.0
    if np.iscomplexobj(x):
        xc = x.astype(np.complex64)
        planes = np.stack([xc.real, xc.imag])   # f32 planes
        ck = cspline2d(planes, lmbda)
        out = sepfir2d(torch.from_numpy(ck), hcol, hcol).numpy()
        return (out[0] + 1j * out[1]).astype(intype)
    ck = cspline2d(x, lmbda)
    out = sepfir2d(torch.from_numpy(ck), hcol, hcol).numpy()
    return out.astype(intype)
