"""Carried verbatim from ``simpledsp_tpu/design/iir.py``: NumPy only, so both
packages design bit-identical coefficients.

General IIR design: analog prototypes -> band transform -> bilinear -> SOS.

This generalizes the closed-form Butterworth recipes of
:mod:`simpledsp_tpu_torch.design.biquad` (the TPU analog of the reference's
coefficient setters, reference: include/sdsp/casc_2o_iir.h:82-194) to the
full classical design pipeline:

    analog low-pass prototype (zeros z, poles p, gain k, cutoff 1 rad/s)
      -> lp2lp / lp2hp / lp2bp / lp2bs frequency transform
      -> bilinear transform with tan prewarping
      -> second-order-section pairing
      -> :class:`~simpledsp_tpu_torch.design.biquad.BiquadCascadeDesign`

Five prototype families: Butterworth, Chebyshev type I/II, elliptic
(Cauer), and Bessel-Thomson — each with the standard order-selection
helper (buttord / cheb1ord / cheb2ord / ellipord).  Everything is
host-side float64 NumPy that runs once per reconfiguration; the result is
a frozen design whose coefficients the torch ops build as buffers.

The elliptic prototype uses the exact degree-equation solution via Landen
/ Gauss transformations of the Jacobi elliptic functions (sn, cd and
their inverses) rather than numerical optimization; Bessel uses the exact
integer reverse-Bessel-polynomial coefficients.  All families are
validated against scipy.signal (butter / cheby1 / cheby2 / ellip /
bessel) in tests/test_iir_design.py.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import numpy as np

from simpledsp_tpu_torch.design.biquad import BiquadCascadeDesign, FilterType

__all__ = [
    "buttap", "cheb1ap", "cheb2ap", "ellipap", "besselap",
    "band_stop_obj",
    "butter_ap",
    "gammatone",
    "cheby1_ap",
    "cheby2_ap",
    "ellip_ap",
    "bessel_ap",
    "lp2lp_zpk",
    "lp2hp_zpk",
    "lp2bp_zpk",
    "lp2bs_zpk",
    "bilinear_zpk",
    "zpk2sos",
    "sos_to_design",
    "iirfilter",
    "butter",
    "cheby1",
    "cheby2",
    "ellip",
    "bessel",
    "buttord",
    "cheb1ord",
    "cheb2ord",
    "ellipord",
    "iirnotch",
    "iirpeak",
    "iircomb",
]


# ----------------------------------------------------------------------------
# Jacobi elliptic machinery (Landen / Gauss transformation form).
#
# All arguments are in "normalized" units: u is in units of the complete
# elliptic integral K(k), so cd(u, k) here means the textbook cd(u*K(k), k).
# The descending Landen recursion converges quadratically; ~10 iterations
# reach float64 epsilon for any k < 1 - 1e-12.
# ----------------------------------------------------------------------------

def _landen(k: float, iters: int = 24) -> np.ndarray:
    """Descending sequence of Landen moduli k_1..k_M (k_0 = k omitted)."""
    ks = []
    for _ in range(iters):
        kp = math.sqrt(max(0.0, 1.0 - k * k))
        k = ((k / (1.0 + kp)) ** 2)
        ks.append(k)
        if k < 1e-300:
            break
    return np.asarray(ks, dtype=np.float64)


def ellipk(k: float) -> float:
    """Complete elliptic integral K(k) — MODULUS convention (scipy's
    ellipk takes the parameter m = k**2) — by the arithmetic-geometric
    mean."""
    if k >= 1.0:
        return math.inf
    a, b = 1.0, math.sqrt(1.0 - k * k)
    for _ in range(64):  # AGM converges quadratically; 64 is far beyond f64
        if abs(a - b) <= 2e-16 * a:
            break
        a, b = 0.5 * (a + b), math.sqrt(a * b)
    return math.pi / (2.0 * a)


def _cde(u, k: float):
    """Jacobi cd(u*K(k), k) for real or complex u (vectorized)."""
    w = np.cos(np.asarray(u) * (math.pi / 2.0))
    for kn in _landen(k)[::-1]:
        w = (1.0 + kn) * w / (1.0 + kn * w * w)
    return w


def _sne(u, k: float):
    """Jacobi sn(u*K(k), k) for real or complex u (vectorized)."""
    w = np.sin(np.asarray(u) * (math.pi / 2.0))
    for kn in _landen(k)[::-1]:
        w = (1.0 + kn) * w / (1.0 + kn * w * w)
    return w


def _asne(w, k: float):
    """Inverse of _sne: u (in units of K) with sn(u*K, k) = w."""
    w = np.asarray(w, dtype=np.complex128)
    moduli = np.concatenate([[k], _landen(k)])
    for n in range(1, len(moduli)):
        km1 = moduli[n - 1]
        w = 2.0 * w / ((1.0 + moduli[n])
                       * (1.0 + np.sqrt(1.0 - km1 * km1 * w * w)))
    return 2.0 / math.pi * np.arcsin(w)


def _ellipdeg(n: int, k1: float) -> float:
    """Solve the elliptic degree equation for the selectivity k given the
    order n and discrimination k1 = eps_p/eps_s:

        n = K(k) K'(k1) / (K'(k) K(k1))

    Exact solution via the product form k' = k1'^n * prod sn^4(u_i; k1')."""
    k1p = math.sqrt(1.0 - k1 * k1)
    ui = (2.0 * np.arange(1, n // 2 + 1) - 1.0) / n
    prod = np.prod(_sne(ui, k1p)) if ui.size else 1.0
    kp = k1p ** n * float(prod) ** 4
    return math.sqrt(max(0.0, 1.0 - kp * kp))


# ----------------------------------------------------------------------------
# Analog low-pass prototypes (cutoff 1 rad/s), (zeros, poles, gain).
# ----------------------------------------------------------------------------

def band_stop_obj(wp, ind: int, passb, stopb, gpass: float,
                  gstop: float, type: str):
    """Band-stop order objective (scipy.signal.band_stop_obj semantics):
    the filter order needed when passband edge ``ind`` moves to ``wp``
    — the function scipy's *ord selectors minimize for band-stop
    designs; the framework's own order selectors solve the same problem
    internally, this is the public scipy-compatible surface."""
    from scipy import special

    if gpass <= 0 or gstop <= 0 or gpass >= gstop:
        raise ValueError("gpass and gstop must be positive with "
                         "gpass < gstop")
    passb = np.asarray(passb, dtype=np.float64).copy()
    stopb = np.asarray(stopb, dtype=np.float64)
    passb[ind] = wp
    nat = (stopb * (passb[0] - passb[1])
           / (stopb ** 2 - passb[0] * passb[1]))
    nat = float(np.min(np.abs(nat)))
    if type == "butter":
        gs = 10.0 ** (0.1 * abs(gstop))
        gp = 10.0 ** (0.1 * abs(gpass))
        return np.log10((gs - 1.0) / (gp - 1.0)) / (2 * np.log10(nat))
    if type == "cheby":
        gs = 10.0 ** (0.1 * abs(gstop))
        gp = 10.0 ** (0.1 * abs(gpass))
        return np.arccosh(np.sqrt((gs - 1.0) / (gp - 1.0))) \
            / np.arccosh(nat)
    if type == "ellip":
        gs = 10.0 ** (0.1 * gstop)
        gp = 10.0 ** (0.1 * gpass)
        arg1 = np.sqrt((gp - 1.0) / (gs - 1.0))
        arg0 = 1.0 / nat
        d0 = special.ellipk([arg0 ** 2, 1 - arg0 ** 2])
        d1 = special.ellipk([arg1 ** 2, 1 - arg1 ** 2])
        return d0[0] * d1[1] / (d0[1] * d1[0])
    raise ValueError(f"Incorrect type: {type}")


def buttap(N: int):
    """scipy.signal.buttap name for :func:`butter_ap`."""
    return butter_ap(N)


def cheb1ap(N: int, rp: float):
    """scipy.signal.cheb1ap name for :func:`cheby1_ap`."""
    return cheby1_ap(N, rp)


def cheb2ap(N: int, rs: float):
    """scipy.signal.cheb2ap name for :func:`cheby2_ap`."""
    return cheby2_ap(N, rs)


def ellipap(N: int, rp: float, rs: float):
    """scipy.signal.ellipap name for :func:`ellip_ap`."""
    return ellip_ap(N, rp, rs)


def besselap(N: int, norm: str = "phase"):
    """scipy.signal.besselap name for :func:`bessel_ap`."""
    return bessel_ap(N, norm)


def butter_ap(n: int) -> Tuple[np.ndarray, np.ndarray, float]:
    """Butterworth analog prototype: poles on the unit left-half circle."""
    _check_order(n)
    theta = (2.0 * np.arange(1, n + 1) - 1.0) * math.pi / (2.0 * n)
    p = -np.sin(theta) + 1j * np.cos(theta)
    p = _symmetrize(p)
    return np.empty(0, dtype=np.complex128), p, 1.0


def cheby1_ap(n: int, rp: float) -> Tuple[np.ndarray, np.ndarray, float]:
    """Chebyshev-I analog prototype (passband ripple ``rp`` dB).

    Even orders are normalized so the ripple TOP is unity (DC gain
    1/sqrt(1+eps^2)) — scipy's convention."""
    _check_order(n)
    eps = math.sqrt(10.0 ** (rp / 10.0) - 1.0)
    mu = math.asinh(1.0 / eps) / n
    theta = (2.0 * np.arange(1, n + 1) - 1.0) * math.pi / (2.0 * n)
    p = -math.sinh(mu) * np.sin(theta) + 1j * math.cosh(mu) * np.cos(theta)
    p = _symmetrize(p)
    k = np.real(np.prod(-p))
    if n % 2 == 0:
        k /= math.sqrt(1.0 + eps * eps)
    return np.empty(0, dtype=np.complex128), p, float(k)


def cheby2_ap(n: int, rs: float) -> Tuple[np.ndarray, np.ndarray, float]:
    """Chebyshev-II (inverse Chebyshev) analog prototype: flat passband,
    equiripple stopband ``rs`` dB down past 1 rad/s."""
    _check_order(n)
    de = 1.0 / math.sqrt(10.0 ** (rs / 10.0) - 1.0)
    mu = math.asinh(1.0 / de) / n
    theta = (2.0 * np.arange(1, n + 1) - 1.0) * math.pi / (2.0 * n)
    p = 1.0 / (-math.sinh(mu) * np.sin(theta)
               + 1j * math.cosh(mu) * np.cos(theta))
    p = _symmetrize(p)
    # Zeros on the imaginary axis at 1/cos(theta); odd n has one theta at
    # pi/2 (zero at infinity) which is dropped.
    ct = np.cos(theta)
    finite = np.abs(ct) > 1e-12
    z = 1j / ct[finite]
    z = _symmetrize(z)
    k = np.real(np.prod(-p) / np.prod(-z))
    return z, p, float(k)


def ellip_ap(n: int, rp: float, rs: float
             ) -> Tuple[np.ndarray, np.ndarray, float]:
    """Elliptic (Cauer) analog prototype: ripple ``rp`` dB in the passband,
    at least ``rs`` dB attenuation in the stopband, with the sharpest
    possible transition for the order.  Exact Landen-form solution of the
    degree equation (no numerical optimization)."""
    _check_order(n)
    if n == 1:
        # Degenerate: single real pole where the response is rp down at 1.
        eps = math.sqrt(10.0 ** (rp / 10.0) - 1.0)
        p = np.asarray([-1.0 / eps], dtype=np.complex128)
        return np.empty(0, dtype=np.complex128), p, 1.0 / eps
    eps_p = math.sqrt(10.0 ** (rp / 10.0) - 1.0)
    eps_s = math.sqrt(10.0 ** (rs / 10.0) - 1.0)
    k1 = eps_p / eps_s
    k = _ellipdeg(n, k1)
    L = n // 2
    ui = (2.0 * np.arange(1, L + 1) - 1.0) / n
    # Zeros: on the imaginary axis at j / (k * cd(u_i K, k)).
    cd = np.real(_cde(ui, k))
    z = 1j / (k * cd)
    z = np.concatenate([z, np.conj(z)])
    # Poles: p_i = j cd((u_i - j v0) K, k) with v0 from the passband ripple.
    v0 = float(np.real(-1j * _asne(1j / eps_p, k1) / n))
    pv = 1j * _cde(ui - 1j * v0, k)
    if not np.all(np.real(pv) < 0):
        raise ValueError(f"elliptic prototype produced non-LHP poles "
                         f"(n={n}, rp={rp}, rs={rs})")
    p = np.concatenate([pv, np.conj(pv)])
    if n % 2:
        p0 = 1j * _sne(1j * v0, k)
        p = np.concatenate([p, [complex(np.real(p0), 0.0)]])
    kg = np.real(np.prod(-p) / np.prod(-z))
    if n % 2 == 0:
        kg /= math.sqrt(1.0 + eps_p * eps_p)
    return z, p, float(kg)


def bessel_ap(n: int, norm: str = "phase"
              ) -> Tuple[np.ndarray, np.ndarray, float]:
    """Bessel-Thomson analog prototype (maximally flat group delay).

    Poles are the roots of the reverse Bessel polynomial (exact integer
    coefficients); ``norm``:
      'phase' — phase reaches its midpoint at 1 rad/s (scipy default),
      'delay' — unit group delay at DC,
      'mag'   — -3 dB magnitude at 1 rad/s.
    """
    _check_order(n)
    # Reverse Bessel polynomial theta_n: coefficient of s^j is
    # (2n-j)! / (2^(n-j) j! (n-j)!), exact in Python ints.
    coeffs = [math.factorial(2 * n - j)
              // (2 ** (n - j) * math.factorial(j) * math.factorial(n - j))
              for j in range(n, -1, -1)]
    p = np.roots(np.asarray(coeffs, dtype=np.float64))
    p = _symmetrize(p)
    a0 = float(coeffs[-1])
    if norm == "delay":
        pass
    elif norm == "phase":
        p = p * a0 ** (-1.0 / n)
    elif norm == "mag":
        # Find w0 with |H(j w0)| = 1/sqrt(2), then scale the cutoff there.
        kk = np.real(np.prod(-p))

        def mag2(w):
            return (kk * kk
                    / np.prod(np.abs(1j * w - p)) ** 2) - 0.5

        lo, hi = 1e-6, 1.0
        while mag2(hi) > 0.0:
            hi *= 2.0
        from scipy.optimize import brentq

        w0 = brentq(mag2, lo, hi, xtol=1e-15, rtol=8.9e-16)
        p = p / w0
    else:
        raise ValueError(f"unknown bessel norm {norm!r}")
    k = float(np.real(np.prod(-p)))
    return np.empty(0, dtype=np.complex128), p, k


def _symmetrize(r: np.ndarray) -> np.ndarray:
    """Force an (approximately) conjugate-symmetric root set to be exactly
    conjugate-symmetric: real parts of near-real roots are zeroed in the
    imaginary part; complex roots are returned as exact conjugate pairs."""
    r = np.asarray(r, dtype=np.complex128)
    scale = max(1.0, float(np.max(np.abs(r))) if r.size else 1.0)
    tol = 1e-9 * scale
    reals = np.real(r[np.abs(np.imag(r)) <= tol])
    upper = r[np.imag(r) > tol]
    lower = r[np.imag(r) < -tol]
    if len(upper) != len(lower):
        raise ValueError("root set is not conjugate-symmetric")
    # Match each upper root to its nearest lower conjugate and average.
    used = np.zeros(len(lower), dtype=bool)
    sym = []
    for u in upper:
        d = np.where(used, np.inf, np.abs(np.conj(lower) - u))
        j = int(np.argmin(d))
        used[j] = True
        sym.append(0.5 * (u + np.conj(lower[j])))
    out = []
    for s in sym:
        out.extend([s, np.conj(s)])
    out.extend(reals.astype(np.complex128))
    return np.asarray(out, dtype=np.complex128)


def _check_order(n: int) -> None:
    if not isinstance(n, (int, np.integer)) or n < 1:
        raise ValueError(f"order must be a positive integer, got {n!r}")


# ----------------------------------------------------------------------------
# Frequency transforms (zpk form) and the bilinear transform.
# ----------------------------------------------------------------------------

def _relative_degree(z: np.ndarray, p: np.ndarray) -> int:
    d = len(p) - len(z)
    if d < 0:
        raise ValueError("more zeros than poles")
    return d


def lp2lp_zpk(z, p, k, wo: float):
    """Scale the prototype cutoff from 1 to ``wo`` rad/s."""
    z, p = np.asarray(z, complex), np.asarray(p, complex)
    deg = _relative_degree(z, p)
    return z * wo, p * wo, k * wo ** deg


def lp2hp_zpk(z, p, k, wo: float):
    """Low-pass prototype -> high-pass at ``wo`` (s -> wo/s)."""
    z, p = np.asarray(z, complex), np.asarray(p, complex)
    deg = _relative_degree(z, p)
    zh = wo / z if len(z) else np.empty(0, complex)
    ph = wo / p
    zh = np.append(zh, np.zeros(deg, complex))
    kh = k * np.real(np.prod(-z) / np.prod(-p))
    return zh, ph, float(kh)


def lp2bp_zpk(z, p, k, wo: float, bw: float):
    """Low-pass prototype -> band-pass, center ``wo``, width ``bw``
    (s -> (s^2 + wo^2)/(bw s))."""
    z, p = np.asarray(z, complex), np.asarray(p, complex)
    deg = _relative_degree(z, p)
    zl, pl = z * (bw / 2.0), p * (bw / 2.0)
    zb = np.concatenate([zl + np.sqrt(zl * zl - wo * wo),
                         zl - np.sqrt(zl * zl - wo * wo)])
    pb = np.concatenate([pl + np.sqrt(pl * pl - wo * wo),
                         pl - np.sqrt(pl * pl - wo * wo)])
    zb = np.append(zb, np.zeros(deg, complex))
    kb = k * bw ** deg
    return zb, pb, float(kb)


def lp2bs_zpk(z, p, k, wo: float, bw: float):
    """Low-pass prototype -> band-stop (s -> bw s/(s^2 + wo^2))."""
    z, p = np.asarray(z, complex), np.asarray(p, complex)
    deg = _relative_degree(z, p)
    zl = (bw / 2.0) / z if len(z) else np.empty(0, complex)
    pl = (bw / 2.0) / p
    zb = np.concatenate([zl + np.sqrt(zl * zl - wo * wo),
                         zl - np.sqrt(zl * zl - wo * wo)])
    pb = np.concatenate([pl + np.sqrt(pl * pl - wo * wo),
                         pl - np.sqrt(pl * pl - wo * wo)])
    # The deg zeros at infinity move to +-j wo.
    zb = np.concatenate([zb, 1j * wo * np.ones(deg),
                         -1j * wo * np.ones(deg)])
    kb = k * np.real(np.prod(-z) / np.prod(-p)) if len(z) else \
        k * np.real(1.0 / np.prod(-p))
    return zb, pb, float(kb)


def bilinear_zpk(z, p, k, fs: float):
    """Analog (s-plane) -> digital (z-plane) via the bilinear transform
    s = 2 fs (z-1)/(z+1).  Prewarping is the caller's job (iirfilter)."""
    z, p = np.asarray(z, complex), np.asarray(p, complex)
    deg = _relative_degree(z, p)
    fs2 = 2.0 * fs
    zd = (fs2 + z) / (fs2 - z)
    pd = (fs2 + p) / (fs2 - p)
    zd = np.append(zd, -np.ones(deg, complex))
    kd = k * np.real(np.prod(fs2 - z) / np.prod(fs2 - p))
    return zd, pd, float(kd)


# ----------------------------------------------------------------------------
# SOS pairing.
# ----------------------------------------------------------------------------

def _split_real_complex(r: np.ndarray, tol: float
                        ) -> Tuple[list, list]:
    """Split a conjugate-symmetric root set into (complex upper-half
    representatives, real roots)."""
    reals = [float(np.real(x)) for x in r if abs(np.imag(x)) <= tol]
    upper = [complex(x) for x in r if np.imag(x) > tol]
    lower = [complex(x) for x in r if np.imag(x) < -tol]
    if len(upper) != len(lower):
        raise ValueError("roots are not conjugate-symmetric")
    return upper, reals


def zpk2sos(z, p, k: float) -> np.ndarray:
    """Pair digital zeros/poles into second-order sections, (M, 6) rows
    ``[b0 b1 b2 1 a1 a2]`` whose cascade product equals the zpk transfer
    function exactly.

    Pairing policy (the usual numeric-robustness heuristics; the cascade
    product is invariant to pairing in exact arithmetic):
      * pole pairs closest to the unit circle are paired with their
        nearest zeros and placed LAST in the cascade;
      * real poles are merged two-per-section, matched with leftover real
        zeros;
      * the overall gain is folded into the FIRST section.
    """
    z = np.asarray(z, dtype=np.complex128)
    p = np.asarray(p, dtype=np.complex128)
    if len(z) > len(p):
        raise ValueError("more zeros than poles")
    scale = max(1.0, float(np.max(np.abs(p))) if p.size else 1.0)
    tol = 1e-9 * scale
    zc, zr = _split_real_complex(z, tol)
    pc, pr = _split_real_complex(p, tol)

    sections = []  # list of (b_poly, a_poly) float64 length-3 arrays

    def _quad_from_pair(c: complex) -> np.ndarray:
        return np.array([1.0, -2.0 * c.real, abs(c) ** 2])

    def _quad_from_reals(r1: float, r2: float) -> np.ndarray:
        return np.array([1.0, -(r1 + r2), r1 * r2])

    def _lin_from_real(r1: float) -> np.ndarray:
        return np.array([1.0, -r1, 0.0])

    def _take_nearest(pool: list, target: complex) -> complex:
        i = int(np.argmin([abs(x - target) for x in pool]))
        return pool.pop(i)

    # Complex pole pairs, nearest the unit circle first (so the highest-Q
    # poles get first pick of the zeros); the cascade is emitted with
    # those high-Q sections LAST.
    pc.sort(key=lambda c: abs(1.0 - abs(c)))
    for pole in pc:
        a = _quad_from_pair(pole)
        if zc:
            zero = _take_nearest(zc, pole)
            b = _quad_from_pair(zero)
        elif len(zr) >= 2:
            # Two nearest real zeros.
            zr.sort(key=lambda x: abs(x - pole))
            b = _quad_from_reals(zr.pop(0), zr.pop(0))
        elif len(zr) == 1:
            b = _lin_from_real(zr.pop(0))
        else:
            b = np.array([1.0, 0.0, 0.0])
        sections.append((b, a))
    sections.reverse()  # high-Q complex sections go last

    # Real poles: two per section, placed before the complex sections.
    real_sections = []
    pr.sort(key=lambda x: abs(1.0 - abs(x)), reverse=True)
    while len(pr) >= 2:
        a = _quad_from_reals(pr.pop(0), pr.pop(0))
        if zc:
            b = _quad_from_pair(zc.pop(0))
        elif len(zr) >= 2:
            b = _quad_from_reals(zr.pop(0), zr.pop(0))
        elif len(zr) == 1:
            b = _lin_from_real(zr.pop(0))
        else:
            b = np.array([1.0, 0.0, 0.0])
        real_sections.append((b, a))
    if pr:
        a = _lin_from_real(pr.pop(0))
        if len(zr) >= 1:
            b = _lin_from_real(zr.pop(0))
        else:
            b = np.array([1.0, 0.0, 0.0])
        real_sections.append((b, a))
    if zc or zr:
        raise ValueError("zeros left unpaired (zeros must not outnumber "
                         "poles per section)")

    sections = real_sections + sections
    sos = np.zeros((max(1, len(sections)), 6), dtype=np.float64)
    if not sections:
        sos[0] = (k, 0.0, 0.0, 1.0, 0.0, 0.0)
        return sos
    for i, (b, a) in enumerate(sections):
        sos[i, :3] = b
        sos[i, 3:] = a
    sos[0, :3] *= k
    return sos


def sos_to_design(sos: np.ndarray, *, ftype: FilterType = FilterType.none,
                  f0: float = float("nan"), fs: float = 2.0,
                  q: float = float("nan"),
                  gain: float = 1.0) -> BiquadCascadeDesign:
    """Convert an (M, 6) SOS matrix into the framework's cascade design
    (b0-normalized rows + single input gain), runnable by ops.iir.sosfilt
    / BlockIIR."""
    sos = np.asarray(sos, dtype=np.float64)
    if sos.ndim != 2 or sos.shape[1] != 6:
        raise ValueError(f"expected (M, 6) SOS matrix, got {sos.shape}")
    b = sos[:, :3].copy()
    a = sos[:, 3:].copy()
    g = gain
    for i in range(sos.shape[0]):
        if a[i, 0] != 1.0:
            if a[i, 0] == 0.0:
                raise ValueError(f"section {i} has a0 == 0")
            b[i] /= a[i, 0]
            a[i] /= a[i, 0]
        b0 = b[i, 0]
        if b0 == 0.0:
            raise ValueError(
                f"section {i} has b0 == 0; cannot normalize to the "
                "cascade's b0==1 convention")
        g *= b0
        b[i] /= b0
    return BiquadCascadeDesign(b=b, a=a, gain=float(g), ftype=ftype,
                               f0=f0, fs=fs, q=q)


# ----------------------------------------------------------------------------
# Top-level design entry points.
# ----------------------------------------------------------------------------

_BTYPES = {
    "lowpass": "lowpass", "low": "lowpass", "lp": "lowpass",
    "highpass": "highpass", "high": "highpass", "hp": "highpass",
    "bandpass": "bandpass", "bp": "bandpass",
    "bandstop": "bandstop", "bs": "bandstop", "stop": "bandstop",
    "notch": "bandstop",
}

_FTYPE_TAG = {
    "lowpass": FilterType.low_pass,
    "highpass": FilterType.high_pass,
    "bandpass": FilterType.band_pass,
    "bandstop": FilterType.band_stop,
}


def iirfilter(n: int, wn: Union[float, Sequence[float]], *,
              rp: Optional[float] = None, rs: Optional[float] = None,
              btype: str = "lowpass", ftype: str = "butter",
              fs: float = 2.0, norm: str = "phase",
              output: str = "design"):
    """Design an order-``n`` digital IIR filter (scipy.signal.iirfilter's
    role, built on this module's own prototypes/transforms).

    Args:
      n: filter order (the BAND transforms double it: a band-pass of
        order n has 2n poles, matching scipy).
      wn: critical frequency (scalar for lowpass/highpass) or (f1, f2)
        band edges, in the units of ``fs`` (default fs=2 -> normalized
        0..1, scipy's convention).
      rp: passband ripple dB (cheby1, ellip).
      rs: stopband attenuation dB (cheby2, ellip).
      btype: 'lowpass' | 'highpass' | 'bandpass' | 'bandstop'.
      ftype: 'butter' | 'cheby1' | 'cheby2' | 'ellip' | 'bessel'.
      norm: Bessel normalization ('phase' | 'delay' | 'mag').
      output: 'design' (BiquadCascadeDesign, default) | 'sos' | 'zpk' |
        'ba'.
    """
    btype = _BTYPES.get(btype.lower())
    if btype is None:
        raise ValueError(f"unknown btype {btype!r}")
    ftype = ftype.lower()
    if ftype in ("butter", "butterworth"):
        z, p, k = butter_ap(n)
    elif ftype in ("cheby1", "chebyshev1", "chebyshevi"):
        if rp is None:
            raise ValueError("cheby1 needs rp (passband ripple, dB)")
        z, p, k = cheby1_ap(n, rp)
    elif ftype in ("cheby2", "chebyshev2", "chebyshevii"):
        if rs is None:
            raise ValueError("cheby2 needs rs (stopband attenuation, dB)")
        z, p, k = cheby2_ap(n, rs)
    elif ftype in ("ellip", "elliptic", "cauer"):
        if rp is None or rs is None:
            raise ValueError("ellip needs rp and rs")
        z, p, k = ellip_ap(n, rp, rs)
    elif ftype == "bessel":
        z, p, k = bessel_ap(n, norm=norm)
    else:
        raise ValueError(f"unknown ftype {ftype!r}")

    wn_arr = np.atleast_1d(np.asarray(wn, dtype=np.float64))
    if np.any(wn_arr <= 0.0) or np.any(wn_arr >= fs / 2.0):
        raise ValueError(f"critical frequencies must lie in (0, fs/2); "
                         f"got {wn_arr} at fs={fs}")
    # tan prewarp so the bilinear image lands exactly on wn.
    fs2 = 2.0
    warped = fs2 * np.tan(math.pi * wn_arr / fs)

    if btype in ("lowpass", "highpass"):
        if wn_arr.size != 1:
            raise ValueError(f"{btype} takes a scalar wn")
        wo = float(warped[0])
        z, p, k = (lp2lp_zpk if btype == "lowpass" else lp2hp_zpk)(
            z, p, k, wo)
        f0, q = float(wn_arr[0]), float("nan")
    else:
        if wn_arr.size != 2 or wn_arr[0] >= wn_arr[1]:
            raise ValueError(f"{btype} takes (f1, f2) with f1 < f2")
        bwp = float(warped[1] - warped[0])
        wo = float(math.sqrt(warped[0] * warped[1]))
        z, p, k = (lp2bp_zpk if btype == "bandpass" else lp2bs_zpk)(
            z, p, k, wo, bwp)
        f0 = float(math.sqrt(wn_arr[0] * wn_arr[1]))
        q = f0 / float(wn_arr[1] - wn_arr[0])

    z, p, k = bilinear_zpk(z, p, k, fs2 / 2.0)
    if output == "zpk":
        return z, p, k
    sos = zpk2sos(z, p, k)
    if output == "sos":
        return sos
    if output == "ba":
        b = k * np.real(np.poly(z))
        a = np.real(np.poly(p))
        return b, a
    if output == "design":
        return sos_to_design(sos, ftype=_FTYPE_TAG[btype], f0=f0, fs=fs,
                             q=q)
    raise ValueError(f"unknown output {output!r}")


def butter(n: int, wn, btype: str = "lowpass", fs: float = 2.0,
           output: str = "design"):
    """Butterworth digital design, any band type / order (generalizes the
    closed-form design_lowpass/... of design.biquad to odd orders and the
    full zpk pipeline)."""
    return iirfilter(n, wn, btype=btype, ftype="butter", fs=fs,
                     output=output)


def cheby1(n: int, rp: float, wn, btype: str = "lowpass", fs: float = 2.0,
           output: str = "design"):
    """Chebyshev-I digital design (ripple ``rp`` dB in the passband)."""
    return iirfilter(n, wn, rp=rp, btype=btype, ftype="cheby1", fs=fs,
                     output=output)


def cheby2(n: int, rs: float, wn, btype: str = "lowpass", fs: float = 2.0,
           output: str = "design"):
    """Chebyshev-II digital design (``rs`` dB stopband attenuation; wn is
    the STOPBAND edge)."""
    return iirfilter(n, wn, rs=rs, btype=btype, ftype="cheby2", fs=fs,
                     output=output)


def ellip(n: int, rp: float, rs: float, wn, btype: str = "lowpass",
          fs: float = 2.0, output: str = "design"):
    """Elliptic (Cauer) digital design."""
    return iirfilter(n, wn, rp=rp, rs=rs, btype=btype, ftype="ellip",
                     fs=fs, output=output)


def bessel(n: int, wn, btype: str = "lowpass", fs: float = 2.0,
           norm: str = "phase", output: str = "design"):
    """Bessel-Thomson digital design (note: the bilinear transform does
    not preserve the maximally-flat group delay exactly; same caveat as
    scipy)."""
    return iirfilter(n, wn, btype=btype, ftype="bessel", fs=fs, norm=norm,
                     output=output)


# ----------------------------------------------------------------------------
# Order selection.
# ----------------------------------------------------------------------------

def _order_prewarp(wp, ws, fs: float):
    wp = np.atleast_1d(np.asarray(wp, dtype=np.float64))
    ws = np.atleast_1d(np.asarray(ws, dtype=np.float64))
    if wp.shape != ws.shape or wp.size not in (1, 2):
        raise ValueError("wp/ws must both be scalars or both (f1, f2)")
    passb = np.tan(math.pi * wp / fs)
    stopb = np.tan(math.pi * ws / fs)
    return wp, ws, passb, stopb


def _band_nat(passb: np.ndarray, stopb: np.ndarray, gpass: float,
              gstop: float, kind: str) -> Tuple[float, np.ndarray]:
    """LP-equivalent selectivity (transition ratio) for each filter shape,
    plus possibly-adjusted passband edges.  For band-stop the passband
    edges are nudged toward the stopband to maximize selectivity before
    computing the order, exactly as scipy's band_stop_obj optimization
    (maximizing selectivity minimizes the order for every family, since
    the order formulas are all monotone decreasing in it)."""
    if passb.size == 1:
        if kind == "lp":
            nat = stopb[0] / passb[0]
        else:
            nat = passb[0] / stopb[0]
        return float(abs(nat)), passb
    if kind == "bp":
        nat = min(abs((stopb[0] ** 2 - passb[0] * passb[1])
                      / (stopb[0] * (passb[0] - passb[1]))),
                  abs((stopb[1] ** 2 - passb[0] * passb[1])
                      / (stopb[1] * (passb[0] - passb[1]))))
        return float(nat), passb
    from scipy.optimize import fminbound

    orig = passb.copy()

    def neg_nat(p0, p1):
        n1 = stopb[0] * (p0 - p1) / (stopb[0] ** 2 - p0 * p1)
        n2 = stopb[1] * (p0 - p1) / (stopb[1] ** 2 - p0 * p1)
        return -min(abs(n1), abs(n2))

    # Each edge optimized against the ORIGINAL other edge (scipy's order).
    passb0 = float(fminbound(lambda x: neg_nat(x, orig[1]),
                             orig[0], stopb[0] - 1e-12, xtol=1e-5, disp=0))
    passb1 = float(fminbound(lambda x: neg_nat(orig[0], x),
                             stopb[1] + 1e-12, orig[1], xtol=1e-5, disp=0))
    passb = np.array([passb0, passb1])
    return float(-neg_nat(passb0, passb1)), passb


def _kind_of(wp: np.ndarray, ws: np.ndarray) -> str:
    if wp.size == 1:
        return "lp" if wp[0] < ws[0] else "hp"
    if wp[0] < ws[0] < ws[1] < wp[1]:
        return "bs"
    if ws[0] < wp[0] < wp[1] < ws[1]:
        return "bp"
    raise ValueError("band edges must nest: bp needs ws0<wp0<wp1<ws1, "
                     "bs the converse")


def _order_wn_back(kind: str, passb: np.ndarray, wn_analog, fs: float):
    """Map LP-equivalent analog natural frequencies back to digital Hz."""
    w = np.atleast_1d(np.asarray(wn_analog, dtype=np.float64))
    wn = (fs / math.pi) * np.arctan(w)
    return float(wn[0]) if wn.size == 1 else np.sort(wn)


def buttord(wp, ws, gpass: float, gstop: float, fs: float = 2.0
            ) -> Tuple[int, Union[float, np.ndarray]]:
    """Minimum Butterworth order meeting <=``gpass`` dB passband loss at
    ``wp`` and >=``gstop`` dB attenuation at ``ws``; returns (order, wn)
    where ``wn`` feeds :func:`butter` (the -3 dB point placed to meet the
    stopband spec exactly, scipy's convention)."""
    wp_, ws_, passb, stopb = _order_prewarp(wp, ws, fs)
    kind = _kind_of(wp_, ws_)
    nat, passb = _band_nat(passb, stopb, gpass, gstop, kind)
    GP = 10.0 ** (0.1 * gpass) - 1.0
    GS = 10.0 ** (0.1 * gstop) - 1.0
    n = int(math.ceil(math.log10(GS / GP) / (2.0 * math.log10(nat))))
    if n <= 0:
        n = 1
    # -3 dB frequency placed so the PASSBAND spec is met exactly (scipy's
    # convention), in LP-equivalent units of the passband edge.
    W0 = GP ** (-1.0 / (2.0 * n))
    if kind == "lp":
        wn = _order_wn_back(kind, passb, W0 * passb[0], fs)
    elif kind == "hp":
        wn = _order_wn_back(kind, passb, passb[0] / W0, fs)
    else:
        bw = passb[1] - passb[0]
        wo2 = passb[0] * passb[1]
        if kind == "bp":
            # Solve |(w^2 - wo^2)/(bw w)| = W0 for the two positive roots.
            disc = math.sqrt((W0 * bw) ** 2 + 4.0 * wo2)
            w_hi = (W0 * bw + disc) / 2.0
            w_lo = wo2 / w_hi
        else:
            # |(bw w)/(w^2 - wo^2)| = W0.
            disc = math.sqrt(bw ** 2 + 4.0 * W0 ** 2 * wo2)
            w_hi = (bw + disc) / (2.0 * W0)
            w_lo = wo2 / w_hi
        wn = _order_wn_back(kind, passb, np.array([w_lo, w_hi]), fs)
    return n, wn


def cheb1ord(wp, ws, gpass: float, gstop: float, fs: float = 2.0
             ) -> Tuple[int, Union[float, np.ndarray]]:
    """Minimum Chebyshev-I order; wn returned is the passband edge(s)."""
    wp_, ws_, passb, stopb = _order_prewarp(wp, ws, fs)
    kind = _kind_of(wp_, ws_)
    nat, passb_adj = _band_nat(passb, stopb, gpass, gstop, kind)
    GP = 10.0 ** (0.1 * gpass) - 1.0
    GS = 10.0 ** (0.1 * gstop) - 1.0
    n = int(math.ceil(math.acosh(math.sqrt(GS / GP)) / math.acosh(nat)))
    if n <= 0:
        n = 1
    # wn = the (band-stop: selectivity-adjusted) passband edge(s).
    wn = _order_wn_back(kind, passb_adj, passb_adj, fs)
    return n, wn


def cheb2ord(wp, ws, gpass: float, gstop: float, fs: float = 2.0
             ) -> Tuple[int, Union[float, np.ndarray]]:
    """Minimum Chebyshev-II order; wn is the stopband edge moved inward so
    the passband spec is met exactly (scipy's convention)."""
    wp_, ws_, passb, stopb = _order_prewarp(wp, ws, fs)
    kind = _kind_of(wp_, ws_)
    nat, passb_adj = _band_nat(passb, stopb, gpass, gstop, kind)
    GP = 10.0 ** (0.1 * gpass) - 1.0
    GS = 10.0 ** (0.1 * gstop) - 1.0
    n = int(math.ceil(math.acosh(math.sqrt(GS / GP)) / math.acosh(nat)))
    if n <= 0:
        n = 1
    # New LP-equivalent stopband edge where the spec is met exactly.
    W0 = 1.0 / math.cosh(math.acosh(math.sqrt(GS / GP)) / n)
    if kind == "lp":
        wn = _order_wn_back(kind, passb, passb_adj[0] / W0, fs)
    elif kind == "hp":
        wn = _order_wn_back(kind, passb, passb_adj[0] * W0, fs)
    elif kind == "bp":
        bw = passb_adj[1] - passb_adj[0]
        wo2 = passb_adj[0] * passb_adj[1]
        Wst = 1.0 / W0
        disc = math.sqrt((Wst * bw) ** 2 + 4.0 * wo2)
        w_hi = (Wst * bw + disc) / 2.0
        w_lo = wo2 / w_hi
        wn = _order_wn_back(kind, passb, np.array([w_lo, w_hi]), fs)
    else:
        bw = passb_adj[1] - passb_adj[0]
        wo2 = passb_adj[0] * passb_adj[1]
        Wst = 1.0 / W0
        disc = math.sqrt((bw / Wst) ** 2 + 4.0 * wo2)
        w_hi = (bw / Wst + disc) / 2.0
        w_lo = wo2 / w_hi
        wn = _order_wn_back(kind, passb, np.array([w_lo, w_hi]), fs)
    return n, wn


def ellipord(wp, ws, gpass: float, gstop: float, fs: float = 2.0
             ) -> Tuple[int, Union[float, np.ndarray]]:
    """Minimum elliptic order via the degree equation
    n >= K(k) K'(k1) / (K'(k) K(k1)); wn is the passband edge(s)."""
    wp_, ws_, passb, stopb = _order_prewarp(wp, ws, fs)
    kind = _kind_of(wp_, ws_)
    nat, passb_adj = _band_nat(passb, stopb, gpass, gstop, kind)
    GP = 10.0 ** (0.1 * gpass) - 1.0
    GS = 10.0 ** (0.1 * gstop) - 1.0
    k = 1.0 / nat
    k1 = math.sqrt(GP / GS)
    kp = math.sqrt(1.0 - k * k)
    k1p = math.sqrt(1.0 - k1 * k1)
    n = int(math.ceil(ellipk(k) * ellipk(k1p) / (ellipk(kp) * ellipk(k1))))
    if n <= 0:
        n = 1
    wn = _order_wn_back(kind, passb_adj, passb_adj, fs)
    return n, wn


# ----------------------------------------------------------------------------
# Notch / peak / comb one-liners.
# ----------------------------------------------------------------------------

def iirdesign(wp, ws, gpass: float, gstop: float, *,
              ftype: str = "ellip", fs: float = 2.0,
              output: str = "design"):
    """Complete IIR design from a band specification
    (scipy.signal.iirdesign semantics): pick the minimum order of the
    requested family meeting <= ``gpass`` dB passband loss at ``wp`` and
    >= ``gstop`` dB attenuation at ``ws``, then design it.  The band
    type (low/high/band-pass/stop) is inferred from the edge layout,
    exactly as the *ord estimators do."""
    ords = {"butter": buttord, "cheby1": cheb1ord, "cheby2": cheb2ord,
            "ellip": ellipord}
    if ftype not in ords:
        raise ValueError(f"ftype must be one of {sorted(ords)}, "
                         f"got {ftype!r}")
    n, wn = ords[ftype](wp, ws, gpass, gstop, fs=fs)
    wp_, ws_, _, _ = _order_prewarp(wp, ws, fs)
    btype = {"lp": "lowpass", "hp": "highpass", "bp": "bandpass",
             "bs": "bandstop"}[_kind_of(wp_, ws_)]
    return iirfilter(n, wn, rp=gpass, rs=gstop, btype=btype, ftype=ftype,
                     fs=fs, output=output)


def gammatone(freq: float, ftype: str = "fir", *,
              order: Optional[int] = None,
              numtaps: Optional[int] = None,
              fs: float = 2.0) -> Tuple[np.ndarray, np.ndarray]:
    """Gammatone auditory filter (scipy.signal.gammatone semantics),
    from the defining equations — the sampled gammatone impulse response
    t^{n-1} e^{-2 pi b t} cos(2 pi f t) for 'fir', and Slaney's
    8th-order digital realization of the 4th-order gammatone ("An
    Efficient Implementation of the Patterson-Holdsworth Auditory Filter
    Bank", 1993) for 'iir'; b = 1.019 ERB(f) with the standard
    Glasberg-Moore ERB = f/9.26449 + 24.7."""
    import cmath
    import warnings
    from math import cos, exp, factorial, hypot, pi, sin, sqrt

    freq = float(freq)
    ftype = str(ftype).lower()
    if not 0.0 < freq < fs / 2.0:
        raise ValueError(f"freq must be in (0, fs/2), got {freq} @ fs={fs}")
    erb = freq / 9.26449 + 24.7
    if ftype == "fir":
        order = 4 if order is None else int(order)
        if not 0 < order <= 24:
            raise ValueError("order must be in (0, 24]")
        numtaps = max(int(fs * 0.015), 15) if numtaps is None \
            else int(numtaps)
        t = np.arange(numtaps, dtype=np.float64) / fs
        bw = 1.019 * erb
        b = t ** (order - 1) * np.exp(-2.0 * np.pi * bw * t) \
            * np.cos(2.0 * np.pi * freq * t)
        b *= 2.0 * (2.0 * np.pi * bw) ** order / factorial(order - 1) / fs
        return b, np.asarray([1.0])
    if ftype != "iir":
        raise ValueError("ftype must be 'fir' or 'iir'")
    if order is not None:
        warnings.warn("order is not used for the IIR gammatone filter "
                      "(the Slaney realization is fixed 4th-order "
                      "gammatone)", stacklevel=2)
    if numtaps is not None:
        warnings.warn("numtaps is not used for the IIR gammatone filter",
                      stacklevel=2)
    T = 1.0 / fs
    bw = 2.0 * pi * 1.019 * erb
    fr = 2.0 * freq * pi * T
    bwT = bw * T
    # Center-frequency gain normalization (Slaney eq. set).
    g1 = -2.0 * cmath.exp(2j * fr) * T
    g2 = 2.0 * cmath.exp(-bwT + 1j * fr) * T
    g3 = sqrt(3.0 + 2.0 ** 1.5) * sin(fr)
    g4 = sqrt(3.0 - 2.0 ** 1.5) * sin(fr)
    g5 = cmath.exp(2j * fr)
    g = ((g1 + g2 * (cos(fr) - g4)) * (g1 + g2 * (cos(fr) + g4))
         * (g1 + g2 * (cos(fr) - g3)) * (g1 + g2 * (cos(fr) + g3)))
    g /= (-2.0 / exp(2.0 * bwT) - 2.0 * g5
          + 2.0 * (1.0 + g5) / exp(bwT)) ** 4
    gm = hypot(g.real, g.imag)
    e = [exp(-k * bwT) for k in range(9)]
    b = np.array([T ** 4 / gm,
                  -4.0 * T ** 4 * cos(fr) * e[1] / gm,
                  6.0 * T ** 4 * cos(2.0 * fr) * e[2] / gm,
                  -4.0 * T ** 4 * cos(3.0 * fr) * e[3] / gm,
                  T ** 4 * cos(4.0 * fr) * e[4] / gm])
    a = np.array([1.0,
                  -8.0 * cos(fr) * e[1],
                  4.0 * (4.0 + 3.0 * cos(2.0 * fr)) * e[2],
                  -8.0 * (6.0 * cos(fr) + cos(3.0 * fr)) * e[3],
                  2.0 * (18.0 + 16.0 * cos(2.0 * fr)
                         + cos(4.0 * fr)) * e[4],
                  -8.0 * (6.0 * cos(fr) + cos(3.0 * fr)) * e[5],
                  4.0 * (4.0 + 3.0 * cos(2.0 * fr)) * e[6],
                  -8.0 * cos(fr) * e[7],
                  e[8]])
    return b, a


def iirnotch(f0: float, q: float, fs: float = 2.0) -> BiquadCascadeDesign:
    """Second-order notch at ``f0`` with -3 dB width f0/q (scipy.signal.
    iirnotch parity), as a single-section cascade design."""
    return _notch_peak(f0, q, fs, notch=True)


def iirpeak(f0: float, q: float, fs: float = 2.0) -> BiquadCascadeDesign:
    """Second-order resonator at ``f0`` with -3 dB width f0/q."""
    return _notch_peak(f0, q, fs, notch=False)


def _notch_peak(f0: float, q: float, fs: float,
                notch: bool) -> BiquadCascadeDesign:
    if not 0.0 < f0 < fs / 2.0:
        raise ValueError(f"need 0 < f0 < fs/2, got f0={f0}, fs={fs}")
    w0 = 2.0 * math.pi * f0 / fs
    beta = math.tan(w0 / (2.0 * q))
    g = 1.0 / (1.0 + beta)
    if notch:
        b = np.array([[1.0, -2.0 * math.cos(w0), 1.0]])
        gain = g
    else:
        b = np.array([[1.0, 0.0, -1.0]])
        gain = 1.0 - g
    a = np.array([[1.0, -2.0 * g * math.cos(w0), 2.0 * g - 1.0]])
    tag = FilterType.band_stop if notch else FilterType.band_pass
    return BiquadCascadeDesign(b=b, a=a, gain=gain, ftype=tag, f0=f0,
                               fs=fs, q=q)


def iircomb(f0: float, q: float, fs: float = 2.0, *,
            ftype: str = "notch",
            pass_zero: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """Comb filter notching (or peaking) every harmonic of ``f0``
    (scipy.signal.iircomb parity).  Returns (b, a) transfer-function
    arrays of length fs/f0 + 1 for use with ops.lfilter.lfilter — comb
    denominators are single long feedback taps, not biquad cascades."""
    if fs % f0:
        if abs(round(fs / f0) - fs / f0) > 1e-9:
            raise ValueError(f"fs/f0 must be an integer, got {fs / f0}")
    N = int(round(fs / f0))
    w_delta = 2.0 * math.pi * f0 / (q * fs)
    if ftype == "notch":
        G0, G = 1.0, 0.0
    elif ftype == "peak":
        G0, G = 0.0, 1.0
    else:
        raise ValueError(f"ftype must be 'notch' or 'peak', got {ftype!r}")
    GB = 1.0 / math.sqrt(2.0)
    beta = math.sqrt((GB * GB - G0 * G0)
                     / (G * G - GB * GB)) * math.tan(N * w_delta / 4.0)
    ax = (1.0 - beta) / (1.0 + beta)
    bx = (G0 + G * beta) / (1.0 + beta)
    cx = (G0 - G * beta) / (1.0 + beta)
    b = np.zeros(N + 1)
    a = np.zeros(N + 1)
    neg = (ftype == "notch") != bool(pass_zero)
    sign = -1.0 if neg else 1.0
    b[0], b[-1] = bx, sign * cx
    a[0], a[-1] = 1.0, sign * ax
    return b, a
