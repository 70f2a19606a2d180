"""Carried verbatim from ``simpledsp_tpu/design/ltisys.py``: NumPy only, except
:func:`dlsim` and :func:`freqresp`, which run on the port's ``ops/lfilter``
(a CPU float64 tensor) and return NumPy.

LTI representation conversions (scipy.signal parity, host-side f64).

The migration glue a scipy user expects around the design layer: move
between transfer-function (b, a), zero-pole-gain (z, p, k), and
second-order-section forms, plus continuous-to-discrete conversion.
All pure NumPy float64 running at design time — none of this belongs on
the TPU (the reference's analog is its host-side coefficient math,
reference: include/sdsp/casc_2o_iir.h:82-194).

`zpk2sos` itself lives in design/iir.py (it is the spine of the zpk
design pipeline); this module re-exports it for a complete conversion
family.
"""

from __future__ import annotations

import warnings
from typing import Tuple

import numpy as np

from simpledsp_tpu_torch.design.iir import zpk2sos


class BadCoefficients(UserWarning):
    """Warning about badly conditioned filter coefficients
    (scipy.signal.BadCoefficients)."""

__all__ = ["BadCoefficients",
           "tf2zpk", "zpk2tf", "tf2sos", "sos2tf", "sos2zpk",
           "normalize", "cont2discrete", "zpk2sos", "sosfreqz",
           "freqz_sos", "bilinear", "tf2ss", "ss2tf", "ss2zpk", "zpk2ss",
           "lp2lp", "lp2hp", "lp2bp", "lp2bs",
           "findfreqs", "abcd_normalize",
           "lsim", "impulse", "step", "dlsim", "dimpulse", "dstep",
           "bode", "freqresp", "dbode", "dfreqresp"]


def normalize(b, a) -> Tuple[np.ndarray, np.ndarray]:
    """Normalize a transfer function so a[0] == 1 (scipy.signal.normalize
    semantics): leading denominator zeros are trimmed, numerator columns
    within 1e-14 of zero are trimmed with a BadCoefficients warning, and
    complex coefficients are preserved (analog prototypes may be
    complex)."""
    b = np.atleast_1d(np.asarray(b))
    a = np.atleast_1d(np.asarray(a))
    b = b.astype(np.result_type(b.dtype, np.float64))
    a = a.astype(np.result_type(a.dtype, np.float64))
    if a.ndim != 1 or b.ndim > 2:
        raise ValueError("a must be 1-D, b at most 2-D")
    if np.all(a == 0):
        raise ValueError("Denominator must have at least one nonzero "
                         "element.")
    a = np.trim_zeros(a, "f")
    b = np.atleast_2d(b) / a[0]
    a = a / a[0]
    # Trim leading near-zero numerator columns (keep at least one).
    leading = 0
    for j in range(b.shape[1]):
        if np.all(np.abs(b[:, j]) <= 1e-14):
            leading += 1
        else:
            break
    if leading > 0:
        warnings.warn("Badly conditioned filter coefficients (numerator): "
                      "the results may be meaningless",
                      BadCoefficients, stacklevel=2)
        leading = min(leading, b.shape[1] - 1)
        b = b[:, leading:]
    return (b[0] if b.shape[0] == 1 else b), a


def tf2zpk(b, a) -> Tuple[np.ndarray, np.ndarray, float]:
    """(b, a) -> zeros, poles, gain (scipy.signal.tf2zpk semantics)."""
    b, a = normalize(b, a)
    b = np.atleast_1d(b)
    if b.ndim != 1:
        raise ValueError("tf2zpk expects a single-row numerator")
    if b[0] == 0.0:
        z = np.roots(b)
        k = 0.0
    else:
        z = np.roots(b / b[0])
        k = b[0].item()      # python float, or complex for complex b
    p = np.roots(a)
    return z, p, k


def zpk2tf(z, p, k: float) -> Tuple[np.ndarray, np.ndarray]:
    """zeros, poles, gain -> (b, a) (scipy.signal.zpk2tf semantics);
    real-valued output when roots come in conjugate pairs."""
    z = np.atleast_1d(np.asarray(z))
    p = np.atleast_1d(np.asarray(p))
    zpoly = np.poly(z)
    b = float(k) * zpoly
    a = np.poly(p)
    if np.isrealobj(zpoly) or _conj_paired(z):
        b = np.real(b)
    if _conj_paired(p):
        a = np.real(a)
    return np.atleast_1d(b), np.atleast_1d(a)


def _conj_paired(r: np.ndarray) -> bool:
    return bool(np.allclose(np.sort_complex(r),
                            np.sort_complex(np.conj(r))))


def tf2sos(b, a) -> np.ndarray:
    """(b, a) -> (n, 6) second-order sections via the zpk pipeline
    (scipy.signal.tf2sos semantics: pairing through zpk2sos)."""
    z, p, k = tf2zpk(b, a)
    return zpk2sos(z, p, k)


def sos2tf(sos) -> Tuple[np.ndarray, np.ndarray]:
    """(n, 6) sections -> one (b, a) by polynomial multiplication
    (scipy.signal.sos2tf semantics)."""
    sos = np.asarray(sos, dtype=np.float64)
    if sos.ndim != 2 or sos.shape[1] != 6:
        raise ValueError(f"sos must be (n, 6), got {sos.shape}")
    b = np.ones(1)
    a = np.ones(1)
    for row in sos:
        b = np.polymul(b, row[:3])
        a = np.polymul(a, row[3:])
    return b, a


def sos2zpk(sos) -> Tuple[np.ndarray, np.ndarray, float]:
    """(n, 6) sections -> zeros, poles, gain (scipy.signal.sos2zpk
    semantics: 2n roots, including the zero-padding of degenerate
    sections)."""
    sos = np.asarray(sos, dtype=np.float64)
    if sos.ndim != 2 or sos.shape[1] != 6:
        raise ValueError(f"sos must be (n, 6), got {sos.shape}")
    n = sos.shape[0]
    z = np.zeros(2 * n, dtype=np.complex128)
    p = np.zeros(2 * n, dtype=np.complex128)
    k = 1.0
    # Per-section tf2zpk (scipy routes each row through tf2zpk/normalize):
    # leading numerator zeros are trimmed so a pure-delay section
    # [0, 1, 0 | a] contributes gain 1.0, not b0/a0 == 0.
    for i, row in enumerate(sos):
        zi, pi, ki = tf2zpk(row[:3], row[3:])
        z[2 * i: 2 * i + len(zi)] = zi
        p[2 * i: 2 * i + len(pi)] = pi
        k *= ki
    return z, p, k


def sosfreqz(sos, n: int = 512, *, fs: float = 2.0 * np.pi
             ) -> Tuple[np.ndarray, np.ndarray]:
    """Frequency response of a cascade of second-order sections on n
    points of [0, fs/2) (scipy.signal.sosfreqz(worN=n) semantics): the
    per-section responses multiplied — numerically far better than
    expanding to one high-order polynomial first."""
    sos = np.asarray(sos, dtype=np.float64)
    if sos.ndim != 2 or sos.shape[1] != 6:
        raise ValueError(f"sos must be (n, 6), got {sos.shape}")
    w = np.linspace(0.0, np.pi, n, endpoint=False)
    z = np.exp(-1j * w)
    h = np.ones_like(z)
    for row in sos:
        h *= np.polynomial.polynomial.polyval(z, row[:3]) \
            / np.polynomial.polynomial.polyval(z, row[3:])
    return w * (fs / (2.0 * np.pi)), h


def freqz_sos(sos, n: int = 512, *, fs: float = 2.0 * np.pi
              ) -> Tuple[np.ndarray, np.ndarray]:
    """scipy 1.15+ name for :func:`sosfreqz`."""
    return sosfreqz(sos, n, fs=fs)


def bilinear(b, a, fs: float = 1.0) -> Tuple[np.ndarray, np.ndarray]:
    """Bilinear (Tustin) transform of an analog transfer function
    (scipy.signal.bilinear semantics), routed through the framework's
    zpk-level bilinear_zpk."""
    from simpledsp_tpu_torch.design.iir import bilinear_zpk
    z, p, k = tf2zpk(b, a)
    zd, pd, kd = bilinear_zpk(z, p, k, fs=float(fs))
    bd, ad = zpk2tf(zd, pd, kd)
    if bd.size < ad.size:
        bd = np.concatenate([np.zeros(ad.size - bd.size), bd])
    return bd, ad


def findfreqs(num, den, N: int, kind: str = "ba") -> np.ndarray:
    """Log-spaced frequency grid suited to an analog filter's response
    (scipy.signal.findfreqs semantics): decades chosen from the pole and
    zero magnitudes (kind='ba': polynomial coefficients; 'zp': roots)."""
    if kind == "ba":
        ep = np.atleast_1d(np.roots(np.asarray(den)))
        tz = np.atleast_1d(np.roots(np.asarray(num)))
    elif kind == "zp":
        ep = np.atleast_1d(np.asarray(den))
        tz = np.atleast_1d(np.asarray(num))
    else:
        raise ValueError("input must be one of {'ba', 'zp'}")
    ep = ep.astype(np.complex128)
    tz = tz.astype(np.complex128)
    if ep.size == 0:
        ep = np.asarray([-1000.0 + 0j])
    ez = np.concatenate([ep[ep.imag >= 0],
                         tz[(np.abs(tz) < 1e5) & (tz.imag >= 0)]])
    integ = (np.abs(ez) < 1e-10).astype(np.float64)
    hfreq = np.round(np.log10(np.max(3.0 * np.abs(ez.real + integ)
                                     + 1.5 * ez.imag)) + 0.5)
    lfreq = np.round(np.log10(0.1 * np.min(np.abs((ez + integ).real)
                                           + 2.0 * ez.imag)) - 0.5)
    return np.logspace(lfreq, hfreq, int(N))


def abcd_normalize(A=None, B=None, C=None, D=None):
    """Fill in and shape-check state-space matrices, inferring missing
    ones as zeros (scipy.signal.abcd_normalize semantics)."""
    if A is None and B is None and C is None:
        raise ValueError("Dimension n is undefined for A = B = C = None")
    if B is None and D is None:
        raise ValueError("Dimension p is undefined for B = D = None")
    if C is None and D is None:
        raise ValueError("Dimension q is undefined for C = D = None")
    mats = [np.atleast_2d(np.asarray(m, dtype=np.float64))
            if m is not None else np.zeros((0, 0)) for m in (A, B, C, D)]
    A, B, C, D = mats
    n = A.shape[0] or B.shape[0] or C.shape[1] or 0
    p = B.shape[1] or D.shape[1] or 0
    q = C.shape[0] or D.shape[0] or 0
    A = np.zeros((n, n)) if A.size == 0 else A
    B = np.zeros((n, p)) if B.size == 0 else B
    C = np.zeros((q, n)) if C.size == 0 else C
    D = np.zeros((q, p)) if D.size == 0 else D
    for name, m, want in (("A", A, (n, n)), ("B", B, (n, p)),
                          ("C", C, (q, n)), ("D", D, (q, p))):
        if m.shape != want:
            raise ValueError(f"Parameter {name} has shape {m.shape} but "
                             f"should be {want}")
    return A, B, C, D


def lp2lp(b, a, wo: float = 1.0) -> Tuple[np.ndarray, np.ndarray]:
    """Shift an analog low-pass prototype's cutoff to ``wo``
    (scipy.signal.lp2lp semantics: direct power-of-wo column scaling of
    the polynomial coefficients; the zpk-level transform lives in
    design/iir.py:lp2lp_zpk)."""
    b = np.atleast_1d(np.asarray(b))
    a = np.atleast_1d(np.asarray(a))
    b = b.astype(np.result_type(b.dtype, np.float64))
    a = a.astype(np.result_type(a.dtype, np.float64))
    wo = float(wo)
    d, n = len(a), len(b)
    m = max(d, n)
    pwo = wo ** np.arange(m - 1, -1, -1)
    start1 = max(n - d, 0)
    start2 = max(d - n, 0)
    return normalize(b * pwo[start1] / pwo[start2:],
                     a * pwo[start1] / pwo[start1:])


def lp2hp(b, a, wo: float = 1.0) -> Tuple[np.ndarray, np.ndarray]:
    """Low-pass prototype -> high-pass at ``wo``
    (scipy.signal.lp2hp semantics: s -> wo / s, i.e. reversed
    coefficients scaled by powers of wo)."""
    b = np.atleast_1d(np.asarray(b))
    a = np.atleast_1d(np.asarray(a))
    b = b.astype(np.result_type(b.dtype, np.float64))
    a = a.astype(np.result_type(a.dtype, np.float64))
    wo = float(wo)
    d, n = len(a), len(b)
    m = max(d, n)
    pwo = wo ** np.arange(m)
    if d >= n:
        outa = a[::-1] * pwo
        outb = np.zeros(d, dtype=b.dtype)
        outb[:n] = b[::-1] * pwo[:n]
    else:
        outb = b[::-1] * pwo
        outa = np.zeros(n, dtype=a.dtype)
        outa[:d] = a[::-1] * pwo[:d]
    return normalize(outb, outa)


def _lp2band(b, a, wo: float, bw: float, stop: bool):
    """Shared s -> (s^2 + wo^2)/(bw s) [band-pass] or its reciprocal
    [band-stop] polynomial expansion (scipy's lp2bp/lp2bs double-sum
    construction)."""
    from math import comb
    b = np.atleast_1d(np.asarray(b))
    a = np.atleast_1d(np.asarray(a))
    b = b.astype(np.result_type(b.dtype, np.float64))
    a = a.astype(np.result_type(a.dtype, np.float64))
    dd, nn = len(a) - 1, len(b) - 1
    ma = max(nn, dd)
    np_, dp_ = nn + ma, dd + ma
    wosq = float(wo) ** 2
    bw = float(bw)

    def expand(coefs, deg, out_deg):
        out = np.zeros(out_deg + 1, dtype=coefs.dtype)
        for j in range(out_deg + 1):
            val = 0.0
            for i in range(deg + 1):
                if stop:
                    # s -> bw s / (s^2 + wo^2): common denominator
                    # (s^2 + wo^2)^ma, numerator term (bw s)^i
                    # (s^2 + wo^2)^(ma - i) expanded binomially.
                    for k in range(ma - i + 1):
                        if i + 2 * k == j:
                            val += (comb(ma - i, k) * coefs[deg - i]
                                    * wosq ** (ma - i - k) * bw ** i)
                else:
                    for k in range(i + 1):
                        if ma - i + 2 * k == j:
                            val += (comb(i, k) * coefs[deg - i]
                                    * wosq ** (i - k) / bw ** i)
            out[out_deg - j] = val
        return out

    if stop:
        out_deg = 2 * ma
        return normalize(expand(b, nn, out_deg), expand(a, dd, out_deg))
    return normalize(expand(b, nn, np_), expand(a, dd, dp_))


def lp2bp(b, a, wo: float = 1.0, bw: float = 1.0
          ) -> Tuple[np.ndarray, np.ndarray]:
    """Low-pass prototype -> band-pass centered at ``wo`` with width
    ``bw`` (scipy.signal.lp2bp semantics; zpk-level transform in
    design/iir.py:lp2bp_zpk)."""
    return _lp2band(b, a, wo, bw, stop=False)


def lp2bs(b, a, wo: float = 1.0, bw: float = 1.0
          ) -> Tuple[np.ndarray, np.ndarray]:
    """Low-pass prototype -> band-stop (scipy.signal.lp2bs semantics)."""
    return _lp2band(b, a, wo, bw, stop=True)


def ss2zpk(A, B, C, D, input: int = 0
           ) -> Tuple[np.ndarray, np.ndarray, float]:
    """(A, B, C, D) -> zeros, poles, gain (scipy.signal.ss2zpk
    semantics: tf2zpk of ss2tf)."""
    return tf2zpk(*ss2tf(A, B, C, D, input=input))


def zpk2ss(z, p, k: float
           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """zeros, poles, gain -> controllable-canonical (A, B, C, D)
    (scipy.signal.zpk2ss semantics: tf2ss of zpk2tf)."""
    return tf2ss(*zpk2tf(z, p, k))


def tf2ss(b, a) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(b, a) -> controllable-canonical (A, B, C, D)
    (scipy.signal.tf2ss semantics)."""
    b0, a0 = normalize(b, a)
    b0 = np.atleast_1d(b0)
    if b0.ndim != 1:
        raise ValueError("tf2ss expects a single-row numerator")
    n = a0.size - 1
    if n == 0:
        return (np.zeros((0, 0)), np.zeros((0, 1)), np.zeros((1, 0)),
                np.atleast_2d(b0[:1]))
    bp = np.zeros(n + 1)
    bp[n + 1 - b0.size:] = b0
    d = bp[0]
    A = np.zeros((n, n))
    A[0] = -a0[1:]
    if n > 1:
        A[1:, :-1] = np.eye(n - 1)
    B = np.zeros((n, 1))
    B[0, 0] = 1.0
    C = (bp[1:] - d * a0[1:])[None, :]
    D = np.array([[d]])
    return A, B, C, D


def ss2tf(A, B, C, D, input: int = 0
          ) -> Tuple[np.ndarray, np.ndarray]:
    """(A, B, C, D) -> (num, den) for one input (scipy.signal.ss2tf
    semantics: num is (n_outputs, order + 1)), via the matrix
    determinant lemma — det(zI - A + b c) = den(z) (1 + c (zI-A)^-1 b),
    no symbolic algebra."""
    A = np.atleast_2d(np.asarray(A, dtype=np.float64))
    B = np.atleast_2d(np.asarray(B, dtype=np.float64))
    C = np.atleast_2d(np.asarray(C, dtype=np.float64))
    D = np.atleast_2d(np.asarray(D, dtype=np.float64))
    n = A.shape[0]
    den = np.poly(A) if n else np.ones(1)
    bcol = B[:, input: input + 1]
    nout = C.shape[0]
    num = np.empty((nout, n + 1))
    for i in range(nout):
        di = D[i, input] if D.size else 0.0
        if n:
            num[i] = (np.poly(A - bcol @ C[i: i + 1]) - den) + di * den
        else:
            num[i] = np.atleast_1d(di)
    return num, den


def cont2discrete(system, dt: float, method: str = "zoh"
                  ) -> Tuple[np.ndarray, np.ndarray, float]:
    """Discretize a continuous-time transfer function (b, a) at step dt
    (scipy.signal.cont2discrete semantics for the supported methods:
    'bilinear'/'tustin', 'euler'/'forward_diff', 'backward_diff', 'zoh').
    Returns (bd, ad, dt).

    The rational methods substitute the corresponding s -> f(z) map at
    the zpk level and use the framework's own bilinear_zpk for 'tustin';
    'zoh' matrix-exponentiates the controllable-canonical state-space
    realization (the textbook route; scipy used only for expm).  Like
    scipy, the returned numerator is left-padded with zeros to the
    denominator's length — that padding carries the relative degree in
    the z^-1 convention lfilter/freqz use, so do not trim it."""
    b, a = system
    b = np.atleast_1d(np.asarray(b, dtype=np.float64))
    a = np.atleast_1d(np.asarray(a, dtype=np.float64))

    def padded(bd, ad):
        bd, ad = normalize(bd, ad)
        bd = np.atleast_1d(bd)
        if bd.size < ad.size:
            bd = np.concatenate([np.zeros(ad.size - bd.size), bd])
        return bd, ad, dt
    if method in ("bilinear", "tustin"):
        from simpledsp_tpu_torch.design.iir import bilinear_zpk
        z, p, k = tf2zpk(b, a)
        zd, pd, kd = bilinear_zpk(z, p, k, fs=1.0 / dt)
        bd2, ad2 = zpk2tf(zd, pd, kd)
        return padded(bd2, ad2)
    if method in ("euler", "forward_diff", "backward_diff"):
        # Polynomial substitution s -> q(z)/r(z) with the common
        # denominator r(z)^n multiplied through both sides:
        # forward Euler  s = (z - 1)/dt        (q = [1, -1],  r = [dt])
        # backward diff  s = (z - 1)/(dt z)    (q = [1, -1],  r = [dt, 0])
        q = np.array([1.0, -1.0])
        r = (np.array([dt, 0.0]) if method == "backward_diff"
             else np.array([dt]))
        n = max(b.size, a.size) - 1

        def sub(poly):
            deg = poly.size - 1
            acc = np.zeros(1)
            for i, c in enumerate(poly):
                pw = deg - i
                term = np.ones(1)
                for _ in range(pw):
                    term = np.polymul(term, q)
                for _ in range(n - pw):
                    term = np.polymul(term, r)
                acc = np.polyadd(acc, c * term)
            return acc

        return padded(sub(b), sub(a))
    if method == "zoh":
        # Controllable-canonical state space, matrix-exponential
        # discretization [Ad Bd; 0 I] = expm([A B; 0 0] dt), then back to
        # a transfer function via the matrix determinant lemma:
        # C (zI - Ad)^-1 Bd = [det(zI - Ad + Bd C) - det(zI - Ad)]
        #                     / det(zI - Ad).
        from scipy.linalg import expm
        b0, a0 = normalize(b, a)
        b0 = np.atleast_1d(b0)
        n = a0.size - 1
        if n == 0:
            return b0, a0, dt
        bp = np.zeros(n + 1)
        bp[n + 1 - b0.size:] = b0
        d = bp[0]
        cvec = bp[1:] - d * a0[1:]
        A = np.zeros((n, n))
        A[0] = -a0[1:]
        if n > 1:
            A[1:, :-1] = np.eye(n - 1)
        M = np.zeros((n + 1, n + 1))
        M[:n, :n] = A
        M[0, n] = 1.0                      # B = e1
        Md = expm(M * dt)
        Ad, Bd = Md[:n, :n], Md[:n, n:]
        ad = np.poly(Ad)
        bd = (np.poly(Ad - Bd @ cvec[None, :]) - ad) + d * ad
        return padded(bd, ad)
    raise ValueError(f"unknown method {method!r}")


# ---------------------------------------------------------------------------
# LTI simulation (scipy.signal lsim/impulse/step + discrete counterparts)
# ---------------------------------------------------------------------------

def _expm_foh(A: np.ndarray, B: np.ndarray, dt: float):
    """(Ad, F0, F1): exact propagation of x' = Ax + Bu over one step with
    LINEARLY interpolated input (first-order hold):
    x(dt) = Ad x0 + F0 u0 + F1 u1, via one augmented matrix exponential
    with top blocks [Ad | P | Q], P = int e^{A(dt-s)} B ds,
    Q = int e^{A(dt-s)} B s/dt ds."""
    from scipy.linalg import expm
    n = A.shape[0]
    m = np.zeros((n + 2, n + 2))
    m[:n, :n] = A
    m[:n, n] = B[:, 0]
    m[n, n + 1] = 1.0 / dt
    md = expm(m * dt)
    ad = md[:n, :n]
    p = md[:n, n]
    q = md[:n, n + 1]       # the 1/dt ramp slope is inside M already
    return ad, p - q, q


def lsim(system, u, t, *, interp: bool = True
         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Simulate a continuous-time transfer function (b, a) driven by
    ``u`` sampled on the UNIFORM grid ``t`` (scipy.signal.lsim semantics
    for tf systems: returns (t, y, x)).  ``interp=True`` treats u as
    piecewise-linear (first-order hold, scipy's default), False as
    zero-order hold; both propagate exactly via matrix exponentials of
    the controllable-canonical realization — no ODE solver."""
    b, a = system
    t = np.asarray(t, dtype=np.float64)
    u = np.asarray(u, dtype=np.float64)
    if t.ndim != 1 or t.size < 2:
        raise ValueError("t must be a 1-D grid with >= 2 points")
    dt = t[1] - t[0]
    if not np.allclose(np.diff(t), dt, rtol=1e-8):
        raise ValueError("lsim requires a uniformly spaced t")
    if u.shape != t.shape:
        raise ValueError("u must match t in shape")
    A, B, C, D = tf2ss(b, a)
    n = A.shape[0]
    x = np.zeros((t.size, n))
    if n:
        if interp:
            ad, f0, f1 = _expm_foh(A, B, dt)
            for i in range(t.size - 1):
                x[i + 1] = ad @ x[i] + f0 * u[i] + f1 * u[i + 1]
        else:
            from scipy.linalg import expm
            m = np.zeros((n + 1, n + 1))
            m[:n, :n] = A
            m[:n, n] = B[:, 0]
            md = expm(m * dt)
            ad, bd = md[:n, :n], md[:n, n]
            for i in range(t.size - 1):
                x[i + 1] = ad @ x[i] + bd * u[i]
    y = x @ C[0] + D[0, 0] * u
    return t, y, x


def impulse(system, *, n: int = 100, t=None
            ) -> Tuple[np.ndarray, np.ndarray]:
    """Impulse response of a continuous (b, a) system
    (scipy.signal.impulse semantics: x0 = B, zero input): (t, y)."""
    b, a = system
    A, B, C, D = tf2ss(b, a)
    t = _default_t(A, n) if t is None else np.asarray(t, np.float64)
    from scipy.linalg import expm
    dt = t[1] - t[0]
    ad = expm(A * dt)
    x = B[:, 0].copy()
    y = np.empty(t.size)
    for i in range(t.size):
        y[i] = C[0] @ x
        x = ad @ x
    return t, y


def step(system, *, n: int = 100, t=None) -> Tuple[np.ndarray, np.ndarray]:
    """Step response of a continuous (b, a) system
    (scipy.signal.step semantics): (t, y)."""
    b, a = system
    A, _, _, _ = tf2ss(b, a)
    t = _default_t(A, n) if t is None else np.asarray(t, np.float64)
    tout, y, _ = lsim(system, np.ones_like(t), t)
    return tout, y


def _default_t(A: np.ndarray, n: int) -> np.ndarray:
    """Response horizon from the slowest pole (scipy's _default_response_times:
    7 time constants of the least-damped mode)."""
    if A.shape[0]:
        vals = np.linalg.eigvals(A)
        r = np.min(np.abs(np.real(vals)))
        if r == 0.0 or np.isnan(r):
            r = 1.0
        tc = 1.0 / r
    else:
        tc = 1.0
    return np.linspace(0.0, 7.0 * tc, int(n))


def _pad_z_num(b, a) -> Tuple[np.ndarray, np.ndarray]:
    """scipy's dlti convention is polynomials in z (descending powers):
    a numerator SHORTER than the denominator carries relative degree,
    i.e. extra delay.  Left-pad it with zeros so the z^-1-convention
    machinery (lfilter, unit-circle polyval) reproduces that delay
    exactly; a numerator longer than the denominator is non-causal."""
    b = np.atleast_1d(np.asarray(b, dtype=np.float64))
    a = np.atleast_1d(np.asarray(a, dtype=np.float64))
    if b.size > a.size:
        raise ValueError("numerator degree exceeds denominator degree "
                         "(non-causal discrete system)")
    if b.size < a.size:
        b = np.concatenate([np.zeros(a.size - b.size), b])
    return b, a


def dlsim(system, u, t=None, x0=None
          ) -> Tuple[np.ndarray, np.ndarray]:
    """Simulate a discrete transfer function (b, a, dt) driven by ``u``
    (scipy.signal.dlsim tf semantics, INCLUDING the z-polynomial
    convention: a shorter numerator is relative degree = delay): returns
    (tout, yout) — the output IS the framework lfilter run host-side in
    f64 (x0 must be None for the tf form, as in scipy)."""
    b, a, dt = system
    if x0 is not None:
        raise ValueError("x0 is only meaningful for state-space systems")
    b, a = _pad_z_num(b, a)
    u = np.asarray(u, dtype=np.float64)
    tout = (np.arange(u.shape[0]) * float(dt) if t is None
            else np.asarray(t, np.float64))
    import torch

    from simpledsp_tpu_torch.ops.lfilter import lfilter_scan
    y, _ = lfilter_scan(b, a, torch.as_tensor(u, dtype=torch.float64))
    return tout, y.numpy()


def dimpulse(system, *, n: int = 100) -> Tuple[np.ndarray, Tuple]:
    """Discrete impulse response (scipy.signal.dimpulse tf semantics):
    (tout, (y,))."""
    b, a, dt = system
    u = np.zeros(int(n))
    u[0] = 1.0
    tout, y = dlsim((b, a, dt), u)
    return tout, (y,)


def dstep(system, *, n: int = 100) -> Tuple[np.ndarray, Tuple]:
    """Discrete step response (scipy.signal.dstep tf semantics):
    (tout, (y,))."""
    b, a, dt = system
    tout, y = dlsim((b, a, dt), np.ones(int(n)))
    return tout, (y,)


def freqresp(system, w) -> Tuple[np.ndarray, np.ndarray]:
    """Continuous frequency response H(jw) (scipy.signal.freqresp
    semantics with explicit w)."""
    from simpledsp_tpu_torch.ops.lfilter import freqs
    b, a = system
    return freqs(b, a, worN=np.asarray(w, np.float64))


def bode(system, w) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Bode magnitude (dB) and phase (degrees, unwrapped) of a
    continuous (b, a) system (scipy.signal.bode semantics with
    explicit w)."""
    w, h = freqresp(system, w)
    mag = 20.0 * np.log10(np.abs(h))
    phase = np.degrees(np.unwrap(np.angle(h)))
    return w, mag, phase


def dfreqresp(system, w) -> Tuple[np.ndarray, np.ndarray]:
    """Discrete frequency response H(e^{j w dt}) for (b, a, dt)
    (scipy.signal.dfreqresp semantics with explicit w in rad/s; the
    z-polynomial relative-degree convention is honored via
    :func:`_pad_z_num`)."""
    b, a, dt = system
    b64, a64 = _pad_z_num(b, a)
    wn = np.asarray(w, np.float64) * float(dt)
    z = np.exp(-1j * wn)
    h = np.polynomial.polynomial.polyval(z, b64) \
        / np.polynomial.polynomial.polyval(z, a64)
    return np.asarray(w, np.float64), h


def dbode(system, w) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Discrete Bode plot data for (b, a, dt)
    (scipy.signal.dbode semantics with explicit w in rad/s)."""
    b, a, dt = system
    b64, a64 = _pad_z_num(b, a)
    wn = np.asarray(w, np.float64) * float(dt)
    z = np.exp(-1j * wn)
    h = np.polynomial.polynomial.polyval(z, b64) \
        / np.polynomial.polynomial.polyval(z, a64)
    mag = 20.0 * np.log10(np.abs(h))
    phase = np.degrees(np.unwrap(np.angle(h)))
    return np.asarray(w, np.float64), mag, phase
