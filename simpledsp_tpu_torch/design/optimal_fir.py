"""Carried verbatim from ``simpledsp_tpu/design/optimal_fir.py``: NumPy
only, so both packages design bit-identical taps.

Optimal FIR design: Parks-McClellan (remez), least-squares (firls),
and minimum-phase conversion (host-side float64).

The reference library carries no FIR design at all (its filters are biquad
IIR cascades, reference: include/sdsp/casc_2o_iir.h); these are the standard
design tools a DSP user expects next to the windowed-sinc family in
design/fir.py.  Everything here is the framework's own implementation of
the textbook algorithms — the Remez exchange runs on a barycentric-Lagrange
equioscillation solve in x = cos(2*pi*f), and synthesis inverts the exact
DTFT samples (no window) — validated against scipy.signal in tests.

All run once at trace time on the host; taps become constants in the
jitted HLO like the reference's compile-time tables (fft.h:197-214).
"""

from __future__ import annotations

import math
import warnings
from typing import Optional, Sequence

import numpy as np

__all__ = ["remez", "firls", "minimum_phase"]


# ---------------------------------------------------------------------------
# Remez exchange (Parks-McClellan)


def _pm_grid(num_taps: int, bands: np.ndarray, desired: np.ndarray,
             weight: np.ndarray, ftype: str, grid_density: int, nfcns: int,
             neg: bool, nodd: bool):
    """Dense frequency grid (cycles/sample, 0..0.5) with per-point desired
    response and weight — an exact replica of the classic PM
    (McClellan/Parks/Rabiner 1973) grid: per band, points f_lo + k*delf by
    repeated addition, the first point past f_hi clamped back to f_hi, the
    first edge lifted to delf for antisymmetric types, and the last point
    dropped when the type's trig factor vanishes at Nyquist.  The discrete
    minimax optimum depends on the grid, so tap-for-tap parity with other
    PM implementations requires this construction verbatim."""
    delf = 0.5 / (grid_density * nfcns)
    bands = np.array(bands, dtype=np.float64, copy=True)
    if neg and bands[0] < delf:
        bands[0] = delf
    grid, des, wt, seg = [], [], [], []
    for b in range(len(bands) // 2):
        f_lo, f_hi = bands[2 * b], bands[2 * b + 1]
        f = f_lo
        gband = []
        while True:
            gband.append(f)
            f = f + delf
            if f > f_hi:
                break
        gband[-1] = f_hi
        gband = np.asarray(gband)
        if ftype == "differentiator":
            # Desired is a slope: D = slope * f; relative-error weighting
            # unless the slope is (near) zero.
            d = desired[b] * gband
            if desired[b] >= 1e-4:
                w = weight[b] / gband
            else:
                w = np.full(len(gband), weight[b])
        else:
            d = np.full(len(gband), desired[b])
            w = np.full(len(gband), weight[b])
        grid.append(gband)
        des.append(d)
        wt.append(w)
        seg.append(np.full(len(gband), b))
    grid = np.concatenate(grid)
    des = np.concatenate(des)
    wt = np.concatenate(wt)
    seg = np.concatenate(seg)
    # Types II and III have q(0.5) = 0: drop a final grid point near
    # Nyquist so the transformed weight never vanishes.
    if (int(neg) == int(nodd)) and grid[-1] > 0.5 - delf:
        grid, des, wt, seg = grid[:-1], des[:-1], wt[:-1], seg[:-1]
    return grid, des, wt, seg


def _pm_transform(grid, des, wt, neg: bool, nodd: bool):
    """Fold the linear-phase type's fixed trig factor into D and W so the
    exchange always fits a pure cosine polynomial P(f) = sum a_k cos(2πkf):
    H(f) = P(f) * q(f) with q = 1 / cos(πf) / sin(2πf) / sin(πf) for
    types I / II / III / IV.  The grid construction guarantees q != 0."""
    if not neg:
        if nodd:
            q = np.ones_like(grid)
        else:
            q = np.cos(np.pi * grid)
    else:
        if nodd:
            q = np.sin(2 * np.pi * grid)
        else:
            q = np.sin(np.pi * grid)
    return des / q, wt * q


def _bary_weights(x: np.ndarray):
    """Barycentric weights on nodes x, log-scaled against under/overflow:
    returns b with b_k proportional to 1/prod_j (x_k - x_j)."""
    n = len(x)
    d = x[:, None] - x[None, :]
    np.fill_diagonal(d, 1.0)
    logs = -np.sum(np.log(np.abs(d)), axis=1)
    sign = np.prod(np.sign(d), axis=1)
    return sign * np.exp(logs - logs.max())


def _eval_bary(xg, xn, cn, bn):
    """Evaluate the polynomial through nodes (xn, cn) with barycentric
    weights bn at the points xg (exact at coincident nodes)."""
    diff = xg[:, None] - xn[None, :]
    hit = np.abs(diff) < 1e-15
    with np.errstate(divide="ignore", invalid="ignore"):
        k = bn[None, :] / diff
        p = (k @ cn) / k.sum(axis=1)
    for i in np.nonzero(hit.any(axis=1))[0]:
        p[i] = cn[np.argmax(hit[i])]
    return p


def _remez_exchange(grid, des, wt, seg, nfcns: int, maxiter: int):
    """Core equioscillation exchange on the cosine-polynomial problem.
    Returns (extremal x nodes, node values C_k, delta, converged).

    Multiple exchange: each iteration levels the error on the current
    extremal set (the barycentric delta solve), then rebuilds the set from
    the true local extrema of the signed weighted error — one-sided at band
    boundaries, admitted only when |err| >= |delta|, collapsed to one per
    same-sign run, and trimmed from the weaker end to r = nfcns+1 points.
    The fixed point of this map is the unique discrete minimax solution on
    the grid (equioscillation theorem), so independent PM implementations
    agree tap-for-tap once the grid matches.
    """
    ngrid = len(grid)
    x_all = np.cos(2 * np.pi * grid)
    r = nfcns + 1  # extremal count
    # Classic init: evenly strided over the grid, last point pinned.
    stride = (ngrid - 1) / nfcns
    iext = np.minimum(np.round(np.arange(nfcns) * stride).astype(int),
                      ngrid - 1)
    iext = np.unique(np.concatenate([iext, [ngrid - 1]]))
    if len(iext) < r:
        pad = np.setdiff1d(np.arange(ngrid), iext)
        iext = np.sort(np.concatenate([iext, pad[: r - len(iext)]]))
    # Band-segment boundaries: extrema detection never looks across a
    # transition gap.
    band_edges = np.nonzero(np.diff(seg) != 0)[0]
    seg_start = np.concatenate([[0], band_edges + 1])
    seg_end = np.concatenate([band_edges, [ngrid - 1]])
    signs = (-1.0) ** np.arange(r)

    converged = False
    for _ in range(maxiter):
        xe = x_all[iext]
        b = _bary_weights(xe)
        delta = (b @ des[iext]) / (b @ (signs / wt[iext]))
        ce = des[iext] - signs * delta / wt[iext]
        # Barycentric evaluation of P on the whole grid through the first
        # nfcns nodes (degree nfcns-1 polynomial in x).
        xn, cn = xe[:nfcns], ce[:nfcns]
        p = _eval_bary(x_all, xn, cn, _bary_weights(xn))
        err = (p - des) * wt
        ae = np.abs(err)
        ad = np.abs(delta)

        # Candidates: one-sided local extrema of the SIGNED error within
        # each band segment whose magnitude reaches |delta| (points below
        # the current leveled error can never be extremal in the optimum).
        pos = err > 0
        left_ok = np.ones(ngrid, dtype=bool)
        left_ok[1:] = np.where(pos[1:], err[1:] >= err[:-1],
                               err[1:] <= err[:-1])
        left_ok[seg_start] = True
        right_ok = np.ones(ngrid, dtype=bool)
        right_ok[:-1] = np.where(pos[:-1], err[:-1] >= err[1:],
                                 err[:-1] <= err[1:])
        right_ok[seg_end] = True
        cand = np.nonzero(left_ok & right_ok
                          & (ae >= ad * (1.0 - 1e-12)))[0]
        if len(cand) == 0:
            break

        # Collapse same-sign consecutive runs, keeping the largest |err|.
        keep: list[int] = []
        for i in cand:
            if keep and np.sign(err[i]) == np.sign(err[keep[-1]]):
                if ae[i] > ae[keep[-1]]:
                    keep[-1] = int(i)
            else:
                keep.append(int(i))
        if len(keep) < r:
            # Degenerate iteration (fewer alternations than needed): merge
            # the previous extremal set back in and re-collapse.
            merged = sorted(set(keep) | set(int(i) for i in iext))
            keep = []
            for i in merged:
                if keep and np.sign(err[i]) == np.sign(err[keep[-1]]):
                    if ae[i] > ae[keep[-1]]:
                        keep[-1] = int(i)
                else:
                    keep.append(int(i))
            if len(keep) < r:
                break
        # Trim to r extrema, dropping the weaker end first (preserves
        # alternation — an interior drop would create a same-sign pair).
        while len(keep) > r:
            if ae[keep[0]] < ae[keep[-1]]:
                keep.pop(0)
            else:
                keep.pop()

        new_iext = np.asarray(keep, dtype=int)
        if np.array_equal(new_iext, iext):
            converged = True
            break
        iext = new_iext

    xe = x_all[iext]
    b = _bary_weights(xe)
    delta = (b @ des[iext]) / (b @ (signs / wt[iext]))
    ce = des[iext] - signs * delta / wt[iext]
    return xe[:nfcns], ce[:nfcns], delta, converged


def remez(num_taps: int, bands: Sequence[float], desired: Sequence[float],
          *, weight: Optional[Sequence[float]] = None,
          ftype: str = "bandpass", maxiter: int = 25,
          grid_density: int = 16, fs: float = 1.0) -> np.ndarray:
    """Parks-McClellan optimal equiripple FIR design
    (scipy.signal.remez semantics).

    ``bands`` is a flat, monotonic list of band edges in the units of
    ``fs``; ``desired`` one gain per band (a slope for
    ``ftype='differentiator'``); ``weight`` one relative ripple weight per
    band.  ``ftype`` selects symmetric ('bandpass') or antisymmetric
    ('differentiator', 'hilbert') linear phase.  Host float64; validated
    against scipy.signal.remez in tests.
    """
    if ftype not in ("bandpass", "differentiator", "hilbert"):
        raise ValueError(f"unknown ftype {ftype!r}")
    bands = np.asarray(bands, dtype=np.float64) / fs  # cycles/sample
    desired = np.asarray(desired, dtype=np.float64)
    if bands.ndim != 1 or len(bands) % 2 or len(bands) < 2:
        raise ValueError("bands must be a flat list of edge pairs")
    if (np.diff(bands) <= 0).any() or bands[0] < 0 or bands[-1] > 0.5:
        raise ValueError("band edges must strictly ascend within [0, fs/2]")
    if len(desired) != len(bands) // 2:
        raise ValueError("need one desired value per band")
    if weight is None:
        weight = np.ones(len(desired))
    weight = np.asarray(weight, dtype=np.float64)
    if len(weight) != len(desired):
        raise ValueError("need one weight per band")
    if num_taps < 3:
        raise ValueError("num_taps must be >= 3")

    neg = ftype != "bandpass"
    nodd = bool(num_taps % 2)
    nfcns = num_taps // 2
    if nodd and not neg:
        nfcns += 1

    grid, des, wt, seg = _pm_grid(num_taps, bands, desired, weight, ftype,
                                  grid_density, nfcns, neg, nodd)
    des_t, wt_t = _pm_transform(grid, des, wt, neg, nodd)

    xn, cn, _, converged = _remez_exchange(grid, des_t, wt_t, seg, nfcns,
                                           maxiter)
    if not converged:
        warnings.warn(
            "remez: exchange did not reach a stable extremal set in "
            f"{maxiter} iterations; the design may not be optimal",
            RuntimeWarning, stacklevel=2)

    # Synthesis: a length-L FIR is exactly determined by >= L uniform DTFT
    # samples.  Evaluate H(f) = P(f) * q(f) * phase on an rFFT grid and
    # invert — no window, no approximation.
    nfft = 1 << max(int(math.ceil(math.log2(2 * num_taps))), 4)
    f = np.arange(nfft // 2 + 1) / nfft
    pf = _eval_bary(np.cos(2 * np.pi * f), xn, cn, _bary_weights(xn))
    if not neg:
        q = np.ones_like(f) if nodd else np.cos(np.pi * f)
    else:
        q = np.sin(2 * np.pi * f) if nodd else np.sin(np.pi * f)
    amp = pf * q
    phase = np.exp(-1j * np.pi * f * (num_taps - 1))
    if neg:
        # Antisymmetric taps: H = j A e^{-j pi f (N-1)} (type-III/IV
        # convention matching scipy's remez output sign).
        phase = phase * 1j
    h = np.fft.irfft(amp * phase, nfft)[:num_taps]
    return h


# ---------------------------------------------------------------------------
# Least-squares linear-phase design


def firls(num_taps: int, bands: Sequence[float], desired: Sequence[float],
          *, weight: Optional[Sequence[float]] = None,
          fs: float = 2.0) -> np.ndarray:
    """Least-squares linear-phase FIR (scipy.signal.firls semantics,
    type I: odd num_taps).

    ``bands`` is a flat list of edge pairs; ``desired`` gives the response
    at EACH edge (linear within a band); ``weight`` one value per band.
    Minimizes the weighted integrated squared error in closed form: the
    normal equations' Gram matrix is Toeplitz+Hankel of band sinc
    integrals.  Host float64; validated against scipy.signal.firls.
    """
    if num_taps % 2 == 0 or num_taps < 3:
        raise ValueError("firls needs odd num_taps >= 3 (type I)")
    bands = np.asarray(bands, dtype=np.float64) * (2.0 / fs)  # Nyquist = 1
    desired = np.asarray(desired, dtype=np.float64)
    if len(bands) % 2 or len(desired) != len(bands):
        raise ValueError("bands must be edge pairs with desired per edge")
    if (np.diff(bands) < 0).any() or bands[0] < 0 or bands[-1] > 1:
        raise ValueError("band edges must ascend within [0, fs/2]")
    nb = len(bands) // 2
    if weight is None:
        weight = np.ones(nb)
    weight = np.asarray(weight, dtype=np.float64)
    if len(weight) != nb:
        raise ValueError("need one weight per band")

    m = (num_taps - 1) // 2  # cosine-series order
    k = np.arange(m + 1, dtype=np.float64)

    def int_cos(n, f1, f2):
        """∫ cos(pi n f) df over [f1, f2] (Nyquist-normalized f)."""
        n = np.asarray(n, dtype=np.float64)
        out = np.where(n == 0, f2 - f1, 0.0)
        nz = n != 0
        ns = np.where(nz, n, 1.0)
        out = np.where(
            nz,
            (np.sin(np.pi * ns * f2) - np.sin(np.pi * ns * f1)) / (np.pi * ns),
            out)
        return out

    def int_fcos(n, f1, f2):
        """∫ f cos(pi n f) df over [f1, f2]."""
        n = np.asarray(n, dtype=np.float64)
        out = np.where(n == 0, 0.5 * (f2 * f2 - f1 * f1), 0.0)
        nz = n != 0
        ns = np.where(nz, n, 1.0) * np.pi
        val = ((np.cos(ns * f2) - np.cos(ns * f1)) / ns ** 2
               + (f2 * np.sin(ns * f2) - f1 * np.sin(ns * f1)) / ns)
        return np.where(nz, val, out)

    # Gram matrix Q[i,j] = sum_b w ∫ cos(pi i f) cos(pi j f) df
    #                    = 0.5 * (T[|i-j|] + H[i+j]).
    tvec = np.zeros(m + 1)
    hvec = np.zeros(2 * m + 1)
    bvec = np.zeros(m + 1)
    for b in range(nb):
        f1, f2 = bands[2 * b], bands[2 * b + 1]
        w = weight[b]
        tvec += w * int_cos(np.arange(m + 1), f1, f2)
        hvec += w * int_cos(np.arange(2 * m + 1), f1, f2)
        # Desired is linear over the band: D(f) = c0 + c1 f.
        d1, d2 = desired[2 * b], desired[2 * b + 1]
        if f2 > f1:
            c1 = (d2 - d1) / (f2 - f1)
            c0 = d1 - c1 * f1
        else:
            c0, c1 = d1, 0.0
        bvec += w * (c0 * int_cos(k, f1, f2) + c1 * int_fcos(k, f1, f2))

    i = np.arange(m + 1)
    q = 0.5 * (tvec[np.abs(i[:, None] - i[None, :])]
               + hvec[i[:, None] + i[None, :]])
    a = np.linalg.solve(q, bvec)

    # Cosine series -> symmetric taps: h[m] = a0, h[m±k] = a_k / 2.
    h = np.zeros(num_taps)
    h[m] = a[0]
    h[m + 1:] = a[1:] / 2.0
    h[:m] = h[m + 1:][::-1]
    return h


# ---------------------------------------------------------------------------
# Minimum-phase conversion


def minimum_phase(h: np.ndarray, *, n_fft: Optional[int] = None
                  ) -> np.ndarray:
    """Homomorphic minimum-phase conversion of a linear-phase FIR
    (scipy.signal.minimum_phase 'homomorphic' method): returns
    ``(len(h)+1)//2`` taps whose magnitude response is the square root of
    the input's — the standard half-length minimum-phase equivalent.

    Real cepstrum route: log|H| -> fold the anticausal cepstrum onto the
    causal side -> exp.  Host float64.
    """
    h = np.asarray(h, dtype=np.float64)
    if h.ndim != 1 or len(h) < 2:
        raise ValueError("h must be a 1-D filter with >= 2 taps")
    n_half = len(h) // 2
    if n_fft is None:
        n_fft = 2 ** int(math.ceil(math.log2(2 * (len(h) - 1) / 0.01)))
    if n_fft < len(h):
        raise ValueError("n_fft must be at least len(h)")
    mag = np.abs(np.fft.fft(h, n_fft))
    # Floor tiny bins so log is finite (scipy's relative epsilon trick).
    tiny = mag[mag > 0].min() * 1e-7 if (mag > 0).any() else 1e-300
    lm = 0.5 * np.log(mag ** 2 + tiny ** 2)  # log|H| with a smooth floor
    cep = np.fft.ifft(lm).real
    # Fold: keep quefrency 0, double 1..n-1 of the causal side (sqrt of
    # magnitude comes from halving the log first).
    win = np.zeros(n_fft)
    win[0] = 1.0
    stop = n_fft // 2
    win[1:stop] = 2.0
    if n_fft % 2 == 0:
        win[stop] = 1.0
    else:
        win[stop] = 2.0
    cep *= 0.5 * win  # 0.5: sqrt of the magnitude response
    h_min = np.fft.ifft(np.exp(np.fft.fft(cep))).real
    n_out = n_half + len(h) % 2
    return h_min[:n_out]
