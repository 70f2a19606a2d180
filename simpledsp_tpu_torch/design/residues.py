"""Carried verbatim from ``simpledsp_tpu/design/residues.py``: NumPy only, so
both packages give bit-identical results.

Partial-fraction expansion (scipy.signal residue family, host f64).

residue/invres work on s-domain ratios b(s)/a(s) (ascending powers of
1/(s-p)); residuez/invresz on z^-1-domain ratios (powers of
1/(1 - p z^-1)) — the analysis form behind IIR parallel-form
realizations.  Pure NumPy polynomial algebra; repeated poles use the
Taylor-coefficient (generalized Leibniz) formula rather than symbolic
differentiation.  Validated against scipy.signal in
tests/test_residues.py.
"""

from __future__ import annotations

from math import comb, factorial
from typing import Tuple

import numpy as np

__all__ = ["unique_roots", "residue", "residuez", "invres", "invresz"]


def unique_roots(p, tol: float = 1e-3, rtype: str = "min"
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Cluster near-identical roots (scipy.signal.unique_roots
    semantics): roots within ``tol`` of a cluster's representative merge
    into it; the representative is the cluster 'min'/'max'/'avg' per
    ``rtype``.  Returns (unique_roots, multiplicities)."""
    if rtype not in ("min", "max", "avg", "mean", "maximum", "minimum"):
        raise ValueError(f"unknown rtype {rtype!r}")
    p = np.atleast_1d(np.asarray(p))
    groups = []          # list of lists
    for root in p:
        for g in groups:
            if abs(root - g[0]) < tol:
                g.append(root)
                break
        else:
            groups.append([root])
    reps = []
    for g in groups:
        arr = np.asarray(g)
        if rtype in ("min", "minimum"):
            reps.append(arr[np.argmin(np.abs(arr))] if np.iscomplexobj(arr)
                        else arr.min())
        elif rtype in ("max", "maximum"):
            reps.append(arr[np.argmax(np.abs(arr))] if np.iscomplexobj(arr)
                        else arr.max())
        else:
            reps.append(arr.mean())
    return (np.asarray(reps),
            np.asarray([len(g) for g in groups], dtype=np.intp))


def _poly_derivs_at(c: np.ndarray, x0: complex, n: int) -> np.ndarray:
    """[f(x0), f'(x0), ..., f^(n)(x0)] of the polynomial with descending
    coefficients c."""
    out = np.empty(n + 1, dtype=np.complex128)
    d = np.asarray(c, dtype=np.complex128)
    for k in range(n + 1):
        out[k] = np.polyval(d, x0)
        d = np.polyder(d)
    return out


def _residues_at(b: np.ndarray, a: np.ndarray, pole: complex,
                 mult: int) -> np.ndarray:
    """Residues r_1..r_mult of b/a at a pole of multiplicity ``mult``
    (r_l is the coefficient of 1/(s - pole)^l): with
    q(s) = a(s)/(s-pole)^mult and f(s) = b(s)/q(s), the residues are
    f's Taylor coefficients, computed by the generalized Leibniz
    recursion on f q = b (no symbolic differentiation)."""
    q = np.asarray(a, dtype=np.complex128)
    for _ in range(mult):
        q, rem = np.polydiv(q, np.asarray([1.0, -pole]))
    bd = _poly_derivs_at(np.asarray(b, np.complex128), pole, mult - 1)
    qd = _poly_derivs_at(q, pole, mult - 1)
    f = np.empty(mult, dtype=np.complex128)
    for n in range(mult):
        acc = bd[n]
        for k in range(n):
            acc -= comb(n, k) * f[k] * factorial(k) * qd[n - k]
        f[n] = acc / (factorial(n) * qd[0])
    # Taylor coeff t_j of f -> residue of order mult - j.
    return f[::-1]


def residue(b, a, tol: float = 1e-3, rtype: str = "avg"
            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Partial-fraction expansion of b(s)/a(s)
    (scipy.signal.residue semantics): returns (r, p, k) with
    b/a = k(s) + sum r_i / (s - p_i)^{power}, repeated poles listed with
    ascending powers."""
    b = np.atleast_1d(np.asarray(b, dtype=np.float64))
    a = np.atleast_1d(np.asarray(a, dtype=np.float64))
    if a.size == 0 or np.all(a == 0):
        raise ValueError("denominator must be nonzero")
    b = b / a[0]
    a = a / a[0]
    if b.size >= a.size:
        k, b = np.polydiv(b, a)
    else:
        k = np.zeros(0)
    poles, mults = unique_roots(np.roots(a), tol=tol, rtype=rtype)
    r = []
    pfull = []
    for pole, m in zip(poles, mults):
        res = _residues_at(b, a, pole, int(m))
        r.extend(res)           # powers 1..m ascending
        pfull.extend([pole] * int(m))
    return np.asarray(r), np.asarray(pfull), np.atleast_1d(k)


def residuez(b, a, tol: float = 1e-3, rtype: str = "avg"
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Partial-fraction expansion of b(z^-1)/a(z^-1)
    (scipy.signal.residuez semantics): b/a = k(z^-1) +
    sum r_i / (1 - p_i z^-1)^{power}.

    Reduction to :func:`residue`: substituting u = z^-1 gives factors
    (1 - p u) = -p (u - 1/p), so the u-domain residue at pole 1/p of
    order l maps to r = res_u * (-p)^l / ... — handled directly by
    evaluating the same Leibniz recursion against the u-polynomials with
    the (1 - p u)^l normalization."""
    b = np.atleast_1d(np.asarray(b, dtype=np.float64))
    a = np.atleast_1d(np.asarray(a, dtype=np.float64))
    if a.size == 0 or a[0] == 0:
        raise ValueError("a[0] must be nonzero")
    b = b / a[0]
    a = a / a[0]
    # Ascending-in-u polynomials (u = z^-1): b[0] + b[1] u + ... ->
    # descending form for np.poly* is the reverse.
    bu = b[::-1].copy()
    au = a[::-1].copy()
    # Polynomial part: in the z^-1 convention the direct part exists when
    # len(b) >= len(a); scipy peels it from the HIGH-order end of u.
    if b.size >= a.size:
        k, bu = np.polydiv(bu, au)
        k = k[::-1]
    else:
        k = np.zeros(0)
    # Poles of a(u) in u are u_i = 1/p_i.
    uroots, mults = unique_roots(np.roots(au), tol=tol, rtype=rtype)
    r = []
    pfull = []
    for u0, m in zip(uroots, mults):
        m = int(m)
        p0 = 1.0 / u0
        # a(u) = c * (u - u0)^m * q(u); want residues against
        # (1 - p0 u)^l = (-p0)^l (u - u0)^l.
        res_u = _residues_at(bu, au, u0, m)    # coeffs of 1/(u - u0)^l
        # (1 - p u)^l = (-p)^l (u - u0)^l, so c/(u-u0)^l = c (-p)^l
        # against the (1 - p u)^l basis.
        for ell in range(1, m + 1):
            r.append(res_u[ell - 1] * (-p0) ** ell)
        pfull.extend([p0] * m)
    return np.asarray(r), np.asarray(pfull), np.atleast_1d(k)


def invres(r, p, k, tol: float = 1e-3, rtype: str = "avg"
           ) -> Tuple[np.ndarray, np.ndarray]:
    """Inverse of :func:`residue`: rebuild (b, a) from (r, p, k)
    (scipy.signal.invres semantics; repeated poles grouped by ``tol``)."""
    r = np.atleast_1d(np.asarray(r))
    p = np.atleast_1d(np.asarray(p))
    k = np.atleast_1d(np.asarray(k))
    poles, mults = unique_roots(p, tol=tol, rtype=rtype)
    a = np.ones(1, dtype=np.complex128)
    for pole, m in zip(poles, mults):
        for _ in range(int(m)):
            a = np.polymul(a, [1.0, -pole])
    b = np.polymul(np.asarray(k, np.complex128), a) if k.size and \
        np.any(k != 0) else np.zeros(1, dtype=np.complex128)
    idx = 0
    for gi, (pole, m) in enumerate(zip(poles, mults)):
        m = int(m)
        # denominator without this pole group
        rest = np.ones(1, dtype=np.complex128)
        for gj, (pole2, m2) in enumerate(zip(poles, mults)):
            if gj == gi:
                continue
            for _ in range(int(m2)):
                rest = np.polymul(rest, [1.0, -pole2])
        for ell in range(1, m + 1):
            term = np.polymul(rest, np.atleast_1d(r[idx]))
            for _ in range(m - ell):
                term = np.polymul(term, [1.0, -pole])
            b = np.polyadd(b, term)
            idx += 1
    if np.allclose(b.imag, 0, atol=1e-10) and np.allclose(a.imag, 0,
                                                          atol=1e-10):
        b, a = b.real, a.real
    return np.atleast_1d(b), np.atleast_1d(a)


def invresz(r, p, k, tol: float = 1e-3, rtype: str = "avg"
            ) -> Tuple[np.ndarray, np.ndarray]:
    """Inverse of :func:`residuez`: rebuild (b, a) in the z^-1
    convention (scipy.signal.invresz semantics)."""
    r = np.atleast_1d(np.asarray(r))
    p = np.atleast_1d(np.asarray(p))
    k = np.atleast_1d(np.asarray(k))
    poles, mults = unique_roots(p, tol=tol, rtype=rtype)
    # Work in ascending powers of u = z^-1: factor (1 - p u) = [1, -p]
    # ASCENDING, i.e. numpy descending form [-p, 1].
    a_u = np.ones(1, dtype=np.complex128)
    for pole, m in zip(poles, mults):
        for _ in range(int(m)):
            a_u = np.polymul(a_u, [-pole, 1.0])
    b_u = np.zeros(1, dtype=np.complex128)
    if k.size and np.any(k != 0):
        b_u = np.polymul(k[::-1].astype(np.complex128), a_u)
    idx = 0
    for gi, (pole, m) in enumerate(zip(poles, mults)):
        m = int(m)
        rest = np.ones(1, dtype=np.complex128)
        for gj, (pole2, m2) in enumerate(zip(poles, mults)):
            if gj == gi:
                continue
            for _ in range(int(m2)):
                rest = np.polymul(rest, [-pole2, 1.0])
        for ell in range(1, m + 1):
            term = np.polymul(rest, np.atleast_1d(r[idx]))
            for _ in range(m - ell):
                term = np.polymul(term, [-pole, 1.0])
            b_u = np.polyadd(b_u, term)
            idx += 1
    b = b_u[::-1]
    a = a_u[::-1]
    if np.allclose(b.imag, 0, atol=1e-10) and np.allclose(a.imag, 0,
                                                          atol=1e-10):
        b, a = b.real, a.real
    return np.atleast_1d(b), np.atleast_1d(a)
