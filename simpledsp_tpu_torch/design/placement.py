"""Carried verbatim from ``simpledsp_tpu/design/placement.py``: NumPy and SciPy
only, so both packages give bit-identical gains.

Robust pole placement by state feedback (scipy.signal.place_poles
parity, host-side f64).

Given ``x' = A x + B u``, find K so that eig(A - B K) equals the
requested poles, choosing among the (MIMO-non-unique) solutions one with
a well-conditioned closed-loop eigenvector matrix X.  Two published
algorithms: Kautsky-Nichols-Van Dooren update method 0 (rank-1
projections, real poles only) and the Tits-Yang rank-2 schedule
(default; supports complex-conjugate pairs).  Both iterate on X to grow
``|det(X)|``, each eigenvector constrained to its pole's admissible
subspace ker(U1^T (A - p I)) — the same construction scipy implements;
results are validated by the achieved poles (the gain matrix itself is
not unique).
"""

from __future__ import annotations

import warnings

import numpy as np
from scipy.linalg import qr as _qr

__all__ = ["place_poles"]


class FullStateFeedback(dict):
    """Attribute-accessible result record (scipy Bunch semantics)."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None

    def __setattr__(self, name, value):
        self[name] = value


def _order_poles(poles: np.ndarray) -> np.ndarray:
    """Sorted reals first, then complex pairs (p, conj(p)) in
    lexicographic order; raises if a complex pole lacks its
    conjugate."""
    ordered = np.sort(poles[np.isreal(poles)])
    pairs = []
    for p in np.sort(poles[np.imag(poles) < 0]):
        if np.conj(p) in poles:
            pairs.extend((p, np.conj(p)))
    ordered = np.hstack((ordered, pairs))
    if poles.shape[0] != len(ordered):
        raise ValueError("Complex poles must come with their conjugates")
    return ordered


def _knv0_step(ker_pole, X, j):
    """Rank-1 KNV update of column j: project the direction orthogonal
    to every OTHER column onto pole j's admissible subspace."""
    q, _ = _qr(np.delete(X, j, axis=1), mode="full")
    yj = ker_pole[j] @ (ker_pole[j].T @ q[:, -1])
    if not np.allclose(yj, 0):
        X[:, j] = yj / np.linalg.norm(yj)


def _yt_real(ker_pole, q, X, i, j):
    """Tits-Yang rank-2 update for a real pole pair (sec. 6.1)."""
    u = q[:, -2, np.newaxis]
    v = q[:, -1, np.newaxis]
    m = ker_pole[i].T @ (u @ v.T - v @ u.T) @ ker_pole[j]
    um, sm, vm = np.linalg.svd(m)
    mu1, mu2 = um.T[:2, :, np.newaxis]
    nu1, nu2 = vm[:2, :, np.newaxis]
    xij = np.vstack((X[:, i, np.newaxis], X[:, j, np.newaxis]))
    if not np.allclose(sm[0], sm[1]):
        basis = np.vstack((ker_pole[i] @ mu1, ker_pole[j] @ nu1))
    else:
        kp = np.vstack((
            np.hstack((ker_pole[i], np.zeros(ker_pole[i].shape))),
            np.hstack((np.zeros(ker_pole[j].shape), ker_pole[j]))))
        basis = kp @ np.vstack((np.hstack((mu1, mu2)),
                                np.hstack((nu1, nu2))))
    new = basis @ (basis.T @ xij)
    n_i = X.shape[0]
    if not np.allclose(new, 0):
        new = np.sqrt(2) * new / np.linalg.norm(new)
        X[:, i] = new[:n_i, 0]
        X[:, j] = new[n_i:, 0]
    else:
        # xij orthogonal to the basis span: restart from the basis
        # itself (the KNV fallback idea).
        X[:, i] = basis[:n_i, 0]
        X[:, j] = basis[n_i:, 0]


def _yt_complex(ker_pole, q, X, i, j):
    """Tits-Yang rank-2 update for a conjugate pair (sec. 6.2);
    columns i/j hold Re/Im of the complex eigenvector."""
    u = np.sqrt(2) * (q[:, -2, np.newaxis] + 1j * q[:, -1, np.newaxis])
    kp = ker_pole[i]
    m = np.conj(kp.T) @ (u @ np.conj(u).T - np.conj(u) @ u.T) @ kp
    e_val, e_vec = np.linalg.eig(m)
    order = np.argsort(np.abs(e_val))
    mu1 = e_vec[:, order[-1], np.newaxis]
    mu2 = e_vec[:, order[-2], np.newaxis]
    xc = X[:, i, np.newaxis] + 1j * X[:, j, np.newaxis]
    if not np.allclose(np.abs(e_val[order[-1]]), np.abs(e_val[order[-2]])):
        basis = kp @ mu1
    else:
        basis = kp @ np.hstack((mu1, mu2))
    new = basis @ (np.conj(basis.T) @ xc)
    if not np.allclose(new, 0):
        new = new / np.linalg.norm(new)
        X[:, i] = np.real(new[:, 0])
        X[:, j] = np.imag(new[:, 0])
    else:
        X[:, i] = np.real(basis[:, 0])
        X[:, j] = np.imag(basis[:, 0])


def _yt_update_order(poles: np.ndarray) -> np.ndarray:
    """The Tits-Yang sweep schedule (IEEE edition p. 1442) over 1-based
    pole indices, returned 0-based as (n_steps, 2)."""
    nb_real = int(poles[np.isreal(poles)].shape[0])
    hnb = nb_real // 2
    first: list = []
    second: list = []

    def add(a, b):
        first.extend(np.atleast_1d(a).tolist())
        second.extend(np.atleast_1d(b).tolist())

    if nb_real > 0:
        add(nb_real, 1)                     # biggest real with smallest
    r_comp = np.arange(nb_real + 1, len(poles) + 1, 2)
    r_p = np.arange(1, hnb + nb_real % 2)
    add(2 * r_p, 2 * r_p + 1)               # 1.a
    add(r_comp, r_comp + 1)                 # 1.b
    r_p = np.arange(1, hnb + 1)
    add(2 * r_p - 1, 2 * r_p)               # 1.c
    if hnb == 0 and np.isreal(poles[0]):
        add(1, 1)                           # 1.d (single real pole)
    add(r_comp, r_comp + 1)
    for j in np.arange(2, hnb + nb_real % 2):   # 2.a
        for i in range(1, hnb + 1):
            add(i, i + j)
    if hnb == 0 and np.isreal(poles[0]):
        add(1, 1)                           # 2.b
    add(r_comp, r_comp + 1)
    for j in np.arange(2, hnb + nb_real % 2):   # 2.c
        for i in range(hnb + 1, nb_real + 1):
            idx = i + j if i + j <= nb_real else i + j - nb_real
            add(i, idx)
    if hnb == 0 and np.isreal(poles[0]):
        add(1, 1)                           # 2.d
    add(r_comp, r_comp + 1)
    for i in range(1, hnb + 1):             # 3.a
        add(i, i + hnb)
    if hnb == 0 and np.isreal(poles[0]):
        add(1, 1)                           # 3.b
    add(r_comp, r_comp + 1)
    return np.array([first, second]).T - 1


def _optimize(ker_pole, X, poles, maxiter, rtol, knv_only):
    """Sweep the update schedule until |det(X)| stabilizes (YT p. 21
    convergence test)."""
    order = (np.array([[j, j] for j in range(X.shape[1])])
             if knv_only else _yt_update_order(poles))
    floor = np.sqrt(np.spacing(1.0))
    stop = False
    nb_iter = 0
    cur_rtol = 0.0
    while nb_iter < maxiter and not stop:
        det_prev = np.abs(np.linalg.det(X))
        for i, j in order:
            if i == j:
                _knv0_step(ker_pole, X, i)
            else:
                q, _ = _qr(np.delete(X, (i, j), axis=1), mode="full")
                if np.isreal(poles[i]):
                    _yt_real(ker_pole, q, X, i, j)
                else:
                    _yt_complex(ker_pole, q, X, i, j)
        det_cur = max(floor, np.abs(np.linalg.det(X)))
        cur_rtol = np.abs((det_cur - det_prev) / det_cur)
        if cur_rtol < rtol and det_cur > floor:
            stop = True
        nb_iter += 1
    return stop, cur_rtol, nb_iter


def place_poles(A, B, poles, method: str = "YT", rtol: float = 1e-3,
                maxiter: int = 30) -> FullStateFeedback:
    """Closed-loop pole placement (scipy.signal.place_poles semantics):
    returns a record with gain_matrix K (eig(A - B K) ~= poles),
    computed_poles, requested_poles, the eigenvector matrix X, and the
    achieved rtol / iteration count."""
    A = np.asarray(A, dtype=np.float64)
    B = np.asarray(B, dtype=np.float64)
    poles = np.asarray(poles)
    if poles.ndim > 1:
        raise ValueError("Poles must be a 1D array like.")
    poles = _order_poles(poles)
    if A.ndim != 2 or A.shape[0] != A.shape[1]:
        raise ValueError("A must be a square 2D array")
    if B.ndim != 2:
        raise ValueError("B must be a 2D array")
    n = A.shape[0]
    if len(poles) != n:
        raise ValueError(f"number of poles is {len(poles)} but you "
                         f"should provide {n}")
    rank_b = np.linalg.matrix_rank(B)
    for p in poles:
        if np.sum(p == poles) > rank_b:
            raise ValueError("at least one of the requested pole is "
                             "repeated more than rank(B) times")
    if method not in ("KNV0", "YT"):
        raise ValueError("The method keyword must be one of 'YT' or "
                         "'KNV0'")
    if method == "KNV0" and not all(np.isreal(poles)):
        raise ValueError("Complex poles are not supported by KNV0")
    if maxiter < 1:
        raise ValueError("maxiter must be at least equal to 1")
    if rtol > 1:
        raise ValueError("rtol can not be greater than 1")

    u, z = _qr(B, mode="full")
    u0, u1 = u[:, :rank_b], u[:, rank_b:]
    z = z[:rank_b, :]
    cur_rtol: float = 0.0
    nb_iter: float = 0

    if B.shape[0] == rank_b:
        # B full row rank: X = I works; solve B K = diag-form - A by
        # least squares, with conjugate pairs in the real 2x2 block form.
        diag_poles = np.zeros(A.shape)
        idx = 0
        while idx < n:
            p = poles[idx]
            diag_poles[idx, idx] = np.real(p)
            if not np.isreal(p):
                diag_poles[idx, idx + 1] = -np.imag(p)
                diag_poles[idx + 1, idx + 1] = np.real(p)
                diag_poles[idx + 1, idx] = np.imag(p)
                idx += 1
            idx += 1
        gain = np.linalg.lstsq(B, diag_poles - A, rcond=-1)[0]
        X = np.eye(n).astype(complex)
        cur_rtol = np.nan
        nb_iter = np.nan
    else:
        # Admissible subspace + starting vector per pole (conjugates
        # share their pair's subspace; columns hold Re / Im).
        ker_pole = []
        cols = []
        skip = False
        for j in range(n):
            if skip:
                skip = False
                continue
            space = (u1.T @ (A - poles[j] * np.eye(n))).T
            q, _ = _qr(space, mode="full")
            ker_j = q[:, space.shape[1]:]
            # Sum of the basis vectors: immune to zero rows / real-only
            # columns that stall convergence (the choice scipy settled
            # on, for the same reasons).
            xj = np.sum(ker_j, axis=1)[:, np.newaxis]
            xj = xj / np.linalg.norm(xj)
            if not np.isreal(poles[j]):
                cols.extend([np.real(xj), np.imag(xj)])
                ker_pole.extend([ker_j, ker_j])
                skip = True
            else:
                cols.append(xj)
                ker_pole.append(ker_j)
        X = np.hstack(cols)
        if rank_b > 1:
            stop, cur_rtol, nb_iter = _optimize(
                ker_pole, X, poles, maxiter, rtol, method == "KNV0")
            if not stop and rtol > 0:
                warnings.warn(
                    "Convergence was not reached after maxiter "
                    f"iterations.\nYou asked for a tolerance of {rtol}, "
                    f"we got {cur_rtol}.", stacklevel=2)
        # Re/Im columns -> the complex conjugate eigenvector pair.
        X = X.astype(complex)
        idx = 0
        while idx < n - 1:
            if not np.isreal(poles[idx]):
                re = X[:, idx].copy()
                im = X[:, idx + 1]
                X[:, idx] = re - 1j * im
                X[:, idx + 1] = re + 1j * im
                idx += 1
            idx += 1
        try:
            m = np.linalg.solve(X.T, np.diag(poles) @ X.T).T
            gain = np.linalg.solve(z, u0.T @ (m - A))
        except np.linalg.LinAlgError as e:
            raise ValueError(
                "The poles you've chosen can't be placed. Check the "
                "controllability matrix and try another set of poles"
            ) from e

    gain = np.real(-gain)   # solved A + B K; the convention is A - B K
    result = FullStateFeedback()
    result.gain_matrix = gain
    result.computed_poles = _order_poles(
        np.linalg.eig(A - B @ gain)[0])
    result.requested_poles = poles
    result.X = X
    result.rtol = cur_rtol
    result.nb_iter = nb_iter
    return result
