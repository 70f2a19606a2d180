"""Carried verbatim from ``simpledsp_tpu/design/systems.py``: NumPy only, over
the port's ``design/ltisys``.

LTI system classes (scipy.signal lti/dlti API facade, host-side f64).

A thin object layer over the framework's functional core (design/ltisys):
the classes hold one representation (tf / zpk / ss), convert through the
module's own conversion family, and delegate every simulation/response
method to the functional implementations — nothing here re-derives math.

``lti(*sys)`` / ``dlti(*sys, dt=...)`` dispatch on argument count
(2 -> TransferFunction, 3 -> ZerosPolesGain, 4 -> StateSpace), like
scipy; ``dt`` distinguishes discrete systems (None = continuous, True =
unspecified sampling interval), and the response methods
(impulse/step/output/bode/freqresp) dispatch on it, so one class set
covers both domains (scipy splits them into *Continuous/*Discrete
subclasses; the construction and method surface here is the same).
"""

from __future__ import annotations

import numpy as np

from simpledsp_tpu_torch.design import ltisys as _lt

__all__ = ["lti", "dlti", "TransferFunction", "ZerosPolesGain",
           "StateSpace"]


def lti(*system):
    """Continuous-time system from (num, den), (z, p, k) or
    (A, B, C, D) (scipy.signal.lti dispatch semantics)."""
    return _make(system, dt=None)


def dlti(*system, dt=True):
    """Discrete-time system (scipy.signal.dlti dispatch semantics);
    ``dt`` defaults to True (unspecified sampling interval)."""
    if dt is None:
        raise ValueError("dlti requires dt (True for unspecified)")
    return _make(system, dt=dt)


def _make(system, dt):
    try:
        cls = {2: TransferFunction, 3: ZerosPolesGain,
               4: StateSpace}[len(system)]
    except KeyError:
        raise ValueError(
            f"need 2 (tf), 3 (zpk) or 4 (ss) arguments, got "
            f"{len(system)}") from None
    return cls(*system, dt=dt)


class _LTIBase:
    """Representation storage + conversions + dt-dispatching responses."""

    _dt = None

    @property
    def dt(self):
        return self._dt

    def _tf(self):
        """(num, den) of this system."""
        raise NotImplementedError

    def _d3(self):
        num, den = self._tf()
        return num, den, 1.0 if self._dt is True else float(self._dt)

    # -- conversions (always a NEW object of the target class) ----------
    def to_tf(self) -> "TransferFunction":
        num, den = self._tf()
        return TransferFunction(num, den, dt=self._dt)

    def to_zpk(self) -> "ZerosPolesGain":
        z, p, k = _lt.tf2zpk(*self._tf())
        return ZerosPolesGain(z, p, k, dt=self._dt)

    def to_ss(self) -> "StateSpace":
        return StateSpace(*_lt.tf2ss(*self._tf()), dt=self._dt)

    def to_discrete(self, dt: float, method: str = "zoh"):
        """Discretized system in the SAME representation
        (scipy.signal's .to_discrete, via the framework's
        cont2discrete)."""
        if self._dt is not None:
            raise ValueError("system is already discrete")
        bd, ad, _ = _lt.cont2discrete(self._tf(), float(dt), method)
        tf = TransferFunction(bd, ad, dt=float(dt))
        if isinstance(self, ZerosPolesGain):
            return tf.to_zpk()
        if isinstance(self, StateSpace):
            return tf.to_ss()
        return tf

    @property
    def zeros(self):
        return self.to_zpk().z

    @property
    def poles(self):
        return self.to_zpk().p

    # -- responses, dispatching on dt -----------------------------------
    def impulse(self, X0=None, T=None, N=None):
        """(t, y) impulse response — scipy lti.impulse / dlti.impulse
        semantics per domain (discrete returns (t, (y,)))."""
        if self._dt is not None:
            if X0 is not None or T is not None:
                raise NotImplementedError(
                    "x0/t unsupported on the discrete path; use dlsim")
            return _lt.dimpulse(self._d3(), n=100 if N is None else int(N))
        t, y = _lt.impulse(self._tf(), n=100 if N is None else int(N),
                           t=T)
        if X0 is not None:
            y = y + self._zero_input(np.asarray(t, np.float64), X0)
        return t, y

    def step(self, X0=None, T=None, N=None):
        """(t, y) step response per domain."""
        if self._dt is not None:
            if X0 is not None or T is not None:
                raise NotImplementedError(
                    "x0/t unsupported on the discrete path; use dlsim")
            return _lt.dstep(self._d3(), n=100 if N is None else int(N))
        t, y = _lt.step(self._tf(), n=100 if N is None else int(N), t=T)
        if X0 is not None:
            y = y + self._zero_input(np.asarray(t, np.float64), X0)
        return t, y

    def output(self, U, T=None, X0=None):
        """Forced response: continuous (t, y, x) via lsim, discrete
        (t, y) via dlsim."""
        if self._dt is not None:
            return _lt.dlsim(self._d3(), U, t=T, x0=X0)
        if T is None:
            raise ValueError("continuous output() requires T")
        t, y, x = _lt.lsim(self._tf(), U, T)
        if X0 is not None:
            y = y + self._zero_input(np.asarray(t, np.float64), X0)
        return t, y, x

    def _zero_input(self, t, x0):
        """Zero-input response C expm(A t) x0 added on top of the
        zero-state simulation (scipy folds X0 into its ss solver; the
        state coordinates are the same controllable-canonical tf2ss)."""
        from scipy.linalg import expm
        A, _, C, _ = _lt.tf2ss(*self._tf())
        x0 = np.asarray(x0, np.float64).reshape(-1)
        if x0.size != A.shape[0]:
            raise ValueError(f"X0 must have {A.shape[0]} entries")
        step_ = expm(A * (t[1] - t[0]))
        y = np.empty(t.size)
        x = x0.copy()
        for i in range(t.size):
            y[i] = C[0] @ x
            x = step_ @ x
        return y

    def freqresp(self, w=None, n: int = 10000):
        """Continuous: H(jw), w in rad/s.  Discrete: scipy's dfreqresp
        convention — w in rad/SAMPLE, returned unchanged (the
        functional-layer dfreqresp takes rad/s, hence the /dt)."""
        if self._dt is not None:
            dt = self._d3()[2]
            if w is None:
                w = np.linspace(0, np.pi, int(n), endpoint=False)
            w = np.asarray(w, np.float64)
            _, h = _lt.dfreqresp(self._d3(), w / dt)
            return w, h
        if w is None:
            w = _default_w(self, int(n))
        return _lt.freqresp(self._tf(), w)

    def bode(self, w=None, n: int = 100):
        """Continuous: (w, mag dB, phase deg).  Discrete: scipy's dbode
        convention — w IN is rad/sample, w OUT is rad/s (= w/dt)."""
        if self._dt is not None:
            dt = self._d3()[2]
            if w is None:
                w = np.linspace(0, np.pi, int(n), endpoint=False)
            return _lt.dbode(self._d3(), np.asarray(w, np.float64) / dt)
        if w is None:
            w = _default_w(self, int(n))
        return _lt.bode(self._tf(), w)

    def __repr__(self):
        return f"{type(self).__name__}({self._desc()}, dt={self._dt})"


def _default_w(sys_, n: int) -> np.ndarray:
    """scipy's _default_response_frequencies: one decade either side of
    the nonzero poles' real-part magnitudes."""
    A, _, _, _ = _lt.tf2ss(*sys_._tf())
    vals = np.linalg.eigvals(A) if A.shape[0] else np.array([])
    poles = vals[vals != 0]
    if poles.size == 0:
        lo = hi = 1.0
    else:
        mags = np.abs(np.real(poles))
        lo, hi = mags.min(), mags.max()
    return np.logspace(np.log10(lo) - 1, np.log10(hi) + 1, n)


class TransferFunction(_LTIBase):
    """Polynomial (num, den) representation (descending powers);
    ``TransferFunction(other)`` converts another system."""

    def __init__(self, *system, dt=None):
        if len(system) == 1 and isinstance(system[0], _LTIBase):
            other = system[0].to_tf()
            system, dt = (other.num, other.den), other.dt
        if len(system) != 2:
            raise ValueError("TransferFunction needs (num, den)")
        self.num, self.den = _lt.normalize(*system)
        self._dt = dt

    def _tf(self):
        return self.num, self.den

    def _desc(self):
        return f"num={self.num}, den={self.den}"


class ZerosPolesGain(_LTIBase):
    """(zeros, poles, gain) representation."""

    def __init__(self, *system, dt=None):
        if len(system) == 1 and isinstance(system[0], _LTIBase):
            other = system[0].to_zpk()
            system, dt = (other.z, other.p, other.k), other.dt
        if len(system) != 3:
            raise ValueError("ZerosPolesGain needs (z, p, k)")
        z, p, k = system
        self.z = np.atleast_1d(np.asarray(z))
        self.p = np.atleast_1d(np.asarray(p))
        self.k = k if isinstance(k, complex) else float(k)
        self._dt = dt

    @property
    def zeros(self):
        return self.z

    @property
    def poles(self):
        return self.p

    @property
    def gain(self):
        return self.k

    def _tf(self):
        return _lt.zpk2tf(self.z, self.p, self.k)

    def _desc(self):
        return f"z={self.z}, p={self.p}, k={self.k}"


class StateSpace(_LTIBase):
    """(A, B, C, D) state-space representation (single input/output)."""

    def __init__(self, *system, dt=None):
        if len(system) == 1 and isinstance(system[0], _LTIBase):
            other = system[0].to_ss()
            system, dt = (other.A, other.B, other.C, other.D), other.dt
        if len(system) != 4:
            raise ValueError("StateSpace needs (A, B, C, D)")
        self.A, self.B, self.C, self.D = (
            np.atleast_2d(np.asarray(m, dtype=np.float64)) for m in system)
        self._dt = dt

    def _tf(self):
        num, den = _lt.ss2tf(self.A, self.B, self.C, self.D)
        return np.atleast_1d(np.squeeze(num)), den

    def _desc(self):
        return f"A={self.A.shape}, B={self.B.shape}"
