"""The port's host design layer against the JAX package: ``design/iir``,
``ltisys``, ``residues``, ``placement``, ``systems``, the seven names of
``design/biquad`` that came with them, and ``utils/intmath``.

These modules are NumPy and SciPy in both packages (the port carries the
files with their imports repointed), so every call gives the JAX
package's output bit for bit, and every refused input raises the same
exception type.  The exceptions are the two functions that run on the
port's ``ops/lfilter`` (``dlsim`` and its users ``dimpulse`` / ``dstep``
and the discrete systems' responses; ``freqresp``): they agree to 1e-12
relative to the largest output.  Each case takes its arguments from the
JAX package's tests (tests/test_iir_design.py, test_design.py,
test_placement.py, test_residues.py, test_systems.py); a few scipy checks
confirm the port's own calls.
"""

import enum
import importlib
import inspect
import warnings

import numpy as np
import pytest
import scipy.signal as sig
import torch

import simpledsp_tpu.design.biquad as jbq
import simpledsp_tpu.design.iir as jiir
import simpledsp_tpu.design.ltisys as jlt
import simpledsp_tpu.design.placement as jpl
import simpledsp_tpu.design.residues as jrz
import simpledsp_tpu.design.systems as jsy
import simpledsp_tpu.utils.intmath as jim
import simpledsp_tpu_torch.design.biquad as tbq
import simpledsp_tpu_torch.design.iir as tiir
import simpledsp_tpu_torch.design.ltisys as tlt
import simpledsp_tpu_torch.design.placement as tpl
import simpledsp_tpu_torch.design.residues as trz
import simpledsp_tpu_torch.design.systems as tsy
import simpledsp_tpu_torch.utils.intmath as tim

TOL = 1e-12
PAIRS = {"iir": (jiir, tiir), "lt": (jlt, tlt), "rz": (jrz, trz),
         "pl": (jpl, tpl), "sy": (jsy, tsy), "bq": (jbq, tbq),
         "im": (jim, tim)}


def _same(got, want, tol=None, path="out"):
    """``got`` equals ``want``: bit for bit, or to ``tol`` relative to
    the largest magnitude, through tuples, dicts and objects' fields."""
    if isinstance(want, torch.Tensor) or isinstance(got, torch.Tensor):
        raise AssertionError(f"{path}: a tensor where NumPy was expected")
    if isinstance(want, enum.Enum):
        assert int(got) == int(want), path
    elif isinstance(want, (tuple, list)):
        assert isinstance(got, (tuple, list)) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, tol, f"{path}[{i}]")
    elif isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _same(got[k], want[k], tol, f"{path}.{k}")
    elif hasattr(want, "__dict__") and not isinstance(want, np.ndarray):
        assert type(got).__name__ == type(want).__name__, path
        _same(vars(got), vars(want), tol, path)
    elif tol is None:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                      err_msg=path)
        assert np.asarray(got).dtype == np.asarray(want).dtype, path
    else:
        w = np.asarray(want)
        scale = max(1.0, float(np.abs(w).max())) if w.size else 1.0
        np.testing.assert_allclose(np.asarray(got), w, rtol=0,
                                   atol=tol * scale, err_msg=path)


def _run(call, mod):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return call(mod)


# -- every public name ---------------------------------------------------------

NAME_MODULES = ["design.iir", "design.ltisys", "design.residues",
                "design.placement", "design.systems", "design.biquad",
                "utils.fixtures", "utils.intmath", "ops.lfilter",
                "models.audio", "models.comms"]
# Modules ported in earlier slices that this one completes: the names it adds.
ADDED_NAMES = {"ops.iir": ["sosfilt_zi", "sosfiltfilt", "_preload_from_values"],
               "ops.fir": ["upfirdn", "resample", "decimate", "resample_poly"],
               "ops.conv": ["deconvolve"]}


def _public(mod):
    return {n for n, v in vars(mod).items()
            if not n.startswith("_")
            and (inspect.isfunction(v) or inspect.isclass(v))
            and getattr(v, "__module__", None) == mod.__name__}


@pytest.mark.parametrize("name", NAME_MODULES)
def test_port_has_every_public_name(name):
    j = importlib.import_module(f"simpledsp_tpu.{name}")
    t = importlib.import_module(f"simpledsp_tpu_torch.{name}")
    assert _public(j) - set(dir(t)) == set()
    assert sorted(getattr(t, "__all__", [])) == sorted(getattr(j, "__all__",
                                                               []))


@pytest.mark.parametrize("name", sorted(ADDED_NAMES))
def test_port_has_the_added_names(name):
    j = importlib.import_module(f"simpledsp_tpu.{name}")
    t = importlib.import_module(f"simpledsp_tpu_torch.{name}")
    for n in ADDED_NAMES[name]:
        assert hasattr(j, n) and callable(getattr(t, n)), n
    assert set(j.__all__) <= set(t.__all__)


# -- outputs: the JAX package's bits -------------------------------------------

ORDERS = [1, 2, 3, 5, 8]
BANDS = [("lowpass", 0.3), ("highpass", 0.45),
         ("bandpass", (0.2, 0.5)), ("bandstop", (0.2, 0.5))]
ORDER_SPECS = [
    (0.2, 0.3, 1.0, 40.0),
    (0.1, 0.5, 3.0, 60.0),
    (0.3, 0.2, 0.5, 50.0),
    ([0.2, 0.5], [0.1, 0.6], 1.0, 40.0),
    ([0.1, 0.6], [0.2, 0.5], 1.0, 40.0),
]
A_DOC = np.array([[1.380, -0.2077, 6.715, -5.676],
                  [-0.5814, -4.290, 0, 0.6750],
                  [1.067, 4.273, -6.654, 5.893],
                  [0.0480, 4.273, 1.343, -2.104]])
B_DOC = np.array([[0, 5.679], [1.136, 1.136], [0, 0], [-3.146, 0]])
BC, AC = sig.butter(3, 8.0, analog=True)
T201 = np.linspace(0, 2, 201)
W60 = np.logspace(-1, 2, 60)
U100 = np.random.default_rng(5).standard_normal(100)
R5 = np.random.default_rng(3)
SS_A, SS_B = R5.standard_normal((4, 4)), R5.standard_normal((4, 1))
SS_C, SS_D = R5.standard_normal((1, 4)), R5.standard_normal((1, 1))
MIMO = np.random.default_rng(0)
MIMO_A, MIMO_B = MIMO.standard_normal((5, 5)), MIMO.standard_normal((5, 3))


def _designs():
    out = []
    for n in ORDERS:
        for btype, wn in BANDS:
            out.append((f"butter-{n}-{btype}",
                        lambda m, n=n, b=btype, w=wn: m.butter(
                            n, w, btype=b, output="sos")))
    for n in (2, 3, 7):
        for btype, wn in BANDS:
            out.append((f"cheby1-{n}-{btype}",
                        lambda m, n=n, b=btype, w=wn: m.cheby1(
                            n, 0.8, w, btype=b, output="sos")))
            out.append((f"cheby2-{n}-{btype}",
                        lambda m, n=n, b=btype, w=wn: m.cheby2(
                            n, 42.0, w, btype=b, output="sos")))
    for n in (1, 2, 3, 7, 8):
        for btype, wn in BANDS:
            out.append((f"ellip-{n}-{btype}",
                        lambda m, n=n, b=btype, w=wn: m.ellip(
                            n, 0.7, 45.0, w, btype=b, output="sos")))
    for norm in ("phase", "delay", "mag"):
        for n in (1, 2, 4, 7, 10):
            out.append((f"bessel-{n}-{norm}",
                        lambda m, n=n, nm=norm: m.bessel(
                            n, 0.3, norm=nm, output="sos")))
    for output in ("design", "zpk", "ba", "sos"):
        out.append((f"butter-output-{output}",
                    lambda m, o=output: m.butter(5, 0.3, output=o)))
        out.append((f"ellip-bandpass-fs-{output}",
                    lambda m, o=output: m.ellip(
                        6, 1.0, 60.0, (3000.0, 8000.0), btype="bandpass",
                        fs=48000.0, output=o)))
    out += [
        ("bessel-bandpass", lambda m: m.bessel(4, (0.2, 0.6),
                                               btype="bandpass",
                                               output="sos")),
        ("iirfilter-cheby2-design",
         lambda m: m.iirfilter(4, 0.3, rs=40.0, ftype="cheby2")),
        ("ellip-design", lambda m: m.ellip(7, 0.5, 55.0, 0.22)),
    ]
    for i, (wp, ws, gp, gs) in enumerate(ORDER_SPECS):
        for f in ("buttord", "cheb1ord", "cheb2ord", "ellipord"):
            out.append((f"{f}-{i}", lambda m, f=f, a=(wp, ws, gp, gs):
                        getattr(m, f)(*a)))
    out += [("buttord-fs", lambda m: m.buttord(3000.0, 5000.0, 1.0, 45.0,
                                               fs=48000.0))]
    for i, (wp, ws, gp, gs, ft) in enumerate([
            (0.2, 0.3, 1.0, 40.0, "ellip"),
            (0.3, 0.2, 1.0, 40.0, "cheby1"),
            ([0.2, 0.5], [0.1, 0.6], 2.0, 40.0, "butter"),
            ([0.1, 0.6], [0.2, 0.5], 1.0, 30.0, "cheby2")]):
        for output in ("sos", "design"):
            out.append((f"iirdesign-{i}-{output}",
                        lambda m, a=(wp, ws, gp, gs), f=ft, o=output:
                        m.iirdesign(*a, ftype=f, output=o)))
    for n, btype, wn in ((7, "lowpass", 0.3), (4, "bandstop", (0.25, 0.6))):
        out.append((f"zpk2sos-{btype}", lambda m, n=n, b=btype, w=wn:
                    m.zpk2sos(*m.ellip(n, 1.0, 50.0, w, btype=b,
                                       output="zpk"))))
        out.append((f"sos_to_design-{btype}", lambda m, n=n, b=btype, w=wn:
                    m.sos_to_design(m.ellip(n, 1.0, 50.0, w, btype=b,
                                            output="sos"))))
    out += [
        ("iirnotch", lambda m: m.iirnotch(1500.0, 30.0, fs=48000.0)),
        ("iirpeak", lambda m: m.iirpeak(0.5, 12.0)),
        ("iircomb-notch", lambda m: m.iircomb(1000.0, 30.0, fs=8000.0)),
        ("iircomb-peak", lambda m: m.iircomb(1000.0, 30.0, fs=8000.0,
                                             ftype="peak", pass_zero=True)),
        ("gammatone-fir", lambda m: m.gammatone(440.0, "fir", fs=16000.0)),
        ("gammatone-iir", lambda m: m.gammatone(1000.0, "iir",
                                                fs=44100.0)),
        ("gammatone-FIR-case", lambda m: m.gammatone(0.3, "FIR", fs=2.0)),
        ("gammatone-iir-order", lambda m: m.gammatone(440.0, "iir", order=8,
                                                      fs=16000.0)),
        ("buttap", lambda m: m.buttap(4)),
        ("cheb1ap", lambda m: m.cheb1ap(4, 1.0)),
        ("cheb2ap", lambda m: m.cheb2ap(4, 30.0)),
        ("ellipap", lambda m: m.ellipap(4, 1.0, 40.0)),
        ("besselap", lambda m: m.besselap(5)),
        ("besselap-mag", lambda m: m.besselap(6, norm="mag")),
        ("butter_ap", lambda m: m.butter_ap(7)),
        ("cheby1_ap", lambda m: m.cheby1_ap(5, 0.5)),
        ("cheby2_ap", lambda m: m.cheby2_ap(6, 50.0)),
        ("ellip_ap", lambda m: m.ellip_ap(5, 0.5, 50.0)),
        ("bessel_ap", lambda m: m.bessel_ap(8, norm="delay")),
        ("lp2lp_zpk", lambda m: m.lp2lp_zpk(*m.cheby1_ap(4, 1.0), 2.5)),
        ("lp2hp_zpk", lambda m: m.lp2hp_zpk(*m.cheby2_ap(4, 40.0), 2.5)),
        ("lp2bp_zpk", lambda m: m.lp2bp_zpk(*m.butter_ap(3), 2.0, 0.5)),
        ("lp2bs_zpk", lambda m: m.lp2bs_zpk(*m.ellip_ap(3, 1.0, 40.0),
                                            2.0, 0.5)),
        ("bilinear_zpk", lambda m: m.bilinear_zpk(*m.butter_ap(4), 2.0)),
    ]
    passb, stopb = np.array([0.8, 2.2]), np.array([1.0, 2.0])
    for wp, ind in ((0.9, 0), (2.1, 1), (0.85, 0)):
        for t in ("butter", "cheby", "ellip"):
            out.append((f"band_stop_obj-{wp}-{t}",
                        lambda m, a=(wp, ind, passb.copy(), stopb, 1.0,
                                     40.0, t): m.band_stop_obj(*a)))
    return out


def _biquad_and_intmath():
    return [
        ("bp_cutoff_freqs", lambda m: m.bp_cutoff_freqs(2000.0, 0.8,
                                                        39000.0)),
        ("design_bandstop", lambda m: m.design_bandstop(4, 6000.0, 39000.0,
                                                        3.0)),
        ("design_bandstop-gain", lambda m: m.design_bandstop(
            2, 200.0, 39000.0, 1.4, gain=2.0)),
        ("design_cheby1_lowpass", lambda m: m.design_cheby1_lowpass(
            4, 0.05, 0.1, 2.0)),
        ("design_cheby1_lowpass-fs", lambda m: m.design_cheby1_lowpass(
            3, 1.0, 3000.0, 48000.0, gain=0.5)),
        ("design_cheby2_lowpass", lambda m: m.design_cheby2_lowpass(
            3, 40.0, 0.3, 2.0)),
        ("ba_coefficients", lambda m: m.ba_coefficients(
            m.design_lowpass(3, 2000.0, 39000.0))),
        ("freq_response", lambda m: m.freq_response(
            m.design_bandpass(4, 6000.0, 39000.0, 3.0))),
        ("freq_response-freqs", lambda m: m.freq_response(
            m.design_lowpass(4, 2000.0, 39000.0),
            np.linspace(0, 19000.0, 77))),
        ("group_delay", lambda m: m.group_delay(
            m.design_lowpass(4, 2000.0, 39000.0), n=256)),
        ("group_delay-freqs", lambda m: m.group_delay(
            m.design_highpass(2, 5000.0, 39000.0), [100.0, 9000.0])),
        ("ilog2", lambda m: [m.ilog2(n) for n in (1, 2, 3, 1024, 1025)]),
        ("ilog4", lambda m: [m.ilog4(n) for n in (1, 4, 15, 16, 4096)]),
        ("is_power_of_2", lambda m: [m.is_power_of_2(n)
                                     for n in (0, 1, 2, 6, 4096)]),
        ("is_power_of_4", lambda m: [m.is_power_of_4(n)
                                     for n in (0, 1, 2, 16, 32, 4096)]),
        ("is_power_of", lambda m: [m.is_power_of(n, 3)
                                   for n in (0, 1, 27, 30)]),
    ]


def _ltisys():
    b, a = np.array([0.5, 1.2, -0.3]), np.array([2.0, 0.4, 0.9, 0.1])
    sos6 = sig.butter(6, 0.3, output="sos")
    cases = [
        ("tf2zpk", lambda m: m.tf2zpk(b, a)),
        ("tf2zpk-complex", lambda m: m.tf2zpk(np.array([1 + 0.5j]),
                                              np.array([1, 0.3 + 0.2j, 1]))),
        ("zpk2tf", lambda m: m.zpk2tf(*m.tf2zpk(b, a))),
        ("sos2tf", lambda m: m.sos2tf(sos6)),
        ("sos2zpk", lambda m: m.sos2zpk(sos6)),
        ("tf2sos", lambda m: m.tf2sos(*m.sos2tf(sos6))),
        ("zpk2sos", lambda m: m.zpk2sos(*sig.butter(5, 0.3, output="zpk"))),
        ("normalize", lambda m: m.normalize([0.0, 2.0, 4.0], [2.0, 1.0])),
        ("normalize-lead-zero", lambda m: m.normalize([1.0], [0.0, 1.0])),
        ("normalize-bad", lambda m: m.normalize([1e-16, 1.0], [1.0, 0.5])),
        ("sosfreqz", lambda m: m.sosfreqz(sos6, 256)),
        ("sosfreqz-fs", lambda m: m.sosfreqz(sos6, 64, fs=1000.0)),
        ("freqz_sos", lambda m: m.freqz_sos(sig.butter(4, 0.3,
                                                       output="sos"), 128)),
        ("bilinear", lambda m: m.bilinear(BC, AC, fs=100.0)),
        ("tf2ss", lambda m: m.tf2ss(b, a)),
        ("ss2tf", lambda m: m.ss2tf(*m.tf2ss(b, a))),
        ("ss2zpk", lambda m: m.ss2zpk(SS_A, SS_B, SS_C, SS_D)),
        ("zpk2ss", lambda m: m.zpk2ss(np.array([-1.0 + 1j, -1.0 - 1j]),
                                      np.array([-2.0, -3.0, -0.5]), 2.3)),
        ("findfreqs", lambda m: m.findfreqs(np.real(np.poly([-3.0, -30.0])),
                                            np.real(np.poly([-1.0, -2 + 1j,
                                                             -2 - 1j])),
                                            27)),
        ("findfreqs-zp", lambda m: m.findfreqs([-1 + 4j], [-2 + 1j, -5], 15,
                                               kind="zp")),
        ("lsim-foh", lambda m: m.lsim((BC, AC), np.sin(3 * T201), T201)),
        ("lsim-zoh", lambda m: m.lsim((BC, AC), np.sin(3 * T201), T201,
                                      interp=False)),
        ("impulse", lambda m: m.impulse((BC, AC), t=T201)),
        ("impulse-default", lambda m: m.impulse((BC, AC))),
        ("step", lambda m: m.step((BC, AC), t=T201)),
        ("step-n", lambda m: m.step((BC, AC), n=50)),
        ("bode", lambda m: m.bode((BC, AC), W60)),
        ("dbode", lambda m: m.dbode(m.cont2discrete((BC, AC), 0.01),
                                    W60[:30])),
        ("dfreqresp", lambda m: m.dfreqresp(m.cont2discrete((BC, AC), 0.01),
                                            np.linspace(0.1, 100.0, 40))),
        ("dfreqresp-delay", lambda m: m.dfreqresp(([1.0], [1.0, -0.5], 1.0),
                                                  np.linspace(0.1, 2, 20))),
    ]
    for kw in ({"A": [[1, 2], [3, 4]], "B": [[5], [6]], "D": [[7]]},
               {"B": [[1], [2]], "C": [[3, 4]]},
               {"A": [[1]], "C": [[2]], "D": [[3]]}):
        cases.append((f"abcd_normalize-{sorted(kw)}",
                      lambda m, kw=kw: m.abcd_normalize(**kw)))
    for method in ("bilinear", "tustin", "euler", "forward_diff",
                   "backward_diff", "zoh"):
        cases.append((f"cont2discrete-{method}",
                      lambda m, me=method: m.cont2discrete(
                          (BC, AC), 0.01, method=me)))
    tfs = [(np.array([1.0]), np.array([1.0, 1.4142, 1.0])),
           (np.array([2.0, 1.0]), np.array([1.0, 2.0, 3.0, 1.0])),
           (np.array([1.0, 0.5, 0.2, 0.1]), np.array([1.0, 2.0])),
           (np.array([1 + 0.5j]), np.array([1, 0.3 + 0.2j, 1]))]
    for i, (bb, aa) in enumerate(tfs):
        for wo in (1.0, 0.4, 3.7):
            cases.append((f"lp2lp-{i}-{wo}", lambda m, bb=bb, aa=aa, wo=wo:
                          m.lp2lp(bb, aa, wo)))
            cases.append((f"lp2hp-{i}-{wo}", lambda m, bb=bb, aa=aa, wo=wo:
                          m.lp2hp(bb, aa, wo)))
            for bw in (1.0, 0.3):
                cases.append((f"lp2bp-{i}-{wo}-{bw}",
                              lambda m, bb=bb, aa=aa, wo=wo, bw=bw:
                              m.lp2bp(bb, aa, wo, bw)))
                cases.append((f"lp2bs-{i}-{wo}-{bw}",
                              lambda m, bb=bb, aa=aa, wo=wo, bw=bw:
                              m.lp2bs(bb, aa, wo, bw)))
    for sos in (np.array([[0., 1., 0., 1., -.5, 0.]]),
                np.array([[0., 2., .3, 1., -.2, .05],
                          [1., .3, .2, 1., -.2, .05]]),
                np.array([[0., 0., 3., 1., -.4, .1]]),
                np.array([[2, 1, .5, 2, -.4, .1], [1, .3, .2, 1, -.2, .05]])):
        cases.append((f"sos2zpk-{sos.sum():.3f}",
                      lambda m, s=sos: m.sos2zpk(s)))
    return cases


def _ltisys_on_lfilter():
    """The calls that run on the port's ops/lfilter: 1e-12."""
    return [
        ("dlsim", lambda m: m.dlsim(m.cont2discrete((BC, AC), 0.01), U100)),
        ("dlsim-t", lambda m: m.dlsim(([1.0, 0.5], [1.0, -0.5], 0.1), U100,
                                      t=np.arange(100) * 0.1)),
        ("dlsim-delay", lambda m: m.dlsim(([1.0], [1.0, -0.5], 1.0),
                                          np.eye(1, 8)[0])),
        ("dimpulse", lambda m: m.dimpulse(m.cont2discrete((BC, AC), 0.01),
                                          n=50)),
        ("dstep", lambda m: m.dstep(m.cont2discrete((BC, AC), 0.01), n=50)),
        ("freqresp", lambda m: m.freqresp((BC, AC), W60)),
    ]


def _residues():
    a3 = np.poly([-1.0, -2.5, -4.0])
    rep = np.polymul(np.poly([-1.0, -1.0]), [1.0, 3.0])
    az = np.array([1.0, -0.2, -0.15])
    azr = np.polymul([1.0, -0.5], np.polymul([1.0, -0.5], [1.0, 0.3]))
    cases = [
        ("unique_roots", lambda m: m.unique_roots(
            np.array([1.0, 1.0002, 2.5, 2.5, -3.0]), tol=1e-3)),
        ("unique_roots-max", lambda m: m.unique_roots(
            np.array([1.0, 1.0002, 2.5, 2.5, -3.0]), rtype="max")),
        ("residue", lambda m: m.residue([1.0, 2.0, 3.0], a3)),
        ("residue-improper", lambda m: m.residue(
            np.polyadd(np.polymul([2.0, 1.0], a3), [1.0, 0.5, 0.2]), a3)),
        ("residue-repeated", lambda m: m.residue([1.0, 0.5, 2.0], rep)),
        ("invres", lambda m: m.invres(*m.residue([1.0, 0.5, 2.0], rep))),
        ("residuez-proper", lambda m: m.residuez([1.0, -0.5], az)),
        ("residuez-improper", lambda m: m.residuez([2.0, 1.0, 0.3, -0.1],
                                                   az)),
        ("residuez-repeated", lambda m: m.residuez([1.0, 0.2], azr)),
        ("invresz", lambda m: m.invresz(*m.residuez([2.0, 1.0, 0.3, -0.1],
                                                    az))),
        ("invresz-repeated", lambda m: m.invresz(*m.residuez([1.0, 0.2],
                                                             azr))),
    ]
    return cases


def _placement():
    poles = np.array([-0.2, -0.5, -5.0566, -8.6659])
    cases = [
        ("yt-real", lambda m: m.place_poles(A_DOC, B_DOC, poles)),
        ("knv0-real", lambda m: m.place_poles(A_DOC, B_DOC, poles,
                                              method="KNV0")),
        ("yt-complex", lambda m: m.place_poles(
            A_DOC, B_DOC, np.array([-0.2 + 0.5j, -0.2 - 0.5j, -5.0, -8.0]))),
        ("siso", lambda m: m.place_poles(np.array([[0, 1], [0, 0]], float),
                                         np.array([[0], [1]], float),
                                         [-2.0, -3.0])),
        ("square-B", lambda m: m.place_poles(np.diag([1.0, 2.0, 3.0]),
                                             np.eye(3), [-1.0 + 1j, -1.0 - 1j,
                                                         -3.0])),
        ("mimo-yt", lambda m: m.place_poles(MIMO_A, MIMO_B,
                                            [-0.7, -1.1, -2.0, -2.9, -3.5])),
        ("mimo-knv0", lambda m: m.place_poles(MIMO_A, MIMO_B,
                                              [-0.7, -1.1, -2.0, -2.9, -3.5],
                                              method="KNV0")),
        ("mimo-complex", lambda m: m.place_poles(
            MIMO_A, MIMO_B, np.array([-1.0 + 1j, -1.0 - 1j, -2.0 + 0.5j,
                                      -2.0 - 0.5j, -3.0]))),
    ]
    return cases


def _systems():
    w50 = np.logspace(-2, 2, 50)
    T = np.linspace(0, 5, 200)
    w40 = np.linspace(0.05, 3.0, 40)
    return [
        ("lti-tf", lambda m: m.lti([1.0, 2], [1, 2, 3])),
        ("lti-zpk", lambda m: m.lti([-1.0], [-2.0, -3.0], 4.0)),
        ("lti-ss", lambda m: m.lti(SS_A, SS_B, SS_C, SS_D)),
        ("to_zpk", lambda m: m.lti([1.0, 2], [1, 2, 3]).to_zpk()),
        ("to_ss", lambda m: m.lti([1.0, 2], [1, 2, 3]).to_ss()),
        ("to_tf", lambda m: m.lti([-1.0], [-2.0, -3.0], 4.0).to_tf()),
        ("ctor-tf-from-zpk", lambda m: m.TransferFunction(
            m.lti([1.0, 2], [1, 2, 3]).to_zpk())),
        ("ctor-zpk-from-tf", lambda m: m.ZerosPolesGain(
            m.lti([1.0, 2], [1, 2, 3]))),
        ("ctor-ss-from-tf", lambda m: m.StateSpace(
            m.lti([1.0, 2], [1, 2, 3]))),
        ("poles-zeros", lambda m: (m.lti([1.0, 2], [1, 2, 3]).poles,
                                   m.lti([1.0, 2], [1, 2, 3]).zeros)),
        ("impulse", lambda m: m.lti([1.0, 2], [1, 2, 3]).impulse(T=T)),
        ("step", lambda m: m.lti([1.0, 2], [1, 2, 3]).step(T=T)),
        ("output", lambda m: m.lti([1.0, 2], [1, 2, 3]).output(np.sin(T), T)),
        ("output-X0", lambda m: m.lti([1.0, 2], [1, 2, 3]).output(
            np.sin(T), T, X0=[0.5, -0.2])),
        ("bode", lambda m: m.lti([1.0, 2], [1, 2, 3]).bode(w=w50)),
        ("bode-n", lambda m: m.lti([1.0, 2], [1, 2, 3]).bode(n=30)),
        ("dlti", lambda m: m.dlti([1.0, 0.5], [1, -0.5], dt=0.1)),
        ("dfreqresp", lambda m: m.dlti([1.0, 0.5], [1, -0.5],
                                       dt=0.1).freqresp(w=w40)),
        ("dfreqresp-n", lambda m: m.dlti([1.0, 0.5], [1, -0.5],
                                         dt=0.1).freqresp(n=32)),
        ("dbode", lambda m: m.dlti([1.0, 0.5], [1, -0.5], dt=0.1).bode(w=w40)),
        ("to_discrete-zoh", lambda m: m.lti([1.0, 2], [1, 2, 3]).to_discrete(
            0.01)),
        ("to_discrete-bilinear", lambda m: m.lti([1.0, 2], [1, 2, 3])
         .to_discrete(0.01, method="bilinear")),
    ]


def _systems_on_lfilter():
    return [
        ("freqresp", lambda m: m.lti([1.0, 2], [1, 2, 3]).freqresp(
            w=np.logspace(-2, 2, 50))),
        ("dimpulse", lambda m: m.dlti([1.0, 0.5], [1, -0.5],
                                      dt=0.1).impulse(N=10)),
        ("dstep", lambda m: m.dlti([1.0, 0.5], [1, -0.5], dt=0.1).step(N=12)),
        ("doutput", lambda m: m.dlti([1.0, 0.5], [1, -0.5],
                                     dt=0.1).output(np.sin(np.arange(20)))),
    ]


CASES = ([("iir", i, c, None) for i, c in _designs()]
         + [("bq", i, c, None) for i, c in _biquad_and_intmath()
            if not i.startswith(("ilog", "is_power"))]
         + [("im", i, c, None) for i, c in _biquad_and_intmath()
            if i.startswith(("ilog", "is_power"))]
         + [("lt", i, c, None) for i, c in _ltisys()]
         + [("lt", i, c, TOL) for i, c in _ltisys_on_lfilter()]
         + [("rz", i, c, None) for i, c in _residues()]
         + [("pl", i, c, None) for i, c in _placement()]
         + [("sy", i, c, None) for i, c in _systems()]
         + [("sy", i, c, TOL) for i, c in _systems_on_lfilter()])


@pytest.mark.parametrize("pair,call,tol", [c[::2] + (c[3],) for c in CASES],
                         ids=[f"{c[0]}-{c[1]}" for c in CASES])
def test_output_equals_jax(pair, call, tol):
    j, t = PAIRS[pair]
    _same(_run(call, t), _run(call, j), tol)


# -- refusals: the same exception type ------------------------------------------

A2, B2 = [[0, 1], [0, 0]], [[0], [1]]
RAISES = [
    ("iir", lambda m: m.butter(0, 0.3)),
    ("iir", lambda m: m.butter(4, 1.2)),
    ("iir", lambda m: m.butter(4, (0.5, 0.2), btype="bandpass")),
    ("iir", lambda m: m.butter(4, (0.2, 0.5), btype="lowpass")),
    ("iir", lambda m: m.butter(4, 0.3, output="nope")),
    ("iir", lambda m: m.cheby1(4, None, 0.3)),
    ("iir", lambda m: m.cheby2(4, None, 0.3)),
    ("iir", lambda m: m.ellip(4, 1.0, None, 0.3)),
    ("iir", lambda m: m.iirfilter(4, 0.3, ftype="nonsense")),
    ("iir", lambda m: m.iirfilter(4, 0.3, btype="nonsense")),
    ("iir", lambda m: m.iirdesign(0.2, 0.3, 1.0, 40.0, ftype="gaussian")),
    ("iir", lambda m: m.gammatone(0.0, "fir", fs=2.0)),
    ("iir", lambda m: m.gammatone(0.3, "cheby", fs=2.0)),
    ("iir", lambda m: m.gammatone(0.3, "fir", order=30, fs=2.0)),
    ("iir", lambda m: m.iircomb(1000.0, 30.0, fs=8000.0, ftype="nope")),
    ("iir", lambda m: m.iircomb(3000.0, 30.0, fs=8000.0)),
    ("iir", lambda m: m.band_stop_obj(0.9, 0, np.array([0.8, 2.2]),
                                      np.array([1.0, 2.0]), 1.0, 40.0,
                                      "nope")),
    ("iir", lambda m: m.band_stop_obj(0.9, 0, np.array([0.8, 2.2]),
                                      np.array([1.0, 2.0]), 40.0, 1.0,
                                      "butter")),
    ("iir", lambda m: m.bessel_ap(4, norm="nope")),
    ("bq", lambda m: m.design_bandstop(3, 6000.0, 39000.0, 3.0)),
    ("bq", lambda m: m.design_cheby1_lowpass(0, 0.05, 0.1, 2.0)),
    ("bq", lambda m: m.design_cheby2_lowpass(2, 40.0, 1.5, 2.0)),
    ("im", lambda m: m.ilog2(0)),
    ("lt", lambda m: m.normalize([1.0], [0.0, 0.0])),
    ("lt", lambda m: m.cont2discrete((BC, AC), 0.01, method="warp-drive")),
    ("lt", lambda m: m.sosfreqz(np.zeros((2, 5)))),
    ("lt", lambda m: m.lsim((BC, AC), np.sin(T201), T201 ** 2)),
    ("lt", lambda m: m.lsim((BC, AC), np.sin(T201)[:-1], T201)),
    ("lt", lambda m: m.dlsim((np.ones(2), np.ones(2), 0.1), U100,
                             x0=np.zeros(3))),
    ("lt", lambda m: m.dlsim(([1.0, 0, 0, 0], [1.0, -0.5], 1.0), U100)),
    ("lt", lambda m: m.findfreqs([1.0], [1.0], 5, kind="nope")),
    ("lt", lambda m: m.abcd_normalize(D=[[1]])),
    ("lt", lambda m: m.abcd_normalize(A=[[1]], B=[[1]], C=[[1]], D=[[1, 2]])),
    ("rz", lambda m: m.unique_roots(np.ones(3), rtype="median")),
    ("rz", lambda m: m.residue([1.0], [0.0])),
    ("pl", lambda m: m.place_poles(A2, B2, [-1.0 + 1j, -2.0])),
    ("pl", lambda m: m.place_poles(A2, B2, [-1.0 + 1j, -1.0 - 1j],
                                   method="KNV0")),
    ("pl", lambda m: m.place_poles(A2, B2, [-1.0, -2.0, -3.0])),
    ("pl", lambda m: m.place_poles(A2, B2, [-1.0, -1.0])),
    ("pl", lambda m: m.place_poles(A2, B2, [-1.0, -2.0], method="nope")),
    ("pl", lambda m: m.place_poles(A2, B2, [-1.0, -2.0], maxiter=0)),
    ("pl", lambda m: m.place_poles(A2, B2, [-1.0, -2.0], rtol=2.0)),
    ("sy", lambda m: m.lti([1.0])),
    ("sy", lambda m: m.dlti([1.0], [1.0], dt=None)),
    ("sy", lambda m: m.dlti([1.0], [1, -0.5], dt=0.1).to_discrete(0.1)),
]


def _raised(call, mod):
    try:
        _run(call, mod)
    except Exception as e:  # noqa: BLE001 - the type is what is compared
        return type(e)
    return None


@pytest.mark.parametrize("pair,call", RAISES,
                         ids=[f"{p}-{i}" for i, (p, _) in enumerate(RAISES)])
def test_refusal_equals_jax(pair, call):
    j, t = PAIRS[pair]
    want = _raised(call, j)
    assert want is not None
    got = _raised(call, t)
    assert got is not None and got.__name__ == want.__name__


def test_warnings_equal_jax():
    with pytest.warns(tlt.BadCoefficients):
        tlt.normalize([1e-16, 1.0], [1.0, 0.5])
    with pytest.warns(UserWarning, match="order is not used"):
        tiir.gammatone(440.0, "iir", order=8, fs=16000.0)
    with pytest.warns(UserWarning, match="numtaps is not used"):
        tiir.gammatone(440.0, "Iir", numtaps=99, fs=16000.0)


# -- scipy checks through the port ------------------------------------------------

def _impulse(sos, n=4096):
    x = np.zeros(n)
    x[0] = 1.0
    return sig.sosfilt(np.atleast_2d(np.asarray(sos, dtype=np.float64)), x)


@pytest.mark.parametrize("btype,wn", BANDS)
def test_iir_designs_match_scipy(btype, wn):
    for ours, theirs, tol in (
            (tiir.butter(5, wn, btype=btype, output="sos"),
             sig.butter(5, np.atleast_1d(wn), btype=btype, output="sos"),
             1e-12),
            (tiir.ellip(7, 0.7, 45.0, wn, btype=btype, output="sos"),
             sig.ellip(7, 0.7, 45.0, np.atleast_1d(wn), btype=btype,
                       output="sos"), 1e-9)):
        assert np.abs(_impulse(ours) - _impulse(theirs)).max() < tol


def test_design_runs_on_the_port_runtime():
    """An elliptic design of the port runs through the port's sosfilt and
    its (b, a) through the port's lfilter, against scipy in float64."""
    from simpledsp_tpu_torch.ops.iir import sosfilt
    from simpledsp_tpu_torch.ops.lfilter import lfilter
    des = tiir.ellip(7, 0.5, 55.0, 0.22)
    x = np.random.default_rng(7).standard_normal(2048)
    y, _ = sosfilt(des, torch.as_tensor(x), method="scan")
    ref = sig.sosfilt(sig.ellip(7, 0.5, 55.0, 0.22, output="sos"), x)
    assert np.abs(y.numpy() - ref).max() < 1e-9
    b, a = tiir.butter(4, 0.2, output="ba")
    y, _ = lfilter(b, a, torch.as_tensor(x))
    assert np.abs(y.numpy() - sig.lfilter(b, a, x)).max() < 1e-12


def test_biquad_names_match_scipy():
    d = tbq.design_cheby1_lowpass(4, 0.05, 0.1, 2.0)
    ref = sig.cheby1(8, 0.05, 0.1, output="sos")
    assert np.abs(_impulse(tbq.sos_matrix(d)) - _impulse(ref)).max() < 1e-12
    d = tbq.design_cheby2_lowpass(3, 40.0, 0.3, 2.0)
    ref = sig.cheby2(6, 40.0, 0.3, output="sos")
    assert np.abs(_impulse(tbq.sos_matrix(d)) - _impulse(ref)).max() < 1e-12
    f1, f2 = tbq.bp_cutoff_freqs(6000.0, 3.0, 39000.0)
    d = tbq.design_bandstop(4, 6000.0, 39000.0, 3.0)
    ref = sig.butter(4, [f1, f2], btype="bandstop", fs=39000.0, output="sos")
    assert np.abs(_impulse(tbq.sos_matrix(d)) - _impulse(ref)).max() < 1e-12
    b, a = tbq.ba_coefficients(tbq.design_lowpass(3, 2000.0, 39000.0))
    bs, as_ = sig.butter(6, 2000.0, fs=39000.0)
    np.testing.assert_allclose(b, bs, atol=1e-12)
    np.testing.assert_allclose(a, as_, atol=1e-12)
    w, gd = tbq.group_delay(tbq.design_lowpass(4, 2000.0, 39000.0), n=64)
    assert np.all(gd[w < 1500.0] > 0)


def test_dlsim_and_freqresp_return_numpy_and_match_scipy():
    bd, ad, dt = tlt.cont2discrete((BC, AC), 0.01)
    tout, y = tlt.dlsim((bd, ad, dt), U100)
    t2, y2 = sig.dlsim((bd, ad, dt), U100)
    assert isinstance(y, np.ndarray) and y.dtype == np.float64
    np.testing.assert_allclose(tout, t2)
    np.testing.assert_allclose(y, np.squeeze(y2), atol=TOL)
    w, h = tlt.freqresp((BC, AC), W60)
    assert isinstance(h, np.ndarray)
    np.testing.assert_allclose(h, sig.freqresp((BC, AC), w=W60)[1],
                               atol=TOL)
