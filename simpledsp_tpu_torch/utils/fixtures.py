"""Carried verbatim from ``simpledsp_tpu/utils/fixtures.py``: NumPy and SciPy
only; ``FilterType`` and ``bp_cutoff_freqs`` come from the port's own
``design/biquad``.

Golden impulse-response fixtures in the reference's CSV format.

The reference validates its IIR against Octave-generated CSVs with header
``fType,fs,f0,Q,n`` followed by n impulse-response samples (reference:
test/testIIR.cpp:7-28 reader, test_data/WriteImpulse.m generator).  This
module reads/writes that exact format and regenerates the golden set with
scipy (`butter`/`zp2sos`/`sosfilt` — the same algorithms Octave's signal
package uses), so fixtures are reproduced independently rather than copied.
"""

from __future__ import annotations

import dataclasses
import pathlib
import re
from typing import List, Tuple

import numpy as np
import scipy.signal as sig

from simpledsp_tpu_torch.design.biquad import FilterType

__all__ = ["ImpulseFixture", "read_fixture", "write_fixture",
           "generate_golden_fixtures", "REFERENCE_CASES"]


@dataclasses.dataclass(frozen=True)
class ImpulseFixture:
    ftype: FilterType
    fs: float
    f0: float
    q: float
    response: np.ndarray  # (n,) float64 impulse response


# The reference's parameter grid (reference: test_data/WriteImpulse.m:7-14,
# 35-36, 57-58): fs = 39 kHz, order 8 (4 SOS), three (f0, Q) pairs.
REFERENCE_CASES: List[Tuple[float, float]] = [
    (200.0, 1.4), (2000.0, 0.8), (15000.0, 2.0)]
REFERENCE_FS = 39000.0
REFERENCE_ORDER = 8
REFERENCE_N = 1000


def read_fixture(path) -> ImpulseFixture:
    """Parse the reference CSV format: ``fType,fs,f0,Q,n`` + n samples.

    Layout-agnostic: accepts both Octave ``csvwrite`` output (everything on
    one comma-separated line, the reference's actual files — parsed by
    test/testIIR.cpp:7-28 with ``getline(..., ',')``) and this repo's
    one-sample-per-line layout.  Tokens are split on commas and whitespace.
    """
    toks = re.split(r"[,\s]+", pathlib.Path(path).read_text().strip())
    ftype_s, fs_s, f0_s, q_s, n_s = toks[:5]
    n = int(float(n_s))
    vals = np.array([float(v) for v in toks[5:5 + n]], dtype=np.float64)
    if vals.size != n:
        raise ValueError(f"{path}: expected {n} samples, got {vals.size}")
    return ImpulseFixture(ftype=FilterType(int(float(ftype_s))),
                          fs=float(fs_s), f0=float(f0_s), q=float(q_s),
                          response=vals)


def write_fixture(path, fx: ImpulseFixture, layout: str = "lines") -> None:
    """Write a fixture CSV.  ``layout="lines"`` (default) puts one sample
    per line; ``layout="octave"`` writes the single-comma-separated-line
    form Octave's csvwrite produces, byte-compatible with the reference's
    reader (testIIR.cpp:7-28)."""
    header = f"{int(fx.ftype)},{fx.fs:g},{fx.f0:g},{fx.q:g},{fx.response.size}"
    vals = [repr(float(v)) for v in fx.response]
    if layout == "octave":
        text = ",".join([header] + vals) + "\n"
    elif layout == "lines":
        text = "\n".join([header] + vals) + "\n"
    else:
        raise ValueError(f"unknown layout {layout!r}")
    pathlib.Path(path).write_text(text)


def _scipy_impulse(ftype: FilterType, fs: float, f0: float, q: float,
                   order: int = REFERENCE_ORDER,
                   n: int = REFERENCE_N) -> np.ndarray:
    """Impulse response via scipy butter/zp2sos/sosfilt (WriteImpulse.m's
    recipe with scipy in place of Octave)."""
    if ftype == FilterType.low_pass:
        z, p, k = sig.butter(order, f0, btype="low", fs=fs, output="zpk")
    elif ftype == FilterType.high_pass:
        z, p, k = sig.butter(order, f0, btype="high", fs=fs, output="zpk")
    elif ftype in (FilterType.band_pass, FilterType.band_stop):
        # Band edges per the reference's solver (findIIRCutoffFreq.m):
        # f2 - f1 = f0 / q with the -3 dB points symmetric about f0.
        from simpledsp_tpu_torch.design.biquad import bp_cutoff_freqs
        f1, f2 = bp_cutoff_freqs(f0, q, fs)
        btype = "bandpass" if ftype == FilterType.band_pass else "bandstop"
        z, p, k = sig.butter(order // 2, [f1, f2], btype=btype, fs=fs,
                             output="zpk")
    else:
        raise ValueError(ftype)
    sos = sig.zpk2sos(z, p, k)
    x = np.zeros(n)
    x[0] = 1.0
    return sig.sosfilt(sos, x)


def generate_golden_fixtures(out_dir, cases=None, fs: float = REFERENCE_FS,
                             order: int = REFERENCE_ORDER,
                             n: int = REFERENCE_N) -> List[pathlib.Path]:
    """Regenerate the reference's 9-CSV golden set (LP/HP/BP x 3 cases)
    with scipy; returns the written paths."""
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    cases = cases or REFERENCE_CASES
    names = {FilterType.low_pass: "LP", FilterType.high_pass: "HP",
             FilterType.band_pass: "BP"}
    paths = []
    for i, (f0, q) in enumerate(cases):
        for ftype, prefix in names.items():
            suffix = "" if i == 0 else str(i + 1)
            path = out / f"{prefix}impulse{suffix}.csv"
            resp = _scipy_impulse(ftype, fs, f0, q, order, n)
            write_fixture(path, ImpulseFixture(ftype, fs, f0, q, resp))
            paths.append(path)
    return paths
