"""The PyTorch port against the committed golden impulse responses, the
North Star's 1e-12 bar (the port of tests/test_golden.py).

Every CSV in test_data/impulse_response is read with the port's
``utils/fixtures.read_fixture``, which must give the JAX package's fixture
field by field (bitwise: the same parser).  The filter is rebuilt from the
header with the port's ``design/biquad`` and run through the port's
``sosfilt_scan`` in float64 on the CPU.  Tolerances: 1e-12 absolute
against the fixture; 32-sample blocks give the bits of one call.
"""

import pathlib

import numpy as np
import pytest
import torch

from simpledsp_tpu.utils import fixtures as jfx
from simpledsp_tpu_torch.design.biquad import (FilterType, design_bandpass,
                                               design_highpass, design_lowpass)
from simpledsp_tpu_torch.ops.iir import (coeffs_from_design, iir_init,
                                         sosfilt_scan)
from simpledsp_tpu_torch.utils import fixtures as tfx

FIXTURE_DIR = (pathlib.Path(__file__).parent.parent
               / "test_data" / "impulse_response")
FIXTURES = sorted(FIXTURE_DIR.glob("*.csv"))


def _design(fx, m=4):
    if fx.ftype == FilterType.low_pass:
        return design_lowpass(m, fx.f0, fx.fs)
    if fx.ftype == FilterType.high_pass:
        return design_highpass(m, fx.f0, fx.fs)
    assert fx.ftype == FilterType.band_pass, fx.ftype
    return design_bandpass(m, fx.f0, fx.fs, fx.q)


@pytest.mark.parametrize("path", FIXTURES, ids=lambda p: p.stem)
def test_impulse_response_matches_fixture(path):
    fx = tfx.read_fixture(path)
    m = 4  # order 8 = 4 SOS, the fixture generation setting
    design = _design(fx, m)
    n = fx.response.size
    x = torch.zeros(n, dtype=torch.float64)
    x[0] = 1.0
    coeffs = coeffs_from_design(design, dtype=torch.float64)
    y, _ = sosfilt_scan(coeffs, x, iir_init(m, (), dtype=torch.float64))
    err = np.abs(y.numpy() - fx.response).max()
    assert err < 1e-12, f"{path.name}: {err:.2e}"

    # blockwise == whole, bit for bit, 32-sample blocks
    state = iir_init(m, (), dtype=torch.float64)
    parts = []
    for i in range(0, n, 32):
        yb, state = sosfilt_scan(coeffs, x[i:i + 32], state)
        parts.append(yb)
    assert torch.equal(torch.cat(parts), y)


@pytest.mark.parametrize("path", FIXTURES, ids=lambda p: p.stem)
def test_read_fixture_equals_jax(path):
    got, want = tfx.read_fixture(path), jfx.read_fixture(path)
    assert int(got.ftype) == int(want.ftype)
    assert (got.fs, got.f0) == (want.fs, want.f0)
    assert got.q == want.q or (np.isnan(got.q) and np.isnan(want.q))
    np.testing.assert_array_equal(got.response, want.response)


def test_fixture_set_is_complete():
    assert len(FIXTURES) == 9  # LP/HP/BP x 3 (f0, Q) cases


@pytest.mark.parametrize("layout", ["lines", "octave"])
def test_write_fixture_round_trips_and_equals_jax(tmp_path, layout):
    fx = tfx.read_fixture(FIXTURES[0])
    tfx.write_fixture(tmp_path / "t.csv", fx, layout=layout)
    jfx.write_fixture(tmp_path / "j.csv", jfx.read_fixture(FIXTURES[0]),
                      layout=layout)
    assert (tmp_path / "t.csv").read_text() == (tmp_path / "j.csv").read_text()
    back = tfx.read_fixture(tmp_path / "t.csv")
    np.testing.assert_array_equal(back.response, fx.response)
    with pytest.raises(ValueError):
        tfx.write_fixture(tmp_path / "x.csv", fx, layout="bad")


def test_generate_golden_fixtures_equals_jax_and_committed_set(tmp_path):
    got = tfx.generate_golden_fixtures(tmp_path / "t", n=200)
    want = jfx.generate_golden_fixtures(tmp_path / "j", n=200)
    assert [p.name for p in got] == [p.name for p in want]
    for g, w in zip(got, want):
        assert g.read_text() == w.read_text()
        # The regenerated responses agree with the committed fixtures.
        committed = tfx.read_fixture(FIXTURE_DIR / g.name).response[:200]
        np.testing.assert_allclose(tfx.read_fixture(g).response, committed,
                                   rtol=0, atol=1e-12)
