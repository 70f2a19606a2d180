"""The port's example scenarios (``simpledsp_tpu_torch/examples``) on the
CPU: each passes its ground truth, and its arrays agree with the JAX
package's public API on the same scene (the composable paths, as the JAX
tests run them), both in float32.

Tolerances, each relative to the largest magnitude of the JAX array:
1e-5 for the FM audio of the two carrier channels, the IQ channel powers,
the channelized, resampled and overlap-saved planes, and the radar map
(the largest difference seen is 5e-7); the detection masks are equal
outside the cells whose power lies within 1e-4 (relative) of the JAX
threshold.  The bank's other channels carry no carrier: the discriminator
turns their noise into audio that any rounding changes, so only the
carriers' audio is compared.
"""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpledsp_tpu_torch.examples import (channelize_resample, fm_receiver,
                                          radar_rdm)

REPO = Path(__file__).resolve().parent.parent
REL = 1e-5
THRESHOLD_REL = 1e-4
EXAMPLES = {"fm_receiver": fm_receiver,
            "channelize_resample": channelize_resample,
            "radar_rdm": radar_rdm}


@pytest.fixture(scope="module")
def results():
    return {name: ex.run(device="cpu") for name, ex in EXAMPLES.items()}


def _close(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_passes_its_ground_truth(results, name):
    EXAMPLES[name].check(results[name])


def test_fm_receiver_matches_the_jax_bank(results):
    from simpledsp_tpu.models import FMReceiverBank, NorthStarChain

    out = results["fm_receiver"]
    rx = FMReceiverBank(16, 1.024e6, decim=4, deviation_hz=5e3)
    x = out["x"]
    audio, state = rx(x)
    audio2, _ = rx(x, state)
    for got, want in ((out["audio"], audio), (out["audio2"], audio2)):
        for ch, _ in fm_receiver.TONES:
            _close(got[0, ch], np.asarray(want)[0, ch])
    (iqr, iqi), _ = rx.chan.process_ri(
        jnp.asarray(x.real.astype(np.float32)),
        jnp.asarray(x.imag.astype(np.float32)))
    _close(out["pw"], np.asarray((iqr ** 2 + iqi ** 2).mean(axis=1))[0])
    xx = np.random.default_rng(0).standard_normal((2, 8192))
    (sr, si), _ = NorthStarChain()(jnp.asarray(xx, dtype=jnp.float32))
    for got, want in zip(out["spectra"], (sr, si)):
        _close(got, want)


def test_fm_receiver_probes_raise_as_in_jax(results):
    out = results["fm_receiver"]
    assert "multiple of M*decim" in out["probe_bad_length"]
    assert "even" in out["probe_odd_band"]


def test_channelize_resample_matches_the_jax_chain(results):
    from simpledsp_tpu import (OverlapSaveFIR, PFBChannelizer,
                               PolyphaseResampler, lowpass_taps,
                               resampler_taps)

    out = results["channelize_resample"]
    x = out["x"]
    chan = PFBChannelizer(8, taps_per_channel=8)
    (iqr, iqi), _ = chan.process_ri(jnp.asarray(x.real, jnp.float32),
                                    jnp.asarray(x.imag, jnp.float32))
    taps = resampler_taps(3, 2, taps_per_phase=16)
    yr, _ = PolyphaseResampler(taps, up=3, down=2)(iqr[..., 3])
    yi, _ = PolyphaseResampler(taps, up=3, down=2)(iqi[..., 3])
    osf = OverlapSaveFIR(lowpass_taps(255, 0.2, fs=1.0), block_size=1024)
    zf, _ = osf(jnp.pad(yr, (0, (-yr.shape[-1]) % 1024)))
    for got, want in zip((*out["iq"], *out["resampled"], out["filtered"]),
                         (iqr, iqi, yr, yi, zf)):
        _close(got, want)
    assert out["nfft"] == osf.nfft == 2048


def test_radar_rdm_matches_the_jax_pipeline(results):
    from simpledsp_tpu.models.radar import cfar_ca, lfm_chirp, range_doppler_map

    out = results["radar_rdm"]
    z = out["z"]
    tx_re, tx_im = lfm_chirp(radar_rdm.N_CHIRP, 0.8)
    np.testing.assert_array_equal(out["tx"][0], tx_re)
    rdm = range_doppler_map(jnp.asarray(z.real, jnp.float32)[None],
                            jnp.asarray(z.imag, jnp.float32)[None],
                            tx_re, tx_im)
    det, thr = cfar_ca(rdm, guard=2, train=12, pfa=1e-5)
    rdm, det, thr = (np.asarray(a)[0] for a in (rdm, det, thr))
    _close(out["rdm"], rdm)
    clear = np.abs(rdm - thr) > THRESHOLD_REL * thr
    assert clear.mean() > 0.99
    np.testing.assert_array_equal(out["det"][clear], det[clear])


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_runs_as_a_module(name):
    """``python -m simpledsp_tpu_torch.examples.<name> --device cpu``
    prints the JAX script's lines and its last OK line, and exits 0."""
    proc = subprocess.run(
        [sys.executable, "-m", f"simpledsp_tpu_torch.examples.{name}",
         "--device", "cpu"], cwd=REPO, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[-1] == EXAMPLES[name].OK
    assert lines[0].startswith("[") and "s] " in lines[0]


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_without_a_card_exits_2(name):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    proc = subprocess.run(
        [sys.executable, "-m", f"simpledsp_tpu_torch.examples.{name}"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2
    assert "CUDA is not available" in proc.stderr and proc.stdout == ""


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_run_defaults_to_cuda(name):
    """``run()`` with no device means CUDA, and raises without a card."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: device=None is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        EXAMPLES[name].run()
