"""End-to-end SDR scenario through the public API: an FM receiver bank.

Port of the JAX package's ``examples/fm_receiver.py``, at its sizes: two
FM carriers (1000 Hz and 2500 Hz tones, 5 kHz deviation) in channels 3 and
9 of a 16-channel bank at 1.024 MHz, 2^16 samples a call, audio decimated
by 4.  Checked: the recovered tones and their rms, channel 5's IQ power
below 1e-3 of channel 3's, a streamed second call, the zero-copy padded
entry bit for bit the plain call (on the kernel path), the north-star
chain's packed spectra, and two error probes.

    python -m simpledsp_tpu_torch.examples.fm_receiver [--device cpu]

On the card the bank runs the flat PFB kernel and the chain its kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from simpledsp_tpu_torch.examples import Laps, parse_device

__all__ = ["run", "check", "main", "scene", "OK"]

# The line main prints last, once the ground truth held.
OK = "SDR end-to-end OK"

FS, M, DECIM, T = 1.024e6, 16, 4, 1 << 16
TONES = ((3, 1000.0), (9, 2500.0))       # (channel, tone Hz)


def scene() -> np.ndarray:
    """(1, T) complex64: the two FM carriers."""
    t = np.arange(T) / FS

    def fm(fc, ftone, dev):
        return np.exp(1j * (2 * np.pi * fc * t
                            + dev / ftone * np.sin(2 * np.pi * ftone * t)))
    return (fm(3 * FS / M, 1000.0, 5e3)
            + fm(9 * FS / M, 2500.0, 5e3))[None, :].astype(np.complex64)


def _peak_hz(a: np.ndarray, rate: float) -> float:
    spec = np.abs(np.fft.rfft(a * np.hanning(a.size)))
    return float(np.fft.rfftfreq(a.size, 1 / rate)[np.argmax(spec)])


def _probe(fn):
    """The message of the ValueError ``fn()`` raises, or None."""
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def run(device=None) -> dict:
    from simpledsp_tpu_torch import design_bandpass, design_lowpass
    from simpledsp_tpu_torch.models import FMReceiverBank, NorthStarChain

    laps = Laps()
    rx = FMReceiverBank(M, FS, decim=DECIM, deviation_hz=5e3, device=device)
    dev = rx.device
    x = scene()
    audio, state = rx(x)
    audio = audio.cpu().numpy()
    laps(f"audio {audio.shape} {audio.dtype}")

    arate = FS / M / DECIM
    peaks, rms = {}, {}
    for ch, _ in TONES:
        a = audio[0, ch][200:]
        peaks[ch] = _peak_hz(a, arate)
        rms[ch] = float(np.sqrt(np.mean(a ** 2)))

    # Channel isolation at the IQ surface (an empty channel FM-demodulates
    # to noise by design, so its quiet is read before the discriminator).
    (iqr, iqi), _ = rx.chan.process_ri(
        torch.as_tensor(x.real.astype(np.float32), device=dev),
        torch.as_tensor(x.imag.astype(np.float32), device=dev))
    pw = (iqr ** 2 + iqi ** 2).mean(dim=1)[0].cpu().numpy()

    audio2, _ = rx(x, state)
    audio2 = audio2.cpu().numpy()
    peak2 = _peak_hz(audio2[0, 3], arate)
    laps(f"streamed call ch3 peak {peak2:.1f} Hz")

    # The zero-copy padded entry must give the plain call's bits.
    padded_dev = None
    if rx.use_kernel:
        front, total = rx.padded_spec(T)
        br = torch.empty((1, total), dtype=torch.float32, device=dev)
        bi = torch.empty_like(br)
        br[0, front:front + T] = torch.as_tensor(x.real, device=dev)
        bi[0, front:front + T] = torch.as_tensor(x.imag, device=dev)
        audio3, _, _ = rx.process_padded((br, bi), state)
        padded_dev = float(np.abs(audio3.cpu().numpy() - audio2).max())
        laps(f"padded entry max dev vs plain: {padded_dev:.1e}")

    chain = NorthStarChain(device=dev)
    xx = torch.as_tensor(np.random.default_rng(0).standard_normal((2, 8192)),
                         dtype=torch.float32, device=dev)
    (sr, si), _ = chain(xx)
    laps(f"northstar spectra RI {tuple(sr.shape)} kernel={chain.use_kernel}")

    # Probes: a wrong block length and an odd section count must raise.
    bad_length = _probe(lambda: rx(x[:, :100]))
    design_lowpass(3, 200.0, 39000.0)   # odd M is legal for LP/HP (order 6)
    odd_band = _probe(lambda: design_bandpass(3, 2000.0, 39000.0, 1.0))
    return {"x": x, "audio": audio, "audio2": audio2, "pw": pw,
            "arate": arate, "peaks": peaks, "rms": rms, "peak2": peak2,
            "padded_dev": padded_dev,
            "spectra": (sr.cpu().numpy(), si.cpu().numpy()),
            "probe_bad_length": bad_length, "probe_odd_band": odd_band,
            "laps": laps}


def check(out: dict) -> None:
    """The scenario's ground truth."""
    arate, n = out["arate"], out["audio"].shape[-1] - 200
    for ch, expect in TONES:
        assert abs(out["peaks"][ch] - expect) < 2 * arate / n * 10, \
            (ch, out["peaks"][ch])
        assert 0.5 < out["rms"][ch] < 1.5, out["rms"][ch]  # unit sine: 0.707
    pw = out["pw"]
    assert pw[5] < 1e-3 * pw[3], pw
    assert abs(out["peak2"] - 1000.0) < 20, out["peak2"]
    if out["padded_dev"] is not None:
        assert out["padded_dev"] == 0.0, out["padded_dev"]
    sr, si = out["spectra"]
    assert sr.shape == si.shape == (2, 2, 2048)   # packed one-sided
    assert out["probe_bad_length"] is not None, "no error for bad length"
    assert out["probe_odd_band"] is not None, "no error for odd-M band-pass"


def main(argv=None) -> None:
    out = run(parse_device(argv, __doc__.split("\n\n")[0]))
    laps = list(out["laps"])
    print(laps.pop(0))
    for ch, expect in TONES:
        print(f"  ch {ch}: peak {out['peaks'][ch]:.1f} Hz rms "
              f"{out['rms'][ch]:.3f} (expect {expect} Hz)")
    pw = out["pw"]
    print(f"  IQ powers: ch3={pw[3]:.3f} ch9={pw[9]:.3f} ch5={pw[5]:.2e}")
    for line in laps:
        print(line)
    for what, key in (("bad-length", "probe_bad_length"),
                      ("odd-M band-pass", "probe_odd_band")):
        if out[key] is None:
            print(f"PROBE FAIL: no error for {what}")
        else:
            print(f"  probe {what} ->", out[key])
    check(out)
    print(OK)


if __name__ == "__main__":
    main()
