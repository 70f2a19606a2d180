"""Wideband channelize -> per-channel rational resample -> long-FIR clean-up.

Port of the JAX package's ``examples/channelize_resample.py``, at its
sizes: a tone at +5 kHz inside channel 3 of a ``PFBChannelizer(8,
taps_per_channel=8)`` on 2^15 samples at 512 kHz (the RI path), then a 3/2
``PolyphaseResampler`` (64 -> 96 kHz) on channel 3 and a 255-tap
``OverlapSaveFIR`` (block 1024, nfft 2048) on the resampled real plane.
Checked: the tone sits at +5 kHz within 300 Hz at the channel rate and
after the resampler.

    python -m simpledsp_tpu_torch.examples.channelize_resample [--device cpu]

On the card the overlap-save filter's 2048-point transforms run the frames
FFT kernel; the channelizer's RI path (branch FIRs and an 8-point DFT) and
the resampler are plain PyTorch, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from simpledsp_tpu_torch.examples import Laps, parse_device

__all__ = ["run", "check", "main", "scene", "OK"]

# The line main prints last, once the ground truth held.
OK = "channelize/resample/overlap-save chain OK"

FS, M, T = 512e3, 8, 1 << 15
TONE_OFF = 5e3                  # Hz from channel 3's centre
UP, DOWN = 3, 2


def scene() -> np.ndarray:
    """(T,) complex128: one tone inside channel 3."""
    n = np.arange(T)
    return np.exp(2j * np.pi * (3 * FS / M + TONE_OFF) * n / FS)


def peak_hz(re, im, rate: float) -> float:
    """The strongest frequency of re + i im past its first 256 samples."""
    z = (np.asarray(re, np.float64) + 1j * np.asarray(im, np.float64))[256:]
    spec = np.abs(np.fft.fft(z * np.hanning(z.size)))
    return float(np.fft.fftfreq(z.size, 1 / rate)[np.argmax(spec)])


def run(device=None) -> dict:
    from simpledsp_tpu_torch import (OverlapSaveFIR, PFBChannelizer,
                                     PolyphaseResampler, lowpass_taps,
                                     resampler_taps)

    laps = Laps()
    x = scene()
    chan = PFBChannelizer(M, taps_per_channel=8, device=device)
    dev = chan.device
    (iqr, iqi), _ = chan.process_ri(
        torch.as_tensor(x.real, dtype=torch.float32, device=dev),
        torch.as_tensor(x.imag, dtype=torch.float32, device=dev))
    laps(f"channelized: {tuple(iqr.shape)} (frames, channels), rate "
         f"{FS / M / 1e3:.0f} kHz")

    # Channel 3 at baseband, 64 kHz -> resample 3/2 -> 96 kHz.
    taps = resampler_taps(UP, DOWN, taps_per_phase=16)
    rs_r = PolyphaseResampler(taps, up=UP, down=DOWN, device=dev)
    rs_i = PolyphaseResampler(taps, up=UP, down=DOWN, device=dev)
    ch3_r, ch3_i = iqr[..., 3], iqi[..., 3]
    yr, _ = rs_r(ch3_r)
    yi, _ = rs_i(ch3_i)
    new_rate = FS / M * UP / DOWN
    laps(f"resampled ch3: {ch3_r.shape[-1]} -> {yr.shape[-1]} samples "
         f"({new_rate / 1e3:.0f} kHz)")

    # Long clean-up FIR (255 taps) by overlap-save on the real plane.
    os_taps = lowpass_taps(255, 0.2, fs=1.0)
    osf = OverlapSaveFIR(os_taps, block_size=1024, device=dev)
    zf, _ = osf(F.pad(yr, (0, (-yr.shape[-1]) % 1024)))
    laps(f"overlap-save filtered: {zf.shape[-1]} samples "
         f"({len(os_taps)} taps)")

    ch3_r, ch3_i = ch3_r.cpu().numpy(), ch3_i.cpu().numpy()
    yr, yi = yr.cpu().numpy(), yi.cpu().numpy()
    p1 = peak_hz(ch3_r, ch3_i, FS / M)
    p2 = peak_hz(yr, yi, new_rate)
    laps(f"tone at channel rate: {p1 / 1e3:+.2f} kHz; after resample: "
         f"{p2 / 1e3:+.2f} kHz (expect {TONE_OFF / 1e3:+.2f})")
    return {"x": x, "iq": (iqr.cpu().numpy(), iqi.cpu().numpy()),
            "resampled": (yr, yi), "filtered": zf.cpu().numpy(),
            "nfft": osf.nfft, "p1": p1, "p2": p2, "laps": laps}


def check(out: dict) -> None:
    """The scenario's ground truth."""
    assert abs(out["p1"] - TONE_OFF) < 300, out["p1"]
    assert abs(out["p2"] - TONE_OFF) < 300, out["p2"]


def main(argv=None) -> None:
    out = run(parse_device(argv, __doc__.split("\n\n")[0]))
    for line in out["laps"]:
        print(line)
    check(out)
    print(OK)


if __name__ == "__main__":
    main()
