"""The pulse-Doppler radar as the benchmark drives it: the port's
``range_doppler_map(xr, xi, tx_re, tx_im, window=...)`` on (beams, pulses,
range samples) float32 planes, then ``cfar_ca(power, guard, train, pfa)``
along range, as ``examples/radar_rdm.py`` calls them.  A call is one CPI of
every beam and returns the power map and the detection mask; nothing is
carried from call to call.

Each CPI is unit-power complex Gaussian noise plus, in every beam,
``targets`` echoes of the chirp (``lfm_chirp(taps, chirp_bandwidth)``), each
at a delay below N - K, on a Doppler bin, at a per-sample SNR in
[``snr_db_low``, ``snr_db_high``] and with a phase, all drawn from the seed:
white noise alone would leave the CFAR nothing to find.  The check runs the
float64 reference beam by beam on the call's CPI and reads two numbers:

- ``rdm_rel_err``: the worst relative RMS error of one beam's power map;
- ``det_mismatch``: the cells whose detection differs from the reference's
  where the reference's power lies outside ``det_band`` (relative) of its
  threshold; closer than that, float32 rounding may decide either way.
"""

from __future__ import annotations

import contextlib
import math
import random

import torch

from dspbench.harness import worst_row
from dspbench.inputs import block_generator, draw, sub_seed


class System:
    def __init__(self, params: dict, traffic: dict, device, mesh=None):
        from simpledsp_tpu_torch.models.radar import lfm_chirp

        if mesh is not None:
            raise ValueError("the radar cell runs on one card")
        p = params
        self.params, self.device = params, device
        self.beams, self.pulses = p["beams"], p["pulses"]
        self.samples = p["range_samples"]
        if traffic["samples_per_call"] != self.pulses * self.samples:
            raise ValueError(
                f"the mix gives {traffic['samples_per_call']} samples a "
                f"beam's CPI; the configuration's is {self.pulses} x "
                f"{self.samples}")
        self.samples_per_call = self.beams * self.pulses * self.samples
        self.tx_re, self.tx_im = lfm_chirp(p["taps"], p["chirp_bandwidth"])
        self.controlled = False

    # -- inputs ----------------------------------------------------------
    def _targets(self, seed: int, block: int) -> list:
        """Per target slot, (delays, Doppler bins, amplitudes, phases), each
        a list over the beams."""
        p = self.params
        rng = random.Random(sub_seed(seed, "targets", block))
        slots = []
        for _ in range(p["targets"]):
            beams = range(self.beams)
            slots.append((
                [rng.randrange(self.samples - p["taps"]) for _ in beams],
                [rng.randrange(self.pulses) for _ in beams],
                [10.0 ** (rng.uniform(p["snr_db_low"], p["snr_db_high"])
                          / 20.0) for _ in beams],
                [rng.uniform(0.0, 2.0 * math.pi) for _ in beams]))
        return slots

    def block(self, seed: int, block: int):
        """(xr, xi), each (B, P, N) float32 on the card: block ``block``'s
        CPI of every beam."""
        shape = (self.beams, self.pulses, self.samples)
        gen = block_generator(self.device, seed, block, 0)
        scale = math.sqrt(0.5)
        z = [torch.randn(shape, generator=gen, device=self.device,
                         dtype=torch.float32).double() * scale
             for _ in range(2)]
        dev, f64 = self.device, torch.float64
        tx = torch.complex(torch.as_tensor(self.tx_re, dtype=f64),
                           torch.as_tensor(self.tx_im, dtype=f64)).to(dev)
        k = tx.shape[0]
        pulse = torch.arange(self.pulses, dtype=f64, device=dev)
        for delays, bins, amps, phases in self._targets(seed, block):
            d = torch.tensor(delays, device=dev)
            turn = torch.tensor(bins, dtype=f64, device=dev)[:, None] * pulse
            ang = (2.0 * math.pi / self.pulses) * turn + torch.tensor(
                phases, dtype=f64, device=dev)[:, None]
            amp = torch.tensor(amps, dtype=f64, device=dev)[:, None]
            echo = (torch.polar(amp.expand_as(ang), ang)[:, :, None]
                    * tx[None, None, :])                      # (B, P, K)
            index = (d[:, None, None] + torch.arange(k, device=dev)).expand(
                echo.shape)
            z[0].scatter_add_(-1, index, echo.real.contiguous())
            z[1].scatter_add_(-1, index, echo.imag.contiguous())
        return z[0].float(), z[1].float()

    def pool(self, seed: int, blocks: int) -> list:
        return [self.block(seed, j) for j in range(blocks)]

    def init_state(self):
        return None

    def call(self, x, state):
        from simpledsp_tpu_torch.models.radar import (cfar_ca,
                                                      range_doppler_map)
        p = self.params
        power = range_doppler_map(x[0], x[1], self.tx_re, self.tx_im,
                                  window=p["window"])
        det, _ = cfar_ca(power, guard=p["guard"], train=p["train"],
                         pfa=p["pfa"])
        return (power, det), state

    def work(self) -> dict:
        from dspbench.roofline_radar import pulse_doppler_work
        p = self.params
        return pulse_doppler_work(self.beams, self.pulses, self.samples,
                                  p["taps"], p["train"])

    # -- the check -------------------------------------------------------
    def check(self, seed: int, blocks: int, kept: list, reference) -> dict:
        """The worst beam's relative RMS error of the power map and the
        detections that differ outside the band, over the kept calls
        (call g ran on block g % blocks)."""
        p = self.params
        kw = dict(taps=p["taps"], bandwidth=p["chirp_bandwidth"],
                  guard=p["guard"], train=p["train"], pfa=p["pfa"])
        worst, mismatch, compared = 0.0, 0, 0
        for g, out, rows in kept:
            xr, xi = self.block(seed, g % blocks)
            for b in rows:
                z = torch.complex(xr[b].double(), xi[b].double()).cpu()
                ref, ref_det, ref_thresh = reference.detect(z, **kw)
                if self.controlled:
                    got, got_det, _ = reference.detect(z, tf32=True, **kw)
                else:
                    got = out[0][b].double().cpu()
                    got_det = out[1][b].cpu()
                err = float(((got - ref) ** 2).sum())
                norm = float((ref ** 2).sum())
                worst = max(worst, worst_row([err], [norm]))
                outside = ((ref - ref_thresh).abs()
                           > p["det_band"] * ref_thresh)
                mismatch += int(((got_det != ref_det) & outside).sum())
            compared += len(rows)
        return {"numbers": {"rdm_rel_err": worst, "det_mismatch": mismatch},
                "compared": compared}

    def rows(self, seed: int, last: bool) -> list:
        """The beams compared in a kept call: every one in the last call, a
        few drawn from the seed in another."""
        if last:
            return list(range(self.beams))
        return draw(seed, "radar beams", self.beams,
                    self.params["sampled_rows"])


@contextlib.contextmanager
def control(system: System):
    """The reference computed with TF32 products (every product's operands
    rounded to a 10-bit significand, float32 sums) in the program's place:
    the check judges its map and detections where it would judge the
    program's."""
    system.controlled = True
    try:
        yield
    finally:
        system.controlled = False
