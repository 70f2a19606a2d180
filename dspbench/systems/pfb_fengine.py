"""The F-engine's channelizer as the benchmark drives it: the port's
``PFBChannelizer(M, taps_per_channel=K).process_real(x, state)`` on
(inputs, T) float32 ADC streams, the state carried from call to call; a
call returns the M/2 channels below the Nyquist channel of T / M spectra a
stream as (re, im) float32 planes.

Each stream is unit-power Gaussian noise plus ``tones`` sinusoids at
``tone_db_low`` to ``tone_db_high`` dB over the noise, each at a frequency
and a phase drawn from the seed, so that the spectra are not flat; the
tones run on across the blocks of the pool (block j holds samples j T ..
(j + 1) T - 1).  The check runs the float64 reference over the call's
samples and the M K - 1 before them, which set the carried history (call g
ran on block g % pool after block (g - 1) % pool), and takes the worst
relative RMS error of one input's channel spectra (``chan_rel_err``).
"""

from __future__ import annotations

import contextlib
import math
import random

import torch

from dspbench.harness import worst_row
from dspbench.inputs import block_generator, draw, sub_seed

NUMBER = "chan_rel_err"


class System:
    def __init__(self, params: dict, traffic: dict, device, mesh=None):
        from simpledsp_tpu_torch.ops.channelizer import PFBChannelizer

        if mesh is not None:
            raise ValueError("the F-engine cell runs on one card")
        p = params
        self.params, self.device = params, device
        self.inputs, self.m, self.k = p["inputs"], p["branches"], p["taps"]
        if p["channels_out"] != self.m // 2:
            raise ValueError(f"an M={self.m} real PFB keeps {self.m // 2} "
                             f"channels, not {p['channels_out']}")
        self.samples = traffic["samples_per_call"]
        self.history = self.m * self.k - 1
        if self.samples % self.m or self.samples < self.history:
            raise ValueError(
                f"the mix gives {self.samples} samples a stream a call; the "
                f"F-engine needs a multiple of M={self.m} at least as long "
                f"as its history of {self.history}")
        self.samples_per_call = self.inputs * self.samples
        if not hasattr(PFBChannelizer, "process_real"):
            raise NotImplementedError("this PFBChannelizer has no streaming "
                                      "real-input entry (process_real)")
        self.model = PFBChannelizer(self.m, taps_per_channel=self.k,
                                    dtype=torch.float32, design=p["design"],
                                    device=device)
        self.controlled = False

    # -- inputs ----------------------------------------------------------
    def _tones(self, seed: int):
        """(amplitude, cycles a sample, phase), each (S, tones) float64 on
        the card."""
        p = self.params
        rng = random.Random(sub_seed(seed, "tones"))
        shape = (self.inputs, p["tones"])
        rows = [[(math.sqrt(2.0 * 10.0 ** (rng.uniform(
                    p["tone_db_low"], p["tone_db_high"]) / 10.0)),
                  rng.uniform(0.0, 0.5), rng.uniform(0.0, 2.0 * math.pi))
                 for _ in range(shape[1])] for _ in range(shape[0])]
        t = torch.tensor(rows, dtype=torch.float64, device=self.device)
        return t[..., 0], t[..., 1], t[..., 2]

    def block(self, seed: int, block: int) -> torch.Tensor:
        """(S, T) float32 on the card: samples block T .. (block + 1) T - 1
        of every stream."""
        gen = block_generator(self.device, seed, block, 0)
        x = torch.randn((self.inputs, self.samples), generator=gen,
                        device=self.device, dtype=torch.float32).double()
        n = torch.arange(block * self.samples, (block + 1) * self.samples,
                         dtype=torch.float64, device=self.device)
        amp, freq, phase = self._tones(seed)
        for i in range(amp.shape[1]):
            x += amp[:, i:i + 1] * torch.cos(
                2.0 * math.pi * freq[:, i:i + 1] * n + phase[:, i:i + 1])
        return x.float()

    def pool(self, seed: int, blocks: int) -> list:
        return [self.block(seed, j) for j in range(blocks)]

    def init_state(self):
        return None

    def call(self, x, state):
        return self.model.process_real(x, state)

    def work(self) -> dict:
        from dspbench.roofline_fengine import fengine_work
        return fengine_work(self.inputs, self.samples, self.m, self.k)

    # -- the check -------------------------------------------------------
    def check(self, seed: int, blocks: int, kept: list, reference) -> dict:
        """The worst relative RMS error of one input's channel spectra over
        the kept calls."""
        taps = reference.prototype(self.m, self.k)
        rounding = "bfloat16" if self.controlled else None
        h = self.history
        worst, compared = 0.0, 0
        for g, out, rows in kept:
            if g < 1:
                raise ValueError("the first call of a stream starts from "
                                 "rest and is not compared")
            before = self.block(seed, (g - 1) % blocks)[rows, -h:]
            x = torch.cat([before, self.block(seed, g % blocks)[rows]], -1)
            x = x.double().cpu()
            for i, s in enumerate(rows):
                ref = reference.channels(x[i], taps, self.m, prefix=h)
                if self.controlled:
                    got = reference.channels(x[i], taps, self.m, prefix=h,
                                             rounding=rounding)
                else:
                    got = torch.complex(out[0][s].double(),
                                        out[1][s].double()).cpu()
                err = float((got - ref).abs().square().sum())
                norm = float(ref.abs().square().sum())
                worst = max(worst, worst_row([err], [norm]))
            compared += len(rows)
        return {"numbers": {NUMBER: worst}, "compared": compared}

    def rows(self, seed: int, last: bool) -> list:
        """The inputs compared in a kept call: every one in the last call,
        a few drawn from the seed in another."""
        if last:
            return list(range(self.inputs))
        return draw(seed, "fengine inputs", self.inputs,
                    self.params["sampled_rows"])


@contextlib.contextmanager
def control(system: System):
    """The reference computed with the FIR's input and taps rounded to
    bfloat16 in the program's place (the route has no GEMM, so TF32 is no
    control here): the check judges its channels where it would judge the
    program's."""
    system.controlled = True
    try:
        yield
    finally:
        system.controlled = False
