"""The FM receiver bank as the benchmark drives it: the port's
``FMReceiverBank.__call__((xr, xi), state)`` on (re, im) float32 planes,
the state carried from call to call.

The input is one constant-envelope FM carrier in each channel of each
stream, near the channel's centre, its tone, phase and modulation drawn
from the seed: white noise would measure how well ``atan2`` is conditioned
near zero, not the bank.  The carriers run on across the blocks of the pool
(block j holds samples j T .. (j + 1) T - 1).  The check runs the float64
reference over the call's samples and the samples just before them, which
set every stage's state, and takes the worst relative RMS error of a
channel's audio.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from dspbench.harness import worst_row
from dspbench.inputs import draw, sub_seed

NUMBER = "audio_rel_err"


class System:
    def __init__(self, params: dict, traffic: dict, device, mesh=None):
        from simpledsp_tpu_torch.models.sdr import FMReceiverBank

        if mesh is not None:
            raise ValueError("the FM bank cell runs on one card")
        self.params, self.device = params, device
        p = params
        self.streams, self.channels = p["streams"], p["channels"]
        self.samples = traffic["samples_per_call"]
        self.samples_per_call = self.streams * self.samples
        self.model = FMReceiverBank(
            p["channels"], p["fs"], decim=p["decim"],
            deviation_hz=p["deviation_hz"], taps_per_channel=p["taps"],
            audio_taps=p["audio_taps"], dtype=torch.float32, device=device,
            use_kernel=True, design=p["design"])
        self.controlled = False

    # -- inputs ----------------------------------------------------------
    def _carriers(self, seed: int):
        """(phase, tone, index), each (B, M) float64 on the card."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(sub_seed(seed, "carriers"))
        shape = (self.streams, self.channels)
        u = torch.rand((3,) + shape, generator=gen, device=self.device,
                       dtype=torch.float64)
        p = self.params
        tone = (p["tone_low"] + (p["tone_high"] - p["tone_low"]) * u[1])
        index = p["index_low"] + (p["index_high"] - p["index_low"]) * u[2]
        return 2 * math.pi * u[0], tone / p["fs"], index

    def block(self, seed: int, block: int, shard: int = 0):
        """(xr, xi), each (B, T) float32 on the card: samples block T ..
        (block + 1) T - 1 of every stream's carriers."""
        phase, tone, index = self._carriers(seed)
        n = torch.arange(block * self.samples, (block + 1) * self.samples,
                         dtype=torch.float64, device=self.device)
        zr = torch.zeros((self.streams, self.samples), dtype=torch.float64,
                         device=self.device)
        zi = torch.zeros_like(zr)
        m, off = self.channels, self.params["carrier_offset"]
        for c in range(m):
            ang = (2 * math.pi * ((c + off) / m) * n[None, :]
                   + index[:, c:c + 1] * torch.sin(
                       2 * math.pi * tone[:, c:c + 1] * n[None, :])
                   + phase[:, c:c + 1])
            zr += torch.cos(ang)
            zi += torch.sin(ang)
        return zr.float(), zi.float()

    def pool(self, seed: int, blocks: int) -> list:
        return [self.block(seed, j) for j in range(blocks)]

    def init_state(self):
        return self.model.init_state(self.streams)

    def call(self, x, state):
        return self.model(x, state)

    def work(self) -> dict:
        from dspbench.roofline import pfb_fm_work
        p = self.params
        return pfb_fm_work(self.streams, self.samples, p["channels"],
                           p["taps"], p["decim"], p["audio_taps"])

    # -- the check -------------------------------------------------------
    def _host(self, seed, block, rows, tail=None) -> np.ndarray:
        xr, xi = self.block(seed, block)
        z = xr[rows].double().cpu().numpy() + 1j * xi[rows].double().cpu(
        ).numpy()
        return z if tail is None else z[:, z.shape[1] - tail:]

    def check(self, seed: int, blocks: int, kept: list, reference) -> dict:
        """The worst relative RMS error of one channel's audio of one
        stream over the kept calls (call g ran on block g % blocks, after
        block (g - 1) % blocks)."""
        p = self.params
        kw = dict(channels=p["channels"], taps=p["taps"], fs=p["fs"],
                  decim=p["decim"], audio_taps=p["audio_taps"],
                  deviation_hz=p["deviation_hz"])
        prefix = reference.memory(p["channels"], p["taps"], p["decim"],
                                  p["audio_taps"])
        worst, compared = 0.0, 0
        for g, out, rows in kept:
            if g < 1:
                raise ValueError("the first call of a stream starts from "
                                 "rest and is not compared")
            z = np.concatenate([
                self._host(seed, (g - 1) % blocks, rows, tail=prefix),
                self._host(seed, g % blocks, rows)], axis=1)
            ref = reference.audio(z, prefix=prefix, **kw)
            if self.controlled:
                got = reference.audio(z, prefix=prefix, tf32=True, **kw)
            else:
                got = out[rows].double().cpu().numpy()
            err = ((got - ref) ** 2).sum(axis=2)
            norm = (ref ** 2).sum(axis=2)
            worst = max(worst, worst_row(err, norm))
            compared += len(rows)
        return {"numbers": {NUMBER: worst}, "compared": compared}

    def rows(self, seed: int, last: bool) -> list:
        if last:
            return list(range(self.streams))
        return draw(seed, "bank rows", self.streams,
                    self.params["sampled_rows"])


@contextlib.contextmanager
def control(system: System):
    """The reference computed in TF32 (every product's operands rounded to
    a 10-bit significand, float32 sums) in the program's place: the check
    judges its audio where it would judge the program's."""
    system.controlled = True
    try:
        yield
    finally:
        system.controlled = False
