"""The north-star chain as the benchmark drives it.

On one card the port's ``NorthStarChain`` takes each call pre-framed as
(C, F, n1, n2), the layout ``frame_input`` gives, and carries its IIR state
from call to call.  Over a mesh the port's ``ShardedNorthStarChain`` takes
each rank's time shard as a ``DTensor``; the state entering each shard
crosses the ranks in one all_gather and one all_reduce a call.

Inputs are standard normal float32 samples made on the card from the seed,
one generator seed a (block, shard), so that any rank can make any shard
again for the reference.  The check runs the float64 reference over the
call's samples and the samples just before them (``warm``), which sets the
state entering the call, and takes the worst relative RMS error of a
channel's spectra.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from dspbench.harness import worst_row
from dspbench.inputs import block_generator, draw

NUMBER = "spec_rel_err"


class System:
    """The chain of a configuration under a traffic mix, on ``device``, or
    on ``mesh`` (a (dp, sp) mesh whose sp axis splits time)."""

    def __init__(self, params: dict, traffic: dict, device, mesh=None):
        from simpledsp_tpu_torch.design.biquad import design_lowpass
        from simpledsp_tpu_torch.models.northstar import (
            NorthStarChain, ShardedNorthStarChain)

        self.params, self.device, self.mesh = params, device, mesh
        self.channels = params["channels"]
        self.fft_size = params["fft_size"]
        design = design_lowpass(params["sections"], params["cutoff_hz"],
                                params["fs"])
        kw = dict(fft_size=self.fft_size, block_size=params["block_size"],
                  dtype=torch.float32, use_kernel=True)
        if mesh is None:
            self.shards, self.shard = 1, 0
            self.model = NorthStarChain(design, device=device, **kw)
        else:
            dim = mesh.mesh_dim_names.index("sp")
            self.shards = mesh.size(dim)
            self.shard = mesh.get_coordinate()[dim]
            self.model = ShardedNorthStarChain(mesh, design, **kw)
        self.samples = traffic["samples_per_call"] // self.shards
        self.samples_per_call = self.channels * self.samples
        self.warm = params["warm_samples"]

    # -- inputs ----------------------------------------------------------
    def block(self, seed: int, block: int, shard: int) -> torch.Tensor:
        """(C, T_shard) float32 samples of one block's shard, on the card."""
        gen = block_generator(self.device, seed, block, shard)
        return torch.randn((self.channels, self.samples), generator=gen,
                           device=self.device, dtype=torch.float32)

    def pool(self, seed: int, blocks: int) -> list:
        """Each block's input for this rank, in the form a call takes."""
        out = []
        for j in range(blocks):
            x = self.block(seed, j, self.shard)
            if self.mesh is None:
                ops = self.model.ops
                out.append(x.reshape(self.channels, -1, ops.n1, ops.n2))
            else:
                from simpledsp_tpu_torch.parallel.mesh import (SHARDED,
                                                               from_local)
                out.append(from_local(self.mesh, x, SHARDED))
        return out

    def init_state(self):
        from simpledsp_tpu_torch.ops.iir import iir_init
        return iir_init(self.params["sections"], (self.channels,),
                        dtype=torch.float32, device=self.device)

    def call(self, x, state):
        return self.model(x, state)

    def work(self) -> dict:
        from dspbench.roofline import chain_work
        m = self.params["sections"]
        return chain_work(self.channels, self.samples, self.fft_size, m,
                          2 * (m + 1))

    # -- the check -------------------------------------------------------
    def _host(self, seed, block, shard, rows, tail=None) -> np.ndarray:
        x = self.block(seed, block, shard)[rows]
        if tail is not None:
            x = x[:, x.shape[1] - tail:]
        return x.double().cpu().numpy()

    def check(self, seed: int, blocks: int, kept: list, reference) -> dict:
        """The worst relative RMS error of a channel's spectra over the kept
        calls.  ``kept`` holds (call index, output, rows) with the index
        counted from the stream's first call, call g on block g % blocks;
        the call before it ran on the previous block, and on this rank's
        shard the samples before it are the previous shard's."""
        p = self.params
        sos = reference.lowpass_sos(p["sections"], p["cutoff_hz"], p["fs"])
        worst, compared = 0.0, 0
        for g, out, rows in kept:
            if g < 1:
                raise ValueError("the first call of a stream starts from "
                                 "rest and is not compared")
            block = g % blocks
            if self.shard > 0:
                prev = (block, self.shard - 1)
            else:
                prev = ((g - 1) % blocks, self.shards - 1)
            warm = self._host(seed, *prev, rows, tail=self.warm)
            x = self._host(seed, block, self.shard, rows)
            ref_re, ref_im = reference.spectra(sos, x, self.fft_size, warm)
            got_re, got_im = (_local(t)[rows].double().cpu().numpy()
                              for t in out)
            err = ((got_re - ref_re) ** 2 + (got_im - ref_im) ** 2).sum(
                axis=(1, 2))
            norm = (ref_re ** 2 + ref_im ** 2).sum(axis=(1, 2))
            worst = max(worst, worst_row(err, norm))
            compared += len(rows)
        return {"numbers": {NUMBER: worst}, "compared": compared}

    def rows(self, seed: int, last: bool) -> list:
        """The channels compared in a kept call: all of them in the last
        call, a few drawn from the seed in another."""
        if last:
            return list(range(self.channels))
        return draw(seed, "chain rows", self.channels,
                    self.params["sampled_rows"])


def _local(t):
    return t.to_local() if hasattr(t, "to_local") else t


@contextlib.contextmanager
def control(system: System):
    """The program with every float32 matmul of its chain path in TF32
    (``allow_tf32``), the step below the IEEE float32 that the
    configuration states: the prepass products and the sharded state's
    closed form run on the tensor cores' 10-bit significand."""
    from simpledsp_tpu_torch.kernels import chain as kchain
    from simpledsp_tpu_torch.parallel import iir as piir

    @contextlib.contextmanager
    def tf32():
        prev = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        try:
            yield
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = prev

    saved = kchain.ieee_fp32, piir.ieee_fp32
    kchain.ieee_fp32 = piir.ieee_fp32 = tf32
    try:
        yield
    finally:
        kchain.ieee_fp32, piir.ieee_fp32 = saved
