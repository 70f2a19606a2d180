"""Entry points: the flagship forward step and the multi-device dry run.

Port of the JAX package's ``__graft_entry__.py``.

:func:`entry` returns the forward step of the flagship model (the
north-star chain: 8-SOS Butterworth IIR -> framed 4096-point FFT) and its
example arguments, on the card.

:func:`dryrun_multichip` builds an n-rank (dp, sp) mesh, one process a
device, runs the sharded pipeline's eleven steps on it at small shapes and
checks each against the serial op: the chain (composable and fused), the
halo FIR, the channelizer, the receiver bank, MFCCs, the radar, the
centred convolution, the STFT, the modem, the overlap-save filter and 2-D
convolution.  Unlike the JAX dry run, which swaps to a virtual CPU mesh
when devices are short, ``device=None`` needs n CUDA devices and raises
with fewer; ``device="cpu"`` runs the same steps in n gloo processes.

    python -m simpledsp_tpu_torch.entry          # entry() on the card
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from simpledsp_tpu_torch.device import resolve_device

__all__ = ["entry", "dryrun_multichip"]

# Seconds the dry run's ranks may take, all together.
RANK_TIMEOUT = 600


def entry():
    """(fn, example_args): the flagship forward step on the card."""
    from simpledsp_tpu_torch.models.northstar import NorthStarChain
    from simpledsp_tpu_torch.ops.iir import iir_init

    chain = NorthStarChain(fft_size=4096, block_size=256,
                           dtype=torch.float32)
    c, t = 4, 16384
    x = torch.as_tensor(np.random.default_rng(0).standard_normal((c, t)),
                        dtype=torch.float32, device=chain.device)
    state = iir_init(chain.design.nsections, (c,), dtype=torch.float32,
                     device=chain.device)
    return chain.forward, (x, state)


def _mesh_shape(n: int):
    dp = 2 if n % 2 == 0 and n > 1 else 1
    return dp, n // dp


def dryrun_multichip(n_devices: int, device=None) -> str:
    """One sharded pipeline step over an n_devices mesh (small shapes),
    each step checked against its serial op; prints and returns the
    one-line summary.  ``device=None`` means CUDA: n_devices cards, one
    rank each (in this process for one card); ``device="cpu"`` runs
    n_devices gloo ranks.  Raises if a step fails or a rank does."""
    device = resolve_device(device)
    if device.type == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(
            f"need {n_devices} CUDA devices, found "
            f"{torch.cuda.device_count()}; pass device='cpu' to run "
            f"{n_devices} gloo ranks on the CPU")
    if n_devices == 1:
        from simpledsp_tpu_torch.parallel.mesh import single_device_mesh
        started = not dist.is_initialized()
        try:
            summary = _dryrun(single_device_mesh(device))
        finally:
            if started:
                dist.destroy_process_group()
        print(summary)
        return summary
    return _run_ranks(n_devices, device)


def _run_ranks(n: int, device: torch.device) -> str:
    """Start n ranks of ``python -m simpledsp_tpu_torch.entry --rank``,
    rendezvous through a file store, wait for all; returns rank 0's
    summary.  Leftover ranks are killed."""
    root = str(Path(__file__).resolve().parents[1])
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = []
        try:
            for rank in range(n):
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "simpledsp_tpu_torch.entry",
                     "--rank", str(rank), "--world", str(n), "--store",
                     store, "--device", device.type],
                    env=dict(env, LOCAL_RANK=str(rank)),
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True))
            outs = [p.communicate(timeout=RANK_TIMEOUT)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    failed = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
    if failed:
        rank = failed[0][0]
        raise RuntimeError(f"dry run ranks {failed} failed; rank {rank}:\n"
                           f"{outs[rank][-4000:]}")
    summary = [ln for ln in outs[0].splitlines()
               if ln.startswith("dryrun_multichip OK")]
    if not summary:
        raise RuntimeError(f"rank 0 printed no summary:\n{outs[0][-4000:]}")
    print(summary[-1])
    return summary[-1]


def _rank_main(rank: int, world: int, store: str, device_type: str) -> None:
    """One rank of the dry run: join the group, run the steps, leave."""
    from simpledsp_tpu_torch.parallel.mesh import backend, make_mesh
    if device_type == "cpu":
        torch.set_num_threads(1)
    dist.init_process_group(backend(torch.device(device_type)),
                            init_method=f"file://{store}", rank=rank,
                            world_size=world)
    try:
        summary = _dryrun(make_mesh(*_mesh_shape(world), device_type))
        if rank == 0:
            print(summary, flush=True)
    finally:
        dist.destroy_process_group()


def _close(got, ref, rel: float, what: str) -> float:
    """max |got - ref| (got a DTensor or tensor), which must be below
    rel * max(|ref|, 1); returns it."""
    got = got.full_tensor() if hasattr(got, "full_tensor") else got
    dev = float((got.double() - ref.double()).abs().max())
    scale = max(float(ref.double().abs().max()), 1.0)
    if not dev < rel * scale:
        raise AssertionError(f"{what}: sharded != serial, dev {dev:.3e}, "
                             f"scale {scale:.3e}")
    return dev


def _dryrun(mesh) -> str:
    """The eleven steps on ``mesh``; returns the summary line."""
    from simpledsp_tpu_torch.design.fir import lowpass_taps
    from simpledsp_tpu_torch.models.audio import mfcc
    from simpledsp_tpu_torch.models.comms import Constellation, LinearModem
    from simpledsp_tpu_torch.models.northstar import (NorthStarChain,
                                                      ShardedNorthStarChain)
    from simpledsp_tpu_torch.models.radar import (cfar_ca, lfm_chirp,
                                                  range_doppler_map)
    from simpledsp_tpu_torch.models.sdr import FMReceiverBank
    from simpledsp_tpu_torch.ops.conv import convolve
    from simpledsp_tpu_torch.ops.conv2d import convolve2d
    from simpledsp_tpu_torch.ops.fir import FIRFilter, OverlapSaveFIR
    from simpledsp_tpu_torch.ops.spectral import stft_ri
    from simpledsp_tpu_torch.parallel import (ShardedChannelizer,
                                              ShardedConvolve, ShardedFIR,
                                              ShardedOverlapSaveFIR,
                                              ShardedReceiverBank,
                                              ShardedSTFT)
    from simpledsp_tpu_torch.parallel.mesh import (ROWS, from_local,
                                                   local_part, mesh_device)

    dp, sp = mesh["dp"].size(), mesh["sp"].size()
    dev = mesh_device(mesh)
    f32 = torch.float32

    def noise(seed, shape):
        return torch.as_tensor(np.random.default_rng(seed).standard_normal(
            shape), dtype=f32, device=dev)

    def rows(fn, *args):
        """``fn`` on this rank's rows of each argument (data parallel over
        dp), as a DTensor placed on dp."""
        return from_local(mesh, fn(*(local_part(mesh, a, ROWS)
                                     for a in args)), ROWS)

    # 1. Flagship chain: sequence-parallel IIR + local framed FFT, and the
    # state handed across two sharded calls.
    fft_size, block = 16, 8
    c, t = 2 * dp, 2 * fft_size * sp
    x = noise(1, (c, t))
    chain = ShardedNorthStarChain(mesh, fft_size=fft_size, block_size=block)
    serial = NorthStarChain(fft_size=fft_size, block_size=block, device=dev,
                            use_kernel=False)
    (sr, _), state = chain(x)
    (sr2, _), state = chain(x, state)
    (gr, _), gstate = serial(x)
    (gr2, _), gstate = serial(x, gstate)
    _close(sr, gr, 5e-4, "chain")
    _close(sr2, gr2, 5e-4, "chain, second call")

    # 1b. The fused path, the per-shard chain kernel (its plain version on
    # the CPU), against the serial composable chain.
    fused = ShardedNorthStarChain(mesh, fft_size=4096, block_size=256,
                                  use_kernel=True)
    serial = NorthStarChain(fft_size=4096, block_size=256, device=dev,
                            use_kernel=False)
    xf = noise(11, (2 * dp, 4096 * sp))
    (fr, _), fstate = fused(xf)
    (gr, _), gstate = serial(xf)
    fdev = _close(fr, gr, 5e-4, "fused chain")
    _close(fstate.y_hist, gstate.y_hist, 5e-4, "fused chain state")

    # 2. Halo-exchange FIR (ring shift over sp), streaming over two calls.
    taps = lowpass_taps(17, 0.2, fs=1.0)
    fir = ShardedFIR(taps, mesh)
    y, fst = fir(x)
    y2, _ = fir(x, fst)
    serial_fir = FIRFilter(taps, device=dev)
    z, zst = serial_fir(x)
    z2, _ = serial_fir(x, zst)
    _close(y, z, 1e-5, "FIR")
    _close(y2, z2, 1e-5, "FIR, second call")

    # 3. Sharded PFB channelizer (halo + local branch FIRs + FFT).
    ch = ShardedChannelizer(8, mesh, taps_per_channel=4)
    xc = x.to(torch.complex64)
    iq, _ = ch(xc)
    ref_iq, _ = ch.pfb(xc)
    _close(torch.view_as_real(iq.full_tensor()), torch.view_as_real(ref_iq),
           1e-5, "channelizer")

    # 4. dp-sharded FM receiver bank, streaming over two calls.
    bank = FMReceiverBank(8, fs=1.6e6, decim=2, taps_per_channel=4,
                          audio_taps=8, device=dev)
    sbank = ShardedReceiverBank(bank, mesh)
    xb = noise(2, (2, 2 * dp, 128))
    audio, bstate = sbank((xb[0], xb[1]))
    audio2, _ = sbank((xb[0], xb[1]), bstate)
    ref_a, rstate = bank((xb[0], xb[1]))
    ref_a2, _ = bank((xb[0], xb[1]), rstate)
    _close(audio, ref_a, 1e-5, "receiver bank")
    _close(audio2, ref_a2, 1e-5, "receiver bank, second call")

    # 5. dp-sharded MFCCs (replicated tables).
    xa = noise(3, (2 * dp, 64))

    def feats_of(a):
        return mfcc(a, 4, nfft=16, hop=8, n_mels=8, fs=1000.0)

    feats = rows(feats_of, xa)
    _close(feats, feats_of(xa), 1e-5, "mfcc")

    # 6. dp-sharded radar: matched filter -> Doppler FFT -> CA-CFAR.
    tx = lfm_chirp(8, 0.8)
    xr_r, xi_r = noise(4, (2 * dp, 8, 64)), noise(40, (2 * dp, 8, 64))
    rdm = rows(lambda a, b: range_doppler_map(a, b, *tx), xr_r, xi_r)
    _close(rdm, range_doppler_map(xr_r, xi_r, *tx), 1e-5, "radar map")
    det = rows(lambda p: cfar_ca(p, guard=1, train=4, pfa=1e-3)[0],
               rdm.full_tensor())

    # 7. sp-sharded centred convolution (left halo + centring shift).
    yc = ShardedConvolve(taps, mesh)(x)
    _close(yc, convolve(x, taps, mode="same"), 1e-5, "convolve")

    # 8. sp-sharded STFT (right-neighbour look-ahead, frames over sp).
    st_r, st_i = ShardedSTFT(mesh, nfft=16, hop=8)(x)
    ref_r, ref_i = stft_ri(x, 16, hop=8)
    _close(st_r, ref_r, 1e-5, "stft re")
    _close(st_i, ref_i, 1e-5, "stft im")

    # 9. dp-sharded modem: TX -> matched RX, the loopback exact.
    modem = LinearModem(Constellation.qpsk(), sps=4, span=4, beta=0.35,
                        device=dev)
    bits = torch.as_tensor(np.random.default_rng(5).integers(
        0, 2, (2 * dp, 64)), dtype=torch.int32, device=dev)
    txr = rows(lambda b: modem.modulate(b)[0], bits)
    rx_bits = rows(lambda b: modem.demodulate(*modem.modulate(b))[0], bits)
    got = rx_bits.full_tensor()
    if not torch.equal(got, bits[:, :got.shape[-1]].to(got.dtype)):
        raise AssertionError("sharded modem loopback mismatch")

    # 10. sp-sharded overlap-save FIR, streaming over two calls.
    taps65 = lowpass_taps(65, 0.11, fs=1.0)
    x_ols = noise(12, (2 * dp, 1024 * sp))
    sols = ShardedOverlapSaveFIR(taps65, mesh, block_size=1024)
    y_sh, ols_state = sols(x_ols)
    y_sh2, _ = sols(x_ols, ols_state)
    serial_ols = OverlapSaveFIR(taps65, block_size=1024, device=dev)
    y_se, se_state = serial_ols(x_ols)
    y_se2, _ = serial_ols(x_ols, se_state)
    _close(y_sh, y_se, 1e-5, "overlap-save")
    _close(y_sh2, y_se2, 1e-5, "overlap-save, second call")

    # 11. dp-sharded batched 2-D convolution.
    ker = np.random.default_rng(13).standard_normal((5, 5)).astype(
        np.float32)
    img = noise(14, (2 * dp, 24, 24))
    y2d = rows(lambda a: convolve2d(a, ker, "same"), img)
    _close(y2d, convolve2d(img, ker, "same"), 1e-5, "conv2d")

    def shape(a):
        return tuple(a.shape)

    return (f"dryrun_multichip OK: mesh=({dp},{sp}) {dev.type} "
            f"chain={shape(sr)} fused=({shape(fr)},dev={fdev:.1e}) "
            f"fir={shape(y)} chan={shape(iq)} bank={shape(audio)} "
            f"mfcc={shape(feats)} radar={shape(det)} conv={shape(yc)} "
            f"stft={shape(st_r)} modem={shape(txr)} ols={shape(y_sh)} "
            f"conv2d={shape(y2d)}")


def _main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m simpledsp_tpu_torch.entry",
        description="Run entry() on the card and print its output shapes "
                    "(with --rank: one rank of dryrun_multichip).")
    parser.add_argument("--rank", type=int)
    parser.add_argument("--world", type=int)
    parser.add_argument("--store")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    if args.rank is not None:
        _rank_main(args.rank, args.world, args.store, args.device)
        return 0
    fn, fargs = entry()
    (sr, si), state = fn(*fargs)
    torch.cuda.synchronize()
    print("entry OK:", tuple(sr.shape), tuple(si.shape),
          tuple(state.y_hist.shape))
    return 0


if __name__ == "__main__":
    sys.exit(_main())
