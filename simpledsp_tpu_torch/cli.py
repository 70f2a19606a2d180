"""Command-line SDR front end: file-based receive chains on the card.

    python -m simpledsp_tpu_torch fm-rx  --input capture.iq --format iq16 \
        --rate 1.024e6 --channels 16 --decim 4 --output audio.npz
    python -m simpledsp_tpu_torch am-rx  --input capture.iq ... --output audio.npz
    python -m simpledsp_tpu_torch spectra --input capture.f32 --fft 4096 \
        --design lp:2000 --rate 39000 --output spectra.npz
    python -m simpledsp_tpu_torch mfcc --input speech.pcm --rate 16000 \
        --output features.npz
    python -m simpledsp_tpu_torch modem-sim --constellation qpsk --ebn0 0:10:2
    python -m simpledsp_tpu_torch bench

Ingest runs through the native streaming runtime (ring buffer, background
file reader and IQ converters, simpledsp_tpu_torch/runtime); DSP runs on
CUDA.  Every command takes --device; without a card, a command exits with
status 2 unless it is given --device cpu: it never moves to the CPU on its
own.  A size the CUDA kernel does not take (``spectra --fft 32768``,
``fm-rx --channels 12``) runs the plain PyTorch route on the same device,
which the command says in one line on stderr (``chain_route``,
``bank_route``).  Outputs are .npz files with the keys of the JAX package's CLI, and
the carried state is saved beside them in the JAX package's checkpoint
format, so a follow-up run of either package can resume the stream.
"""

from __future__ import annotations

import argparse
import sys
import time
from collections import deque

import numpy as np

_POLL = 0.0005  # seconds between looks at the ring while a block fills


def _positive_int(text: str) -> int:
    value = int(text)
    if value < 1:
        raise argparse.ArgumentTypeError(f"must be at least 1, got {value}")
    return value


def _raw_blocks(path: str, nbytes: int):
    """Yield consecutive ``nbytes`` blocks (uint8) of the file at ``path``,
    read ahead by the native source thread into a ring that holds two
    blocks.  A partial tail is dropped.  Ends as soon as the source has
    stopped and the ring holds less than a block; raises OSError when the
    source failed."""
    from simpledsp_tpu_torch.runtime import FileSource, RingBuffer

    ring = RingBuffer(max(1 << 22, 2 * nbytes))
    try:
        with FileSource(path, ring, chunk=1 << 16) as src:
            while True:
                # Read the state first: a source that has stopped pushes
                # nothing more, so the ring then holds all that is left.
                state = src.state
                if state == src.ERROR:
                    raise OSError(f"reading {path} failed")
                if ring.readable < nbytes and state == src.RUNNING:
                    time.sleep(_POLL)
                    continue
                raw = ring.pop_exact(nbytes, timeout=0.0)
                if raw is None:
                    return
                yield raw
    finally:
        ring.close()


def _ingest_blocks(path: str, fmt: str, block_pairs: int):
    """Yield (re, im) float32 plane blocks of ``block_pairs`` samples from
    an IQ capture (or real float32 samples, with a zero imaginary plane)."""
    from simpledsp_tpu_torch.runtime import iq16_to_planes, iqu8_to_planes

    itemsize = {"iq16": 4, "iqu8": 2, "f32": 4}[fmt]
    for raw in _raw_blocks(path, block_pairs * itemsize):
        if fmt == "iq16":
            yield iq16_to_planes(raw.view(np.int16))
        elif fmt == "iqu8":
            yield iqu8_to_planes(raw)
        else:  # real f32
            x = raw.view(np.float32)
            yield x, np.zeros_like(x)


def chain_route(fft_size: int, device) -> str:
    """The spectra chain's route for ``fft_size`` on ``device``: "kernel"
    where the CUDA chain kernel takes the size (a split fft_size = n1 n2
    with n1, n2 <= 128 and n2 even), else "plain", the composable path on
    the same device.  The CPU always takes "plain"."""
    import torch

    from simpledsp_tpu_torch.kernels.chain import kernel_supports
    from simpledsp_tpu_torch.kernels.fft import _best_split

    if torch.device(device).type != "cuda":
        return "plain"
    split = _best_split(int(fft_size))
    return "kernel" if split and kernel_supports(*split) else "plain"


def bank_route(channels: int, taps_per_channel: int, device) -> str:
    """The receiver bank's route on ``device``: "kernel" where the CUDA
    PFB kernel takes (M, K) = (``channels``, ``taps_per_channel``), M | 128
    and K <= 32, else "plain", the composable path on the same device.
    The CPU always takes "plain"."""
    import torch

    from simpledsp_tpu_torch.kernels.pfb import kernel_supports

    if torch.device(device).type != "cuda":
        return "plain"
    return "kernel" if kernel_supports(int(channels),
                                       int(taps_per_channel)) else "plain"


def _say_plain(cmd: str, size: str, why: str, dev) -> None:
    print(f"{cmd}: {size}: {why}; running the plain PyTorch route on {dev}",
          file=sys.stderr)


def _state_path(args) -> str:
    return args.save_state or (args.output + ".state.npz")


def _resume_state(args, prototype):
    """The carried state saved at ``--state``, or None for a fresh stream.
    ``prototype()`` gives a state of the right structure, shapes, device
    and dtype, whose values the saved ones replace."""
    if not args.state:
        return None
    from simpledsp_tpu_torch.utils.checkpoint import load_state
    return load_state(args.state, prototype())


def _cmd_rx(args, mode: str, dev) -> int:
    import torch

    from simpledsp_tpu_torch.models.sdr import AMReceiverBank, FMReceiverBank
    from simpledsp_tpu_torch.utils.checkpoint import save_state

    taps = 16      # the banks' taps_per_channel, which the CLI keeps
    route = bank_route(args.channels, taps, dev)
    if route == "plain" and dev.type == "cuda":
        _say_plain(f"{mode}-rx", f"--channels {args.channels}",
                   f"the CUDA PFB kernel takes M | 128 channels and at most "
                   f"32 taps per channel (here {taps})", dev)
    kw = dict(decim=args.decim, taps_per_channel=taps, device=dev,
              use_kernel=route == "kernel")
    if mode == "fm":
        rx = FMReceiverBank(args.channels, args.rate,
                            deviation_hz=args.deviation, **kw)
    else:
        rx = AMReceiverBank(args.channels, args.rate, **kw)
    block = args.channels * args.decim * args.block_frames

    # On the kernel path each block is uploaded at offset `front` of a
    # padded buffer (the tail is never read) and the bank writes the carried
    # history into the buffer's front in place (process_padded): no prefixed
    # copy of the stream on the device.
    pad_spec = rx.padded_spec(block) if rx.use_kernel else None

    def run_block(re, im, state):
        if pad_spec is None:
            return rx((re[None, :], im[None, :]), state)
        front, total = pad_spec
        buf = np.empty((2, total), np.float32)
        buf[0, front:front + block] = re
        buf[1, front:front + block] = im
        planes = torch.from_numpy(buf).to(dev)
        a, state, _ = rx.process_padded((planes[0:1], planes[1:2]), state)
        return a, state

    state = _resume_state(args, lambda: rx.init_state(1))
    audio = []
    t0 = time.time()
    nsamp = 0
    # Keep two blocks in flight: launches return at once, so fetching block
    # i-2 while the card works on block i overlaps ingest, conversion,
    # upload and download with compute.
    pending: "deque" = deque()
    for re, im in _ingest_blocks(args.input, args.format, block):
        a, state = run_block(re, im, state)
        pending.append(a)
        nsamp += re.size
        if len(pending) > 2:
            audio.append(pending.popleft()[0].cpu().numpy())
    while pending:
        audio.append(pending.popleft()[0].cpu().numpy())
    if not audio:
        print("no complete blocks read", file=sys.stderr)
        return 1
    out = np.concatenate(audio, axis=-1)  # (channels, T_audio)
    np.savez(args.output, audio=out,
             rate=args.rate / args.channels / args.decim,
             channels=args.channels)
    save_state(_state_path(args), state)
    dt = time.time() - t0
    print(f"{mode.upper()} rx: {nsamp} samples -> {out.shape} audio "
          f"({nsamp/dt/1e6:.1f} Msamples/s wall)")
    return 0


def _cmd_spectra(args, dev) -> int:
    from simpledsp_tpu_torch.design.biquad import (
        design_bandpass, design_highpass, design_lowpass)
    from simpledsp_tpu_torch.models.northstar import NorthStarChain
    from simpledsp_tpu_torch.ops.iir import iir_init
    from simpledsp_tpu_torch.utils.checkpoint import save_state

    kind, _, param = args.design.partition(":")
    designers = {"lp": design_lowpass, "hp": design_highpass,
                 "bp": lambda m, f0, fs: design_bandpass(m, f0, fs, args.q)}
    try:
        f0 = float(param)
        designer = designers[kind]
    except (KeyError, ValueError):
        print(f"unknown design {args.design!r} (use lp:F0|hp:F0|bp:F0)",
              file=sys.stderr)
        return 2
    design = designer(args.order // 2, f0, args.rate)
    route = chain_route(args.fft, dev)
    if route == "plain" and dev.type == "cuda":
        _say_plain("spectra", f"--fft {args.fft}",
                   "the CUDA chain kernel takes fft = n1 x n2 with n1, n2 <= "
                   "128 and n2 even", dev)
    chain = NorthStarChain(design=design, fft_size=args.fft, device=dev,
                           use_kernel=route == "kernel")
    block = args.fft * args.block_frames

    state = _resume_state(
        args, lambda: iir_init(design.nsections, (1,), device=dev))
    frames = 0
    sr_acc = []
    si_acc = []
    t0 = time.time()
    pending: "deque" = deque()
    # frame_input uploads each block in the kernel's framed view when the
    # chain runs the kernel: the host reshape is free and the device skips
    # a re-tiling copy.  The input is real float32 whatever --format says,
    # as in the JAX CLI.
    for raw in _raw_blocks(args.input, 4 * block):
        x = raw.view(np.float32)
        (sr, si), state = chain(chain.frame_input(x[None, :]), state)
        pending.append((sr, si))
        frames += sr.shape[1]
        if len(pending) > 2:
            pr, pi = pending.popleft()
            sr_acc.append(pr[0].cpu().numpy())
            si_acc.append(pi[0].cpu().numpy())
    while pending:
        pr, pi = pending.popleft()
        sr_acc.append(pr[0].cpu().numpy())
        si_acc.append(pi[0].cpu().numpy())
    if not sr_acc:
        print("no complete blocks read", file=sys.stderr)
        return 1
    np.savez(args.output, spec_re=np.concatenate(sr_acc, axis=0),
             spec_im=np.concatenate(si_acc, axis=0), fft=args.fft,
             rate=args.rate)
    save_state(_state_path(args), state)
    dt = time.time() - t0
    print(f"spectra: {frames} frames of {args.fft} "
          f"({frames*args.fft/dt/1e6:.1f} Msamples/s wall)")
    return 0


def _cmd_mfcc(args, dev) -> int:
    """Streaming MFCC features from a PCM file (int16 or float32 mono)."""
    import torch

    from simpledsp_tpu_torch.models.audio import mfcc
    from simpledsp_tpu_torch.runtime import i16_to_f32

    nfft, hop = args.fft, args.hop or args.fft // 2
    if nfft % hop:
        print(f"--hop must divide --fft (got {hop}, {nfft})",
              file=sys.stderr)
        return 2
    block = hop * args.block_frames
    overlap = nfft - hop
    itemsize = 2 if args.format == "i16" else 4
    hist = np.zeros(overlap, dtype=np.float32)

    feats = []
    t0 = time.time()
    nsamp = 0
    pending: "deque" = deque()
    for raw in _raw_blocks(args.input, block * itemsize):
        x = (i16_to_f32(raw.view(np.int16)) if args.format == "i16"
             else raw.view(np.float32))
        xb = np.concatenate([hist, x])
        hist = xb[-overlap:] if overlap else hist
        pending.append(mfcc(torch.from_numpy(xb[None, :]).to(dev),
                            args.coeffs, nfft=nfft, hop=hop,
                            n_mels=args.mels, fs=args.rate))
        nsamp += x.size
        if len(pending) > 2:
            feats.append(pending.popleft()[0].cpu().numpy())
    while pending:
        feats.append(pending.popleft()[0].cpu().numpy())
    if not feats:
        print("no complete blocks read", file=sys.stderr)
        return 1
    out = np.concatenate(feats, axis=0)  # (nframes, n_mfcc)
    np.savez(args.output, mfcc=out, rate=args.rate, fft=nfft, hop=hop,
             mels=args.mels)
    dt = time.time() - t0
    print(f"mfcc: {nsamp} samples -> {out.shape} features "
          f"({nsamp/dt/1e6:.1f} Msamples/s wall)")
    return 0


def _cmd_modem_sim(args, dev) -> int:
    """Self-contained BER simulation: bits -> RRC TX -> AWGN -> matched
    RX -> BER, one JSON line per Eb/N0 point.  The noise is drawn from the
    seed by torch, so it has the JAX package's statistics, not its bits."""
    import json

    import torch

    from simpledsp_tpu_torch.models.comms import (Constellation, LinearModem,
                                                  awgn, ber)

    const = {"bpsk": Constellation.bpsk, "qpsk": Constellation.qpsk,
             "qam16": lambda: Constellation.qam(16),
             "qam64": lambda: Constellation.qam(64)}[args.constellation]()
    modem = LinearModem(const, sps=args.sps, span=args.span,
                        beta=args.beta, device=dev)
    k = const.bits_per_symbol
    rng = np.random.default_rng(args.seed)
    bits = torch.as_tensor(rng.integers(0, 2, (args.symbols * k,)),
                           device=dev)
    xr, xi = modem.modulate(bits)
    n_ok = (args.symbols - modem.delay_symbols) * k
    records = []
    lo, hi, step = (float(v) for v in args.ebn0.split(":"))
    for i, ebn0 in enumerate(np.arange(lo, hi + 1e-9, step)):
        snr_db = (ebn0 + 10.0 * np.log10(k)
                  - 10.0 * np.log10(modem.sps))
        yr, yi = awgn(args.seed + i + 1, (xr, xi), float(snr_db),
                      signal_power=1.0)
        rx, _ = modem.demodulate(yr, yi)
        measured = float(ber(bits[:n_ok], rx[:n_ok]))
        rec = {"constellation": const.name, "ebn0_db": round(float(ebn0), 3),
               "ber": measured, "bits": n_ok}
        records.append(rec)
        print(json.dumps(rec))
    if args.output:
        np.savez(args.output,
                 ebn0_db=np.asarray([r["ebn0_db"] for r in records]),
                 ber=np.asarray([r["ber"] for r in records]),
                 constellation=const.name, bits_per_point=n_ok)
    return 0


def build_parser() -> argparse.ArgumentParser:
    """The parser of :func:`main`: the JAX package's commands and options,
    each command with ``--device``."""
    p = argparse.ArgumentParser(prog="simpledsp_tpu_torch",
                                description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    def device(sp):
        sp.add_argument("--device", default=None,
                        help="torch device (default: cuda; there is no "
                             "fallback: pass cpu to run on the CPU)")

    def common(sp, iq=True):
        sp.add_argument("--input", required=True)
        sp.add_argument("--output", required=True)
        sp.add_argument("--rate", type=float, required=True)
        sp.add_argument("--format", choices=["iq16", "iqu8", "f32"],
                        default="iq16" if iq else "f32")
        sp.add_argument("--block-frames", type=_positive_int, default=1024)
        sp.add_argument("--state", default=None,
                        help="resume from a carried-state .npz saved by a "
                             "previous run")
        sp.add_argument("--save-state", default=None,
                        help="where to save the final carried state "
                             "(default: <output>.state.npz)")
        device(sp)

    for mode in ("fm", "am"):
        sp = sub.add_parser(f"{mode}-rx", help=f"{mode.upper()} receiver bank")
        common(sp)
        sp.add_argument("--channels", type=int, default=16)
        sp.add_argument("--decim", type=int, default=4)
        if mode == "fm":
            sp.add_argument("--deviation", type=float, default=75e3)

    sp = sub.add_parser("spectra", help="IIR -> framed FFT chain")
    common(sp, iq=False)
    sp.add_argument("--fft", type=int, default=4096)
    sp.add_argument("--design", default="lp:2000")
    sp.add_argument("--order", type=int, default=8)
    sp.add_argument("--q", type=float, default=1.0)

    sp = sub.add_parser("mfcc", help="streaming MFCC audio features")
    sp.add_argument("--input", required=True)
    sp.add_argument("--output", required=True)
    sp.add_argument("--rate", type=float, required=True)
    sp.add_argument("--format", choices=["i16", "f32"], default="i16")
    sp.add_argument("--fft", type=int, default=512)
    sp.add_argument("--hop", type=int, default=None)
    sp.add_argument("--mels", type=int, default=64)
    sp.add_argument("--coeffs", type=int, default=13)
    sp.add_argument("--block-frames", type=_positive_int, default=256,
                    help="hop-frames per device call")
    device(sp)

    sp = sub.add_parser("bench", help="run the headline benchmark")
    device(sp)

    sp = sub.add_parser("modem-sim", help="digital modem BER simulation "
                                          "(TX -> AWGN -> matched RX)")
    sp.add_argument("--constellation",
                    choices=["bpsk", "qpsk", "qam16", "qam64"],
                    default="qpsk")
    sp.add_argument("--ebn0", default="0:10:2",
                    help="Eb/N0 sweep lo:hi:step in dB")
    sp.add_argument("--symbols", type=int, default=20000)
    sp.add_argument("--sps", type=int, default=4)
    sp.add_argument("--span", type=int, default=12)
    sp.add_argument("--beta", type=float, default=0.3)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--output", default=None,
                    help="optional .npz with the sweep arrays")
    device(sp)
    return p


def main(argv=None) -> int:
    p = build_parser()
    args = p.parse_args(argv)
    from simpledsp_tpu_torch.device import resolve_device
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(f"{p.prog} {args.cmd}: {e} (on the command line: --device cpu)",
              file=sys.stderr)
        return 2
    if args.cmd == "fm-rx":
        return _cmd_rx(args, "fm", dev)
    if args.cmd == "am-rx":
        return _cmd_rx(args, "am", dev)
    if args.cmd == "spectra":
        return _cmd_spectra(args, dev)
    if args.cmd == "mfcc":
        return _cmd_mfcc(args, dev)
    if args.cmd == "bench":
        from simpledsp_tpu_torch import bench
        bench.main(device=dev)
        return 0
    return _cmd_modem_sim(args, dev)


if __name__ == "__main__":
    raise SystemExit(main())
