"""Smoke run of the PyTorch port on one NVIDIA GPU: builds the CUDA kernels,
checks each against its plain version, drives the north-star chain and
both SDR receiver banks end to end, and times them.

    python3 chip_smoke.py

Phases (any failure exits nonzero before the result line):

1. Device: a CUDA device is required; prints the card's name and power limit.
2. Build: compiles ``simpledsp_tpu_torch/csrc/chain.cu`` and ``pfb.cu`` into
   ``build/``, one nvcc for each, started together.
3. Chain kernel against its plain version at N = 1024, 2048, 4096, 16384
   and at the smaller splits N = 200, 256, 512, 768, 1152, on the frames
   and sub-block starts that 64 x 2^20 samples of noise give: >= 130 dB SNR
   against ``chain_frames_reference`` evaluated in float64 on the same
   float32 inputs and tables.
4. Chain main path: ``NorthStarChain(fft_size=4096, device="cuda")`` on
   64 x 2^20 float32 samples per call, 4 calls with the state chained, with
   TF32 enabled by the caller (the chain must not use it).  The kernel must
   launch once per call; channels 0-1 of call 0 and the concatenated
   channel-0 spectra of calls 0-1 must hold >= 130 dB against the float64
   oracle (scipy sosfilt + numpy rfft).
5. Chain timing, each the median of 5 runs timed with CUDA events: the main
   path, the kernel against its plain version, the composable path
   (``use_kernel=False``) and ``torch.fft.rfft`` (cuFFT) as a baseline.
   Phases 6 and 9 time windows of 10 back-to-back calls (median of 5, or of
   3 for the plain versions), so a call's host work overlaps the previous
   call's device work as it does in a stream.
6. PFB kernels against their plain versions at the banks' shape (16 streams
   x 65,536 frames, M = K = 16, 64 audio taps, decim 4), on constant-envelope
   FM carriers with per-stream phases: every flat mode (fm, fm_dec, am,
   am_dec, am_dec + emit_sum) and every frames mode (fm, fm_dec, am, am_dec,
   chan), and fm_dec at M16/K32, M8/K16, M32/K16.  Bar per output: max |err|
   against the float64 plain version (same float32 inputs) <= max(1.5e-6
   max(1, scale), 2 x the float32 plain version's own max |err|).  Two tile
   sizes must give bitwise-equal outputs (the emit_sum totals excepted: they
   are held to the bar).  Kernel and float32 plain times.
7. Bank main path: ``FMReceiverBank(16, fs=1.6e6, device="cuda")`` and
   ``AMReceiverBank(...)`` (remove_dc) on 16 x 2^20 float32 I/Q per call, the
   carriers continued across 4 calls with the state chained, through
   ``__call__`` and then ``process_padded``.  The flat kernel launches once
   per call; streams 0-1 of every call hold the bar above against the same
   bank with ``use_kernel=False, dtype=float64`` chained over the same calls
   (the float32 plain error of the bar: the float32 composable bank);
   calls 0-1 equal that float64 bank run once over their concatenation (FM,
   and AM through the envelope path without DC removal: block-mean DC
   removal is per call by definition); the two entries give identical audio.
8. Bare channelizer path: ``PFBChannelizer.frames_t`` ->
   ``pfb_channelize_frames`` (the frames kernel) on one call's planes,
   against the float64 composable channelizer.
9. Bank timing: ms/call and Msamples/s through both entries, and the
   float32 composable bank.

The line before the last is a JSON object with the kernels' records; the
last line is ``{"ok": true, "device": {...}}``.
"""

import json
import subprocess
import sys
import threading
import time

import numpy as np
import torch

C, T = 64, 1 << 20          # chain: channels, samples per channel per call
SIZES = (1024, 2048, 4096, 16384, 200, 256, 512, 768, 1152)
MAIN_N = 4096
CALLS = 4
MIN_SNR_DB = 130.0
REPS = 5

B, M, K = 16, 16, 16        # banks: streams, channels, taps per channel
TB = 1 << 20                # banks: samples per stream per call
FS, DECIM, KD = 1.6e6, 4, 64
PFB_CONFIGS = ((16, 32), (8, 16), (32, 16))
BAR = 1.5e-6
STEADY = 10                 # bank-phase timings: calls per timed window


KERNELS = []                # every kernel wrapper with a launch count


def zero_counts() -> None:
    for kernel in KERNELS:
        kernel.launches = 0


def snr_db(ref, got) -> float:
    ref = np.asarray(ref, dtype=np.complex128)
    err = np.asarray(got, dtype=np.complex128) - ref
    return float(10 * np.log10((np.abs(ref) ** 2).sum()
                               / max((np.abs(err) ** 2).sum(), 1e-300)))


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def median_ms(fn, reps=REPS, per=1) -> float:
    """Median over ``reps`` CUDA-event timings of ``per`` back-to-back
    calls, in ms per call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / per)
    return float(np.median(times))


def oracle_packed(design, x64: np.ndarray, n: int) -> np.ndarray:
    """float64 scipy sosfilt + numpy rfft, packed to the chain's N/2 bins
    (X[N/2].re in the imaginary plane's bin 0)."""
    import scipy.signal as sig

    from simpledsp_tpu_torch.design.biquad import sos_matrix
    y = sig.sosfilt(sos_matrix(design), x64, axis=-1)
    full = np.fft.rfft(y.reshape(x64.shape[0], -1, n))
    packed = full[..., : n // 2].copy()
    packed[..., 0] += 1j * full[..., n // 2].real
    return packed


def leaves(t):
    if isinstance(t, (tuple, list)):
        return [u for v in t for u in leaves(v)]
    return [t]


def bar_check(got, ref64, ref32, what: str) -> float:
    """Every output within the bar; returns the largest max |err|."""
    worst = 0.0
    for i, (a, r, p) in enumerate(zip(leaves(got), leaves(ref64),
                                      leaves(ref32))):
        check(a.shape == r.shape, f"{what} output {i}: shape "
                                  f"{tuple(a.shape)} != {tuple(r.shape)}")
        check(bool(torch.isfinite(a).all()), f"{what} output {i} not finite")
        err = float((a.double() - r).abs().max())
        own = float((p.double() - r).abs().max())
        scale = float(r.abs().max())
        limit = max(BAR * max(1.0, scale), 2 * own)
        check(err <= limit, f"{what} output {i}: max |err| {err:.3e} > "
                            f"{limit:.3e} (scale {scale:.3e})")
        worst = max(worst, err)
    return worst


def carriers(b, m, t0, t, dev, seed=0):
    """Constant-envelope FM carriers, one per channel, samples [t0, t0 + t)
    of each stream, each stream with its own carrier phases (numpy seed
    ``seed``); built in float64 on the card, returned as float32 planes."""
    ph = torch.as_tensor(np.random.default_rng(seed).uniform(
        0.0, 2 * np.pi, (b, m)), device=dev)
    n = torch.arange(t0, t0 + t, dtype=torch.float64, device=dev)
    zr = torch.zeros(b, t, dtype=torch.float64, device=dev)
    zi = torch.zeros_like(zr)
    for c in range(m):
        ang = (2 * np.pi * ((c + 0.002) / m) * n
               + 2.0 * torch.sin(2 * np.pi * (0.2 + 0.03 * c) / 257.0 * n))
        ang = ang[None, :] + ph[:, c:c + 1]
        zr += torch.cos(ang)
        zi += torch.sin(ang)
    return zr.float(), zi.float()


# -- the chain ---------------------------------------------------------------

def chain_phases(dev, kchain, NorthStarChain, design):
    """Phases 3-5; returns the chain kernel's record."""
    # The prepass runs in IEEE float32 whatever the caller set: with TF32
    # enabled it gives the same starts bit for bit, and the flag survives.
    ops = kchain.FusedNorthStarOperators(design, MAIN_N, device=dev)
    xp = torch.as_tensor(np.random.default_rng(2).standard_normal(
        (4, 64 * MAIN_N), dtype=np.float32), device=dev)
    sp = torch.zeros(4, ops.state_dim, device=dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    ieee = kchain.chain_prepass(ops, xp, sp)
    torch.backends.cuda.matmul.allow_tf32 = True
    with_tf32 = kchain.chain_prepass(ops, xp, sp)
    check(torch.backends.cuda.matmul.allow_tf32, "allow_tf32 not restored")
    torch.backends.cuda.matmul.allow_tf32 = False
    check(all(torch.equal(a, b) for a, b in zip(ieee, with_tf32)),
          "the prepass result depends on the caller's allow_tf32")
    print("prepass: IEEE float32 with the caller's allow_tf32 = True")

    # -- 3. kernel against its plain version ----------------------------
    rng = np.random.default_rng(1)
    x_noise = torch.as_tensor(rng.standard_normal((C, T), dtype=np.float32),
                              device=dev)
    per_size = {}
    for n in SIZES:
        ops = kchain.FusedNorthStarOperators(design, n, device=dev)
        s0 = torch.zeros(C, ops.state_dim, device=dev)
        x3, s3, _ = kchain.chain_prepass(
            ops, x_noise[:, : T - T % n].contiguous(), s0)
        tabs = ops.tables()
        kr, ki = kchain.chain_frames(x3, s3, tabs)
        torch.cuda.synchronize()
        t64 = kchain.ChainTables(*(t.double() for t in tabs))
        dr, di = kchain.chain_frames_reference(x3.double(), s3.double(), t64)
        pr, pi = kchain.chain_frames_reference(x3, s3, tabs)
        err2 = ((kr.double() - dr) ** 2).sum() + ((ki.double() - di) ** 2).sum()
        sig2 = (dr ** 2).sum() + (di ** 2).sum()
        snr = float(10 * torch.log10(sig2 / err2))
        perr2 = ((pr.double() - dr) ** 2).sum() + ((pi.double() - di) ** 2).sum()
        plain_snr = float(10 * torch.log10(sig2 / perr2))
        max_err = float(torch.maximum((kr.double() - dr).abs().max(),
                                      (ki.double() - di).abs().max()))
        finite = bool(torch.isfinite(kr).all() and torch.isfinite(ki).all())
        ms = median_ms(lambda: kchain.chain_frames(x3, s3, tabs))
        plain_ms = median_ms(lambda: kchain.chain_frames_reference(x3, s3, tabs))
        per_size[n] = dict(snr=snr, max_abs_err=max_err, ms=ms, plain_ms=plain_ms)
        print(f"kernel N={n} ({ops.n1} x {ops.n2}) frames={x3.shape[0]}: "
              f"{snr:.2f} dB vs float64 plain (float32 plain {plain_snr:.2f} "
              f"dB), max |err| {max_err:.3e}; kernel {ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms")
        check(finite and snr >= MIN_SNR_DB,
              f"kernel at N={n}: {snr:.2f} dB < {MIN_SNR_DB} dB or not finite")
        del kr, ki, dr, di, pr, pi, x3, s3
    del x_noise

    # -- 4. main path ------------------------------------------------------
    # A caller that enabled TF32: the chain must still run IEEE float32.
    torch.backends.cuda.matmul.allow_tf32 = True
    chain = NorthStarChain(fft_size=MAIN_N, block_size=256, device=dev)
    check(chain.use_kernel, "NorthStarChain(device='cuda') is not on the kernel")
    rng = np.random.default_rng(0)
    x_host = [rng.standard_normal((C, T)).astype(np.float32) for _ in range(CALLS)]
    xs = [chain.frame_input(x) for x in x_host]
    torch.cuda.synchronize()
    zero_counts()
    outs, state = [], None
    for i, x in enumerate(xs):
        before = kchain.chain_kernel.launches
        (sr, si), state = chain(x, state)
        check(kchain.chain_kernel.launches == before + 1,
              f"call {i} launched the kernel "
              f"{kchain.chain_kernel.launches - before} times")
        outs.append((sr, si))
    torch.cuda.synchronize()
    launches = kchain.chain_kernel.launches
    check(torch.backends.cuda.matmul.allow_tf32,
          "the caller's allow_tf32 setting was not restored")
    torch.backends.cuda.matmul.allow_tf32 = False
    nf, h = T // MAIN_N, MAIN_N // 2
    for i, (sr, si) in enumerate(outs):
        check(sr.shape == si.shape == (C, nf, h), f"call {i} shape {tuple(sr.shape)}")
        check(bool(torch.isfinite(sr).all() and torch.isfinite(si).all()),
              f"call {i} spectra not finite")
    check(tuple(state.y_hist.shape) == (C, design.nsections + 1, 2)
          and bool(torch.isfinite(state.y_hist).all()), "final state")
    got0 = (outs[0][0][:2].double() + 1j * outs[0][1][:2].double()).cpu().numpy()
    snr_call0 = snr_db(oracle_packed(design, x_host[0][:2].astype(np.float64),
                                     MAIN_N), got0)
    x01 = np.concatenate([x_host[0][:1], x_host[1][:1]], -1).astype(np.float64)
    got01 = np.concatenate([
        (outs[k][0][:1].double() + 1j * outs[k][1][:1].double()).cpu().numpy()
        for k in (0, 1)], axis=1)
    snr_stream = snr_db(oracle_packed(design, x01, MAIN_N), got01)
    print(f"main path: {CALLS} calls of {C} x {T} float32, kernel launches "
          f"{launches}; call 0 channels 0-1 {snr_call0:.2f} dB, calls 0-1 "
          f"channel 0 continuity {snr_stream:.2f} dB vs float64 oracle")
    check(launches == CALLS, f"{launches} kernel launches in {CALLS} calls")
    check(snr_call0 >= MIN_SNR_DB, f"main path {snr_call0:.2f} dB")
    check(snr_stream >= MIN_SNR_DB, f"streaming continuity {snr_stream:.2f} dB")

    # -- 5. timing ---------------------------------------------------------
    x0 = xs[0]
    chain_ms = median_ms(lambda: chain(x0, state))
    plain = NorthStarChain(fft_size=MAIN_N, block_size=256, device=dev,
                           use_kernel=False)
    x_flat = x0.reshape(C, T)
    (cr, ci), _ = plain(x_flat)
    snr_plain = snr_db(oracle_packed(design, x_host[0][:2].astype(np.float64),
                                     MAIN_N),
                       (cr[:2].double() + 1j * ci[:2].double()).cpu().numpy())
    plain_chain_ms = median_ms(lambda: plain(x_flat), reps=3)
    frames = x_flat.reshape(C, nf, MAIN_N)
    cufft_ms = median_ms(lambda: torch.fft.rfft(frames))
    msps = C * T / (chain_ms * 1e-3) / 1e6
    print(f"timing: main path {chain_ms:.3f} ms/call ({msps:.1f} Msamples/s); "
          f"composable path (use_kernel=False) {plain_chain_ms:.3f} ms/call at "
          f"{snr_plain:.2f} dB; torch.fft.rfft (cuFFT, no IIR) of the same "
          f"frames {cufft_ms:.3f} ms")
    main = per_size[MAIN_N]
    return {"name": "chain_frames", "route": "cuda",
            "source": "simpledsp_tpu_torch/csrc/chain.cu",
            "replaces": "simpledsp_tpu/kernels/chain.py:362",
            "launches": launches, "max_abs_err": main["max_abs_err"],
            "ms": main["ms"], "plain_ms": main["plain_ms"]}


# -- the PFB kernels and the receiver banks ---------------------------------

def pfb_kernel_phase(dev, kpfb, PFBChannelizer, lowpass_taps):
    """Phase 6; returns {layout: (max |err|, kernel ms, plain ms)} at the
    main mode of each layout (flat fm_dec, frames chan)."""
    g = TB // M
    chan = PFBChannelizer(M, taps_per_channel=K, device=dev)
    ops = chan.kernel_ops
    h = chan.hist_len
    xr, xi = carriers(B, M, -h, h + M * g, dev)
    w = kpfb.flat_pad_to(ops, g)
    xpr = torch.zeros(B, w, device=dev)
    xpi = torch.zeros(B, w, device=dev)
    xpr[:, :h + M * g] = xr
    xpi[:, :h + M * g] = xi
    ftr, fti = chan.frames_t(xr), chan.frames_t(xi)
    del xr, xi
    rng = np.random.default_rng(5)

    def f32(*shape):
        return torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32,
                               device=dev)

    prev_r, prev_i, ahist = f32(B, M, 1), f32(B, M, 1), f32(B, M, KD - 1)
    dtaps = torch.as_tensor(lowpass_taps(KD, 0.4 / DECIM, fs=1.0),
                            dtype=torch.float32, device=dev)
    tabs = ops.tables(dev)
    t64 = kpfb.PFBTables(*(t.double() for t in tabs))
    cases = [("flat", m) for m in ("fm", "fm_dec", "am", "am_dec", "am_sum")]
    cases += [("frames", m) for m in ("fm", "fm_dec", "am", "am_dec", "chan")]
    results = {}
    for layout, mode in cases:
        kmode = "am_dec" if mode == "am_sum" else mode
        fm, dec = kmode.startswith("fm"), kmode.endswith("_dec")
        args = (prev_r if fm else None, prev_i if fm else None,
                ahist if dec else None, dtaps if dec else None)
        kw = dict(gain=0.2, g=g, decim=DECIM, emit_sum=mode == "am_sum")
        x = (xpr, xpi) if layout == "flat" else (ftr, fti)
        kern = kpfb.pfb_flat_kernel if layout == "flat" else kpfb.pfb_frames_kernel
        ref = (kpfb.pfb_flat_reference if layout == "flat"
               else kpfb.pfb_frames_reference)

        def run_kernel(tile=None):
            return kern(kmode, tabs, *x, *args, tile=tile, **kw)

        got = run_kernel()
        other = run_kernel(64)
        torch.cuda.synchronize()
        ref64 = ref(kmode, t64, x[0].double(), x[1].double(),
                    *[None if a is None else a.double() for a in args], **kw)
        ref32 = ref(kmode, tabs, *x, *args, **kw)
        err = bar_check(got, ref64, ref32, f"pfb {layout} {mode}")
        del ref64
        for i, (a, c) in enumerate(zip(leaves(got), leaves(other))):
            if mode == "am_sum" and a.dim() == 2:
                continue   # the per-call totals, held to the bar above
            check(torch.equal(a, c), f"pfb {layout} {mode} output {i}: tiles "
                                     f"of 64 and the default differ")
        ms = median_ms(run_kernel, per=STEADY)
        plain_ms = median_ms(lambda: ref(kmode, tabs, *x, *args, **kw), reps=3,
                             per=STEADY)
        print(f"pfb {layout} {mode}: max |err| {err:.3e} vs float64 plain, "
              f"tile seams bitwise equal; kernel {ms:.3f} ms, float32 plain "
              f"{plain_ms:.3f} ms")
        results[(layout, mode)] = (err, ms, plain_ms)
        del got, other, ref32
    del ftr, fti, xpr, xpi
    for m, k in PFB_CONFIGS:
        chan = PFBChannelizer(m, taps_per_channel=k, device=dev)
        ops = chan.kernel_ops
        gm = TB // m
        h = chan.hist_len
        xr, xi = carriers(B, m, -h, h + m * gm, dev, seed=m + k)
        w = kpfb.flat_pad_to(ops, gm)
        xp = [torch.nn.functional.pad(v, (0, w - v.shape[1])) for v in (xr, xi)]
        del xr, xi
        pr, pi, ah = f32(B, m, 1), f32(B, m, 1), f32(B, m, KD - 1)
        tabs = ops.tables(dev)
        t64 = kpfb.PFBTables(*(t.double() for t in tabs))
        kw = dict(gain=0.2, g=gm, decim=DECIM, emit_sum=False)
        args = (pr, pi, ah, dtaps)
        got = kpfb.pfb_flat_kernel("fm_dec", tabs, *xp, *args, tile=None, **kw)
        ref64 = kpfb.pfb_flat_reference(
            "fm_dec", t64, *[v.double() for v in xp],
            *[a.double() for a in args], **kw)
        ref32 = kpfb.pfb_flat_reference("fm_dec", tabs, *xp, *args, **kw)
        err = bar_check(got, ref64, ref32, f"pfb flat fm_dec M{m}/K{k}")
        ms = median_ms(lambda: kpfb.pfb_flat_kernel(
            "fm_dec", tabs, *xp, *args, tile=None, **kw), per=STEADY)
        print(f"pfb flat fm_dec M{m}/K{k}: max |err| {err:.3e}; kernel "
              f"{ms:.3f} ms")
        del got, ref64, ref32, xp
    return results


def bank_phases(dev, kpfb, sdr, PFBChannelizer):
    """Phases 7-9; returns (flat launches, frames launches, frames record)."""
    t = TB
    banks = {"FM": sdr.FMReceiverBank(M, fs=FS, device=dev),
             "AM": sdr.AMReceiverBank(M, fs=FS, device=dev)}
    oracles = {name: type(bank)(M, fs=FS, device=dev, dtype=torch.float64,
                                use_kernel=False)
               for name, bank in banks.items()}
    inputs = [carriers(B, M, i * t, t, dev) for i in range(CALLS)]
    torch.cuda.synchronize()
    flat_launches = 0
    timing = {}
    for name, bank in banks.items():
        check(bank.use_kernel, f"{name} bank on CUDA is not on the kernel")
        # Oracle: the float64 composable bank over streams 0-1, chained; the
        # float32 composable bank beside it gives the float32 plain error.
        plain32 = type(bank)(M, fs=FS, device=dev, use_kernel=False)
        so = s32 = None
        ref, own = [], []
        for xr, xi in inputs:
            a, so = oracles[name]((xr[:2].double(), xi[:2].double()), so)
            p32, s32 = plain32((xr[:2], xi[:2]), s32)
            ref.append(a)
            own.append(float((p32.double() - a).abs().max()))
        audio = {}
        for entry in ("__call__", "process_padded"):
            zero_counts()
            st, outs = None, []
            for i, (xr, xi) in enumerate(inputs):
                before = kpfb.pfb_flat_kernel.launches
                if entry == "__call__":
                    a, st = bank((xr, xi), st)
                else:
                    front, total = bank.padded_spec(t)
                    bufs = tuple(torch.empty(B, total, device=dev)
                                 for _ in range(2))
                    bufs[0][:, front:front + t] = xr
                    bufs[1][:, front:front + t] = xi
                    a, st, _ = bank.process_padded(bufs, st)
                check(kpfb.pfb_flat_kernel.launches == before + 1,
                      f"{name} {entry} call {i} launched the flat kernel "
                      f"{kpfb.pfb_flat_kernel.launches - before} times")
                outs.append(a)
            torch.cuda.synchronize()
            launches = kpfb.pfb_flat_kernel.launches
            check(launches == CALLS, f"{name} {entry}: {launches} launches")
            flat_launches += launches
            worst = 0.0
            for i, (a, r) in enumerate(zip(outs, ref)):
                check(a.shape == (B, M, t // M // DECIM)
                      and bool(torch.isfinite(a).all()),
                      f"{name} {entry} call {i} audio shape or values")
                err = float((a[:2].double() - r).abs().max())
                limit = max(BAR * max(1.0, float(r.abs().max())), 2 * own[i])
                check(err <= limit, f"{name} {entry} call {i}: max |err| "
                                    f"{err:.3e} > {limit:.3e}")
                worst = max(worst, err)
            audio[entry] = outs
            print(f"{name} bank {entry}: {CALLS} calls of {B} x {t} float32, "
                  f"flat kernel launches {launches}; streams 0-1 max |err| "
                  f"{worst:.3e} vs the float64 composable bank (float32 "
                  f"composable bank {max(own):.3e})")
        check(all(torch.equal(a, b) for a, b in zip(audio["__call__"],
                                                    audio["process_padded"])),
              f"{name}: __call__ and process_padded audio differ")
        # Continuity: calls 0-1 against one float64 call over both.
        if name == "FM":
            kaudio, cont = audio["__call__"][:2], oracles[name]
        else:
            kbank = sdr.AMReceiverBank(M, fs=FS, device=dev, remove_dc=False)
            kst, kaudio = None, []
            for xr, xi in inputs[:2]:
                a, kst = kbank((xr[:2], xi[:2]), kst)
                kaudio.append(a)
            cont = sdr.AMReceiverBank(M, fs=FS, device=dev, remove_dc=False,
                                      dtype=torch.float64, use_kernel=False)
        whole, _ = cont(tuple(torch.cat([inputs[0][p][:2], inputs[1][p][:2]],
                                        -1).double() for p in (0, 1)))
        got = torch.cat([a[:2] for a in kaudio], -1).double()
        err = float((got - whole).abs().max())
        limit = BAR * max(1.0, float(whole.abs().max()))
        print(f"{name} continuity: calls 0-1 against one float64 call over "
              f"both: max |err| {err:.3e}"
              + ("" if name == "FM" else " (envelope path, remove_dc=False)"))
        check(err <= limit, f"{name} continuity {err:.3e} > {limit:.3e}")
        # -- 9. timing
        xr, xi = inputs[0]
        st = bank.init_state(B)
        call_ms = median_ms(lambda: bank((xr, xi), st), per=STEADY)
        front, total = bank.padded_spec(t)
        bufs = tuple(torch.empty(B, total, device=dev) for _ in range(2))
        bufs[0][:, front:front + t] = xr
        bufs[1][:, front:front + t] = xi
        pad_ms = median_ms(lambda: bank.process_padded(bufs, st), per=STEADY)
        plain = type(bank)(M, fs=FS, device=dev, use_kernel=False)
        plain_ms = median_ms(lambda: plain((xr, xi), st), reps=3, per=STEADY)
        timing[name] = (call_ms, pad_ms, plain_ms)
        print(f"{name} bank timing: __call__ {call_ms:.3f} ms/call "
              f"({B * t / call_ms / 1e3:.1f} Msamples/s), process_padded "
              f"{pad_ms:.3f} ms/call ({B * t / pad_ms / 1e3:.1f} Msamples/s); "
              f"float32 composable bank {plain_ms:.3f} ms/call")
    # -- 8. bare channelizer path (the frames kernel)
    chan = PFBChannelizer(M, taps_per_channel=K, device=dev)
    chan64 = PFBChannelizer(M, taps_per_channel=K, device=dev,
                            dtype=torch.float64)
    xr, xi = inputs[0]
    hist = torch.zeros(B, chan.hist_len, device=dev)
    ftr = chan.frames_t(torch.cat([hist, xr], -1))
    fti = chan.frames_t(torch.cat([hist, xi], -1))
    torch.cuda.synchronize()
    zero_counts()
    yr, yi = kpfb.pfb_channelize_frames(chan.kernel_ops, ftr, fti)
    torch.cuda.synchronize()
    frames_launches = kpfb.pfb_frames_kernel.launches
    check(frames_launches == 1, f"bare channelizer: {frames_launches} launches")
    (cr, ci), _ = chan64.process_ri_cm(xr[:2].double(), xi[:2].double())
    err = max(float((yr[:2].double() - cr).abs().max()),
              float((yi[:2].double() - ci).abs().max()))
    limit = BAR * max(1.0, float(cr.abs().max()))
    print(f"bare channelizer: frames kernel launches {frames_launches}; "
          f"streams 0-1 max |err| {err:.3e} vs the float64 composable "
          f"channelizer")
    check(err <= limit, f"bare channelizer {err:.3e} > {limit:.3e}")
    return flat_launches, frames_launches, timing


def build_all(libs):
    """Build every kernel library at once, one nvcc each; re-raise the
    first failure."""
    errors = []

    def build(lib):
        try:
            lib()
        except Exception as e:  # noqa: BLE001 - re-raised below
            errors.append(e)

    threads = [threading.Thread(target=build, args=(lib,)) for lib in libs]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise errors[0]


def main() -> int:
    # -- 1. device ---------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from simpledsp_tpu_torch.design.fir import lowpass_taps
    from simpledsp_tpu_torch.kernels import _build
    from simpledsp_tpu_torch.kernels import chain as kchain
    from simpledsp_tpu_torch.kernels import pfb as kpfb
    from simpledsp_tpu_torch.models import sdr
    from simpledsp_tpu_torch.models.northstar import NorthStarChain, default_design
    from simpledsp_tpu_torch.ops.channelizer import PFBChannelizer

    KERNELS[:] = [kchain.chain_kernel, kpfb.pfb_flat_kernel,
                  kpfb.pfb_frames_kernel]
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; {kind}; {smi}")

    # -- 2. build ----------------------------------------------------------
    start = time.perf_counter()
    build_all([kchain.chain_kernel.library, kpfb.pfb_flat_kernel.library])
    print(f"build: chain.cu {_build.build_seconds['sdsp_chain']:.2f} s and "
          f"pfb.cu {_build.build_seconds['sdsp_pfb']:.2f} s in nvcc, "
          f"{time.perf_counter() - start:.2f} s for both with loading")

    chain_record = chain_phases(dev, kchain, NorthStarChain, default_design())
    pfb = pfb_kernel_phase(dev, kpfb, PFBChannelizer, lowpass_taps)
    flat_launches, frames_launches, _ = bank_phases(dev, kpfb, sdr,
                                                    PFBChannelizer)
    flat_err, flat_ms, flat_plain = pfb[("flat", "fm_dec")]
    fr_err, fr_ms, fr_plain = pfb[("frames", "chan")]
    print(smi)
    print(json.dumps({"kernels": [chain_record, {
        "name": "pfb_flat", "route": "cuda",
        "source": "simpledsp_tpu_torch/csrc/pfb.cu",
        "replaces": "simpledsp_tpu/kernels/pfb.py:298",
        "launches": flat_launches, "max_abs_err": flat_err,
        "ms": flat_ms, "plain_ms": flat_plain,
    }, {
        "name": "pfb_frames", "route": "cuda",
        "source": "simpledsp_tpu_torch/csrc/pfb.cu",
        "replaces": "simpledsp_tpu/kernels/pfb.py:475",
        "launches": frames_launches, "max_abs_err": fr_err,
        "ms": fr_ms, "plain_ms": fr_plain,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
