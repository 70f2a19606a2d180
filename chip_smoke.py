"""Smoke run of the PyTorch port on one NVIDIA GPU: builds the CUDA chain
kernel, checks it, drives the north-star chain end to end, and times it.

    python3 chip_smoke.py

Phases (any failure exits nonzero before the result line):

1. Device: a CUDA device is required; prints the card's name and power limit.
2. Build: compiles ``simpledsp_tpu_torch/csrc/chain.cu`` into ``build/``.
3. Kernel against its plain version at N = 1024, 2048, 4096 and 16384, on
   the frames and sub-block starts that 64 x 2^20 samples of noise give:
   >= 130 dB SNR against ``chain_frames_reference`` evaluated in float64 on
   the same float32 inputs and tables.
4. Main path: ``NorthStarChain(fft_size=4096, device="cuda")`` on 64 x 2^20
   float32 samples per call, 4 calls with the state chained, with TF32
   enabled by the caller (the chain must not use it).  The kernel must
   launch once per call; channels 0-1 of call 0 and the concatenated
   channel-0 spectra of calls 0-1 must hold >= 130 dB against the float64
   oracle (scipy sosfilt + numpy rfft).
5. Timing, each the median of 5 runs timed with CUDA events: the main path,
   the kernel against its plain version, the composable path
   (``use_kernel=False``) and ``torch.fft.rfft`` (cuFFT) as a baseline.

The line before the last is a JSON object with the kernel's record; the
last line is ``{"ok": true, "device": {...}}``.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

C, T = 64, 1 << 20          # channels, samples per channel per call
SIZES = (1024, 2048, 4096, 16384)
MAIN_N = 4096
CALLS = 4
MIN_SNR_DB = 130.0
REPS = 5


def snr_db(ref, got) -> float:
    ref = np.asarray(ref, dtype=np.complex128)
    err = np.asarray(got, dtype=np.complex128) - ref
    return float(10 * np.log10((np.abs(ref) ** 2).sum()
                               / max((np.abs(err) ** 2).sum(), 1e-300)))


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def median_ms(fn, reps=REPS) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
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


def main() -> int:
    # -- 1. device ---------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from simpledsp_tpu_torch.kernels import _build
    from simpledsp_tpu_torch.kernels import chain as kchain
    from simpledsp_tpu_torch.models.northstar import NorthStarChain, default_design

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; {kind}")
    design = default_design()

    # -- 2. build ----------------------------------------------------------
    start = time.perf_counter()
    kchain.chain_kernel.library()
    print(f"build: chain.cu {_build.build_seconds['sdsp_chain']:.2f} s in nvcc, "
          f"{time.perf_counter() - start:.2f} s with loading")

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

    # -- 3. kernel against its plain version --------------------------------
    rng = np.random.default_rng(1)
    x_noise = torch.as_tensor(rng.standard_normal((C, T), dtype=np.float32),
                              device=dev)
    per_size = {}
    for n in SIZES:
        ops = kchain.FusedNorthStarOperators(design, n, device=dev)
        s0 = torch.zeros(C, ops.state_dim, device=dev)
        x3, s3, _ = kchain.chain_prepass(ops, x_noise, s0)
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
        print(f"kernel N={n} frames={x3.shape[0]}: {snr:.2f} dB vs float64 plain "
              f"(float32 plain {plain_snr:.2f} dB), max |err| {max_err:.3e}; "
              f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
        check(finite and snr >= MIN_SNR_DB,
              f"kernel at N={n}: {snr:.2f} dB < {MIN_SNR_DB} dB or not finite")
        del kr, ki, dr, di, pr, pi, x3, s3
    del x_noise

    # -- 4. main path --------------------------------------------------------
    # A caller that enabled TF32: the chain must still run IEEE float32.
    torch.backends.cuda.matmul.allow_tf32 = True
    chain = NorthStarChain(fft_size=MAIN_N, block_size=256, device=dev)
    check(chain.use_kernel, "NorthStarChain(device='cuda') is not on the kernel")
    rng = np.random.default_rng(0)
    x_host = [rng.standard_normal((C, T)).astype(np.float32) for _ in range(CALLS)]
    xs = [chain.frame_input(x) for x in x_host]
    torch.cuda.synchronize()
    kchain.chain_kernel.launches = 0
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

    # -- 5. timing -----------------------------------------------------------
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
    print(smi)
    print(json.dumps({"kernels": [{
        "name": "chain_frames",
        "route": "cuda",
        "source": "simpledsp_tpu_torch/csrc/chain.cu",
        "replaces": "simpledsp_tpu/kernels/chain.py:362",
        "launches": launches,
        "max_abs_err": main["max_abs_err"],
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
