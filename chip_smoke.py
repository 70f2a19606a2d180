"""Smoke run of the PyTorch port on one NVIDIA GPU: builds the CUDA kernels,
checks each against its plain version, drives the north-star chain, both
SDR receiver banks, the 1-D and 2-D convolution paths, the spectral
transforms, the pulse-Doppler radar and the chain's full spectrum and
layouts end to end, and times them; runs the probes of the card
(``simpledsp_tpu_torch/tools``) on their own kernels; then drives the
general filtering surface, the audio features, the modems, the
command-line front end, the smoothing filters, the parallel layer, the
headline benchmark and the example scenarios.

    python3 chip_smoke.py

Phases (any failure exits nonzero before the result line):

1. Device: a CUDA device is required; prints the card's name and power limit.
2. Build: compiles ``simpledsp_tpu_torch/csrc/chain.cu``, ``chain_tc.cu``,
   ``pfb.cu``, ``ols.cu``, ``conv2d.cu``, ``fft.cu`` and ``probes.cu`` into
   ``build/``, one nvcc for each, and the host runtime's
   ``native/sdsp_io.cpp`` with g++, all started together (``chain.cu``,
   ``chain_tc.cu``, ``ols.cu`` and ``fft.cu`` include the FFT core
   ``fft_core.cuh``; the two chain sources the kernel's template
   ``chain_natural.cuh``); prints each compiler's seconds.
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
   are held to the bar).  Kernel and float32 plain times, and the kernel's
   CUDA-graph (device) time; then the flat fm_dec kernel's stage split
   (``tools/pfb_stages.py``: builds cut after the input, the FIR, the FFT
   and the demod, each timed as CUDA-graph replays).
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
10. Overlap-save kernel against its plain version at nfft 4096 / 8192 /
    16384 (m = 301 / 1000 / 2000 random taps) on the frames that 256 x 65536
    float32 noise (seed 0) gives: >= 100 dB SNR against
    ``conv_ols_frames_reference`` in float64 on the same float32 frames, and
    no more than 6 dB below the float32 plain version's own SNR.  Kernel
    and float32 plain ms (median of 5), and the kernel's CUDA-graph
    (device) ms.
11. 1-D main path on the same 256 x 65536 float32 with 301 random taps:
    ``fftconvolve(x, h, "same")``, ``convolve(x, h, "full")``,
    ``correlate(x, h, "same")`` and ``oaconvolve(x, h)`` each launch the
    overlap-save kernel exactly once, rows 0-1 hold >= 100 dB against scipy
    in float64, and all 256 rows >= 100 dB against the same call on the
    float64 signal (the plain ``OverlapSaveFIR`` route).  The route's entry
    ``convolve_ols_fused`` (frames read in place, zero history and tail)
    holds >= 100 dB on all rows against ``conv_ols_frames_reference`` in
    float64 on the padded frames.  ``OverlapSaveFIR(h, block_size=4096)``
    over 2 chained calls equals one call over both, bit for bit, and so
    does ``OverlapSaveFIR`` with 40 taps and block 64 (nfft 128, the
    engine's small-DFT route) over 3 chained calls.  ms/call
    and Msamples/s; the plain ``OverlapSaveFIR`` route and ``torch.fft``
    (cuFFT) as labelled baselines.
12. conv2d kernel against its plain version at 32 x 512 x 512 float32 with
    3x3, 9x9 and 13x13 random taps, and on that image padded so the output
    is whole 32 x 128 tiles (512 x 512) and padded by k - 1 on every side as
    the 'same' path pads it: equal bit for bit.  Kernel and plain ms, and
    the kernel's CUDA-graph (device) ms.
13. 2-D main path on the same image: ``convolve2d(x, k9, "same")`` with each
    boundary and ``correlate2d(x, k9, "same")`` launch the conv2d kernel once
    each; ``convolve2d(x, k64, "same", method="fft")`` launches none.  The
    direct calls' 32 images equal, bit for bit, the same call with a tensor
    kernel (the plain direct route).  Image 0 holds against scipy in
    float64: <= 1e-5 relative max error on the direct route, >= 100 dB on
    the FFT route.  ms/call; for the direct calls also their CUDA-graph
    (device) ms and, beside it, the kernel's alone on the image the call
    pads (the rest is the boundary pad and the crop).
    Phases 10-13 time windows of 10 back-to-back calls, as phases 6 and 9 do.
14. Frames FFT kernel against its plain version at N = 100, 256, 384, 1152,
    2048, 4096, 8192 and 16384, 1024 x 4096 samples' worth of frames at each
    (seed 14), forward complex (``fft_frames_ri``), inverse complex scaled
    by 1/N and forward real (``rfft_frames``): >= 120 dB SNR against
    ``fft_frames_reference`` in float64 on the same float32 frames, and no
    more than 6 dB below the float32 plain version's own SNR.  rfft_ri's
    even / odd strided views of 1024 x 8192 give the bits of their
    contiguous copies.  Kernel, float32 plain and ``torch.fft`` (cuFFT, a
    yardstick the port never calls) ms, and the bound; beside them, apart,
    the kernel and ``torch.fft`` as CUDA-graph replays of 10 calls, the
    device's time without the host's (a wrapper's host work takes about as
    long as the kernel at 4 M samples a call).
15. Transform path at the JAX package's on-chip sizes
    (``tools/ab_fused.py:78-92``, ``tools/verify_fused_transforms.py``):
    ``dct(x, 2, norm="ortho")`` and ``analytic_ri`` on 1024 x 4096, ``fft_ri``
    on 512 x 4099 (Bluestein), ``rfft_ri`` / ``irfft_ri`` on 4 x 8192,
    ``stft_ri(x, 4096, hop=2048)`` on 64 x 262144, ``istft_ri`` back
    (interior samples) and ``welch_psd(x, 4096)``: each >= 100 dB against
    scipy / numpy in float64 on the same float32 input, and each call
    launches the frames kernel as often as the code implies; the stft's
    direct and FFT routes timed at nfft 1024 and 4096.  ms/call and
    Msamples/s, and ms/call with the engine's kernel routing off (the plain
    four-step), the A/B behind the port's routing.
16. Radar path: ``range_doppler_map`` and ``cfar_ca(guard=2, train=12,
    pfa=1e-5)`` on 16 CPIs x 256 pulses x 4096 range cells of complex
    float32 I/Q (seed 0; two targets, a 512-sample ``lfm_chirp(512, 0.8)``):
    the map >= 100 dB against a float64 numpy oracle, both targets detected
    in every CPI, a detection-cell fraction below 5e-3, three kernel
    launches a call (8192-point forward and inverse, 256-point Doppler)
    and one CFAR kernel launch a ``cfar_ca`` call, whose threshold and
    mask equal the rolled route's bit for bit; the CFAR kernel's device
    ms (CUDA graph) beside its bound and the rolled route's.
    ms/call, and with the kernel routing off.  The map's accuracy stage by
    stage (``radar_stages``: range FFT, inverse, matched filter, Doppler
    FFT, and the map on and off the targets' cells).
    Phases 14-16 time windows of 10 back-to-back calls (3 for the radar).
17. The rest of the chain kernel family against its float64 plain versions
    on the frames and starts of 16 x 2^20 float32 noise (seed 17): the
    full-spectrum kernel at N = 1000 (odd n2), 1024, 4096, 16384, and the
    odd N = 375, 8181 and 16129 (127 x 127, the largest odd N) against
    ``chain_frames_full_reference``, and every half-spectrum layout (reg,
    k1, regs, regw, reg2, reg4, regp, fmajor, pair) at N = 200, 1024, 4096,
    16384 through its wrapper against ``chain_frames_reference``: >= 130 dB,
    finite; regw and fmajor (after its transpose) equal reg bit for bit.
    Kernel and float32 plain ms (median of 5 / 3), the group size g of the
    grouped layouts, and the bound.  Every layout runs
    ``chain_natural_kernel``; regs with its IIR block on the tensor cores
    (``chain_tc.cu``), against its own plain version in float32 too.
18. Full-spectrum main path: ``fused_chain_frames(ops, x, s0)`` with its
    defaults (``FusedNorthStarOperators`` built with no device: CUDA) at
    N = 4096 on 64 x 2^20 float32 samples a call, 4 calls with the state
    chained: one full-spectrum launch a call and no other chain launch;
    channels 0-1 of call 0 and the channel-0 spectra of calls 0-1 >= 130
    dB against float64 scipy ``sosfilt`` + numpy ``fft``.  ms/call beside
    ``NorthStarChain``'s half-spectrum ms/call from phase 5.
19. Layout path: ``fused_chain_frames(..., half_spectrum=True, layout=L)``
    on call 0 for L = regs, regw, fmajor, reg2, reg4, regp, pair: one
    launch of L's kernel a call, channels 0-1 >= 130 dB against the packed
    float64 oracle; ms/call for regs, regw, reg2 and pair.
20. Probes: ``run()`` of each of ``simpledsp_tpu_torch.tools.probe_dma_scale``,
    ``probe_store``, ``probe_dispatch``, ``probe_hlo``, ``probe_transpose``,
    ``probe_relayout`` and ``probe_mosaic``, the launch counts set to 0
    before and read after: each of the four probe kernels (scale_copy,
    permute, contract, row_sum) launches on that path.  Each probe holds
    every launch to its plain version and raises otherwise: the copies and
    transposes bit for bit, the products and the row sum (k1-k3) at >= 120
    dB SNR against the float64 plain version and no more than 6 dB below
    the float32 plain version.  A line of numbers a probe; the whole result
    goes to ``chiprun_out/probes.json``.
21. Filtering path on 64 x 2^20 float32 noise (seed 21), the chain's width:
    ``lfilter`` and ``filtfilt`` with ``butter(4, 0.2, output="ba")``,
    ``sosfiltfilt`` with ``design_lowpass(4, 2000, 39000)``,
    ``decimate(x, 8)`` IIR and FIR, ``resample_poly(x, 3, 2)``,
    ``upfirdn(firwin(61, 0.3), x, 3, 2)`` and ``resample(x, 2**19)``, each
    once with the launch counts set to 0 before: decimate FIR (161 taps)
    launches the overlap-save kernel once and resample the frames FFT
    kernel.  Rows 0-1 against scipy in float64: the FIR paths >= 100 dB;
    the IIR paths no more than 6 dB below the same call in float32 on the
    CPU, and the same call in float64 on the card within 1e-9 of the peak.
    ms/call over windows of back-to-back calls (3 for the IIR paths, whose
    block state loop is serial in Python).
22. Audio path on 64 x 262144 float32 at 16 kHz (seed 22), the stft cell's
    shape: ``MelSpectrogram(512, 256, 64)`` and ``mfcc(x, n_mfcc=13)``.
    The mel energies and MFCCs in float32 >= 100 dB against the port in
    float64 on the card; the float64 MFCCs of rows 0-1 within 1e-9 of the
    peak of a numpy oracle (scipy.signal.stft's frames, the filterbank,
    scipy.fft.dct).  nfft 512 takes the stft's direct route, so the path
    launches no hand kernel (checked).  ``griffin_lim`` on 4 rows: the
    spectral convergence after 0-8 iterations, finite, below its start
    after 8 and not rising from the first iterate on.  ms/call.
23. Comms path: QPSK ``LinearModem`` (sps 8, beta 0.35) on 64 x 65536
    symbols at span 8 (65 taps, convolve's direct route) and span 16
    (129 taps on 524288-sample rows: each demodulate launches the
    overlap-save kernel twice, once a plane), and QPSK ``OFDMModem``
    (n_fft 64, cp 16) on 64 x 4096 OFDM symbols: noiseless round trips and
    the OFDM round trip through a 3-tap channel with its equalizer give
    BER 0; through ``awgn`` at Eb/N0 4 dB the BER lies within 0.6-1.6 x
    the analytic value.  ms/call of each modulate and demodulate.
24. The command-line front end (``simpledsp_tpu_torch.cli``) on files in a
    temporary directory: a 2^25-pair iq16 capture at 1.024 MS/s (a carrier
    in each of the 16 channels, each with its own AM and FM tones, FM
    deviation 5 kHz; seed 24), 2^25 float32 samples of noise (seed 24),
    2^23 int16 PCM samples (seed 25).  First each command once as
    ``python -m simpledsp_tpu_torch`` with no ``--device`` (CUDA, the
    default), all at once, within a time limit: exit 0.  Then in this
    process through ``cli.main``, the counts set to 0 before each run:
    ``spectra`` (defaults: lp:2000, order 8, fft 4096, 8 blocks of 2^22)
    launches the chain kernel once a block and every frame holds >= 130 dB
    against ``NorthStarChain(use_kernel=False)`` in float64 over the same
    blocks; ``fm-rx`` and ``am-rx`` at ``--block-frames`` 1024 and 16384
    launch the flat PFB kernel once a block and every channel holds the
    bank bar against the float64 composable bank over the same blocks (the
    float32 plain error of the bar: the float32 composable bank);
    ``spectra`` and ``fm-rx`` split at a block boundary and resumed with
    ``--state`` equal the continuous run bit for bit; ``mfcc`` (defaults,
    16 kHz) holds >= 100 dB against float64 ``mfcc`` over the same
    overlapped blocks; ``modem-sim`` (QPSK, 2^20 symbols, Eb/N0 0-10 dB)
    has a BER that falls with Eb/N0 and lies within 0.6-1.6 x theory
    wherever >= 100 errors were counted.  ``mfcc`` and ``modem-sim``
    launch no hand kernel, and no command launches one off its path; the
    ``python -m`` runs' outputs are held to the same bars against this
    process's.  Each run's Msamples/s of wall time beside the card's name
    and power limit.
25. The smoothing filters (``ops/smooth``, ``ops/splines.sepfir2d``) on
    64 x 2^20 float32 noise plus three tones a row (seed 25; the chain's
    width): ``savgol_filter`` (31, 3) in 'interp' and 'mirror' and (11,
    2), ``medfilt`` at 9 and 3, ``wiener`` at 5, ``detrend``; and on 32 x
    512 x 512 float32 noise (the conv2d cell): ``medfilt2d`` 5x5,
    ``wiener`` 5x5, ``sepfir2d`` with two 9-tap filters and
    ``order_filter`` with a 3x3 cross, each once with the counts set to 0
    before (no hand kernel may launch).  All rows against the CPU: the
    linear filters >= 100 dB against scipy in float64; the rank filters
    equal, bit for bit, the port's plain float64 path cast to float32;
    ``wiener`` >= 100 dB against the port's float32 run on the CPU (its
    local variance cancels in float32 on both sides), its float64 SNR
    printed beside.  The device events of each call, traced once by
    ``torch.profiler`` (``tools/probe_hlo.device_events``) in a process of
    its own: savgol at 31 taps and medfilt at 9 launch no more than at 11
    and 3.  Host checks:
    ``max_len_seq(20)`` through the native LFSR equals scipy's, and
    ``find_peaks`` of a savgol row on the card equals scipy's.  The CLI at
    the sizes the kernels do not take, ``spectra --fft 32768`` on 2^22
    samples and ``fm-rx --channels 12`` on a 1.5 M-pair capture with a
    carrier in each channel, as ``python -m simpledsp_tpu_torch`` on the
    card and with ``--device cpu``: exit 0, one stderr line naming the
    plain route on the card; spectra card against CPU and each against
    the float64 composable chain >= 120 dB, every channel of both within
    the bank bar of the float64 composable bank.  ms/call of each
    smoothing call beside the card's name and power limit.
26. The parallel layer (``simpledsp_tpu_torch/parallel``) on a mesh of one
    rank: ``single_device_mesh()`` starts an NCCL group of one in this
    process (dp = sp = 1; the card has one H100, and NCCL takes one rank a
    device), destroyed at the end whatever happens.
    ``ShardedNorthStarChain`` on its kernel path at the chain cell
    (64 x 2^20 float32, phase 4's input, N = 4096, block 256, 4 chained
    calls): one chain kernel launch a call; each call's spectra equal, bit
    for bit, ``NorthStarChain``'s on the same input and incoming state (at
    sp = 1 the closed form's incoming state is s0 exactly), its final
    state within 1e-6 relative of the serial call's, call 0 rows 0-1 >= 130
    dB against the float64 oracle; on ``use_kernel=False`` once, >= 130
    dB, launching what the serial composable chain launches (the frames
    FFT kernel under ``rfft_ri``).  ``ShardedBlockIIR`` (block 256, 2 chained calls on 64 x 2^20):
    rows 0-1 >= 90 dB against scipy ``sosfilt`` in float64, its largest
    difference to the serial ``BlockIIR`` printed.  ``ShardedReceiverBank``
    on the FM bank M16/K16 (16 x 2^20 I/Q, 4 chained calls): equal bits to
    the serial bank, one flat PFB launch a call.  On the 1-D conv cell
    (256 x 65536, 301 taps) ``ShardedConvolve`` and
    ``ShardedOverlapSaveFIR`` (block 1024, nfft 2048): equal bits to
    ``convolve(x, h, "same")`` and to ``OverlapSaveFIR``, rows 0-1 >= 100
    dB against scipy in float64, their OLS and frames FFT launches those
    of the serial calls.  ``ShardedSTFT`` (4096, hop 2048) on 64 x 262144:
    rows 0-1 >= 100 dB against numpy, one frames FFT launch.
    ``ShardedFIR`` (63 taps) on 64 x 2^20 and ``ShardedChannelizer`` (M 16,
    K 16, with and without ``gather_output``) on 16 x 2^20 complex: equal
    bits to the serial ops.  ``entry.dryrun_multichip(1)`` prints its
    summary.  Each module's ms/call beside the serial module's (CUDA
    events, median of 3 windows of back-to-back calls), and, from one
    ``torch.profiler`` window in a process of its own, the NCCL kernels of
    a sharded chain call and a gathered channelizer call with their
    device time, beside the card's name and power limit.
27. The headline benchmark, its smoke and the example scenarios.
    ``python -m simpledsp_tpu_torch bench`` as a subprocess with its smoke
    on: one JSON line with the JAX ``bench.py``'s keys and metric, parity
    >= 130 dB, and the smoke's record (``build/smoke.json``) reading
    ``compiled_smoke_ok: true``; its value and seconds a call are printed
    beside the card's name and power limit.  Once its line is out, each of
    ``simpledsp_tpu_torch.examples.{fm_receiver, channelize_resample,
    radar_rdm}`` runs as ``python -m`` (exit 0, its last line the OK
    line), and, in a process of its own, once under the profiler
    (``example_trace``: its hand kernels by name, at least one each);
    meanwhile in this process each example's ``run`` on the card, the
    counts set to 0 before: its ground truth holds and it launches at
    least one hand kernel.  Then the FFT engine's small-DFT route on the
    card: ``fft_ri`` at n = 64 and 128 in float32 against float64 (>= 120
    dB, no hand kernel), beside the stacked (2n, n) form it replaced, the
    same route on the CPU and ``torch.fft.fft``; and the plain chain route
    at N = 32768 against the float64 oracle.
    Phases 21-27 print their seconds, and the script its total.

Every kernel's record gives its bound on the benchmark's yardstick
(``dspbench/roofline.py``: the H100 SXM data sheet's peaks, float32 outside
the tensor cores): the larger of the bytes it must move (each input read
once, each output written once) over the memory bandwidth and its
operations over the float32 peak (an FFT counts 5 N log2 N a complex
frame).  The chain family's rows and the PFB's fm_dec rows take the
benchmark's own counts (``roofline.chain_work``, ``roofline.pfb_fm_work``);
the other rows count their own.  Beside the bound, the time of one PyTorch
call that computes the same function (``F.conv1d`` / ``F.conv2d`` with
TF32 off, ``torch.fft.fft``), or null where there is none.

The chain family's records (chain_full, chain_regs, chain_grouped with the
"reg2" numbers, chain_store with the "regw" numbers) take ms, plain ms,
error and bound from phase 17 at N = 4096 and launches from phases 18-19;
like the chain, they have no library call (the function carries state).
The probe kernels' records take their numbers from phase 20: scale_copy
from probe_dma_scale at f = 16384 (``torch.mul``), permute from
probe_relayout's relayout kernel alone (``.permute(1, 2, 0).contiguous()``),
contract from probe_mosaic's k1 (``torch.einsum``) and row_sum from its k3
(``torch.sum``).  The cfar record (a kernel that replaces no TPU kernel:
``replaces`` is null) takes its device ms (CUDA graph), the rolled
route's as ``plain_ms`` and its bound from phase 16, and counts the
launches of phases 16 and 27.

The ols and fft_frames records count the launches of phases 21, 23, 26
and 27 beside those of phases 11 and 15-16; the chain_frames and pfb_flat
records count phases 24's, 26's and 27's beside those of phases 4 and 7.

The PFB records also carry ``device_ms``, the kernel's CUDA-graph time
from phase 6, the OLS record its CUDA-graph time from phase 10, the
conv2d record its CUDA-graph time at 9x9 from phase 12, and the
scale_copy and permute records theirs from phase 20 (the PyTorch calls'
and ``y.copy_(x)``'s device times on the line after the probes').  The
line before the last is a JSON object with the kernels' records; the last
line is ``{"ok": true, "device": {...}}``.
"""

import json
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from dspbench import roofline
from simpledsp_tpu_torch.tools._common import graph_ms, median_ms

C, T = 64, 1 << 20          # chain: channels, samples per channel per call
SIZES = (1024, 2048, 4096, 16384, 200, 256, 512, 768, 1152)
MAIN_N = 4096
CALLS = 4
MIN_SNR_DB = 130.0

B, M, K = 16, 16, 16        # banks: streams, channels, taps per channel
TB = 1 << 20                # banks: samples per stream per call
FS, DECIM, KD = 1.6e6, 4, 64
PFB_CONFIGS = ((16, 32), (8, 16), (32, 16))
BAR = 1.5e-6
STEADY = 10                 # bank-phase timings: calls per timed window

CB, CT = 256, 1 << 16       # 1-D convolution: rows, samples per row
OLS_CASES = ((4096, 301), (8192, 1000), (16384, 2000))   # (nfft, taps)
MIN_CONV_DB = 100.0
IB, IH = 32, 512            # 2-D convolution: images, height = width
DIRECT_REL = 1e-5

FFT_SIZES = (256, 384, 1152, 2048, 4096, 8192, 16384, 100)
FFT_SAMPLES = 1024 * 4096   # frames FFT: samples per size
MIN_FFT_DB = 120.0
MIN_TRANSFORM_DB = 100.0
RC, RP, RS = 16, 256, 4096  # radar: CPIs, pulses, range cells
RADAR_TARGETS = ((1000, 40, 1.0), (2900, -70, 0.7))   # (delay, Doppler bin, amp)


KERNELS = []                # every kernel wrapper with a launch count


def zero_counts() -> None:
    for kernel in KERNELS:
        kernel.launches = 0


def snr_db(ref, got) -> float:
    ref = np.asarray(ref, dtype=np.complex128)
    err = np.asarray(got, dtype=np.complex128) - ref
    return float(10 * np.log10((np.abs(ref) ** 2).sum()
                               / max((np.abs(err) ** 2).sum(), 1e-300)))


def snr_db_dev(ref: torch.Tensor, got: torch.Tensor) -> float:
    """:func:`snr_db` of real tensors, reduced in float64 on their device."""
    ref = ref.double()
    err = float(((got.double() - ref) ** 2).sum())
    return float(10 * np.log10(float((ref ** 2).sum()) / max(err, 1e-300)))


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in leaves(list(tensors))
               if t is not None)


def bound(moved: int, flops: float) -> dict:
    """The least time the card could take for a function that moves
    ``moved`` bytes and does ``flops`` float32 operations
    (``roofline.bound_s``), and which of the two sets it."""
    by_bytes = roofline.bound_s(0, moved) >= roofline.bound_s(flops, 0)
    return {"bound_ms": roofline.bound_s(flops, moved) * 1e3,
            "bound_by": "bytes" if by_bytes else "operations"}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


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
    """Phases 3-5; returns the chain kernel's record, the main path's
    ms/call and its inputs (host float32, one array a call)."""
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
        if n == MAIN_N:
            per_size[n].update(chain_bound(x3, C, design.nsections))
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
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None}, chain_ms, x_host


# -- the PFB kernels and the receiver banks ---------------------------------

def pfb_flops(mode: str, samples: int, m: int, k: int) -> float:
    """Operations of a PFB mode the benchmark does not count (chan, am,
    am_dec, am_sum, undecimated fm; fm_dec is ``roofline.pfb_fm_work``) on
    ``samples`` complex input samples: the FIR (4 K a sample), the M-point
    DFT (5 log2 M a sample), the demod (6 for FM's conjugate product, 3 for
    AM's magnitude) and the decimator (2 KD / decim a channel sample)."""
    per = 4 * k + 5 * np.log2(m)
    if mode != "chan":
        per += 6 if mode.startswith("fm") else 3
    if mode.endswith("_dec") or mode == "am_sum":
        per += 2 * KD / DECIM
    return samples * per


def pfb_kernel_phase(dev, kpfb, PFBChannelizer, lowpass_taps):
    """Phase 6; returns {(layout, mode): (max |err|, kernel ms, plain ms,
    bound, device ms)}."""
    from simpledsp_tpu_torch.tools import pfb_stages
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
        device_ms = graph_ms(run_kernel, per=STEADY)
        plain_ms = median_ms(lambda: ref(kmode, tabs, *x, *args, **kw), reps=3,
                             per=STEADY)
        print(f"pfb {layout} {mode}: max |err| {err:.3e} vs float64 plain, "
              f"tile seams bitwise equal; kernel {ms:.4f} ms (CUDA graph "
              f"{device_ms:.4f} ms), float32 plain {plain_ms:.3f} ms")
        if mode == "fm_dec":
            work = roofline.pfb_fm_work(B, M * g, M, K, DECIM, KD)
            b = bound(work["bytes"], work["flops"])
        else:
            b = bound(nbytes(x, args, tabs, got),
                      pfb_flops(mode, B * M * g, M, K))
        results[(layout, mode)] = (err, ms, plain_ms, b, device_ms)
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
        def run_cfg():
            return kpfb.pfb_flat_kernel("fm_dec", tabs, *xp, *args, tile=None,
                                        **kw)

        ms = median_ms(run_cfg, per=STEADY)
        device_ms = graph_ms(run_cfg, per=STEADY)
        print(f"pfb flat fm_dec M{m}/K{k}: max |err| {err:.3e}; kernel "
              f"{ms:.4f} ms (CUDA graph {device_ms:.4f} ms)")
        del got, ref64, ref32, xp
    # The stage split: device ms of builds cut after each stage.
    split = pfb_stages.run(m=M, k=K)["ms"]
    print("pfb flat fm_dec stage split (CUDA graph ms, cut after each "
          "stage): " + ", ".join(f"{name} {t:.4f}" for name, t in split.items()))
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


# -- the convolution paths ----------------------------------------------------

def ols_kernel_phase(dev, kols):
    """Phase 10; returns {nfft: (max |err|, kernel ms, plain ms, bound,
    library ms, device ms)}: the library call is ``F.conv1d`` of the signal,
    the same full convolution; device ms the kernel's CUDA-graph time."""
    from simpledsp_tpu_torch.kernels.fft import _best_split
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (CB, CT), dtype=np.float32), device=dev)
    results = {}
    for nfft, m in OLS_CASES:
        taps = np.random.default_rng(m).standard_normal(m)
        n2 = _best_split(nfft)[1]
        o1 = -(-(m - 1) // n2)
        hop = nfft - o1 * n2
        nf = -(-(CT + m - 1) // hop)
        frames = torch.nn.functional.pad(x, (o1 * n2, nf * hop - CT)).unfold(
            -1, nfft, hop)
        got = kols.conv_ols_frames(frames, taps, overlap_rows=o1)
        torch.cuda.synchronize()
        t64 = kols.ols_tables(nfft, taps, torch.float64, dev)
        t32 = kols.ols_tables(nfft, taps, torch.float32, dev)
        ref = kols.conv_ols_frames_reference(frames.double(), t64, o1)
        own = kols.conv_ols_frames_reference(frames, t32, o1)
        sig2 = float((ref ** 2).sum())
        snr = 10 * np.log10(sig2 / float(((got.double() - ref) ** 2).sum()))
        plain_snr = 10 * np.log10(sig2 / float(((own.double() - ref) ** 2).sum()))
        err = float((got.double() - ref).abs().max())
        check(bool(torch.isfinite(got).all()), f"ols nfft={nfft} not finite")
        del ref, own
        def run():
            return kols.conv_ols_frames(frames, taps, overlap_rows=o1)

        ms = median_ms(run, per=STEADY)
        dev_ms = graph_ms(run, per=STEADY)
        plain_ms = median_ms(lambda: kols.conv_ols_frames_reference(
            frames, t32, o1), reps=3, per=STEADY)
        print(f"ols kernel nfft={nfft} m={m} frames={CB * nf}: {snr:.2f} dB vs "
              f"float64 plain (float32 plain {plain_snr:.2f} dB), max |err| "
              f"{err:.3e}; kernel {ms:.4f} ms, {dev_ms:.4f} ms device (CUDA "
              f"graph), float32 plain {plain_ms:.3f} ms")
        check(snr >= MIN_CONV_DB and snr >= plain_snr - 6.0,
              f"ols kernel nfft={nfft}: {snr:.2f} dB (float32 plain "
              f"{plain_snr:.2f} dB)")
        # Forward and inverse FFT of a real frame (2 x 2.5 nfft log2 nfft)
        # and the half-spectrum product (3 nfft) a frame; the padded signal
        # the frames view covers, the tables and the outputs.
        padded = x.shape[0] * (frames.shape[1] * hop + o1 * n2) * 4
        flops = frames.shape[0] * frames.shape[1] * (
            5 * nfft * np.log2(nfft) + 3 * nfft)
        b = bound(padded + nbytes(t32, got), flops)
        w = torch.as_tensor(taps[::-1].copy(), dtype=torch.float32,
                            device=dev).view(1, 1, -1)
        lib_ms = median_ms(lambda: torch.nn.functional.conv1d(
            x[:, None], w, padding=m - 1), per=STEADY)
        print(f"ols kernel nfft={nfft}: bound {b['bound_ms']:.4f} ms "
              f"({b['bound_by']}); F.conv1d of the same convolution "
              f"{lib_ms:.3f} ms")
        results[nfft] = (err, ms, plain_ms, b, lib_ms, dev_ms)
        del got, frames
    return results


def conv1d_path(dev, kols, conv, OverlapSaveFIR):
    """Phase 11; returns the overlap-save kernel's launches on the path."""
    import scipy.signal as ss

    from simpledsp_tpu_torch.kernels.fft import _best_split
    x_host = np.random.default_rng(0).standard_normal((CB, CT), dtype=np.float32)
    x = torch.as_tensor(x_host, device=dev)
    taps = np.random.default_rng(301).standard_normal(301)
    calls = {"fftconvolve same": (lambda s=x: conv.fftconvolve(s, taps, "same"),
                                  lambda r: ss.fftconvolve(r, taps, "same")),
             "convolve full": (lambda s=x: conv.convolve(s, taps, "full"),
                               lambda r: ss.convolve(r, taps, "full")),
             "correlate same": (lambda s=x: conv.correlate(s, taps, "same"),
                                lambda r: ss.correlate(r, taps, "same")),
             "oaconvolve full": (lambda s=x: conv.oaconvolve(s, taps),
                                 lambda r: ss.oaconvolve(r, taps))}
    torch.cuda.synchronize()
    zero_counts()
    outs = {}
    for name, (run, _) in calls.items():
        before = kols.ols_kernel.launches
        outs[name] = run()
        check(kols.ols_kernel.launches == before + 1,
              f"{name} launched the overlap-save kernel "
              f"{kols.ols_kernel.launches - before} times")
    torch.cuda.synchronize()
    launches = kols.ols_kernel.launches
    rows = x_host[:2].astype(np.float64)
    x64 = x.double()
    for name, (run, oracle) in calls.items():
        ref = np.stack([oracle(r) for r in rows])
        got = outs[name][:2].double().cpu().numpy()
        check(got.shape == ref.shape and np.isfinite(got).all(),
              f"{name}: shape {got.shape} != {ref.shape} or not finite")
        snr = snr_db(ref, got)
        # Every row against the same call on the float64 signal, which takes
        # the plain OverlapSaveFIR route.
        plain = run(x64)
        snr_all = snr_db_dev(plain, outs[name])
        del plain
        ms = median_ms(run, per=STEADY)
        print(f"1-D path {name}: {CB} x {CT} float32, 301 taps, 1 kernel "
              f"launch; rows 0-1 {snr:.2f} dB vs scipy float64, all {CB} rows "
              f"{snr_all:.2f} dB vs the float64 plain route; {ms:.3f} ms/call "
              f"({CB * CT / ms / 1e3:.1f} Msamples/s)")
        check(snr >= MIN_CONV_DB and snr_all >= MIN_CONV_DB,
              f"{name}: {snr:.2f} dB vs scipy, {snr_all:.2f} dB vs the float64 "
              f"plain route (bar {MIN_CONV_DB} dB)")
    del outs
    # The route's entry point, which reads the frames in place with the
    # zero history and tail, against the plain version on the padded frames.
    m = taps.size
    nfft = max(4096, 1 << (8 * m - 1).bit_length())
    n2 = _best_split(nfft)[1]
    o1 = -(-(m - 1) // n2)
    hop = nfft - o1 * n2
    nf = -(-(CT + m - 1) // hop)
    got = kols.convolve_ols_fused(x, taps, nfft=nfft)
    frames = torch.nn.functional.pad(x64, (o1 * n2, nf * hop - CT)).unfold(
        -1, nfft, hop)
    ref = kols.conv_ols_frames_reference(
        frames, kols.ols_tables(nfft, taps, torch.float64, dev), o1)
    ref = ref.reshape(CB, nf * hop)[:, : CT + m - 1]
    check(got.shape == ref.shape, f"convolve_ols_fused: shape "
                                  f"{tuple(got.shape)} != {tuple(ref.shape)}")
    snr = snr_db_dev(ref, got)
    print(f"1-D path convolve_ols_fused nfft={nfft}: all {CB} rows {snr:.2f} "
          f"dB vs conv_ols_frames_reference in float64 on the padded frames")
    check(snr >= MIN_CONV_DB, f"convolve_ols_fused: {snr:.2f} dB")
    del got, frames, ref, x64
    ols = OverlapSaveFIR(taps, block_size=4096, device=dev)
    whole, _ = ols(x)
    a, st = ols(x[:, : CT // 2])
    b, _ = ols(x[:, CT // 2:], st)
    check(torch.equal(torch.cat([a, b], -1), whole),
          "OverlapSaveFIR: 2 chained calls differ from one call")
    # nfft 128: the FFT engine's small-DFT route, whose rows must not take
    # other bits in a call of other rows.
    small = OverlapSaveFIR(taps[:40], block_size=64, device=dev)
    check(small.nfft <= 128, f"OverlapSaveFIR(40 taps, block 64) nfft "
                             f"{small.nfft}")
    whole, _ = small(x)
    parts, st = [], None
    for lo, hi in ((0, 64), (64, 256), (256, CT)):
        y, st = small(x[:, lo:hi], st)
        parts.append(y)
    check(torch.equal(torch.cat(parts, -1), whole),
          f"OverlapSaveFIR(40 taps, block 64, nfft {small.nfft}): 3 chained "
          f"calls differ from one call")
    del whole, parts
    fir_ms = median_ms(lambda: ols(x), reps=3, per=STEADY)
    n = CT + taps.size - 1
    L = 1 << (n - 1).bit_length()
    ht = torch.as_tensor(taps, dtype=torch.float32, device=dev)

    def cufft():
        return torch.fft.irfft(torch.fft.rfft(x, L) * torch.fft.rfft(ht, L),
                               L)[:, :n]

    cufft_ms = median_ms(cufft, per=STEADY)
    print(f"1-D path: OverlapSaveFIR(block 4096) streams bit for bit over 2 "
          f"chained calls, OverlapSaveFIR(40 taps, block 64, nfft "
          f"{small.nfft}) over 3; plain OverlapSaveFIR route {fir_ms:.3f} "
          f"ms/call; "
          f"torch.fft rfft/irfft (cuFFT) of the same convolution "
          f"{cufft_ms:.3f} ms")
    return launches


def conv2d_kernel_phase(dev, k2d):
    """Phase 12; returns {(kh, kw): (max |err|, kernel ms, plain ms, bound,
    library ms, device ms)}: the library call is ``F.conv2d``, VALID;
    device ms the kernel's CUDA-graph time."""
    x = torch.as_tensor(np.random.default_rng(7).standard_normal(
        (IB, IH, IH), dtype=np.float32), device=dev)
    results = {}
    for ks in ((3, 3), (9, 9), (13, 13)):
        k = np.random.default_rng(ks[0]).standard_normal(ks)
        k32 = torch.as_tensor(k, dtype=torch.float32, device=dev)
        # The image as given, padded so the output is whole 32 x 128 tiles
        # (512 x 512), and padded by k - 1 on every side as the 'same' path
        # hands it to the kernel.
        for pad in (0, ks[0] - 1, 2 * (ks[0] - 1)):
            xp = torch.nn.functional.pad(x, (0, pad, 0, pad)) if pad else x
            got = k2d.conv2d_valid_fused(xp, k)
            ref = k2d.conv2d_valid_reference(xp, k32)
            torch.cuda.synchronize()
            check(got.shape == ref.shape and torch.equal(got, ref),
                  f"conv2d kernel {ks} on {tuple(xp.shape)}: not bit for bit "
                  f"its plain version")
            del got, ref
        got = k2d.conv2d_valid_fused(x, k)
        err = float((got - k2d.conv2d_valid_reference(x, k32)).abs().max())
        ms = median_ms(lambda: k2d.conv2d_valid_fused(x, k), per=STEADY)
        dev_ms = graph_ms(lambda: k2d.conv2d_valid_fused(x, k), per=STEADY)
        plain_ms = median_ms(lambda: k2d.conv2d_valid_reference(x, k32),
                             reps=3, per=STEADY)
        print(f"conv2d kernel {ks[0]}x{ks[1]} on {IB} x {IH} x {IH}, "
              f"{IH + ks[0] - 1} and {IH + 2 * (ks[0] - 1)} square: bit for "
              f"bit its float32 plain version; kernel {ms:.4f} ms, "
              f"{dev_ms:.4f} ms device (CUDA graph), plain {plain_ms:.3f} ms "
              f"on {IH} x {IH}")
        b = bound(nbytes(x, k32, got), 2 * ks[0] * ks[1] * got.numel())
        kflip = k32.flip(0, 1).reshape(1, 1, *ks).contiguous()
        lib_ms = median_ms(lambda: torch.nn.functional.conv2d(x[:, None],
                                                              kflip),
                           per=STEADY)
        print(f"conv2d kernel {ks[0]}x{ks[1]}: bound {b['bound_ms']:.4f} ms "
              f"({b['bound_by']}); F.conv2d (TF32 off) {lib_ms:.3f} ms")
        results[ks] = (err, ms, plain_ms, b, lib_ms, dev_ms)
    return results


def conv2d_path(dev, k2d, conv2d):
    """Phase 13; returns the conv2d kernel's launches on the path."""
    import scipy.signal as ss

    x_host = np.random.default_rng(8).standard_normal((IB, IH, IH),
                                                      dtype=np.float32)
    x = torch.as_tensor(x_host, device=dev)
    k9 = np.random.default_rng(9).standard_normal((9, 9))
    k64 = np.random.default_rng(64).standard_normal((64, 64))
    img0 = x_host[0].astype(np.float64)
    # A tensor kernel takes the plain direct route: conv2d_valid_reference on
    # the same boundary-padded images, cropped the same way.
    k9t = torch.as_tensor(k9, device=dev)
    calls = [(f"convolve2d same {b}",
              lambda b=b, k=k9: conv2d.convolve2d(x, k, "same", boundary=b),
              lambda b=b: ss.convolve2d(img0, k9, "same", boundary=b), 1)
             for b in ("fill", "wrap", "symm")]
    calls.append(("correlate2d same",
                  lambda k=k9: conv2d.correlate2d(x, k, "same"),
                  lambda: ss.correlate2d(img0, k9, "same"), 1))
    calls.append(("convolve2d same 64x64 fft",
                  lambda: conv2d.convolve2d(x, k64, "same", method="fft"),
                  lambda: ss.convolve2d(img0, k64, "same"), 0))
    torch.cuda.synchronize()
    zero_counts()
    outs = []
    for name, run, _, want in calls:
        before = k2d.conv2d_kernel.launches
        outs.append(run())
        check(k2d.conv2d_kernel.launches == before + want,
              f"{name} launched the conv2d kernel "
              f"{k2d.conv2d_kernel.launches - before} times, not {want}")
    torch.cuda.synchronize()
    launches = k2d.conv2d_kernel.launches
    for (name, run, oracle, want), out in zip(calls, outs):
        ref = oracle()
        got = out[0].double().cpu().numpy()
        check(out.shape == x.shape and np.isfinite(got).all(),
              f"{name}: shape {tuple(out.shape)} or values")
        if want:
            plain = run(k=k9t)
            check(torch.equal(out, plain), f"{name}: the kernel's {IB} images "
                                           f"differ from the plain direct route")
            del plain
            rel = float(np.abs(got - ref).max() / np.abs(ref).max())
            quality = (f"image 0 max rel err {rel:.3e} vs scipy float64, all "
                       f"{IB} images bit for bit the plain direct route")
            check(rel <= DIRECT_REL, f"{name}: max rel err {rel:.3e}")
        else:
            snr = snr_db(ref, got)
            quality = f"image 0 {snr:.2f} dB vs scipy float64"
            check(snr >= MIN_CONV_DB, f"{name}: {snr:.2f} dB")
        ms = median_ms(run, per=STEADY)
        split = ""
        if want:
            # The call's device time, and its kernel's alone on the image
            # the call pads: the rest is the pad and the crop.
            b = name.split()[-1] if name.startswith("convolve2d") else "fill"
            xp = conv2d._pad_boundary(x, 9, 9, b, 0.0)
            k_run = k9 if name.startswith("correlate2d") else k9[::-1, ::-1]
            call_dev = graph_ms(run, per=STEADY)
            kern_dev = graph_ms(lambda: k2d.conv2d_valid_fused(xp, k_run),
                                per=STEADY)
            split = (f"; device {call_dev:.4f} ms/call (CUDA graph), the "
                     f"kernel {kern_dev:.4f} of it, pad and crop "
                     f"{call_dev - kern_dev:.4f}")
        print(f"2-D path {name}: {IB} x {IH} x {IH} float32, {want} kernel "
              f"launch(es); {quality}; {ms:.3f} ms/call "
              f"({IB * IH * IH / ms / 1e3:.1f} Msamples/s){split}")
    return launches


# -- the spectral transforms and the radar -----------------------------------

def snr_planes(ref, got) -> float:
    """SNR in dB of (re, im) planes ``got`` against ``ref``, in float64 on
    the device."""
    sig2 = sum(float((r.double() ** 2).sum()) for r in ref)
    err2 = sum(float(((g.double() - r.double()) ** 2).sum())
               for r, g in zip(ref, got))
    return float(10 * np.log10(sig2 / max(err2, 1e-300)))


def fft_kernel_phase(dev, kfft):
    """Phase 14; returns the record's numbers at N = 4096, forward complex."""
    rng = np.random.default_rng(14)
    main = None
    for n in FFT_SIZES:
        f = FFT_SAMPLES // n
        xr, xi = (torch.as_tensor(rng.standard_normal((f, n), dtype=np.float32),
                                  device=dev) for _ in range(2))
        xc = torch.complex(xr, xi)
        for form in ("forward", "inverse", "real"):
            inv = form == "inverse"
            if form == "real":
                planes = (xr, None)

                def run():
                    return kfft.rfft_frames(xr)

                def lib():
                    return torch.fft.fft(xr)
            else:
                planes = (xr, xi)

                def run(inv=inv):
                    return kfft.fft_frames_ri(xr, xi, inverse=inv)

                def lib(inv=inv):
                    return (torch.fft.ifft if inv else torch.fft.fft)(xc)
            s = 1.0 / n if inv else 1.0

            def plain(dtype):
                p = [None if v is None else v.to(dtype) for v in planes]
                return [v * s for v in kfft.fft_frames_reference(
                    *p, inverse=inv)]

            got = run()
            torch.cuda.synchronize()
            ref64 = plain(torch.float64)
            snr = snr_planes(ref64, got)
            plain_snr = snr_planes(ref64, plain(torch.float32))
            err = max(float((g.double() - r).abs().max())
                      for g, r in zip(got, ref64))
            check(all(bool(torch.isfinite(g).all()) for g in got),
                  f"frames FFT N={n} {form} not finite")
            del ref64
            ms = median_ms(run, per=STEADY)
            plain_ms = median_ms(lambda: plain(torch.float32), reps=3,
                                 per=STEADY)
            lib_ms = median_ms(lib, per=STEADY)
            graph = (graph_ms(run, per=STEADY), graph_ms(lib, per=STEADY))
            ops = (2.5 if form == "real" else 5.0) * n * np.log2(n) * f
            b = bound(nbytes(planes, got), ops)
            print(f"frames FFT N={n} {form} F={f}: {snr:.2f} dB vs float64 "
                  f"plain (float32 plain {plain_snr:.2f} dB), max |err| "
                  f"{err:.3e}; kernel {ms:.4f} ms, float32 plain "
                  f"{plain_ms:.3f} ms, torch.fft {lib_ms:.4f} ms, bound "
                  f"{b['bound_ms']:.4f} ms ({b['bound_by']}); CUDA graph: "
                  f"kernel {graph[0]:.4f} ms, torch.fft {graph[1]:.4f} ms")
            check(snr >= MIN_FFT_DB and snr >= plain_snr - 6.0,
                  f"frames FFT N={n} {form}: {snr:.2f} dB (float32 plain "
                  f"{plain_snr:.2f} dB)")
            if n == 4096 and form == "forward":
                main = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            library_ms=lib_ms, **b)
            del got
        del xr, xi, xc
    # rfft_ri's even / odd samples, read in place as strided planes.
    x = torch.as_tensor(rng.standard_normal((1024, 8192), dtype=np.float32),
                        device=dev)
    ev, od = x[:, 0::2], x[:, 1::2]
    got = kfft._fft_frames(ev, od, inverse=False)
    want = kfft._fft_frames(ev.contiguous(), od.contiguous(), inverse=False)
    snr = snr_planes(kfft.fft_frames_reference(ev.double(), od.double(),
                                               inverse=False), got)
    check(all(torch.equal(a, b) for a, b in zip(got, want)),
          "frames FFT: strided even / odd planes differ from their copies")
    check(snr >= MIN_FFT_DB, f"frames FFT strided: {snr:.2f} dB")
    print(f"frames FFT strided even / odd views of 1024 x 8192: bit for bit "
          f"their contiguous copies, {snr:.2f} dB vs float64 plain")
    return main


def plain_engine_ms(tfft, run, per=STEADY) -> float:
    """ms/call of ``run`` with the FFT engine's kernel routing off (the plain
    four-step matmuls): the A/B behind the port's routing."""
    gate = tfft._use_fused_kernel
    tfft._use_fused_kernel = lambda n, x: False
    try:
        return median_ms(run, reps=3, per=per)
    finally:
        tfft._use_fused_kernel = gate


def transform_path(dev, kfft, tfft, ttr, tsp):
    """Phase 15; returns the frames kernel's launches on the path."""
    import scipy.fft as sfft
    import scipy.signal as ss

    rng = np.random.default_rng(15)

    def dev32(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    def cplx(pair):
        return (pair[0].double().cpu().numpy()
                + 1j * pair[1].double().cpu().numpy())

    x1 = rng.standard_normal((1024, 4096)).astype(np.float32)
    xp = rng.standard_normal((512, 4099)).astype(np.float32)
    x2 = rng.standard_normal((4, 8192)).astype(np.float32)
    xs = rng.standard_normal((64, 262144)).astype(np.float32)
    t1, tp, t2, ts = (dev32(a) for a in (x1, xp, x2, xs))
    zp = torch.zeros_like(tp)
    spec = np.fft.rfft(x2.astype(np.float64))
    sr2, si2 = dev32(spec.real), dev32(spec.imag)
    sq = np.asarray(sr2.cpu(), np.float64) + 1j * np.asarray(si2.cpu(),
                                                              np.float64)
    sts = tsp.stft_ri(ts, 4096, hop=2048)
    win = tsp.window_taps("hann", 4096)
    edge = slice(2048, xs.shape[-1] - 2048)
    # (name, call, launches a call, output -> numpy, float64 oracle,
    #  input samples)
    cases = [
        ("dct(x, 2, norm='ortho') 1024 x 4096",
         lambda: ttr.dct(t1, 2, norm="ortho"), 1,
         lambda o: o.double().cpu().numpy(),
         lambda: sfft.dct(x1.astype(np.float64), 2, norm="ortho"), x1.size),
        ("analytic_ri 1024 x 4096", lambda: ttr.analytic_ri(t1), 2, cplx,
         lambda: ss.hilbert(x1.astype(np.float64), axis=-1), x1.size),
        ("fft_ri 512 x 4099 (Bluestein)", lambda: tfft.fft_ri(tp, zp), 2,
         cplx, lambda: np.fft.fft(xp.astype(np.float64)), xp.size),
        ("rfft_ri 4 x 8192", lambda: tfft.rfft_ri(t2), 1, cplx,
         lambda: spec, x2.size),
        ("irfft_ri 4 x 8192", lambda: tfft.irfft_ri(sr2, si2), 1,
         lambda o: o.double().cpu().numpy(),
         lambda: np.fft.irfft(sq, 8192), x2.size),
        ("stft_ri(x, 4096, hop=2048) 64 x 262144",
         lambda: tsp.stft_ri(ts, 4096, hop=2048), 1, cplx,
         lambda: np.fft.rfft(np.lib.stride_tricks.sliding_window_view(
             xs.astype(np.float64), 4096, -1)[:, ::2048] * win), xs.size),
        ("istft_ri (interior) 64 x 262144",
         lambda: tsp.istft_ri(*sts, 4096, hop=2048), 1,
         lambda o: o[:, edge].double().cpu().numpy(),
         lambda: xs[:, edge].astype(np.float64), xs.size),
        ("welch_psd(x, 4096) 64 x 262144",
         lambda: tsp.welch_psd(ts, 4096)[1], 1,
         lambda o: o.double().cpu().numpy(),
         lambda: ss.welch(xs.astype(np.float64), nperseg=4096,
                          noverlap=2048)[1], xs.size),
    ]
    torch.cuda.synchronize()
    zero_counts()
    outs = []
    for name, run, want, *_ in cases:
        before = kfft.fft_frames_kernel.launches
        outs.append(run())
        n = kfft.fft_frames_kernel.launches - before
        check(n == want, f"{name} launched the frames FFT kernel {n} times, "
                         f"not {want}")
    torch.cuda.synchronize()
    launches = kfft.fft_frames_kernel.launches
    for (name, run, want, get, oracle, samples), out in zip(cases, outs):
        got, ref = get(out), oracle()
        check(got.shape == ref.shape and np.isfinite(got).all(),
              f"{name}: shape {got.shape} != {ref.shape} or not finite")
        snr = snr_db(ref, got)
        ms = median_ms(run, per=STEADY)
        plain_ms = plain_engine_ms(tfft, run)
        print(f"transform path {name}: {want} kernel launch(es); {snr:.2f} dB "
              f"vs float64 scipy / numpy; {ms:.3f} ms/call "
              f"({samples / ms / 1e3:.1f} Msamples/s); plain four-step "
              f"engine {plain_ms:.3f} ms/call")
        check(snr >= MIN_TRANSFORM_DB, f"{name}: {snr:.2f} dB")
    # The stft's two routes at nfft 1024 and 4096: "auto" keeps the JAX
    # package's crossover (direct matmul up to 2048).
    routes = []
    for nfft in (1024, 4096):
        for method in ("direct", "fft"):
            ms = median_ms(lambda: tsp.spectrogram_ri(
                ts, nfft, hop=nfft // 2, onesided=True, method=method),
                per=STEADY)
            routes.append(f"nfft {nfft} {method} {ms:.3f} ms")
    print(f"transform path stft routes on 64 x 262144: {'; '.join(routes)}")
    # The float64 oracles of the engine never reach the kernel.
    before = kfft.fft_frames_kernel.launches
    tfft.fft_ri(t1.double(), torch.zeros_like(t1, dtype=torch.float64))
    check(kfft.fft_frames_kernel.launches == before,
          "a float64 transform launched the frames FFT kernel")
    return launches


def radar_scene(dev, radar):
    """The radar's scene (seed 0): the chirp's (re, im) and the float32 I/Q
    on the host and on ``dev``."""
    rng = np.random.default_rng(0)
    tx_re, tx_im = radar.lfm_chirp(512, 0.8)
    tx = tx_re + 1j * tx_im
    z = (rng.standard_normal((RC, RP, RS))
         + 1j * rng.standard_normal((RC, RP, RS))) * 0.05
    p = np.arange(RP)
    for delay, dop, amp in RADAR_TARGETS:
        z[:, :, delay: delay + tx.size] += (
            amp * np.exp(2j * np.pi * dop * p / RP)[:, None] * tx[None, :])
    zr, zi = z.real.astype(np.float32), z.imag.astype(np.float32)
    del z
    return (tx_re, tx_im, zr, zi, torch.as_tensor(zr, device=dev),
            torch.as_tensor(zi, device=dev))


def radar_stages(dev, scene=None) -> dict:
    """The radar map's accuracy stage by stage, SNR in dB over all 16 CPIs:
    each stage runs on the card on the float32 rounding of the float64
    result of the stage before and is held to float64 numpy on that same
    input.  "map" is phase 16's number; "map, targets' cells" and "map,
    other cells" split it into the 5 x 5 cells around each target's peak
    and the rest.  Uses only entries the port has had since the radar's
    slice, so it also runs against an earlier checkout's package."""
    import torch.nn.functional as F

    from simpledsp_tpu_torch.models import radar
    from simpledsp_tpu_torch.ops import fft as tfft
    tx_re, tx_im, zr, zi, xr, xi = scene or radar_scene(dev, radar)
    tx = tx_re + 1j * tx_im
    m = 1 << (RS + tx.size - 2).bit_length()
    hspec = np.conj(np.fft.fft(tx, m))
    w = radar.window_taps("hann", RP)[:, None]
    peaks = np.zeros((RP, RS), bool)
    for delay, dop, _ in RADAR_TARGETS:
        row = (dop + RP // 2) % RP
        peaks[row - 2: row + 3, delay - 2: delay + 3] = True
    sums = {}

    def add(key, ref, got):
        s2, e2 = sums.get(key, (0.0, 0.0))
        sums[key] = (s2 + float((np.abs(ref) ** 2).sum()),
                     e2 + float((np.abs(got - ref) ** 2).sum()))

    def planes(a):
        a = np.ascontiguousarray(a)
        return (torch.as_tensor(a.real.astype(np.float32), device=dev),
                torch.as_tensor(a.imag.astype(np.float32), device=dev))

    def host(pl):
        return pl[0].double().cpu().numpy() + 1j * pl[1].double().cpu().numpy()

    for c in range(RC):
        fz = np.fft.fft(zr[c].astype(np.float64) + 1j * zi[c], m, axis=-1)
        pad = (0, m - RS)
        add("range FFT", fz, host(tfft.fft_ri(F.pad(xr[c], pad),
                                              F.pad(xi[c], pad))))
        prod = planes(fz * hspec)
        add("inverse", np.fft.ifft(host(prod)), host(tfft.ifft_ri(*prod)))
        y = np.fft.ifft(fz * hspec)[:, :RS]
        add("matched filter", y,
            host(radar.matched_filter_ri(xr[c], xi[c], tx_re, tx_im)))
        cols = planes((y * w).T)
        add("Doppler FFT", np.fft.fft(host(cols)), host(tfft.fft_ri(*cols)))
        ref = np.roll(np.abs(np.fft.fft(y * w, axis=0)) ** 2, RP // 2, axis=0)
        got = radar.range_doppler_map(xr[c], xi[c], tx_re, tx_im)
        got = got.double().cpu().numpy()
        add("map", ref, got)
        add("map, targets' cells", ref[peaks], got[peaks])
        add("map, other cells", ref[~peaks], got[~peaks])
    return {k: float(10 * np.log10(s2 / e2)) for k, (s2, e2) in sums.items()}


def radar_path(dev, kfft, tfft, radar, kcfar):
    """Phase 16; returns the frames kernel's launches on the path and the
    CFAR kernel's record."""
    scene = radar_scene(dev, radar)
    tx_re, tx_im, zr, zi, xr, xi = scene
    tx = tx_re + 1j * tx_im

    def run():
        rdm = radar.range_doppler_map(xr, xi, tx_re, tx_im)
        return rdm, radar.cfar_ca(rdm, guard=2, train=12, pfa=1e-5)[0]

    torch.cuda.synchronize()
    zero_counts()
    rdm, det = run()
    torch.cuda.synchronize()
    launches = kfft.fft_frames_kernel.launches
    check(launches == 3, f"range_doppler_map launched the frames FFT kernel "
                         f"{launches} times, not 3")
    cfar_launches = kcfar.cfar_kernel.launches
    check(cfar_launches == 1, f"cfar_ca launched the CFAR kernel "
                              f"{cfar_launches} times, not once")
    check(rdm.shape == (RC, RP, RS) and bool(torch.isfinite(rdm).all()),
          f"range-Doppler map shape {tuple(rdm.shape)} or values")
    # float64 numpy oracle on the same float32 I/Q, one CPI at a time.
    m = 1 << (RS + tx.size - 2).bit_length()
    hspec = np.conj(np.fft.fft(tx, m))
    w = radar.window_taps("hann", RP)[:, None]
    sig2 = err2 = 0.0
    for c in range(RC):
        zc = zr[c].astype(np.float64) + 1j * zi[c].astype(np.float64)
        y = np.fft.ifft(np.fft.fft(zc, m, axis=-1) * hspec)[:, :RS]
        d = np.fft.fft(y * w, axis=0)
        ref = np.roll(np.abs(d) ** 2, RP // 2, axis=0)
        got = rdm[c].double().cpu().numpy()
        sig2 += float((ref ** 2).sum())
        err2 += float(((got - ref) ** 2).sum())
    snr = 10 * np.log10(sig2 / err2)
    dets = det.cpu().numpy()
    hits = []
    for delay, dop, _ in RADAR_TARGETS:
        row = (dop + RP // 2) % RP
        patch = dets[:, max(0, row - 1): row + 2, max(0, delay - 2): delay + 3]
        hits.append(int(patch.any(axis=(1, 2)).sum()))
    frac = float(dets.mean())
    ms = median_ms(run, per=3)
    plain_ms = plain_engine_ms(tfft, run, per=3)
    print(f"radar path: {RC} CPIs x {RP} pulses x {RS} cells complex float32, "
          f"{launches} kernel launches a call; map {snr:.2f} dB vs float64 "
          f"numpy; targets detected in {hits} of {RC} CPIs; detection-cell "
          f"fraction {frac:.3e}; {ms:.3f} ms/call "
          f"({RC * RP * RS / ms / 1e3:.1f} Msamples/s); plain four-step "
          f"engine {plain_ms:.3f} ms/call")
    stages = radar_stages(dev, scene)
    print("radar stages, dB against float64 numpy on each stage's float32 "
          "input: " + ", ".join(f"{k} {v:.2f}" for k, v in stages.items()))
    check(snr >= MIN_TRANSFORM_DB, f"radar map {snr:.2f} dB")
    check(all(h == RC for h in hits), f"radar targets detected in {hits} CPIs")
    check(frac < 5e-3, f"radar detection-cell fraction {frac:.3e}")
    # The CFAR kernel against the rolled route on the same map: equal bits.
    alpha = 24 * (1e-5 ** (-1.0 / 24) - 1.0)
    det, thresh = radar.cfar_ca(rdm, guard=2, train=12, pfa=1e-5)
    rdet, rthresh = kcfar.cfar_rolled(rdm, 2, 12, alpha)
    check(torch.equal(thresh, rthresh) and torch.equal(det, rdet),
          "the CFAR kernel's bits differ from the rolled route's")
    cfar_ms = graph_ms(lambda: radar.cfar_ca(rdm, guard=2, train=12,
                                             pfa=1e-5))
    rolled_ms = graph_ms(lambda: kcfar.cfar_rolled(rdm, 2, 12, alpha), per=4)
    cells = rdm.numel()
    # Its own count: roofline_radar counts the CFAR only inside the whole
    # call, with the same operations, 2 T + 1 a cell (T = 12).  Bytes: the
    # map read once, the threshold and the mask written once.
    cfar_bound = bound(cells * (2 * roofline.F32 + 1), cells * (2 * 12 + 1.0))
    print(f"radar CFAR (guard 2, train 12) on the {RC} x {RP} x {RS} map: "
          f"{cfar_launches} CFAR kernel launch a call, device "
          f"{cfar_ms:.4f} ms (bound {cfar_bound['bound_ms']:.4f} ms, "
          f"{cfar_bound['bound_by']}: "
          f"{100 * cfar_bound['bound_ms'] / cfar_ms:.1f} %), the rolled "
          f"route {rolled_ms:.4f} ms; bits equal")
    return launches, {
        "name": "cfar", "route": "cuda",
        "source": "simpledsp_tpu_torch/csrc/cfar.cu", "replaces": None,
        "launches": cfar_launches, "max_abs_err": 0.0, "ms": None,
        "device_ms": cfar_ms, "plain_ms": rolled_ms, **cfar_bound,
        "library_ms": None}


# -- the rest of the chain kernel family ----------------------------------------

FULL_SIZES = (1000, 1024, 4096, 16384, 375, 8181, 16129)   # odd: 375 ...
LAYOUT_SIZES = (200, 1024, 4096, 16384)
FAMILY_C = 16               # channels of T samples per size in phase 17
# (record name, form timed in phase 17, source, TPU kernel replaced)
FAMILY_RECORDS = (
    ("chain_full", "full", "chain.cu", "simpledsp_tpu/kernels/chain.py:425"),
    ("chain_regs", "regs", "chain_tc.cu",
     "simpledsp_tpu/kernels/chain_variants.py:67"),
    ("chain_grouped", "reg2", "chain.cu",
     "simpledsp_tpu/kernels/chain_variants.py:227"),
    ("chain_store", "regw", "chain.cu",
     "simpledsp_tpu/kernels/chain_variants.py:144"),
)


def chain_bound(x3, channels: int, sections: int) -> dict:
    """A chain row's bound on the frames ``x3`` (C F, n1, n2) of ``channels``
    channels: the benchmark's count of the algorithm
    (``roofline.chain_work``, which ``chain_kernel_roofline`` reads), the
    same for every form and layout."""
    frames, n1, n2 = x3.shape
    w = roofline.chain_work(channels, frames // channels * n1 * n2, n1 * n2,
                            sections, 2 * (sections + 1))
    return bound(w["bytes"], w["flops"])


def natural(planes):
    """(F, n1, n2/2) k1-major rows ("fmajor") as (F, N/2) natural order."""
    return tuple(p.transpose(1, 2).reshape(p.shape[0], -1) if p.dim() == 3
                 else p for p in planes)


def chain_family_phase(dev, kchain, kcv, design):
    """Phase 17; returns {(form, n): numbers}: form "full" or a layout."""
    rng = np.random.default_rng(17)
    x_noise = torch.as_tensor(rng.standard_normal((FAMILY_C, T),
                                                  dtype=np.float32), device=dev)
    results = {}
    for n in sorted(set(FULL_SIZES + LAYOUT_SIZES)):
        ops = kchain.FusedNorthStarOperators(design, n, device=dev)
        s0 = torch.zeros(FAMILY_C, ops.state_dim, device=dev)
        x3, s3, _ = kchain.chain_prepass(
            ops, x_noise[:, : T - T % n].contiguous(), s0)
        x64, s64 = x3.double(), s3.double()
        tabs = ops.tables()
        ftabs = ops.tables(full=True)
        # (form, kernel run, float32 plain run, float64 plain run)
        cases = []
        if n in FULL_SIZES:
            cases.append((
                "full", lambda: kchain.chain_frames_full(x3, s3, ftabs),
                lambda: kchain.chain_frames_full_reference(x3, s3, ftabs),
                lambda: kchain.chain_frames_full_reference(
                    x64, s64, kchain.ChainTables(*(t.double() for t in ftabs)))))
        groups = {}
        if n in LAYOUT_SIZES:
            r = kchain._tile_frames(x3.shape[0], n, 4, 64)

            def half64():
                return kchain.chain_frames_reference(
                    x64, s64, kchain.ChainTables(*(t.double() for t in tabs)))

            def plain():
                return kchain.chain_frames_reference(x3, s3, tabs)

            for layout in kchain.LAYOUTS:
                own_plain = plain
                if layout in ("reg", "k1"):
                    def run():
                        return kchain.chain_frames(x3, s3, tabs)
                elif layout == "regs":
                    def run():
                        return kcv.chain_frames_regs(x3, s3, tabs)

                    def own_plain():
                        return kcv.chain_frames_regs_reference(x3, s3, tabs)
                elif layout in ("regw", "fmajor"):
                    def run(mode="wide" if layout == "regw" else "fmajor"):
                        return kcv.chain_frames_store(x3, s3, tabs, mode)
                else:
                    g = groups[layout] = kcv.group_frames(
                        layout, ops.n1, ops.n2, r, ops.state_dim)

                    def run(g=g):
                        return kcv.chain_frames_grouped(x3, s3, tabs, g)
                cases.append((layout, run, own_plain, half64))
        refs = {}
        reg = None
        for form, run, plain32, plain64 in cases:
            got = natural(run())
            torch.cuda.synchronize()
            extra = ""
            if form in groups:
                extra = f", g = {groups[form]}, chain_natural_kernel"
            elif form == "reg":
                reg = got
            elif form in ("regw", "fmajor"):
                same = all(torch.equal(a, b) for a, b in zip(got, reg))
                extra = f", chain_natural_kernel, reg's bits: {same}"
                check(same, f"chain family {form} N={n}: not reg's bits")
            key = "full" if form == "full" else "half"
            if key not in refs:
                refs[key] = plain64()
            ref = refs[key]
            snr = snr_planes(ref, got)
            own = snr_planes(ref, natural(plain32()))
            err = max(float((g_.double() - r_).abs().max())
                      for g_, r_ in zip(got, ref))
            finite = all(bool(torch.isfinite(g_).all()) for g_ in got)
            ms = median_ms(run)
            plain_ms = median_ms(plain32, reps=3)
            rec = dict(snr=snr, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       **chain_bound(x3, FAMILY_C, design.nsections))
            results[(form, n)] = rec
            print(f"chain family {form} N={n} ({ops.n1} x {ops.n2}{extra}) "
                  f"frames={x3.shape[0]}: {snr:.2f} dB vs float64 plain "
                  f"(float32 plain {own:.2f} dB), max |err| {err:.3e}; kernel "
                  f"{ms:.4f} ms, float32 plain {plain_ms:.3f} ms, bound "
                  f"{rec['bound_ms']:.4f} ms ({rec['bound_by']})")
            check(finite and snr >= MIN_SNR_DB,
                  f"chain family {form} N={n}: {snr:.2f} dB < {MIN_SNR_DB} dB "
                  f"or not finite")
            del got
        del refs, reg, x3, s3, x64, s64
    return results


def full_path(dev, kchain, kcv, design, chain_ms):
    """Phases 18-19; returns (full-spectrum launches, {kernel name: layout
    path launches})."""
    import scipy.signal as ss

    from simpledsp_tpu_torch.design.biquad import sos_matrix
    ops = kchain.FusedNorthStarOperators(design, MAIN_N)
    check(ops.H.device.type == "cuda", "FusedNorthStarOperators default "
                                       "device is not CUDA")
    rng = np.random.default_rng(18)
    x_host = [rng.standard_normal((C, T)).astype(np.float32)
              for _ in range(CALLS)]
    xs = [torch.as_tensor(x, device=dev) for x in x_host]
    nf, n1, n2 = T // MAIN_N, ops.n1, ops.n2
    family = [kchain.chain_kernel, kchain.chain_full_kernel,
              kcv.chain_regs_kernel, kcv.chain_grouped_kernel,
              kcv.chain_store_kernel]
    torch.cuda.synchronize()
    zero_counts()
    outs, state = [], torch.zeros(C, ops.state_dim, device=dev)
    for i, x in enumerate(xs):
        before = kchain.chain_full_kernel.launches
        (yr, yi), state = kchain.fused_chain_frames(ops, x, state)
        check(kchain.chain_full_kernel.launches == before + 1,
              f"full path call {i} launched the full-spectrum kernel "
              f"{kchain.chain_full_kernel.launches - before} times")
        outs.append((yr[:2], yi[:2]))
    torch.cuda.synchronize()
    launches = kchain.chain_full_kernel.launches
    others = sum(k.launches for k in family) - launches
    check(launches == CALLS and others == 0,
          f"full path: {launches} full-spectrum launches, {others} others")
    for i, (yr, yi) in enumerate(outs):
        check(yr.shape == yi.shape == (2, nf, n2, n1)
              and bool(torch.isfinite(yr).all() and torch.isfinite(yi).all()),
              f"full path call {i}: shape {tuple(yr.shape)} or values")

    def oracle(x64):
        y = ss.sosfilt(sos_matrix(design), x64, axis=-1)
        return np.fft.fft(y.reshape(x64.shape[0], -1, MAIN_N))

    def spectrum(yr, yi):
        return (yr.double() + 1j * yi.double()).reshape(
            yr.shape[0], nf, MAIN_N).cpu().numpy()

    ref0 = oracle(x_host[0][:2].astype(np.float64))
    snr_call0 = snr_db(ref0, spectrum(*outs[0]))
    x01 = np.concatenate([x_host[0][:1], x_host[1][:1]], -1).astype(np.float64)
    got01 = np.concatenate([spectrum(yr[:1], yi[:1]) for yr, yi in outs[:2]],
                           axis=1)
    snr_stream = snr_db(oracle(x01), got01)
    print(f"full path: fused_chain_frames(ops, x, s0) at N={MAIN_N}, {CALLS} "
          f"calls of {C} x {T} float32, full-spectrum launches {launches}; "
          f"call 0 channels 0-1 {snr_call0:.2f} dB, calls 0-1 channel 0 "
          f"continuity {snr_stream:.2f} dB vs float64 scipy + numpy fft")
    check(snr_call0 >= MIN_SNR_DB, f"full path {snr_call0:.2f} dB")
    check(snr_stream >= MIN_SNR_DB, f"full path continuity {snr_stream:.2f} dB")
    del outs
    s0 = torch.zeros(C, ops.state_dim, device=dev)
    full_ms = median_ms(lambda: kchain.fused_chain_frames(ops, xs[0], s0))
    print(f"full path timing: {full_ms:.3f} ms/call "
          f"({C * T / full_ms / 1e3:.1f} Msamples/s); NorthStarChain half "
          f"spectrum {chain_ms:.3f} ms/call in this run")

    # -- 19. the layouts through the same entry, one call each
    ref_half = ref0[..., : MAIN_N // 2].copy()
    ref_half[..., 0] += 1j * ref0[..., MAIN_N // 2].real
    variants = {"regs": kcv.chain_regs_kernel, "regw": kcv.chain_store_kernel,
                "fmajor": kcv.chain_store_kernel,
                "reg2": kcv.chain_grouped_kernel,
                "reg4": kcv.chain_grouped_kernel,
                "regp": kcv.chain_grouped_kernel,
                "pair": kcv.chain_grouped_kernel}
    torch.cuda.synchronize()
    zero_counts()
    quality = []
    for layout, kernel in variants.items():
        before = sum(k.launches for k in family)
        mine = kernel.launches
        (zr, zi), _ = kchain.fused_chain_frames(ops, xs[0], s0,
                                                half_spectrum=True,
                                                layout=layout)
        check(kernel.launches == mine + 1
              and sum(k.launches for k in family) == before + 1,
              f"layout {layout}: not one launch of its kernel")
        check(zr.shape == (C, nf, n2 // 2, n1), f"layout {layout}: shape "
                                                f"{tuple(zr.shape)}")
        got = (zr[:2].double() + 1j * zi[:2].double()).reshape(
            2, nf, -1).cpu().numpy()
        snr = snr_db(ref_half, got)
        extra = (f", g = {kcv.chain_grouped_kernel.last_g}"
                 if kernel is kcv.chain_grouped_kernel else "")
        check(snr >= MIN_SNR_DB, f"layout {layout}: {snr:.2f} dB")
        quality.append(f"{layout} {snr:.2f} dB{extra}")
        del zr, zi
    torch.cuda.synchronize()
    counts = {"chain_regs": kcv.chain_regs_kernel.launches,
              "chain_grouped": kcv.chain_grouped_kernel.launches,
              "chain_store": kcv.chain_store_kernel.launches}
    print(f"layout path: fused_chain_frames(half_spectrum=True, layout=...) "
          f"on call 0, channels 0-1 vs float64 oracle: {'; '.join(quality)}; "
          f"launches {counts}")
    times = []
    for lay in ("regs", "regw", "reg2", "pair"):
        ms = median_ms(lambda: kchain.fused_chain_frames(
            ops, xs[0], s0, half_spectrum=True, layout=lay), reps=3)
        times.append(f"{lay} {ms:.3f} ms/call")
    print(f"layout path timing: {'; '.join(times)}")
    return launches, counts


# -- the probes -------------------------------------------------------------------

PROBES = ("probe_dma_scale", "probe_store", "probe_dispatch", "probe_hlo",
          "probe_transpose", "probe_relayout", "probe_mosaic")
# (record name, wrapper in kernels/probes.py, probe and key of its numbers,
#  the TPU kernels it replaces)
PROBE_RECORDS = (
    ("scale_copy", "scale_copy_kernel", ("probe_dma_scale", "record"),
     "tools/probe_dispatch.py:30, tools/probe_dma_scale.py:18, "
     "tools/probe_store.py:59, tools/probe_hlo.py:17"),
    ("permute", "permute_kernel", ("probe_relayout", "record"),
     "tools/probe_store.py:68, tools/probe_relayout.py:33, "
     "tools/probe_transpose.py:82, tools/probe_mosaic.py:129"),
    ("contract", "contract_kernel", ("probe_mosaic", "k1"),
     "tools/probe_mosaic.py:36, tools/probe_mosaic.py:62"),
    ("row_sum", "row_sum_kernel", ("probe_mosaic", "k3"),
     "tools/probe_mosaic.py:97"),
)


def brief(obj):
    """A probe's result for the log: floats to 5 significant digits, each
    call's trace events cut to the 4 longest."""
    if isinstance(obj, float):
        return float(f"{obj:.5g}")
    if isinstance(obj, dict):
        return {k: brief(v[:4] if k == "events" else v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [brief(v) for v in obj]
    return obj


def probe_phase(dev, kprobes):
    """Phase 20; returns the probe kernels' records."""
    import importlib
    from pathlib import Path
    torch.cuda.synchronize()
    zero_counts()
    results = {}
    for name in PROBES:
        start = time.perf_counter()
        module = importlib.import_module(f"simpledsp_tpu_torch.tools.{name}")
        results[name] = module.run(dev)
        torch.cuda.synchronize()
        print(f"probe {name} ({time.perf_counter() - start:.1f} s): "
              f"{json.dumps(brief(results[name]))}")
    launches = {rec: getattr(kprobes, attr).launches
                for rec, attr, _, _ in PROBE_RECORDS}
    check(all(n > 0 for n in launches.values()),
          f"a probe kernel did not launch on the probe path: {launches}")
    out = Path(__file__).resolve().parent / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "probes.json").write_text(json.dumps(results, indent=1))
    records, device = [], []
    for rec, _, (probe, key), replaces in PROBE_RECORDS:
        r = results[probe][key]
        records.append({
            "name": rec, "route": "cuda",
            "source": "simpledsp_tpu_torch/csrc/probes.cu",
            "replaces": replaces, "launches": launches[rec],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            **({"device_ms": r["device_ms"]} if "device_ms" in r else {}),
            "plain_ms": r["plain_ms"], **bound(r["bytes"], r["flops"]),
            "library_ms": r["library_ms"]})
        if "device_ms" in r:
            device.append(f"{rec} {r['device_ms']:.4f} (library "
                          f"{r['library_device_ms']:.4f})")
    print(f"probe kernels: launches on the probe path {launches}; " + "; ".join(
        f"{r['name']} {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, library "
        f"{r['library_ms']:.4f}, bound {r['bound_ms']:.4f} {r['bound_by']})"
        for r in records))
    print("probe kernels, CUDA-graph (device) ms: " + "; ".join(device)
          + f"; y.copy_(x) at the scale_copy record's size "
          f"{results['probe_dma_scale']['record']['copy_device_ms']:.4f}")
    return records


# -- the filtering surface, audio and comms -----------------------------------

FC, FT = 64, 1 << 20        # filtering: rows, samples per row (the chain's)
AC, AT, AFS = 64, 262144, 16000.0   # audio: rows, samples, Hz (the stft cell)
MIN_FILTER_DB = 100.0
IIR_REL = 1e-9              # float64 on the card against scipy, of the peak
SLOW = dict(reps=3, per=3)  # windows for the block-loop-bound calls


def rel_err(ref: np.ndarray, got: np.ndarray) -> float:
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def filtering_path(dev):
    """Phase 21; returns the launches of the overlap-save and frames FFT
    kernels on the path."""
    import scipy.signal as ss

    from simpledsp_tpu_torch.design.biquad import design_lowpass, sos_matrix
    from simpledsp_tpu_torch.design.iir import butter
    from simpledsp_tpu_torch.kernels import fft as kfft
    from simpledsp_tpu_torch.kernels import ols as kols
    from simpledsp_tpu_torch.ops import fir, iir, lfilter as lf

    host = np.random.default_rng(21).standard_normal((FC, FT),
                                                     dtype=np.float32)
    x = torch.as_tensor(host, device=dev)
    rows = host[:2].astype(np.float64)
    b, a = butter(4, 0.2, output="ba")
    design = design_lowpass(4, 2000.0, 39000.0)
    sos = sos_matrix(design)
    h = ss.firwin(61, 0.3)
    # (name, call on a signal, scipy float64 oracle on rows, IIR?)
    cases = [
        ("lfilter(butter(4, 0.2))", lambda s: lf.lfilter(b, a, s)[0],
         lambda r: ss.lfilter(b, a, r, axis=-1), True),
        ("filtfilt(butter(4, 0.2))", lambda s: lf.filtfilt(b, a, s),
         lambda r: ss.filtfilt(b, a, r, axis=-1), True),
        ("sosfiltfilt(design_lowpass(4, 2000, 39000))",
         lambda s: iir.sosfiltfilt(design, s),
         lambda r: ss.sosfiltfilt(sos, r, axis=-1), True),
        ("decimate(x, 8) iir", lambda s: fir.decimate(s, 8),
         lambda r: ss.decimate(r, 8, axis=-1), True),
        ("decimate(x, 8) fir", lambda s: fir.decimate(s, 8, ftype="fir"),
         lambda r: ss.decimate(r, 8, ftype="fir", axis=-1), False),
        ("resample_poly(x, 3, 2)", lambda s: fir.resample_poly(s, 3, 2),
         lambda r: ss.resample_poly(r, 3, 2, axis=-1), False),
        ("upfirdn(firwin(61, 0.3), x, 3, 2)",
         lambda s: fir.upfirdn(h, s, 3, 2),
         lambda r: ss.upfirdn(h, r, 3, 2, axis=-1), False),
        ("resample(x, 2**19)", lambda s: fir.resample(s, FT // 2),
         lambda r: ss.resample(r, FT // 2, axis=-1), False),
    ]
    torch.cuda.synchronize()
    zero_counts()
    outs, per_call = [], []
    for name, run, _, _ in cases:
        before = (kols.ols_kernel.launches, kfft.fft_frames_kernel.launches)
        outs.append(run(x))
        per_call.append((kols.ols_kernel.launches - before[0],
                         kfft.fft_frames_kernel.launches - before[1]))
    torch.cuda.synchronize()
    launches = (kols.ols_kernel.launches, kfft.fft_frames_kernel.launches)
    names = [c[0] for c in cases]
    check(per_call[names.index("decimate(x, 8) fir")][0] == 1,
          f"decimate fir launched the overlap-save kernel "
          f"{per_call[names.index('decimate(x, 8) fir')][0]} times, not 1")
    check(per_call[names.index("resample(x, 2**19)")][1] >= 1,
          "resample launched no frames FFT kernel")
    for (name, run, oracle, is_iir), out, (n_ols, n_fft) in zip(
            cases, outs, per_call):
        ref = oracle(rows)
        got = out[:2].double().cpu().numpy()
        check(got.shape == ref.shape and np.isfinite(got).all(),
              f"{name}: shape {got.shape} != {ref.shape} or not finite")
        snr = snr_db(ref, got)
        ms = median_ms(lambda: run(x), **(SLOW if is_iir else
                                          dict(reps=3, per=STEADY)))
        head = (f"filtering path {name}: {FC} x {FT} float32, "
                f"{n_ols} overlap-save and {n_fft} frames FFT launch(es); "
                f"rows 0-1 {snr:.2f} dB vs scipy float64")
        if is_iir:
            cpu = run(torch.as_tensor(host[:2]))
            cpu_snr = snr_db(ref, cpu.double().numpy())
            f64 = rel_err(ref, run(torch.as_tensor(rows, device=dev))
                          .cpu().numpy())
            print(f"{head} (the same call on the CPU in float32 {cpu_snr:.2f} "
                  f"dB); float64 on the card {f64:.3e} of the peak; "
                  f"{ms:.3f} ms/call ({FC * FT / ms / 1e3:.1f} Msamples/s)")
            check(snr >= cpu_snr - 6.0 and f64 <= IIR_REL,
                  f"{name}: {snr:.2f} dB (CPU float32 {cpu_snr:.2f} dB), "
                  f"float64 {f64:.3e} of the peak")
        else:
            # Every row against the same call on the float64 signal, which
            # takes the plain routes (no hand kernel runs float64).
            snr_all = snr_db_dev(run(x.double()), out)
            print(f"{head}, all {FC} rows {snr_all:.2f} dB vs the float64 "
                  f"plain route; {ms:.3f} ms/call "
                  f"({FC * FT / ms / 1e3:.1f} Msamples/s)")
            check(snr >= MIN_FILTER_DB and snr_all >= MIN_FILTER_DB,
                  f"{name}: {snr:.2f} dB vs scipy, {snr_all:.2f} dB vs the "
                  f"float64 plain route")
    return launches


def audio_path(dev):
    """Phase 22: the mel spectrogram, MFCCs and Griffin-Lim at the stft
    cell's shape.  nfft 512 takes the stft's direct route (one matmul), so
    the path launches no hand kernel; checked."""
    import scipy.fft as sfft

    from simpledsp_tpu_torch.models import audio
    from simpledsp_tpu_torch.ops.spectral import stft_ri, window_taps

    host = np.random.default_rng(22).standard_normal((AC, AT),
                                                     dtype=np.float32)
    x = torch.as_tensor(host, device=dev)
    mel = audio.MelSpectrogram(512, 256, 64, AFS)
    energies = audio.MelSpectrogram(512, 256, 64, AFS, log=False)
    energies64 = audio.MelSpectrogram(512, 256, 64, AFS, log=False,
                                      dtype=torch.float64)
    torch.cuda.synchronize()
    zero_counts()
    e32 = energies(x)
    c32 = audio.mfcc(x, n_mfcc=13)
    torch.cuda.synchronize()
    check(all(k.launches == 0 for k in KERNELS),
          "the audio path launched a hand kernel")
    x64 = x.double()
    e_snr = snr_db_dev(energies64(x64), e32)
    c64 = audio.mfcc(x64, n_mfcc=13, dtype=torch.float64)
    c_snr = snr_db_dev(c64, c32)
    # numpy oracle on rows 0-1: scipy.signal.stft's frames (periodic hann,
    # no scaling), |rfft|^2, the filterbank, log, orthonormal DCT-II.
    rows = host[:2].astype(np.float64)
    frames = np.lib.stride_tricks.sliding_window_view(rows, 512, -1)[:, ::256]
    power = np.abs(np.fft.rfft(frames * window_taps("hann", 512))) ** 2
    logmel = np.log(np.maximum(power @ audio.mel_filterbank(64, 512, AFS).T,
                               1e-10))
    ref = sfft.dct(logmel, type=2, norm="ortho", axis=-1)[..., :13]
    got = c64[:2].cpu().numpy()
    check(got.shape == ref.shape, f"mfcc shape {got.shape} != {ref.shape}")
    oracle_err = float(np.abs(got - ref).max() / max(1.0, np.abs(ref).max()))
    mel_ms = median_ms(lambda: mel(x), reps=3, per=STEADY)
    mfcc_ms = median_ms(lambda: audio.mfcc(x, n_mfcc=13), reps=3, per=STEADY)
    # Griffin-Lim on 4 rows: the spectral convergence after n iterations.
    sr, si = stft_ri(x[:4], 512, hop=128)
    mag = torch.hypot(sr, si)

    def convergence(n):
        y = audio.griffin_lim(mag, nfft=512, hop=128, n_iter=n)
        yr, yi = stft_ri(y, 512, hop=128)
        return float(torch.linalg.norm(torch.hypot(yr, yi) - mag)
                     / torch.linalg.norm(mag))

    conv = [convergence(n) for n in range(9)]
    gl_ms = median_ms(lambda: audio.griffin_lim(mag, nfft=512, hop=128,
                                                n_iter=8), reps=3, per=1)
    print(f"audio path: {AC} x {AT} float32 at {AFS:g} Hz, nfft 512 hop 256, "
          f"64 mels: no hand kernel (the stft's direct route); mel energies "
          f"{e_snr:.2f} dB and MFCCs {c_snr:.2f} dB vs the port in float64 on "
          f"the card; float64 MFCCs rows 0-1 {oracle_err:.3e} of the peak vs "
          f"a numpy oracle; MelSpectrogram {mel_ms:.3f} ms/call, mfcc "
          f"{mfcc_ms:.3f} ms/call ({AC * AT / mfcc_ms / 1e3:.1f} Msamples/s)")
    print(f"audio path griffin_lim 4 x {AT}, nfft 512 hop 128: spectral "
          f"convergence after 0-8 iterations "
          f"{', '.join(f'{c:.5f}' for c in conv)}; 8 iterations "
          f"{gl_ms:.3f} ms/call")
    check(e_snr >= MIN_FILTER_DB and c_snr >= MIN_FILTER_DB,
          f"audio float32: energies {e_snr:.2f} dB, MFCCs {c_snr:.2f} dB")
    check(oracle_err <= IIR_REL, f"audio float64 vs numpy {oracle_err:.3e}")
    # The first fast-GL step extrapolates from the zero-phase start and may
    # rise; from the first iterate on the error must not.
    check(all(np.isfinite(conv)) and conv[8] < conv[0]
          and all(b <= a for a, b in zip(conv[1:], conv[2:])),
          f"griffin_lim spectral convergence {conv}")


def comms_path(dev):
    """Phase 23; returns the overlap-save kernel's launches on the path."""
    from scipy.special import erfc

    from simpledsp_tpu_torch.kernels import ols as kols
    from simpledsp_tpu_torch.models import comms
    from simpledsp_tpu_torch.ops.conv import convolve

    gen = torch.Generator(device=dev).manual_seed(23)
    qpsk = comms.Constellation.qpsk()
    ebn0 = 4.0
    theory = 0.5 * erfc(np.sqrt(10.0 ** (ebn0 / 10.0)))
    # span 8 as the JAX package's tests run it (65 taps: convolve's direct
    # route) and span 16 (129 taps: the overlap-save kernel).
    modems = {span: comms.LinearModem(qpsk, sps=8, span=span, beta=0.35)
              for span in (8, 16)}
    bits = torch.randint(0, 2, (64, 2 * 65536), device=dev, generator=gen)
    torch.cuda.synchronize()
    zero_counts()
    results = {}
    for span, modem in modems.items():
        before = kols.ols_kernel.launches
        planes = modem.modulate(bits)
        rx, _ = modem.demodulate(*planes)
        n_ols = kols.ols_kernel.launches - before
        results[span] = (planes, rx, n_ols)
    ofdm = comms.OFDMModem(qpsk, n_fft=64, cp=16)
    obits = torch.randint(0, 2, (64, 4096 * ofdm.bits_per_symbol),
                          device=dev, generator=gen)
    otx = ofdm.modulate(obits)
    orx, _ = ofdm.demodulate(*otx)
    h = np.array([1.0, 0.4 - 0.2j, -0.15 + 0.1j])
    faded = convolve(torch.complex(*otx), h)[..., : otx[0].shape[-1]]
    frx, _ = ofdm.demodulate(faded.real, faded.imag,
                             channel=(h.real, h.imag))
    torch.cuda.synchronize()
    launches = kols.ols_kernel.launches
    check(results[16][2] == 2 and results[8][2] == 0,
          f"LinearModem demodulate launched the overlap-save kernel "
          f"{results[16][2]} (span 16, 129 taps) / {results[8][2]} (span 8, "
          f"65 taps) times, not 2 / 0")
    for span, modem in modems.items():
        planes, rx, n_ols = results[span]
        n = rx.shape[-1]
        clean = float(comms.ber(bits[:, :n], rx))
        # The symbol planes of all 64 rows against demodulate on the float64
        # planes, which takes the plain routes (no hand kernel runs float64).
        sym = modem.demodulate(*planes)[1]
        sym_snr = snr_planes(modem.demodulate(*(p.double() for p in planes))[1],
                             sym)
        snr_db_ = ebn0 + 10.0 * np.log10(2) - 10.0 * np.log10(modem.sps)
        noisy, _ = modem.demodulate(*comms.awgn(gen, planes, snr_db_,
                                                signal_power=1.0))
        measured = float(comms.ber(bits[:, :n], noisy))
        tx_ms = median_ms(lambda: modem.modulate(bits), reps=3, per=STEADY)
        rx_ms = median_ms(lambda: modem.demodulate(*planes), reps=3,
                          per=STEADY)
        print(f"comms path LinearModem QPSK sps 8 span {span} beta 0.35 "
              f"({modem._h_rx.size} taps), 64 x 65536 symbols: {n_ols} "
              f"overlap-save launches a demodulate; symbol planes, all 64 rows, "
              f"{sym_snr:.2f} dB vs the float64 plain route; noiseless BER "
              f"{clean:g}; "
              f"Eb/N0 {ebn0:g} dB BER {measured:.5f} (theory {theory:.5f}); "
              f"modulate {tx_ms:.3f} ms/call, demodulate {rx_ms:.3f} ms/call")
        check(sym_snr >= MIN_FILTER_DB,
              f"LinearModem span {span}: symbol planes {sym_snr:.2f} dB vs "
              f"the float64 plain route")
        check(clean == 0.0, f"LinearModem span {span}: noiseless BER {clean}")
        check(0.6 * theory < measured < 1.6 * theory,
              f"LinearModem span {span}: BER {measured} vs theory {theory}")
    clean = float(comms.ber(obits, orx))
    osym = snr_planes(ofdm.demodulate(*(p.double() for p in otx))[1],
                      ofdm.demodulate(*otx)[1])
    faded_ber = float(comms.ber(obits, frx))
    noisy, _ = ofdm.demodulate(*comms.awgn(gen, otx,
                                           ebn0 + 10.0 * np.log10(2),
                                           signal_power=1.0))
    measured = float(comms.ber(obits, noisy))
    tx_ms = median_ms(lambda: ofdm.modulate(obits), reps=3, per=STEADY)
    rx_ms = median_ms(lambda: ofdm.demodulate(*otx), reps=3, per=STEADY)
    print(f"comms path OFDMModem QPSK n_fft 64 cp 16, 64 x 4096 OFDM symbols: "
          f"subcarrier planes, all 64 rows, {osym:.2f} dB vs the float64 "
          f"route; noiseless BER {clean:g}, 3-tap channel with its equalizer BER "
          f"{faded_ber:g}; Eb/N0 {ebn0:g} dB BER {measured:.5f} (theory "
          f"{theory:.5f}); modulate {tx_ms:.3f} ms/call, demodulate "
          f"{rx_ms:.3f} ms/call")
    check(osym >= MIN_FILTER_DB, f"OFDMModem subcarrier planes {osym:.2f} dB "
                                 f"vs the float64 route")
    check(clean == 0.0 and faded_ber == 0.0,
          f"OFDMModem BER {clean} noiseless, {faded_ber} through the channel")
    check(0.6 * theory < measured < 1.6 * theory,
          f"OFDMModem BER {measured} vs theory {theory}")
    return launches


# -- the command-line front end ----------------------------------------------

CLI_PAIRS = 1 << 25         # rx capture: iq16 I/Q pairs (128 MB, 33 s)
CLI_FS, CLI_DEV = 1.024e6, 5e3   # its sample rate and FM deviation, Hz
CLI_RX_FRAMES = (1024, 16384)    # --block-frames: 65536- and 2^20-pair blocks
CLI_SAMPLES = 1 << 25       # spectra: f32 samples at 39 kHz
CLI_PCM = 1 << 23           # mfcc: int16 samples at 16 kHz
CLI_SYMBOLS = 1 << 20       # modem-sim: QPSK symbols a point
CLI_TIMEOUT = 600           # seconds for the `python -m` runs, all together


def band_capture(n, fs, m, seed, dev) -> np.ndarray:
    """Interleaved int16 I/Q of n pairs with a carrier within 500 Hz of
    the centre of each of m channels (numpy seed ``seed``), each
    amplitude-modulated (depth 0.5) and frequency-modulated (CLI_DEV) by
    tones of its own; built in float64 on the card.  A carrier in every
    channel keeps every channel's audio well conditioned: a channel with
    none demodulates quantization noise, where float32 against float64 is
    chance."""
    rng = np.random.default_rng(seed)
    t = torch.arange(n, dtype=torch.float64, device=dev) / fs
    zr = torch.zeros(n, dtype=torch.float64, device=dev)
    zi = torch.zeros_like(zr)
    for c in range(m):
        am, fm, off, ph0, ph1 = (rng.uniform(100, 3000), rng.uniform(300, 3000),
                                 rng.uniform(-500, 500),
                                 *rng.uniform(0, 2 * np.pi, 2))
        env = 1 + 0.5 * torch.sin(2 * np.pi * am * t + ph0)
        ang = (2 * np.pi * (c * fs / m + off) * t
               + CLI_DEV / fm * torch.sin(2 * np.pi * fm * t) + ph1)
        zr += env * torch.cos(ang)
        zi += env * torch.sin(ang)
    scale = 20000.0 / float(torch.sqrt(zr * zr + zi * zi).max())
    iq = torch.stack([zr, zi], -1).mul_(scale).round_().to(torch.int16)
    return iq.reshape(-1).cpu().numpy()


def run_cli(cli, argv):
    """cli.main(argv) in this process: (its stdout, its seconds)."""
    import contextlib
    import io

    out = io.StringIO()
    torch.cuda.synchronize()
    start = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    seconds = time.perf_counter() - start
    check(rc == 0, f"cli {' '.join(argv[:1])} exited {rc}")
    return out.getvalue(), seconds


def run_entry_points(cmds, cwd):
    """Run each argument list as ``python -m simpledsp_tpu_torch``, all at
    once, within CLI_TIMEOUT; kill any that is left; every exit code must
    be 0."""
    procs = [subprocess.Popen([sys.executable, "-m", "simpledsp_tpu_torch",
                               *cmd], cwd=cwd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    deadline = time.monotonic() + CLI_TIMEOUT
    try:
        outs = [proc.communicate(timeout=max(1.0, deadline - time.monotonic()))
                for proc in procs]
    except subprocess.TimeoutExpired:
        raise SystemExit(f"chip_smoke: FAILED: python -m simpledsp_tpu_torch "
                         f"runs not done in {CLI_TIMEOUT} s")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for cmd, proc, (_, err) in zip(cmds, procs, outs):
        check(proc.returncode == 0, f"python -m simpledsp_tpu_torch "
                                    f"{cmd[0]} exited {proc.returncode}: "
                                    f"{err[-2000:]}")
    return outs


def rx_oracle(sdr, mode, iq, blk, dtype, dev, m=M):
    """The composable bank of ``m`` channels in ``dtype`` over the
    capture's blocks of ``blk`` pairs, the state carried: (channels, T /
    channels / decim)."""
    cls = sdr.FMReceiverBank if mode == "fm" else sdr.AMReceiverBank
    kw = {"deviation_hz": CLI_DEV} if mode == "fm" else {}
    bank = cls(m, CLI_FS, decim=DECIM, dtype=dtype, device=dev,
               use_kernel=False, **kw)
    # The converter's bits: int16 to float32 times 2^-15 is exact.
    planes = (iq.view(-1, 2).T.to(torch.float32) / 32768.0).contiguous()
    st, outs = None, []
    for i in range(0, planes.shape[1], blk):
        a, st = bank(tuple(p[None, i:i + blk].to(dtype) for p in planes), st)
        outs.append(a[0])
    return torch.cat(outs, -1)


def cli_path(dev, smi, kchain, kpfb):
    """Phase 24; returns (chain launches, flat PFB launches) of the CLI's
    in-process runs."""
    import tempfile
    from pathlib import Path

    from scipy.special import erfc

    from simpledsp_tpu_torch import cli
    from simpledsp_tpu_torch.models import audio, sdr
    from simpledsp_tpu_torch.models.northstar import NorthStarChain
    from simpledsp_tpu_torch.runtime import i16_to_f32

    tmp_dir = tempfile.TemporaryDirectory()
    tmp = Path(tmp_dir.name)
    iq = band_capture(CLI_PAIRS, CLI_FS, M, 24, dev)
    iq.tofile(tmp / "band.iq16")
    half = CLI_PAIRS // 2           # a boundary of both block sizes
    iq[: 2 * half].tofile(tmp / "band_a.iq16")
    iq[2 * half:].tofile(tmp / "band_b.iq16")
    x = np.random.default_rng(24).standard_normal(CLI_SAMPLES,
                                                  dtype=np.float32)
    x.tofile(tmp / "noise.f32")
    x[: CLI_SAMPLES // 2].tofile(tmp / "noise_a.f32")
    x[CLI_SAMPLES // 2:].tofile(tmp / "noise_b.f32")
    pcm = np.round(np.random.default_rng(25).standard_normal(CLI_PCM)
                   * 8000).clip(-32768, 32767).astype(np.int16)
    pcm.tofile(tmp / "speech.pcm")

    def rx(mode, name, frames, *extra):
        return [f"{mode}-rx", "--input", str(tmp / f"{name}.iq16"),
                "--output", str(tmp / f"{mode}_{name}_{frames}.npz"),
                "--rate", str(CLI_FS), "--block-frames", str(frames),
                *(("--deviation", str(CLI_DEV)) if mode == "fm" else ()),
                *extra]

    def spectra(name, *extra):
        return ["spectra", "--input", str(tmp / f"{name}.f32"), "--output",
                str(tmp / f"spectra_{name}.npz"), "--rate", "39000", *extra]

    mfcc_cmd = ["mfcc", "--input", str(tmp / "speech.pcm"), "--output",
                str(tmp / "mfcc.npz"), "--rate", "16000"]
    modem_cmd = ["modem-sim", "--symbols", str(CLI_SYMBOLS), "--ebn0",
                 "0:10:2", "--output", str(tmp / "modem.npz")]

    # -- the entry point a user runs, each command once, all at once
    torch.cuda.synchronize()
    start = time.perf_counter()
    cmds = [rx("fm", "band", CLI_RX_FRAMES[0]),
            rx("am", "band", CLI_RX_FRAMES[0]), spectra("noise"), mfcc_cmd,
            modem_cmd]
    run_entry_points([[a.replace(".npz", "_sub.npz") for a in cmd]
                      for cmd in cmds], Path(__file__).resolve().parent)
    print(f"cli: python -m simpledsp_tpu_torch fm-rx, am-rx, spectra, mfcc "
          f"and modem-sim, all at once: exit 0 in "
          f"{time.perf_counter() - start:.1f} s")

    # -- in this process, with the launch counts
    launches = {}
    rates = []

    def counted(name, argv, kernel, samples):
        """cli.main(argv) with the counts set to 0 before: ``kernel``'s
        launches (None: no hand kernel may launch)."""
        zero_counts()
        out, secs = run_cli(cli, argv)
        torch.cuda.synchronize()
        launches[name] = 0 if kernel is None else kernel.launches
        stray = [i for i, k in enumerate(KERNELS)
                 if k is not kernel and k.launches]
        check(not stray, f"cli {name}: kernels {stray} of KERNELS, off its "
                         f"path, launched")
        rates.append((name, samples / secs / 1e6, secs, out.strip()))
        return out

    n_spec = CLI_SAMPLES // (4096 * 1024)
    counted("spectra", spectra("noise"), kchain.chain_kernel, CLI_SAMPLES)
    counted("spectra first half", spectra("noise_a"), kchain.chain_kernel,
            CLI_SAMPLES // 2)
    counted("spectra second half", spectra(
        "noise_b", "--state", str(tmp / "spectra_noise_a.npz.state.npz")),
            kchain.chain_kernel, CLI_SAMPLES // 2)
    for mode in ("fm", "am"):
        for frames in CLI_RX_FRAMES:
            counted(f"{mode}-rx {frames}", rx(mode, "band", frames),
                    kpfb.pfb_flat_kernel, CLI_PAIRS)
    frames = CLI_RX_FRAMES[1]
    counted("fm-rx first half", rx("fm", "band_a", frames),
            kpfb.pfb_flat_kernel, half)
    counted("fm-rx second half", rx("fm", "band_b", frames, "--state", str(
        tmp / f"fm_band_a_{frames}.npz.state.npz")), kpfb.pfb_flat_kernel,
            half)
    counted("mfcc", mfcc_cmd, None, CLI_PCM)
    modem_out = counted("modem-sim", modem_cmd, None,
                        CLI_SYMBOLS * 4 * 6)
    for name, msps, secs, out in rates:
        print(f"cli {name}: {msps:.6f} Msamples/s wall ({secs:.3f} s in "
              f"cli.main); {smi}; the command printed: "
              f"{out.splitlines()[-1] if out else ''}")
    print("cli modem-sim records: " + " ".join(modem_out.split()))

    # -- launches: one a block
    n_rx = {f: CLI_PAIRS // (M * DECIM * f) for f in CLI_RX_FRAMES}
    want = {"spectra": n_spec, "spectra first half": n_spec // 2,
            "spectra second half": n_spec // 2,
            "fm-rx first half": n_rx[frames] // 2,
            "fm-rx second half": n_rx[frames] // 2, "mfcc": 0,
            "modem-sim": 0,
            **{f"{m}-rx {f}": n_rx[f] for m in ("fm", "am")
               for f in CLI_RX_FRAMES}}
    print("cli launches (chain kernel for spectra, flat PFB kernel for rx): "
          + ", ".join(f"{k} {v}" for k, v in launches.items()))
    for name, n in want.items():
        check(launches[name] == n, f"cli {name}: {launches[name]} launches, "
                                   f"want {n} (one a block)")

    def load(name):
        with np.load(tmp / name) as z:
            return {k: z[k] for k in z.files}

    # -- spectra: every frame against the float64 composable chain
    spec = load("spectra_noise.npz")
    got = spec["spec_re"] + 1j * spec["spec_im"]
    chain64 = NorthStarChain(fft_size=4096, dtype=torch.float64, device=dev,
                             use_kernel=False)
    xs = torch.as_tensor(x, device=dev).double().reshape(n_spec, 1, -1)
    st, ref = None, []
    for blk in xs:
        (rr, ri), st = chain64(blk, st)
        ref.append(torch.complex(rr[0], ri[0]).cpu().numpy())
    ref = np.concatenate(ref, axis=0)
    check(got.shape == ref.shape and np.isfinite(got).all(),
          f"cli spectra shape {got.shape} or values")
    spec_snr = snr_db(ref, got)
    whole = {k: spec[k] for k in ("spec_re", "spec_im")}
    a, b = load("spectra_noise_a.npz"), load("spectra_noise_b.npz")
    spec_resume = all(np.array_equal(np.concatenate([a[k], b[k]]), whole[k])
                      for k in whole)
    subs = load("spectra_noise_sub.npz")
    sub_equal = all(np.array_equal(subs[k], whole[k]) for k in whole)
    spec_sub = (np.inf if sub_equal
                else snr_db(got, subs["spec_re"] + 1j * subs["spec_im"]))
    print(f"cli spectra: {got.shape[0]} frames of 4096, all against the "
          f"float64 composable chain over the same {n_spec} blocks: "
          f"{spec_snr:.2f} dB; resumed at block {n_spec // 2} equal bit for "
          f"bit: {spec_resume}; python -m run equal bits: {sub_equal}, "
          f"{spec_sub:.2f} dB vs this process's")
    check(spec_snr >= MIN_SNR_DB, f"cli spectra {spec_snr:.2f} dB")
    check(spec_resume, "cli spectra resumed != continuous")
    check(spec_sub >= MIN_SNR_DB, f"cli spectra python -m {spec_sub:.2f} dB")
    del got, ref, whole, a, b, subs, spec, xs

    # -- rx: every channel within the bank bar against float64
    iq_dev = torch.as_tensor(iq, device=dev)
    for mode in ("fm", "am"):
        for f in CLI_RX_FRAMES:
            blk = M * DECIM * f
            audio_ = torch.as_tensor(load(f"{mode}_band_{f}.npz")["audio"],
                                     device=dev)
            r64 = rx_oracle(sdr, mode, iq_dev, blk, torch.float64, dev)
            r32 = rx_oracle(sdr, mode, iq_dev, blk, torch.float32, dev)
            check(audio_.shape == r64.shape
                  and bool(torch.isfinite(audio_).all()),
                  f"cli {mode}-rx {f}: audio shape {tuple(audio_.shape)}")
            err = (audio_.double() - r64).abs().amax(-1)
            own = (r32.double() - r64).abs().amax(-1)
            scale = r64.abs().amax(-1)
            limit = torch.maximum(BAR * scale.clamp_min(1.0), 2 * own)
            print(f"cli {mode}-rx block-frames {f}: {M} channels x "
                  f"{audio_.shape[1]} audio samples, every channel against "
                  f"the float64 composable bank over the same "
                  f"{CLI_PAIRS // blk} blocks: max |err| "
                  f"{float(err.max()):.3e} (float32 composable bank "
                  f"{float(own.max()):.3e}); worst channel at "
                  f"{float((err / limit).max()):.3f} of its bar")
            check(bool((err <= limit).all()),
                  f"cli {mode}-rx {f}: channels over the bar: "
                  f"{(err > limit).nonzero().flatten().tolist()}")
            if f == CLI_RX_FRAMES[0]:
                subs = torch.as_tensor(
                    load(f"{mode}_band_{f}_sub.npz")["audio"], device=dev)
                sub_err = float((subs - audio_).abs().max())
                print(f"cli {mode}-rx python -m run: max |diff| {sub_err:.3e} "
                      f"vs this process's")
                check(sub_err <= BAR * max(1.0, float(scale.max())),
                      f"cli {mode}-rx python -m run differs by {sub_err:.3e}")
    whole = load(f"fm_band_{frames}.npz")["audio"]
    a = load(f"fm_band_a_{frames}.npz")["audio"]
    b = load(f"fm_band_b_{frames}.npz")["audio"]
    rx_resume = np.array_equal(np.concatenate([a, b], -1), whole)
    print(f"cli fm-rx resumed at pair {half} equal bit for bit: {rx_resume}")
    check(rx_resume, "cli fm-rx resumed != continuous")
    del iq_dev, whole, a, b

    # -- mfcc: every frame against float64 over the same overlapped blocks
    feats = load("mfcc.npz")["mfcc"]
    hop, nfft, blk = 256, 512, 256 * 256
    xf = torch.as_tensor(i16_to_f32(pcm), device=dev).double()
    xf = torch.cat([torch.zeros(nfft - hop, dtype=xf.dtype, device=dev), xf])
    nblk = CLI_PCM // blk
    idx = (torch.arange(nblk, device=dev)[:, None] * blk
           + torch.arange(blk + nfft - hop, device=dev))
    ref = audio.mfcc(xf[idx], 13, nfft=nfft, hop=hop, n_mels=64, fs=16000.0,
                     dtype=torch.float64).reshape(-1, 13)
    got = torch.as_tensor(feats, device=dev)
    check(got.shape == ref.shape and bool(torch.isfinite(got).all()),
          f"cli mfcc shape {tuple(got.shape)} != {tuple(ref.shape)}")
    mfcc_snr = snr_db_dev(ref, got)
    mfcc_sub = snr_db_dev(got, torch.as_tensor(load("mfcc_sub.npz")["mfcc"],
                                               device=dev))
    print(f"cli mfcc: {got.shape[0]} frames x 13, all against float64 mfcc "
          f"over the same {nblk} overlapped blocks: {mfcc_snr:.2f} dB; "
          f"python -m run {mfcc_sub:.2f} dB vs this process's")
    check(mfcc_snr >= MIN_FILTER_DB, f"cli mfcc {mfcc_snr:.2f} dB")
    check(mfcc_sub >= MIN_FILTER_DB, f"cli mfcc python -m {mfcc_sub:.2f} dB")
    del xf, idx, ref, got

    # -- modem-sim: the BER falls, and follows theory where it can be read
    for name in ("modem.npz", "modem_sub.npz"):
        z = load(name)
        ebn0, ber_ = z["ebn0_db"], z["ber"]
        bits = int(z["bits_per_point"])
        theory = 0.5 * erfc(np.sqrt(10.0 ** (ebn0 / 10.0)))
        read = ber_ * bits >= 100
        ratio = ber_[read] / theory[read]
        print(f"cli modem-sim ({name}): Eb/N0 {ebn0.tolist()} dB, BER "
              f"{ber_.tolist()}, theory {theory.tolist()}; measured / theory "
              f"where >= 100 errors {ratio.tolist()}")
        check(ebn0.size == 6 and all(b2 < b1 for b1, b2 in
                                     zip(ber_, ber_[1:])),
              f"cli modem-sim {name}: BER does not fall {ber_.tolist()}")
        check(bool(read.any()) and bool(((0.6 < ratio) & (ratio < 1.6)).all()),
              f"cli modem-sim {name}: BER / theory {ratio.tolist()}")
    tmp_dir.cleanup()
    return (launches["spectra"] + launches["spectra first half"]
            + launches["spectra second half"],
            sum(v for k, v in launches.items() if "rx" in k))


# -- the smoothing filters, splines, peaks and waveforms ----------------------

SC, ST = 64, 1 << 20        # 1-D smoothing: rows, samples (the chain's)
S2 = (32, 512, 512)         # 2-D smoothing: images (the conv2d cell)
# The pairs of calls that differ only in their window: the launches a call
# must not grow with it (a loop of shifted slices would launch a kernel a
# tap).
WINDOW_PAIRS = (("savgol_filter(x, 11, 2)", "savgol_filter(x, 31, 3)"),
                ("medfilt(x, 3)", "medfilt(x, 9)"))
CROSS = np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]])
SEP_TAPS = (np.hanning(11)[1:-1] / np.hanning(11)[1:-1].sum(),
            np.array([-1.0, 2.0, 5.0, 10.0, 16.0, 10.0, 5.0, 2.0, -1.0]) / 48)
SMOOTH_CLI_PAIRS = 12 * DECIM * 1024 * 32   # fm-rx --channels 12: 32 blocks
SMOOTH_CLI_SAMPLES = 1 << 22                # spectra --fft 32768: 8 blocks
# The plain route's spectra at --fft 32768, the card's against --device
# cpu's and each against float64: the card-against-CPU bar of
# tests/test_torch_cuda.py::test_cli_on_the_card_matches_the_cpu.  (The
# chain's 130 dB is the kernel route's; the plain route's float32 engine
# holds about 127 dB at this size.)
MIN_PLAIN_CLI_DB = 120.0


def smoothing_signals(dev):
    """The phase's inputs on ``dev``: 64 x 2^20 float32 noise (numpy seed
    25) plus three tones a row of random amplitude, frequency and phase
    (made in float64 on the card), and 32 x 512 x 512 float32 noise."""
    rng = np.random.default_rng(25)
    x = torch.as_tensor(rng.standard_normal((SC, ST), dtype=np.float32),
                        device=dev).double()
    t = torch.arange(ST, dtype=torch.float64, device=dev)
    for _ in range(3):
        amp, freq, ph = (torch.as_tensor(v, device=dev)[:, None] for v in (
            rng.uniform(0.5, 3.0, SC), rng.uniform(1e-4, 0.05, SC),
            rng.uniform(0, 2 * np.pi, SC)))
        x += amp * torch.sin(2 * np.pi * freq * t + ph)
    img = torch.as_tensor(rng.standard_normal(S2, dtype=np.float32),
                          device=dev)
    return x.float(), img


def smoothing_calls(x, img) -> dict:
    """name: (call on a tensor, 1-D or 2-D input) of the phase."""
    from simpledsp_tpu_torch.ops import smooth, splines

    hr, hc = SEP_TAPS
    return {
        "savgol_filter(x, 31, 3)": (
            lambda v: smooth.savgol_filter(v, 31, 3), x),
        "savgol_filter(x, 31, 3, mode='mirror')": (
            lambda v: smooth.savgol_filter(v, 31, 3, mode="mirror"), x),
        "savgol_filter(x, 11, 2)": (
            lambda v: smooth.savgol_filter(v, 11, 2), x),
        "medfilt(x, 9)": (lambda v: smooth.medfilt(v, 9), x),
        "medfilt(x, 3)": (lambda v: smooth.medfilt(v, 3), x),
        "wiener(x, 5)": (lambda v: smooth.wiener(v, 5), x),
        "detrend(x)": (lambda v: smooth.detrend(v), x),
        "medfilt2d(img, 5)": (lambda v: smooth.medfilt2d(v, 5), img),
        "wiener(img, 5)": (lambda v: smooth.wiener(v, 5), img),
        "sepfir2d(img, 9 taps, 9 taps)": (
            lambda v: splines.sepfir2d(v, hr, hc), img),
        "order_filter(img, cross, 2)": (
            lambda v: smooth.order_filter(v, CROSS, 2), img),
    }


def smoothing_launches() -> dict:
    """Device events of one call of each of the phase's calls, traced in
    one profiler session (``tools/probe_hlo.device_events``) after a
    warm-up call: {name: {"kernels": n, "copies": n, "names": [device
    events]}}.  Run in a process of its own: traced in this one, after
    phase 20's session, the first call lost most of its device events."""
    from simpledsp_tpu_torch.tools.probe_hlo import device_events

    dev = torch.device("cuda", 0)
    x, img = smoothing_signals(dev)
    calls = {name: (lambda f=f, v=v: f(v))
             for name, (f, v) in smoothing_calls(x, img).items()}
    for call in calls.values():
        call()
    out = {}
    for name, evs in device_events(calls).items():
        out[name] = {k: sum(e["count"] for e in evs if (e["kind"] == "copy")
                            == (k == "copies")) for k in ("kernels", "copies")}
        out[name]["names"] = [f"{e['count']} x {e['name'][:80]}" for e in evs]
    return out


def in_background(fn):
    """Run ``fn`` in a thread; returns a call that waits for it and gives
    its result, or re-raises what it raised."""
    box = {}

    def run():
        try:
            box["value"] = fn()
        except BaseException as e:  # noqa: BLE001 - re-raised by the waiter
            box["error"] = e

    th = threading.Thread(target=run)
    th.start()

    def wait():
        th.join()
        if "error" in box:
            raise box["error"]
        return box["value"]
    return wait


def smoothing_path(dev, smi, sdr):
    """Phase 25."""
    import tempfile
    from pathlib import Path

    root = Path(__file__).resolve().parent
    tmp_dir = tempfile.TemporaryDirectory()
    tmp = Path(tmp_dir.name)

    # -- in the background: the launch counts in a process of their own, and
    # the two CLI sizes the kernels do not take, on the card and on the CPU
    counter = subprocess.Popen(
        [sys.executable, "-c", "import json, chip_smoke; print(json.dumps("
         "chip_smoke.smoothing_launches()))"], cwd=root,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        iq = band_capture(SMOOTH_CLI_PAIRS, CLI_FS, 12, 25, dev)
        iq.tofile(tmp / "band12.iq16")
        xs = np.random.default_rng(25).standard_normal(SMOOTH_CLI_SAMPLES,
                                                       dtype=np.float32)
        xs.tofile(tmp / "noise.f32")
        cli_cmds = {
            "spectra": ["spectra", "--input", str(tmp / "noise.f32"),
                        "--rate", "39000", "--fft", "32768",
                        "--block-frames", "16"],
            "fm-rx": ["fm-rx", "--input", str(tmp / "band12.iq16"),
                      "--rate", str(CLI_FS), "--channels", "12",
                      "--deviation", str(CLI_DEV)]}
        labels = [(name, where) for name in cli_cmds
                  for where in ("card", "cpu")]
        runs = [[*cli_cmds[name], "--output",
                 str(tmp / f"{name}_{where}.npz"),
                 *(("--device", "cpu") if where == "cpu" else ())]
                for name, where in labels]
        cli_outs = in_background(lambda: run_entry_points(runs, root))
        smoothing_checks(dev, smi, sdr, tmp, counter, cli_outs, labels, iq,
                         xs)
    finally:
        if counter.poll() is None:
            counter.kill()
            counter.wait()
        tmp_dir.cleanup()


def smoothing_checks(dev, smi, sdr, tmp, counter, cli_outs, labels, iq, xs):
    """Phase 25 once its background work has started: the card's calls
    against the CPU, the host paths, the launch counts, the CLI's
    outputs, and the timings."""
    import scipy.signal as ss

    from simpledsp_tpu_torch.models.northstar import NorthStarChain
    from simpledsp_tpu_torch.ops import peaks, smooth, waveforms

    # -- every call once on the card, then against the CPU
    x, img = smoothing_signals(dev)
    calls = smoothing_calls(x, img)
    torch.cuda.synchronize()
    zero_counts()
    outs = {name: f(v) for name, (f, v) in calls.items()}
    torch.cuda.synchronize()
    stray = [i for i, k in enumerate(KERNELS) if k.launches]
    check(not stray, f"smoothing: kernels {stray} of KERNELS launched")
    x_host, img_host = x.cpu(), img.cpu()
    x64, img64 = x_host.double(), img_host.double()
    xn, imgn = x64.numpy(), img64.numpy()
    hr, hc = SEP_TAPS
    # The float64 reference on the CPU of each call: scipy for the linear
    # filters (in a thread, beside the rest), the port's plain float64 path
    # for the rank filters (scipy 1.17's order_filter ignores the holes of a
    # domain) and for wiener.
    start = time.perf_counter()
    scipy_refs = in_background(lambda: {
        "savgol_filter(x, 31, 3)": ss.savgol_filter(xn, 31, 3),
        "savgol_filter(x, 31, 3, mode='mirror')":
            ss.savgol_filter(xn, 31, 3, mode="mirror"),
        "savgol_filter(x, 11, 2)": ss.savgol_filter(xn, 11, 2),
        "detrend(x)": ss.detrend(xn, axis=-1),
        "sepfir2d(img, 9 taps, 9 taps)":
            np.stack([ss.sepfir2d(im, hr, hc) for im in imgn])})
    rank = ("medfilt(x, 9)", "medfilt(x, 3)", "medfilt2d(img, 5)",
            "order_filter(img, cross, 2)")
    report = {}
    # The port's own references first, while the scipy thread runs.
    for name in sorted(calls, key=lambda n: not (n in rank
                                                 or n.startswith("wiener"))):
        f, v = calls[name]
        got = outs[name]
        check(got.shape == v.shape and got.dtype == torch.float32
              and bool(torch.isfinite(got).all()),
              f"smoothing {name}: shape {tuple(got.shape)}, {got.dtype}, or "
              f"not finite")
        got = got.cpu()
        inp64 = x64 if v is x else img64
        if name in rank:
            want = f(inp64).float()
            equal = torch.equal(got, want)
            report[name] = "equal bits to the port's plain float64 path on " \
                           f"the CPU cast to float32: {equal}"
            check(equal, f"smoothing {name}: not the float64 result's bits")
        elif name.startswith("wiener"):
            cpu32 = f(x_host if v is x else img_host)
            snr32 = snr_db_dev(cpu32, got)
            snr64 = snr_db_dev(f(inp64), got)
            report[name] = (f"{snr32:.2f} dB vs the port's float32 run on "
                            f"the CPU (bar {MIN_FILTER_DB}"
                            f"), {snr64:.2f} dB vs its float64 run")
            check(snr32 >= MIN_FILTER_DB,
                  f"smoothing {name}: {snr32:.2f} dB vs float32 on the CPU")
        else:
            snr = snr_db_dev(torch.as_tensor(scipy_refs()[name]), got)
            report[name] = (f"{snr:.2f} dB vs scipy float64 on the CPU "
                            f"(bar {MIN_FILTER_DB})")
            check(snr >= MIN_FILTER_DB,
                  f"smoothing {name}: {snr:.2f} dB vs scipy float64")
    print(f"smoothing: the references on the CPU took "
          f"{time.perf_counter() - start:.1f} s")
    del outs, x64, img64, xn, imgn

    # -- host checks: the native LFSR, peaks of a tensor on the card
    start = time.perf_counter()
    seq, state = waveforms.max_len_seq(20)
    mls_s = time.perf_counter() - start
    ref_seq, ref_state = ss.max_len_seq(20)
    check(seq.device.type == "cuda"
          and np.array_equal(seq.cpu().numpy(), ref_seq)
          and np.array_equal(state, ref_state),
          "max_len_seq(20) differs from scipy")
    # A 65536-sample piece: the peak search is a Python loop on the host.
    row = smooth.savgol_filter(x[0, :1 << 16], 31, 3)
    pk, props = peaks.find_peaks(row, prominence=1.0, distance=64)
    ref_pk, ref_props = ss.find_peaks(row.double().cpu().numpy(),
                                      prominence=1.0, distance=64)
    check(pk.size > 0 and np.array_equal(pk, ref_pk) and np.array_equal(
        props["prominences"], ref_props["prominences"]),
          "find_peaks of a tensor on the card differs from scipy")
    print(f"smoothing host paths: max_len_seq(20) {seq.numel()} bits on "
          f"{seq.device} in {mls_s * 1e3:.1f} ms (the native LFSR), equal "
          f"to scipy with its state; find_peaks of a savgol row on the card "
          f"{pk.size} peaks, equal to scipy's")

    # -- the launch counts, traced in their own process
    out, err = counter.communicate(timeout=CLI_TIMEOUT)
    check(counter.returncode == 0, f"smoothing launch count exited "
                                   f"{counter.returncode}: {err[-2000:]}")
    launches = json.loads(out.strip().splitlines()[-1])
    for small, large in WINDOW_PAIRS:
        a = launches[small]["kernels"] + launches[small]["copies"]
        b = launches[large]["kernels"] + launches[large]["copies"]
        print(f"smoothing launches a call: {small} {a}, {large} {b}: "
              f"{launches[small]['names']} / {launches[large]['names']}")
        check(0 < b <= a, f"smoothing: {large} launched {b} times a call, "
                          f"{small} {a}: the count grows with the window")

    # -- the CLI at sizes the kernels do not take
    for (name, where), (_, err) in zip(labels, cli_outs()):
        said = [ln for ln in err.splitlines() if "plain PyTorch route" in ln]
        print(f"cli {name} ({where}) stderr route line: {said}")
        check(len(said) == (1 if where == "card" else 0),
              f"cli {name} on the {where}: route lines {said}")

    def load(name):
        with np.load(tmp / name) as z:
            return {k: z[k] for k in z.files}

    card, cpu = load("spectra_card.npz"), load("spectra_cpu.npz")
    got = card["spec_re"] + 1j * card["spec_im"]
    want = cpu["spec_re"] + 1j * cpu["spec_im"]
    check(got.shape == want.shape and np.isfinite(got).all(),
          f"cli spectra --fft 32768 shape {got.shape} vs {want.shape}")
    # The float64 composable chain over the same blocks, as phase 24's.
    chain64 = NorthStarChain(fft_size=32768, dtype=torch.float64, device=dev,
                             use_kernel=False)
    st, ref = None, []
    for blk in torch.as_tensor(xs, device=dev).double().reshape(-1, 1,
                                                                 32768 * 16):
        (rr, ri), st = chain64(blk, st)
        ref.append(torch.complex(rr[0], ri[0]).cpu().numpy())
    ref = np.concatenate(ref, axis=0)
    snrs = (snr_db(want, got), snr_db(ref, got), snr_db(ref, want))
    print(f"cli spectra --fft 32768 (the plain route): {got.shape[0]} frames, "
          f"card vs --device cpu {snrs[0]:.2f} dB; against the float64 "
          f"composable chain over the same blocks: card {snrs[1]:.2f} dB, "
          f"cpu {snrs[2]:.2f} dB (bar {MIN_PLAIN_CLI_DB} for each)")
    check(min(snrs) >= MIN_PLAIN_CLI_DB,
          f"cli spectra --fft 32768: {snrs} dB")
    blk = 12 * DECIM * 1024
    iq_dev = torch.as_tensor(iq, device=dev)
    r64, r32 = (rx_oracle(sdr, "fm", iq_dev, blk, dt, dev, m=12)
                for dt in (torch.float64, torch.float32))
    own = (r32.double() - r64).abs().amax(-1)
    scale = r64.abs().amax(-1)
    limit = torch.maximum(BAR * scale.clamp_min(1.0), 2 * own)
    worst = {}
    for where in ("card", "cpu"):
        audio_ = torch.as_tensor(load(f"fm-rx_{where}.npz")["audio"],
                                 device=dev)
        check(audio_.shape == r64.shape, f"cli fm-rx --channels 12 ({where}) "
                                         f"audio {tuple(audio_.shape)}")
        err = (audio_.double() - r64).abs().amax(-1)
        worst[where] = float((err / limit).max())
        check(bool((err <= limit).all()), f"cli fm-rx --channels 12 ({where}):"
                                          f" channels over the bank bar")
    apart = float(np.abs(load("fm-rx_card.npz")["audio"]
                         - load("fm-rx_cpu.npz")["audio"]).max())
    print(f"cli fm-rx --channels 12 (the plain route): 12 channels x "
          f"{r64.shape[1]} audio samples against the float64 composable bank "
          f"over the same {SMOOTH_CLI_PAIRS // blk} blocks, the worst channel "
          f"at {worst['card']:.3f} (card) and {worst['cpu']:.3f} (--device "
          f"cpu) of its bar; card vs cpu max |diff| {apart:.3e}")
    del iq_dev, r64, r32

    # -- ms/call on the card, alone now
    for name, (f, v) in calls.items():
        ms = median_ms(lambda: f(v), **SLOW)
        n = launches[name]
        print(f"smoothing {name} on {tuple(v.shape)} float32: {ms:.3f} ms/call "
              f"({v.numel() / ms / 1e3:.1f} Msamples/s), {n['kernels']} "
              f"kernel(s) and {n['copies']} copies a call; {report[name]}; "
              f"{smi}")


# -- 26. the parallel layer ---------------------------------------------------

SHARDED_IIR_CALLS = 2       # ShardedBlockIIR: chained calls on the chain cell
MIN_IIR_DB = 90.0           # the sharded float32 IIR's bar (tests/test_parallel.py)
STATE_REL = 1e-6            # the sharded chain's final state against the serial


def sharded_trace() -> dict:
    """Device events of one sharded chain call (kernel path, 64 x 2^20),
    the serial chain's on the same input and one gathered channelizer call
    (16 x 2^20 complex) on a mesh of one, traced in one profiler session
    (``tools/probe_hlo.device_events``) after a warm-up call: {name:
    {"kernels", "nccl", "nccl_us", "device_us", "names"}}.  Run in a
    process of its own (a second profiler session in one process records
    no device activity), with its own NCCL group of one."""
    import torch.distributed as dist

    from simpledsp_tpu_torch.models.northstar import (NorthStarChain,
                                                      ShardedNorthStarChain)
    from simpledsp_tpu_torch.parallel import (ShardedChannelizer,
                                              single_device_mesh)
    from simpledsp_tpu_torch.tools.probe_hlo import device_events

    dev = torch.device("cuda", 0)
    mesh = single_device_mesh()
    try:
        g = torch.Generator(device=dev).manual_seed(26)
        x = torch.randn(C, T, generator=g, device=dev)
        xc = torch.complex(torch.randn(B, TB, generator=g, device=dev),
                           torch.randn(B, TB, generator=g, device=dev))
        sharded = ShardedNorthStarChain(mesh)
        serial = NorthStarChain(device=dev)
        chan = ShardedChannelizer(M, mesh, taps_per_channel=K,
                                  gather_output=True)
        calls = {"sharded chain": lambda: sharded(x),
                 "serial chain": lambda: serial(x),
                 "gathered channelizer": lambda: chan(xc)}
        for call in calls.values():
            call()
        out = {}
        for name, evs in device_events(calls).items():
            nccl = [e for e in evs if "nccl" in e["name"].lower()]
            out[name] = {
                "kernels": sum(e["count"] for e in evs if e["kind"] != "copy"),
                "nccl": sum(e["count"] for e in nccl),
                "nccl_us": sum(e["device_us"] for e in nccl),
                "device_us": sum(e["device_us"] for e in evs),
                "names": [f"{e['count']} x {e['name'][:70]} "
                          f"{e['device_us']:.1f} us" for e in evs]}
        return out
    finally:
        dist.destroy_process_group()


def sharded_path(dev, smi, chain_x):
    """Phase 26; returns {kernel wrapper: launches} of the sharded modules'
    runs (not of the serial calls they are compared with)."""
    from pathlib import Path

    import torch.distributed as dist

    from simpledsp_tpu_torch.parallel import single_device_mesh

    root = Path(__file__).resolve().parent
    # In the background: the profiler window in a process of its own.
    tracer = subprocess.Popen(
        [sys.executable, "-c", "import json, chip_smoke; print(json.dumps("
         "chip_smoke.sharded_trace()))"], cwd=root,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    started = not dist.is_initialized()
    try:
        mesh = single_device_mesh()
        check(dist.get_backend() == "nccl", f"the group's backend is "
                                            f"{dist.get_backend()}")
        return sharded_checks(dev, smi, mesh, chain_x, tracer)
    finally:
        if tracer.poll() is None:
            tracer.kill()
            tracer.wait()
        if started and dist.is_initialized():
            dist.destroy_process_group()


def sharded_checks(dev, smi, mesh, chain_x, tracer):
    """Phase 26 on the mesh, the tracer started."""
    import scipy.signal as ss

    from simpledsp_tpu_torch import entry
    from simpledsp_tpu_torch.design.biquad import sos_matrix
    from simpledsp_tpu_torch.design.fir import lowpass_taps
    from simpledsp_tpu_torch.kernels import chain as kchain
    from simpledsp_tpu_torch.kernels import fft as kfft
    from simpledsp_tpu_torch.kernels import ols as kols
    from simpledsp_tpu_torch.kernels import pfb as kpfb
    from simpledsp_tpu_torch.models.northstar import (NorthStarChain,
                                                      ShardedNorthStarChain,
                                                      default_design)
    from simpledsp_tpu_torch.models.sdr import FMReceiverBank
    from simpledsp_tpu_torch.ops.channelizer import PFBChannelizer
    from simpledsp_tpu_torch.ops.conv import convolve
    from simpledsp_tpu_torch.ops.fir import FIRFilter, OverlapSaveFIR
    from simpledsp_tpu_torch.ops.iir import BlockIIR, IIRState
    from simpledsp_tpu_torch.ops.spectral import stft_ri, window_taps
    from simpledsp_tpu_torch.parallel import (ShardedBlockIIR,
                                              ShardedChannelizer,
                                              ShardedConvolve, ShardedFIR,
                                              ShardedOverlapSaveFIR,
                                              ShardedReceiverBank,
                                              ShardedSTFT)

    launches = {k: 0 for k in KERNELS}
    times = []

    def counted(fn):
        """``fn()`` with the counts set to 0 before and added to the
        phase's after: returns (its result, {kernel: launches})."""
        torch.cuda.synchronize()
        zero_counts()
        out = fn()
        torch.cuda.synchronize()
        now = {k: k.launches for k in KERNELS}
        for k, n in now.items():
            launches[k] += n
        return out, now

    def launched(fn):
        """The launches of ``fn()`` (a serial call to compare with), not
        added to the phase's."""
        zero_counts()
        fn()
        torch.cuda.synchronize()
        return {k: k.launches for k in KERNELS}

    def timed(name, sharded_fn, serial_fn, **window):
        ms, serial_ms = median_ms(sharded_fn, **window), median_ms(serial_fn,
                                                                    **window)
        times.append(f"{name} {ms:.3f} (serial {serial_ms:.3f})")
        return ms, serial_ms

    def local(d):
        """A mesh of one's DTensor as its one (whole) local tensor."""
        check(tuple(d.to_local().shape) == tuple(d.shape),
              f"a DTensor of shape {tuple(d.shape)} holds "
              f"{tuple(d.to_local().shape)} on the one rank")
        return d.to_local()

    design = default_design()
    g = torch.Generator(device=dev).manual_seed(26)

    # -- the chain, kernel path: 4 chained calls at the chain cell ----------
    sharded = ShardedNorthStarChain(mesh, fft_size=MAIN_N, block_size=256)
    serial = NorthStarChain(fft_size=MAIN_N, block_size=256, device=dev)
    check(sharded.use_kernel, "ShardedNorthStarChain on CUDA is not on the "
                              "kernel")
    xs = [torch.as_tensor(x, device=dev) for x in chain_x]
    state, worst_rel, outs = None, 0.0, []
    for i, x in enumerate(xs):
        ((sr, si), new), n = counted(lambda: sharded(x, state))
        check(n[kchain.chain_kernel] == 1, f"sharded chain call {i} launched "
              f"the chain kernel {n[kchain.chain_kernel]} times")
        s_in = None if state is None else IIRState(local(state.y_hist))
        (rr, ri), ref_state = serial(x, s_in)
        check(torch.equal(local(sr), rr) and torch.equal(local(si), ri),
              f"sharded chain call {i}: spectra differ from the serial "
              f"chain's on the same input and state")
        s_sh, s_se = local(new.y_hist), ref_state.y_hist
        rel = float((s_sh - s_se).abs().max() / s_se.abs().max())
        check(rel <= STATE_REL, f"sharded chain call {i}: final state "
                                f"{rel:.3e} relative from the serial one")
        worst_rel = max(worst_rel, rel)
        outs.append((sr, si))
        state = new
    oracle = oracle_packed(design, chain_x[0][:2].astype(np.float64), MAIN_N)
    sr0, si0 = (local(p)[:2].double().cpu().numpy() for p in outs[0])
    snr_chain = snr_db(oracle, sr0 + 1j * si0)
    check(snr_chain >= MIN_SNR_DB, f"sharded chain {snr_chain:.2f} dB")
    x0 = xs[0]
    ms, serial_ms = timed("chain", lambda: sharded(x0, state),
                          lambda: serial(x0), per=STEADY, reps=3)
    print(f"sharded chain (kernel path, mesh of one): {CALLS} calls of {C} x "
          f"{T}, 1 chain launch a call, spectra equal bits to NorthStarChain "
          f"on the same input and state, final state within {worst_rel:.3e} "
          f"relative; call 0 rows 0-1 {snr_chain:.2f} dB vs float64 oracle; "
          f"{ms:.3f} ms/call ({C * T / ms / 1e3:.1f} Msamples/s), serial "
          f"{serial_ms:.3f}; {smi}")

    # -- the chain, composable path, once ------------------------------------
    plain = ShardedNorthStarChain(mesh, fft_size=MAIN_N, block_size=256,
                                  use_kernel=False)
    plain_serial = NorthStarChain(fft_size=MAIN_N, block_size=256,
                                  device=dev, use_kernel=False)
    ((pr, pi), _), n = counted(lambda: plain(x0))
    ref_n = launched(lambda: plain_serial(x0))
    check(n == ref_n, "the composable sharded chain's launches differ from "
                      "the serial composable chain's")
    pr0, pi0 = (local(p)[:2].double().cpu().numpy() for p in (pr, pi))
    snr_plain = snr_db(oracle, pr0 + 1j * pi0)
    check(snr_plain >= MIN_SNR_DB, f"composable sharded chain "
                                   f"{snr_plain:.2f} dB")
    ms, serial_ms = timed("chain composable", lambda: plain(x0),
                          lambda: plain_serial(x0), reps=3)
    print(f"sharded chain (use_kernel=False): {snr_plain:.2f} dB vs float64 "
          f"oracle; {n[kfft.fft_frames_kernel]} frames FFT launch(es), as "
          f"the serial composable chain; {ms:.3f} ms/call, serial "
          f"{serial_ms:.3f}")
    del xs, outs, sr, si, rr, ri, pr, pi

    # -- ShardedBlockIIR: 2 chained calls ------------------------------------
    fi = ShardedBlockIIR(design, mesh, block_size=256)
    bi = BlockIIR(design, block_size=256, device=dev)
    sos = sos_matrix(design)
    zi = np.zeros((sos.shape[0], 2, 2))
    st, st_ser, worst, snr_iir = None, None, 0.0, []
    for i in range(SHARDED_IIR_CALLS):
        x = chain_x[i]
        xd = torch.as_tensor(x, device=dev)
        (y, st), _ = counted(lambda: fi(xd, st))
        y_ser, st_ser = bi(xd, st_ser)
        worst = max(worst, float((local(y) - y_ser).abs().max()))
        ref, zi = ss.sosfilt(sos, x[:2].astype(np.float64), axis=-1, zi=zi)
        snr_iir.append(snr_db(ref, local(y)[:2].double().cpu().numpy()))
        check(snr_iir[-1] >= MIN_IIR_DB, f"ShardedBlockIIR call {i} rows 0-1 "
                                         f"{snr_iir[-1]:.2f} dB")
    ms, serial_ms = timed("iir", lambda: fi(xd), lambda: bi(xd), **SLOW)
    print(f"ShardedBlockIIR: {SHARDED_IIR_CALLS} calls of {C} x {T}, rows "
          f"0-1 {', '.join(f'{v:.2f}' for v in snr_iir)} dB vs scipy sosfilt "
          f"float64; max |sharded - serial BlockIIR| {worst:.3e}; {ms:.3f} "
          f"ms/call, serial {serial_ms:.3f}")
    del y, y_ser, xd

    # -- ShardedReceiverBank: FM M16/K16, 4 chained calls --------------------
    bank = FMReceiverBank(M, fs=FS, device=dev)
    sbank = ShardedReceiverBank(bank, mesh)
    inputs = [carriers(B, M, i * TB, TB, dev) for i in range(CALLS)]
    sst = ser = None
    for i, (xr, xi) in enumerate(inputs):
        (a, sst), n = counted(lambda: sbank((xr, xi), sst))
        check(n[kpfb.pfb_flat_kernel] == 1, f"sharded bank call {i} launched "
              f"the flat PFB kernel {n[kpfb.pfb_flat_kernel]} times")
        b_, ser = bank((xr, xi), ser)
        check(torch.equal(local(a), b_), f"sharded bank call {i} differs "
                                         f"from the serial bank")
    ms, serial_ms = timed("bank", lambda: sbank(inputs[0]),
                          lambda: bank(inputs[0]), per=STEADY, reps=3)
    print(f"ShardedReceiverBank (FM M{M}/K{K}): {CALLS} calls of {B} x {TB} "
          f"I/Q, 1 flat PFB launch a call, equal bits to the serial bank; "
          f"{ms:.3f} ms/call, serial {serial_ms:.3f}")

    # -- ShardedChannelizer (with and without gather) and ShardedFIR ---------
    xc = torch.complex(*inputs[0])
    pfb = PFBChannelizer(M, taps_per_channel=K, device=dev)
    ref_c, _ = pfb(xc)
    for gather in (False, True):
        chan = ShardedChannelizer(M, mesh, taps_per_channel=K,
                                  gather_output=gather)
        (yc, _), _ = counted(lambda: chan(xc))
        check(torch.equal(local(yc), ref_c), f"ShardedChannelizer (gather "
                                             f"{gather}) differs from serial")
    ms_c, serial_c = timed("channelizer", lambda: chan(xc), lambda: pfb(xc),
                           per=STEADY, reps=3)
    taps63 = lowpass_taps(63, 0.12, fs=1.0)
    xf = torch.randn(C, T, generator=g, device=dev)
    sfir, fir = ShardedFIR(taps63, mesh), FIRFilter(taps63, device=dev)
    ((yf, sf), _), (rf, rfs) = counted(lambda: sfir(xf)), fir(xf)
    check(torch.equal(local(yf), rf) and torch.equal(local(sf.hist), rfs.hist),
          "ShardedFIR differs from FIRFilter")
    ms_f, serial_f = timed("fir", lambda: sfir(xf), lambda: fir(xf),
                           per=STEADY, reps=3)
    print(f"ShardedChannelizer (M {M}, K {K}, {B} x {TB} complex, with and "
          f"without gather_output) and ShardedFIR (63 taps, {C} x {T}): equal "
          f"bits to the serial ops; {ms_c:.3f} / {ms_f:.3f} ms/call, serial "
          f"{serial_c:.3f} / {serial_f:.3f}")
    del xc, ref_c, yc, xf, yf, rf, inputs

    # -- the 1-D conv cell: ShardedConvolve and ShardedOverlapSaveFIR ---------
    taps = np.random.default_rng(301).standard_normal(301)
    xv = torch.randn(CB, CT, generator=g, device=dev)
    rows = xv[:2].double().cpu().numpy()
    sconv = ShardedConvolve(taps, mesh)
    yv, nv = counted(lambda: sconv(xv))
    ref_n = launched(lambda: convolve(xv, taps, "same"))
    check(nv == ref_n and nv[kols.ols_kernel] == 1,
          f"ShardedConvolve launched {nv[kols.ols_kernel]} OLS kernels")
    check(torch.equal(local(yv), convolve(xv, taps, "same")),
          "ShardedConvolve differs from convolve(x, h, 'same')")
    snr_conv = snr_db(ss.convolve(rows[0], taps, "same"),
                      local(yv)[0].double().cpu().numpy())
    snr_conv = min(snr_conv, snr_db(ss.convolve(rows[1], taps, "same"),
                                    local(yv)[1].double().cpu().numpy()))
    check(snr_conv >= MIN_CONV_DB, f"ShardedConvolve {snr_conv:.2f} dB")
    ms_v, serial_v = timed("convolve", lambda: sconv(xv),
                           lambda: convolve(xv, taps, "same"), per=STEADY,
                           reps=3)
    sols = ShardedOverlapSaveFIR(taps, mesh, block_size=1024)
    osf = OverlapSaveFIR(taps, block_size=1024, device=dev)
    check(osf.nfft == 2048, f"OverlapSaveFIR nfft {osf.nfft}")
    ((yo, so), no), (ro, rso) = counted(lambda: sols(xv)), osf(xv)
    ref_n = launched(lambda: osf(xv))
    check(no == ref_n and no[kfft.fft_frames_kernel] == 2,
          f"ShardedOverlapSaveFIR launched {no[kfft.fft_frames_kernel]} "
          f"frames FFT kernels")
    ((yo2, _), _), (ro2, _) = counted(lambda: sols(xv, so)), osf(xv, rso)
    check(torch.equal(local(yo), ro) and torch.equal(local(yo2), ro2),
          "ShardedOverlapSaveFIR differs from OverlapSaveFIR")
    lf = ss.lfilter(taps, [1.0], rows, axis=-1)
    snr_ols = min(snr_db(lf[k], local(yo)[k].double().cpu().numpy())
                  for k in range(2))
    check(snr_ols >= MIN_CONV_DB, f"ShardedOverlapSaveFIR {snr_ols:.2f} dB")
    ms_o, serial_o = timed("overlap-save", lambda: sols(xv), lambda: osf(xv),
                           per=STEADY, reps=3)
    print(f"ShardedConvolve / ShardedOverlapSaveFIR (301 taps, block 1024, "
          f"{CB} x {CT}): equal bits to convolve same / OverlapSaveFIR (two "
          f"chained calls), {nv[kols.ols_kernel]} OLS / "
          f"{no[kfft.fft_frames_kernel]} frames FFT launches a call; rows "
          f"0-1 {snr_conv:.2f} / {snr_ols:.2f} dB vs scipy float64; "
          f"{ms_v:.3f} / {ms_o:.3f} ms/call, serial {serial_v:.3f} / "
          f"{serial_o:.3f}")
    del xv, yv, yo, ro, yo2, ro2

    # -- ShardedSTFT at the transform cell ------------------------------------
    xt = torch.randn(64, 262144, generator=g, device=dev)
    st_ = ShardedSTFT(mesh, nfft=4096, hop=2048)
    (gr, gi), nt = counted(lambda: st_(xt))
    check(nt[kfft.fft_frames_kernel] == 1, f"ShardedSTFT launched "
          f"{nt[kfft.fft_frames_kernel]} frames FFT kernels")
    rows = xt[:2].double().cpu().numpy()
    ref_t = np.fft.rfft(np.lib.stride_tricks.sliding_window_view(
        rows, 4096, -1)[:, ::2048] * window_taps("hann", 4096))
    got_t = (local(gr)[:2].double().cpu().numpy()
             + 1j * local(gi)[:2].double().cpu().numpy())
    check(got_t.shape == ref_t.shape, f"ShardedSTFT frames {got_t.shape} != "
                                      f"{ref_t.shape}")
    snr_t = snr_db(ref_t, got_t)
    check(snr_t >= MIN_TRANSFORM_DB, f"ShardedSTFT {snr_t:.2f} dB")
    ms_t, serial_t = timed("stft", lambda: st_(xt),
                           lambda: stft_ri(xt, 4096, hop=2048), per=STEADY,
                           reps=3)
    print(f"ShardedSTFT (4096, hop 2048, 64 x 262144): 1 frames FFT launch, "
          f"rows 0-1 {snr_t:.2f} dB vs numpy float64; {ms_t:.3f} ms/call, "
          f"serial stft_ri {serial_t:.3f}")
    del xt, gr, gi

    # -- the dry run on the card ------------------------------------------------
    start = time.perf_counter()
    entry.dryrun_multichip(1)
    print(f"dryrun_multichip(1) on the card: "
          f"{time.perf_counter() - start:.2f} s")

    # -- the profiler window ------------------------------------------------------
    out, err = tracer.communicate(timeout=300)
    check(tracer.returncode == 0, f"the phase's tracer failed: {err[-2000:]}")
    trace = json.loads(out.strip().splitlines()[-1])
    for name, t in trace.items():
        print(f"traced {name} (mesh of one): {t['kernels']} kernels, "
              f"{t['device_us']:.1f} us of device time; {t['nccl']} NCCL "
              f"kernels, {t['nccl_us']:.1f} us; "
              f"{'; '.join(t['names'][:8])}")
    check(trace["sharded chain"]["nccl"] >= 1,
          "the traced sharded chain call ran no NCCL kernel")
    print(f"sharded timings (ms/call, {smi}): {'; '.join(times)}")
    print(f"sharded launches: " + ", ".join(
        f"{k.__class__.__name__}:{getattr(k, 'modes', '')} {n}"
        for k, n in launches.items() if n))
    return launches


# -- 27. the benchmark, its smoke and the example scenarios ---------------

EXAMPLES = ("fm_receiver", "channelize_resample", "radar_rdm")
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "detail"}
BENCH_DETAIL = {"channels", "samples_per_channel", "seconds_per_call",
                "device", "dtype", "parity_snr_db", "baseline"}
PHASE27_TIMEOUT = 300       # seconds for the phase's subprocesses, all together
SMALL_DFT_SIZES = (64, 128)
PLAIN_CHAIN_N = 32768


def example_trace() -> dict:
    """Device events of one in-process run of each example on the card,
    traced in one profiler session (``tools/probe_hlo.device_events``)
    after a warm-up run: {name: {"hand": {kernel: launches}, "kernels",
    "device_us"}}.  Run in a process of its own (a second profiler session
    in one process records no device activity)."""
    import importlib

    from simpledsp_tpu_torch.tools.probe_hlo import device_events

    calls = {}
    for name in EXAMPLES:
        mod = importlib.import_module(f"simpledsp_tpu_torch.examples.{name}")
        calls[name] = lambda mod=mod: mod.run("cuda")
    for call in calls.values():
        call()
    out = {}
    for name, evs in device_events(calls).items():
        hand = {}
        for e in evs:
            if e["kind"] == "hand":
                hand[e["name"][:60]] = hand.get(e["name"][:60], 0) + e["count"]
        out[name] = {"hand": hand,
                     "kernels": sum(e["count"] for e in evs
                                    if e["kind"] != "copy"),
                     "device_us": sum(e["device_us"] for e in evs)}
    return out


def stacked_dft(xr: torch.Tensor, xi: torch.Tensor) -> tuple:
    """The small-DFT route's form before the repair, for the comparison:
    [xr | xi] against stacked (2n, n) tables, a 2n-term sum an output."""
    from simpledsp_tpu_torch.ops.fft import dft_matrix

    n = xr.shape[-1]
    wr, wi = dft_matrix(n)
    tre, tim = (torch.as_tensor(t, dtype=xr.dtype, device=xr.device)
                for t in (np.concatenate([wr.T, -wi.T]),
                          np.concatenate([wi.T, wr.T])))
    v = torch.cat([xr, xi], -1)
    return v @ tre, v @ tim


def small_dft_rereads(dev, smi):
    """The FFT engine's small-DFT route on the card in float32 against
    float64, beside the form it replaced on the same card, the same route
    on the CPU and ``torch.fft.fft`` (cuFFT); then the plain chain route
    at N = 32768 against the float64 oracle."""
    from simpledsp_tpu_torch.models.northstar import NorthStarChain
    from simpledsp_tpu_torch.ops import fft as tfft

    rng = np.random.default_rng(27)
    for n in SMALL_DFT_SIZES:
        xr, xi = rng.standard_normal((2, (1 << 20) // n, n)).astype(np.float32)
        ref = np.fft.fft(xr.astype(np.float64) + 1j * xi.astype(np.float64))
        gr, gi = (torch.as_tensor(p, device=dev) for p in (xr, xi))
        zero_counts()
        card = tfft.fft_ri(gr, gi)
        check(sum(k.launches for k in KERNELS) == 0,
              f"the {n}-point small-DFT route launched a hand kernel")
        old = stacked_dft(gr, gi)
        cpu = tfft.fft_ri(torch.as_tensor(xr), torch.as_tensor(xi))
        lib = torch.fft.fft(torch.complex(gr, gi))
        dbs = [snr_db(ref, p[0].cpu().numpy() + 1j * p[1].cpu().numpy())
               for p in (card, old, cpu, (lib.real, lib.imag))]
        check(dbs[0] >= MIN_FFT_DB, f"the {n}-point small-DFT route on the "
                                    f"card: {dbs[0]:.2f} dB")
        print(f"small-DFT route, fft_ri n = {n}, {ref.shape[0]} rows, "
              f"float32 against float64: card {dbs[0]:.2f} dB; the stacked "
              f"(2n, n) form it replaced, on the card {dbs[1]:.2f}; the same "
              f"route on the CPU {dbs[2]:.2f}; torch.fft.fft {dbs[3]:.2f} "
              f"({smi})")
    x = rng.standard_normal((2, 1 << 20)).astype(np.float32)
    chain = NorthStarChain(fft_size=PLAIN_CHAIN_N, device=dev,
                           use_kernel=False)
    (sr, si), _ = chain(torch.as_tensor(x, device=dev))
    ref = oracle_packed(chain.design, x.astype(np.float64), PLAIN_CHAIN_N)
    db = snr_db(ref, sr.cpu().numpy() + 1j * si.cpu().numpy())
    check(db >= MIN_SNR_DB - 10, f"the plain chain at N = {PLAIN_CHAIN_N}: "
                                 f"{db:.2f} dB")
    print(f"plain chain route at N = {PLAIN_CHAIN_N} on 2 x 2^20 float32 "
          f"(seed 27): {db:.2f} dB against float64 scipy + numpy")


def bench_and_examples(dev, smi):
    """Phase 27; returns {kernel wrapper: launches} of the examples' runs
    in this process."""
    import importlib
    import os
    from pathlib import Path

    from simpledsp_tpu_torch.tools.smoke import default_out_path

    root = Path(__file__).resolve().parent
    record = default_out_path()
    record.unlink(missing_ok=True)
    env = {k: v for k, v in os.environ.items() if k != "SDSP_SKIP_SMOKE"}

    def start(args):
        return subprocess.Popen([sys.executable, *args], cwd=root, env=env,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)

    procs = {"bench": start(["-m", "simpledsp_tpu_torch", "bench"])}
    deadline = time.monotonic() + PHASE27_TIMEOUT
    try:
        # The benchmark times its loops alone on the card: the rest of the
        # phase starts once its line is out (its smoke runs beside them).
        line = procs["bench"].stdout.readline()
        for name in EXAMPLES:
            procs[name] = start(["-m", f"simpledsp_tpu_torch.examples.{name}"])
        procs["trace"] = start(["-c", "import json, chip_smoke; print("
                                      "json.dumps(chip_smoke.example_trace()))"])
        launches = {k: 0 for k in KERNELS}
        for name in EXAMPLES:
            mod = importlib.import_module(f"simpledsp_tpu_torch.examples.{name}")
            zero_counts()
            mod.check(mod.run(dev))
            ran = {k: k.launches for k in KERNELS if k.launches}
            check(bool(ran), f"the example {name} launched no hand kernel")
            print(f"example {name} in this process: ground truth held; "
                  f"launches " + ", ".join(
                      f"{k.__class__.__name__}:{getattr(k, 'modes', '')} {n}"
                      for k, n in ran.items()))
            for k, n in ran.items():
                launches[k] += n
        small_dft_rereads(dev, smi)
        outs = {}
        for name, proc in procs.items():
            outs[name] = proc.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        raise SystemExit(f"chip_smoke: FAILED: phase 27's subprocesses not "
                         f"done in {PHASE27_TIMEOUT} s")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for name, proc in procs.items():
        check(proc.returncode == 0, f"phase 27's {name} run exited "
                                    f"{proc.returncode}: {outs[name][1][-2000:]}")

    lines = (line + outs["bench"][0]).splitlines()
    check(len(lines) == 1, f"bench printed {len(lines)} stdout lines")
    rec = json.loads(lines[0])
    check(set(rec) == BENCH_KEYS and set(rec["detail"]) == BENCH_DETAIL,
          f"bench's keys: {sorted(rec)}, {sorted(rec['detail'])}")
    check(rec["metric"] == "northstar_chain_8sos_iir_4096fft_throughput",
          f"bench's metric {rec['metric']}")
    d = rec["detail"]
    check(d["parity_snr_db"] >= MIN_SNR_DB, f"bench parity "
                                            f"{d['parity_snr_db']} dB")
    smoke = json.loads(record.read_text())
    check(smoke["compiled_smoke_ok"] is True, f"the smoke's record: {smoke}")
    print(f"bench: {rec['value']} {rec['unit']}, vs_baseline "
          f"{rec['vs_baseline']}, {d['seconds_per_call'] * 1e3:.4f} ms/call "
          f"({d['channels']} x {d['samples_per_channel']}), parity "
          f"{d['parity_snr_db']} dB; device {d['device']!r} ({smi})")
    print(f"smoke: {json.dumps(smoke)}")
    for name in EXAMPLES:
        out = outs[name][0].splitlines()
        ok = importlib.import_module(f"simpledsp_tpu_torch.examples.{name}").OK
        check(bool(out) and out[-1] == ok,
              f"python -m simpledsp_tpu_torch.examples.{name}: {out[-1:]}")
        print(f"python -m simpledsp_tpu_torch.examples.{name}: exit 0; "
              + " | ".join(s.strip() for s in out))
    trace = json.loads(outs["trace"][0].strip().splitlines()[-1])
    for name in EXAMPLES:
        t = trace[name]
        check(bool(t["hand"]), f"the traced example {name} ran no hand kernel")
        print(f"traced example {name}: {t['kernels']} kernels, "
              f"{t['device_us']:.1f} us of device time; hand kernels "
              + ", ".join(f"{n} x {k}" for k, n in t["hand"].items()))
    return launches


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
    began = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from simpledsp_tpu_torch import runtime
    from simpledsp_tpu_torch.design.fir import lowpass_taps
    from simpledsp_tpu_torch.kernels import _build
    from simpledsp_tpu_torch.kernels import cfar as kcfar
    from simpledsp_tpu_torch.kernels import chain as kchain
    from simpledsp_tpu_torch.kernels import chain_variants as kcv
    from simpledsp_tpu_torch.kernels import conv2d as k2d
    from simpledsp_tpu_torch.kernels import fft as kfft
    from simpledsp_tpu_torch.kernels import ols as kols
    from simpledsp_tpu_torch.kernels import pfb as kpfb
    from simpledsp_tpu_torch.kernels import probes as kprobes
    from simpledsp_tpu_torch.models import radar, sdr
    from simpledsp_tpu_torch.models.northstar import NorthStarChain, default_design
    from simpledsp_tpu_torch.ops import conv, conv2d
    from simpledsp_tpu_torch.ops import fft as tfft
    from simpledsp_tpu_torch.ops import spectral as tsp
    from simpledsp_tpu_torch.ops import transforms as ttr
    from simpledsp_tpu_torch.ops.channelizer import PFBChannelizer
    from simpledsp_tpu_torch.ops.fir import OverlapSaveFIR

    KERNELS[:] = [kchain.chain_kernel, kpfb.pfb_flat_kernel,
                  kpfb.pfb_frames_kernel, kols.ols_kernel, k2d.conv2d_kernel,
                  kfft.fft_frames_kernel, kchain.chain_full_kernel,
                  kcv.chain_regs_kernel, kcv.chain_grouped_kernel,
                  kcv.chain_store_kernel, kprobes.scale_copy_kernel,
                  kprobes.permute_kernel, kprobes.contract_kernel,
                  kprobes.row_sum_kernel, kcfar.cfar_kernel]
    # The library calls timed beside the kernels run in IEEE float32 too.
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; {kind}; {smi}")

    # -- 2. build ----------------------------------------------------------
    start = time.perf_counter()
    build_all([kchain.chain_kernel.library, kpfb.pfb_flat_kernel.library,
               kols.ols_kernel.library, k2d.conv2d_kernel.library,
               kfft.fft_frames_kernel.library, kcv.chain_regs_kernel.library,
               kprobes.scale_copy_kernel.library, kcfar.cfar_kernel.library,
               runtime.load_library])
    secs = _build.build_seconds
    print(f"build: chain.cu {secs['sdsp_chain']:.2f} s, chain_tc.cu "
          f"{secs['sdsp_chain_tc']:.2f} s, pfb.cu "
          f"{secs['sdsp_pfb']:.2f} s, ols.cu {secs['sdsp_ols']:.2f} s, "
          f"conv2d.cu {secs['sdsp_conv2d']:.2f} s, fft.cu "
          f"{secs['sdsp_fft']:.2f} s, probes.cu "
          f"{secs['sdsp_probes']:.2f} s and cfar.cu "
          f"{secs['sdsp_cfar']:.2f} s in nvcc, native/sdsp_io.cpp "
          f"{secs['sdsp_io']:.2f} s in g++, "
          f"{time.perf_counter() - start:.2f} s for all with loading")

    chain_record, chain_ms, chain_x = chain_phases(dev, kchain, NorthStarChain,
                                                   default_design())
    family = chain_family_phase(dev, kchain, kcv, default_design())
    full_launches, layout_launches = full_path(dev, kchain, kcv,
                                               default_design(), chain_ms)
    pfb = pfb_kernel_phase(dev, kpfb, PFBChannelizer, lowpass_taps)
    flat_launches, frames_launches, _ = bank_phases(dev, kpfb, sdr,
                                                    PFBChannelizer)
    ols = ols_kernel_phase(dev, kols)
    ols_launches = conv1d_path(dev, kols, conv, OverlapSaveFIR)
    k2 = conv2d_kernel_phase(dev, k2d)
    conv2d_launches = conv2d_path(dev, k2d, conv2d)
    fft_main = fft_kernel_phase(dev, kfft)
    fft_launches = transform_path(dev, kfft, tfft, ttr, tsp)
    radar_launches, cfar_record = radar_path(dev, kfft, tfft, radar, kcfar)
    fft_launches += radar_launches
    probe_records = probe_phase(dev, kprobes)
    start = time.perf_counter()
    ols_more, fft_more = filtering_path(dev)
    print(f"phase 21 took {time.perf_counter() - start:.1f} s")
    start = time.perf_counter()
    audio_path(dev)
    print(f"phase 22 took {time.perf_counter() - start:.1f} s")
    start = time.perf_counter()
    ols_more += comms_path(dev)
    print(f"phase 23 took {time.perf_counter() - start:.1f} s")
    start = time.perf_counter()
    chain_cli, flat_cli = cli_path(dev, smi, kchain, kpfb)
    print(f"phase 24 took {time.perf_counter() - start:.1f} s")
    start = time.perf_counter()
    smoothing_path(dev, smi, sdr)
    print(f"phase 25 took {time.perf_counter() - start:.1f} s")
    start = time.perf_counter()
    sharded = sharded_path(dev, smi, chain_x)
    del chain_x
    print(f"phase 26 took {time.perf_counter() - start:.1f} s")
    start = time.perf_counter()
    examples = bench_and_examples(dev, smi)
    print(f"phase 27 took {time.perf_counter() - start:.1f} s")
    chain_record["launches"] += (chain_cli + sharded[kchain.chain_kernel]
                                 + examples[kchain.chain_kernel])
    flat_launches += (flat_cli + sharded[kpfb.pfb_flat_kernel]
                      + examples[kpfb.pfb_flat_kernel])
    frames_launches += examples[kpfb.pfb_frames_kernel]
    cfar_record["launches"] += examples[kcfar.cfar_kernel]
    ols_launches += (ols_more + sharded[kols.ols_kernel]
                     + examples[kols.ols_kernel])
    fft_launches += (fft_more + sharded[kfft.fft_frames_kernel]
                     + examples[kfft.fft_frames_kernel])
    flat_err, flat_ms, flat_plain, flat_bound, flat_dev = pfb[("flat", "fm_dec")]
    fr_err, fr_ms, fr_plain, fr_bound, fr_dev = pfb[("frames", "chan")]
    ols_err, ols_ms, ols_plain, ols_bound, ols_lib, ols_dev = ols[4096]
    k2_err, k2_ms, k2_plain, k2_bound, k2_lib, k2_dev = k2[(9, 9)]
    print(f"chip_smoke: all phases passed in {time.perf_counter() - began:.1f} "
          f"s, the build included")
    print(smi)
    print(json.dumps({"kernels": [chain_record, {
        "name": "pfb_flat", "route": "cuda",
        "source": "simpledsp_tpu_torch/csrc/pfb.cu",
        "replaces": "simpledsp_tpu/kernels/pfb.py:298",
        "launches": flat_launches, "max_abs_err": flat_err,
        "ms": flat_ms, "device_ms": flat_dev, "plain_ms": flat_plain,
        **flat_bound, "library_ms": None,
    }, {
        "name": "pfb_frames", "route": "cuda",
        "source": "simpledsp_tpu_torch/csrc/pfb.cu",
        "replaces": "simpledsp_tpu/kernels/pfb.py:475",
        "launches": frames_launches, "max_abs_err": fr_err,
        "ms": fr_ms, "device_ms": fr_dev, "plain_ms": fr_plain, **fr_bound,
        "library_ms": None,
    }, {
        "name": "ols", "route": "cuda",
        "source": "simpledsp_tpu_torch/csrc/ols.cu",
        "replaces": "simpledsp_tpu/kernels/ols.py:83",
        "launches": ols_launches, "max_abs_err": ols_err,
        "ms": ols_ms, "device_ms": ols_dev, "plain_ms": ols_plain,
        **ols_bound,
        "library_ms": ols_lib,
    }, {
        "name": "conv2d", "route": "cuda",
        "source": "simpledsp_tpu_torch/csrc/conv2d.cu",
        "replaces": "simpledsp_tpu/kernels/conv2d.py:52",
        "launches": conv2d_launches, "max_abs_err": k2_err,
        "ms": k2_ms, "device_ms": k2_dev, "plain_ms": k2_plain, **k2_bound,
        "library_ms": k2_lib,
    }, {
        "name": "fft_frames", "route": "cuda",
        "source": "simpledsp_tpu_torch/csrc/fft.cu",
        "replaces": "simpledsp_tpu/kernels/fft.py:79",
        "launches": fft_launches, **fft_main,
    }] + [{
        "name": name, "route": "cuda",
        "source": f"simpledsp_tpu_torch/csrc/{src}", "replaces": replaces,
        "launches": (full_launches if form == "full"
                     else layout_launches[name]),
        **{k: family[(form, MAIN_N)][k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None,
    } for name, form, src, replaces in FAMILY_RECORDS] + probe_records
        + [cfar_record]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
