"""The CUDA kernels against their plain versions, on an NVIDIA GPU.

These tests need a card and ``nvcc``; elsewhere they skip.  The file
imports no JAX, so it also runs where only the port is installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest

Tolerances: the chain kernel >= 130 dB SNR against its plain version
evaluated in float64 on the same float32 inputs and tables (the chain's
bar; the kernel sums in IEEE float32).  The PFB kernel: max |err| against
the float64 plain version <= max(1.5e-6 max(1, scale), 2 x the float32
plain version's own max |err|) per output, 1.5e-6 being the bank parity
gate the TPU kernels were held to; outputs for two tile sizes are equal
bit for bit.  The banks on the card: the same bar against the float64
composable path.  The overlap-save kernel: >= 100 dB SNR against its plain
version in float64 on the same float32 frames (the JAX package's on-chip
bar for ``convolve``), and no more than 6 dB below the float32 plain
version's own SNR.  The conv2d kernel: equal bit for bit to its float32
plain version.  The frames FFT kernel: >= 120 dB SNR against its plain
version in float64 on the same float32 frames (the convolution kernel bar)
and no more than 6 dB below the float32 plain version's own SNR; the paths
on the engine >= 100 dB against numpy / scipy in float64 (the JAX package's
on-chip bar for the fused transforms).  The full-spectrum chain kernel and
the layout kernels (regs, grouped, store): >= 130 dB against the float64
plain version, as the chain kernel; the store forms give the chain
kernel's bits; regs >= 120 dB against its own float32 plain version
(the same split products summed in another order).  The probes' kernels:
the copy and the transpose equal their plain versions bit for bit; the
product and the row sum >= 120 dB against the float64 plain version and no
more than 6 dB below the float32 plain version (the frames FFT kernel's
bar).  The FFT engine
gives a row the same bits in any batch, as on the CPU.  The filtering
surface on the card: in float64 within 1e-9 of the largest output of the
same call on the CPU; the FIR paths in float32 >= 100 dB against it, and
the IIR paths in float32 no more than 6 dB below the same call in float32
on the CPU.  The mel energies >= 100 dB against the CPU in float64; the
modems' noiseless round trips give every bit back.  The command-line front
end on the card against the same files with ``--device cpu``: the spectra
>= 120 dB apart, the audio within twice the bank bar (each side within the
bar of float64); a bank state saved from the card resumes bit for bit; at
the sizes the kernels do not take (``--fft 32768``, ``--channels 12``) the
same bars on the plain route, with no chain or PFB launch.  The smoothing
filters: in float64 within 1e-12 of the largest output of the same call on
the CPU, in float32 >= 100 dB against it (the FIR bar); the rank filters
give the CPU's bits; ``max_len_seq`` equals scipy.
"""

import numpy as np
import pytest
import scipy.signal as sig
import torch

from simpledsp_tpu_torch.design.biquad import sos_matrix
from simpledsp_tpu_torch.design.fir import lowpass_taps
from simpledsp_tpu_torch.kernels import chain as tchain
from simpledsp_tpu_torch.kernels import chain_variants as tcv
from simpledsp_tpu_torch.kernels import conv2d as tk2d
from simpledsp_tpu_torch.kernels import fft as tkfft
from simpledsp_tpu_torch.kernels import ols as tols
from simpledsp_tpu_torch.kernels import pfb as tpfb
from simpledsp_tpu_torch.kernels import probes as tprobes
from simpledsp_tpu_torch.kernels.fft import _best_split
from simpledsp_tpu_torch.models import radar as trd
from simpledsp_tpu_torch.models import sdr as tsdr
from simpledsp_tpu_torch.models.northstar import NorthStarChain, default_design
from simpledsp_tpu_torch.ops import conv as tconv
from simpledsp_tpu_torch.ops import conv2d as tconv2d
from simpledsp_tpu_torch.ops import fft as tfft
from simpledsp_tpu_torch.ops import spectral as tsp
from simpledsp_tpu_torch.ops import transforms as ttr
from simpledsp_tpu_torch.ops.channelizer import PFBChannelizer
from simpledsp_tpu_torch.ops.fir import OverlapSaveFIR

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA chain kernel)")
    return torch.device("cuda", 0)


def _snr_db(ref, got):
    err = sum(((g.double() - r) ** 2).sum() for r, g in zip(ref, got))
    sig = sum((r ** 2).sum() for r in ref)
    return 10 * torch.log10(sig / err).item()


@pytest.mark.parametrize("n", [1024, 2048, 4096, 16384, 200, 256, 512, 768,
                               1152])
def test_kernel_matches_plain_version(n, cuda_device):
    ops = tchain.FusedNorthStarOperators(default_design(), n, device=cuda_device)
    x = torch.as_tensor(np.random.default_rng(n).standard_normal((2, 8 * n)),
                        dtype=torch.float32, device=cuda_device)
    x3, s3, _ = tchain.chain_prepass(ops, x, torch.zeros(2, ops.state_dim,
                                                         device=cuda_device))
    launches = tchain.chain_kernel.launches
    got = tchain.chain_frames(x3, s3, ops.tables())
    torch.cuda.synchronize()
    assert tchain.chain_kernel.launches == launches + 1
    t64 = tchain.ChainTables(*(t.double() for t in ops.tables()))
    ref = tchain.chain_frames_reference(x3.double(), s3.double(), t64)
    assert _snr_db(ref, got) >= 130.0


@pytest.mark.parametrize("n,frames", [(4096, 3 * 132 + 5), (16384, 133),
                                      (200, 1001), (1024, 8 * 264 + 3)])
def test_kernel_partial_last_wave(n, frames, cuda_device):
    """A frame count that leaves the last wave of blocks partial (132 SMs;
    two frames a block and two blocks an SM at N = 4096, one frame and one
    block at 16384), and the last block short of its frames (an odd count
    at 4096, 3 of 8 at 1024, 9 of 32 at 200, whose frames of 2 rows stack
    unpadded)."""
    ops = tchain.FusedNorthStarOperators(default_design(), n, device=cuda_device)
    x = torch.as_tensor(np.random.default_rng(frames).standard_normal(
        (1, frames * n)), dtype=torch.float32, device=cuda_device)
    x3, s3, _ = tchain.chain_prepass(ops, x, torch.zeros(1, ops.state_dim,
                                                         device=cuda_device))
    got = tchain.chain_frames(x3, s3, ops.tables())
    torch.cuda.synchronize()
    assert got[0].shape == (frames, n // 2)
    t64 = tchain.ChainTables(*(t.double() for t in ops.tables()))
    ref = tchain.chain_frames_reference(x3.double(), s3.double(), t64)
    assert _snr_db(ref, got) >= 130.0


@pytest.mark.parametrize("use_kernel", [True, False])
def test_chain_on_the_card_matches_oracle(use_kernel, cuda_device):
    """Both paths on the card hold 130 dB against the float64 oracle; the
    fused one launches the kernel once per call, the composable one never."""
    chain = NorthStarChain(fft_size=4096, device=cuda_device,
                           use_kernel=use_kernel)
    x = np.random.default_rng(7).standard_normal((3, 4 * 4096)).astype(np.float32)
    launches = tchain.chain_kernel.launches
    (sr, si), state = chain(torch.as_tensor(x, device=cuda_device))
    assert tchain.chain_kernel.launches == launches + int(use_kernel)
    assert state.y_hist.device == cuda_device
    y = sig.sosfilt(sos_matrix(chain.design), x.astype(np.float64), axis=-1)
    full = np.fft.rfft(y.reshape(3, -1, 4096))
    ref_re = full.real[..., :2048]
    ref_im = np.concatenate([full.real[..., 2048:], full.imag[..., 1:2048]], -1)
    ref = tuple(torch.as_tensor(r, device=cuda_device) for r in (ref_re, ref_im))
    assert _snr_db(ref, (sr, si)) >= 130.0


def _carriers(b, t, m, seed=0):
    """Constant-envelope FM carriers, one per channel, with per-stream
    phases: (xr, xi) float32 (b, t) numpy planes."""
    rng = np.random.default_rng(seed)
    n = np.arange(t)
    z = np.zeros((b, t), np.complex128)
    for c in range(m):
        ph = rng.uniform(0, 2 * np.pi, (b, 1))
        z += np.exp(1j * (2 * np.pi * ((c + 0.002) / m) * n
                          + 2.0 * np.sin(2 * np.pi * (0.2 + 0.03 * c) / 257.0
                                         * n) + ph))
    return z.real.astype(np.float32), z.imag.astype(np.float32)


def _leaves(t):
    if isinstance(t, (tuple, list)):
        return [u for v in t for u in _leaves(v)]
    return [t]


def _within_bar(got, ref64, ref32):
    for a, r, p in zip(_leaves(got), _leaves(ref64), _leaves(ref32)):
        err = float((a.double() - r).abs().max())
        own = float((p.double() - r).abs().max())
        scale = float(r.abs().max())
        assert err <= max(1.5e-6 * max(1.0, scale), 2 * own), (err, own, scale)


PFB_MODES = [("flat", "fm"), ("flat", "fm_dec"), ("flat", "am"),
             ("flat", "am_dec"), ("flat", "am_sum"), ("frames", "fm"),
             ("frames", "fm_dec"), ("frames", "am"), ("frames", "am_dec"),
             ("frames", "chan")]


@pytest.mark.parametrize("layout,mode", PFB_MODES)
@pytest.mark.parametrize("m,k", [(16, 16), (8, 16), (32, 16), (16, 32),
                                 (128, 8), (2, 4)])
def test_pfb_kernel_matches_plain_version(layout, mode, m, k, cuda_device):
    b, g, kd = 3, 4096, 64
    dev = cuda_device
    chan = PFBChannelizer(m, taps_per_channel=k, device=dev)
    ops = chan.kernel_ops
    xr, xi = _carriers(b, (g + k) * m, m)
    xr, xi = (torch.as_tensor(v, device=dev) for v in (xr, xi))
    if layout == "frames":
        xr, xi = chan.frames_t(xr), chan.frames_t(xi)
    rng = np.random.default_rng(m + k)
    prev = [torch.as_tensor(rng.standard_normal((b, m, 1)), dtype=torch.float32,
                            device=dev) for _ in range(2)]
    ahist = torch.as_tensor(rng.standard_normal((b, m, kd - 1)),
                            dtype=torch.float32, device=dev)
    dtaps = torch.as_tensor(lowpass_taps(kd, 0.1, fs=1.0), dtype=torch.float32,
                            device=dev)
    kmode = "am_dec" if mode == "am_sum" else mode
    dec = kmode.endswith("_dec")
    fm = kmode.startswith("fm")
    kw = dict(gain=0.2, g=g, decim=4, emit_sum=mode == "am_sum")
    args = (prev[0] if fm else None, prev[1] if fm else None,
            ahist if dec else None, dtaps if dec else None)

    def kernel(tile):
        kern = tpfb.pfb_flat_kernel if layout == "flat" else tpfb.pfb_frames_kernel
        return kern(kmode, ops.tables(dev), xr, xi, *args, tile=tile, **kw)

    ref = (tpfb.pfb_flat_reference if layout == "flat"
           else tpfb.pfb_frames_reference)
    t64 = tpfb.PFBTables(*(t.double() for t in ops.tables(dev)))
    got = kernel(None)
    other = kernel(16 if m >= 64 else 64 if mode == "am_sum" else 32)
    torch.cuda.synchronize()
    ref64 = ref(kmode, t64, xr.double(), xi.double(),
                *[None if a is None else a.double() for a in args], **kw)
    ref32 = ref(kmode, ops.tables(dev), xr, xi, *args, **kw)
    _within_bar(got, ref64, ref32)
    for a, c in zip(_leaves(got), _leaves(other)):
        if a.dim() == 2:       # the emit_sum totals: compared above only
            continue
        assert torch.equal(a, c)


def _misaligned(v, offset, pad):
    """v with `pad` more columns (zero, never read), contiguous, its first
    element `offset` floats past a 16-byte boundary."""
    shape = v.shape[:-1] + (v.shape[-1] + pad,)
    n = int(np.prod(shape))
    out = torch.zeros(n + offset, device=v.device)[offset:].view(shape)
    out[..., :v.shape[-1]] = v
    return out


@pytest.mark.parametrize("mode", ["fm_dec", "am_sum", "fm", "chan"])
@pytest.mark.parametrize("offset", [1, 3])
def test_pfb_kernel_reads_misaligned_rows(mode, offset, cuda_device):
    """Planes whose first element is an odd number of floats past a 16-byte
    boundary, with an odd row stride (one more column, never read), give
    the bits of the aligned contiguous planes: flat rows (fm_dec, am_sum,
    fm) and channel-major frames (chan)."""
    b, m, k, g, kd = 3, 16, 16, 2048, 64
    dev = cuda_device
    chan = PFBChannelizer(m, taps_per_channel=k, device=dev)
    ops = chan.kernel_ops
    xr, xi = (torch.as_tensor(v, device=dev)
              for v in _carriers(b, (g + k) * m, m, seed=offset))
    rng = np.random.default_rng(offset)
    prev = [torch.as_tensor(rng.standard_normal((b, m, 1)), dtype=torch.float32,
                            device=dev) for _ in range(2)]
    ahist = torch.as_tensor(rng.standard_normal((b, m, kd - 1)),
                            dtype=torch.float32, device=dev)
    dtaps = torch.as_tensor(lowpass_taps(kd, 0.1, fs=1.0), dtype=torch.float32,
                            device=dev)
    kmode = "am_dec" if mode == "am_sum" else mode
    fm, dec = kmode.startswith("fm"), kmode.endswith("_dec")
    args = (prev[0] if fm else None, prev[1] if fm else None,
            ahist if dec else None, dtaps if dec else None)
    kw = dict(gain=0.2, g=g, decim=4, emit_sum=mode == "am_sum", tile=None)
    if mode == "chan":
        planes = [chan.frames_t(v).contiguous() for v in (xr, xi)]
        kern = tpfb.pfb_frames_kernel
    else:
        planes = [xr, xi]
        kern = tpfb.pfb_flat_kernel
    pad = 1 if planes[0].shape[-1] % 2 == 0 else 2
    shifted = [_misaligned(v, offset, pad) for v in planes]
    assert shifted[0].shape[-1] % 2 == 1
    assert shifted[0].data_ptr() % 16 == 4 * offset
    aligned = kern(kmode, ops.tables(dev), *planes, *args, **kw)
    got = kern(kmode, ops.tables(dev), *shifted, *args, **kw)
    torch.cuda.synchronize()
    for a, c in zip(_leaves(aligned), _leaves(got)):
        assert torch.equal(a, c)


@pytest.mark.parametrize("kind", ["fm", "am"])
def test_banks_on_the_card_match_float64_composable(kind, cuda_device):
    """Both banks on the card, 3 chained calls through __call__ and
    process_padded, against the float64 composable path on the card; the
    kernel launches once per call."""
    cls = tsdr.FMReceiverBank if kind == "fm" else tsdr.AMReceiverBank
    bank = cls(16, fs=1.6e6, device=cuda_device)
    oracle = cls(16, fs=1.6e6, device=cuda_device, dtype=torch.float64,
                 use_kernel=False)
    plain = cls(16, fs=1.6e6, device=cuda_device, use_kernel=False)
    assert bank.use_kernel
    b, t = 2, 16 * 4096
    xr, xi = _carriers(b, 3 * t, 16, seed=3)
    s = sp = so = s32 = None
    for i in range(3):
        part = [torch.as_tensor(v[:, i * t:(i + 1) * t], device=cuda_device)
                for v in (xr, xi)]
        launches = tpfb.pfb_flat_kernel.launches
        audio, s = bank(tuple(part), s)
        assert tpfb.pfb_flat_kernel.launches == launches + 1
        front, total = bank.padded_spec(t)
        bufs = tuple(torch.empty(b, total, device=cuda_device)
                     for _ in range(2))
        for buf, v in zip(bufs, part):
            buf[:, front:front + t] = v
        padded, sp, _ = bank.process_padded(bufs, sp)
        ref, so = oracle(tuple(v.double() for v in part), so)
        p32, s32 = plain(tuple(part), s32)
        assert torch.equal(audio, padded)
        err = float((audio.double() - ref).abs().max())
        own = float((p32.double() - ref).abs().max())
        assert err <= max(1.5e-6 * max(1.0, float(ref.abs().max())),
                          2 * own), (err, own)


def _ols_snr(got, ref):
    err = ((got.double() - ref) ** 2).sum()
    return 10 * torch.log10((ref ** 2).sum() / err).item()


@pytest.mark.parametrize("nfft,m,rows,t", [(4096, 301, 3, 20000),
                                           (8192, 1000, 1, 30000),
                                           (16384, 2000, 2, 40000),
                                           (1024, 65, 1, 5000)])
def test_ols_kernel_matches_plain_version(nfft, m, rows, t, cuda_device):
    """Both entries (the unpadded signal, and a strided frames view of the
    padded signal) launch the kernel once and give the same bits; the
    8192 case has 5 frames, so its last pair is half empty; nfft 8192 and
    16384 need the shared-memory opt-in."""
    rng = np.random.default_rng(nfft + m)
    x = torch.as_tensor(rng.standard_normal((rows, t)), dtype=torch.float32,
                        device=cuda_device)
    h = rng.standard_normal(m)
    n2 = _best_split(nfft)[1]
    o1 = -(-(m - 1) // n2)
    hop = nfft - o1 * n2
    nf = -(-(t + m - 1) // hop)
    launches = tols.ols_kernel.launches
    y = tols.convolve_ols_fused(x, h, nfft=nfft)
    frames = torch.nn.functional.pad(x, (o1 * n2, nf * hop - t)).unfold(
        -1, nfft, hop)
    yf = tols.conv_ols_frames(frames, h, overlap_rows=o1)
    torch.cuda.synchronize()
    assert tols.ols_kernel.launches == launches + 2
    assert torch.equal(y, yf.reshape(rows, -1)[:, : t + m - 1])
    ref64 = tols.conv_ols_frames_reference(
        frames.double(), tols.ols_tables(nfft, h, torch.float64, cuda_device), o1)
    ref32 = tols.conv_ols_frames_reference(
        frames, tols.ols_tables(nfft, h, torch.float32, cuda_device), o1)
    snr = _ols_snr(yf, ref64)
    assert snr >= 100.0 and snr >= _ols_snr(ref32, ref64) - 6.0
    full = np.stack([np.convolve(r, h) for r in x.cpu().double().numpy()])
    assert _ols_snr(y.cpu(), torch.as_tensor(full)) >= 100.0


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("nfft", [64, 128, 256, 512, 1024, 2048, 4096, 8192,
                                  16384])
def test_ols_kernel_at_every_size(nfft, aligned, cuda_device):
    """The kernel on the signal path's source at every frame size it takes,
    an odd frame count (the last pair without frame b) and rows of 16-byte
    copies (aligned) or 4-byte ones (the signal one sample into its
    storage, a row stride of t + 3): >= 100 dB against numpy's full
    convolution in float64 and, where the four-step split leaves output
    (nfft >= 256), against the plain version in float64 on the padded
    frames, no more than 6 dB below the float32 plain version."""
    rng = np.random.default_rng(nfft)
    rows, m = 3, 33
    n1, n2 = _best_split(nfft)
    o1 = -(-(m - 1) // n2)
    skip = o1 * n2 if o1 < n1 else 32
    hop = nfft - skip
    t = 5 * hop - m
    nf = -(-(t + m - 1) // hop)
    assert (rows * nf) % 2 == 1
    h = rng.standard_normal(m)
    host = rng.standard_normal((rows, t))
    if aligned:
        x = torch.as_tensor(host, dtype=torch.float32, device=cuda_device)
    else:
        store = torch.zeros(rows, t + 3, device=cuda_device)
        x = store[:, 1:t + 1]
        x.copy_(torch.as_tensor(host, dtype=torch.float32))
    launches = tols.ols_kernel.launches
    y = tols.ols_kernel(x, nf=nf, frame_stride=hop, offset=skip, valid=t,
                        nfft=nfft, skip=skip, taps64=h)
    torch.cuda.synchronize()
    assert tols.ols_kernel.launches == launches + 1
    got = y.reshape(rows, -1)[:, : t + m - 1].cpu()
    xs = x.cpu().double().numpy()
    full = np.stack([np.convolve(r, h) for r in xs])
    assert bool(torch.isfinite(y).all())
    assert _ols_snr(got, torch.as_tensor(full)) >= 100.0
    if o1 < n1:
        frames = torch.nn.functional.pad(x, (skip, nf * hop - t)).unfold(
            -1, nfft, hop)
        ref64 = tols.conv_ols_frames_reference(
            frames.double(), tols.ols_tables(nfft, h, torch.float64,
                                             cuda_device), o1)
        ref32 = tols.conv_ols_frames_reference(
            frames, tols.ols_tables(nfft, h, torch.float32, cuda_device), o1)
        snr = _ols_snr(y, ref64.reshape(rows * nf, hop))
        assert snr >= 100.0 and snr >= _ols_snr(ref32, ref64) - 6.0


def test_ols_kernel_rejects_what_it_does_not_take(cuda_device):
    x = torch.zeros(2, 4096, device=cuda_device)
    with pytest.raises(ValueError, match="power of two"):
        tols.conv_ols_frames(torch.zeros(3, 1000, device=cuda_device),
                             np.ones(9), overlap_rows=1)
    with pytest.raises(ValueError, match="float32"):
        tols.convolve_ols_fused(x.double(), np.ones(9), nfft=1024)


CONV2D_SHAPES = [((2, 70, 90), (9, 9)), ((1, 130, 200), (5, 7)),
                 ((3, 2, 40, 50), (3, 3)), ((1, 128, 128), (13, 13)),
                 ((1, 17, 33), (4, 2)), ((1, 8, 130), (1, 3)),
                 ((2, 200, 40), (169, 1)), ((1, 40, 300), (1, 169))]
# Every templated kw (1-16) at kh 3, the generic instance's first width, a
# batch of 300 one-tile images (not a multiple of the persistent grid), and
# 1 x 1 outputs.
CONV2D_SHAPES += [((1, 70, 150 + kw), (3, kw)) for kw in range(1, 17)]
CONV2D_SHAPES += [((1, 30, 200), (3, 17)), ((300, 66, 130), (3, 3)),
                  ((1, 9, 9), (9, 9)), ((2, 13, 13), (13, 13)),
                  ((1, 1, 1), (1, 1))]


@pytest.mark.parametrize("shape,ks", CONV2D_SHAPES)
def test_conv2d_kernel_bit_exact(shape, ks, cuda_device):
    rng = np.random.default_rng(shape[-1] + ks[0])
    x = torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32,
                        device=cuda_device)
    k = rng.standard_normal(ks)
    launches = tk2d.conv2d_kernel.launches
    got = tk2d.conv2d_valid_fused(x, k)
    torch.cuda.synchronize()
    assert tk2d.conv2d_kernel.launches == launches + 1
    ref = tk2d.conv2d_valid_reference(
        x, torch.as_tensor(k, dtype=torch.float32, device=cuda_device))
    assert got.shape == ref.shape
    assert torch.equal(got, ref)


@pytest.mark.parametrize("ks", [(3, 3), (9, 9), (1, 20)])
def test_conv2d_kernel_keeps_inf_and_nan(ks, cuda_device):
    """An image holding inf and NaN, and a zero tap: the same NaN positions
    as the plain version and equal bits everywhere else."""
    rng = np.random.default_rng(ks[1])
    x = torch.as_tensor(rng.standard_normal((2, 150, 300)),
                        dtype=torch.float32, device=cuda_device)
    x[0, 5, 7] = float("inf")
    x[0, 90, 200] = -float("inf")
    x[1, 66, 3] = float("nan")
    k = rng.standard_normal(ks)
    k[0, 1] = 0.0
    got = tk2d.conv2d_valid_fused(x, k)
    ref = tk2d.conv2d_valid_reference(
        x, torch.as_tensor(k, dtype=torch.float32, device=cuda_device))
    assert bool(ref.isnan().any())
    assert torch.equal(got.isnan(), ref.isnan())
    assert torch.equal(got.nan_to_num(0.0), ref.nan_to_num(0.0))


def test_public_entries_reach_the_kernels(cuda_device):
    """A CUDA float32 convolve on the overlap-save route and a convolve2d
    with host taps each launch their kernel once, and hold against scipy."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 20000))
    h = rng.standard_normal(301)
    launches = tols.ols_kernel.launches
    y = tconv.convolve(torch.as_tensor(x, dtype=torch.float32,
                                       device=cuda_device), h, "same")
    assert tols.ols_kernel.launches == launches + 1
    ref = np.stack([sig.convolve(r, h, "same") for r in
                    x.astype(np.float32).astype(np.float64)])
    assert _ols_snr(y.cpu(), torch.as_tensor(ref)) >= 100.0
    img = rng.standard_normal((2, 64, 80))
    k = rng.standard_normal((5, 5))
    launches = tk2d.conv2d_kernel.launches
    z = tconv2d.convolve2d(torch.as_tensor(img, dtype=torch.float32,
                                           device=cuda_device), k, "same",
                           boundary="symm")
    assert tk2d.conv2d_kernel.launches == launches + 1
    want = sig.convolve2d(img[1].astype(np.float32).astype(np.float64), k,
                          "same", boundary="symm")
    assert np.abs(z[1].cpu().double().numpy() - want).max() <= \
        1e-5 * np.abs(want).max()


def test_complex_convolve2d_launches_once_per_real_plane(cuda_device):
    rng = np.random.default_rng(12)
    img = rng.standard_normal((3, 40, 50)) + 1j * rng.standard_normal((3, 40, 50))
    k = rng.standard_normal((4, 3)) + 1j * rng.standard_normal((4, 3))
    launches = tk2d.conv2d_kernel.launches
    z = tconv2d.correlate2d(torch.as_tensor(img, dtype=torch.complex64,
                                            device=cuda_device), k, "same")
    assert tk2d.conv2d_kernel.launches == launches + 4
    want = sig.correlate2d(img[2].astype(np.complex64).astype(np.complex128),
                           k, "same")
    assert np.abs(z[2].cpu().numpy() - want).max() <= 1e-5 * np.abs(want).max()


def test_overlap_save_fir_streams_bit_exact_on_the_card(cuda_device):
    rng = np.random.default_rng(3)
    h = rng.standard_normal(301)
    x = torch.as_tensor(rng.standard_normal((4, 8 * 4096)), dtype=torch.float32,
                        device=cuda_device)
    ols = OverlapSaveFIR(h, block_size=4096, device=cuda_device)
    whole, _ = ols(x)
    a, st = ols(x[:, : 3 * 4096])
    b, _ = ols(x[:, 3 * 4096:], st)
    assert torch.equal(torch.cat([a, b], -1), whole)


@pytest.mark.parametrize("n", [8, 64, 100, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_engine_rows_get_the_same_bits_in_any_batch(n, dtype, cuda_device):
    """A row's transform does not depend on the rows transformed with it,
    also across the small-DFT route's 8192-row products on the card."""
    rng = np.random.default_rng(n)
    xr, xi = (torch.as_tensor(a, dtype=dtype, device=cuda_device)
              for a in rng.standard_normal((2, 20000, n)))
    for entry in (tfft.fft_ri, tfft.ifft_ri):
        whole = entry(xr, xi)
        for lo, count in ((0, 1), (5, 3), (8190, 7), (12000, 3000),
                          (19999, 1)):
            part = entry(xr[lo: lo + count], xi[lo: lo + count])
            for p, w in zip(part, whole):
                assert torch.equal(p, w[lo: lo + count]), (entry, lo, count)


def test_overlap_save_fir_streams_bit_exact_at_nfft_128(cuda_device):
    rng = np.random.default_rng(40)
    h = rng.standard_normal(40)
    x = torch.as_tensor(rng.standard_normal((4, 6 * 64)), dtype=torch.float32,
                        device=cuda_device)
    ols = OverlapSaveFIR(h, block_size=64, device=cuda_device)
    assert ols.nfft == 128
    whole, _ = ols(x)
    parts, st = [], None
    for lo, hi in ((0, 64), (64, 256), (256, 384)):
        y, st = ols(x[:, lo:hi], st)
        parts.append(y)
    assert torch.equal(torch.cat(parts, -1), whole)


def _frames_snr(got, ref):
    return _snr_db(ref, got)


@pytest.mark.parametrize("n", [1, 6, 64, 100, 256, 384, 1152, 4096, 8192,
                               16384, 16256])
@pytest.mark.parametrize("form", ["forward", "inverse", "real"])
def test_fft_frames_kernel_matches_plain_version(n, form, cuda_device):
    rng = np.random.default_rng(n)
    f = max(3, (1 << 16) // n)
    xr, xi = (torch.as_tensor(rng.standard_normal((f, n)), dtype=torch.float32,
                              device=cuda_device) for _ in range(2))
    if form == "real":
        xi = None
    inverse = form == "inverse"
    launches = tkfft.fft_frames_kernel.launches
    got = tkfft._fft_frames(xr, xi, inverse=inverse)
    torch.cuda.synchronize()
    assert tkfft.fft_frames_kernel.launches == launches + 1
    s = 1.0 / n if inverse else 1.0
    ref64 = [v * s for v in tkfft.fft_frames_reference(
        xr.double(), None if xi is None else xi.double(), inverse=inverse)]
    ref32 = [v * s for v in tkfft.fft_frames_reference(xr, xi,
                                                       inverse=inverse)]
    snr = _frames_snr(got, ref64)
    assert snr >= 120.0 and snr >= _frames_snr(ref32, ref64) - 6.0, snr


def test_fft_frames_kernel_reads_strided_planes(cuda_device):
    """rfft_ri's even / odd views are read in place: the same bits as their
    contiguous copies, with no copy made by the wrapper."""
    x = torch.as_tensor(np.random.default_rng(5).standard_normal((64, 8192)),
                        dtype=torch.float32, device=cuda_device)
    ev, od = x[:, 0::2], x[:, 1::2]
    got = tkfft._fft_frames(ev, od, inverse=False)
    want = tkfft._fft_frames(ev.contiguous(), od.contiguous(), inverse=False)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    cols = x.t()[:256]                     # elements 8192 apart
    got = tkfft._fft_frames(cols, None, inverse=True, scale=False)
    want = tkfft._fft_frames(cols.contiguous(), None, inverse=True,
                             scale=False)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("n", [2048, 8192])
def test_fft_frames_kernel_strided_planes_at_size(n, cuda_device):
    """Even / odd planes (element stride 2) and rows at an odd offset and
    stride (no 16-byte alignment) give the bits of their contiguous copies,
    >= 120 dB against the float64 plain version."""
    x = torch.as_tensor(np.random.default_rng(n).standard_normal((48, 2 * n + 3)),
                        dtype=torch.float32, device=cuda_device)
    for xr, xi in ((x[:, 0:2 * n:2], x[:, 1:2 * n:2]),
                   (x[:, 3:n + 3], x[:, n + 3:])):
        for inverse in (False, True):
            got = tkfft._fft_frames(xr, xi, inverse=inverse)
            want = tkfft._fft_frames(xr.contiguous(), xi.contiguous(),
                                     inverse=inverse)
            assert all(torch.equal(a, b) for a, b in zip(got, want))
            s = 1.0 / n if inverse else 1.0
            ref = [v * s for v in tkfft.fft_frames_reference(
                xr.double(), xi.double(), inverse=inverse)]
            assert _frames_snr(got, ref) >= 120.0


def test_fft_frames_kernel_rejects_what_it_does_not_take(cuda_device):
    x = torch.zeros(4, 256, device=cuda_device)
    with pytest.raises(ValueError, match="float32"):
        tkfft.fft_frames_kernel(x.double(), None, inverse=False, scale=False)
    with pytest.raises(ValueError, match="131"):
        tkfft._fft_frames(torch.zeros(4, 131, device=cuda_device), None,
                          inverse=False)
    with pytest.raises(ValueError, match="shape"):
        tkfft.fft_frames_kernel(x, x[:2], inverse=False, scale=False)
    with pytest.raises(ValueError, match="float32"):
        tkfft.fft_frames_kernel(x, x.cpu(), inverse=False, scale=False)


def test_engine_paths_launch_the_frames_kernel(cuda_device):
    """fft / ifft / rfft / irfft, Bluestein, dct, the analytic signal, the
    stft / istft engine route and the radar map launch the kernel as many
    times as the code implies, and hold >= 100 dB against numpy / scipy;
    float64 never launches it."""
    import scipy.fft as sfft
    rng = np.random.default_rng(21)
    x64 = rng.standard_normal((4, 8192))
    x = torch.as_tensor(x64, dtype=torch.float32, device=cuda_device)
    xq = x.double().cpu().numpy()
    z = torch.zeros_like(x)

    def runs(fn):
        before = tkfft.fft_frames_kernel.launches
        out = fn()
        return out, tkfft.fft_frames_kernel.launches - before

    def cplx(pair):
        return (pair[0].double().cpu().numpy()
                + 1j * pair[1].double().cpu().numpy())

    cases = [
        (lambda: tfft.fft_ri(x, z), 1, lambda o: cplx(o),
         lambda: np.fft.fft(xq)),
        (lambda: tfft.ifft_ri(x, z), 1, lambda o: cplx(o),
         lambda: np.fft.ifft(xq)),
        (lambda: tfft.rfft_ri(x), 1, lambda o: cplx(o),
         lambda: np.fft.rfft(xq)),
        (lambda: tfft.irfft_ri(*tfft.rfft_ri(x)), 2,
         lambda o: o.double().cpu().numpy(), lambda: xq),
        (lambda: tfft.fft_ri(x[:, :4099], z[:, :4099]), 2, lambda o: cplx(o),
         lambda: np.fft.fft(xq[:, :4099])),
        (lambda: ttr.dct(x[:, :4096], 2, norm="ortho"), 1,
         lambda o: o.double().cpu().numpy(),
         lambda: sfft.dct(xq[:, :4096], 2, norm="ortho")),
        (lambda: ttr.analytic_ri(x[:, :4096]), 2, lambda o: cplx(o),
         lambda: sig.hilbert(xq[:, :4096], axis=-1)),
        (lambda: tsp.stft_ri(x, 4096, hop=2048), 1, lambda o: cplx(o),
         lambda: np.fft.rfft(
             np.lib.stride_tricks.sliding_window_view(xq, 4096, -1)[:, ::2048]
             * tsp.window_taps("hann", 4096))),
    ]
    for i, (fn, want, get, oracle) in enumerate(cases):
        out, n = runs(fn)
        assert n == want, (i, n, want)
        got, ref = get(out), oracle()
        assert got.shape == ref.shape, i
        err = np.abs(got - ref) ** 2
        assert 10 * np.log10((np.abs(ref) ** 2).sum() / err.sum()) >= 100.0, i
    sr, si = tsp.stft_ri(x, 4096, hop=2048)
    y, n = runs(lambda: tsp.istft_ri(sr, si, 4096, hop=2048))
    assert n == 1
    inner = slice(2048, y.shape[-1] - 2048)
    err = ((y[:, inner].double().cpu().numpy() - xq[:, inner]) ** 2).sum()
    assert 10 * np.log10((xq[:, inner] ** 2).sum() / err) >= 100.0
    _, n = runs(lambda: tfft.fft_ri(x.double(), z.double()))
    assert n == 0
    tx = trd.lfm_chirp(64, 0.8)
    p = torch.as_tensor(rng.standard_normal((2, 256, 512)), dtype=torch.float32,
                        device=cuda_device)
    _, n = runs(lambda: trd.range_doppler_map(p, p, *tx))
    assert n == 3


def _chain_frames(n, device):
    ops = tchain.FusedNorthStarOperators(default_design(), n, device=device)
    x = torch.as_tensor(np.random.default_rng(n).standard_normal(
        (2, 8 * n)), dtype=torch.float32, device=device)
    x3, s3, _ = tchain.chain_prepass(ops, x, torch.zeros(2, ops.state_dim,
                                                         device=device))
    return ops, x3, s3


def _tables64(tables):
    return tchain.ChainTables(*(t.double() for t in tables))


@pytest.mark.parametrize("n", [1000, 1024, 4096, 16384, 200, 375, 8181,
                               16129])
def test_full_kernel_matches_plain_version(n, cuda_device):
    """The full-spectrum kernel, odd n2 (1000 = 8 x 125) and odd N (375 =
    3 x 125, 8181 = 81 x 101 at 32 values a thread, and 16129 = 127 x 127,
    the largest odd N, at 64) included."""
    ops, x3, s3 = _chain_frames(n, cuda_device)
    tabs = ops.tables(full=True)
    launches = tchain.chain_full_kernel.launches
    got = tchain.chain_frames_full(x3, s3, tabs)
    torch.cuda.synchronize()
    assert tchain.chain_full_kernel.launches == launches + 1
    assert got[0].shape == (x3.shape[0], n)
    ref = tchain.chain_frames_full_reference(x3.double(), s3.double(),
                                             _tables64(tabs))
    assert _snr_db(ref, got) >= 130.0


@pytest.mark.parametrize("n,frames", [(4096, 3 * 132 + 5), (16384, 133),
                                      (1000, 8 * 132 + 3), (375, 133),
                                      (16129, 133)])
def test_full_kernel_partial_last_wave(n, frames, cuda_device):
    """The full-spectrum kernel at frame counts that leave the last wave of
    blocks partial and the last block short of its frames (two frames a
    block at 4096, eight at 1000 and at the odd 375 (5 in the last), one at
    16384 and at the odd 16129)."""
    ops = tchain.FusedNorthStarOperators(default_design(), n, device=cuda_device)
    x = torch.as_tensor(np.random.default_rng(frames).standard_normal(
        (1, frames * n)), dtype=torch.float32, device=cuda_device)
    x3, s3, _ = tchain.chain_prepass(ops, x, torch.zeros(1, ops.state_dim,
                                                         device=cuda_device))
    tabs = ops.tables(full=True)
    got = tchain.chain_frames_full(x3, s3, tabs)
    torch.cuda.synchronize()
    assert got[0].shape == (frames, n)
    ref = tchain.chain_frames_full_reference(x3.double(), s3.double(),
                                             _tables64(tabs))
    assert _snr_db(ref, got) >= 130.0


@pytest.mark.parametrize("layout", ["regs", "regw", "fmajor", "reg2", "reg4",
                                    "regp", "pair"])
@pytest.mark.parametrize("n", [200, 1024, 4096, 16384])
def test_layout_kernels_match_plain_version(layout, n, cuda_device):
    """Each layout's kernel against the float64 plain version of the chain
    (the function every layout computes), launched once through its
    wrapper."""
    ops, x3, s3 = _chain_frames(n, cuda_device)
    tabs = ops.tables()
    if layout == "regs":
        kernel, run = tcv.chain_regs_kernel, lambda: tcv.chain_frames_regs(
            x3, s3, tabs)
    elif layout in ("regw", "fmajor"):
        mode = "wide" if layout == "regw" else "fmajor"
        kernel, run = tcv.chain_store_kernel, lambda: tcv.chain_frames_store(
            x3, s3, tabs, mode)
    else:
        g = tcv.group_frames(layout, ops.n1, ops.n2, 64, ops.state_dim)
        kernel, run = tcv.chain_grouped_kernel, lambda: tcv.chain_frames_grouped(
            x3, s3, tabs, g)
    launches = kernel.launches
    got = run()
    torch.cuda.synchronize()
    assert kernel.launches == launches + 1
    if kernel is tcv.chain_grouped_kernel:
        assert kernel.last_g == g
    if layout == "fmajor":
        got = tuple(p.transpose(1, 2).reshape(x3.shape[0], -1) for p in got)
    ref = tchain.chain_frames_reference(x3.double(), s3.double(),
                                        _tables64(tabs))
    assert _snr_db(ref, got) >= 130.0


@pytest.mark.parametrize("n,frames", [(200, 65), (768, 13), (16384, 3)])
def test_regs_kernel_partial_last_block(n, frames, cuda_device):
    """The regs form at frame counts that leave its last block short of the
    kernel's own g (32 at N = 200, 8 at 768, 1 at 16384): >= 130 dB against
    the float64 plain version, and within float32 rounding of its own plain
    version (the split product summed in float32)."""
    ops = tchain.FusedNorthStarOperators(default_design(), n, device=cuda_device)
    x = torch.as_tensor(np.random.default_rng(frames).standard_normal(
        (1, frames * n)), dtype=torch.float32, device=cuda_device)
    x3, s3, _ = tchain.chain_prepass(ops, x, torch.zeros(1, ops.state_dim,
                                                         device=cuda_device))
    tabs = ops.tables()
    launches = tcv.chain_regs_kernel.launches
    got = tcv.chain_frames_regs(x3, s3, tabs)
    torch.cuda.synchronize()
    assert tcv.chain_regs_kernel.launches == launches + 1
    ref = tchain.chain_frames_reference(x3.double(), s3.double(),
                                        _tables64(tabs))
    assert _snr_db(ref, got) >= 130.0
    own = tcv.chain_frames_regs_reference(x3, s3, tabs)
    assert _snr_db(tuple(o.double() for o in own), got) >= 120.0


@pytest.mark.parametrize("n", [200, 1024, 4096, 16384])
def test_store_forms_give_the_bits_of_reg(n, cuda_device):
    """regw and fmajor change only the chain kernel's store: their planes,
    fmajor's after the transpose to natural order, are reg's bits."""
    ops, x3, s3 = _chain_frames(n, cuda_device)
    tabs = ops.tables()
    want = tchain.chain_frames(x3, s3, tabs)
    wide = tcv.chain_frames_store(x3, s3, tabs, "wide")
    fmajor = tcv.chain_frames_store(x3, s3, tabs, "fmajor")
    assert fmajor[0].shape == (x3.shape[0], ops.n1, ops.n2 // 2)
    fmajor = tuple(p.transpose(1, 2).reshape(x3.shape[0], -1) for p in fmajor)
    for got in (wide, fmajor):
        assert all(torch.equal(g_, w_) for g_, w_ in zip(got, want))


@pytest.mark.parametrize("g", [1, 3, 16])
def test_grouped_kernel_partial_last_block(g, cuda_device):
    """A frame count that g does not divide: the last block holds fewer
    frames and writes only theirs."""
    ops, x3, s3 = _chain_frames(768, cuda_device)
    x3, s3 = x3[:13].contiguous(), s3[:13].contiguous()
    tabs = ops.tables()
    got = tcv.chain_frames_grouped(x3, s3, tabs, g)
    ref = tchain.chain_frames_reference(x3.double(), s3.double(),
                                        _tables64(tabs))
    assert _snr_db(ref, got) >= 130.0


@pytest.mark.parametrize("half,layout", [(False, None), (True, "reg"),
                                         (True, "k1"), (True, "regs"),
                                         (True, "regw"), (True, "reg2"),
                                         (True, "reg4"), (True, "regp"),
                                         (True, "fmajor"), (True, "pair")])
def test_fused_chain_frames_on_the_card(half, layout, cuda_device):
    """The public entry on the card: one launch a call, the JAX shapes, and
    >= 130 dB against scipy sosfilt + numpy fft in float64."""
    n = 4096
    ops = tchain.FusedNorthStarOperators(default_design(), n)
    assert ops.H.device.type == "cuda"
    x = np.random.default_rng(9).standard_normal((3, 4 * n)).astype(np.float32)
    kernels = [tchain.chain_kernel, tchain.chain_full_kernel,
               tcv.chain_regs_kernel, tcv.chain_grouped_kernel,
               tcv.chain_store_kernel]
    before = sum(k.launches for k in kernels)
    (sr, si), _ = tchain.fused_chain_frames(
        ops, torch.as_tensor(x, device=cuda_device),
        torch.zeros(3, ops.state_dim, device=cuda_device),
        half_spectrum=half, layout=layout)
    torch.cuda.synchronize()
    assert sum(k.launches for k in kernels) == before + 1
    y = sig.sosfilt(sos_matrix(ops.design), x.astype(np.float64), axis=-1)
    full = np.fft.fft(y.reshape(3, -1, n))
    if half:
        assert sr.shape == (3, 4, 64, 32)
        ref = full[..., : n // 2].copy()
        ref[..., 0] += 1j * full[..., n // 2].real
    else:
        assert sr.shape == (3, 4, 128, 32)
        ref = full
    got = (sr.reshape(3, 4, -1).double() + 1j * si.reshape(3, 4, -1).double()
           ).cpu().numpy()
    err = (np.abs(got - ref) ** 2).sum()
    assert 10 * np.log10((np.abs(ref) ** 2).sum() / err) >= 130.0


def test_chain_variant_kernels_reject_what_they_do_not_take(cuda_device):
    ops, x3, s3 = _chain_frames(1024, cuda_device)
    tabs = ops.tables()
    with pytest.raises(ValueError, match="float32"):
        tcv.chain_regs_kernel(x3.double(), s3, tabs)
    with pytest.raises(ValueError, match="fit a block"):
        tcv.chain_regs_kernel(x3, torch.zeros(x3.shape[0], 400, x3.shape[1],
                                              device=cuda_device),
                              tabs._replace(T3=torch.zeros(
                                  3, 528, 128, device=cuda_device)))
    with pytest.raises(ValueError, match="fit a block"):
        tcv.chain_grouped_kernel(x3, s3, tabs, 64)
    with pytest.raises(ValueError, match="launches"):
        tcv.chain_store_kernel(x3, s3, tabs, "full")
    lower = tabs._replace(HT=tabs.HT.T.contiguous())
    with pytest.raises(ValueError, match="upper-triangular"):
        tcv.chain_grouped_kernel(x3, s3, lower, 2)
    with pytest.raises(ValueError, match="upper-triangular"):
        tcv.chain_store_kernel(x3, s3, lower, "wide")
    with pytest.raises(ValueError, match="expected"):
        tchain.chain_full_kernel(x3, s3, tabs._replace(PhiT=tabs.PhiT[1:]))


# -- the probes' kernels (kernels/probes.py) ----------------------------------

@pytest.mark.parametrize("n", [8 * 128, 1000003])
@pytest.mark.parametrize("vec_bytes", [4, 8, 16])
def test_scale_copy_kernel_bit_exact(n, vec_bytes, cuda_device):
    x = torch.randn(n, generator=torch.Generator(cuda_device).manual_seed(n),
                    device=cuda_device)
    before = tprobes.scale_copy_kernel.launches
    assert torch.equal(tprobes.scale_copy(x, vec_bytes=vec_bytes), x * 2.0)
    assert tprobes.scale_copy_kernel.launches == before + 1
    tile = x[:1024].view(8, 128)
    assert torch.equal(tprobes.scale_copy(tile, 0.5, same_tile_blocks=64),
                       tile * 0.5)


@pytest.mark.parametrize("shape,rows,batch", [((16, 16, 128), 32, 1),
                                              ((5, 100, 33), 64, 2),
                                              ((3, 1000, 45), 2048, 8)])
def test_permute_kernel_bit_exact(shape, rows, batch, cuda_device):
    x = torch.randn(shape, generator=torch.Generator(cuda_device).manual_seed(1),
                    device=cuda_device)
    before = tprobes.permute_kernel.launches
    got = tprobes.permute(x, 1.5, rows_per_block=rows, batch_per_block=batch)
    assert torch.equal(got, tprobes.permute_reference(x, 1.5))
    assert tprobes.permute_kernel.launches == before + 1
    view = x.permute(1, 0, 2)                     # strided, as the relayout
    if view.shape[2] % 2 == 0:
        for g, w in zip(tprobes.permute(view, split=True),
                        tprobes.permute_reference(view, split=True)):
            assert torch.equal(g, w)


@pytest.mark.parametrize("n", [1, 3, 4097, 1000003])
@pytest.mark.parametrize("vec_bytes", [4, 8, 16])
def test_scale_copy_kernel_tails(n, vec_bytes, cuda_device):
    """n % 4 != 0 (the scalar tail), one pass and same-tile mode."""
    x = torch.randn(n, generator=torch.Generator(cuda_device).manual_seed(n),
                    device=cuda_device)
    assert torch.equal(tprobes.scale_copy(x, 3.0, vec_bytes=vec_bytes), x * 3.0)
    tile = x[:min(n, 1003)]
    for g in (1, 7):
        assert torch.equal(tprobes.scale_copy(tile, -0.5, vec_bytes=vec_bytes,
                                              same_tile_blocks=g),
                           tile * -0.5)


@pytest.mark.parametrize("vec_bytes", [4, 8, 16])
def test_scale_copy_kernel_beyond_2_gib(vec_bytes, cuda_device):
    """More than 2^31 bytes in: 64-bit offsets; the last floats checked."""
    n = (1 << 29) + 3
    free, _ = torch.cuda.mem_get_info(cuda_device)
    if free < 3 * 4 * n:
        pytest.skip("needs 6.5 GB of free device memory")
    x = torch.empty(n, device=cuda_device)
    x[:] = 1.0
    x[-1000:] = torch.arange(1000, device=cuda_device, dtype=torch.float32)
    y = tprobes.scale_copy(x, 2.0, vec_bytes=vec_bytes)
    assert torch.equal(y[-1000:], x[-1000:] * 2.0)
    assert bool((y[:-1000] == 2.0).all())
    del x, y


def test_scale_copy_kernel_on_two_streams_and_in_a_graph(cuda_device):
    """Copies on two streams at once, and replayed from a CUDA graph, give
    the bits of the same calls made one at a time."""
    gen = torch.Generator(cuda_device).manual_seed(5)
    xs = [torch.randn(1 << 22, generator=gen, device=cuda_device) + i
          for i in range(2)]
    want = [x * 2.0 for x in xs]
    streams = [torch.cuda.Stream(cuda_device) for _ in xs]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream(cuda_device))
    got = [[], []]
    for _ in range(20):
        for i, (x, st) in enumerate(zip(xs, streams)):
            with torch.cuda.stream(st):
                got[i].append(tprobes.scale_copy(x))
    torch.cuda.synchronize(cuda_device)
    for i in range(2):
        assert all(torch.equal(g, want[i]) for g in got[i]), i
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side), torch.cuda.graph(graph):
        captured = [tprobes.scale_copy(x, vec_bytes=v)
                    for x, v in zip(xs, (16, 4))]
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize(cuda_device)
        assert all(torch.equal(c, w) for c, w in zip(captured, want))


@pytest.mark.parametrize("shape,vec", [
    ((4, 1000, 16), True), ((300, 16, 128), True), ((9, 16, 16), True),
    ((64, 32, 128), True), ((70, 32, 64), True), ((3, 68, 20), True),
    ((2, 4, 4), True),
    # not multiples of 4: the 4-byte instance
    ((3, 101, 45), False), ((5, 67, 30), False), ((2, 16, 13), False),
    ((1, 1, 1), False)])
def test_permute_kernel_shapes(shape, vec, cuda_device):
    """C = 16, R = 16, both, shapes that are not multiples of 4 or of a
    tile, with a scale: the plain version's bits, one launch, and the
    instance permute_plan picks."""
    x = torch.randn(shape, generator=torch.Generator(cuda_device).manual_seed(
        sum(shape)), device=cuda_device)
    before = tprobes.permute_kernel.launches
    got = tprobes.permute(x, -1.25)
    assert tprobes.permute_kernel.launches == before + 1
    assert tprobes.permute_kernel.last_plan.vec == vec
    assert torch.equal(got, tprobes.permute_reference(x, -1.25))


def test_permute_kernel_takes_the_scalar_instance(cuda_device):
    """A view with columns strided (sc != 1), and one whose base pointer
    is one float past a 16-byte boundary: the 4-byte instance, the same
    bits."""
    gen = torch.Generator(cuda_device).manual_seed(3)
    x = torch.randn(6, 64, 96, generator=gen, device=cuda_device)
    views = {"sc != 1": x.transpose(1, 2),
             "misaligned": x.view(-1)[1:1 + 6 * 64 * 92].view(6, 64, 92),
             "row stride odd": x.view(-1)[:6 * 64 * 33].view(6, 64, 33)[
                 :, :, :32]}
    for name, v in views.items():
        got = tprobes.permute(v, 0.5)
        assert not tprobes.permute_kernel.last_plan.vec, name
        assert torch.equal(got, tprobes.permute_reference(v, 0.5)), name
        if v.shape[2] % 2 == 0:
            for g, w in zip(tprobes.permute(v, split=True),
                            tprobes.permute_reference(v, split=True)):
                assert torch.equal(g, w), name


@pytest.mark.parametrize("shape", [(3, 40, 66), (5, 33, 2), (2, 64, 130)])
def test_permute_kernel_split_with_odd_half(shape, cuda_device):
    """C / 2 odd: a tile straddles the split column."""
    x = torch.randn(shape, generator=torch.Generator(cuda_device).manual_seed(
        shape[2]), device=cuda_device)
    for g, w in zip(tprobes.permute(x, 2.0, split=True),
                    tprobes.permute_reference(x, 2.0, split=True)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("shape", [(0, 8, 16), (4, 0, 16), (4, 8, 0)])
def test_permute_kernel_empty(shape, cuda_device):
    x = torch.zeros(shape, device=cuda_device)
    got = tprobes.permute(x)
    assert got.shape == (shape[0], shape[2], shape[1])
    g0, g1 = tprobes.permute(x, split=True)
    assert g0.shape == g1.shape == (shape[0], shape[2] // 2, shape[1])


@pytest.mark.parametrize("p,lt", [(8, 2048), (8, 8192), (1, 8192), (1, 32),
                                  (16, 32), (3, 96)])
def test_permute_kernel_transpose_forms(p, lt, cuda_device):
    """probe_transpose's (P, L) forms at a reduced nfr: P and L order the
    tiles, never the bits."""
    nfr = 4096 + 128
    x3 = torch.randn(16, nfr, 16, generator=torch.Generator(
        cuda_device).manual_seed(lt), device=cuda_device)
    got = tprobes.permute(x3, rows_per_block=lt, batch_per_block=p)
    assert torch.equal(got, x3.transpose(-1, -2).contiguous())


@pytest.mark.parametrize("tile", [2048, 4096, 16384])
def test_permute_kernel_other_tile_sizes(tile, cuda_device, monkeypatch):
    """The kernel's tile is its kPermTile: a plan of another size (the
    variant tool's tile arms edit both) is refused, and counts no
    launch."""
    monkeypatch.setattr(tprobes, "PERMUTE_TILE", tile)
    x = torch.randn(5, 1000, 16, device=cuda_device)
    before = tprobes.permute_kernel.launches
    with pytest.raises(RuntimeError, match="permute kernel launch failed"):
        tprobes.permute(x)
    assert tprobes.permute_kernel.launches == before


def _probe_snr_ok(got, plain32, ref64):
    snr = _snr_db([ref64], [got])
    return snr >= 120.0 and snr >= _snr_db([ref64], [plain32]) - 6.0, snr


@pytest.mark.parametrize("m,k,n,group", [
    (64, 320, 320, None), (2048, 128, 10, 32), (37, 45, 13, None),
    # the chain's sizes: the prepass's kb @ TO and x @ KT with its shift
    (16384, 320, 320, None), (524288, 128, 10, 32),
    # split K steps (4 tiles, 16 steps a cluster), with and without the
    # shift-in; too many steps for a cluster (one block a tile)
    (256, 500, 40, None), (256, 500, 40, 32), (256, 1000, 40, None),
    (256, 1000, 40, 32),
    # the skinny form's widths and the first tiled one
    (3000, 64, 1, None), (3000, 64, 16, 8), (3000, 64, 17, None),
    (3000, 64, 17, 8),
    # k not a multiple of the step, a tail of rows and columns, k = 0
    (130, 37, 70, None), (100, 0, 20, None)])
def test_contract_kernel_matches_plain_version(m, k, n, group, cuda_device):
    _check_contract(m, k, n, group, False, cuda_device)


@pytest.mark.parametrize("m,k,n,group", [(64, 320, 320, None),
                                         (2048, 128, 10, 32),
                                         (256, 500, 40, 32),
                                         (256, 1000, 40, 32)])
def test_contract_kernel_reads_unaligned_operands(m, k, n, group,
                                                  cuda_device):
    """A starts one float past a 16-byte boundary: 4-byte copies."""
    _check_contract(m, k, n, group, True, cuda_device)


def _check_contract(m, k, n, group, unaligned, cuda_device):
    gen = torch.Generator(cuda_device).manual_seed(m)
    a = torch.randn(m * k + 1, generator=gen, device=cuda_device)
    a = (a[1:] if unaligned else a[:-1]).view(m, k)
    assert (a.data_ptr() % 16 != 0) == unaligned
    b = torch.randn(n, k, generator=gen, device=cuda_device).T   # strided
    if k == 0:
        got = tprobes.contract(a, b)
        assert torch.equal(got, torch.zeros(m, n, device=cuda_device))
        return
    sf = (None if group is None else
          torch.randn(m // group, n, generator=gen, device=cuda_device))
    before = tprobes.contract_kernel.launches
    got = tprobes.contract(a, b, sf=sf, group=group or 1)
    assert tprobes.contract_kernel.launches == before + 1
    ref = tprobes.contract_reference(a.double(), b.double(),
                                     None if sf is None else sf.double(),
                                     group or 1)
    ok, snr = _probe_snr_ok(got, tprobes.contract_reference(a, b, sf,
                                                            group or 1), ref)
    assert ok, snr
    # The same launch again: its sums do not depend on block timing.
    assert torch.equal(tprobes.contract(a, b, sf=sf, group=group or 1), got)


@pytest.mark.parametrize("m,k,n,group,rows", [
    # tiled: 128-row tiles unsplit, 64-row tiles unsplit, each K step a block
    (16384, 320, 320, None, (4096, 300, 64, 1)),
    (16384, 200, 40, 8, (4096, 256, 8)),
    # skinny: two warps a block (many blocks), four (few); 7 K steps, so
    # a warp's groups are uneven
    (40000, 128, 10, 32, (2048, 32)), (40000, 200, 16, None, (2049, 1))])
def test_contract_kernel_bits_do_not_depend_on_rows(m, k, n, group, rows,
                                                    cuda_device):
    """contract(a[:r]) is contract(a)[:r] bit for bit: the form, the tile,
    the K split and the warps a block change with the rows, the order of
    the sums does not."""
    gen = torch.Generator(cuda_device).manual_seed(k + n)
    a = torch.randn(m, k, generator=gen, device=cuda_device)
    b = torch.randn(k, n, generator=gen, device=cuda_device)
    sf = (None if group is None else
          torch.randn(m // group, n, generator=gen, device=cuda_device))
    whole = tprobes.contract(a, b, sf=sf, group=group or 1)
    for r in rows:
        part = tprobes.contract(a[:r], b, sf=None if sf is None else
                                sf[:r // group], group=group or 1)
        assert torch.equal(part, whole[:r]), r


def test_contract_kernel_split_calls_share_nothing(cuda_device):
    """Split contractions on two streams at once, and replayed from a CUDA
    graph, give the bits of the same calls made one at a time."""
    gen = torch.Generator(cuda_device).manual_seed(11)
    ops = [(torch.randn(64, 320, generator=gen, device=cuda_device),
            torch.randn(320, 320, generator=gen, device=cuda_device))
           for _ in range(2)]
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert tprobes.contract_plan(64, 320, 320, sms)[1] > 1
    want = [tprobes.contract(a, b) for a, b in ops]
    streams = [torch.cuda.Stream(cuda_device) for _ in ops]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream(cuda_device))
    got = [[], []]
    for _ in range(50):
        for i, ((a, b), s) in enumerate(zip(ops, streams)):
            with torch.cuda.stream(s):
                got[i].append(tprobes.contract(a, b))
    torch.cuda.synchronize(cuda_device)
    for i in range(2):
        assert all(torch.equal(g, want[i]) for g in got[i]), i
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side), torch.cuda.graph(graph):
        captured = [tprobes.contract(a, b) for a, b in ops]
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize(cuda_device)
        assert all(torch.equal(c, w) for c, w in zip(captured, want))


@pytest.mark.parametrize("rows,cols", [(16384, 320), (1001, 7), (33, 1000)])
def test_row_sum_kernel_matches_plain_version(rows, cols, cuda_device):
    x = torch.randn(rows, cols, device=cuda_device,
                    generator=torch.Generator(cuda_device).manual_seed(rows))
    before = tprobes.row_sum_kernel.launches
    got = tprobes.row_sum(x)
    assert tprobes.row_sum_kernel.launches == before + 1
    ok, snr = _probe_snr_ok(got, tprobes.row_sum_reference(x),
                            tprobes.row_sum_reference(x.double()))
    assert ok, snr


def test_probe_kernels_reject_what_they_do_not_take(cuda_device):
    x = torch.zeros(4, 32, 8, device=cuda_device)
    with pytest.raises(ValueError, match="float32"):
        tprobes.scale_copy(x.double())
    with pytest.raises(ValueError, match="aligned"):
        tprobes.scale_copy(x.view(-1)[1:])
    with pytest.raises(ValueError, match="float32"):
        tprobes.permute(x.double())
    with pytest.raises(ValueError, match="float32"):
        tprobes.contract(x[0], x[0].T.double())
    with pytest.raises(ValueError, match="float32"):
        tprobes.row_sum(x[0].double())


# -- the filtering surface, audio and comms on the card ----------------------------

def _rel_err(got, ref):
    got, ref = got.double().cpu(), ref.double().cpu()
    return float((got - ref).abs().max() / ref.abs().max())


def _snr(got, ref):
    return _snr_db([ref.double().cpu()], [got.double().cpu()])


def _noise(shape, seed, device):
    return torch.as_tensor(np.random.default_rng(seed).standard_normal(shape),
                           device=device)


@pytest.mark.parametrize("method", ["block", "scan"])
def test_lfilter_on_the_card_matches_cpu(method, cuda_device):
    from simpledsp_tpu_torch.design.iir import butter
    from simpledsp_tpu_torch.ops.lfilter import filtfilt, lfilter
    b, a = butter(4, 0.2, output="ba")
    t = 4096 if method == "block" else 300
    x = _noise((4, t), 0, "cpu")
    ref, zref = lfilter(b, a, x, method="scan")
    got, zf = lfilter(b, a, x.to(cuda_device), method=method)
    assert got.device.type == "cuda"
    assert _rel_err(got, ref) < 1e-9 and _rel_err(zf, zref) < 1e-9
    got32, _ = lfilter(b, a, x.float().to(cuda_device), method=method)
    cpu32, _ = lfilter(b, a, x.float(), method=method)
    assert _snr(got32, ref) >= _snr(cpu32, ref) - 6.0
    ff = filtfilt(b, a, x.to(cuda_device))
    assert _rel_err(ff, filtfilt(b, a, x)) < 1e-9


def test_block_lfilter_defaults_to_the_card(cuda_device):
    from simpledsp_tpu_torch.ops.lfilter import BlockLFilter
    f = BlockLFilter([0.2, 0.3], [1.0, -0.5])
    assert f.H.device.type == "cuda"


def test_sosfiltfilt_on_the_card_matches_cpu(cuda_device):
    from simpledsp_tpu_torch.design.biquad import design_lowpass
    from simpledsp_tpu_torch.ops.iir import sosfiltfilt
    d = design_lowpass(4, 2000.0, 39000.0)
    x = _noise((4, 8192), 1, "cpu")
    ref = sosfiltfilt(d, x)
    assert _rel_err(sosfiltfilt(d, x.to(cuda_device)), ref) < 1e-9
    got32 = sosfiltfilt(d, x.float().to(cuda_device))
    assert _snr(got32, ref) >= _snr(sosfiltfilt(d, x.float()), ref) - 6.0


@pytest.mark.parametrize("ftype", ["iir", "fir"])
def test_decimate_on_the_card_matches_cpu(ftype, cuda_device):
    from simpledsp_tpu_torch.ops.fir import decimate
    x = _noise((4, 1 << 15), 2, "cpu")
    ref = decimate(x, 8, ftype=ftype)
    assert _rel_err(decimate(x.to(cuda_device), 8, ftype=ftype), ref) < 1e-9
    before = tols.ols_kernel.launches
    got32 = decimate(x.float().to(cuda_device), 8, ftype=ftype)
    if ftype == "fir":
        # 161 taps on 32768-sample rows: the overlap-save kernel, once.
        assert tols.ols_kernel.launches == before + 1
        assert _snr(got32, ref) >= 100.0
    else:
        cpu32 = decimate(x.float(), 8, ftype=ftype)
        assert _snr(got32, ref) >= _snr(cpu32, ref) - 6.0


@pytest.mark.parametrize("padtype", ["constant", "median"])
def test_resample_poly_and_upfirdn_on_the_card(padtype, cuda_device):
    from simpledsp_tpu_torch.ops.fir import resample, resample_poly, upfirdn
    x = _noise((4, 8192), 3, "cpu") + 1.0
    ref = resample_poly(x, 3, 2, padtype=padtype)
    assert _snr(resample_poly(x.float().to(cuda_device), 3, 2,
                              padtype=padtype), ref) >= 100.0
    h = lowpass_taps(31, 0.3)
    assert _snr(upfirdn(h, x.float().to(cuda_device), 3, 2),
                upfirdn(h, x, 3, 2)) >= 100.0
    assert _snr(resample(x.float().to(cuda_device), 4096),
                resample(x, 4096)) >= 100.0


def test_mel_spectrogram_on_the_card(cuda_device):
    from simpledsp_tpu_torch.models.audio import MelSpectrogram, mfcc
    x = _noise((4, 16384), 4, "cpu")
    ref = MelSpectrogram(512, 256, 64, log=False, dtype=torch.float64,
                         device="cpu")(x)
    mel = MelSpectrogram(512, 256, 64, log=False)
    assert mel.fbT.device.type == "cuda"
    assert _snr(mel(x.float().to(cuda_device)), ref) >= 100.0
    got = mfcc(x.to(cuda_device), dtype=torch.float64)
    assert _rel_err(got, mfcc(x, dtype=torch.float64)) < 1e-9


def test_modems_round_trip_on_the_card(cuda_device):
    from simpledsp_tpu_torch.models.comms import (Constellation, LinearModem,
                                                  OFDMModem, ber)
    g = torch.Generator(cuda_device).manual_seed(5)
    for span in (8, 16):
        modem = LinearModem(Constellation.qpsk(), sps=8, span=span, beta=0.35)
        bits = torch.randint(0, 2, (4, 2 * 4096), device=cuda_device,
                             generator=g)
        before = tols.ols_kernel.launches
        rx, _ = modem.demodulate(*modem.modulate(bits))
        # 129 taps (span 16) on 32768-sample rows: one launch a plane.
        assert tols.ols_kernel.launches == before + (2 if span == 16 else 0)
        assert float(ber(bits[:, : rx.shape[-1]], rx)) == 0.0
    ofdm = OFDMModem(Constellation.qpsk(), n_fft=64, cp=16)
    bits = torch.randint(0, 2, (4, 64 * ofdm.bits_per_symbol),
                         device=cuda_device, generator=g)
    rx, _ = ofdm.demodulate(*ofdm.modulate(bits))
    assert torch.equal(rx, bits)


# -- the utilities and the command-line front end on the card ---------------

def test_checkpoint_resumes_a_bank_on_the_card(cuda_device, tmp_path):
    """A kernel-route FM state saved from the card loads onto the card
    (the None leaf included) and continues the stream bit for bit."""
    from simpledsp_tpu_torch.utils.checkpoint import load_state, save_state
    from simpledsp_tpu_torch.utils.host import tree_leaves
    bank = tsdr.FMReceiverBank(16, 1.024e6)
    assert bank.use_kernel
    x = _noise((2, 2, 2, 65536), 15, cuda_device).float()
    _, st = bank((x[0, 0], x[0, 1]))
    save_state(tmp_path / "s.npz", st)
    back = load_state(tmp_path / "s.npz", bank.init_state(2))
    assert back.dc is None
    for a, b in zip(tree_leaves(st), tree_leaves(back), strict=True):
        assert b.device == a.device and torch.equal(a, b)
    a1, _ = bank((x[1, 0], x[1, 1]), st)
    a2, _ = bank((x[1, 0], x[1, 1]), back)
    assert torch.equal(a1, a2)


def test_host_fetch_and_checked_on_the_card(cuda_device):
    from simpledsp_tpu_torch.utils.debug import checked
    from simpledsp_tpu_torch.utils.host import to_numpy
    z = torch.randn(64, dtype=torch.complex64, device=cuda_device)
    np.testing.assert_array_equal(to_numpy({"z": z})["z"], z.cpu().numpy())
    f = checked(lambda v: (v, torch.log(v)))
    f(torch.ones(4, device=cuda_device))
    with pytest.raises(RuntimeError, match=r"output\[1\]"):
        f(-torch.ones(4, device=cuda_device))


def test_timing_helpers_wait_for_the_card(cuda_device):
    """A 4096^3 float32 product takes at least 2 ms at 67 TFLOP/s: timings
    that only saw the launch would be some microseconds."""
    from simpledsp_tpu_torch.utils.benchmark import (time_blocked,
                                                     time_streaming)
    x = torch.randn(4096, 4096, device=cuda_device)
    assert time_blocked(lambda a: a @ a, x, iters=3) > 1e-3
    assert time_streaming(lambda a, s: (a @ a, s + 1), x,
                          torch.zeros((), device=cuda_device), iters=3) > 1e-3


def test_cli_on_the_card_matches_the_cpu(cuda_device, tmp_path):
    """spectra and fm-rx with no --device (the card, one kernel launch a
    block) against the same files with --device cpu (the plain routes):
    the spectra >= 120 dB apart, the audio within twice the bank bar
    (each side within the bar of float64)."""
    from simpledsp_tpu_torch import cli
    x = np.random.default_rng(16).standard_normal(4 * 4096)
    x.astype(np.float32).tofile(tmp_path / "x.f32")
    n, fs = 4 * 16 * 4 * 16, 256e3      # 4 blocks at --block-frames 16
    t = np.arange(n) / fs
    # A carrier in each channel, AM and FM by tones of its own.
    z = sum((1 + 0.5 * np.sin(2 * np.pi * (300 + 50 * c) * t))
            * np.exp(1j * (2 * np.pi * (c * fs / 16 + 100) * t
                           + 2.0 * np.sin(2 * np.pi * (400 + 30 * c) * t)))
            for c in range(16))
    z *= 20000 / np.abs(z).max()
    np.stack([z.real, z.imag], -1).round().astype(np.int16).tofile(
        tmp_path / "x.iq16")
    runs = {"spectra": (["spectra", "--input", str(tmp_path / "x.f32"),
                         "--rate", "39000", "--block-frames", "1"],
                        tchain.chain_kernel, 4),
            "fm-rx": (["fm-rx", "--input", str(tmp_path / "x.iq16"),
                       "--rate", str(fs), "--block-frames", "16",
                       "--deviation", "3000"], tpfb.pfb_flat_kernel, 4)}
    for name, (argv, kernel, blocks) in runs.items():
        before = kernel.launches
        assert cli.main([*argv, "--output", str(tmp_path / "g.npz")]) == 0
        assert kernel.launches == before + blocks
        assert cli.main([*argv, "--output", str(tmp_path / "c.npz"),
                         "--device", "cpu"]) == 0
        gpu, cpu = np.load(tmp_path / "g.npz"), np.load(tmp_path / "c.npz")
        assert sorted(gpu.files) == sorted(cpu.files)
        if name == "spectra":
            ref = torch.complex(*(torch.as_tensor(cpu[k]).double()
                                  for k in ("spec_re", "spec_im")))
            got = torch.complex(*(torch.as_tensor(gpu[k]).double()
                                  for k in ("spec_re", "spec_im")))
            err = max(float(((got - ref).abs() ** 2).sum()), 1e-300)
            assert 10 * np.log10(float((ref.abs() ** 2).sum()) / err) >= 120
        else:
            scale = max(1.0, float(np.abs(cpu["audio"]).max()))
            assert np.abs(gpu["audio"] - cpu["audio"]).max() <= 3e-6 * scale


# -- the smoothing filters, splines, waveforms and peaks on the card ---------

_SMOOTH_1D = {
    "savgol interp": lambda v: _smooth().savgol_filter(v, 31, 3),
    "savgol mirror": lambda v: _smooth().savgol_filter(v, 11, 2,
                                                       mode="mirror"),
    "savgol wrap deriv": lambda v: _smooth().savgol_filter(
        v, 9, 3, deriv=1, mode="wrap"),
    "savgol constant": lambda v: _smooth().savgol_filter(
        v, 7, 2, mode="constant", cval=0.5),
    "savgol nearest": lambda v: _smooth().savgol_filter(v, 5, 2,
                                                        mode="nearest"),
    "wiener": lambda v: _smooth().wiener(v, 5),
    "detrend": lambda v: _smooth().detrend(v),
    "detrend constant": lambda v: _smooth().detrend(v, type="constant"),
}
_RANK = {
    "medfilt 3": lambda v: _smooth().medfilt(v, 3),
    "medfilt 9": lambda v: _smooth().medfilt(v, 9),
    "medfilt2d 5": lambda v: _smooth().medfilt2d(v[..., :64, :], 5),
    "order_filter cross": lambda v: _smooth().order_filter(
        v[..., :64, :], np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]]), 2),
}


def _smooth():
    from simpledsp_tpu_torch.ops import smooth
    return smooth


@pytest.mark.parametrize("name", sorted(_SMOOTH_1D))
def test_smoothing_on_the_card_matches_cpu(name, cuda_device):
    """In float64 within 1e-12 of the largest output of the same call on
    the CPU; in float32 >= 100 dB against it (the FIR bar)."""
    fn = _SMOOTH_1D[name]
    x = _noise((4, 8192), 25, "cpu").cumsum(-1) / 30
    ref = fn(x)
    assert _rel_err(fn(x.to(cuda_device)), ref) < 1e-12
    got32 = fn(x.float().to(cuda_device))
    assert got32.dtype == torch.float32 and got32.device.type == "cuda"
    assert _snr(got32, ref) >= 100.0


@pytest.mark.parametrize("name", sorted(_RANK))
def test_rank_filters_on_the_card_equal_cpu(name, cuda_device):
    """A rank filter selects: the card gives the CPU's bits."""
    fn = _RANK[name]
    x = _noise((4, 8192), 26, "cpu").reshape(4, 128, 64)
    if name.startswith("medfilt "):
        x = x.reshape(4, 8192)
    for dtype in (torch.float64, torch.float32):
        xd = x.to(dtype)
        assert torch.equal(fn(xd.to(cuda_device)).cpu(), fn(xd))


def test_sepfir2d_and_gauss_spline_on_the_card(cuda_device):
    from simpledsp_tpu_torch.ops.splines import gauss_spline, sepfir2d
    img = _noise((3, 96, 80), 27, "cpu")
    hr, hc = np.hanning(11)[1:-1], np.array([-1.0, 4.0, 10.0, 4.0, -1.0])
    hr, hc = hr / hr.sum(), hc / hc.sum()
    ref = sepfir2d(img, hr, hc)
    assert _rel_err(sepfir2d(img.to(cuda_device), hr, hc), ref) < 1e-12
    assert _snr(sepfir2d(img.float().to(cuda_device), hr, hc), ref) >= 100.0
    assert _rel_err(gauss_spline(img.to(cuda_device), 3),
                    gauss_spline(img, 3)) < 1e-12


def test_smoothing_launches_do_not_grow_with_the_window(cuda_device):
    """savgol 11 against 31 taps and medfilt 3 against 9: the same number
    of device launches a call (one library call, not one a tap)."""
    from torch.profiler import ProfilerActivity, profile
    x = _noise((8, 1 << 16), 28, cuda_device).float()
    counts = {}
    smooth = _smooth()
    calls = {"sg11": lambda: smooth.savgol_filter(x, 11, 2),
             "sg31": lambda: smooth.savgol_filter(x, 31, 3),
             "mf3": lambda: smooth.medfilt(x, 3),
             "mf9": lambda: smooth.medfilt(x, 9)}
    for name, call in calls.items():
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        counts[name] = sum(1 for e in prof.events()
                           if e.device_type == torch.autograd.DeviceType.CUDA)
    assert counts["sg31"] <= counts["sg11"] and counts["mf9"] <= counts["mf3"]
    assert 0 < counts["sg11"] < 11, counts


def test_waveforms_and_peaks_on_the_card(cuda_device):
    import scipy.signal as sig
    from simpledsp_tpu_torch.ops import peaks, waveforms
    seq, st = waveforms.max_len_seq(14)
    assert seq.device.type == "cuda"
    ref, rst = sig.max_len_seq(14)
    np.testing.assert_array_equal(seq.cpu().numpy(), ref)
    np.testing.assert_array_equal(st, rst)
    assert waveforms.unit_impulse(9, "mid").device.type == "cuda"
    t = torch.linspace(0, 1, 20001, dtype=torch.float64, device=cuda_device)
    y = waveforms.chirp(t, 3.0, 1.0, 40.0)
    assert y.device.type == "cuda"
    assert _rel_err(y, waveforms.chirp(t.cpu(), 3.0, 1.0, 40.0)) < 1e-12
    a, pa = peaks.find_peaks(y, prominence=0.5)
    b, pb = sig.find_peaks(y.cpu().numpy(), prominence=0.5)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(pa["prominences"], pb["prominences"])


@pytest.mark.parametrize("cmd", ["spectra", "fm-rx"])
def test_cli_sizes_without_a_kernel_on_the_card(cmd, cuda_device, tmp_path,
                                                capsys):
    """spectra --fft 32768 and fm-rx --channels 12, which the kernels do
    not take: the CLI says so in one stderr line and runs the plain route
    on the card, no chain or flat-PFB launch; the output against the same
    file with --device cpu: the spectra >= 120 dB apart, the audio within
    twice the bank bar, as test_cli_on_the_card_matches_the_cpu holds."""
    from simpledsp_tpu_torch import cli
    infile = tmp_path / "in.bin"
    if cmd == "spectra":
        np.random.default_rng(16).standard_normal(4 * 32768).astype(
            np.float32).tofile(infile)
        argv = ["spectra", "--input", str(infile), "--rate", "39000",
                "--fft", "32768", "--block-frames", "1"]
        kernel = tchain.chain_kernel
    else:
        fs, n = 12 * 16e3, 4 * 12 * 4 * 16
        t = np.arange(n) / fs
        z = sum((1 + 0.5 * np.sin(2 * np.pi * (300 + 50 * c) * t))
                * np.exp(1j * (2 * np.pi * (c * fs / 12 + 100) * t
                               + 2.0 * np.sin(2 * np.pi * (400 + 30 * c) * t)))
                for c in range(12))
        z *= 20000 / np.abs(z).max()
        np.stack([z.real, z.imag], -1).round().astype(np.int16).tofile(infile)
        argv = ["fm-rx", "--input", str(infile), "--rate", str(fs),
                "--channels", "12", "--block-frames", "16", "--deviation",
                "3000"]
        kernel = tpfb.pfb_flat_kernel
    before = kernel.launches
    assert cli.main([*argv, "--output", str(tmp_path / "g.npz")]) == 0
    err = capsys.readouterr().err
    assert kernel.launches == before
    assert len([ln for ln in err.splitlines()
                if "plain PyTorch route on cuda" in ln]) == 1
    assert cli.main([*argv, "--output", str(tmp_path / "c.npz"),
                     "--device", "cpu"]) == 0
    gpu, cpu = np.load(tmp_path / "g.npz"), np.load(tmp_path / "c.npz")
    assert sorted(gpu.files) == sorted(cpu.files)
    if cmd == "spectra":
        ref = cpu["spec_re"] + 1j * cpu["spec_im"]
        got = gpu["spec_re"] + 1j * gpu["spec_im"]
        err64 = max(float((np.abs(got - ref) ** 2).sum()), 1e-300)
        assert 10 * np.log10(float((np.abs(ref) ** 2).sum()) / err64) >= 120
    else:
        scale = max(1.0, float(np.abs(cpu["audio"]).max()))
        assert np.abs(gpu["audio"] - cpu["audio"]).max() <= 3e-6 * scale
