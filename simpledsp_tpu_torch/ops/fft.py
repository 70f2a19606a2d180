"""Batched FFT/IFFT on (re, im) float planes: the four-step matmul form.

Port of ``simpledsp_tpu/ops/fft.py``.  N = N1 * N2, x viewed as (N1, N2):

    1. DFT_N1 along axis -2            (dense matmul)
    2. twiddle by exp(-+ 2 pi i k1 n2 / N)   (elementwise)
    3. DFT_N2 along axis -1            (recursive)
    4. transpose (k1, k2) -> (k2, k1) and flatten

applied recursively until a factor is <= _MAX_DFT, which is dense
products of one fixed shape against a float64-built table, so that the bits
of a row do not depend on how many rows are transformed with it (streaming
callers rely on that).  Complex values are carried as
explicit (re, im) planes, so every product is a real matmul, and the
public boundary matches the JAX package's.  ``torch.fft`` is not used.

On a CUDA tensor, a float32 transform of n = 128 m, 2 <= m <= 128, runs
the frames FFT kernel (``kernels/fft._fft_frames``, ``csrc/fft.cu``)
instead: :func:`_use_fused_kernel` is the JAX package's gate with "the
tensor is on CUDA" for "the backend is a TPU", and the port routes every
transform it admits to the kernel.  The JAX package keeps its own switch,
off there (on the v5e the fused kernel lost to XLA's one batched einsum;
on the card the alternative is the plain four-step above).  Larger sizes
recurse with the inner transform on the kernel; float64 and CPU tensors
never take it.  Sizes with a prime factor above 128 run Bluestein's chirp-z
(``ops/transforms.czt_ri``).

The complex-dtype wrappers (:func:`fft`, :func:`ifft`, :func:`rfft`,
:func:`irfft`, :func:`fft2`, :func:`ifft2`) take and return complex torch
tensors at the boundary; inside, the planes stay the working form.  The
2-D transforms run the engine per axis with one transpose between.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from simpledsp_tpu_torch.precision import ieee_fp32
from simpledsp_tpu_torch.utils import tracing
from simpledsp_tpu_torch.utils.intmath import is_power_of as _is_power_of

__all__ = ["fft_ri", "ifft_ri", "rfft_ri", "irfft_ri", "pack_rfft_ri",
           "unpack_rfft_ri", "fft_radix2", "fft_radix4", "dft_matrix",
           "fft", "ifft", "rfft", "irfft", "fft2_ri", "ifft2_ri", "rfft2_ri",
           "irfft2_ri", "fft2", "ifft2"]

# Largest size computed as one dense DFT matmul.
_MAX_DFT = 128


@functools.lru_cache(maxsize=None)
def _dft_mats_f64(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """(cos, -sin) parts of the forward DFT matrix W[k, j] = e^{-2 pi i kj/n}.

    The phase index k*j is reduced mod n in exact integer arithmetic before
    scaling by 2 pi / n, so the trig argument never exceeds one turn.
    """
    k = np.arange(n, dtype=np.int64)
    red = np.outer(k, k) % n
    ang = (-2.0 * np.pi / n) * red
    return np.cos(ang), np.sin(ang)


def dft_matrix(n: int, inverse: bool = False, dtype=np.float64):
    """Dense DFT matrix as an (re, im) pair of real matrices (host-side)."""
    cr, si = _dft_mats_f64(n)
    if inverse:
        return cr.astype(dtype), (-si).astype(dtype)
    return cr.astype(dtype), si.astype(dtype)


@functools.lru_cache(maxsize=None)
def _twiddle_f64(n1: int, n2: int) -> Tuple[np.ndarray, np.ndarray]:
    """Step-2 twiddles T[k1, n2] = e^{-2 pi i k1 n2 / (n1 n2)}, with the
    phase index reduced mod n1*n2 exactly (see _dft_mats_f64)."""
    n = n1 * n2
    red = np.outer(np.arange(n1, dtype=np.int64),
                   np.arange(n2, dtype=np.int64)) % n
    ang = (-2.0 * np.pi / n) * red
    return np.cos(ang), np.sin(ang)


def _split(n: int) -> Tuple[int, int]:
    """Factor n = n1 * n2 with n1 <= _MAX_DFT and factors as square as
    possible."""
    d = min(int(np.sqrt(n)), _MAX_DFT)
    while d > 1:
        if n % d == 0 and d <= _MAX_DFT:
            return d, n // d
        d -= 1
    raise ValueError(f"cannot factor N={n} into radices <= {_MAX_DFT}")


# Largest host table _table caches on a CUDA device by value: hashing the
# bytes costs more than the copy beyond this size.
_CACHE_BYTES = 1 << 18


def _table(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """Host table ``a`` in ``like``'s dtype on its device.  On a CUDA device
    a table of up to 256 KB is cached by value (a copy from pageable host
    memory waits for the stream); callers only read the tables.  Larger
    tables that a caller reuses go through :func:`_cached_table`."""
    a = np.ascontiguousarray(a)
    if like.device.type != "cuda" or a.nbytes > _CACHE_BYTES:
        return torch.as_tensor(a, dtype=like.dtype, device=like.device)
    return _device_table(a.tobytes(), a.shape, a.dtype.str, like.dtype,
                         like.device)


@functools.lru_cache(maxsize=256)
def _device_table(buf: bytes, shape, np_dtype: str, dtype: torch.dtype,
                  device: torch.device) -> torch.Tensor:
    host = np.frombuffer(buf, dtype=np_dtype).reshape(shape).copy()
    return torch.as_tensor(host, dtype=dtype, device=device)


@functools.lru_cache(maxsize=64)
def _cached_table(build, key: tuple, dtype: torch.dtype,
                  device: torch.device):
    """The host tables ``build(*key)`` (a tuple of arrays) in ``dtype`` on
    ``device``, made once per (key, dtype, device): for large tables,
    which :func:`_table` does not cache."""
    return tuple(torch.as_tensor(np.ascontiguousarray(h), dtype=dtype,
                                 device=device) for h in build(*key))


# Values (rows x n) of each product in the small-DFT route (_dft_last).
# BLAS picks its kernel and threading by a product's shape (MKL on the CPU,
# cuBLAS on the card), and with them the order in which a row's sums are
# taken: one product over all rows gave a row other bits alone than inside a
# batch, and so did one batched product over a varying number of blocks.
# So every product of an n-point DFT has the same number of rows, the last
# one zero-padded, and a row's bits do not depend on how many rows come with
# it.  Fewer on the CPU, where padding and each product's thread start-up
# cost host time; more on the card, where each product is a launch.
_DFT_VALUES_CPU = 1 << 15
_DFT_VALUES_DEVICE = 1 << 20


def _dft_rows(n: int, device: torch.device) -> int:
    """Rows of each product of the n-point small DFT on ``device``."""
    values = _DFT_VALUES_CPU if device.type == "cpu" else _DFT_VALUES_DEVICE
    return max(128, values // n)


@functools.lru_cache(maxsize=None)
def _dft_table_f64(n: int, inverse: bool) -> np.ndarray:
    """The real table [W_re^T | W_im^T], W the n-point DFT matrix, with a
    zero row after an odd n, as (2, h, 2n), h = ceil(n / 2): the two
    halves of the sum's n terms."""
    wr, wi = dft_matrix(n, inverse=inverse)
    h = -(-n // 2)
    table = np.zeros((2 * h, 2 * n))
    table[:n] = np.concatenate([wr.T, wi.T], axis=1)
    return table.reshape(2, h, 2 * n)


def _dft_last(xr: torch.Tensor, xi: torch.Tensor, inverse: bool
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unscaled DFT along the last axis (n <= _MAX_DFT) as dense products
    of a fixed shape.  Each block of :func:`_dft_rows` rows of xr, and of
    xi, times the table of :func:`_dft_table_f64` gives
    P = xr [Wr^T | Wi^T] and Q = xi [Wr^T | Wi^T], each as its two
    half sums (one batched product a plane); then
    Re = xr Wr^T - xi Wi^T and Im = xi Wr^T + xr Wi^T, as in the JAX
    package: in float32 one 2n-term sum over [xr | xi] costs about 2.7
    dB, and an n-term sum taken whole (MKL's order) 1.5-1.9 dB at n = 16
    and 32 against XLA's CPU dot.  Returns contiguous planes.  The
    counter ``fft.dft_products`` counts the products launched."""
    n = xr.shape[-1]
    lead = xr.shape[:-1]
    rows = int(np.prod(lead, dtype=np.int64))
    block = _dft_rows(n, xr.device)
    padded = -(-rows // block) * block
    h = -(-n // 2)
    v = xr.new_zeros((2, padded, 2 * h))
    v[0, :rows, :n] = xr.reshape(rows, n)
    v[1, :rows, :n] = xi.reshape(rows, n)
    table = _table(_dft_table_f64(n, bool(inverse)), xr)
    p = xr.new_empty((2, padded // block, 2, block, 2 * n))
    tracing.count("fft.dft_products", 2 * (padded // block))
    for b, lo in enumerate(range(0, padded, block)):
        for plane in range(2):
            halves = v[plane, lo: lo + block].view(block, 2, h)
            torch.bmm(halves.transpose(0, 1), table, out=p[plane, b])
    s = (p[:, :, 0] + p[:, :, 1]).reshape(2, padded, 2 * n)[:, :rows]
    yr = s[0, :, :n] - s[1, :, n:]
    yi = s[1, :, :n] + s[0, :, n:]
    return yr.reshape(lead + (n,)), yi.reshape(lead + (n,))


def _use_fused_kernel(n: int, x: torch.Tensor) -> bool:
    """Route this transform of ``x`` through the frames FFT kernel
    (``kernels/fft.py``)?

    Requires a CUDA tensor, float32 and the JAX package's size gate
    n = 128 m, 2 <= m <= 128 (n <= _MAX_DFT is already one dense matmul)."""
    if x.dtype != torch.float32:
        return False
    if n % 128 or not 2 <= n // 128 <= 128:
        return False
    return x.device.type == "cuda"


def _fft_ri(xr: torch.Tensor, xi: torch.Tensor, inverse: bool):
    """Recursive four-step FFT over the LAST axis on (re, im) planes.

    No scaling is applied here (done once at the top level for inverse).
    """
    n = xr.shape[-1]

    if _use_fused_kernel(n, xr):
        # Every caller built on this engine: rfft/irfft packing, dct,
        # hilbert, Bluestein's convolutions, istft, the 2-D transforms.
        from simpledsp_tpu_torch.kernels.fft import _fft_frames
        lead = xr.shape[:-1]
        yr, yi = _fft_frames(xr.reshape(-1, n), xi.reshape(-1, n),
                             inverse=inverse, scale=False)
        return yr.reshape(lead + (n,)), yi.reshape(lead + (n,))

    if n <= _MAX_DFT:
        return _dft_last(xr, xi, inverse)

    try:
        n1, n2 = _split(n)
    except ValueError:
        # Sizes with a prime factor above _MAX_DFT: Bluestein's chirp-z over
        # a power-of-two convolution, unscaled either way like this function.
        from simpledsp_tpu_torch.ops.transforms import czt_ri
        sgn = 1.0 if inverse else -1.0
        return czt_ri(xr, xi, n, w=np.exp(sgn * 2j * np.pi / n),
                      _exact_denom=n)
    # x viewed as (n1, n2), transposed so that t1 is the last axis.
    xr = xr.reshape(xr.shape[:-1] + (n1, n2)).transpose(-1, -2)
    xi = xi.reshape(xi.shape[:-1] + (n1, n2)).transpose(-1, -2)

    # Step 1: DFT_n1 over t1 (n1 <= _MAX_DFT by construction): (..., t2, k1).
    xr, xi = _dft_last(xr, xi, inverse)

    # Step 2: twiddle T[k1, t2], read as (t2, k1) (conjugated for inverse).
    tr64, ti64 = _twiddle_f64(n1, n2)
    tr = _table(tr64.T, xr)
    ti = _table(ti64.T if not inverse else -ti64.T, xr)
    xr, xi = xr * tr - xi * ti, xr * ti + xi * tr

    # Step 3: DFT_n2 over t2 — recurse (n2 may still be big): (..., k1, k2).
    xr, xi = _fft_ri(xr.transpose(-1, -2), xi.transpose(-1, -2), inverse)

    # Step 4: output index k = k1 + n1 k2 -> transpose to (k2, k1), flatten.
    xr = xr.transpose(-1, -2).reshape(xr.shape[:-2] + (n,))
    xi = xi.transpose(-1, -2).reshape(xi.shape[:-2] + (n,))
    return xr, xi


def _as_ri(x: torch.Tensor, dtype: torch.dtype
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(re, im) planes of ``x`` in the real ``dtype``; zeros for real x."""
    if x.is_complex():
        return x.real.to(dtype), x.imag.to(dtype)
    return x.to(dtype), torch.zeros_like(x, dtype=dtype)


def _pick_real_dtype(x: torch.Tensor, dtype=None) -> torch.dtype:
    """The real working dtype: ``dtype`` if given, float64 for float64 or
    complex128 input, float32 otherwise."""
    if dtype is not None:
        return dtype
    if x.dtype in (torch.complex128, torch.float64):
        return torch.float64
    return torch.float32


def fft_ri(xr: torch.Tensor, xi: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward FFT (unscaled) over the last axis on (re, im) planes."""
    with ieee_fp32():
        return _fft_ri(xr, xi, inverse=False)


def ifft_ri(xr: torch.Tensor, xi: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse FFT on (re, im) planes: conjugate twiddles + 1/N scaling."""
    with ieee_fp32():
        yr, yi = _fft_ri(xr, xi, inverse=True)
    scale = 1.0 / xr.shape[-1]
    return yr * scale, yi * scale


def fft_radix2(x: torch.Tensor, *, inverse: bool = False,
               dtype=None) -> torch.Tensor:
    """The reference's radix-2 entry: requires a power-of-2 size.  Takes
    and returns a complex tensor, as :func:`fft` / :func:`ifft` do; the
    result is the mathematical DFT."""
    if not _is_power_of(x.shape[-1], 2):
        raise ValueError(f"fft_radix2 requires power-of-2 size, got {x.shape[-1]}")
    return ifft(x, dtype=dtype) if inverse else fft(x, dtype=dtype)


def fft_radix4(x: torch.Tensor, *, inverse: bool = False,
               dtype=None) -> torch.Tensor:
    """The reference's radix-4 entry: requires a power-of-4 size."""
    if not _is_power_of(x.shape[-1], 4):
        raise ValueError(f"fft_radix4 requires power-of-4 size, got {x.shape[-1]}")
    return ifft(x, dtype=dtype) if inverse else fft(x, dtype=dtype)


@functools.lru_cache(maxsize=None)
def _half_twiddle_f64(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """(cos, -sin) of W[k] = e^{-2 pi i k / n} for k = 0..n//2 inclusive —
    the Hermitian post-twiddle of the real-input split step."""
    k = np.arange(n // 2 + 1, dtype=np.int64)
    ang = (-2.0 * np.pi / n) * k
    return np.cos(ang), np.sin(ang)


def rfft_ri(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Half-spectrum real-input FFT: (..., N) real -> (re, im) planes of the
    N//2+1 non-negative bins.

    Even N packs the N real samples as N/2 complex (even samples real,
    odd samples imaginary), runs one N/2-point FFT, and recovers the half
    spectrum with the Hermitian post-twiddle

        X[k] = E[k] - i W^k O[k],   W = e^{-2 pi i / N},
        E = (Z[k] + conj(Z[N/2-k]))/2,  O = (Z[k] - conj(Z[N/2-k]))/2.

    Odd N falls back to the full transform + slice.
    """
    n = x.shape[-1]
    nb = n // 2 + 1
    if n % 2 or n < 4:
        yr, yi = fft_ri(x, torch.zeros_like(x))
        return yr[..., :nb], yi[..., :nb]
    zr, zi = fft_ri(x[..., 0::2], x[..., 1::2])
    # Extend with Z[N/2] := Z[0] so k and N/2-k index one array of nb bins.
    zr = torch.cat([zr, zr[..., :1]], dim=-1)
    zi = torch.cat([zi, zi[..., :1]], dim=-1)
    rr, ri_ = zr.flip(-1), zi.flip(-1)            # Z[N/2-k]
    er, ei = 0.5 * (zr + rr), 0.5 * (zi - ri_)    # even part E
    orr, oi = 0.5 * (zr - rr), 0.5 * (zi + ri_)   # odd part O
    wc, ws = _half_twiddle_f64(n)
    wr = _table(wc, x)
    wi = _table(ws, x)
    # X = E - i (wr + i wi) O
    yr = er + (wr * oi + wi * orr)
    yi = ei - (wr * orr - wi * oi)
    return yr, yi


def irfft_ri(xr: torch.Tensor, xi: torch.Tensor,
             n: Optional[int] = None) -> torch.Tensor:
    """Inverse of :func:`rfft_ri`: (re, im) planes of N//2+1 bins -> the
    length-n real signal.  Even n inverts the half-size packing; other
    lengths rebuild the full Hermitian spectrum and take the real part of
    a full inverse."""
    nb = xr.shape[-1]
    if n is None:
        n = 2 * (nb - 1)
    if n % 2 or n != 2 * (nb - 1) or n < 4:
        tail_r = xr[..., 1: n - nb + 1].flip(-1)
        tail_i = -xi[..., 1: n - nb + 1].flip(-1)
        fr = torch.cat([xr, tail_r], dim=-1)
        fi = torch.cat([xi, tail_i], dim=-1)
        yr, _ = ifft_ri(fr, fi)
        return yr
    ar, ai = xr[..., :-1], xi[..., :-1]            # X[k], k = 0..N/2-1
    br = xr[..., 1:].flip(-1)                      # X[N/2-k]
    bi = xi[..., 1:].flip(-1)
    er, ei = 0.5 * (ar + br), 0.5 * (ai - bi)
    orr, oi = 0.5 * (ar - br), 0.5 * (ai + bi)
    wc, ws = _half_twiddle_f64(n)
    wr = _table(wc[:-1], xr)
    wp = _table(-ws[:-1], xr)                      # +sin: W^{+k}
    # Z = E + i (wr + i wp) O
    zr = er - (wr * oi + wp * orr)
    zi = ei + (wr * orr - wp * oi)
    zr, zi = ifft_ri(zr, zi)
    return torch.stack([zr, zi], dim=-1).reshape(zr.shape[:-1] + (n,))


def pack_rfft_ri(yr: torch.Tensor, yi: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pack a one-sided spectrum ((..., N/2+1) planes, even N) into the
    N/2-bin form the chain emits: DC..bin N/2-1 in both planes, with
    X[N/2].re (real for real input) in the imag plane's bin-0 slot."""
    pr = yr[..., :-1]
    pi = torch.cat([yr[..., -1:], yi[..., 1:-1]], dim=-1)
    return pr, pi


def unpack_rfft_ri(pr: torch.Tensor, pi: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of :func:`pack_rfft_ri`: (..., N/2) packed planes ->
    (..., N/2+1) one-sided (re, im) planes."""
    zero = torch.zeros_like(pi[..., :1])
    yr = torch.cat([pr, pi[..., :1]], dim=-1)
    yi = torch.cat([zero, pi[..., 1:], zero], dim=-1)
    return yr, yi


def fft(x: torch.Tensor, *, dtype=None) -> torch.Tensor:
    """Forward complex FFT (unscaled) over the last axis, batched over
    leading axes; complex64, or complex128 when computing in float64."""
    yr, yi = fft_ri(*_as_ri(x, _pick_real_dtype(x, dtype)))
    return torch.complex(yr, yi)


def ifft(x: torch.Tensor, *, dtype=None) -> torch.Tensor:
    """Inverse complex FFT over the last axis, with the 1/N scaling."""
    yr, yi = ifft_ri(*_as_ri(x, _pick_real_dtype(x, dtype)))
    return torch.complex(yr, yi)


def rfft(x: torch.Tensor, *, dtype=None) -> torch.Tensor:
    """The N//2+1 non-negative-frequency bins of a real signal
    (numpy.fft.rfft semantics), through :func:`rfft_ri`."""
    yr, yi = rfft_ri(x.to(_pick_real_dtype(x, dtype)))
    return torch.complex(yr, yi)


def irfft(x: torch.Tensor, n: Optional[int] = None, *,
          dtype=None) -> torch.Tensor:
    """Inverse of :func:`rfft`: the length-n real signal from the half
    spectrum."""
    rdt = _pick_real_dtype(x, dtype)
    xr, xi = _as_ri(x, rdt)
    return irfft_ri(xr, xi, n)


def fft2_ri(xr: torch.Tensor, xi: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """2-D FFT over the last two axes on (re, im) planes (numpy.fft.fft2
    semantics)."""
    yr, yi = fft_ri(xr, xi)
    yr, yi = fft_ri(yr.transpose(-1, -2), yi.transpose(-1, -2))
    return yr.transpose(-1, -2), yi.transpose(-1, -2)


def ifft2_ri(xr: torch.Tensor, xi: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse 2-D FFT over the last two axes on (re, im) planes."""
    yr, yi = ifft_ri(xr, xi)
    yr, yi = ifft_ri(yr.transpose(-1, -2), yi.transpose(-1, -2))
    return yr.transpose(-1, -2), yi.transpose(-1, -2)


def rfft2_ri(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """2-D FFT of a real array over the last two axes, half spectrum on
    the last axis (numpy.fft.rfft2 layout, (..., H, W//2+1) bins)."""
    yr, yi = rfft_ri(x)
    yr, yi = fft_ri(yr.transpose(-1, -2), yi.transpose(-1, -2))
    return yr.transpose(-1, -2), yi.transpose(-1, -2)


def irfft2_ri(xr: torch.Tensor, xi: torch.Tensor,
              w: Optional[int] = None) -> torch.Tensor:
    """Inverse of :func:`rfft2_ri`: the real (..., H, w) array from the
    (..., H, W//2+1) half-spectrum planes; ``w`` defaults to 2 (bins - 1)."""
    yr, yi = ifft_ri(xr.transpose(-1, -2), xi.transpose(-1, -2))
    return irfft_ri(yr.transpose(-1, -2), yi.transpose(-1, -2), w)


def fft2(x: torch.Tensor, *, dtype=None) -> torch.Tensor:
    """Complex-dtype wrapper over :func:`fft2_ri`."""
    yr, yi = fft2_ri(*_as_ri(x, _pick_real_dtype(x, dtype)))
    return torch.complex(yr, yi)


def ifft2(x: torch.Tensor, *, dtype=None) -> torch.Tensor:
    """Complex-dtype wrapper over :func:`ifft2_ri`."""
    yr, yi = ifft2_ri(*_as_ri(x, _pick_real_dtype(x, dtype)))
    return torch.complex(yr, yi)
