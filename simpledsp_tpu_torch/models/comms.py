"""Digital communications on torch tensors: linear and OFDM modems over an
AWGN channel.

Port of ``simpledsp_tpu/models/comms.py``: Gray-mapped PSK/QAM
constellations, root-raised-cosine pulse shaping through the polyphase
interpolator, a matched-filter receiver (``ops/conv.convolve``) with
symbol-instant sampling, cyclic-prefix OFDM over the FFT engine, and
hard-decision demapping with BER accounting.  Everything is batched over
leading axes and carried as (re, im) planes.

:class:`LinearModem` holds its interpolator's taps on ``device`` (``None``
means CUDA); :class:`Constellation` (host float64 points) and
:class:`OFDMModem` follow their input's device.  :func:`awgn` draws from
an int seed or a ``torch.Generator`` in place of the JAX key, so its noise
has the same statistics as the JAX package's but not its bits.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from simpledsp_tpu_torch.design.fir import rrc_taps
from simpledsp_tpu_torch.ops.fir import PolyphaseInterpolator

__all__ = ["Constellation", "LinearModem", "OFDMModem", "awgn", "ber"]


class Constellation:
    """Gray-mapped unit-average-energy constellation (host float64 table).

    ``points`` is the (2**bits_per_symbol, 2) RI table indexed by the
    Gray-coded integer whose bits are the transmitted bits (MSB first).
    Hard decision is a minimum-distance search, one (..., n_points)
    broadcast per plane.
    """

    def __init__(self, name: str, points: np.ndarray):
        self.name = name
        pts = np.asarray(points, dtype=np.float64)
        if pts.ndim != 2 or pts.shape[1] != 2:
            raise ValueError("points must be (n, 2) RI")
        n = pts.shape[0]
        k = int(np.log2(n))
        if 1 << k != n:
            raise ValueError(f"constellation size {n} not a power of two")
        # normalize to unit average symbol energy
        pts = pts / np.sqrt(np.mean(np.sum(pts * pts, axis=1)))
        self.points = pts
        self.bits_per_symbol = k

    # -- constructors ------------------------------------------------------

    @staticmethod
    def bpsk() -> "Constellation":
        return Constellation("bpsk", np.array([[1.0, 0.0], [-1.0, 0.0]]))

    @staticmethod
    def qpsk() -> "Constellation":
        # Gray: adjacent (in angle) symbols differ in one bit.
        pts = np.array([[1, 1], [-1, 1], [1, -1], [-1, -1]], np.float64)
        return Constellation("qpsk", pts)

    @staticmethod
    def qam(order: int) -> "Constellation":
        """Square QAM (16/64/256): independent Gray-coded PAM per axis,
        first half of the bits -> I, second half -> Q."""
        k = int(np.log2(order))
        if 1 << k != order or k % 2:
            raise ValueError(f"square QAM needs order 4**m, got {order}")
        m = k // 2
        pam = Constellation._gray_pam(m)            # (2**m,) levels
        pts = np.empty((order, 2))
        for idx in range(order):
            pts[idx] = (pam[idx >> m], pam[idx & ((1 << m) - 1)])
        return Constellation(f"qam{order}", pts)

    @staticmethod
    def _gray_pam(m: int) -> np.ndarray:
        """2**m PAM levels indexed by Gray-coded bits: level of index i is
        odd-spaced so that adjacent LEVELS differ in exactly one bit."""
        n = 1 << m
        levels = np.arange(-(n - 1), n, 2, dtype=np.float64)
        out = np.empty(n)
        for i in range(n):
            out[i] = levels[Constellation._gray_rank(i, m)]
        return out

    @staticmethod
    def _gray_rank(i: int, m: int) -> int:
        """Position of Gray code ``i`` on the PAM line (inverse Gray)."""
        r = 0
        g = i
        while g:
            r ^= g
            g >>= 1
        return r

    # -- mapping -----------------------------------------------------------

    def _shifts(self, device) -> torch.Tensor:
        k = self.bits_per_symbol
        return torch.arange(k - 1, -1, -1, device=device)

    def map_bits(self, bits: torch.Tensor, dtype=torch.float32
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(..., nsym * k) {0,1} bits -> symbol RI planes (..., nsym), on
        the bits' device."""
        k = self.bits_per_symbol
        if bits.shape[-1] % k:
            raise ValueError(f"bit count {bits.shape[-1]} not a multiple "
                             f"of bits/symbol {k}")
        b = bits.reshape(bits.shape[:-1] + (-1, k)).long()
        idx = (b << self._shifts(bits.device)).sum(-1)
        tab = torch.as_tensor(self.points, dtype=dtype, device=bits.device)
        return tab[:, 0][idx], tab[:, 1][idx]

    def demap_hard(self, yr: torch.Tensor, yi: torch.Tensor
                   ) -> torch.Tensor:
        """Minimum-distance hard decision: symbol RI planes (..., nsym) ->
        (..., nsym * k) bits."""
        tab = torch.as_tensor(self.points, dtype=yr.dtype, device=yr.device)
        d = ((yr[..., None] - tab[:, 0]) ** 2
             + (yi[..., None] - tab[:, 1]) ** 2)
        idx = d.argmin(-1)                            # (..., nsym)
        bits = (idx[..., None] >> self._shifts(yr.device)) & 1
        return bits.reshape(idx.shape[:-1] + (-1,))


class LinearModem(nn.Module):
    """Pulse-shaped linear modem: bits -> RRC-shaped baseband RI planes
    and back through the matched filter.

    TX: Gray map -> polyphase interpolate-by-``sps`` through the RRC (the
    zero-stuffed samples are never formed).  RX: matched RRC filter ->
    symbol-instant sampling (the TX + RX cascade is a raised cosine whose
    peak lands ``span * sps`` samples in, an integer number of symbols,
    so timing is a static slice) -> hard decision.  The interpolator's
    taps live on ``device`` (``None`` means CUDA).
    """

    def __init__(self, constellation: Constellation, *, sps: int = 8,
                 span: int = 8, beta: float = 0.35, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.constellation = constellation
        self.sps = int(sps)
        self.span = int(span)
        self.beta = float(beta)
        self.dtype = dtype
        h = rrc_taps(self.sps, self.span, self.beta)
        # Unit-energy taps give the matched cascade unity symbol gain;
        # scale TX by sqrt(sps) so the shaped waveform carries the
        # constellation's unit average energy per symbol.
        self._shape = PolyphaseInterpolator(h * np.sqrt(self.sps), self.sps,
                                           dtype=dtype, device=device)
        self._h_rx = h
        self.delay_symbols = self.span        # TX+RX group delay

    def modulate(self, bits: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(..., nbits) {0,1} -> baseband RI planes (..., nsym * sps)."""
        sr, si = self.constellation.map_bits(bits, dtype=self.dtype)
        xr, _ = self._shape(sr)
        xi, _ = self._shape(si)
        return xr, xi

    def demodulate(self, xr: torch.Tensor, xi: torch.Tensor
                   ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """Baseband RI planes -> (bits, (symbol RI planes)).

        The matched filter is the same RRC run at the full rate; symbol
        sampling slices every ``sps``-th output starting at the cascade
        delay.  Trailing partial symbols (the filter tail) are dropped:
        with TX from :meth:`modulate`, exactly ``nsym - span`` full symbols
        survive, to be compared with the first ``nsym - span`` sent.
        """
        from simpledsp_tpu_torch.ops.conv import convolve

        h = np.asarray(self._h_rx, dtype=np.float64) / np.sqrt(self.sps)
        yr = convolve(xr, h, mode="full")
        yi = convolve(xi, h, mode="full")
        d = self.span * self.sps              # integer cascade delay
        sr = yr[..., d::self.sps]
        si = yi[..., d::self.sps]
        nsym = xr.shape[-1] // self.sps - self.span
        sr, si = sr[..., :nsym], si[..., :nsym]
        return self.constellation.demap_hard(sr, si), (sr, si)


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=np.float64).ravel()


class OFDMModem:
    """Cyclic-prefix OFDM over the port's batched FFT engine.

    TX: Gray-map bits onto all ``n_fft`` subcarriers per OFDM symbol,
    inverse FFT (RI planes), prepend the ``cp``-sample cyclic prefix,
    serialize.  RX: frame, drop the prefix, forward FFT, one-tap
    zero-forcing equalization against a known channel, hard decision.

    The channel argument of :meth:`demodulate` is the impulse response
    (RI pair or None for ideal); equalization divides by its ``n_fft``
    DFT, exact when the channel is shorter than the prefix.
    """

    def __init__(self, constellation: Constellation, *, n_fft: int = 64,
                 cp: int = 16, dtype=torch.float32):
        if cp < 0 or cp >= n_fft:
            raise ValueError(f"need 0 <= cp < n_fft, got {cp}/{n_fft}")
        self.constellation = constellation
        self.n_fft = int(n_fft)
        self.cp = int(cp)
        self.dtype = dtype

    @property
    def bits_per_symbol(self) -> int:
        return self.constellation.bits_per_symbol * self.n_fft

    def modulate(self, bits: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(..., nsym * n_fft * k) bits -> serialized baseband RI planes
        (..., nsym * (n_fft + cp))."""
        from simpledsp_tpu_torch.ops.fft import ifft_ri

        k = self.bits_per_symbol
        if bits.shape[-1] % k:
            raise ValueError(f"bit count {bits.shape[-1]} not a multiple "
                             f"of bits/OFDM-symbol {k}")
        sr, si = self.constellation.map_bits(bits, dtype=self.dtype)
        sr = sr.reshape(sr.shape[:-1] + (-1, self.n_fft))
        si = si.reshape(si.shape[:-1] + (-1, self.n_fft))
        tr, ti = ifft_ri(sr, si)
        scale = float(np.sqrt(self.n_fft))
        tr = tr * scale     # unit average time-domain power
        ti = ti * scale
        if self.cp:
            tr = torch.cat([tr[..., -self.cp:], tr], dim=-1)
            ti = torch.cat([ti[..., -self.cp:], ti], dim=-1)
        return (tr.reshape(tr.shape[:-2] + (-1,)),
                ti.reshape(ti.shape[:-2] + (-1,)))

    def demodulate(self, xr: torch.Tensor, xi: torch.Tensor,
                   channel: Optional[Tuple] = None
                   ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """Serialized RI planes -> (bits, equalized subcarrier planes).
        ``channel``: impulse-response RI pair (length <= cp + 1) for
        one-tap zero-forcing equalization, or None for an ideal channel.
        The serialized length must be a multiple of n_fft + cp; with a
        multipath tail, pass the TX length (tail samples beyond it are
        never framed)."""
        from simpledsp_tpu_torch.ops.fft import fft_ri

        blk = self.n_fft + self.cp
        nsym = xr.shape[-1] // blk
        if nsym < 1:
            raise ValueError("input shorter than one OFDM symbol")
        xr = xr[..., : nsym * blk].reshape(xr.shape[:-1] + (nsym, blk))
        xi = xi[..., : nsym * blk].reshape(xi.shape[:-1] + (nsym, blk))
        fr, fi = fft_ri(xr[..., self.cp:], xi[..., self.cp:])
        inv_scale = float(1.0 / np.sqrt(self.n_fft))
        fr = fr * inv_scale
        fi = fi * inv_scale
        if channel is not None:
            hr = np.zeros(self.n_fft)
            hi = np.zeros(self.n_fft)
            cr, ci = (_host(c) for c in channel)
            if max(cr.size, ci.size) > self.cp + 1:
                raise ValueError(
                    f"channel ({max(cr.size, ci.size)} taps) longer than "
                    f"the cyclic prefix + 1 ({self.cp + 1}) — the "
                    "circular-convolution assumption breaks")
            hr[: cr.size] = cr
            hi[: ci.size] = ci
            hf = np.fft.fft(hr + 1j * hi)
            # zero-forcing: divide by H per subcarrier (host constants)
            den = np.maximum(np.abs(hf) ** 2, 1e-30)
            er = torch.as_tensor(hf.real / den, dtype=fr.dtype,
                                 device=fr.device)
            ei = torch.as_tensor(-hf.imag / den, dtype=fr.dtype,
                                 device=fr.device)
            fr, fi = fr * er - fi * ei, fr * ei + fi * er
        flat_r = fr.reshape(fr.shape[:-2] + (-1,))
        flat_i = fi.reshape(fi.shape[:-2] + (-1,))
        return self.constellation.demap_hard(flat_r, flat_i), (flat_r,
                                                               flat_i)


def awgn(key: Union[int, torch.Generator],
         planes: Tuple[torch.Tensor, torch.Tensor], snr_db: float,
         *, signal_power: Optional[float] = None
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Add complex white Gaussian noise at the given SNR (dB) to RI
    planes.  ``key`` is an int seed or a ``torch.Generator`` on the
    planes' device (the JAX package takes a PRNG key).
    ``signal_power`` (per complex sample) defaults to the measured mean
    power of the input; the noise variance is split evenly across the two
    planes."""
    xr, xi = planes
    if signal_power is None:
        p = torch.mean(xr * xr + xi * xi)
    else:
        p = torch.as_tensor(signal_power, dtype=xr.dtype, device=xr.device)
    nvar = p * (10.0 ** (-snr_db / 10.0))
    if isinstance(key, torch.Generator):
        gen = key
    else:
        gen = torch.Generator(device=xr.device).manual_seed(int(key))
    sigma = torch.sqrt(nvar / 2.0).to(xr.dtype)
    nr = torch.randn(xr.shape, generator=gen, dtype=xr.dtype,
                     device=xr.device)
    ni = torch.randn(xi.shape, generator=gen, dtype=xi.dtype,
                     device=xi.device)
    return xr + sigma * nr, xi + sigma * ni


def ber(tx_bits: torch.Tensor, rx_bits: torch.Tensor) -> torch.Tensor:
    """Bit-error rate between aligned {0,1} tensors (mean over all axes)."""
    if tx_bits.shape != rx_bits.shape:
        raise ValueError(f"shape mismatch {tuple(tx_bits.shape)} vs "
                         f"{tuple(rx_bits.shape)}")
    return torch.mean((tx_bits != rx_bits).to(torch.float32))
