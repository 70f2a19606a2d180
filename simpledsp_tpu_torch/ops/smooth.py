"""Smoothing and robust local filtering: Savitzky-Golay, median, rank
order, Wiener, detrend (scipy.signal parity, batched over leading axes).

Port of ``simpledsp_tpu/ops/smooth.py``.  The weights come from host
float64 linear algebra (the same NumPy code); the device work is a fixed
number of library calls whatever the window, never one call a tap:

* ``savgol_filter``: one ``F.conv1d`` over the rows, the edge padding one
  gather; the 'interp' edges two small matmuls (the edge polyfit is a
  linear map, precomputed);
* ``medfilt`` / ``medfilt2d`` / ``order_filter``: a strided window view
  of the zero-padded input (``unfold``), then one sort over the window
  axis and the rank's element, in chunks of rows of 2^22 samples (so
  that no tensor of a chunk reaches the 2 GiB where a kernel would be
  split over several launches);
* ``wiener``: the two box sums as ``avg_pool2d`` calls that divide by 1;
* ``detrend``: two small matmuls.

Convolutions and matmuls run in IEEE float32 (``precision.ieee_fp32``).
The device tables (filter weights, edge maps, gather indices) are cached
per device, so a call uploads nothing once they exist.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from simpledsp_tpu_torch.precision import ieee_fp32

__all__ = ["savgol_coeffs", "savgol_filter", "medfilt", "medfilt2d",
           "order_filter", "wiener", "detrend"]


@functools.lru_cache(maxsize=None)
def _savgol_coeffs_f64(window_length: int, polyorder: int, deriv: int,
                       delta: float) -> np.ndarray:
    """Least-squares local-polynomial FIR weights (scipy.signal
    savgol_coeffs with use='conv': reversed for convolution)."""
    if polyorder >= window_length:
        raise ValueError("polyorder must be less than window_length")
    if deriv > polyorder:
        return np.zeros(window_length)
    pos = (window_length - 1) / 2.0
    x = np.arange(-pos, window_length - pos, dtype=np.float64)[::-1]
    order = np.arange(polyorder + 1, dtype=np.float64)[:, None]
    A = x[None, :] ** order
    y = np.zeros(polyorder + 1)
    y[deriv] = math.factorial(deriv) / (float(delta) ** deriv)
    coeffs, *_ = np.linalg.lstsq(A, y, rcond=None)
    return coeffs


def savgol_coeffs(window_length: int, polyorder: int, *, deriv: int = 0,
                  delta: float = 1.0) -> np.ndarray:
    """Savitzky-Golay FIR weights in convolution order (scipy.signal
    savgol_coeffs(use='conv')), host float64."""
    return _savgol_coeffs_f64(int(window_length), int(polyorder),
                              int(deriv), float(delta))


@functools.lru_cache(maxsize=None)
def _savgol_edge_maps_f64(window_length: int, polyorder: int, deriv: int,
                          delta: float) -> Tuple[np.ndarray, np.ndarray]:
    """(E_left, E_right): linear maps from the first/last window_length
    samples to the first/last halflen 'interp'-mode outputs — the matrix
    form of scipy's per-call edge polyfit."""
    wl, po = window_length, polyorder
    half = wl // 2
    t = np.arange(wl, dtype=np.float64)
    v_fit = t[:, None] ** np.arange(po + 1)[None, :]          # (wl, po+1)
    pinv = np.linalg.pinv(v_fit)                              # (po+1, wl)
    # Differentiation matrix on the monomial basis.
    dmat = np.eye(po + 1)
    for _ in range(deriv):
        shift = np.zeros((po + 1, po + 1))
        for k in range(1, po + 1):
            shift[k - 1, k] = k
        dmat = shift @ dmat
    def eval_at(points):
        return (points[:, None] ** np.arange(po + 1)[None, :]) @ dmat @ pinv
    scale = float(delta) ** deriv
    e_left = eval_at(np.arange(half, dtype=np.float64)) / scale
    e_right = eval_at(np.arange(wl - half, wl, dtype=np.float64)) / scale
    return e_left, e_right


@functools.lru_cache(maxsize=64)
def _savgol_tables(wl: int, po: int, deriv: int, delta: float,
                   dtype: torch.dtype, device: torch.device):
    """The conv1d weight (1, 1, wl) — the coefficients reversed, conv1d
    being a correlation — and the two edge maps transposed, (wl, half),
    on ``device``."""
    c = _savgol_coeffs_f64(wl, po, deriv, delta)
    e_left, e_right = _savgol_edge_maps_f64(wl, po, deriv, delta)
    kw = dict(dtype=dtype, device=device)
    return (torch.as_tensor(c[::-1].copy(), **kw).reshape(1, 1, wl),
            torch.as_tensor(e_left.T.copy(), **kw),
            torch.as_tensor(e_right.T.copy(), **kw))


@functools.lru_cache(maxsize=64)
def _pad_index(n: int, half: int, mode: str,
               device: torch.device) -> torch.Tensor:
    """Source indices of an axis of n extended by ``half`` on both sides
    by numpy.pad's rule for ``mode`` ('reflect', 'edge' or 'wrap'), for
    any ``half``: the periodic extensions numpy's repeated padding
    builds."""
    i = np.arange(-half, n + half)
    if mode == "edge":
        i = np.clip(i, 0, n - 1)
    elif mode == "wrap":
        i = i % n
    elif n == 1:                       # reflect of one sample repeats it
        i = np.zeros_like(i)
    else:                              # reflect: period 2 (n - 1)
        i = i % (2 * (n - 1))
        i = np.where(i < n, i, 2 * (n - 1) - i)
    return torch.as_tensor(i, device=device)


def savgol_filter(x: torch.Tensor, window_length: int, polyorder: int, *,
                  deriv: int = 0, delta: float = 1.0,
                  mode: str = "interp", cval: float = 0.0) -> torch.Tensor:
    """Savitzky-Golay smoothing / differentiation over the last axis
    (scipy.signal.savgol_filter semantics; odd window_length).

    mode 'interp' (default) replaces each edge half-window with an exact
    polynomial fit of the outermost window — applied here as one small
    precomputed matmul per edge.  'mirror'/'constant'/'nearest'/'wrap'
    pad then convolve.
    """
    wl = int(window_length)
    if wl % 2 != 1 or wl < 1:
        raise ValueError(f"window_length must be odd and >= 1, got {wl}")
    po, deriv, delta = int(polyorder), int(deriv), float(delta)
    _savgol_coeffs_f64(wl, po, deriv, delta)   # raises for a bad polyorder
    half = wl // 2
    t = x.shape[-1]
    if mode == "interp":
        if wl > t:
            raise ValueError("mode 'interp' needs window_length <= the "
                             f"signal length ({wl} > {t})")
        xp = x
    elif mode == "constant":
        xp = F.pad(x, (half, half), value=float(cval))
    elif mode in ("mirror", "nearest", "wrap"):
        rule = {"mirror": "reflect", "nearest": "edge", "wrap": "wrap"}[mode]
        xp = x.index_select(-1, _pad_index(t, half, rule, x.device))
    else:
        raise ValueError(f"unknown mode {mode!r}")
    weight, e_left_t, e_right_t = _savgol_tables(wl, po, deriv, delta,
                                                 x.dtype, x.device)
    # The VALID correlation of every row with the taps: one conv1d over
    # the rows as (B, 1, L).
    with ieee_fp32():
        y = F.conv1d(xp.reshape(-1, 1, xp.shape[-1]), weight)
    y = y.reshape(*xp.shape[:-1], y.shape[-1])
    if mode != "interp":
        return y
    with ieee_fp32():
        yl = x[..., :wl] @ e_left_t
        yr = x[..., -wl:] @ e_right_t
    # Interior valid outputs are exactly indices [half, t-half).
    return torch.cat([yl, y, yr], dim=-1)


def _windows_1d(x: torch.Tensor, k: int) -> torch.Tensor:
    """(..., T, k) strided view of the windows of x zero-padded by k // 2
    on both sides."""
    return F.pad(x, (k // 2, k // 2)).unfold(-1, k, 1)


def _windows_2d(x: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
    """(..., H, W, kh * kw) windows of x zero-padded by (kh // 2, kw // 2)
    on both sides of its last two axes, row-major within a window."""
    xp = F.pad(x, (kw // 2, kw // 2, kh // 2, kh // 2))
    win = xp.unfold(-2, kh, 1).unfold(-2, kw, 1)      # (..., H, W, kh, kw)
    return win.reshape(*win.shape[:-2], kh * kw)


# Output samples one sort takes: the windows of a chunk of rows, values and
# int64 sort indices, then stay under 2 GiB for windows of up to 32
# samples, so that each kernel indexes in 32 bits and is launched once (a
# larger tensor is split over several launches).  The launches a call then
# depend on the input's size, not on the window.
_RANK_CHUNK = 1 << 22


@functools.lru_cache(maxsize=64)
def _neighbours(sel: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    return torch.as_tensor(sel, device=device)


def _rank_filter(x: torch.Tensor, window: Tuple[int, ...],
                 sel: Optional[Tuple[int, ...]], rank: int) -> torch.Tensor:
    """The ``rank``-th smallest (0-based) of the neighbours ``sel`` (flat
    row-major indices into the window; None: all of it) of each sample,
    over a zero-padded ``window`` (k,) or (kh, kw) on the trailing axes of
    ``x``: one sort of the windows of each chunk of rows, as the JAX
    package's ``jnp.sort(...)[..., rank]``.  On the card a sort of short
    rows beats ``torch.median`` and ``torch.kthvalue``, which take a block
    a row."""
    nd = len(window)
    planes = x.reshape(-1, *x.shape[x.ndim - nd:])
    out = torch.empty_like(planes)
    per = max(1, _RANK_CHUNK // max(1, math.prod(planes.shape[1:])))
    for i in range(0, planes.shape[0], per):
        win = (_windows_1d(planes[i:i + per], *window) if nd == 1
               else _windows_2d(planes[i:i + per], *window))
        if sel is not None:
            win = win.index_select(-1, _neighbours(sel, x.device))
        out[i:i + per] = torch.sort(win, dim=-1).values[..., rank]
    return out.reshape(x.shape)


def order_filter(x: torch.Tensor, domain, rank: int) -> torch.Tensor:
    """Rank-order filter (scipy.signal.order_filter semantics): at each
    position, gather the neighbors where ``domain`` is nonzero, sort,
    and keep the ``rank``-th (0-based) — median/erosion/dilation as
    special cases.  ``domain`` is a 1-D or 2-D odd-sized mask applied
    over the trailing axes (leading axes batch; with matching ndim this
    is exactly scipy).  Zero-padded edges.  A window view, a gather of
    the selected neighbors where the domain has holes, one sort of them
    (:func:`_rank_filter`).

    Known upstream deviation: scipy 1.17's order_filter delegates to
    ndimage.rank_filter, which IGNORES zeros inside the footprint
    (footprint [1,0,1,1,1] gives output identical to the full size-5
    window).  This implementation honors the documented semantics — the
    rank is taken over the domain-selected neighbors only — so results
    differ from scipy 1.17 exactly when the domain has interior holes,
    as in the JAX package."""
    dom = np.asarray(domain.detach().cpu() if torch.is_tensor(domain)
                     else domain)
    if dom.ndim not in (1, 2):
        raise ValueError("domain must be 1-D or 2-D")
    if any(s % 2 == 0 for s in dom.shape):
        raise ValueError(f"domain sides must be odd, got {dom.shape}")
    sel = np.flatnonzero(dom != 0)                # row-major, as argwhere
    nsel = sel.size
    if not 0 <= rank < nsel:
        raise ValueError(f"rank {rank} out of range for {nsel} active "
                         "domain elements")
    return _rank_filter(x, dom.shape, None if nsel == dom.size
                        else tuple(sel.tolist()), int(rank))


def medfilt(x: torch.Tensor, kernel_size: int = 3) -> torch.Tensor:
    """Sliding-window median over the last axis, zero-padded edges
    (scipy.signal.medfilt semantics; odd kernel_size)."""
    k = int(kernel_size)
    if k % 2 != 1 or k < 1:
        raise ValueError(f"kernel_size must be odd and >= 1, got {k}")
    if k == 1:
        return x
    # An odd count: the median is the middle element, as jnp.median's.
    return _rank_filter(x, (k,), None, k // 2)


def medfilt2d(x: torch.Tensor, kernel_size: Union[int, Tuple[int, int]] = 3
              ) -> torch.Tensor:
    """2-D sliding median over the last two axes, zero-padded edges
    (scipy.signal.medfilt2d semantics; odd kernel dims)."""
    if isinstance(kernel_size, int):
        kh = kw = int(kernel_size)
    else:
        kh, kw = (int(v) for v in kernel_size)
    if kh % 2 != 1 or kw % 2 != 1 or kh < 1 or kw < 1:
        raise ValueError(f"kernel dims must be odd, got ({kh}, {kw})")
    return _rank_filter(x, (kh, kw), None, kh * kw // 2)


def wiener(x: torch.Tensor, mysize: Union[int, Tuple[int, ...], None] = None,
           noise: Optional[float] = None) -> torch.Tensor:
    """Adaptive Wiener filter (scipy.signal.wiener semantics) over the
    last one (1-D input) or two (2-D input) axes; local moments via box
    convolutions, noise power estimated as the mean local variance when
    not given."""
    nd = min(x.ndim, 2)
    if mysize is None:
        sizes = (3,) * nd
    elif isinstance(mysize, int):
        sizes = (mysize,) * nd
    else:
        sizes = tuple(int(v) for v in mysize)
        if len(sizes) != nd:
            raise ValueError(f"mysize {sizes} must have {nd} entries")
    count = float(np.prod(sizes))

    window = (1,) * (2 - nd) + sizes

    def box(img):
        """Sum over each window, the window's centre at k // 2 of k (zero
        padding (k // 2, k - 1 - k // 2)): one ``avg_pool2d`` that divides
        by 1, its sum taken in the window's order, as the JAX loop's."""
        pad = []
        for k in reversed(sizes):
            pad += [k // 2, k - 1 - k // 2]
        ip = F.pad(img, pad)
        lead = img.shape[:img.ndim - nd]
        planes = ip.reshape(-1, 1, *(1,) * (2 - nd),
                            *ip.shape[img.ndim - nd:])
        acc = F.avg_pool2d(planes, window, stride=1, divisor_override=1)
        return acc.reshape(*lead, *acc.shape[4 - nd:])

    l_mean = box(x) / count
    l_var = box(x * x) / count - l_mean * l_mean
    if noise is None:
        noise_p = torch.mean(l_var, dim=tuple(range(x.ndim - nd, x.ndim)),
                             keepdim=True)
    else:
        noise_p = torch.as_tensor(noise, dtype=x.dtype, device=x.device)
    out = l_mean + (x - l_mean) * (1.0 - noise_p / l_var)
    return torch.where(l_var < noise_p, l_mean, out)


@functools.lru_cache(maxsize=16)
def _detrend_tables(n: int, dtype: torch.dtype, device: torch.device):
    """(pinv^T (n, 2), basis^T (2, n)) of the [1, t] least-squares fit."""
    t = np.arange(n, dtype=np.float64)
    basis = np.stack([np.ones(n), t], axis=1)
    pinv = np.linalg.pinv(basis)
    kw = dict(dtype=dtype, device=device)
    return (torch.as_tensor(pinv.T.copy(), **kw),
            torch.as_tensor(basis.T.copy(), **kw))


def detrend(x: torch.Tensor, *, type: str = "linear") -> torch.Tensor:
    """Remove the least-squares line ('linear') or the mean ('constant')
    over the last axis (scipy.signal.detrend semantics, batched)."""
    if type in ("constant", "c"):
        return x - torch.mean(x, dim=-1, keepdim=True)
    if type in ("linear", "l"):
        pinv_t, basis_t = _detrend_tables(x.shape[-1], x.dtype, x.device)
        with ieee_fp32():
            return x - (x @ pinv_t) @ basis_t
    raise ValueError(f"unknown detrend type {type!r}")
