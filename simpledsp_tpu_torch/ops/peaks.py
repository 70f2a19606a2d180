"""Peak detection and measurement (scipy.signal parity, host-side).

Port of ``simpledsp_tpu/ops/peaks.py``, the same NumPy code: find_peaks /
peak_prominences / peak_widths are post-hoc ANALYSIS of a signal already
computed — irregular, data-dependent control flow that belongs on the
host, not in a kernel (the device-side analog in this package is the radar
CA-CFAR detector, models/radar.py).  A signal given as a tensor, on any
device, is fetched to the host first; results are NumPy arrays with the
JAX package's bits.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from simpledsp_tpu_torch.utils.host import to_numpy

__all__ = ["find_peaks", "find_peaks_cwt", "ricker", "peak_prominences",
           "peak_widths", "argrelmax", "argrelmin", "argrelextrema"]


def _local_maxima(x: np.ndarray):
    """Strict local maxima with plateau handling: returns (midpoints,
    left_edges, right_edges) — scipy's `_local_maxima_1d`."""
    mids, les, res = [], [], []
    i, n = 1, x.size - 1
    while i < n:
        if x[i - 1] < x[i]:
            ahead = i + 1
            while ahead < n and x[ahead] == x[i]:
                ahead += 1
            if x[ahead] < x[i]:
                les.append(i)
                res.append(ahead - 1)
                mids.append((i + ahead - 1) // 2)
                i = ahead
        i += 1
    return (np.asarray(mids, dtype=np.intp),
            np.asarray(les, dtype=np.intp),
            np.asarray(res, dtype=np.intp))


def _interval(arg, x: np.ndarray, peaks: np.ndarray, name: str):
    """(min, max) arrays from a scalar / 2-sequence / array spec —
    scipy's `_unpack_condition_args` semantics: ONLY a plain Python
    tuple/list of length 2 is an interval; array conditions must have
    the SIGNAL's length and are sampled at the current peak positions."""
    if isinstance(arg, (tuple, list)) and len(arg) == 2:
        lo, hi = arg
    else:
        lo, hi = arg, None

    def full(v):
        if v is None:
            return None
        v = np.asarray(to_numpy(v), dtype=np.float64)
        if v.ndim == 0:
            return np.full(peaks.size, float(v))
        if v.size != x.size:
            raise ValueError(f"array {name} must have the same length as "
                             "the signal x")
        return v[peaks]
    return full(lo), full(hi)


def _select_by_distance(peaks: np.ndarray, priority: np.ndarray,
                        distance: float) -> np.ndarray:
    """Greedy highest-priority-first suppression (scipy's
    `_select_by_peak_distance`)."""
    keep = np.ones(peaks.size, dtype=bool)
    order = np.argsort(priority)[::-1]
    for j in order:
        if not keep[j]:
            continue
        k = j - 1
        while k >= 0 and peaks[j] - peaks[k] < distance:
            keep[k] = False
            k -= 1
        k = j + 1
        while k < peaks.size and peaks[k] - peaks[j] < distance:
            keep[k] = False
            k += 1
    return keep


def peak_prominences(x, peaks, wlen: Optional[int] = None
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Prominence of each peak (scipy.signal.peak_prominences semantics):
    height above the higher of the two lowest contour lines reachable
    without crossing a higher peak; returns (prominences, left_bases,
    right_bases)."""
    x = np.asarray(to_numpy(x), dtype=np.float64)
    peaks = np.asarray(to_numpy(peaks), dtype=np.intp)
    if np.any((peaks < 0) | (peaks >= x.size)):
        raise ValueError("peak index out of range")
    n = x.size
    proms = np.empty(peaks.size)
    lb = np.empty(peaks.size, dtype=np.intp)
    rb = np.empty(peaks.size, dtype=np.intp)
    if wlen is not None and wlen <= 1:
        raise ValueError(f"wlen must be > 1, got {wlen}")
    half = None if wlen is None else int(np.ceil(wlen)) // 2
    for j, p in enumerate(peaks):
        lo = 0 if half is None else max(0, p - half)
        hi = n - 1 if half is None else min(n - 1, p + half)
        i = p
        left_min = x[p]
        lb[j] = p
        while i > lo and x[i] <= x[p]:
            i -= 1
            if x[i] < left_min:
                left_min = x[i]
                lb[j] = i
        i = p
        right_min = x[p]
        rb[j] = p
        while i < hi and x[i] <= x[p]:
            i += 1
            if x[i] < right_min:
                right_min = x[i]
                rb[j] = i
        proms[j] = x[p] - max(left_min, right_min)
    return proms, lb, rb


def peak_widths(x, peaks, rel_height: float = 0.5,
                prominence_data=None, wlen: Optional[int] = None
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Width of each peak at ``rel_height`` of its prominence
    (scipy.signal.peak_widths semantics): returns (widths, width_heights,
    left_ips, right_ips) with linearly interpolated crossings."""
    x = np.asarray(to_numpy(x), dtype=np.float64)
    peaks = np.asarray(to_numpy(peaks), dtype=np.intp)
    if rel_height < 0:
        raise ValueError("rel_height must be >= 0")
    if prominence_data is None:
        prominence_data = peak_prominences(x, peaks, wlen)
    proms, lb, rb = to_numpy(prominence_data)
    widths = np.empty(peaks.size)
    wh = np.empty(peaks.size)
    lips = np.empty(peaks.size)
    rips = np.empty(peaks.size)
    for j, p in enumerate(peaks):
        h = x[p] - proms[j] * rel_height
        wh[j] = h
        i = p
        while i > lb[j] and x[i] > h:
            i -= 1
        lips[j] = float(i)
        if x[i] < h:      # strict: h == x[i] interpolates to i exactly
            lips[j] = i + (h - x[i]) / (x[i + 1] - x[i])
        i = p
        while i < rb[j] and x[i] > h:
            i += 1
        rips[j] = float(i)
        if x[i] < h:
            rips[j] = i - (h - x[i]) / (x[i - 1] - x[i])
        widths[j] = rips[j] - lips[j]
    return widths, wh, lips, rips


def find_peaks(x, height=None, threshold=None, distance=None,
               prominence=None, width=None, wlen=None,
               rel_height: float = 0.5, plateau_size=None
               ) -> Tuple[np.ndarray, dict]:
    """Local maxima subject to the scipy.signal.find_peaks conditions,
    applied in scipy's order (plateau_size, height, threshold, distance,
    prominence, width); returns (indices, properties)."""
    x = np.asarray(to_numpy(x), dtype=np.float64)
    if x.ndim != 1:
        raise ValueError("find_peaks expects a 1-D signal")
    if distance is not None and distance < 1:
        raise ValueError("distance must be >= 1")
    peaks, le, re_ = _local_maxima(x)
    props: dict = {}

    def keep_mask(m):
        nonlocal peaks, le, re_
        peaks, le, re_ = peaks[m], le[m], re_[m]
        for k in props:
            props[k] = props[k][m]

    if plateau_size is not None:
        sizes = re_ - le + 1
        lo, hi = _interval(plateau_size, x, peaks, "plateau_size")
        m = sizes >= lo
        if hi is not None:
            m &= sizes <= hi
        props["plateau_sizes"] = sizes
        props["left_edges"] = le
        props["right_edges"] = re_
        keep_mask(m)
    if height is not None:
        h = x[peaks]
        lo, hi = _interval(height, x, peaks, "height")
        m = h >= lo
        if hi is not None:
            m &= h <= hi
        props["peak_heights"] = h
        keep_mask(m)
    if threshold is not None:
        tl = x[peaks] - x[peaks - 1]
        tr = x[peaks] - x[peaks + 1]
        lo, hi = _interval(threshold, x, peaks, "threshold")
        m = np.ones(peaks.size, dtype=bool)
        if lo is not None:
            m &= np.minimum(tl, tr) >= lo
        if hi is not None:
            m &= np.maximum(tl, tr) <= hi
        props["left_thresholds"] = tl
        props["right_thresholds"] = tr
        keep_mask(m)
    if distance is not None:
        keep_mask(_select_by_distance(peaks, x[peaks], distance))
    if prominence is not None or width is not None:
        proms, lb, rb = peak_prominences(x, peaks, wlen)
        props["prominences"] = proms
        props["left_bases"] = lb
        props["right_bases"] = rb
    if prominence is not None:
        lo, hi = _interval(prominence, x, peaks, "prominence")
        m = props["prominences"] >= lo
        if hi is not None:
            m &= props["prominences"] <= hi
        keep_mask(m)
    if width is not None:
        w, wh, lips, rips = peak_widths(
            x, peaks, rel_height,
            (props["prominences"], props["left_bases"],
             props["right_bases"]))
        props["widths"] = w
        props["width_heights"] = wh
        props["left_ips"] = lips
        props["right_ips"] = rips
        lo, hi = _interval(width, x, peaks, "width")
        m = w >= lo
        if hi is not None:
            m &= w <= hi
        keep_mask(m)
    return peaks, props


def argrelextrema(x, comparator, order: int = 1, mode: str = "clip"
                  ) -> Tuple[np.ndarray, ...]:
    """Relative extrema over the last axis
    (scipy.signal.argrelextrema semantics): points strictly satisfying
    ``comparator`` against every neighbor within ``order`` on both
    sides."""
    x = np.asarray(to_numpy(x))
    if order < 1:
        raise ValueError("order must be >= 1")
    n = x.shape[-1]
    idx = np.arange(n)
    m = np.ones(x.shape, dtype=bool)
    for shift in range(1, order + 1):
        if mode == "clip":
            plus = np.clip(idx + shift, 0, n - 1)
            minus = np.clip(idx - shift, 0, n - 1)
        elif mode == "wrap":
            plus = (idx + shift) % n
            minus = (idx - shift) % n
        else:
            raise ValueError(f"unknown mode {mode!r}")
        m &= comparator(x, x[..., plus])
        m &= comparator(x, x[..., minus])
    return np.nonzero(m)


def ricker(points, a) -> np.ndarray:
    """Ricker ("Mexican hat") wavelet — the default `find_peaks_cwt`
    kernel, A (1 - x^2/a^2) exp(-x^2/2a^2) with the unit-energy
    normalization (the public scipy.signal.ricker was removed in 1.15;
    kept here because the CWT peak finder needs it)."""
    amp = 2.0 / (np.sqrt(3.0 * a) * np.pi ** 0.25)
    x = np.arange(0, points) - (points - 1.0) / 2.0
    xsq = x * x
    return amp * (1.0 - xsq / a ** 2) * np.exp(-xsq / (2.0 * a ** 2))


def _cwt_rows(data: np.ndarray, wavelet, widths) -> np.ndarray:
    """Row per width: data convolved ('same') with the reversed
    conjugated wavelet of support min(10*width, len(data)); complex
    wavelets promote the matrix to complex128 (scipy's dtype probe)."""
    cplx = np.iscomplexobj(np.asarray(wavelet(1, widths[0])))
    out = np.empty((len(widths), len(data)),
                   dtype=np.complex128 if cplx else np.float64)
    for i, w in enumerate(widths):
        n = np.min([10 * w, len(data)])
        wv = np.conj(np.asarray(wavelet(n, w))[::-1])
        out[i] = np.convolve(data, wv, mode="same")
    return out


def _ridge_lines(mat: np.ndarray, max_distances, gap_thresh):
    """Connect per-row relative maxima into ridge lines, widest row
    down (Du et al. 2006, the construction scipy's CWT peak finder
    uses): a maximum joins the line whose newest column (as of the
    START of its row — a snapshot, so several maxima may join the same
    line) is nearest within max_distances[row]; lines idle for more
    than gap_thresh rows are closed."""
    n_rows, n_cols = mat.shape
    if len(max_distances) < n_rows:
        raise ValueError("max_distances must have at least as many rows "
                         "as the CWT matrix")
    idx = np.arange(n_cols)
    is_max = np.ones(mat.shape, dtype=bool)
    for s in (1, ):
        is_max &= np.greater(mat, mat[:, np.clip(idx + s, 0, n_cols - 1)])
        is_max &= np.greater(mat, mat[:, np.clip(idx - s, 0, n_cols - 1)])
    rows_with = np.nonzero(is_max.any(axis=1))[0]
    if rows_with.size == 0:
        return []
    start = rows_with[-1]
    active = [[[start], [c], 0] for c in np.nonzero(is_max[start])[0]]
    closed = []
    for row in range(start - 1, -1, -1):
        for line in active:
            line[2] += 1
        prev_cols = np.array([line[1][-1] for line in active])
        for col in np.nonzero(is_max[row])[0]:
            line = None
            if prev_cols.size:
                diffs = np.abs(col - prev_cols)
                nearest = int(np.argmin(diffs))
                if diffs[nearest] <= max_distances[row]:
                    line = active[nearest]
            if line is not None:
                line[0].append(row)
                line[1].append(col)
                line[2] = 0
            else:
                active.append([[row], [col], 0])
        for i in range(len(active) - 1, -1, -1):
            if active[i][2] > gap_thresh:
                closed.append(active[i])
                del active[i]
    out = []
    for line in closed + active:
        # scipy's inverse-permutation scatter (NOT a plain pair sort —
        # they differ when one line gained two maxima in one row);
        # replicated for index-exact parity.
        order = np.argsort(np.asarray(line[0]))
        rows = np.zeros_like(order)
        cols = np.zeros_like(order)
        rows[order] = line[0]
        cols[order] = line[1]
        out.append((rows, cols))
    return out


def find_peaks_cwt(vector, widths, wavelet=None, max_distances=None,
                   gap_thresh=None, min_length=None, min_snr: float = 1,
                   noise_perc: float = 10,
                   window_size: Optional[int] = None) -> np.ndarray:
    """Wavelet-ridge peak finding (scipy.signal.find_peaks_cwt
    semantics): CWT across ``widths``, ridge-line linking widest-scale
    down, then length + SNR filtering against a windowed noise floor at
    the finest scale.  Host-side f64 analysis, like the rest of the
    peak family."""
    vector = np.asarray(to_numpy(vector))
    widths = np.atleast_1d(np.asarray(to_numpy(widths)))
    if gap_thresh is None:
        gap_thresh = np.ceil(widths[0])
    if max_distances is None:
        max_distances = widths / 4.0
    if wavelet is None:
        wavelet = ricker
    mat = _cwt_rows(vector, wavelet, widths)
    lines = _ridge_lines(mat, max_distances, gap_thresh)
    # Filter: minimum ridge length and SNR vs the noise_perc-percentile
    # of |finest-scale| values in a window around the peak.
    n = mat.shape[1]
    if min_length is None:
        min_length = np.ceil(mat.shape[0] / 4)
    if window_size is None:
        window_size = np.ceil(n / 20)
    hw, odd = divmod(int(window_size), 2)
    row0 = mat[0]

    def score(a):
        # Fraction-interpolated percentile on the SORTED values — equals
        # np.percentile(linear) for real data but, unlike np.percentile,
        # also defined for the complex-wavelet case (lexicographic sort,
        # scipy's scoreatpercentile behavior).
        s = np.sort(a)
        pos = noise_perc / 100.0 * (s.size - 1)
        lo = int(pos)
        frac = pos - lo
        if frac == 0:
            return s[lo]
        return s[lo] * (1.0 - frac) + s[lo + 1] * frac

    noises = np.array([
        score(row0[max(i - hw, 0): min(i + hw + odd, n)])
        for i in range(n)])
    locs = []
    for rows, cols in lines:
        if len(rows) < min_length:
            continue
        snr = abs(mat[rows[0], cols[0]] / noises[cols[0]])
        if snr < min_snr:
            continue
        locs.append(cols[0])
    return np.sort(np.asarray(locs))


def argrelmax(x, order: int = 1, mode: str = "clip"):
    """Relative maxima (scipy.signal.argrelmax semantics)."""
    return argrelextrema(x, np.greater, order, mode)


def argrelmin(x, order: int = 1, mode: str = "clip"):
    """Relative minima (scipy.signal.argrelmin semantics)."""
    return argrelextrema(x, np.less, order, mode)
