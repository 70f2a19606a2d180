"""simpledsp_tpu_torch — the PyTorch / CUDA port of ``simpledsp_tpu``.

Mirrors the JAX package's layout, one module per counterpart:

  design/    host-side float64 coefficient design (NumPy)
  ops/       functional torch ops: fft (1-D and 2-D, RI planes and complex
             wrappers), iir, fir (polyphase and overlap-save), demod,
             channelizer, conv (convolve / correlate / fftconvolve /
             oaconvolve), conv2d (convolve2d / correlate2d), transforms
             (chirp-z / Bluestein, zoom FFT, DCT, Hilbert, Goertzel),
             spectral (stft / istft, spectrograms, Welch, CSD, coherence,
             periodogram, Lomb-Scargle, envelope), lfilter, smooth
             (Savitzky-Golay, median, rank order, Wiener, detrend), splines,
             peaks and waveforms
  kernels/   hand-written CUDA kernels for Hopper (csrc/) with their plain
             PyTorch versions, plus the host tables they read: the chain,
             the PFB, overlap-save convolution, direct 2-D convolution and
             the batched frames FFT under the FFT engine
  models/    the north-star chain, the SDR receiver banks, the pulse-Doppler
             radar, audio features and the modems
  device.py  the default device of the objects that hold tables: CUDA
             unless the caller passes ``device="cpu"``

It imports torch, NumPy and SciPy, never JAX.  The names below are the JAX
package's top-level names; each resolves on first access by importing its
own submodule only (``_lazy.py``), so importing the package, or one
submodule, stays cheap.
"""

from simpledsp_tpu_torch import _lazy

__version__ = "0.1.0"

_lazy.install(globals(), {
    "design.biquad": (
        "BiquadCascadeDesign", "FilterType", "bp_cutoff_freqs",
        "design_bandpass", "design_bandstop", "design_cheby1_lowpass",
        "design_cheby2_lowpass", "design_highpass", "design_lowpass",
        "ba_coefficients", "freq_response", "group_delay", "sos_matrix"),
    "design.fir": (
        "bandpass_taps", "bandstop_taps", "firwin2", "highpass_taps",
        "lowpass_taps", "pfb_prototype_taps", "resampler_taps", "firwin",
        "firwin_2d", "kaiser_beta", "rrc_taps"),
    "design.iir": (
        "band_stop_obj", "bessel", "besselap", "bilinear_zpk", "lp2bp_zpk",
        "lp2bs_zpk", "lp2hp_zpk", "lp2lp_zpk", "buttap", "cheb1ap",
        "cheb2ap", "ellipap", "butter", "buttord", "cheb1ord", "cheb2ord",
        "cheby1", "cheby2", "ellip", "ellipord", "gammatone", "iircomb",
        "iirdesign", "iirfilter", "iirnotch", "iirpeak", "zpk2sos"),
    "design.ltisys": (
        "BadCoefficients", "abcd_normalize", "bilinear", "bode",
        "cont2discrete", "dbode", "dfreqresp", "dimpulse", "dlsim", "dstep",
        "findfreqs", "freqresp", "freqz_sos", "impulse", "lp2bp", "lp2bs",
        "lp2hp", "lp2lp", "lsim", "normalize", "sos2tf", "sos2zpk",
        "sosfreqz", "ss2tf", "ss2zpk", "step", "tf2sos", "tf2ss", "tf2zpk",
        "zpk2ss", "zpk2tf"),
    "design.optimal_fir": ("firls", "minimum_phase", "remez"),
    "design.residues": (
        "invres", "invresz", "residue", "residuez", "unique_roots"),
    "design.windows": ("get_window", "kaiser_atten", "kaiserord"),
    "design.placement": ("place_poles",),
    "design.systems": (
        "StateSpace", "TransferFunction", "ZerosPolesGain", "dlti", "lti"),
    "ops.fft": (
        "fft", "fft_radix2", "fft_radix4", "fft_ri", "fft2", "fft2_ri",
        "ifft", "ifft_ri", "ifft2", "ifft2_ri", "irfft2_ri", "rfft2_ri"),
    "ops.iir": (
        "BlockIIR", "CascadeCoeffs", "IIRState", "coeffs_from_design",
        "iir_init", "iir_preload", "sosfilt", "sosfilt_scan", "sosfilt_zi",
        "sosfiltfilt"),
    "ops.fir": (
        "FIRFilter", "FIRState", "OverlapSaveFIR", "PolyphaseDecimator",
        "PolyphaseInterpolator", "PolyphaseResampler", "decimate",
        "fir_filter", "resample", "resample_poly", "upfirdn"),
    "ops.channelizer": ("PFBChannelizer",),
    "ops.conv": (
        "choose_conv_method", "convolve", "correlate", "correlation_lags",
        "deconvolve", "fftconvolve", "oaconvolve"),
    "ops.conv2d": ("convolve2d", "correlate2d"),
    "ops.lfilter": (
        "BlockLFilter", "filtfilt", "freqs", "freqs_zpk", "freqz",
        "freqz_zpk", "lfilter", "lfilter_scan", "lfilter_zi", "lfiltic"),
    "ops.spectral": (
        "check_COLA", "check_NOLA", "closest_STFT_dual_window", "coherence",
        "envelope", "envelope_ri", "csd_ri", "istft_ri", "lombscargle",
        "periodogram", "spectrogram_ri", "stft_dual_window", "stft_ri",
        "vectorstrength", "welch_psd"),
    "ops.transforms": (
        "CZT", "ZoomFFT", "analytic_ri", "czt", "czt_points", "czt_ri",
        "dct", "goertzel", "goertzel_ri", "hilbert", "hilbert2",
        "hilbert2_ri", "idct", "zoom_fft", "zoom_fft_ri"),
    "ops.peaks": (
        "argrelextrema", "argrelmax", "argrelmin", "find_peaks",
        "find_peaks_cwt", "peak_prominences", "peak_widths", "ricker"),
    "ops.splines": (
        "cspline1d", "cspline1d_eval", "cspline2d", "gauss_spline",
        "qspline1d", "qspline1d_eval", "qspline2d", "sepfir2d",
        "spline_filter", "symiirorder1", "symiirorder2"),
    "ops.smooth": (
        "detrend", "medfilt", "medfilt2d", "order_filter", "savgol_coeffs",
        "savgol_filter", "wiener"),
    "ops.waveforms": (
        "chirp", "gausspulse", "max_len_seq", "sawtooth", "square",
        "sweep_poly", "unit_impulse"),
    "ops.demod": (
        "am_demod", "am_demod_ri", "fm_demod", "fm_demod_ri", "nco_mix",
        "nco_mix_ri"),
})
