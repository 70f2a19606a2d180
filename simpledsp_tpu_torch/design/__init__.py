"""Host-side float64 filter design (NumPy).

Exports the JAX package's ``design`` names, each resolved on first access
by importing its own submodule only (``simpledsp_tpu_torch/_lazy.py``).
"""

from simpledsp_tpu_torch import _lazy

_lazy.install(globals(), {
    "design.windows": ("get_window", "kaiserord"),
    "design.biquad": (
        "BiquadCascadeDesign", "FilterType", "design_bandpass",
        "design_bandstop", "design_highpass", "design_lowpass",
        "sos_matrix"),
    "design.ltisys": (
        "bilinear", "cont2discrete", "normalize", "sos2tf", "sos2zpk",
        "sosfreqz", "ss2tf", "tf2sos", "tf2ss", "tf2zpk", "zpk2tf"),
    "design.fir": ("firwin", "firwin2"),
    "design.optimal_fir": ("firls", "minimum_phase", "remez"),
    "design.iir": (
        "bessel", "butter", "buttord", "cheb1ord", "cheb2ord", "cheby1",
        "cheby2", "ellip", "ellipord", "gammatone", "iircomb", "iirdesign",
        "iirfilter", "iirnotch", "iirpeak", "zpk2sos"),
})
