"""Hand-written CUDA kernels (csrc/), their wrappers and plain PyTorch versions.

Exports the JAX package's ``kernels`` names (``pallas_fft_supported`` is
the JAX name of ``fft_split_supported``), each resolved on first access by
importing its own submodule only (``simpledsp_tpu_torch/_lazy.py``).
"""

from simpledsp_tpu_torch import _lazy

_lazy.install(globals(), {
    "kernels.fft": ("fft_frames_ri", "pallas_fft_supported", "rfft_frames"),
})
