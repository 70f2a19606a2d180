"""Signal-chain models composed from the ops and kernels: the north-star
chain, the SDR receiver banks, the pulse-Doppler radar, audio features and
the modems.

Exports the JAX package's ``models`` names, each resolved on first access
by importing its own submodule only (``simpledsp_tpu_torch/_lazy.py``).
"""

from simpledsp_tpu_torch import _lazy

_lazy.install(globals(), {
    "models.northstar": ("NorthStarChain", "ShardedNorthStarChain",
                         "default_design"),
    "models.sdr": ("FMReceiverBank", "SDRState", "AMReceiverBank"),
    "models.audio": ("MelSpectrogram", "griffin_lim", "mel_filterbank",
                     "mfcc"),
    "models.comms": ("Constellation", "LinearModem", "OFDMModem", "awgn",
                     "ber"),
})
