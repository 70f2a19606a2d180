"""The port's objects run on the card unless asked for the CPU.

``device=None`` means CUDA (``simpledsp_tpu_torch.device.resolve_device``):
on a machine without a card every object that holds tables raises instead
of falling back to the CPU, and ``device="cpu"`` builds it on the CPU.
"""

import numpy as np
import pytest
import torch

from simpledsp_tpu_torch.device import resolve_device
from simpledsp_tpu_torch.kernels.chain import FusedNorthStarOperators
from simpledsp_tpu_torch.models import sdr as tsdr
from simpledsp_tpu_torch.models.northstar import NorthStarChain
from simpledsp_tpu_torch.ops import fir as tfir
from simpledsp_tpu_torch.ops import transforms as ttr
from simpledsp_tpu_torch.ops.channelizer import PFBChannelizer
from simpledsp_tpu_torch.ops.iir import BlockIIR
from simpledsp_tpu_torch.design.biquad import design_lowpass
from simpledsp_tpu_torch.models.audio import MelSpectrogram
from simpledsp_tpu_torch.models.comms import Constellation, LinearModem
from simpledsp_tpu_torch.ops.lfilter import BlockLFilter

_TAPS = np.hanning(33) / np.hanning(33).sum()

BUILDERS = {
    "NorthStarChain": lambda **kw: NorthStarChain(**kw),
    "FMReceiverBank": lambda **kw: tsdr.FMReceiverBank(16, fs=1.6e6, **kw),
    "AMReceiverBank": lambda **kw: tsdr.AMReceiverBank(16, fs=1.6e6, **kw),
    "BlockIIR": lambda **kw: BlockIIR(design_lowpass(4, 2000.0, 39000.0),
                                      **kw),
    "PFBChannelizer": lambda **kw: PFBChannelizer(16, **kw),
    "FIRFilter": lambda **kw: tfir.FIRFilter(_TAPS, **kw),
    "PolyphaseDecimator": lambda **kw: tfir.PolyphaseDecimator(_TAPS, 4, **kw),
    "OverlapSaveFIR": lambda **kw: tfir.OverlapSaveFIR(_TAPS, block_size=64,
                                                       **kw),
    "FusedNorthStarOperators": lambda **kw: FusedNorthStarOperators(
        design_lowpass(4, 2000.0, 39000.0), 1024, **kw),
    "CZT": lambda **kw: ttr.CZT(64, **kw),
    "ZoomFFT": lambda **kw: ttr.ZoomFFT(64, [0.1, 0.4], **kw),
    "BlockLFilter": lambda **kw: BlockLFilter([0.2, 0.3], [1.0, -0.5], **kw),
    "MelSpectrogram": lambda **kw: MelSpectrogram(512, 256, 64, **kw),
    "LinearModem": lambda **kw: LinearModem(Constellation.qpsk(), **kw),
}


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_default_device_is_cuda_and_raises_without_it(name):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: device=None is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BUILDERS[name]()


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_cpu_when_asked(name):
    obj = BUILDERS[name](device="cpu")
    held = (list(obj.buffers()) if isinstance(obj, torch.nn.Module)
            else [obj.device])
    assert held and all(getattr(t, "device", t) == torch.device("cpu")
                        for t in held)


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cpu")) == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_device("cuda")
