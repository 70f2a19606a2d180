"""The CUDA chain kernel against its plain version, on an NVIDIA GPU.

These tests need a card and ``nvcc``; elsewhere they skip.  The file
imports no JAX, so it also runs where only the port is installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest

Tolerance: >= 130 dB SNR against the plain version evaluated in float64 on
the same float32 inputs and tables (the chain's bar; the kernel sums in
IEEE float32).
"""

import numpy as np
import pytest
import scipy.signal as sig
import torch

from simpledsp_tpu_torch.design.biquad import sos_matrix
from simpledsp_tpu_torch.kernels import chain as tchain
from simpledsp_tpu_torch.models.northstar import NorthStarChain, default_design

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


@pytest.mark.parametrize("n", [1024, 2048, 4096, 16384])
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
