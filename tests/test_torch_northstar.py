"""The PyTorch port's NorthStarChain against the JAX package's composable
chain (``use_pallas=False``) and the float64 scipy + numpy oracle, on the CPU.

Coefficients and the incoming state cross through
``simpledsp_tpu_torch.convert``.  Tolerances: spectra 1e-9 against JAX and
the oracle (float64, the chain's own bar in the JAX tests), streaming
continuity 1e-10.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as sig
import torch

from simpledsp_tpu.design.biquad import sos_matrix
from simpledsp_tpu.models import northstar as jns
from simpledsp_tpu.ops.iir import IIRState as JIIRState
from simpledsp_tpu_torch.convert import (design_from_numpy, state_from_numpy,
                                         state_to_numpy)
from simpledsp_tpu_torch.models.northstar import NorthStarChain, default_design
from simpledsp_tpu_torch.ops.fft import unpack_rfft_ri

REPO = Path(__file__).resolve().parents[1]


def _oracle(design, x, n):
    """scipy sosfilt (float64) + numpy rfft, packed to N/2 bins with
    X[N/2].re in the imaginary plane's bin 0."""
    y = sig.sosfilt(sos_matrix(design), x, axis=-1)
    full = np.fft.rfft(y.reshape(x.shape[0], -1, n))
    packed = full[..., : n // 2].copy()
    packed[..., 0] += 1j * full[..., n // 2].real
    return packed


def _chain(use_kernel, **kw):
    jd = jns.default_design()
    design = design_from_numpy(jd.b, jd.a, jd.gain, jd.ftype, jd.f0, jd.fs,
                               jd.q)
    return NorthStarChain(design=design, dtype=torch.float64, device="cpu",
                          use_kernel=use_kernel, **kw)


def test_default_design_matches_jax():
    jd, td = jns.default_design(), default_design()
    np.testing.assert_array_equal(td.b, jd.b)
    np.testing.assert_array_equal(td.a, jd.a)
    assert td.gain == jd.gain


@pytest.mark.parametrize("use_kernel", [False, True])
def test_matches_jax_chain_and_oracle(use_kernel, rng):
    chain = _chain(use_kernel)
    jchain = jns.NorthStarChain(dtype=jnp.float64, use_pallas=False)
    x = rng.standard_normal((2, 4 * 4096))
    # Cold start against the oracle.
    (sr, si), _ = chain(torch.as_tensor(x))
    got = sr.numpy() + 1j * si.numpy()
    assert got.shape == (2, 4, 2048)
    assert np.abs(got - _oracle(chain.design, x, 4096)).max() < 1e-9
    # Warm start against the JAX chain, the state crossing through convert.
    warm = rng.standard_normal((2, 4096))
    _, jst = jchain(jnp.asarray(warm))
    s0 = np.array(jst.y_hist)
    (sr, si), st = chain(torch.as_tensor(x),
                         state_from_numpy(s0, dtype=torch.float64))
    (jr, ji), jst2 = jchain(jnp.asarray(x), JIIRState(jnp.asarray(s0)))
    np.testing.assert_allclose(sr.numpy(), np.asarray(jr), rtol=0, atol=1e-9)
    np.testing.assert_allclose(si.numpy(), np.asarray(ji), rtol=0, atol=1e-9)
    np.testing.assert_allclose(state_to_numpy(st), np.asarray(jst2.y_hist),
                               rtol=0, atol=1e-10)
    ref = _oracle(chain.design, np.concatenate([warm, x], -1), 4096)[:, 1:]
    assert np.abs(sr.numpy() + 1j * si.numpy() - ref).max() < 1e-9


@pytest.mark.parametrize("fft_size", [1024, 16384])
def test_fused_and_composable_paths_agree(fft_size, rng):
    """The two block sizes (the fused path's 128-sample sub-block, the
    composable path's 256) agree to rounding."""
    x = torch.as_tensor(rng.standard_normal((2, 2 * fft_size)))
    (ar, ai), sa = _chain(False, fft_size=fft_size)(x)
    (br, bi), sb = _chain(True, fft_size=fft_size)(x)
    np.testing.assert_allclose(br.numpy(), ar.numpy(), rtol=0, atol=1e-9)
    np.testing.assert_allclose(bi.numpy(), ai.numpy(), rtol=0, atol=1e-9)
    np.testing.assert_allclose(sb.y_hist.numpy(), sa.y_hist.numpy(), rtol=0,
                               atol=1e-10)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_streaming_two_halves_equal_one_call(use_kernel, rng):
    chain = _chain(use_kernel)
    x = torch.as_tensor(rng.standard_normal((1, 4 * 4096)))
    (ar, ai), s_all = chain(x)
    (br, bi), s = chain(x[:, : 2 * 4096])
    (cr, ci), s_end = chain(x[:, 2 * 4096:], s)
    np.testing.assert_allclose(torch.cat([br, cr], 1).numpy(), ar.numpy(),
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(torch.cat([bi, ci], 1).numpy(), ai.numpy(),
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(s_end.y_hist.numpy(), s_all.y_hist.numpy(),
                               rtol=0, atol=1e-10)


def test_unpack_matches_numpy_rfft(rng):
    chain = _chain(True)
    x = rng.standard_normal((1, 8192))
    (sr, si), _ = chain(torch.as_tensor(x))
    yr, yi = unpack_rfft_ri(sr, si)
    y = sig.sosfilt(sos_matrix(chain.design), x, axis=-1)
    ref = np.fft.rfft(y.reshape(1, -1, 4096))
    assert yr.shape == (1, 2, 2049)
    assert np.abs(yr.numpy() + 1j * yi.numpy() - ref).max() < 1e-9


def test_frame_input_gives_the_same_spectra(rng):
    chain = _chain(True)
    x = rng.standard_normal((2, 3 * 4096))
    framed = chain.frame_input(x)
    assert framed.shape == (2, 3, 32, 128)
    (ar, ai), sa = chain(torch.as_tensor(x))
    (br, bi), sb = chain(framed)
    assert torch.equal(ar, br) and torch.equal(ai, bi)
    assert torch.equal(sa.y_hist, sb.y_hist)
    assert _chain(False).frame_input(x).shape == (2, 3 * 4096)


def test_module_conversion_moves_every_table(rng):
    """``.float()`` on a float64 chain converts the buffers, and the chain
    follows them: float32 in and out, with the frame-prefix tables rebuilt
    for the new dtype (float32 rounding, 1e-4 of the largest bin)."""
    chain = _chain(True)
    x = rng.standard_normal((2, 2 * 4096))
    (ar, ai), _ = chain(torch.as_tensor(x))
    chain.float()
    assert chain.dtype == torch.float32
    (br, bi), st = chain(torch.as_tensor(x))
    assert br.dtype == bi.dtype == st.y_hist.dtype == torch.float32
    scale = float(ar.abs().max())
    np.testing.assert_allclose(br.numpy(), ar.numpy(), rtol=0, atol=1e-4 * scale)
    np.testing.assert_allclose(bi.numpy(), ai.numpy(), rtol=0, atol=1e-4 * scale)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_use_pallas_is_an_alias_of_use_kernel(use_pallas, rng):
    """The JAX package's keyword picks the same path and the same spectra;
    both keywords with different values raise."""
    jd = jns.default_design()
    design = design_from_numpy(jd.b, jd.a, jd.gain, jd.ftype, jd.f0, jd.fs,
                               jd.q)
    chain = NorthStarChain(design=design, dtype=torch.float64, device="cpu",
                           use_pallas=use_pallas)
    assert chain.use_kernel is use_pallas
    x = torch.as_tensor(rng.standard_normal((2, 2 * 4096)))
    (ar, ai), _ = chain(x)
    (br, bi), _ = _chain(use_pallas)(x)
    assert torch.equal(ar, br) and torch.equal(ai, bi)
    assert _chain(use_pallas, use_pallas=use_pallas).use_kernel is use_pallas
    with pytest.raises(ValueError, match="use_pallas"):
        _chain(use_pallas, use_pallas=not use_pallas)


def test_bad_inputs_raise():
    with pytest.raises(ValueError, match="multiple"):
        _chain(False)(torch.zeros(1, 5000, dtype=torch.float64))
    with pytest.raises(ValueError, match="multiple"):
        _chain(True, block_size=1000)(torch.zeros(1, 4096, dtype=torch.float64))
    with pytest.raises(ValueError, match="pre-framed"):
        _chain(False)(torch.zeros(1, 2, 32, 128, dtype=torch.float64))
    with pytest.raises(ValueError, match="even"):
        NorthStarChain(fft_size=4095, device="cpu")
    with pytest.raises(ValueError, match="32768"):
        NorthStarChain(fft_size=32768, use_kernel=True, device="cpu")


def test_cuda_device_raises_without_cuda():
    """No silent move to the CPU: asking for CUDA where there is none
    raises."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        NorthStarChain(device="cuda")


def _run_python(code, env=None):
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_imports_no_jax():
    code = ("import sys\n"
            "import simpledsp_tpu_torch.models.northstar\n"
            "import simpledsp_tpu_torch.convert\n"
            "import simpledsp_tpu_torch.kernels.chain\n"
            "import simpledsp_tpu_torch.kernels.chain_variants\n"
            "import simpledsp_tpu_torch.models.sdr\n"
            "import simpledsp_tpu_torch.kernels.pfb\n"
            "import simpledsp_tpu_torch.design.optimal_fir\n"
            "import simpledsp_tpu_torch.kernels.ols\n"
            "import simpledsp_tpu_torch.kernels.conv2d\n"
            "import simpledsp_tpu_torch.ops.conv\n"
            "import simpledsp_tpu_torch.ops.conv2d\n"
            "import simpledsp_tpu_torch.ops.fir\n"
            "import simpledsp_tpu_torch.device\n"
            "import simpledsp_tpu_torch.kernels.fft\n"
            "import simpledsp_tpu_torch.ops.transforms\n"
            "import simpledsp_tpu_torch.ops.spectral\n"
            "import simpledsp_tpu_torch.models.radar\n"
            "import simpledsp_tpu_torch.kernels.probes\n"
            "import simpledsp_tpu_torch.tools.probe_dma_scale\n"
            "import simpledsp_tpu_torch.tools.probe_store\n"
            "import simpledsp_tpu_torch.tools.probe_dispatch\n"
            "import simpledsp_tpu_torch.tools.probe_hlo\n"
            "import simpledsp_tpu_torch.tools.probe_transpose\n"
            "import simpledsp_tpu_torch.tools.probe_relayout\n"
            "import simpledsp_tpu_torch.tools.probe_mosaic\n"
            "import simpledsp_tpu_torch.tools.chain_forms\n"
            "import simpledsp_tpu_torch.utils.fixtures\n"
            "import simpledsp_tpu_torch.utils.intmath\n"
            "import simpledsp_tpu_torch.ops.lfilter\n"
            "import simpledsp_tpu_torch.ops.iir\n"
            "import simpledsp_tpu_torch.design.biquad\n"
            "import simpledsp_tpu_torch.design.iir\n"
            "import simpledsp_tpu_torch.design.ltisys\n"
            "import simpledsp_tpu_torch.design.residues\n"
            "import simpledsp_tpu_torch.design.placement\n"
            "import simpledsp_tpu_torch.design.systems\n"
            "import simpledsp_tpu_torch.models.audio\n"
            "import simpledsp_tpu_torch.models.comms\n"
            "from simpledsp_tpu_torch.design.biquad import design_bandstop\n"
            "design_bandstop(4, 6000.0, 39000.0, 3.0)\n"
            "from simpledsp_tpu_torch.design.ltisys import dlsim, freqresp\n"
            "dlsim(([1.0], [1.0, -0.5], 1.0), [1.0, 0.0, 0.0])\n"
            "freqresp(([1.0], [1.0, 1.0]), [1.0, 2.0])\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m == 'jax' or m.startswith(('jax.', 'simpledsp_tpu.')))\n"
            "assert not bad, bad\n")
    proc = _run_python(code)
    assert proc.returncode == 0, proc.stderr


def test_kernel_module_imports_without_nvcc(tmp_path):
    """Importing the kernel module builds nothing; asking for the build
    where there is no nvcc raises a RuntimeError that says so."""
    env = dict(os.environ, PATH=str(tmp_path), CUDA_HOME=str(tmp_path),
               CUDA_PATH=str(tmp_path))
    code = ("import simpledsp_tpu_torch.kernels.chain as kc\n"
            "import simpledsp_tpu_torch.kernels.pfb as kp\n"
            "import simpledsp_tpu_torch.kernels.ols as ko\n"
            "import simpledsp_tpu_torch.kernels.conv2d as k2\n"
            "import simpledsp_tpu_torch.kernels.fft as kf\n"
            "import simpledsp_tpu_torch.kernels.chain_variants as kv\n"
            "import simpledsp_tpu_torch.kernels.probes as kq\n"
            "from simpledsp_tpu_torch.kernels import _build\n"
            "assert kc.chain_kernel.launches == 0\n"
            "assert kp.pfb_flat_kernel.launches == 0\n"
            "assert ko.ols_kernel.launches == 0\n"
            "assert k2.conv2d_kernel.launches == 0\n"
            "assert kf.fft_frames_kernel.launches == 0\n"
            "assert kc.chain_full_kernel.launches == 0\n"
            "assert kv.chain_regs_kernel.launches == 0\n"
            "assert kv.chain_grouped_kernel.launches == 0\n"
            "assert kv.chain_store_kernel.launches == 0\n"
            "for k in (kq.scale_copy_kernel, kq.permute_kernel,\n"
            "          kq.contract_kernel, kq.row_sum_kernel):\n"
            "    assert k.launches == 0\n"
            "assert not _build.build_seconds\n"
            "try:\n"
            "    _build._nvcc()\n"
            "except RuntimeError as e:\n"
            "    assert 'nvcc' in str(e)\n"
            "else:\n"
            "    raise SystemExit('nvcc found')\n")
    proc = _run_python(code, env)
    assert proc.returncode == 0, proc.stderr
