"""The PyTorch port's FFT (simpledsp_tpu_torch.ops.fft, kernels.fft host
tables) against the JAX package and numpy, in float64 on the CPU.

Tolerance: 1e-12 relative to the largest output magnitude (float64 rounding
of four-step sums; outputs of random normal input grow as sqrt(N)).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpledsp_tpu.kernels import fft as jkfft
from simpledsp_tpu.ops import fft as jfft
from simpledsp_tpu_torch.kernels import fft as tkfft
from simpledsp_tpu_torch.ops import fft as tfft

SIZES = [8, 256, 4096, 16384]
TOL = 1e-12


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale)


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


@pytest.mark.parametrize("n", SIZES)
def test_fft_ri_ifft_ri(n, rng):
    xr, xi = rng.standard_normal((2, 3, n))
    yr, yi = tfft.fft_ri(_t(xr), _t(xi))
    jr, ji = jfft.fft_ri(jnp.asarray(xr), jnp.asarray(xi))
    ref = np.fft.fft(xr + 1j * xi)
    for got, want in ((yr, jr), (yi, ji), (yr, ref.real), (yi, ref.imag)):
        _close(got.numpy(), want)
    br, bi = tfft.ifft_ri(yr, yi)
    jr, ji = jfft.ifft_ri(jnp.asarray(yr.numpy()), jnp.asarray(yi.numpy()))
    for got, want in ((br, jr), (bi, ji), (br, xr), (bi, xi)):
        _close(got.numpy(), want)


@pytest.mark.parametrize("n", SIZES + [6, 9])
def test_rfft_ri_irfft_ri(n, rng):
    x = rng.standard_normal((3, n))
    yr, yi = tfft.rfft_ri(_t(x))
    jr, ji = jfft.rfft_ri(jnp.asarray(x))
    ref = np.fft.rfft(x)
    for got, want in ((yr, jr), (yi, ji), (yr, ref.real), (yi, ref.imag)):
        _close(got.numpy(), want)
    back = tfft.irfft_ri(yr, yi, n)
    _close(back.numpy(), jfft.irfft_ri(jr, ji, n))
    _close(back.numpy(), x)


@pytest.mark.parametrize("n", SIZES)
def test_pack_unpack_rfft_ri(n, rng):
    x = rng.standard_normal((2, n))
    yr, yi = tfft.rfft_ri(_t(x))
    pr, pi = tfft.pack_rfft_ri(yr, yi)
    jpr, jpi = jfft.pack_rfft_ri(*jfft.rfft_ri(jnp.asarray(x)))
    _close(pr.numpy(), jpr)
    _close(pi.numpy(), jpi)
    assert pr.shape == (2, n // 2)
    ur, ui = tfft.unpack_rfft_ri(pr, pi)
    ref = np.fft.rfft(x)
    _close(ur.numpy(), ref.real)
    _close(ui.numpy(), ref.imag)


@pytest.mark.parametrize("n", [16, 64, 256, 1024])
def test_radix_entries_match_numpy(n, rng):
    xr, xi = rng.standard_normal((2, 2, n))
    ref = np.fft.fft(xr + 1j * xi)
    yr, yi = tfft.fft_radix2(_t(xr), _t(xi))
    _close(yr.numpy() + 1j * yi.numpy(), ref)
    br, bi = tfft.fft_radix2(yr, yi, inverse=True)
    _close(br.numpy() + 1j * bi.numpy(), xr + 1j * xi)
    yr, yi = tfft.fft_radix4(_t(xr), _t(xi))      # every n here is 4^k
    _close(yr.numpy() + 1j * yi.numpy(), ref)


@pytest.mark.parametrize("entry,n", [("fft_radix2", 12), ("fft_radix2", 96),
                                     ("fft_radix4", 8), ("fft_radix4", 32),
                                     ("fft_radix4", 48)])
def test_radix_gates_raise_as_in_jax(entry, n):
    with pytest.raises(ValueError, match=entry):
        getattr(jfft, entry)(jnp.zeros(n, jnp.complex128))
    with pytest.raises(ValueError, match=entry):
        getattr(tfft, entry)(torch.zeros(n, dtype=torch.float64),
                             torch.zeros(n, dtype=torch.float64))


@pytest.mark.parametrize("n,factor", [(257, 257), (262, 131), (524, 131)])
def test_prime_factor_above_128_not_ported(n, factor):
    """The JAX package runs Bluestein's chirp-z for these sizes; the port
    raises, naming the size it cannot factor, until czt_ri is ported."""
    x = torch.zeros(1, n, dtype=torch.float64)
    with pytest.raises(NotImplementedError, match=f"size {factor} "):
        tfft.fft_ri(x, x)


@pytest.mark.parametrize("n", [8, 9, 128, 1000, 1024, 4096, 16384, 32768])
def test_best_split_and_consts_match_jax(n):
    assert tkfft._best_split(n) == jkfft._best_split(n)
    assert tkfft.fft_split_supported(n) == jkfft.pallas_fft_supported(n)
    if tkfft._best_split(n) is None:
        return
    for inverse in (False, True):
        got = tkfft._consts(n, inverse, "float32")
        want = jkfft._consts(n, inverse, "float32")
        assert got[:2] == want[:2]
        for a, b in zip(got[2:], want[2:]):
            np.testing.assert_array_equal(a, b)


def test_dft_matrix_and_twiddles_bitwise():
    for n in (8, 128):
        for inverse in (False, True):
            for a, b in zip(tfft.dft_matrix(n, inverse), jfft.dft_matrix(n, inverse)):
                np.testing.assert_array_equal(a, b)
    for a, b in zip(tfft._twiddle_f64(32, 128), jfft._twiddle_f64(32, 128)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tfft._half_twiddle_f64(4096), jfft._half_twiddle_f64(4096)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n", [8, 9, 256, 4096])
def test_complex_wrappers_match_jax_and_numpy(n, rng):
    x = rng.standard_normal((3, n)) + 1j * rng.standard_normal((3, n))
    xt = torch.as_tensor(x)
    for name, ref in (("fft", np.fft.fft(x)), ("ifft", np.fft.ifft(x))):
        got = getattr(tfft, name)(xt)
        assert got.dtype == torch.complex128
        _close(got.numpy(), getattr(jfft, name)(jnp.asarray(x)))
        _close(got.numpy(), ref)
    r = x.real
    got = tfft.rfft(torch.as_tensor(r))
    _close(got.numpy(), jfft.rfft(jnp.asarray(r)))
    _close(got.numpy(), np.fft.rfft(r))
    back = tfft.irfft(got, n)
    _close(back.numpy(), jfft.irfft(jnp.asarray(got.numpy()), n))
    _close(back.numpy(), r)


def test_complex_wrappers_working_dtype(rng):
    x = rng.standard_normal((2, 64)).astype(np.float32)
    assert tfft.fft(torch.as_tensor(x)).dtype == torch.complex64
    assert tfft.rfft(torch.as_tensor(x)).dtype == torch.complex64
    assert tfft.fft(torch.as_tensor(x), dtype=torch.float64).dtype == \
        torch.complex128
    assert tfft.fft2(torch.as_tensor(x)).dtype == torch.complex64


@pytest.mark.parametrize("shape", [(8, 16), (3, 12, 20), (2, 31, 17),
                                   (2, 128, 256)])
def test_fft2_ifft2_match_jax_and_numpy(shape, rng):
    x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    got = tfft.fft2(torch.as_tensor(x))
    _close(got.numpy(), jfft.fft2(jnp.asarray(x)))
    _close(got.numpy(), np.fft.fft2(x))
    inv = tfft.ifft2(got)
    _close(inv.numpy(), jfft.ifft2(jnp.asarray(got.numpy())))
    _close(inv.numpy(), x)
    yr, yi = tfft.fft2_ri(torch.as_tensor(x.real), torch.as_tensor(x.imag))
    _close(yr.numpy(), got.real.numpy())
    _close(yi.numpy(), got.imag.numpy())
    br, bi = tfft.ifft2_ri(yr, yi)
    jr, ji = jfft.ifft2_ri(jnp.asarray(yr.numpy()), jnp.asarray(yi.numpy()))
    _close(br.numpy(), jr)
    _close(bi.numpy(), ji)


@pytest.mark.parametrize("shape", [(8, 16), (5, 12, 21), (2, 9, 32),
                                   (2, 640, 640)])
def test_rfft2_ri_irfft2_ri_match_jax_and_numpy(shape, rng):
    x = rng.standard_normal(shape)
    yr, yi = tfft.rfft2_ri(torch.as_tensor(x))
    jr, ji = jfft.rfft2_ri(jnp.asarray(x))
    ref = np.fft.rfft2(x)
    for got, want in ((yr, jr), (yi, ji), (yr, ref.real), (yi, ref.imag)):
        _close(got.numpy(), want)
    back = tfft.irfft2_ri(yr, yi, shape[-1])
    _close(back.numpy(), jfft.irfft2_ri(jr, ji, shape[-1]))
    _close(back.numpy(), x)
