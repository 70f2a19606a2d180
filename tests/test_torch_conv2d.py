"""The port's 2-D convolution (ops/conv2d, kernels/conv2d plain version)
against the JAX package and scipy, in float64 on the CPU.

The JAX fused kernel runs in Pallas interpret mode, as its own tests run
it.  Tolerance: 1e-12 relative to the largest output magnitude (float64
rounding of the FFT route and of shifted sums in another order); the
direct routes of the two packages add the same products in the same order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as sig
import torch

from simpledsp_tpu.kernels import conv2d as jk2d
from simpledsp_tpu.ops import conv2d as jconv2d
from simpledsp_tpu_torch.kernels import conv2d as tk2d
from simpledsp_tpu_torch.ops import conv2d as tconv2d

TOL = 1e-12


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("ksize", [(3, 3), (4, 5), (7, 2), (1, 1)])
@pytest.mark.parametrize("mode", ["full", "same", "valid"])
@pytest.mark.parametrize("boundary", ["fill", "wrap", "symm"])
def test_convolve2d_matches_jax_and_scipy(ksize, mode, boundary, rng):
    x = rng.standard_normal((12, 15))
    k = rng.standard_normal(ksize)
    want = sig.convolve2d(x, k, mode, boundary=boundary)
    for method in ("direct", "fft"):
        got = tconv2d.convolve2d(torch.as_tensor(x), k, mode,
                                 boundary=boundary, method=method).numpy()
        _close(got, jconv2d.convolve2d(jnp.asarray(x), k, mode,
                                       boundary=boundary, method=method))
        _close(got, want)


@pytest.mark.parametrize("ksize", [(3, 3), (4, 5), (7, 2)])
@pytest.mark.parametrize("mode", ["full", "same", "valid"])
@pytest.mark.parametrize("boundary", ["fill", "wrap", "symm"])
def test_correlate2d_matches_jax_and_scipy(ksize, mode, boundary, rng):
    x = rng.standard_normal((12, 15))
    k = rng.standard_normal(ksize)
    got = tconv2d.correlate2d(torch.as_tensor(x), k, mode,
                              boundary=boundary).numpy()
    _close(got, jconv2d.correlate2d(jnp.asarray(x), k, mode,
                                    boundary=boundary))
    _close(got, sig.correlate2d(x, k, mode, boundary=boundary))
    # A tensor kernel takes the plain direct route: the same values.
    _close(tconv2d.correlate2d(torch.as_tensor(x), torch.as_tensor(k), mode,
                               boundary=boundary).numpy(), got)


@pytest.mark.parametrize("mode", ["full", "same", "valid"])
@pytest.mark.parametrize("method", ["direct", "fft"])
def test_complex_inputs(mode, method, rng):
    x = rng.standard_normal((10, 11)) + 1j * rng.standard_normal((10, 11))
    k = rng.standard_normal((4, 3)) + 1j * rng.standard_normal((4, 3))
    for fn in ("convolve2d", "correlate2d"):
        got = getattr(tconv2d, fn)(torch.as_tensor(x), k, mode, method=method)
        assert got.is_complex()
        _close(got.numpy(), getattr(jconv2d, fn)(jnp.asarray(x), k, mode,
                                                 method=method))
        _close(got.numpy(), getattr(sig, fn)(x, k, mode))


@pytest.mark.parametrize("fn", ["convolve2d", "correlate2d"])
@pytest.mark.parametrize("kernel", [[[1.0, 2.0], [3.0, 4.0]],
                                    [[0.5, -1.0, 2.0]],
                                    [[1 + 2j, -1j], [0.5, 3.0]]])
def test_list_kernel(fn, kernel, rng):
    """A nested list is concrete host taps, as the JAX package takes them."""
    x = rng.standard_normal((9, 11))
    got = getattr(tconv2d, fn)(torch.as_tensor(x), kernel, "same").numpy()
    _close(got, getattr(jconv2d, fn)(jnp.asarray(x), kernel, "same"))
    _close(got, getattr(sig, fn)(x, np.asarray(kernel), "same"))


@pytest.mark.parametrize("boundary", ["fill", "wrap", "symm"])
def test_batched_leading_axes(boundary, rng):
    x = rng.standard_normal((3, 2, 12, 15))
    k = rng.standard_normal((3, 3))
    got = tconv2d.convolve2d(torch.as_tensor(x), k, "same",
                             boundary=boundary).numpy()
    _close(got, jconv2d.convolve2d(jnp.asarray(x), k, "same",
                                   boundary=boundary))
    for i in range(3):
        for j in range(2):
            _close(got[i, j], sig.convolve2d(x[i, j], k, "same",
                                             boundary=boundary))


@pytest.mark.parametrize("fillvalue", [0.0, 2.5, -1.0])
@pytest.mark.parametrize("method", ["direct", "fft"])
def test_fillvalue(fillvalue, method, rng):
    x = rng.standard_normal((6, 6))
    k = rng.standard_normal((3, 3))
    got = tconv2d.convolve2d(torch.as_tensor(x), k, "full",
                             fillvalue=fillvalue, method=method).numpy()
    _close(got, jconv2d.convolve2d(jnp.asarray(x), k, "full",
                                   fillvalue=fillvalue, method=method))
    _close(got, sig.convolve2d(x, k, "full", fillvalue=fillvalue))


@pytest.mark.parametrize("boundary", ["wrap", "symm"])
def test_kernel_larger_than_image(boundary, rng):
    """Boundary extension longer than the image repeats it, as numpy.pad
    does for the JAX package."""
    x = rng.standard_normal((5, 6))
    k = rng.standard_normal((9, 14))
    got = tconv2d.convolve2d(torch.as_tensor(x), k, "full",
                             boundary=boundary).numpy()
    _close(got, jconv2d.convolve2d(jnp.asarray(x), k, "full",
                                   boundary=boundary))
    _close(got, sig.convolve2d(x, k, "full", boundary=boundary))


def test_auto_takes_fft_above_256_taps(rng):
    x = rng.standard_normal((40, 50))
    k = rng.standard_normal((17, 17))
    got = tconv2d.convolve2d(torch.as_tensor(x), k, "same").numpy()
    _close(got, jconv2d.convolve2d(jnp.asarray(x), k, "same"))
    _close(got, sig.convolve2d(x, k, "same"))


@pytest.mark.parametrize("n", [1, 7, 100, 128, 129, 300, 575, 1000, 4100])
def test_fft_size_2d_matches_jax(n):
    assert tconv2d._fft_size_2d(n) == jconv2d._fft_size_2d(n)


@pytest.mark.parametrize("shape,ks", [
    ((2, 70, 90), (9, 9)),
    ((1, 130, 200), (5, 7)),
    ((3, 2, 40, 50), (3, 3)),
    ((1, 128, 128), (13, 13)),
    ((1, 17, 33), (4, 2)),
    ((1, 8, 130), (1, 3)),
])
def test_conv2d_valid_fused_matches_jax(shape, ks, rng):
    """The plain version against the JAX fused kernel in interpret mode
    (float64) and against the JAX direct loop; in float32 the port's fused
    entry on the CPU is its plain version, so equal bits."""
    x = rng.standard_normal(shape)
    k = rng.standard_normal(ks)
    got = tk2d.conv2d_valid_fused(torch.as_tensor(x), k)
    _close(got.numpy(), jk2d.conv2d_valid_fused(jnp.asarray(x), k,
                                                 interpret=True))
    _close(got.numpy(), jconv2d._conv2d_direct_real(jnp.asarray(x),
                                                    jnp.asarray(k)))
    x32 = torch.as_tensor(x, dtype=torch.float32)
    ref = tk2d.conv2d_valid_reference(x32, torch.as_tensor(k, dtype=torch.float32))
    assert torch.equal(tk2d.conv2d_valid_fused(x32, k), ref)


def test_gate_and_errors():
    assert tk2d.conv2d_fused_supported(9, 9)
    assert tk2d.conv2d_fused_supported(13, 13)
    assert not tk2d.conv2d_fused_supported(15, 15)   # > 169 taps
    # The tap cap is the JAX gate's on an image that fits the TPU's VMEM.
    for ks in ((1, 1), (9, 9), (13, 13), (1, 169), (13, 14), (15, 15)):
        assert (tk2d.conv2d_fused_supported(*ks)
                == jk2d.conv2d_fused_supported(520, 520, *ks))
    # The TPU's VMEM term is dropped on the card: a large image still
    # takes the kernel there, where the JAX gate refuses it.
    assert not jk2d.conv2d_fused_supported(4000, 4000, 9, 9)
    with pytest.raises(ValueError, match="smaller than kernel"):
        tk2d.conv2d_valid_fused(torch.zeros(1, 4, 4), np.ones((9, 9)))


def test_rejects_bad_arguments(rng):
    x = torch.as_tensor(rng.standard_normal((6, 6)))
    k = rng.standard_normal((3, 3))
    with pytest.raises(ValueError, match="boundary"):
        tconv2d.convolve2d(x, k, "same", boundary="reflect")
    with pytest.raises(ValueError, match="mode"):
        tconv2d.convolve2d(x, k, "ful")
    with pytest.raises(ValueError, match="2-D"):
        tconv2d.convolve2d(x, rng.standard_normal(3))
    with pytest.raises(ValueError, match="2-D"):
        tconv2d.correlate2d(x, torch.zeros(3))
    with pytest.raises(ValueError, match="valid mode"):
        tconv2d.convolve2d(x, rng.standard_normal((7, 7)), "valid")
    with pytest.raises(ValueError, match="method"):
        tconv2d.convolve2d(x, k, method="winograd")
    with pytest.raises(ValueError, match="image"):
        tconv2d.convolve2d(torch.zeros(5), k)
