"""The PyTorch port's fused chain (simpledsp_tpu_torch.kernels.chain)
against the JAX package's ``fused_chain_frames`` in Pallas interpret mode,
in float64 on the CPU.

On the CPU the port runs the kernel's plain version
(``chain_frames_reference``); the CUDA kernel itself is checked against it
in ``test_torch_cuda.py``, which runs only where there is a card.

Tolerances: host-built tables are bitwise equal (same float64 code, same
cast); spectra agree to 1e-9 and the final state to 1e-10 (the two
packages' float64 sums run in different orders over up to 4096 terms).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpledsp_tpu.kernels import chain as jchain
from simpledsp_tpu.models.northstar import default_design as j_default_design
from simpledsp_tpu.ops import iir as jiir
from simpledsp_tpu_torch.convert import design_from_numpy
from simpledsp_tpu_torch.kernels import chain as tchain
from simpledsp_tpu_torch.precision import ieee_fp32

SIZES = [1024, 2048, 4096]


def _designs():
    jd = j_default_design()
    return jd, design_from_numpy(jd.b, jd.a, jd.gain, jd.ftype, jd.f0, jd.fs,
                                 jd.q)


def _ops(n, dtype):
    jd, td = _designs()
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    return (jchain.FusedNorthStarOperators(jd, n, dtype=jdt),
            tchain.FusedNorthStarOperators(td, n, dtype=dtype, device="cpu"))


def _warm_state(rng, c):
    """A realistic incoming state (C, D): the filter's state after noise."""
    jd, _ = _designs()
    _, st = jiir.sosfilt(jd, jnp.asarray(rng.standard_normal((c, 999))),
                         method="scan")
    return np.array(st.y_hist).reshape(c, -1)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n", SIZES + [16384])
def test_operator_tables_bitwise(n, dtype):
    jops, tops = _ops(n, dtype)
    assert (tops.n1, tops.n2, tops.state_dim) == (jops.n1, jops.n2,
                                                  jops.state_dim)
    for name in ("H", "Phi", "K", "Ff", "TKt", "KT", "TO", "FpT"):
        np.testing.assert_array_equal(getattr(tops, name).numpy(),
                                      getattr(jops, name), err_msg=name)
    # The kernel's tables, in the layouts it reads, from the same values.
    np.testing.assert_array_equal(tops.HT.numpy(), jops.H.T)
    np.testing.assert_array_equal(tops.PhiT.numpy(), jops.Phi.T)
    _, _, w1c, w1s, w2c, w2s, tc, ts = jchain._consts(
        n, False, np.dtype(jops.dtype).name)
    h = jops.n2 // 2
    np.testing.assert_array_equal(tops.W1cs.numpy(), np.concatenate([w1c, w1s]))
    np.testing.assert_array_equal(tops.Tc.numpy(), tc.T)
    np.testing.assert_array_equal(tops.Ts.numpy(), ts.T)
    p_tab = np.concatenate([w2c[:h], w2s[:h]])
    q_tab = np.concatenate([-w2s[:h], w2c[:h]])
    np.testing.assert_array_equal(tops.PQT.numpy(),
                                  np.concatenate([p_tab.T, q_tab.T]))


@pytest.mark.parametrize("frames", [1, 3, 5, 256])
def test_frame_prefix_tables_and_steps_match_jax(frames, rng):
    """The two-level frame-state prefix, including F padded up to bg G."""
    jops, tops = _ops(1024, torch.float64)
    jt, tt = jops.frame_prefix_tables(frames), tops.frame_prefix_tables(frames)
    assert tops.frame_prefix_tables(frames) is tt         # cached per F
    for key in ("bg", "G", "q_l", "p_l"):
        assert tt[key] == jt[key], key
    for key in ("LTfT", "LTgT", "FgPT", "FpLT", "FfpT"):
        np.testing.assert_array_equal(tt[key].numpy(), jt[key], err_msg=key)
    c, d = 3, tops.state_dim
    kf_t = rng.standard_normal((frames, c, d))
    s_in = rng.standard_normal((c, d))
    prec = jnp.float64
    jl, jw, jv = jchain._frame_prefix_start(jt, jnp.asarray(kf_t), None, prec)
    tl, tw, tv = tchain._frame_prefix_start(tt, torch.as_tensor(kf_t))
    for got, want in ((tl, jl), (tw, jw), (tv, jv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-10)
    js = jchain._frame_prefix_finish(jt, jl, jw, jnp.asarray(s_in), frames,
                                     None, prec)
    ts = tchain._frame_prefix_finish(tt, tl, tw, torch.as_tensor(s_in), frames)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-10)


@pytest.mark.parametrize("projection", ["two_step", "dense"])
@pytest.mark.parametrize("n", SIZES)
def test_fused_chain_frames_matches_jax_interpret(n, projection, rng):
    c, frames = 2, 3
    jops, tops = _ops(n, torch.float64)
    x = rng.standard_normal((c, frames * n))
    s0 = _warm_state(rng, c)
    (jr, ji), js = jchain.fused_chain_frames(
        jops, jnp.asarray(x), jnp.asarray(s0), half_spectrum=True,
        interpret=True, projection=projection)
    (tr, ti), ts = tchain.fused_chain_frames(
        tops, torch.as_tensor(x), torch.as_tensor(s0), half_spectrum=True,
        projection=projection)
    assert tr.shape == ti.shape == jr.shape == (c, frames, tops.n2 // 2,
                                                tops.n1)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0, atol=1e-9)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=0, atol=1e-9)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-10)


def test_prepass_takes_flat_or_framed_input(rng):
    _, tops = _ops(2048, torch.float64)
    x = torch.as_tensor(rng.standard_normal((2, 4 * 2048)))
    s0 = torch.as_tensor(_warm_state(rng, 2))
    flat = tchain.chain_prepass(tops, x, s0)
    framed = tchain.chain_prepass(tops, x.reshape(2, 4, tops.n1, tops.n2), s0)
    for a, b in zip(flat, framed):
        assert torch.equal(a, b)
    x3, s3, _ = flat
    assert x3.shape == (8, tops.n1, tops.n2)
    assert s3.shape == (8, tops.state_dim, tops.n1)
    with pytest.raises(ValueError, match="projection"):
        tchain.chain_prepass(tops, x, s0, projection="three_step")


def test_chain_frames_runs_only_on_cpu_or_cuda():
    """No fallback: the plain version serves CPU tensors only, and the
    kernel wrapper refuses what the kernel does not take before any build."""
    _, tops = _ops(1024, torch.float64)
    x3 = torch.zeros(2, tops.n1, tops.n2, dtype=torch.float64)
    s3 = torch.zeros(2, tops.state_dim, tops.n1, dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tchain.chain_frames(x3.to("meta"), s3.to("meta"), tops.tables())
    launches = tchain.chain_kernel.launches
    with pytest.raises(ValueError, match="float32"):
        tchain.chain_kernel(x3, s3, tops.tables())
    with pytest.raises(ValueError, match="n2 <= 128 even"):
        tchain.chain_kernel(torch.zeros(2, 8, 125), s3, tops.tables())
    assert tchain.chain_kernel.launches == launches


@pytest.mark.parametrize("n", [200, 256, 512, 768, 1024, 1152, 2048, 4096,
                               16384])
def test_kernel_takes_only_upper_triangular_ht(n):
    """The natural-order kernel reads, for each band of output columns, the
    rows of H^T up to the band's last column only: the operators' H^T is
    upper-triangular at every kernel size, and the wrapper refuses one that
    is not (also after an in-place change) before any build or launch."""
    tops = tchain.FusedNorthStarOperators(_designs()[1], n,
                                          dtype=torch.float32, device="cpu")
    tables = tops.tables()
    tchain._require_upper(tables.HT)
    ht = tables.HT.clone()
    tchain._require_upper(ht)
    ht[-1, 0] = 1e-30
    with pytest.raises(ValueError, match="upper-triangular"):
        tchain._require_upper(ht)
    x3 = torch.zeros(2, tops.n1, tops.n2)
    s3 = torch.zeros(2, tops.state_dim, tops.n1)
    launches = tchain.chain_kernel.launches
    with pytest.raises(ValueError, match="upper-triangular"):
        tchain.chain_kernel(x3, s3, tables._replace(HT=ht))
    assert tchain.chain_kernel.launches == launches


def test_rejects_unsupported_fft_size():
    _, td = _designs()
    with pytest.raises(ValueError, match="32768"):
        tchain.FusedNorthStarOperators(td, 32768, device="cpu")
    ops = tchain.FusedNorthStarOperators(td, 1000, device="cpu")
    assert (ops.n1, ops.n2) == (8, 125)


@pytest.mark.parametrize("n1,n2,ok", [(8, 128, True), (16, 128, True),
                                      (24, 128, True), (128, 128, True),
                                      (4, 128, True), (12, 128, True),
                                      (136, 128, False), (8, 125, False),
                                      (2, 100, True), (9, 128, True),
                                      (8, 130, False)])
def test_kernel_supports(n1, n2, ok):
    """The frames the CUDA kernel takes: n1 <= 128 rows of n2 <= 128
    samples, n2 even."""
    assert tchain.kernel_supports(n1, n2) is ok


@pytest.mark.parametrize("n", [200, 256, 512, 768, 1152, 1000, 1024, 4096])
def test_kernel_supports_every_even_split(n):
    """The kernel takes every split the JAX fused chain runs half-spectrum:
    it refuses a split only for odd n2 (1000 = 8 * 125), where the JAX
    path raises too."""
    from simpledsp_tpu.kernels.fft import _best_split as jax_best_split
    from simpledsp_tpu_torch.kernels.fft import _best_split
    n1, n2 = _best_split(n)
    assert (n1, n2) == jax_best_split(n)
    assert tchain.kernel_supports(n1, n2) is (n2 % 2 == 0)
    assert (n2 % 2 == 0) is (n != 1000)


def test_northstar_cuda_size_check_matches_jax():
    """Where the CUDA chain refuses an fft_size, so does the JAX fused
    path: no split, or odd n2 with the one-sided spectrum."""
    jd, _ = _designs()
    ops = jchain.FusedNorthStarOperators(jd, 1000, dtype=jnp.float64)
    x = jnp.zeros((1, 1000), jnp.float64)
    with pytest.raises(ValueError, match="even n2"):
        jchain.fused_chain_frames(ops, x, jnp.zeros((1, ops.state_dim)),
                                  half_spectrum=True, interpret=True)


def test_ieee_fp32_pins_and_restores_both_tf32_flags():
    """Matmuls and cuDNN convolutions are both pinned to IEEE float32 and
    both caller settings come back, also after an exception."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    try:
        for mm, conv in ((True, True), (True, False), (False, True)):
            torch.backends.cuda.matmul.allow_tf32 = mm
            torch.backends.cudnn.allow_tf32 = conv
            with pytest.raises(RuntimeError):
                with ieee_fp32():
                    assert torch.backends.cuda.matmul.allow_tf32 is False
                    assert torch.backends.cudnn.allow_tf32 is False
                    raise RuntimeError("inside")
            assert torch.backends.cuda.matmul.allow_tf32 is mm
            assert torch.backends.cudnn.allow_tf32 is conv
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def test_ieee_fp32_overrides_and_restores_the_callers_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with ieee_fp32():
            assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cuda.matmul.allow_tf32 is True
        with pytest.raises(KeyError):
            with ieee_fp32():
                raise KeyError("inside")
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
