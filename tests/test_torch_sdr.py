"""The port's receiver banks against the JAX package's, in float64 on the
CPU.

The JAX banks run as their own tests run them: the fused path with
``use_pallas=True`` and ``_interpret = True`` (Pallas interpret mode), the
XLA path with ``use_pallas=False``.  The port's ``use_kernel=True`` runs the
PFB kernel's plain version here (CPU tensors), ``use_kernel=False`` the
composable ops.  State crosses between the packages through
``simpledsp_tpu_torch.convert``.

Tolerances: audio 1e-10 against JAX (the JAX fused kernel's float64 atan2
polynomial is within 1.2e-12 rad); carried states 1e-10; the port against
itself (streaming, padded entry) 1e-12 or exact where the arithmetic is
the same.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpledsp_tpu.models import sdr as jsdr
from simpledsp_tpu_torch.convert import (prototype_from_branch,
                                         sdr_state_from_numpy,
                                         sdr_state_to_numpy)
from simpledsp_tpu_torch.models import sdr as tsdr

FS = 1.6e6
TOL = 1e-10
KINDS = [("fm", None), ("am", True), ("am", False)]
IDS = ["fm", "am_dc", "am"]


def _jax_bank(kind, remove_dc, fused, **kw):
    if kind == "am":
        kw["remove_dc"] = remove_dc
    cls = jsdr.FMReceiverBank if kind == "fm" else jsdr.AMReceiverBank
    bank = cls(16, fs=FS, dtype=jnp.float64, use_pallas=fused, **kw)
    bank._interpret = fused
    return bank


def _bank(kind, remove_dc, use_kernel, **kw):
    if kind == "am":
        kw["remove_dc"] = remove_dc
    cls = tsdr.FMReceiverBank if kind == "fm" else tsdr.AMReceiverBank
    return cls(16, fs=FS, dtype=torch.float64, device="cpu",
               use_kernel=use_kernel, **kw)


def _iq(rng, t, b=2):
    return rng.standard_normal((b, t)) + 1j * rng.standard_normal((b, t))


def _jax_state_arrays(st):
    return dict(hist_r=np.asarray(st.chan.hist_r),
                hist_i=np.asarray(st.chan.hist_i),
                prev_r=np.asarray(st.demod.prev_r),
                prev_i=np.asarray(st.demod.prev_i),
                audio_hist=np.asarray(st.audio.hist),
                dc=None if st.dc is None else np.asarray(st.dc))


@pytest.mark.parametrize("design", ["kaiser", "remez"])
def test_default_designs_equal_jax_bitwise(design):
    jb = jsdr.FMReceiverBank(16, fs=FS, dtype=jnp.float64, use_pallas=False,
                             design=design)
    tb = tsdr.FMReceiverBank(16, fs=FS, dtype=torch.float64, device="cpu",
                             design=design)
    np.testing.assert_array_equal(tb.chan._branch, jb.chan._branch)
    np.testing.assert_array_equal(tb._ataps, jb._ataps)
    assert tb.fm_gain == jb.fm_gain


@pytest.mark.parametrize("kind,remove_dc", KINDS, ids=IDS)
@pytest.mark.parametrize("use_kernel", [True, False])
def test_bank_matches_jax_with_state_carried_across(kind, remove_dc,
                                                    use_kernel, rng):
    """Call 1 from a fresh state; call 2 from the JAX bank's state after
    call 1, converted; audio and the new state agree with JAX's."""
    jb = _jax_bank(kind, remove_dc, use_kernel, design="remez")
    tb = _bank(kind, remove_dc, use_kernel,
               taps=prototype_from_branch(jb.chan._branch),
               dec_taps=np.asarray(jb._ataps))
    x1, x2 = _iq(rng, 16 * 256), _iq(rng, 16 * 128)
    ja1, js1 = jb(x1)
    ta1, _ = tb(x1)
    np.testing.assert_allclose(ta1.numpy(), np.asarray(ja1), rtol=0, atol=TOL)
    st = sdr_state_from_numpy(**_jax_state_arrays(js1), dtype=torch.float64)
    ta2, ts2 = tb(x2, st)
    ja2, js2 = jb(x2, js1)
    assert ta2.shape == (2, 16, 128 // 4)
    np.testing.assert_allclose(ta2.numpy(), np.asarray(ja2), rtol=0, atol=TOL)
    ours, theirs = sdr_state_to_numpy(ts2), _jax_state_arrays(js2)
    assert ours.keys() == theirs.keys()
    for name, a in ours.items():
        if a is None:
            assert theirs[name] is None
        else:
            np.testing.assert_allclose(a, theirs[name], rtol=0, atol=TOL,
                                       err_msg=name)


@pytest.mark.parametrize("kind,remove_dc", KINDS, ids=IDS)
def test_fused_equals_composable_call_for_call(kind, remove_dc, rng):
    """The kernel path and the composable path give the same audio over a
    chained stream (their AM remove_dc decimator histories differ by
    design, SDRState.dc)."""
    fused = _bank(kind, remove_dc, True)
    plain = _bank(kind, remove_dc, False)
    sf = sp = None
    for t in (16 * 64, 16 * 192, 16 * 4):
        x = _iq(rng, t, 3)
        af, sf = fused(x, sf)
        ap, sp = plain(x, sp)
        np.testing.assert_allclose(af.numpy(), ap.numpy(), rtol=0, atol=1e-12)
        np.testing.assert_array_equal(sf.chan.hist_r.numpy(),
                                      sp.chan.hist_r.numpy())


@pytest.mark.parametrize("kind,remove_dc", [("fm", None), ("am", False)],
                         ids=["fm", "am"])
@pytest.mark.parametrize("use_kernel", [True, False])
def test_two_halves_equal_one_call(kind, remove_dc, use_kernel, rng):
    bank = _bank(kind, remove_dc, use_kernel)
    x = _iq(rng, 16 * 512)
    whole, _ = bank(x)
    h1, st = bank(x[:, : 16 * 256])
    h2, _ = bank(x[:, 16 * 256:], st)
    np.testing.assert_allclose(torch.cat([h1, h2], -1).numpy(), whole.numpy(),
                               rtol=0, atol=1e-12)


def _padded(bank, x, rng):
    front, total = bank.padded_spec(x.shape[-1])
    t = x.shape[-1]
    bufs = []
    for part in (x.real, x.imag):
        buf = rng.standard_normal((x.shape[0], total))  # garbage everywhere
        buf[:, front:front + t] = part
        bufs.append(torch.as_tensor(buf))
    return tuple(bufs)


@pytest.mark.parametrize("kind,remove_dc", KINDS, ids=IDS)
def test_process_padded_equals_call(kind, remove_dc, rng):
    """The padded entry gives __call__'s audio and state exactly: the front
    slot is overwritten with the history and the tail is never read."""
    bank = _bank(kind, remove_dc, True)
    s_ref = s_pad = None
    for _ in range(2):
        x = _iq(rng, 16 * 128)
        ref, s_ref = bank(x, s_ref)
        bufs = _padded(bank, x, rng)
        got, s_pad, planes = bank.process_padded(bufs, s_pad)
        assert planes[0] is bufs[0] and planes[1] is bufs[1]
        assert torch.equal(got, ref)
        for a, b in zip(sdr_state_to_numpy(s_pad).values(),
                        sdr_state_to_numpy(s_ref).values()):
            if a is not None:
                np.testing.assert_array_equal(a, b)
    # The state does not alias the caller's buffers.
    hist = s_pad.chan.hist_r.clone()
    bufs[0].fill_(7.0)
    assert torch.equal(s_pad.chan.hist_r, hist)


@pytest.mark.parametrize("kind,remove_dc", KINDS, ids=IDS)
@pytest.mark.parametrize("t", [16 * 4, 16 * 16, 4096])
def test_call_reads_the_history_in_place_as_process_padded(kind, remove_dc,
                                                          t, rng):
    """__call__, whose kernel reads the carried history and the call's
    planes where they lie, gives process_padded's audio and state bit for
    bit over three chained calls, at T = M decim (below the L-1 history),
    L and 4096; its new channelizer state is the last L-1 samples of
    [hist | x]."""
    bank = _bank(kind, remove_dc, True)
    h = bank.chan.hist_len
    stream = np.zeros((2, h), complex)
    s_call = s_pad = None
    for _ in range(3):
        x = _iq(rng, t)
        got, s_call = bank(x, s_call)
        want, s_pad, _ = bank.process_padded(_padded(bank, x, rng), s_pad)
        assert torch.equal(got, want)
        ours, theirs = sdr_state_to_numpy(s_call), sdr_state_to_numpy(s_pad)
        for name, a in ours.items():
            if a is None:
                assert theirs[name] is None
            else:
                np.testing.assert_array_equal(a, theirs[name], err_msg=name)
        stream = np.concatenate([stream, x], -1)[:, -h:]
        np.testing.assert_array_equal(s_call.chan.hist_r.numpy(), stream.real)
        np.testing.assert_array_equal(s_call.chan.hist_i.numpy(), stream.imag)


def test_padded_entry_refuses_bad_widths(rng):
    bank = _bank("fm", None, True)
    with pytest.raises(ValueError, match="padded width"):
        bank._padded_g(12345)
    front, total = bank.padded_spec(16 * 64)
    z = torch.zeros(2, total + 16, dtype=torch.float64)
    with pytest.raises(ValueError, match="padded width"):
        bank.process_padded((z, z))
    with pytest.raises(ValueError, match="multiple"):
        bank.padded_spec(16 * 63)
    with pytest.raises(ValueError, match="use_kernel"):
        _bank("fm", None, False).padded_spec(16 * 64)


def test_rejects_what_it_cannot_run():
    """No silent fallback: a kernel bank whose M does not divide 128, a
    call length that is not a multiple of M decim, and CUDA where there is
    none all raise."""
    with pytest.raises(ValueError, match="M \\| 128"):
        tsdr.FMReceiverBank(12, fs=FS, dtype=torch.float64, device="cpu",
                            use_kernel=True)
    with pytest.raises(ValueError, match="K <= 32"):
        tsdr.AMReceiverBank(16, fs=FS, taps_per_channel=40, use_kernel=True,
                            device="cpu")
    bank = _bank("fm", None, True)
    with pytest.raises(ValueError, match="M\\*decim"):
        bank(np.zeros((1, 16 * 3), np.complex128))
    assert not tsdr.FMReceiverBank(12, fs=FS, device="cpu").use_kernel
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device='cuda' is valid here")
    for cls in (tsdr.FMReceiverBank, tsdr.AMReceiverBank):
        with pytest.raises(RuntimeError, match="CUDA"):
            cls(16, fs=FS, device="cuda")


@pytest.mark.parametrize("cls", [tsdr.FMReceiverBank, tsdr.AMReceiverBank])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_use_pallas_is_an_alias_of_use_kernel(cls, use_pallas, rng):
    """The JAX package's keyword picks the same path and the same audio;
    both keywords with different values raise."""
    bank = cls(16, FS, use_pallas=use_pallas, dtype=torch.float64,
               device="cpu")
    assert bank.use_kernel is use_pallas
    ref = cls(16, FS, use_kernel=use_pallas, dtype=torch.float64,
              device="cpu")
    x = _iq(rng, 16 * 64)
    assert torch.equal(bank(x)[0], ref(x)[0])
    assert cls(16, FS, use_kernel=use_pallas, use_pallas=use_pallas,
               device="cpu").use_kernel is use_pallas
    with pytest.raises(ValueError, match="use_pallas"):
        cls(16, FS, use_kernel=use_pallas, use_pallas=not use_pallas,
            device="cpu")


@pytest.mark.parametrize("form", ["pair", "complex_tensor", "real"])
def test_input_forms_agree(form, rng):
    bank = _bank("fm", None, True)
    x = _iq(rng, 16 * 32)
    if form == "real":
        x = x.real
        ref, _ = bank((x, np.zeros_like(x)))
        got, _ = bank(x)
    else:
        ref, _ = bank(x)
        arg = ((x.real, x.imag) if form == "pair"
               else torch.as_tensor(x))
        got, _ = bank(arg)
    assert torch.equal(got, ref)
