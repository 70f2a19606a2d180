"""The port's command-line front end (``python -m simpledsp_tpu_torch``) on
the CPU: every case of ``tests/test_cli.py`` with ``--device cpu``; the
same files through both packages' CLIs (float32 on both sides: the arrays
agree to a relative 2e-6 of the largest value); carried-state files that
cross between the two CLIs in both directions; the two parsers; the
padded (kernel-route) rx path, which the CPU reaches only when asked; and
no quiet fallback to the CPU.  Every subprocess has a timeout.
"""

import argparse
import subprocess
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from simpledsp_tpu import cli as jcli
from simpledsp_tpu_torch import cli
from simpledsp_tpu_torch import device as devmod
from simpledsp_tpu_torch.device import resolve_device

REPO = Path(__file__).resolve().parents[1]
CPU = ("--device", "cpu")
# float32 on both sides: of the largest value.  The worst seen on these
# files is 7.5e-7 (the padded route against the plain one), 4.4e-7 between
# the two packages.
REL = 2e-6


def _write_f32_tone(path, freq, fs, n, amp=1.0):
    t = np.arange(n) / fs
    x = (amp * np.sin(2 * np.pi * freq * t)).astype(np.float32)
    x.tofile(path)
    return x


def _write_iq16_fm(path, fs, channels, n, tone_hz=400.0, chan=3,
                   deviation=75e3):
    """FM-modulate a tone onto carrier `chan` (center chan*fs/M) and write
    interleaved int16 IQ."""
    t = np.arange(n) / fs
    phase = 2 * np.pi * chan * (fs / channels) * t + (
        deviation / tone_hz) * np.sin(2 * np.pi * tone_hz * t)
    iq = np.empty(2 * n, dtype=np.int16)
    iq[0::2] = np.round(16384 * np.cos(phase)).astype(np.int16)
    iq[1::2] = np.round(16384 * np.sin(phase)).astype(np.int16)
    iq.tofile(path)


def _write_iq16_band(path, fs, channels, n, seed=0):
    """A carrier in every channel, each with its own AM and FM tones, as
    interleaved int16 IQ: every channel's FM and AM audio is well
    conditioned (a channel with no carrier demodulates quantization
    noise, where float32 against float64 is chance)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / fs
    z = np.zeros(n, complex)
    for c in range(channels):
        env = 1 + 0.5 * np.sin(2 * np.pi * rng.uniform(100, 1500) * t
                               + rng.uniform(0, 2 * np.pi))
        z += env * np.exp(1j * (
            2 * np.pi * (c * fs / channels + rng.uniform(-500, 500)) * t
            + 2.0 * np.sin(2 * np.pi * rng.uniform(100, 1500) * t)
            + rng.uniform(0, 2 * np.pi)))
    z *= 20000 / np.abs(z).max()
    iq = np.empty(2 * n, dtype=np.int16)
    iq[0::2] = np.round(z.real)
    iq[1::2] = np.round(z.imag)
    iq.tofile(path)


def _close(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), err


class TestSpectraCmd:
    FS = 39000.0
    FFT = 4096

    def _run(self, tmp_path, name, infile, extra=(), main=cli.main,
             device=CPU):
        out = tmp_path / f"{name}.npz"
        rc = main(["spectra", "--input", str(infile), "--output", str(out),
                   "--rate", str(self.FS), "--fft", str(self.FFT),
                   "--block-frames", "1", "--design", "lp:8000", *extra,
                   *device])
        assert rc == 0
        return np.load(out)

    def test_tone_recovery_and_state_file(self, tmp_path):
        freq = 2500.0
        infile = tmp_path / "tone.f32"
        _write_f32_tone(infile, freq, self.FS, 3 * self.FFT)
        data = self._run(tmp_path, "spec", infile)
        spec = data["spec_re"] + 1j * data["spec_im"]
        assert spec.shape == (3, self.FFT // 2)
        peak = np.abs(spec[1]).argmax()
        assert abs(peak - round(freq / self.FS * self.FFT)) <= 1
        # carried state saved alongside (resume contract)
        assert (tmp_path / "spec.npz.state.npz").exists()

    def test_resume_equals_continuous(self, tmp_path):
        rng = np.random.default_rng(7)
        x = rng.standard_normal(4 * self.FFT).astype(np.float32)
        whole, a, b = (tmp_path / f"{n}.f32" for n in ("whole", "a", "b"))
        x.tofile(whole)
        x[: 2 * self.FFT].tofile(a)
        x[2 * self.FFT:].tofile(b)
        ref = self._run(tmp_path, "whole", whole)
        p1 = self._run(tmp_path, "p1", a)
        p2 = self._run(tmp_path, "p2", b, extra=(
            "--state", str(tmp_path / "p1.npz.state.npz")))
        for key in ("spec_re", "spec_im"):
            np.testing.assert_array_equal(
                np.concatenate([p1[key], p2[key]], axis=0), ref[key])

    def test_partial_tail_dropped(self, tmp_path):
        """EOF and drain: a trailing partial block is dropped, the full
        blocks are processed."""
        infile = tmp_path / "tail.f32"
        _write_f32_tone(infile, 1000.0, self.FS, 2 * self.FFT + 100)
        assert self._run(tmp_path, "tail", infile)["spec_re"].shape[0] == 2

    def test_no_complete_blocks_is_error(self, tmp_path, capsys):
        infile = tmp_path / "short.f32"
        _write_f32_tone(infile, 1000.0, self.FS, 100)
        rc = cli.main(["spectra", "--input", str(infile), "--output",
                       str(tmp_path / "short.npz"), "--rate", str(self.FS),
                       "--fft", str(self.FFT), "--block-frames", "1", *CPU])
        assert rc == 1
        assert "no complete blocks" in capsys.readouterr().err

    @pytest.mark.parametrize("design", ["notch:42", "lp", "lp:x"])
    def test_unknown_design_is_error(self, tmp_path, capsys, design):
        infile = tmp_path / "x.f32"
        _write_f32_tone(infile, 1000.0, self.FS, self.FFT)
        rc = cli.main(["spectra", "--input", str(infile), "--output",
                       str(tmp_path / "x.npz"), "--rate", str(self.FS),
                       "--design", design, *CPU])
        assert rc == 2
        assert "unknown design" in capsys.readouterr().err

    @pytest.mark.parametrize("design", ["lp:3000", "hp:3000", "bp:5000"])
    def test_matches_the_jax_cli(self, tmp_path, design):
        x = np.random.default_rng(3).standard_normal(3 * self.FFT)
        infile = tmp_path / "n.f32"
        x.astype(np.float32).tofile(infile)
        extra = ("--design", design, "--order", "4", "--q", "2.0")
        mine = self._run(tmp_path, "t", infile, extra)
        theirs = self._run(tmp_path, "j", infile, extra, main=jcli.main,
                           device=())
        assert sorted(mine.files) == sorted(theirs.files)
        for key in ("spec_re", "spec_im"):
            _close(mine[key], theirs[key])
        for key in ("fft", "rate"):
            assert mine[key] == theirs[key]

    @pytest.mark.parametrize("first", ["jax", "port"])
    def test_state_crosses_between_the_clis(self, tmp_path, first):
        """A state saved by one CLI resumes in the other and continues the
        stream to the continuous run's output."""
        x = np.random.default_rng(8).standard_normal(4 * self.FFT)
        x = x.astype(np.float32)
        whole, a, b = (tmp_path / f"{n}.f32" for n in ("whole", "a", "b"))
        x.tofile(whole)
        x[: 2 * self.FFT].tofile(a)
        x[2 * self.FFT:].tofile(b)
        mains = {"jax": (jcli.main, ()), "port": (cli.main, CPU)}
        second = "port" if first == "jax" else "jax"
        ref = self._run(tmp_path, "whole", whole, (), *mains[second])
        p1 = self._run(tmp_path, "p1", a, (), *mains[first])
        p2 = self._run(tmp_path, "p2", b, (
            "--state", str(tmp_path / "p1.npz.state.npz")), *mains[second])
        for key in ("spec_re", "spec_im"):
            _close(np.concatenate([p1[key], p2[key]], axis=0), ref[key])
            # The second half alone depends on the carried state.
            _close(p2[key], ref[key][2:])


class TestRxCmds:
    FS = 256000.0
    M = 16
    DECIM = 4

    def _run(self, tmp_path, name, infile, mode, extra=(), main=cli.main,
             device=CPU):
        out = tmp_path / f"{name}.npz"
        rc = main([f"{mode}-rx", "--input", str(infile), "--output",
                   str(out), "--rate", str(self.FS), "--format", "iq16",
                   "--channels", str(self.M), "--decim", str(self.DECIM),
                   "--block-frames", "16", *extra, *device])
        assert rc == 0
        return np.load(out)

    def test_fm_tone_recovery(self, tmp_path):
        n = 16 * self.M * self.DECIM * 16  # 16 CLI blocks
        infile = tmp_path / "fm.iq16"
        # deviation sized to the 16 kHz channel (Carson BW ~7 kHz)
        _write_iq16_fm(infile, self.FS, self.M, n, tone_hz=500.0, chan=3,
                       deviation=3000.0)
        data = self._run(tmp_path, "fm", infile, "fm",
                         extra=("--deviation", "3000"))
        audio = data["audio"]
        audio_rate = float(data["rate"])
        assert audio.shape == (self.M, n // self.M // self.DECIM)
        assert audio_rate == self.FS / self.M / self.DECIM
        # channel 3 carries a 500 Hz tone; skip the filter warm-up.
        seg = audio[3, 48:]
        spec = np.abs(np.fft.rfft(seg * np.hanning(seg.size)))
        peak = spec[1:].argmax() + 1
        assert abs(peak - 500.0 / audio_rate * seg.size) <= 2
        # the tone dominates its channel's audio band
        others = np.delete(spec[1:], [int(peak) - 2, int(peak) - 1,
                                      int(peak)])
        assert spec[int(peak)] > 3 * others.max()

    def test_am_runs_and_saves_state(self, tmp_path):
        n = 2 * self.M * self.DECIM * 16
        infile = tmp_path / "am.iq16"
        _write_iq16_fm(infile, self.FS, self.M, n)
        data = self._run(tmp_path, "am", infile, "am",
                         extra=("--save-state", str(tmp_path / "am_s.npz")))
        assert data["audio"].shape == (self.M, n // self.M // self.DECIM)
        assert (tmp_path / "am_s.npz").exists()

    @pytest.mark.parametrize("mode", ["fm", "am"])
    def test_resume_equals_continuous(self, tmp_path, mode):
        rng = np.random.default_rng(11)
        n = 4 * self.M * self.DECIM * 16
        iq = (rng.integers(-8000, 8000, 2 * n)).astype(np.int16)
        whole, a, b = (tmp_path / f"{k}.iq16" for k in ("w", "a", "b"))
        iq.tofile(whole)
        iq[: n].tofile(a)       # first n/2 pairs
        iq[n:].tofile(b)
        ref = self._run(tmp_path, "w", whole, mode)
        p1 = self._run(tmp_path, "p1", a, mode)
        p2 = self._run(tmp_path, "p2", b, mode, extra=(
            "--state", str(tmp_path / "p1.npz.state.npz")))
        np.testing.assert_array_equal(
            np.concatenate([p1["audio"], p2["audio"]], axis=-1), ref["audio"])

    @pytest.mark.parametrize("fmt", ["iq16", "iqu8", "f32"])
    @pytest.mark.parametrize("mode", ["fm", "am"])
    def test_matches_the_jax_cli(self, tmp_path, mode, fmt):
        n = 3 * self.M * self.DECIM * 16
        infile = tmp_path / "in.bin"
        if fmt == "iq16":
            _write_iq16_band(infile, self.FS, self.M, n)
        else:
            rng = np.random.default_rng(12)
            raw = (rng.integers(0, 256, 2 * n).astype(np.uint8)
                   if fmt == "iqu8"
                   else rng.standard_normal(n).astype(np.float32))
            raw.tofile(infile)
        extra = ("--format", fmt) + (("--deviation", "3000")
                                     if mode == "fm" else ())
        mine = self._run(tmp_path, "t", infile, mode, extra)
        theirs = self._run(tmp_path, "j", infile, mode, extra,
                           main=jcli.main, device=())
        assert sorted(mine.files) == sorted(theirs.files)
        _close(mine["audio"], theirs["audio"])
        for key in ("rate", "channels"):
            assert mine[key] == theirs[key]

    @pytest.mark.parametrize("first", ["jax", "port"])
    @pytest.mark.parametrize("mode", ["fm", "am"])
    def test_state_crosses_between_the_clis(self, tmp_path, mode, first):
        """The plain route on both sides (the CPU default of both
        packages); the FM state has the None leaf ``dc``."""
        n = 4 * self.M * self.DECIM * 16
        infile = tmp_path / "w.iq16"
        _write_iq16_band(infile, self.FS, self.M, n)
        iq = np.fromfile(infile, dtype=np.int16)
        a, b = tmp_path / "a.iq16", tmp_path / "b.iq16"
        iq[: n].tofile(a)
        iq[n:].tofile(b)
        mains = {"jax": (jcli.main, ()), "port": (cli.main, CPU)}
        second = "port" if first == "jax" else "jax"
        ref = self._run(tmp_path, "w", infile, mode, (), *mains[second])
        p1 = self._run(tmp_path, "p1", a, mode, (), *mains[first])
        p2 = self._run(tmp_path, "p2", b, mode, (
            "--state", str(tmp_path / "p1.npz.state.npz")), *mains[second])
        _close(np.concatenate([p1["audio"], p2["audio"]], axis=-1),
               ref["audio"])
        _close(p2["audio"], ref["audio"][:, n // self.M // self.DECIM // 2:])

    @pytest.mark.parametrize("mode", ["fm", "am"])
    def test_one_carrier_file_against_float64(self, tmp_path, mode):
        """tests/test_cli.py's capture, one FM carrier on channel 3, through
        both CLIs against the port's float64 composable bank over the same
        blocks.  Each CLI's channel 3, and every AM channel, are held to
        the bank bar (PERF.md section 2): max |err| <= max(1.5e-6 max(1,
        scale), 2 x the JAX CLI's own).  The other FM channels demodulate
        quantization noise, where float32 against float64 is chance in
        both packages (errors near 1e-3), so they are only checked finite."""
        from simpledsp_tpu_torch.models import sdr
        from simpledsp_tpu_torch.runtime import iq16_to_planes

        n = 8 * self.M * self.DECIM * 16
        infile = tmp_path / "one.iq16"
        _write_iq16_fm(infile, self.FS, self.M, n, tone_hz=500.0,
                       deviation=3000.0)
        extra = ("--deviation", "3000") if mode == "fm" else ()
        mine = self._run(tmp_path, "t", infile, mode, extra)["audio"]
        theirs = self._run(tmp_path, "j", infile, mode, extra,
                           main=jcli.main, device=())["audio"]
        re, im = iq16_to_planes(np.fromfile(infile, dtype=np.int16))
        cls = sdr.FMReceiverBank if mode == "fm" else sdr.AMReceiverBank
        kw = {"deviation_hz": 3000.0} if mode == "fm" else {}
        bank = cls(self.M, self.FS, decim=self.DECIM, dtype=torch.float64,
                   device="cpu", **kw)
        blk, st, ref = self.M * self.DECIM * 16, None, []
        for i in range(0, n, blk):
            a, st = bank((re[None, i:i + blk].astype(np.float64),
                          im[None, i:i + blk].astype(np.float64)), st)
            ref.append(a[0].numpy())
        ref = np.concatenate(ref, axis=-1)
        assert np.isfinite(mine).all() and mine.shape == ref.shape
        for c in ([3] if mode == "fm" else range(self.M)):
            err = np.abs(mine[c] - ref[c]).max()
            own = np.abs(theirs[c] - ref[c]).max()
            assert err <= max(1.5e-6 * max(1.0, np.abs(ref[c]).max()),
                              2 * own), (c, err, own)

    @pytest.mark.parametrize("mode", ["fm", "am"])
    def test_padded_kernel_route(self, tmp_path, monkeypatch, mode):
        """The route a CUDA bank takes (process_padded through
        padded_spec), here on the PFB kernel's plain version: the plain
        route's audio, and resume equal bit for bit within the route."""
        from simpledsp_tpu_torch.models import sdr
        n = 4 * self.M * self.DECIM * 16
        infile = tmp_path / "w.iq16"
        _write_iq16_band(infile, self.FS, self.M, n)
        iq = np.fromfile(infile, dtype=np.int16)
        a, b = tmp_path / "a.iq16", tmp_path / "b.iq16"
        iq[: n].tofile(a)
        iq[n:].tofile(b)
        plain = self._run(tmp_path, "plain", infile, mode)
        calls = []
        # The route the CLI picks on a card for M = 16, K = 16.
        monkeypatch.setattr(cli, "bank_route", lambda *a: "kernel")
        real = sdr.FMReceiverBank.process_padded
        monkeypatch.setattr(sdr.FMReceiverBank, "process_padded",
                            lambda self, *a: calls.append(1) or real(self, *a))
        ref = self._run(tmp_path, "w", infile, mode)
        assert len(calls) == 4
        _close(ref["audio"], plain["audio"])
        p1 = self._run(tmp_path, "p1", a, mode)
        p2 = self._run(tmp_path, "p2", b, mode, extra=(
            "--state", str(tmp_path / "p1.npz.state.npz")))
        np.testing.assert_array_equal(
            np.concatenate([p1["audio"], p2["audio"]], axis=-1), ref["audio"])


def test_bad_subcommand_exits():
    with pytest.raises(SystemExit):
        cli.main(["frobnicate"])


@pytest.mark.parametrize("frames", ["0", "-3"])
def test_block_frames_must_be_positive(tmp_path, frames):
    with pytest.raises(SystemExit):
        cli.main(["spectra", "--input", str(tmp_path / "x"), "--output",
                  str(tmp_path / "o.npz"), "--rate", "1000",
                  "--block-frames", frames, *CPU])


@pytest.mark.parametrize("nbytes", [1000, 6 << 20])
def test_raw_blocks_are_the_file_in_order(tmp_path, nbytes):
    """Whole blocks in file order, the tail dropped; a block larger than
    the default 4 MB ring too."""
    data = np.random.default_rng(5).integers(0, 256, 2 * nbytes + nbytes // 2,
                                             dtype=np.uint8)
    path = tmp_path / "raw.bin"
    data.tofile(path)
    blocks = list(cli._raw_blocks(str(path), nbytes))
    assert [b.size for b in blocks] == [nbytes, nbytes]
    np.testing.assert_array_equal(np.concatenate(blocks), data[:2 * nbytes])


def test_missing_input_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        cli.main(["spectra", "--input", str(tmp_path / "none.f32"),
                  "--output", str(tmp_path / "o.npz"), "--rate", "39000",
                  *CPU])


class TestMfccCmd:
    FS = 16000.0

    def _run(self, tmp_path, name, src, extra=(), main=cli.main, device=CPU):
        out = tmp_path / f"{name}.npz"
        rc = main(["mfcc", "--input", str(src), "--output", str(out),
                   "--rate", str(self.FS), "--fft", "512", "--mels", "40",
                   "--coeffs", "13", "--block-frames", "16", *extra,
                   *device])
        assert rc == 0
        return np.load(str(out))

    def test_tone_features_and_frame_count(self, tmp_path):
        """i16 PCM tone -> streaming MFCC; the frame count of the
        zero-history streaming framing, and a steady c0 after warm-up."""
        n = 16384
        t = np.arange(n) / self.FS
        x = np.round(20000 * np.sin(2 * np.pi * 1000.0 * t)).astype(np.int16)
        src = tmp_path / "tone.pcm"
        x.tofile(src)
        feats = self._run(tmp_path, "feat", src)["mfcc"]
        # block = hop*16 = 4096 -> 4 blocks; each yields
        # (hist 256 + 4096 - 512)//256 + 1 = 16 frames.
        assert feats.shape == (64, 13)
        assert np.all(np.isfinite(feats))
        c0 = feats[2:, 0]
        assert np.std(c0) < 0.05 * np.abs(np.mean(c0)) + 1e-6

    def test_bad_hop_is_error(self, tmp_path):
        src = tmp_path / "x.pcm"
        np.zeros(1024, np.int16).tofile(src)
        rc = cli.main(["mfcc", "--input", str(src), "--output",
                       str(tmp_path / "o.npz"), "--rate", "16000",
                       "--fft", "512", "--hop", "100", *CPU])
        assert rc == 2

    def test_empty_file_is_error(self, tmp_path):
        src = tmp_path / "empty.pcm"
        src.write_bytes(b"")
        rc = cli.main(["mfcc", "--input", str(src), "--output",
                       str(tmp_path / "o.npz"), "--rate", "16000", *CPU])
        assert rc == 1

    @pytest.mark.parametrize("fmt,hop", [("i16", None), ("f32", "128"),
                                         ("i16", "512")])
    def test_matches_the_jax_cli(self, tmp_path, fmt, hop):
        rng = np.random.default_rng(13)
        x = rng.standard_normal(3 * 4096 + 77) * 0.3
        src = tmp_path / "x.pcm"
        (np.round(x * 20000).astype(np.int16) if fmt == "i16"
         else x.astype(np.float32)).tofile(src)
        extra = ("--format", fmt) + (("--hop", hop) if hop else ())
        mine = self._run(tmp_path, "t", src, extra)
        theirs = self._run(tmp_path, "j", src, extra, main=jcli.main,
                           device=())
        assert sorted(mine.files) == sorted(theirs.files)
        _close(mine["mfcc"], theirs["mfcc"])
        for key in ("rate", "fft", "hop", "mels"):
            assert mine[key] == theirs[key]


class TestModemSim:
    def _run(self, tmp_path, name, main=cli.main, device=CPU,
             extra=("--constellation", "qpsk", "--ebn0", "2:6:2",
                    "--symbols", "8000")):
        out = tmp_path / f"{name}.npz"
        assert main(["modem-sim", *extra, "--output", str(out),
                     *device]) == 0
        return np.load(str(out))

    def test_ber_sweep_decreases_and_saves(self, tmp_path, capsys):
        z = self._run(tmp_path, "ber")
        lines = [ln for ln in capsys.readouterr().out.splitlines()
                 if ln.startswith("{")]
        assert len(lines) == 3
        b = z["ber"]
        assert b[0] > b[1] > b[2] > 0          # monotone in Eb/N0
        # 4 dB point within a loose statistical band of theory (1.25e-2)
        assert 0.5e-2 < b[1] < 2.5e-2

    @pytest.mark.parametrize("const", ["bpsk", "qpsk", "qam16", "qam64"])
    def test_same_record_as_the_jax_cli(self, tmp_path, const):
        """The same keys, shapes and Eb/N0 points; the noise differs in
        its bits, so the BERs agree within the statistics."""
        extra = ("--constellation", const, "--ebn0", "0:4:2", "--symbols",
                 "6000")
        mine = self._run(tmp_path, "t", extra=extra)
        theirs = self._run(tmp_path, "j", main=jcli.main, device=(),
                           extra=extra)
        assert sorted(mine.files) == sorted(theirs.files)
        for key in mine.files:
            assert mine[key].shape == theirs[key].shape
        for key in ("ebn0_db", "constellation", "bits_per_point"):
            np.testing.assert_array_equal(mine[key], theirs[key])
        bits = int(mine["bits_per_point"])
        sigma = np.sqrt(theirs["ber"] * (1 - theirs["ber"]) / bits)
        assert np.all(np.abs(mine["ber"] - theirs["ber"])
                      <= 6 * sigma * np.sqrt(2) + 2.0 / bits)


def _parser_of(main):
    """The argparse parser ``main`` builds, caught at its parse_args."""
    class Caught(Exception):
        pass

    caught = []

    def grab(self, *args, **kwargs):
        caught.append(self)
        raise Caught

    with mock.patch.object(argparse.ArgumentParser, "parse_args", grab):
        with pytest.raises(Caught):
            main([])
    return caught[0]


def _commands(parser):
    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))
    return {name: {a.dest: (tuple(a.option_strings), a.default, a.choices,
                            a.required, a.nargs)
                   for a in sp._actions if a.dest != "help"}
            for name, sp in sub.choices.items()}


def test_parsers_have_the_same_commands_and_options():
    """Exactly the JAX parser's commands, ``bench`` included, each with
    the same options, defaults and choices, plus the port's
    ``--device``."""
    mine = _commands(cli.build_parser())
    theirs = _commands(_parser_of(jcli.main))
    assert set(mine) == set(theirs)
    for name, opts in mine.items():
        assert opts.pop("device") == (("--device",), None, None, False, None)
        assert opts == theirs[name], name


_COMMANDS = {
    "spectra": ["spectra", "--input", "x.f32", "--output", "o.npz",
                "--rate", "39000"],
    "fm-rx": ["fm-rx", "--input", "x.iq", "--output", "o.npz", "--rate",
              "1e6"],
    "am-rx": ["am-rx", "--input", "x.iq", "--output", "o.npz", "--rate",
              "1e6"],
    "mfcc": ["mfcc", "--input", "x.pcm", "--output", "o.npz", "--rate",
             "16000"],
    "modem-sim": ["modem-sim", "--symbols", "1000"],
    "bench": ["bench"],
}


@pytest.mark.parametrize("cmd", sorted(_COMMANDS))
def test_no_quiet_fallback_to_the_cpu(capsys, cmd):
    """Without CUDA and without --device, a command exits non-zero with
    resolve_device's message, and runs nothing."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError) as e:
        resolve_device(None)
    assert cli.main(_COMMANDS[cmd]) == 2
    err = capsys.readouterr().err
    assert str(e.value) in err and "--device cpu" in err


@pytest.mark.parametrize("device", ["cuda", "cuda:0", "tpu"])
def test_named_device_that_is_missing_is_an_error(capsys, device):
    if torch.cuda.is_available() and device.startswith("cuda"):
        pytest.skip("this machine has CUDA")
    assert cli.main([*_COMMANDS["modem-sim"], "--device", device]) == 2
    assert device in capsys.readouterr().err


def _python_m(args, timeout=240):
    return subprocess.run([sys.executable, "-m", "simpledsp_tpu_torch",
                           *args], cwd=REPO, capture_output=True, text=True,
                          timeout=timeout)


def test_python_m_entry_point(tmp_path):
    """``python -m simpledsp_tpu_torch`` runs a command to the in-process
    run's bits, and refuses without --device where there is no card."""
    infile = tmp_path / "tone.f32"
    _write_f32_tone(infile, 2500.0, 39000.0, 2 * 4096)
    args = ["spectra", "--input", str(infile), "--rate", "39000",
            "--block-frames", "1"]
    proc = _python_m([*args, "--output", str(tmp_path / "sub.npz"), *CPU])
    assert proc.returncode == 0, proc.stderr
    assert "spectra: 2 frames of 4096" in proc.stdout
    assert cli.main([*args, "--output", str(tmp_path / "in.npz"), *CPU]) == 0
    sub, inproc = np.load(tmp_path / "sub.npz"), np.load(tmp_path / "in.npz")
    for key in ("spec_re", "spec_im"):
        np.testing.assert_array_equal(sub[key], inproc[key])
    if not torch.cuda.is_available():
        proc = _python_m([*args, "--output", str(tmp_path / "x.npz")])
        assert proc.returncode == 2
        assert "CUDA is not available" in proc.stderr
        assert not (tmp_path / "x.npz").exists()


# -- the route the CLI picks for a size ------------------------------------

CUDA = torch.device("cuda")   # a device name only: no card is touched


@pytest.mark.parametrize("fft,route", [(4096, "kernel"), (1024, "kernel"),
                                       (200, "kernel"), (32768, "plain"),
                                       (65536, "plain"), (1000, "plain")])
def test_chain_route_follows_the_kernel_sizes(fft, route):
    """"kernel" exactly where the CUDA chain kernel takes the size (a
    split n1 x n2 <= 128 x 128 with n2 even), on a CUDA device."""
    assert cli.chain_route(fft, CUDA) == route
    assert cli.chain_route(fft, "cuda:0") == route


@pytest.mark.parametrize("m,k,route", [(16, 16, "kernel"), (8, 16, "kernel"),
                                       (32, 32, "kernel"), (12, 16, "plain"),
                                       (256, 16, "plain"), (16, 33, "plain")])
def test_bank_route_follows_the_kernel_sizes(m, k, route):
    assert cli.bank_route(m, k, CUDA) == route


@pytest.mark.parametrize("device", ["cpu", torch.device("cpu")])
def test_routes_on_the_cpu_are_plain(device):
    assert cli.chain_route(4096, device) == "plain"
    assert cli.bank_route(16, 16, device) == "plain"


def test_plain_route_on_the_card_is_said_on_stderr(tmp_path, monkeypatch,
                                                   capsys):
    """A size the kernel does not take builds the model with
    use_kernel=False and says so in one stderr line naming the size; a size
    it takes builds the kernel route and says nothing.  The models are
    recorded, not run: there is no card here."""
    from simpledsp_tpu_torch.models import northstar, sdr
    built = []

    class Stop(Exception):
        pass

    def record(*args, **kw):
        built.append(kw.get("use_kernel"))
        raise Stop

    monkeypatch.setattr(northstar, "NorthStarChain", record)
    monkeypatch.setattr(sdr, "FMReceiverBank", record)
    monkeypatch.setattr(devmod, "resolve_device", lambda d: CUDA)
    runs = [(["spectra", "--fft", "32768"], False, "--fft 32768"),
            (["spectra", "--fft", "4096"], True, None),
            (["fm-rx", "--channels", "12"], False, "--channels 12"),
            (["fm-rx", "--channels", "16"], True, None)]
    for argv, kernel, said in runs:
        with pytest.raises(Stop):
            cli.main([argv[0], "--input", "x", "--output", "o.npz",
                      "--rate", "1e6", *argv[1:]])
        assert built[-1] is kernel
        err = capsys.readouterr().err
        if said is None:
            assert err == ""
        else:
            assert len(err.strip().splitlines()) == 1
            assert said in err and "plain PyTorch route on cuda" in err


@pytest.mark.parametrize("cmd", ["spectra", "fm-rx"])
def test_sizes_without_a_kernel_match_the_jax_cli(tmp_path, cmd):
    """spectra --fft 32768 and fm-rx --channels 12, the sizes the port's
    kernels do not take, on the port's plain route against the JAX CLI's
    composable path (float32 on both sides)."""
    infile = tmp_path / "in.bin"
    if cmd == "spectra":
        x = np.random.default_rng(16).standard_normal(3 * 32768)
        x.astype(np.float32).tofile(infile)
        argv = ["spectra", "--input", str(infile), "--rate", "39000",
                "--fft", "32768", "--block-frames", "1"]
    else:
        fs = 12 * 16e3
        _write_iq16_band(infile, fs, 12, 3 * 12 * 4 * 16)
        argv = ["fm-rx", "--input", str(infile), "--rate", str(fs),
                "--channels", "12", "--block-frames", "16",
                "--deviation", "3000"]
    assert cli.main([*argv, "--output", str(tmp_path / "t.npz"), *CPU]) == 0
    assert jcli.main([*argv, "--output", str(tmp_path / "j.npz")]) == 0
    mine, theirs = np.load(tmp_path / "t.npz"), np.load(tmp_path / "j.npz")
    assert sorted(mine.files) == sorted(theirs.files)
    for key in mine.files:
        _close(mine[key], theirs[key])
