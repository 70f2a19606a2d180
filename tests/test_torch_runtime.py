"""The port's native streaming runtime (``simpledsp_tpu_torch.runtime``):
every case of ``tests/test_runtime.py`` on the port, the converters against
the JAX package's runtime on the same raw bytes (equal bits), and the
build: into the port's ``build/`` under a hashed name, never into
``native/build``, safe when several processes build at once, and a failed
build raises with the compiler's output.

Every wait in these tests has a timeout.
"""

import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from simpledsp_tpu import runtime as jrt
from simpledsp_tpu_torch.kernels import _build
from simpledsp_tpu_torch.runtime import (
    FileSink,
    FileSource,
    RingBuffer,
    f32_to_i16,
    i16_to_f32,
    iq16_to_planes,
    iqu8_to_planes,
)
from simpledsp_tpu_torch.runtime import stream

REPO = Path(__file__).resolve().parents[1]


class TestRingBuffer:
    def test_push_pop_roundtrip(self, rng):
        r = RingBuffer(1 << 16)
        data = rng.integers(0, 256, 5000, dtype=np.uint8)
        assert r.push(data) == 5000
        np.testing.assert_array_equal(r.pop(5000), data)
        r.close()

    def test_wraparound(self, rng):
        r = RingBuffer(1 << 12)  # 4096
        for _ in range(10):  # push/pop 3000 repeatedly to force wrap
            data = rng.integers(0, 256, 3000, dtype=np.uint8)
            assert r.push(data) == 3000
            np.testing.assert_array_equal(r.pop(3000), data)
        r.close()

    def test_backpressure(self, rng):
        r = RingBuffer(1024)
        data = rng.integers(0, 256, 2000, dtype=np.uint8)
        assert r.push(data) == 1024  # capacity-limited, no overwrite
        np.testing.assert_array_equal(r.pop(4096), data[:1024])
        r.close()

    def test_capacity_rounds_up_to_a_power_of_two(self):
        r = RingBuffer(1000)
        assert r.capacity == 1024
        assert r.readable == 0
        r.close()

    def test_threaded_producer_consumer(self, rng):
        r = RingBuffer(1 << 14)
        total = 1 << 20
        src = rng.integers(0, 256, total, dtype=np.uint8)
        got = []
        deadline = time.monotonic() + 30.0

        def producer():
            off = 0
            while off < total and time.monotonic() < deadline:
                off += r.push(src[off:off + 4096])

        th = threading.Thread(target=producer)
        th.start()
        read = 0
        while read < total:
            blk = r.pop_exact(8192, timeout=10.0)
            assert blk is not None, "consumer timed out"
            got.append(blk)
            read += blk.size
        th.join(timeout=10.0)
        assert not th.is_alive()
        np.testing.assert_array_equal(np.concatenate(got), src)
        r.close()

    def test_pop_exact_timeout_keeps_bytes_in_order(self, rng):
        r = RingBuffer(1 << 12)
        data = rng.integers(0, 256, 300, dtype=np.uint8)
        r.push(data[:100])
        assert r.pop_exact(200, timeout=0.01) is None
        r.push(data[100:])
        np.testing.assert_array_equal(r.pop_exact(300, timeout=1.0), data)
        r.close()


class TestConverters:
    def test_iq16(self, rng):
        raw = rng.integers(-32768, 32768, 2048, dtype=np.int16)
        re, im = iq16_to_planes(raw)
        np.testing.assert_allclose(re, raw[0::2] / 32768.0, rtol=1e-6)
        np.testing.assert_allclose(im, raw[1::2] / 32768.0, rtol=1e-6)

    def test_iqu8(self, rng):
        raw = rng.integers(0, 256, 2048, dtype=np.uint8)
        re, im = iqu8_to_planes(raw)
        np.testing.assert_allclose(re, (raw[0::2] - 127.5) / 127.5,
                                   rtol=1e-5, atol=1e-6)

    def test_i16_f32_roundtrip(self, rng):
        x = np.clip(rng.standard_normal(4096) * 0.3, -0.99,
                    0.99).astype(np.float32)
        back = i16_to_f32(f32_to_i16(x), scale=1.0 / 32767.0)
        np.testing.assert_allclose(back, x, atol=1.1 / 32767.0)

    def test_f32_i16_clamps(self):
        i = f32_to_i16(np.array([2.0, -2.0, 0.0], dtype=np.float32))
        assert i[0] == 32767 and i[1] == -32768 and i[2] == 0


# The converters against the JAX package's runtime on the same raw bytes:
# serial and threaded, at a small size and at one above the threaded
# entry's 1 MB-a-thread floor, with non-default scales too.
_CASES = [(n, threads) for n in (4096, 3_000_000) for threads in (1, 0, 4)]


@pytest.mark.parametrize("n,threads", _CASES)
def test_iq16_gives_the_jax_runtime_bits(rng, n, threads):
    raw = rng.integers(-32768, 32768, 2 * n, dtype=np.int16)
    for scale in (1.0 / 32768.0, 1.0 / 32000.0):
        got = iq16_to_planes(raw, scale, threads=threads)
        want = jrt.iq16_to_planes(raw, scale, threads=threads)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.float32
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n,threads", _CASES)
def test_iqu8_gives_the_jax_runtime_bits(rng, n, threads):
    raw = rng.integers(0, 256, 2 * n, dtype=np.uint8)
    for scale in (1.0 / 127.5, 1.0 / 128.0):
        got = iqu8_to_planes(raw, scale, threads=threads)
        want = jrt.iqu8_to_planes(raw, scale, threads=threads)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n,threads", _CASES)
def test_i16_f32_gives_the_jax_runtime_bits(rng, n, threads):
    raw = rng.integers(-32768, 32768, n, dtype=np.int16)
    for scale in (1.0 / 32768.0, 1.0 / 32767.0):
        np.testing.assert_array_equal(
            i16_to_f32(raw, scale, threads=threads),
            jrt.i16_to_f32(raw, scale, threads=threads))


@pytest.mark.parametrize("n,threads", _CASES)
def test_f32_i16_gives_the_jax_runtime_bits(rng, n, threads):
    x = (rng.standard_normal(n) * 1.5).astype(np.float32)  # some clamp
    for scale in (32767.0, 1000.0):
        got = f32_to_i16(x, scale, threads=threads)
        assert got.dtype == np.int16
        np.testing.assert_array_equal(
            got, jrt.f32_to_i16(x, scale, threads=threads))


class TestFileSource:
    def test_streams_file_through_ring(self, tmp_path, rng):
        data = rng.integers(0, 256, 300_000, dtype=np.uint8)
        path = tmp_path / "stream.bin"
        path.write_bytes(data.tobytes())
        ring = RingBuffer(1 << 14)
        got = []
        with FileSource(path, ring, chunk=4096):
            read = 0
            while read < data.size:
                blk = ring.pop_exact(10_000, timeout=10.0)
                assert blk is not None
                got.append(blk)
                read += blk.size
        np.testing.assert_array_equal(np.concatenate(got), data)
        ring.close()

    def test_missing_file_raises(self):
        ring = RingBuffer(1024)
        with pytest.raises(FileNotFoundError):
            FileSource("/nonexistent/nope.bin", ring)
        ring.close()

    def test_state_reaches_eof(self, tmp_path):
        path = tmp_path / "small.bin"
        path.write_bytes(b"\x01" * 100)
        ring = RingBuffer(1 << 12)
        with FileSource(path, ring) as src:
            deadline = time.monotonic() + 10.0
            while src.state == FileSource.RUNNING:
                assert time.monotonic() < deadline
                time.sleep(0.001)
            assert src.state == FileSource.EOF
        assert ring.readable == 100
        ring.close()

    def test_end_to_end_iq_file_to_fm_receiver(self, tmp_path):
        """File of int16 IQ -> native ring -> RI planes -> the port's FM
        receiver (float64, on the CPU): the tone comes out."""
        from simpledsp_tpu_torch.models.sdr import FMReceiverBank

        fs, m, decim = 256e3, 8, 2
        T = 8192
        t = np.arange(T) / fs
        ftone, dev = 400.0, 2e3
        iq = 0.9 * np.exp(1j * (2 * np.pi * (2 * fs / m) * t
                                + dev / ftone * np.sin(2 * np.pi * ftone * t)))
        raw = np.empty(2 * T, dtype=np.int16)
        raw[0::2] = np.round(iq.real * 32000)
        raw[1::2] = np.round(iq.imag * 32000)
        path = tmp_path / "iq.bin"
        path.write_bytes(raw.tobytes())

        ring = RingBuffer(1 << 18)
        blocks = []
        block_pairs = 2048
        with FileSource(path, ring, chunk=8192):
            read = 0
            while read < T:
                blk = ring.pop_exact(block_pairs * 4, dtype=np.int16,
                                     timeout=10.0)
                assert blk is not None
                blocks.append(iq16_to_planes(blk, scale=1.0 / 32000.0))
                read += block_pairs
        ring.close()

        rx = FMReceiverBank(m, fs, decim=decim, deviation_hz=dev,
                            dtype=torch.float64, device="cpu")
        state = None
        audio = []
        for re, im in blocks:
            a, state = rx((re[None, :], im[None, :]), state)
            audio.append(a.numpy())
        a = np.concatenate(audio, axis=-1)[0, 2][50:]
        arate = fs / m / decim
        spec = np.abs(np.fft.rfft(a * np.hanning(a.size)))
        peak = np.fft.rfftfreq(a.size, 1 / arate)[np.argmax(spec)]
        assert abs(peak - ftone) < 3 * arate / a.size, peak


class TestPopAlignment:
    def test_partial_pop_keeps_split_elements(self, rng):
        """A pop that lands mid-element must not crash or drop bytes: the
        partial element is returned by the next pop."""
        r = RingBuffer(1 << 12)
        data = rng.integers(-1000, 1000, 600, dtype=np.int16)
        raw = data.tobytes()
        r.push(np.frombuffer(raw[:101], dtype=np.uint8))  # odd byte count
        first = r.pop(200, dtype=np.int16)
        assert first.size == 50  # 100 bytes -> 50 elements, 1 byte pending
        r.push(np.frombuffer(raw[101:], dtype=np.uint8))
        rest = r.pop(len(raw), dtype=np.int16)
        np.testing.assert_array_equal(np.concatenate([first, rest]), data)
        r.close()


class TestMultithreadedConverters:
    """The threaded converters give the serial loops' bits at any thread
    count (the < 1 MB serial fallback included)."""

    def test_iq16_mt_matches_serial(self, rng):
        raw = rng.integers(-32768, 32768, size=2_000_000, dtype=np.int16)
        re1, im1 = iq16_to_planes(raw, threads=1)
        for threads in (0, 2, 4):
            re, im = iq16_to_planes(raw, threads=threads)
            assert np.array_equal(re, re1)
            assert np.array_equal(im, im1)

    def test_iqu8_mt_matches_serial(self, rng):
        raw = rng.integers(0, 256, size=3_000_000, dtype=np.uint8)
        re1, im1 = iqu8_to_planes(raw, threads=1)
        re4, im4 = iqu8_to_planes(raw, threads=4)
        assert np.array_equal(re4, re1)
        assert np.array_equal(im4, im1)

    def test_i16_f32_mt_small_block_serial_fallback(self, rng):
        raw = rng.integers(-100, 100, size=777, dtype=np.int16)
        assert np.array_equal(i16_to_f32(raw, threads=8),
                              i16_to_f32(raw, threads=1))

    def test_f32_i16_mt_matches_serial(self, rng):
        x = rng.standard_normal(1_500_000).astype(np.float32) * 2.0
        assert np.array_equal(f32_to_i16(x, threads=4),
                              f32_to_i16(x, threads=1))


class TestFileSink:
    def test_drains_ring_to_file(self, tmp_path, rng):
        data = rng.integers(0, 256, size=300_000, dtype=np.uint8)
        ring = RingBuffer(1 << 16)
        path = tmp_path / "out.bin"
        deadline = time.monotonic() + 30.0
        with FileSink(path, ring):
            off = 0
            while off < data.size:
                assert time.monotonic() < deadline
                off += ring.push(data[off:off + 30_000])
            # stop() (via __exit__) must drain the remainder.
        assert np.array_equal(np.fromfile(path, dtype=np.uint8), data)
        ring.close()

    def test_written_count_and_stop_return(self, tmp_path, rng):
        data = rng.integers(0, 256, size=65_536, dtype=np.uint8)
        ring = RingBuffer(1 << 20)
        sink = FileSink(tmp_path / "w.bin", ring)
        assert sink.state == FileSink.RUNNING
        ring.push(data)
        assert sink.stop() == data.size
        assert sink.stop() == 0  # a second stop is a no-op
        ring.close()

    def test_source_to_sink_pipeline(self, tmp_path, rng):
        """file -> FileSource -> ring -> FileSink -> file copies exactly."""
        src_path = tmp_path / "src.bin"
        dst_path = tmp_path / "dst.bin"
        data = rng.integers(0, 256, size=200_000, dtype=np.uint8)
        data.tofile(src_path)
        ring = RingBuffer(1 << 14)
        sink = FileSink(dst_path, ring)
        with FileSource(src_path, ring) as src:
            deadline = time.monotonic() + 10.0
            while src.state == FileSource.RUNNING:
                assert time.monotonic() < deadline
                time.sleep(0.001)
        sink.stop()
        assert np.array_equal(np.fromfile(dst_path, dtype=np.uint8), data)
        ring.close()

    def test_bad_path_raises(self):
        ring = RingBuffer(1 << 12)
        with pytest.raises(OSError):
            FileSink("/nonexistent-dir/x.bin", ring)
        ring.close()


class TestBuild:
    def test_library_lives_in_the_port_build_dir(self):
        stream.load_library()
        built = sorted(_build.BUILD_DIR.glob("libsdsp_io-*.so"))
        assert built, "no libsdsp_io-<hash>.so under build/"
        assert _build.BUILD_DIR == REPO / "build"
        assert "sdsp_io" in _build.build_seconds

    def test_build_goes_to_a_hashed_name_not_native_build(self, tmp_path,
                                                          monkeypatch):
        monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
        path = _build.build_shared("sdsp_io", stream._gxx, stream.GXX_FLAGS,
                                   [stream.SOURCE], salt=stream._target())
        assert path.parent == tmp_path / "build"
        assert path.name.startswith("libsdsp_io-") and path.suffix == ".so"
        assert _build.build_seconds["sdsp_io"] > 0.0
        # A second call finds it and does not build.
        assert _build.build_shared("sdsp_io", stream._gxx, stream.GXX_FLAGS,
                                   [stream.SOURCE],
                                   salt=stream._target()) == path
        assert _build.build_seconds["sdsp_io"] == 0.0
        # Another target (the salt) gets another name.
        other = _build.build_shared("sdsp_io", stream._gxx, stream.GXX_FLAGS,
                                    [stream.SOURCE], salt=b"another host")
        assert other != path
        # The JAX package's make target is native/build/libsdsp_io.so; the
        # port's hashed names never appear there.
        assert not list((REPO / "native" / "build").glob("libsdsp_io-*"))

    def test_concurrent_builds_all_see_a_whole_library(self, tmp_path,
                                                       monkeypatch):
        monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
        src = tmp_path / "tiny.cpp"
        src.write_text('extern "C" int sdsp_tiny(int x) { return 3 * x; }\n')
        paths, errors = [], []

        def build():
            try:
                paths.append(_build.build_shared(
                    "tiny", stream._gxx, stream.GXX_FLAGS, [src]))
            except Exception as e:  # noqa: BLE001 - checked below
                errors.append(e)

        threads = [threading.Thread(target=build) for _ in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120.0)
        assert not any(th.is_alive() for th in threads)
        assert not errors, errors
        assert len(set(paths)) == 1 and len(paths) == 4
        import ctypes
        assert ctypes.CDLL(str(paths[0])).sdsp_tiny(14) == 42
        assert [p.name for p in tmp_path.iterdir()
                if p.suffix == ".so"] == [paths[0].name]

    def test_failed_build_raises_with_compiler_output(self, tmp_path,
                                                      monkeypatch):
        monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
        src = tmp_path / "broken.cpp"
        src.write_text("int sdsp_broken( { return 0; }\n")
        with pytest.raises(RuntimeError, match="broken.cpp"):
            _build.build_shared("broken", stream._gxx, stream.GXX_FLAGS,
                                [src])
        assert not list(tmp_path.glob("*.so"))

    def test_missing_compiler_raises(self, monkeypatch):
        monkeypatch.setattr(stream.shutil, "which", lambda name: None)
        with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
            stream._gxx()
