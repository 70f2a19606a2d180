"""The port's parallel layer on gloo CPU ranks against the JAX package's.

Every case of ``tests/test_parallel.py`` and the sharded chain cases of
``tests/test_models.py`` (:103-158) runs in the port on a mesh of 8 CPU
processes, (dp, sp) = (2, 4) and (1, 8), and is held against the same JAX
call on the same mesh shape of the 8 virtual devices (``conftest.py``), on
the same inputs, at the JAX test's tolerance.  One launch of 8 ranks a
mesh shape runs every case of that shape (a module fixture); each case is
then a test of its own.  The ranks run a worker script written into the
test's directory: it imports the port and never JAX (each rank checks), so
nothing of this file reaches the ranks.  Inputs go to the ranks in an
``.npz``; rank 0 writes the gathered results (``full_tensor()``) back.

The in-process tests check the host-built tables bit for bit, the chain
with a process group of one against the serial call, and the multi-device
dry run.
"""

import json
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as sig
import torch

from simpledsp_tpu.design.biquad import design_bandpass, design_lowpass
from simpledsp_tpu.design.fir import lowpass_taps, resampler_taps
from simpledsp_tpu.ops.iir import IIRState, coeffs_from_design, iir_init, \
    sosfilt_scan

REPO = Path(__file__).resolve().parents[1]
RANK_TIMEOUT = 240            # seconds for one launch of 8 ranks

WORKER = textwrap.dedent('''
    import json, sys, traceback
    sys.path.insert(0, {repo!r})
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    rank, world, dp = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
    store, inputs, out = sys.argv[4], sys.argv[5], sys.argv[6]
    dist.init_process_group("gloo", init_method="file://" + store,
                            rank=rank, world_size=world)
    from simpledsp_tpu_torch import convert
    from simpledsp_tpu_torch import parallel as P
    from simpledsp_tpu_torch.design.biquad import (design_bandpass,
                                                   design_lowpass)
    from simpledsp_tpu_torch.design.fir import lowpass_taps, resampler_taps
    from simpledsp_tpu_torch.models.northstar import (ShardedNorthStarChain,
                                                      default_design)
    from simpledsp_tpu_torch.models.sdr import AMReceiverBank, FMReceiverBank
    from simpledsp_tpu_torch.parallel.mesh import ROWS
    from torch.distributed.tensor import Replicate, Shard
    mesh = P.make_mesh(dp=dp, device="cpu")
    I = dict(np.load(inputs))
    F64 = torch.float64

    def t(name):
        return torch.as_tensor(I[name])

    def full(a):
        return (a.full_tensor() if hasattr(a, "full_tensor") else a).numpy()

    def raises(fn, match):
        try:
            fn()
        except ValueError as e:
            return {{"message": np.array(str(e))}}
        raise AssertionError(f"no ValueError ({{match}})")

    def iir_scan():
        f = P.ShardedBlockIIR(design_lowpass(4, 200.0, 39000.0), mesh,
                              block_size=128, dtype=F64)
        return {{"y": full(f(t("iir_scan"))[0])}}

    def iir_scipy():
        f = P.ShardedBlockIIR(design_bandpass(4, 2000.0, 39000.0, 0.8), mesh,
                              block_size=64, dtype=F64)
        return {{"y": full(f(t("iir_scipy"))[0])}}

    def iir_stream():
        x = t("iir_stream")
        f = P.ShardedBlockIIR(design_lowpass(4, 1000.0, 39000.0), mesh,
                              block_size=128, dtype=F64)
        y, s_whole = f(x)
        y1, s = f(x[:, :4096])
        y2, s = f(x[:, 4096:], s)
        return {{"whole": full(y), "s_whole": full(s_whole.y_hist),
                 "blocks": np.concatenate([full(y1), full(y2)], -1),
                 "s": full(s.y_hist)}}

    def iir_f32():
        f = P.ShardedBlockIIR(design_lowpass(4, 2000.0, 39000.0), mesh,
                              block_size=256, dtype=torch.float32)
        return {{"y": full(f(t("iir_f32"))[0])}}

    def iir_apow():
        f = P.ShardedBlockIIR(design_lowpass(4, 2000.0, 39000.0), mesh,
                              block_size=256, dtype=F64)
        return {{"apow": f._apow(8).numpy()}}

    def iir_from_jax():
        f = P.ShardedBlockIIR(design_lowpass(4, 1000.0, 39000.0), mesh,
                              block_size=128, dtype=F64)
        state = convert.state_from_numpy(I["iir_from_jax_state"],
                                         device="cpu", dtype=F64)
        y2, s = f(t("iir_stream")[:, 4096:], state)
        return {{"y2": full(y2), "s": convert.state_to_numpy(s)}}

    def iir_to_jax():
        f = P.ShardedBlockIIR(design_lowpass(4, 1000.0, 39000.0), mesh,
                              block_size=128, dtype=F64)
        x = t("iir_stream")
        _, s = f(x[:, :4096])
        state = convert.state_to_numpy(s)
        y2, _ = f(x[:, 4096:], s)
        return {{"state": state, "y2": full(y2)}}

    def fir_serial():
        f = P.ShardedFIR(lowpass_taps(63, 0.12, fs=1.0), mesh, dtype=F64)
        return {{"y": full(f(t("fir_serial"))[0])}}

    def fir_resample():
        f = P.ShardedFIR(resampler_taps(3, 2, taps_per_phase=8), mesh, up=3,
                         down=2, dtype=F64)
        return {{"y": full(f(t("fir_resample"))[0])}}

    def fir_stream():
        x = t("fir_stream")
        f = P.ShardedFIR(lowpass_taps(33, 0.2, fs=1.0), mesh, dtype=F64)
        y1, s = f(x[:, :2048])
        y2, _ = f(x[:, 2048:], s)
        return {{"whole": full(f(x)[0]),
                 "blocks": np.concatenate([full(y1), full(y2)], -1)}}

    def fir_from_jax():
        f = P.ShardedFIR(lowpass_taps(33, 0.2, fs=1.0), mesh, dtype=F64)
        state = convert.fir_state_from_numpy(I["fir_from_jax_state"],
                                             device="cpu", dtype=F64)
        return {{"y2": full(f(t("fir_stream")[:, 2048:], state)[0])}}

    def fir_to_jax():
        f = P.ShardedFIR(lowpass_taps(33, 0.2, fs=1.0), mesh, dtype=F64)
        x = t("fir_stream")
        _, s = f(x[:, :2048])
        return {{"state": convert.fir_state_to_numpy(s),
                 "y2": full(f(x[:, 2048:], s)[0])}}

    def chan_serial():
        ch = P.ShardedChannelizer(16, mesh, taps_per_channel=8, dtype=F64)
        return {{"y": full(ch(t("chan_serial"))[0])}}

    def chan_stream():
        x = t("chan_stream")
        ch = P.ShardedChannelizer(8, mesh, taps_per_channel=4, dtype=F64)
        y1, s = ch(x[:, :1024])
        y2, _ = ch(x[:, 1024:], s)
        return {{"whole": full(ch(x)[0]),
                 "blocks": np.concatenate([full(y1), full(y2)], -2)}}

    def chan_gather():
        x = t("chan_stream")
        local = P.ShardedChannelizer(8, mesh, taps_per_channel=4, dtype=F64)
        gathered = P.ShardedChannelizer(8, mesh, taps_per_channel=4,
                                        dtype=F64, gather_output=True)
        yl, _ = local(x)
        yg, _ = gathered(x)
        own = yg.to_local()
        replicated = (tuple(yg.placements) == (Shard(0), Replicate())
                      and own.shape == yg.shape)
        return {{"local": full(yl), "gathered": full(yg),
                 "own": own.numpy(), "replicated": np.array(replicated)}}

    def ols_serial():
        f = P.ShardedOverlapSaveFIR(lowpass_taps(129, 0.1, fs=1.0), mesh,
                                    block_size=256, dtype=F64)
        return {{"y": full(f(t("ols_serial"))[0])}}

    def ols_stream():
        x = t("ols_stream")
        f = P.ShardedOverlapSaveFIR(lowpass_taps(65, 0.2, fs=1.0), mesh,
                                    block_size=256, dtype=F64)
        y1, s = f(x[:, :4096])
        y2, _ = f(x[:, 4096:], s)
        return {{"whole": full(f(x)[0]),
                 "blocks": np.concatenate([full(y1), full(y2)], -1)}}

    def bank_fm(use_kernel):
        bank = FMReceiverBank(16, fs=1.6e6, dtype=F64, device="cpu",
                              use_kernel=use_kernel)
        sharded = P.ShardedReceiverBank(bank, mesh)
        x = t("bank")
        ss, out = sharded.init_state(4), {{}}
        for k in range(2):
            a, ss = sharded(x, ss)
            out[f"audio{{k}}"] = full(a)
        out["hist_r"] = full(ss.chan.hist_r)
        out["prev_r"] = full(ss.demod.prev_r)
        return out

    def bank_am():
        bank = AMReceiverBank(16, fs=1.6e6, dtype=F64, device="cpu",
                              use_kernel=True)
        a, ss = P.ShardedReceiverBank(bank, mesh)(t("bank"))
        return {{"audio": full(a), "dc": full(ss.dc)}}

    def bank_raises():
        bank = FMReceiverBank(16, fs=1.6e6, dtype=F64, device="cpu",
                              use_kernel=False)
        sharded = P.ShardedReceiverBank(bank, mesh)
        return raises(lambda: sharded(torch.zeros(3, 16 * 64, dtype=F64)),
                      "batch")

    def conv(name, taps):
        return lambda: {{"y": full(P.ShardedConvolve(
            I[taps], mesh, dtype=F64)(t(name)))}}

    def conv_raises():
        sc = P.ShardedConvolve(np.ones(301), mesh, dtype=F64)
        return raises(lambda: sc(torch.zeros(1, 8 * 128, dtype=F64)), "halo")

    def stft(name, nfft, hop, onesided=True):
        def run():
            st = P.ShardedSTFT(mesh, nfft=nfft, hop=hop, onesided=onesided,
                               dtype=F64)
            gr, gi = st(t(name))
            return {{"re": full(gr), "im": full(gi)}}
        return run

    def stft_padded():
        x = t("stft_sp8")
        st = P.ShardedSTFT(mesh, nfft=128, hop=64, dtype=F64)
        pr, pi = st(x, padded=True)
        gr, gi = st(x)
        return {{"pr": full(pr), "pi": full(pi), "gr": full(gr),
                 "gi": full(gi)}}

    def stft_bad_hop():
        return raises(lambda: P.ShardedSTFT(mesh, nfft=256, hop=96), "hop")

    def chain(use_kernel, streaming):
        def run():
            design = default_design()
            sharded = ShardedNorthStarChain(mesh, design=design, dtype=F64,
                                            use_kernel=use_kernel)
            if not streaming:
                x = t("chain")
                (br, bi), s_b = sharded(x)
                return {{"re": full(br), "im": full(bi),
                         "s": full(s_b.y_hist)}}
            x = t("chain_stream")
            (ar, _), _ = sharded(x)
            (br, _), s = sharded(x[:, :4 * 16384])
            (cr, _), _ = sharded(x[:, 4 * 16384:], s)
            return {{"whole": full(ar),
                     "blocks": np.concatenate([full(br), full(cr)], 1)}}
        return run

    CASES = dict(
        iir_scan=iir_scan, iir_scipy=iir_scipy, iir_stream=iir_stream,
        iir_f32=iir_f32, iir_apow=iir_apow, iir_from_jax=iir_from_jax,
        iir_to_jax=iir_to_jax, fir_serial=fir_serial,
        fir_resample=fir_resample, fir_stream=fir_stream,
        fir_from_jax=fir_from_jax, fir_to_jax=fir_to_jax,
        chan_serial=chan_serial, chan_stream=chan_stream,
        chan_gather=chan_gather, ols_serial=ols_serial,
        ols_stream=ols_stream, bank_fm_plain=lambda: bank_fm(False),
        bank_fm_kernel=lambda: bank_fm(True), bank_am=bank_am,
        bank_raises=bank_raises,
        conv_same=conv("conv_same", "conv_same_h"),
        conv_even=conv("conv_even", "conv_even_h"),
        conv_scipy=conv("conv_scipy", "conv_scipy_h"),
        conv_raises=conv_raises,
        stft_1=stft("stft", 256, 256), stft_2=stft("stft", 256, 128),
        stft_4=stft("stft", 256, 64), stft_8=stft("stft", 256, 32),
        stft_sp8=stft("stft_sp8", 128, 64, onesided=False),
        stft_padded=stft_padded, stft_bad_hop=stft_bad_hop,
        chain_serial=chain(False, False), chain_stream=chain(False, True),
        fused_serial=chain(True, False), fused_stream=chain(True, True))

    results, errors = {{}}, {{}}
    for name in sys.argv[7].split(","):
        try:
            for key, value in CASES[name]().items():
                results[name + ":" + key] = value
        except Exception:
            errors[name] = traceback.format_exc()
    if rank == 0:
        np.savez(out, **results)
        with open(out + ".errors.json", "w") as fh:
            json.dump(errors, fh)
    dist.destroy_process_group()
    assert "jax" not in sys.modules and "simpledsp_tpu" not in sys.modules
''')

CASES_24 = ("iir_scan", "iir_stream", "iir_from_jax", "iir_to_jax",
            "fir_serial", "fir_stream", "fir_from_jax", "fir_to_jax",
            "bank_fm_plain", "bank_fm_kernel", "bank_am", "bank_raises",
            "conv_same", "stft_1", "stft_2", "stft_4", "stft_8",
            "chain_serial",
            "chain_stream", "fused_serial", "fused_stream")
CASES_18 = ("iir_scipy", "iir_f32", "iir_apow", "fir_resample",
            "chan_serial", "chan_stream", "chan_gather", "ols_serial",
            "ols_stream", "conv_even", "conv_scipy", "conv_raises",
            "stft_sp8", "stft_padded", "stft_bad_hop")


class Run:
    """One launch's results: ``run[case, key]`` is a case's output, and
    raises with the ranks' traceback where the case failed."""

    def __init__(self, results, errors, inputs, ref=None):
        self.results, self.errors, self.inputs = results, errors, inputs
        self.ref = ref or {}

    def __getitem__(self, item):
        case, key = item
        if case in self.errors:
            pytest.fail(f"case {case} failed on the ranks:\n"
                        f"{self.errors[case]}")
        return self.results[f"{case}:{key}"]


def launch(tmp, world: int, dp: int, cases, inputs: dict, worker: str):
    """Run ``cases`` on ``world`` gloo ranks of a (dp, world // dp) mesh;
    returns (results, errors).  Fails the fixture if a rank fails."""
    tmp.mkdir(parents=True, exist_ok=True)
    script = tmp / "worker.py"
    script.write_text(worker.format(repo=str(REPO)))
    np.savez(tmp / "inputs.npz", **inputs)
    out = str(tmp / "out.npz")
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(world), str(dp),
         str(tmp / "store"), str(tmp / "inputs.npz"), out, ",".join(cases)],
        cwd=str(tmp), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RANK_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{o[-4000:]}"
    with np.load(out) as f:
        results = {k: f[k] for k in f.files}
    errors = json.loads(Path(out + ".errors.json").read_text())
    return results, errors


def _seeded(seed, shape, complex_=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    return x + 1j * rng.standard_normal(shape) if complex_ else x


@pytest.fixture(scope="module")
def jmesh24():
    from simpledsp_tpu.parallel import make_mesh
    return make_mesh(dp=2, sp=4)


@pytest.fixture(scope="module")
def jmesh18():
    from simpledsp_tpu.parallel import make_mesh
    return make_mesh(dp=1, sp=8)


@pytest.fixture(scope="module")
def run24(tmp_path_factory, jmesh24):
    from simpledsp_tpu.parallel import ShardedBlockIIR, ShardedFIR
    inputs = dict(
        iir_scan=_seeded(1, (4, 4096)), iir_stream=_seeded(2, (2, 8192)),
        fir_serial=_seeded(3, (4, 2048)), fir_stream=_seeded(4, (2, 4096)),
        bank=_seeded(5, (4, 16 * 256), complex_=True),
        conv_same=_seeded(6, (4, 8192)),
        conv_same_h=np.asarray(lowpass_taps(301, 0.1, fs=1.0)),
        stft=_seeded(7, (4, 8192)), chain=_seeded(8, (2, 4 * 16384)),
        chain_stream=_seeded(9, (2, 8 * 16384)))
    # The JAX side of the state handovers: its first call's state.
    f = ShardedBlockIIR(design_lowpass(4, 1000.0, 39000.0), jmesh24,
                        block_size=128, dtype=jnp.float64)
    _, s = f(jnp.asarray(inputs["iir_stream"][:, :4096]))
    inputs["iir_from_jax_state"] = np.asarray(s.y_hist)
    fir = ShardedFIR(lowpass_taps(33, 0.2, fs=1.0), jmesh24,
                     dtype=jnp.float64)
    _, fs_ = fir(jnp.asarray(inputs["fir_stream"][:, :2048]))
    inputs["fir_from_jax_state"] = np.asarray(fs_.hist)
    results, errors = launch(tmp_path_factory.mktemp("mesh24"), 8, 2,
                             CASES_24, inputs, WORKER)
    return Run(results, errors, inputs)


@pytest.fixture(scope="module")
def run18(tmp_path_factory):
    rng = np.random.default_rng(10)
    inputs = dict(
        iir_scipy=_seeded(11, (2, 2048)),
        iir_f32=_seeded(12, (1, 8192)).astype(np.float32),
        fir_resample=_seeded(13, (2, 1600)),
        chan_serial=_seeded(14, (2, 4096), complex_=True),
        chan_stream=_seeded(15, (1, 2048), complex_=True),
        ols_serial=_seeded(16, (2, 4096)), ols_stream=_seeded(17, (1, 8192)),
        conv_even=_seeded(18, (2, 4096)), conv_even_h=rng.standard_normal(64),
        conv_scipy=_seeded(19, (1, 2048)),
        conv_scipy_h=rng.standard_normal(33),
        stft_sp8=_seeded(20, (2, 8 * 512)))
    results, errors = launch(tmp_path_factory.mktemp("mesh18"), 8, 1,
                             CASES_18, inputs, WORKER)
    return Run(results, errors, inputs)


def close(got, ref, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=atol,
                               rtol=0)


# -- TestShardedIIR ---------------------------------------------------------

def test_iir_matches_jax_and_the_scan_oracle_f64(run24, jmesh24):
    from simpledsp_tpu.parallel import ShardedBlockIIR
    design = design_lowpass(4, 200.0, 39000.0)
    x = run24.inputs["iir_scan"]
    y, _ = ShardedBlockIIR(design, jmesh24, block_size=128,
                           dtype=jnp.float64)(jnp.asarray(x))
    close(run24["iir_scan", "y"], y, 1e-11)
    y_ref, _ = sosfilt_scan(coeffs_from_design(design, dtype=jnp.float64),
                            jnp.asarray(x), iir_init(4, (4,),
                                                     dtype=jnp.float64))
    close(run24["iir_scan", "y"], y_ref, 1e-11)


def test_iir_matches_jax_and_scipy_sosfilt(run18, jmesh18):
    from simpledsp_tpu.design.biquad import sos_matrix
    from simpledsp_tpu.parallel import ShardedBlockIIR
    design = design_bandpass(4, 2000.0, 39000.0, 0.8)
    x = run18.inputs["iir_scipy"]
    y, _ = ShardedBlockIIR(design, jmesh18, block_size=64,
                           dtype=jnp.float64)(jnp.asarray(x))
    close(run18["iir_scipy", "y"], y, 1e-11)
    close(run18["iir_scipy", "y"], sig.sosfilt(sos_matrix(design), x,
                                               axis=-1), 1e-11)


def test_iir_streaming_across_sharded_calls(run24, jmesh24):
    from simpledsp_tpu.parallel import ShardedBlockIIR
    close(run24["iir_stream", "blocks"], run24["iir_stream", "whole"], 1e-12)
    close(run24["iir_stream", "s"], run24["iir_stream", "s_whole"], 1e-12)
    f = ShardedBlockIIR(design_lowpass(4, 1000.0, 39000.0), jmesh24,
                        block_size=128, dtype=jnp.float64)
    y, s = f(jnp.asarray(run24.inputs["iir_stream"]))
    close(run24["iir_stream", "whole"], y, 1e-12)
    close(run24["iir_stream", "s_whole"], s.y_hist, 1e-12)


def test_iir_f32_snr(run18):
    design = design_lowpass(4, 2000.0, 39000.0)
    x = run18.inputs["iir_f32"]
    y_ref, _ = sosfilt_scan(coeffs_from_design(design, dtype=jnp.float64),
                            jnp.asarray(x, dtype=jnp.float64),
                            iir_init(4, (1,), dtype=jnp.float64))
    y_ref = np.asarray(y_ref)
    got = run18["iir_f32", "y"]
    assert got.dtype == np.float32
    err = got.astype(np.float64) - y_ref
    snr = 10 * np.log10(np.mean(y_ref ** 2) / max(np.mean(err ** 2), 1e-30))
    assert snr > 90.0, f"sharded f32 SNR too low: {snr:.1f} dB"


def test_iir_apow_equals_jax_bit_for_bit(run18, jmesh18):
    from simpledsp_tpu.parallel import ShardedBlockIIR
    f = ShardedBlockIIR(design_lowpass(4, 2000.0, 39000.0), jmesh18,
                        block_size=256, dtype=jnp.float64)
    np.testing.assert_array_equal(run18["iir_apow", "apow"], f._apow(8))


@pytest.mark.parametrize("direction", ["from_jax", "to_jax"])
def test_iir_state_crosses_between_sharded_calls(run24, jmesh24, direction):
    """A JAX sharded call's state resumes a port sharded call (through
    ``convert.state_from_numpy``), and a port sharded call's state
    (``convert.state_to_numpy`` of its DTensor) resumes a JAX one."""
    from simpledsp_tpu.parallel import ShardedBlockIIR
    f = ShardedBlockIIR(design_lowpass(4, 1000.0, 39000.0), jmesh24,
                        block_size=128, dtype=jnp.float64)
    x2 = jnp.asarray(run24.inputs["iir_stream"][:, 4096:])
    case = "iir_" + direction
    state = (run24.inputs["iir_from_jax_state"] if direction == "from_jax"
             else run24[case, "state"])
    y2, s = f(x2, IIRState(jnp.asarray(state)))
    close(run24[case, "y2"], y2, 1e-12)
    if direction == "from_jax":
        close(run24[case, "s"], s.y_hist, 1e-12)


# -- TestShardedFIR ---------------------------------------------------------

def test_fir_matches_jax_and_lfilter(run24, jmesh24):
    from simpledsp_tpu.parallel import ShardedFIR
    taps = lowpass_taps(63, 0.12, fs=1.0)
    x = run24.inputs["fir_serial"]
    y, _ = ShardedFIR(taps, jmesh24, dtype=jnp.float64)(jnp.asarray(x))
    close(run24["fir_serial", "y"], y, 1e-12)
    close(run24["fir_serial", "y"], sig.lfilter(taps, [1.0], x, axis=-1),
          1e-12)


def test_fir_resampler_matches_jax(run18, jmesh18):
    from simpledsp_tpu.ops.fir import PolyphaseResampler
    from simpledsp_tpu.parallel import ShardedFIR
    taps = resampler_taps(3, 2, taps_per_phase=8)
    x = jnp.asarray(run18.inputs["fir_resample"])
    y, _ = ShardedFIR(taps, jmesh18, up=3, down=2, dtype=jnp.float64)(x)
    close(run18["fir_resample", "y"], y, 1e-12)
    y_ref, _ = PolyphaseResampler(taps, up=3, down=2, dtype=jnp.float64)(x)
    close(run18["fir_resample", "y"], y_ref, 1e-12)


def test_fir_streaming_across_sharded_calls(run24, jmesh24):
    from simpledsp_tpu.parallel import ShardedFIR
    close(run24["fir_stream", "blocks"], run24["fir_stream", "whole"], 1e-14)
    y, _ = ShardedFIR(lowpass_taps(33, 0.2, fs=1.0), jmesh24,
                      dtype=jnp.float64)(
        jnp.asarray(run24.inputs["fir_stream"]))
    close(run24["fir_stream", "whole"], y, 1e-14)


@pytest.mark.parametrize("direction", ["from_jax", "to_jax"])
def test_fir_state_crosses_between_sharded_calls(run24, jmesh24, direction):
    from simpledsp_tpu.ops.fir import FIRState
    from simpledsp_tpu.parallel import ShardedFIR
    fir = ShardedFIR(lowpass_taps(33, 0.2, fs=1.0), jmesh24,
                     dtype=jnp.float64)
    case = "fir_" + direction
    state = (run24.inputs["fir_from_jax_state"] if direction == "from_jax"
             else run24[case, "state"])
    y2, _ = fir(jnp.asarray(run24.inputs["fir_stream"][:, 2048:]),
                FIRState(jnp.asarray(state)))
    close(run24[case, "y2"], y2, 1e-14)


# -- TestShardedChannelizer / TestChannelizerGather -------------------------

def test_channelizer_matches_jax(run18, jmesh18):
    from simpledsp_tpu.ops.channelizer import PFBChannelizer
    from simpledsp_tpu.parallel import ShardedChannelizer
    x = jnp.asarray(run18.inputs["chan_serial"])
    ch = ShardedChannelizer(16, jmesh18, taps_per_channel=8,
                            dtype=jnp.float64)
    y, _ = ch(x)
    close(run18["chan_serial", "y"], y, 1e-10)
    y_ref, _ = PFBChannelizer.__call__(ch.pfb, x)
    close(run18["chan_serial", "y"], y_ref, 1e-10)


def test_channelizer_streaming_across_sharded_calls(run18, jmesh18):
    from simpledsp_tpu.parallel import ShardedChannelizer
    close(run18["chan_stream", "blocks"], run18["chan_stream", "whole"],
          1e-10)
    y, _ = ShardedChannelizer(8, jmesh18, taps_per_channel=4,
                              dtype=jnp.float64)(
        jnp.asarray(run18.inputs["chan_stream"]))
    close(run18["chan_stream", "whole"], y, 1e-10)


def test_gathered_channelizer_output_replicated_and_correct(run18, jmesh18):
    from simpledsp_tpu.parallel import ShardedChannelizer
    gathered = run18["chan_gather", "gathered"]
    assert gathered.shape == run18["chan_gather", "local"].shape
    close(gathered, run18["chan_gather", "local"], 1e-12)
    # Every rank of sp holds the whole output of its channels.
    assert bool(run18["chan_gather", "replicated"])
    np.testing.assert_array_equal(run18["chan_gather", "own"], gathered)
    y, _ = ShardedChannelizer(8, jmesh18, taps_per_channel=4,
                              dtype=jnp.float64, gather_output=True)(
        jnp.asarray(run18.inputs["chan_stream"]))
    close(gathered, y, 1e-12)


# -- TestShardedOverlapSave -------------------------------------------------

def test_overlap_save_matches_jax_and_lfilter(run18, jmesh18):
    from simpledsp_tpu.parallel import ShardedOverlapSaveFIR
    taps = lowpass_taps(129, 0.1, fs=1.0)
    x = run18.inputs["ols_serial"]
    y, _ = ShardedOverlapSaveFIR(taps, jmesh18, block_size=256,
                                 dtype=jnp.float64)(jnp.asarray(x))
    close(run18["ols_serial", "y"], y, 1e-10)
    close(run18["ols_serial", "y"], sig.lfilter(taps, [1.0], x, axis=-1),
          1e-10)


def test_overlap_save_streaming_across_calls(run18, jmesh18):
    from simpledsp_tpu.parallel import ShardedOverlapSaveFIR
    close(run18["ols_stream", "blocks"], run18["ols_stream", "whole"], 1e-11)
    y, _ = ShardedOverlapSaveFIR(lowpass_taps(65, 0.2, fs=1.0), jmesh18,
                                 block_size=256, dtype=jnp.float64)(
        jnp.asarray(run18.inputs["ols_stream"]))
    close(run18["ols_stream", "whole"], y, 1e-11)


# -- TestShardedReceiverBank ------------------------------------------------

@pytest.mark.parametrize("use_kernel", [False, True])
def test_fm_bank_sharded_matches_jax(run24, jmesh24, use_kernel):
    """The port's sharded bank on its plain path and on its kernel path
    (the PFB kernel's plain version on the CPU) against JAX's sharded bank
    on its XLA path and its fused path in interpret mode."""
    from simpledsp_tpu.models.sdr import FMReceiverBank
    from simpledsp_tpu.parallel import ShardedReceiverBank
    bank = FMReceiverBank(16, fs=1.6e6, dtype=jnp.float64,
                          use_pallas=use_kernel)
    bank._interpret = use_kernel
    sharded = ShardedReceiverBank(bank, jmesh24)
    x = run24.inputs["bank"]
    case = "bank_fm_kernel" if use_kernel else "bank_fm_plain"
    ss = sharded.init_state(4)
    for k in range(2):
        a, ss = sharded(x, ss)
        close(run24[case, f"audio{k}"], a, 1e-12)
    close(run24[case, "hist_r"], ss.chan.hist_r, 0)
    close(run24[case, "prev_r"], ss.demod.prev_r, 1e-12)


def test_am_bank_dc_sharded_matches_jax(run24, jmesh24):
    from simpledsp_tpu.models.sdr import AMReceiverBank
    from simpledsp_tpu.parallel import ShardedReceiverBank
    bank = AMReceiverBank(16, fs=1.6e6, dtype=jnp.float64, use_pallas=True)
    bank._interpret = True
    a, ss = ShardedReceiverBank(bank, jmesh24)(run24.inputs["bank"])
    close(run24["bank_am", "audio"], a, 1e-12)
    close(run24["bank_am", "dc"], ss.dc, 1e-12)


def test_bank_batch_not_divisible_raises(run24):
    assert "multiple of the dp axis" in str(run24["bank_raises", "message"])


# -- TestShardedConvolve ----------------------------------------------------

@pytest.mark.parametrize("case,mesh", [("conv_same", "24"),
                                       ("conv_even", "18"),
                                       ("conv_scipy", "18")])
def test_convolve_same_matches_jax(request, case, mesh):
    from simpledsp_tpu.ops.conv import convolve
    from simpledsp_tpu.parallel.fir import ShardedConvolve
    run = request.getfixturevalue("run" + mesh)
    jmesh = request.getfixturevalue("jmesh" + mesh)
    x, h = run.inputs[case], run.inputs[case + "_h"]
    got = run[case, "y"]
    close(got, ShardedConvolve(h, jmesh, dtype=jnp.float64)(jnp.asarray(x)),
          1e-12)
    close(got, convolve(jnp.asarray(x), h, mode="same"), 1e-12)
    if case == "conv_scipy":
        close(got[0], sig.convolve(x[0], h, mode="same"), 1e-10)


def test_convolve_short_shard_raises(run18):
    assert "halo" in str(run18["conv_raises", "message"])


# -- TestShardedSTFT --------------------------------------------------------

@pytest.mark.parametrize("hop_div", [1, 2, 4, 8])
def test_stft_matches_jax(run24, jmesh24, hop_div):
    """hop_div 8 at sp = 4: the unpadded frames' split is not the even
    chunk layout of a DTensor shard, so they are gathered over sp."""
    from simpledsp_tpu.ops.spectral import stft_ri
    from simpledsp_tpu.parallel.spectral import ShardedSTFT
    x = jnp.asarray(run24.inputs["stft"])
    hop = 256 // hop_div
    gr, gi = ShardedSTFT(jmesh24, nfft=256, hop=hop, dtype=jnp.float64)(x)
    case = f"stft_{hop_div}"
    close(run24[case, "re"], gr, 1e-12)
    close(run24[case, "im"], gi, 1e-12)
    rr, ri_ = stft_ri(x, 256, hop=hop)
    close(run24[case, "re"], rr, 1e-12)
    close(run24[case, "im"], ri_, 1e-12)


def test_stft_sp8_onesided_false(run18, jmesh18):
    from simpledsp_tpu.parallel.spectral import ShardedSTFT
    x = jnp.asarray(run18.inputs["stft_sp8"])
    gr, gi = ShardedSTFT(jmesh18, nfft=128, hop=64, onesided=False,
                         dtype=jnp.float64)(x)
    close(run18["stft_sp8", "re"], gr, 1e-12)
    close(run18["stft_sp8", "im"], gi, 1e-12)


def test_stft_bad_hop_raises(run18):
    assert "hop" in str(run18["stft_bad_hop", "message"])


def test_stft_padded_keeps_frames_sharded(run18, jmesh18):
    from simpledsp_tpu.parallel.spectral import ShardedSTFT
    pr, pi = run18["stft_padded", "pr"], run18["stft_padded", "pi"]
    gr, gi = run18["stft_padded", "gr"], run18["stft_padded", "gi"]
    assert pr.shape[1] == run18.inputs["stft_sp8"].shape[1] // 64
    nf = gr.shape[1]
    assert nf == (run18.inputs["stft_sp8"].shape[1] - 128) // 64 + 1
    np.testing.assert_array_equal(pr[:, :nf], gr)
    np.testing.assert_array_equal(pi[:, :nf], gi)
    jr, _ = ShardedSTFT(jmesh18, nfft=128, hop=64, dtype=jnp.float64)(
        jnp.asarray(run18.inputs["stft_sp8"]), padded=True)
    close(pr, jr, 1e-12)


# -- tests/test_models.py: ShardedNorthStarChain ----------------------------

@pytest.mark.parametrize("use_kernel", [False, True])
def test_sharded_chain_matches_jax(run24, jmesh24, use_kernel):
    """Composable and fused (the chain kernel's plain version on the CPU)
    against JAX's sharded chain on its jnp path and its fused path in
    interpret mode, and against JAX's serial chain."""
    from simpledsp_tpu.models.northstar import (NorthStarChain,
                                                ShardedNorthStarChain,
                                                default_design)
    x = jnp.asarray(run24.inputs["chain"])
    sharded = ShardedNorthStarChain(jmesh24, design=default_design(),
                                    dtype=jnp.float64, use_pallas=use_kernel)
    sharded._interpret = use_kernel
    (br, bi), s_b = sharded(x)
    case = "fused_serial" if use_kernel else "chain_serial"
    close(run24[case, "re"], br, 1e-9)
    close(run24[case, "im"], bi, 1e-9)
    close(run24[case, "s"], s_b.y_hist, 1e-10)
    serial = NorthStarChain(design=default_design(), dtype=jnp.float64,
                            use_pallas=False)
    (ar, _), s_a = serial(x)
    close(run24[case, "re"], ar, 1e-9)
    close(run24[case, "s"], s_a.y_hist, 1e-10)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_sharded_chain_streaming(run24, jmesh24, use_kernel):
    from simpledsp_tpu.models.northstar import ShardedNorthStarChain
    case = "fused_stream" if use_kernel else "chain_stream"
    close(run24[case, "blocks"], run24[case, "whole"], 1e-10)
    sharded = ShardedNorthStarChain(jmesh24, dtype=jnp.float64,
                                    use_pallas=use_kernel)
    sharded._interpret = use_kernel
    (ar, _), _ = sharded(jnp.asarray(run24.inputs["chain_stream"]))
    close(run24[case, "whole"], ar, 1e-10)


# -- in-process: tables, a group of one, the dry run -------------------------

@pytest.fixture(scope="module")
def mesh1():
    """A (1, 1) gloo mesh in this process, ended after the module."""
    import torch.distributed as dist
    from simpledsp_tpu_torch.parallel import single_device_mesh
    started = not dist.is_initialized()
    mesh = single_device_mesh("cpu")
    yield mesh
    if started:
        dist.destroy_process_group()


def test_shard_powers_equal_jax_bit_for_bit():
    from simpledsp_tpu.kernels.chain import FusedNorthStarOperators as JOps
    from simpledsp_tpu.models.northstar import default_design as jdesign
    from simpledsp_tpu_torch.kernels.chain import FusedNorthStarOperators
    from simpledsp_tpu_torch.models.northstar import default_design
    ours = FusedNorthStarOperators(default_design(), 4096, device="cpu")
    theirs = JOps(jdesign(), 4096, dtype=jnp.float32)
    for frames, shards in ((16, 4), (256, 1), (64, 8)):
        np.testing.assert_array_equal(ours.shard_powers(frames, shards),
                                      theirs.shard_powers(frames, shards))


def test_apow_of_a_mesh_of_one_equals_jax(mesh1):
    from simpledsp_tpu.parallel import ShardedBlockIIR as JIIR
    from simpledsp_tpu.parallel import make_mesh
    from simpledsp_tpu_torch.design.biquad import design_lowpass as tdesign
    from simpledsp_tpu_torch.parallel import ShardedBlockIIR
    ours = ShardedBlockIIR(tdesign(4, 2000.0, 39000.0), mesh1,
                           block_size=256, dtype=torch.float64)
    theirs = JIIR(design_lowpass(4, 2000.0, 39000.0), make_mesh(dp=8, sp=1),
                  block_size=256, dtype=jnp.float64)
    for nb in (1, 16, 4096):
        np.testing.assert_array_equal(ours._apow(nb).numpy(),
                                      theirs._apow(nb))


def test_block_iir_operators_equal_jax():
    from simpledsp_tpu.ops.iir import BlockIIR as JBlockIIR
    from simpledsp_tpu_torch.design.biquad import design_lowpass as tdesign
    from simpledsp_tpu_torch.ops.iir import BlockIIR
    ours = BlockIIR(tdesign(4, 2000.0, 39000.0), block_size=64,
                    dtype=torch.float64, device="cpu").operators
    theirs = JBlockIIR(design_lowpass(4, 2000.0, 39000.0), block_size=64,
                       dtype=jnp.float64).operators
    assert len(ours) == len(theirs) == 4
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fused_chain_frames_with_a_group_of_one_equals_the_serial_call(
        mesh1, dtype):
    """At sp = 1 the incoming state is s0 exactly (the identity power), so
    the spectra keep the serial call's bits; the final state is the closed
    form's, within rounding of the serial one."""
    from simpledsp_tpu_torch.kernels import chain as kchain
    from simpledsp_tpu_torch.models.northstar import default_design
    ops = kchain.FusedNorthStarOperators(default_design(), 1024,
                                         dtype=dtype, device="cpu")
    rng = np.random.default_rng(30)
    x = torch.as_tensor(rng.standard_normal((3, 16 * 1024)), dtype=dtype)
    s0 = torch.as_tensor(rng.standard_normal((3, ops.state_dim)),
                         dtype=dtype)
    group = mesh1.get_group("sp")
    for half in (False, True):
        (sr, si), s_fin = kchain.fused_chain_frames(
            ops, x, s0, half_spectrum=half, group=group,
            shard_powers=ops.shard_powers(16, 1))
        (rr, ri), r_fin = kchain.fused_chain_frames(ops, x, s0,
                                                    half_spectrum=half)
        assert torch.equal(sr, rr) and torch.equal(si, ri)
        tol = 1e-5 if dtype == torch.float32 else 1e-12
        assert float((s_fin - r_fin).abs().max()) <= tol * float(
            r_fin.abs().max())
    with pytest.raises(ValueError, match="shard_powers"):
        kchain.fused_chain_frames(ops, x, s0, group=group)


def test_sharded_convolve_on_one_shard_is_the_serial_call(mesh1):
    from simpledsp_tpu_torch.ops.conv import convolve
    from simpledsp_tpu_torch.parallel import ShardedConvolve
    x = torch.as_tensor(_seeded(31, (2, 8192)), dtype=torch.float32)
    h = np.asarray(lowpass_taps(301, 0.1, fs=1.0))
    got = ShardedConvolve(h, mesh1)(x).full_tensor()
    assert torch.equal(got, convolve(x, h, mode="same"))


def test_dryrun_multichip_without_a_card_raises():
    from simpledsp_tpu_torch.entry import dryrun_multichip
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun_multichip(2)


def test_dryrun_multichip_on_four_cpu_ranks(capsys):
    from simpledsp_tpu_torch.entry import dryrun_multichip
    summary = dryrun_multichip(4, device="cpu")
    assert summary.startswith("dryrun_multichip OK: mesh=(2,2) cpu")
    assert "fused=((4, 2, 2048)" in summary
    assert summary in capsys.readouterr().out
