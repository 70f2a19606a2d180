"""The port's ``utils/{host, checkpoint, benchmark, debug}``: the checkpoint
and debug cases of ``tests/test_utils.py`` on the port, states that cross
between the two packages' checkpoint files in both directions (the FM
state's None leaf included), the flatten order against ``jax.tree_util``,
the host fetch, the timing helpers and the profiler trace."""

import json
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpledsp_tpu.models import sdr as jsdr
from simpledsp_tpu.utils import benchmark as jbench
from simpledsp_tpu.utils import checkpoint as jckpt
from simpledsp_tpu_torch.models import sdr as tsdr
from simpledsp_tpu_torch.utils import benchmark as tbench
from simpledsp_tpu_torch.utils.checkpoint import load_state, save_state
from simpledsp_tpu_torch.utils.host import (to_numpy, tree_items,
                                            tree_leaves, tree_map)


class Pair(NamedTuple):
    a: torch.Tensor
    b: Optional[torch.Tensor] = None


def _nested(rng):
    t = lambda *s: torch.as_tensor(rng.standard_normal(s))  # noqa: E731
    return {"z": [t(2), None, t(3, 2)], "a": (Pair(t(4)), t(1)),
            "m": Pair(t(2, 2), t(5))}


class TestCheckpoint:
    def test_iir_state_roundtrip(self, tmp_path, rng):
        from simpledsp_tpu_torch.ops.iir import IIRState, iir_init
        state = IIRState(torch.as_tensor(rng.standard_normal((3, 5, 2))))
        p = tmp_path / "state.npz"
        save_state(p, state)
        back = load_state(p, iir_init(4, (3,), dtype=torch.float64))
        assert isinstance(back, IIRState)
        assert back.y_hist.dtype == torch.float64
        assert torch.equal(back.y_hist, state.y_hist)

    def test_resume_equals_continuous(self, tmp_path, rng):
        """Checkpoint mid-stream, restore, continue: identical output."""
        from simpledsp_tpu_torch.design.biquad import design_lowpass
        from simpledsp_tpu_torch.ops.iir import (
            coeffs_from_design, iir_init, sosfilt_scan)
        design = design_lowpass(4, 1000.0, 39000.0)
        coeffs = coeffs_from_design(design, dtype=torch.float64)
        x = torch.as_tensor(rng.standard_normal(600))
        s0 = iir_init(4, (), dtype=torch.float64)
        y_all, _ = sosfilt_scan(coeffs, x, s0)
        y1, s_mid = sosfilt_scan(coeffs, x[:300], s0)
        save_state(tmp_path / "mid.npz", s_mid)
        s_back = load_state(tmp_path / "mid.npz", s0)
        y2, _ = sosfilt_scan(coeffs, x[300:], s_back)
        assert torch.equal(torch.cat([y1, y2]), y_all)

    def test_sdr_state_roundtrip(self, tmp_path):
        rx = tsdr.FMReceiverBank(8, 256e3, decim=2, device="cpu")
        st = rx.init_state(2)
        p = tmp_path / "sdr.npz"
        save_state(p, st)
        back = load_state(p, rx.init_state(2))
        assert back.dc is None
        assert torch.equal(back.demod.prev_r, st.demod.prev_r)

    def test_leaf_count_mismatch_raises(self, tmp_path):
        from simpledsp_tpu_torch.ops.iir import iir_init
        save_state(tmp_path / "s.npz", iir_init(4, ()))
        with pytest.raises(ValueError, match="leaves"):
            load_state(tmp_path / "s.npz", (iir_init(4, ()), iir_init(4, ())))

    def test_leaf_shape_mismatch_raises(self, tmp_path):
        from simpledsp_tpu_torch.ops.iir import iir_init
        save_state(tmp_path / "s.npz", iir_init(4, (2,)))
        with pytest.raises(ValueError, match="shape"):
            load_state(tmp_path / "s.npz", iir_init(4, (3,)))

    def test_complex_and_nested_roundtrip(self, tmp_path, rng):
        state = _nested(rng)
        state["c"] = torch.as_tensor(rng.standard_normal(6)
                                     + 1j * rng.standard_normal(6))
        save_state(tmp_path / "n.npz", state)
        proto = tree_map(torch.zeros_like, state)
        back = load_state(tmp_path / "n.npz", proto)
        assert back["z"][1] is None and back["m"].b is not None
        for (pa, a), (pb, b) in zip(tree_items(state), tree_items(back)):
            assert pa == pb and a.dtype == b.dtype and torch.equal(a, b)

    def test_load_follows_the_prototype_dtype(self, tmp_path, rng):
        x = torch.as_tensor(rng.standard_normal(5))
        save_state(tmp_path / "d.npz", (x,))
        (back,) = load_state(tmp_path / "d.npz", (torch.zeros(5),))
        assert back.dtype == torch.float32
        assert torch.equal(back, x.float())

    def test_file_format_is_the_jax_one(self, tmp_path, rng):
        state = tsdr.FMReceiverBank(8, 256e3, decim=2,
                                    device="cpu").init_state(1)
        save_state(tmp_path / "f.npz", state)
        with np.load(tmp_path / "f.npz") as z:
            meta = json.loads(bytes(z["__meta__"]).decode())
            names = sorted(z.files)
        assert meta["n"] == 5 and meta["kinds"] == ["real"] * 5
        assert "SDRState" in meta["treedef"]
        assert names == ["__meta__"] + [f"leaf{i}" for i in range(5)]


class TestAcrossPackages:
    """States saved by one package resume in the other."""

    @pytest.mark.parametrize("bank", ["fm", "am"])
    def test_jax_state_loads_in_the_port(self, tmp_path, rng, bank):
        m, fs, decim = 8, 256e3, 2
        jb = (jsdr.FMReceiverBank(m, fs, decim=decim) if bank == "fm"
              else jsdr.AMReceiverBank(m, fs, decim=decim))
        tb = (tsdr.FMReceiverBank(m, fs, decim=decim, device="cpu")
              if bank == "fm"
              else tsdr.AMReceiverBank(m, fs, decim=decim, device="cpu"))
        x = rng.standard_normal((2, 2, 512)).astype(np.float32)
        _, jst = jb((jnp.asarray(x[0]), jnp.asarray(x[1])), None)
        jckpt.save_state(tmp_path / "j.npz", jst)
        back = load_state(tmp_path / "j.npz", tb.init_state(2))
        assert (back.dc is None) == (bank == "fm")
        jleaves = jax.tree_util.tree_leaves(jst)
        assert len(jleaves) == len(tree_leaves(back)) == (5 if bank == "fm"
                                                          else 6)
        for j, t in zip(jleaves, tree_leaves(back)):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))

    @pytest.mark.parametrize("bank", ["fm", "am"])
    def test_port_state_loads_in_jax(self, tmp_path, rng, bank):
        m, fs, decim = 8, 256e3, 2
        tb = (tsdr.FMReceiverBank(m, fs, decim=decim, device="cpu")
              if bank == "fm"
              else tsdr.AMReceiverBank(m, fs, decim=decim, device="cpu"))
        jb = (jsdr.FMReceiverBank(m, fs, decim=decim) if bank == "fm"
              else jsdr.AMReceiverBank(m, fs, decim=decim))
        x = rng.standard_normal((2, 2, 512)).astype(np.float32)
        _, tst = tb((x[0], x[1]), None)
        save_state(tmp_path / "t.npz", tst)
        back = jckpt.load_state(tmp_path / "t.npz", jb.init_state(2))
        jleaves = jax.tree_util.tree_leaves(back)
        assert len(jleaves) == len(tree_leaves(tst))
        for j, t in zip(jleaves, tree_leaves(tst)):
            np.testing.assert_array_equal(np.asarray(j), t.numpy())

    def test_nested_state_crosses_both_ways(self, tmp_path, rng):
        """Dicts (sorted keys), lists, NamedTuples and None number their
        leaves as jax.tree_util does."""
        state = _nested(rng)
        save_state(tmp_path / "t.npz", state)
        jproto = jax.tree_util.tree_map(lambda t: np.zeros(t.shape),
                                        tree_map(lambda t: t.numpy(), state))
        jback = jckpt.load_state(tmp_path / "t.npz", jproto)
        for (path, t), j in zip(tree_items(state),
                                jax.tree_util.tree_leaves(jback)):
            np.testing.assert_array_equal(np.asarray(j), t.numpy(), path)
        jckpt.save_state(tmp_path / "j.npz", jback)
        back = load_state(tmp_path / "j.npz",
                          tree_map(torch.zeros_like, state))
        for (pa, a), (pb, b) in zip(tree_items(state), tree_items(back)):
            assert pa == pb and torch.equal(a, b)

    def test_complex_leaf_crosses_both_ways(self, tmp_path, rng):
        z = rng.standard_normal(7) + 1j * rng.standard_normal(7)
        save_state(tmp_path / "t.npz", (torch.as_tensor(z),))
        (j,) = jckpt.load_state(tmp_path / "t.npz",
                                (jnp.zeros(7, jnp.complex128),))
        np.testing.assert_array_equal(np.asarray(j), z)
        jckpt.save_state(tmp_path / "j.npz", (jnp.asarray(z),))
        (t,) = load_state(tmp_path / "j.npz",
                          (torch.zeros(7, dtype=torch.complex128),))
        np.testing.assert_array_equal(t.numpy(), z)


class TestHost:
    def test_flatten_order_is_jax_tree_util_order(self, rng):
        host = tree_map(lambda t: t.numpy(), _nested(rng))
        mine, theirs = tree_leaves(host), jax.tree_util.tree_leaves(host)
        assert len(mine) == len(theirs) == 6
        assert all(a is b for a, b in zip(mine, theirs))

    def test_paths_name_the_access(self, rng):
        assert [p for p, _ in tree_items(_nested(rng))] == [
            "['a'][0].a", "['a'][1]", "['m'].a", "['m'].b", "['z'][0]",
            "['z'][2]"]

    def test_to_numpy_keeps_structure_and_values(self, rng):
        state = _nested(rng)
        host = to_numpy(state)
        assert host["z"][1] is None and isinstance(host["m"], Pair)
        for (_, a), (_, b) in zip(tree_items(state), tree_items(host)):
            assert isinstance(b, np.ndarray)
            np.testing.assert_array_equal(a.numpy(), b)

    @pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
    def test_to_numpy_complex_through_planes(self, rng, dtype):
        z = torch.as_tensor(rng.standard_normal(9)
                            + 1j * rng.standard_normal(9)).to(dtype)
        got = to_numpy(z)
        assert got.dtype == (np.complex64 if dtype == torch.complex64
                             else np.complex128)
        np.testing.assert_array_equal(got, z.numpy())

    def test_to_numpy_of_a_tensor_that_needs_grad(self):
        x = torch.ones(3, requires_grad=True)
        np.testing.assert_array_equal(to_numpy(2 * x), [2.0, 2.0, 2.0])


class TestBenchmark:
    def test_time_blocked_calls_and_times(self):
        calls = []

        def fn(x):
            calls.append(1)
            return x + 1
        t = tbench.time_blocked(fn, torch.zeros(4), iters=5, warmup=2)
        assert t > 0 and len(calls) == 7

    def test_time_streaming_chains_the_state(self):
        seen = []

        def step(x, s):
            seen.append(int(s))
            return x * 2, s + 1
        t = tbench.time_streaming(step, torch.ones(3), torch.tensor(0),
                                  iters=4, warmup=2)
        assert t > 0
        # warmup: states 0, 1; then the timed loop from the initial state.
        assert seen == [0, 1, 0, 1, 2, 3]

    @pytest.mark.parametrize("kwargs", [
        {}, {"baseline": 2.0}, {"detail": {"n": 3}},
        {"baseline": 3.0, "detail": {"cell": "x"}}])
    def test_emit_metric_prints_the_jax_record(self, capsys, kwargs):
        rec = tbench.emit_metric("throughput", 12.3456, "Msamples/s",
                                 **kwargs)
        mine = capsys.readouterr().out
        jrec = jbench.emit_metric("throughput", 12.3456, "Msamples/s",
                                  **kwargs)
        assert mine == capsys.readouterr().out
        assert rec == jrec == json.loads(mine)

    def test_trace_writes_a_chrome_trace(self, tmp_path):
        with tbench.trace(str(tmp_path / "tr")) as d:
            torch.ones(64, 64) @ torch.ones(64, 64)
        files = list((tmp_path / "tr").glob("trace-*.json"))
        assert d == str(tmp_path / "tr") and len(files) == 1
        events = json.loads(files[0].read_text())["traceEvents"]
        assert any("mm" in e.get("name", "") for e in events)

    def test_trace_is_written_when_the_body_raises(self, tmp_path):
        with pytest.raises(ZeroDivisionError):
            with tbench.trace(str(tmp_path)):
                1 / 0
        assert len(list(tmp_path.glob("trace-*.json"))) == 1


class TestDebug:
    def test_assert_stable_accepts_good_design(self):
        from simpledsp_tpu_torch.design.biquad import design_lowpass
        from simpledsp_tpu_torch.utils.debug import assert_stable, pole_radii
        d = design_lowpass(4, 2000.0, 39000.0)
        assert_stable(d)
        assert (pole_radii(d) < 1.0).all()

    def test_pole_radii_match_the_jax_package(self):
        from simpledsp_tpu.design.biquad import design_bandpass as jbp
        from simpledsp_tpu.utils.debug import pole_radii as jradii
        from simpledsp_tpu_torch.design.biquad import design_bandpass
        from simpledsp_tpu_torch.utils.debug import pole_radii
        np.testing.assert_array_equal(
            pole_radii(design_bandpass(4, 3000.0, 39000.0, 2.0)),
            jradii(jbp(4, 3000.0, 39000.0, 2.0)))

    def test_assert_stable_rejects_a_pole_on_the_circle(self):
        import dataclasses

        from simpledsp_tpu_torch.design.biquad import design_lowpass
        from simpledsp_tpu_torch.utils.debug import assert_stable
        d = design_lowpass(2, 2000.0, 39000.0)
        a = d.a.copy()
        a[1] = [1.0, -2.0, 1.0]      # a double pole at z = 1
        with pytest.raises(ValueError, match="unstable"):
            assert_stable(dataclasses.replace(d, a=a))

    def test_checked_catches_nan(self):
        from simpledsp_tpu_torch.utils.debug import checked

        def bad(x):
            return torch.log(x)  # NaN for negative input

        f = checked(bad)
        f(torch.tensor([1.0, 2.0]))  # fine
        with pytest.raises(RuntimeError, match="non-finite"):
            f(torch.tensor([-1.0]))

    def test_checked_names_the_leaf_and_catches_inf(self):
        from simpledsp_tpu_torch.ops.iir import IIRState
        from simpledsp_tpu_torch.utils.debug import checked

        def step(x):
            return x, (torch.arange(3), IIRState(1.0 / x))

        f = checked(step)
        out = f(torch.tensor([1.0, 2.0]))
        assert torch.equal(out[1][1].y_hist, torch.tensor([1.0, 0.5]))
        with pytest.raises(RuntimeError, match=r"output\[1\]\[1\]\.y_hist"):
            f(torch.tensor([0.0, 2.0]))

    def test_checked_keeps_the_name_and_passes_kwargs(self):
        from simpledsp_tpu_torch.utils.debug import checked

        def scaled(x, *, k=1.0):
            """doc"""
            return {"y": x * k}
        f = checked(scaled)
        assert f.__name__ == "scaled" and f.__doc__ == "doc"
        assert torch.equal(f(torch.ones(2), k=3.0)["y"], torch.full((2,), 3.0))
        with pytest.raises(RuntimeError, match=r"output\['y'\]"):
            f(torch.ones(2), k=float("inf"))
