"""The port's multi-node runtime on four gloo processes against the JAX
package's.

The counterpart of ``tests/test_multihost.py``: there two JAX processes of
two virtual devices each form a (2, 2) mesh; here four port processes, one
a device, start through ``multihost.initialize(coordinator=...)`` and
``pod_mesh()`` makes the same (2, 2) mesh from ``LOCAL_WORLD_SIZE=2`` (two
"nodes" of two ranks).  Each node feeds its own channel through
``host_sharded``, and the sharded IIR, the halo FIR, the sharded chain,
the centred convolution and the STFT run across the process boundaries.
Every rank checks its results as the JAX worker does; rank 0's gathered
results are held against the JAX package's on a (2, 2) mesh of the virtual
devices, on the same global input.
"""

import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
WORLD = 4

WORKER = textwrap.dedent('''
    import os, sys
    sys.path.insert(0, {repo!r})
    import numpy as np
    import torch
    torch.set_num_threads(1)
    rank = int(sys.argv[1])
    results = open(sys.argv[2], "a")

    def report(line):
        print(line, flush=True)
        results.write(line + chr(10))
        results.flush()

    from simpledsp_tpu_torch.parallel import multihost
    multihost.initialize(coordinator="localhost:{port}", num_processes=4,
                         process_id=rank, device="cpu")
    multihost.initialize(coordinator="localhost:{port}", num_processes=4,
                         process_id=rank, device="cpu")   # a no-op
    assert multihost.is_initialized()
    mesh = multihost.pod_mesh(device="cpu")
    assert mesh.shape == (2, 2) and mesh.mesh_dim_names == ("dp", "sp")
    node = rank // 2
    assert list(mesh.get_coordinate()) == [node, rank % 2]
    local = np.random.default_rng(node).standard_normal(
        (1, 1024)).astype(np.float32)
    x = multihost.host_sharded(mesh, local)
    assert tuple(x.shape) == (2, 1024)
    assert tuple(x.to_local().shape) == (1, 512)
    ref_in = np.concatenate(
        [np.random.default_rng(p).standard_normal((1, 1024)).astype(
            np.float32) for p in range(2)], axis=0)
    out = dict(x=x.full_tensor().numpy())

    from simpledsp_tpu_torch.models.northstar import default_design
    from simpledsp_tpu_torch.parallel import ShardedBlockIIR
    y, _ = ShardedBlockIIR(default_design(), mesh, block_size=64)(x)
    out["iir"] = y.full_tensor().numpy()
    report(f"OK proc {{rank}} checksum {{np.abs(out['iir']).sum():.6f}}")

    # Halo-exchange FIR across the process boundary (ring shift).
    from simpledsp_tpu_torch.design.fir import lowpass_taps
    from simpledsp_tpu_torch.parallel import ShardedFIR
    yf, _ = ShardedFIR(lowpass_taps(33, 0.25, fs=1.0), mesh)(x)
    out["fir"] = yf.full_tensor().numpy()
    report(f"OKFIR proc {{rank}} checksum {{np.abs(out['fir']).sum():.6f}}")

    # The sharded chain across processes against a local serial chain on
    # the (deterministic) global input.
    from simpledsp_tpu_torch.models.northstar import (NorthStarChain,
                                                      ShardedNorthStarChain)
    chain = ShardedNorthStarChain(mesh, fft_size=256, block_size=64,
                                  use_kernel=False)
    (sr, si), _ = chain(x)
    out["chain_re"], out["chain_im"] = (sr.full_tensor().numpy(),
                                        si.full_tensor().numpy())
    val_chain = float(np.abs(out["chain_re"]).sum()
                      + np.abs(out["chain_im"]).sum())
    serial = NorthStarChain(fft_size=256, block_size=64, device="cpu",
                            use_kernel=False)
    (rr, ri), _ = serial(torch.as_tensor(ref_in))
    val_serial = float(rr.abs().sum() + ri.abs().sum())
    rel = abs(val_chain - val_serial) / max(abs(val_serial), 1e-9)
    assert rel < 1e-5, (val_chain, val_serial)
    report(f"OKCHAIN proc {{rank}} checksum {{val_chain:.6f}}")

    # The centred convolution (left halo + centring shift) and the STFT
    # (right-neighbour look-ahead), each against a serial call.
    from simpledsp_tpu_torch.ops.conv import convolve
    from simpledsp_tpu_torch.ops.spectral import stft_ri
    from simpledsp_tpu_torch.parallel import ShardedConvolve, ShardedSTFT
    h33 = lowpass_taps(33, 0.2, fs=1.0)
    yc = ShardedConvolve(h33, mesh)(x).full_tensor()
    ref_c = convolve(torch.as_tensor(ref_in), h33, mode="same")
    rel_c = float((yc - ref_c).abs().max() / ref_c.abs().max())
    assert rel_c < 1e-5, rel_c
    out["conv"] = yc.numpy()
    report(f"OKCONV proc {{rank}} checksum {{float(yc.abs().sum()):.6f}}")

    gr, gi = ShardedSTFT(mesh, nfft=128, hop=64)(x)
    rr_s, ri_s = stft_ri(torch.as_tensor(ref_in), 128, hop=64)
    gr, gi = gr.full_tensor(), gi.full_tensor()
    rel_s = float((gr - rr_s).abs().max() + (gi - ri_s).abs().max())
    assert rel_s < 1e-4, rel_s
    out["stft_re"], out["stft_im"] = gr.numpy(), gi.numpy()
    report(f"OKSTFT proc {{rank}} checksum {{float(gr.abs().sum()):.6f}}")
    if rank == 0:
        np.savez(sys.argv[3], **out)
    import torch.distributed as dist
    dist.destroy_process_group()
    assert "jax" not in sys.modules and "simpledsp_tpu" not in sys.modules
''')

TAGS = ("OK ", "OKFIR ", "OKCHAIN ", "OKCONV ", "OKSTFT ")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Four ranks, two "nodes" of two; returns (every rank's result lines,
    rank 0's gathered outputs)."""
    import os
    tmp = tmp_path_factory.mktemp("multihost")
    script = tmp / "worker.py"
    script.write_text(WORKER.format(repo=str(REPO), port=_free_port()))
    res = [tmp / f"results_{i}.txt" for i in range(WORLD)]
    env = dict(os.environ, LOCAL_WORLD_SIZE="2")
    procs = [subprocess.Popen([sys.executable, str(script), str(i),
                               str(res[i]), str(tmp / "out.npz")],
                              cwd=str(tmp), env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for i in range(WORLD)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {i}:\n{o[-4000:]}"
    lines = [f.read_text().splitlines() for f in res]
    with np.load(tmp / "out.npz") as f:
        out = {k: f[k] for k in f.files}
    return lines, out


@pytest.fixture(scope="module")
def jax_run():
    """The JAX package's calls on a (2, 2) mesh of the virtual devices."""
    from simpledsp_tpu.design.fir import lowpass_taps
    from simpledsp_tpu.models.northstar import (ShardedNorthStarChain,
                                                default_design)
    from simpledsp_tpu.parallel import (ShardedBlockIIR, ShardedConvolve,
                                        ShardedFIR, ShardedSTFT, make_mesh)
    mesh = make_mesh(dp=2, sp=2, devices=jax.devices()[:4])
    x = jnp.asarray(np.concatenate(
        [np.random.default_rng(p).standard_normal((1, 1024)).astype(
            np.float32) for p in range(2)], axis=0))
    out = dict(x=x)
    out["iir"], _ = ShardedBlockIIR(default_design(), mesh, block_size=64)(x)
    out["fir"], _ = ShardedFIR(lowpass_taps(33, 0.25, fs=1.0), mesh)(x)
    (out["chain_re"], out["chain_im"]), _ = ShardedNorthStarChain(
        mesh, fft_size=256, block_size=64, dtype=jnp.float32,
        use_pallas=False)(x)
    out["conv"] = ShardedConvolve(lowpass_taps(33, 0.2, fs=1.0), mesh,
                                  dtype=jnp.float32)(x)
    out["stft_re"], out["stft_im"] = ShardedSTFT(
        mesh, nfft=128, hop=64, dtype=jnp.float32)(x)
    return {k: np.asarray(v, dtype=np.float64) for k, v in out.items()}


def test_every_rank_reports_every_mechanism(run):
    lines, _ = run
    for tag in TAGS:
        checks = [ln for rank in lines for ln in rank if ln.startswith(tag)]
        assert len(checks) == WORLD, (tag, lines)


@pytest.mark.parametrize("tag", TAGS)
def test_the_ranks_agree(run, tag):
    """Every rank computed the same global result: the checksums agree to a
    relative 1e-6 (a broken collective or halo is off by far more)."""
    lines, _ = run
    vals = [float(ln.split()[-1]) for rank in lines for ln in rank
            if ln.startswith(tag)]
    scale = max(max(abs(v) for v in vals), 1e-30)
    assert (max(vals) - min(vals)) / scale < 1e-6, vals


def test_host_sharded_assembles_the_nodes_channels(run, jax_run):
    _, out = run
    np.testing.assert_array_equal(out["x"], jax_run["x"])


@pytest.mark.parametrize("key", ["iir", "fir", "chain_re", "chain_im",
                                 "conv", "stft_re", "stft_im"])
def test_rank0_results_match_jax(run, jax_run, key):
    """float32 on both sides: within 1e-5 of the peak (the JAX test's bar
    for the chain against its serial reference)."""
    _, out = run
    ref = jax_run[key]
    err = np.abs(out[key].astype(np.float64) - ref).max()
    assert err <= 1e-5 * np.abs(ref).max(), (key, err, np.abs(ref).max())


def test_initialize_without_a_card_raises():
    import torch
    from simpledsp_tpu_torch.parallel import multihost
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        multihost.initialize(coordinator="localhost:1", num_processes=2,
                             process_id=0)
    assert not multihost._initialized
