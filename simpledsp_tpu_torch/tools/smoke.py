"""The compiled-path smoke check that every benchmark run repeats.

Port of the JAX package's ``tools/tpu_smoke.py``, at its sizes:

1. ``NorthStarChain`` on its kernel path (2 x 8 * 4096 float32, seed 7,
   N = 4096, block 256): SNR against the float64 scipy oracle (``sosfilt``
   + numpy ``rfft``, packed), >= 130 dB.
2. ``ShardedNorthStarChain`` on its kernel path over a mesh of one rank
   (``parallel.mesh.single_device_mesh``: NCCL on the card, gloo on the
   CPU) against the serial chain: spectra within 1e-4 of their scale,
   the final state within 1e-4.
3. ``ShardedReceiverBank`` over the kernel bank ``FMReceiverBank(16,
   fs=1.6e6)`` on 2 x 16 * 2048 I/Q: bits equal to the serial bank.

On the card the three launch the chain and flat PFB kernels; on the CPU
(``--device cpu``) the kernel wrappers run their plain versions.  The record
(``compiled_smoke_ok``, ``chain_snr_db``, ``shard_dev``, ``state_dev``,
``bank_dev``, ``spectra_scale``, ``device``) goes to the path given,
``build/smoke.json`` by default, and to stdout.

    python -m simpledsp_tpu_torch.tools.smoke [record.json] [--device cpu]

Without a card and without ``--device cpu`` it exits 2 with
``resolve_device``'s message; a failed check exits 1.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

from simpledsp_tpu_torch.device import resolve_device

__all__ = ["run", "main", "default_out_path", "MIN_SNR_DB"]

MIN_SNR_DB = 130.0


def default_out_path() -> Path:
    """``build/smoke.json`` at the root of the checkout (``.gitignore``
    lists ``build/``)."""
    from simpledsp_tpu_torch.kernels._build import BUILD_DIR
    return BUILD_DIR / "smoke.json"


def _full(t) -> torch.Tensor:
    """A sharded module's ``DTensor`` as the whole tensor."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max())


def run(out_path=None, device=None) -> dict:
    """Run the three checks on ``device`` (None: CUDA), write the record to
    ``out_path`` (None: :func:`default_out_path`) and return it."""
    import scipy.signal as sig
    import torch.distributed as dist

    from simpledsp_tpu_torch.design.biquad import sos_matrix
    from simpledsp_tpu_torch.models.northstar import (NorthStarChain,
                                                      ShardedNorthStarChain)
    from simpledsp_tpu_torch.models.sdr import FMReceiverBank
    from simpledsp_tpu_torch.parallel.mesh import single_device_mesh
    from simpledsp_tpu_torch.parallel.sdr import ShardedReceiverBank

    dev = resolve_device(device)
    rng = np.random.default_rng(7)
    c, t, nfft = 2, 8 * 4096, 4096
    x = rng.standard_normal((c, t)).astype(np.float32)
    xs = torch.as_tensor(x, device=dev)

    # -- 1. the chain on its kernel path against the float64 oracle -------
    serial = NorthStarChain(fft_size=nfft, block_size=256,
                            dtype=torch.float32, device=dev, use_kernel=True)
    assert serial.use_kernel, "the chain is not on its kernel path"
    (ar, ai), s_a = serial(xs)
    got = (ar.double().cpu().numpy() + 1j * ai.double().cpu().numpy())
    y64 = sig.sosfilt(sos_matrix(serial.design), x.astype(np.float64),
                      axis=-1)
    ref = np.fft.rfft(y64.reshape(c, -1, nfft))
    packed = ref[..., : nfft // 2].copy()
    packed[..., 0] += 1j * ref[..., nfft // 2].real
    err = got - packed
    snr_db = float(10 * np.log10((np.abs(packed) ** 2).sum()
                                 / max((np.abs(err) ** 2).sum(), 1e-300)))
    print(f"chain SNR vs f64 oracle: {snr_db:.1f} dB", flush=True)

    started = not dist.is_initialized()
    try:
        mesh = single_device_mesh(dev)
        # -- 2. the sharded chain's kernel path on a mesh of one ----------
        sharded = ShardedNorthStarChain(mesh, fft_size=nfft, block_size=256,
                                        dtype=torch.float32, use_kernel=True)
        assert sharded.use_kernel, "the sharded chain is not on its kernel path"
        (br, bi), s_b = sharded(xs)
        br, bi = _full(br), _full(bi)
        scale = float(ar.abs().max())
        d_shard = max(_max_abs(ar, br), _max_abs(ai, bi))
        d_state = _max_abs(s_a.y_hist, _full(s_b.y_hist))
        print(f"sharded chain dev: {d_shard:.3e} (scale {scale:.1f}), "
              f"state dev {d_state:.3e}", flush=True)

        # -- 3. the dp-sharded FM bank on the kernel -----------------------
        bank = FMReceiverBank(16, fs=1.6e6, dtype=torch.float32, device=dev,
                              use_kernel=True)
        sbank = ShardedReceiverBank(bank, mesh)
        zb = rng.standard_normal((2, 2, 16 * 2048)).astype(np.float32)
        zr, zi = (torch.as_tensor(p, device=dev) for p in zb)
        a_ser, _ = bank((zr, zi))
        a_sh, _ = sbank((zr, zi))
        d_bank = _max_abs(a_ser, _full(a_sh))
        print(f"bank dev: {d_bank:.3e}", flush=True)
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()

    ok = (snr_db >= MIN_SNR_DB and d_shard < 1e-4 * scale and d_state < 1e-4
          and d_bank == 0.0)
    record = {
        "compiled_smoke_ok": bool(ok),
        "chain_snr_db": round(snr_db, 1),
        "shard_dev": d_shard, "state_dev": d_state, "bank_dev": d_bank,
        "spectra_scale": scale,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else str(dev)),
    }
    path = Path(out_path) if out_path is not None else default_out_path()
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(record) + "\n")
    return record


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="simpledsp_tpu_torch.tools.smoke",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("out", nargs="?", default=None,
                   help="where to write the record (default: "
                        "build/smoke.json)")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; there is no "
                        "fallback: pass cpu to run on the CPU)")
    args = p.parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(f"{p.prog}: {e}", file=sys.stderr)
        return 2
    record = run(args.out, dev)
    print(json.dumps(record))
    return 0 if record["compiled_smoke_ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
