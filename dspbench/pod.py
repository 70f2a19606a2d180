"""A cell over several cards: one process a card, one program across them.

The launcher (``run.py``, the process that prints the result) starts a rank
a card, ``python3 -m dspbench.pod --rank r ...``, with the rendezvous file
in a temporary directory under ``TMPDIR`` and NCCL kept out of ``/dev/shm``
(``NCCL_SHM_DISABLE=1``).  Each rank joins the NCCL group, builds the
traffic's (dp, sp) mesh, makes its own shard of every input block and runs
the cell's window on its card.  The ranks meet before the window (a gloo
barrier), and every ``stop_every`` calls rank 0 says over gloo, without
waiting on any card, whether the window has run its seconds; after the
last call each rank synchronizes its card and they meet again.  Each rank
checks its own shard, then writes its record to the temporary directory;
the launcher waits for every rank, reads the records and assembles the
line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

from dspbench.harness import (Cell, boot_clock, forbidden_modules, run_cell,
                              set_cache_dirs)
from dspbench.registry import ROOT, Registry

RANK_TIMEOUT_S = 1100     # a first run in a checkout builds its kernels


def spawn(cell: Cell, seeds: list, seconds: float, trace: bool, *,
          device_type: str = "cuda", control: bool = False,
          fault: str = None) -> list:
    """Run ``cell`` on ``traffic["ranks"]`` ranks for each of ``seeds`` in
    turn (one process a rank for all of them); returns, for each seed, the
    ranks' records.  The ranks load the cell from its entry with
    ``cell``'s sizes (tests run it small on the CPU); ``control`` puts the cell's control in the
    program's place, ``fault`` names a fault the ranks plant (tests).
    Raises RuntimeError when a rank fails."""
    world = cell.traffic["ranks"]
    env = dict(os.environ, NCCL_SHM_DISABLE="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    with tempfile.TemporaryDirectory(prefix="dspbench-") as tmp:
        procs = []
        try:
            for rank in range(world):
                cmd = [sys.executable, "-m", "dspbench.pod", "--rank",
                       str(rank), "--world", str(world), "--dir", tmp,
                       "--cell", json.dumps(cell.entry),
                       "--seconds", str(seconds),
                       "--trace", str(int(trace)), "--device", device_type,
                       "--sizes", json.dumps([cell.params, cell.traffic]),
                       "--seeds", *map(str, seeds)]
                if control:
                    cmd.append("--control")
                if fault:
                    cmd += ["--fault", fault]
                procs.append(subprocess.Popen(
                    cmd, env=dict(env, LOCAL_RANK=str(rank)), cwd=ROOT))
            deadline = time.monotonic() + RANK_TIMEOUT_S * len(seeds)
            for p in procs:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        failed = [(r, p.returncode) for r, p in enumerate(procs)
                  if p.returncode]
        if failed:
            raise RuntimeError(f"ranks failed (rank, exit code): {failed}")
        ranks = []
        for rank in range(world):
            with open(Path(tmp) / f"rank{rank}.json") as f:
                ranks.append(json.load(f))
    return [list(records) for records in zip(*ranks)]


def launch(registry: Registry, cell: Cell, args, started: float, *,
           device_type: str = "cuda", fault: str = None) -> int:
    """One run of a cell over its ranks: print its line; the exit code."""
    from dspbench.run import Context, finish
    try:
        (records,) = spawn(cell, [args.seed], args.seconds, bool(args.trace),
                           device_type=device_type, fault=fault)
    except RuntimeError as e:
        print(f"dspbench: {e}", file=sys.stderr)
        return 1
    first = records[0]
    ctx = Context(cell, records, first["first_call"] - started)
    info = {"cell": cell.name, "seed": args.seed,
            "build_seconds": first["build_seconds"],
            "calls": first["attempted"],
            "compared": sum(r["compared"] for r in records),
            "run_s": boot_clock() - started,
            "rank_forbidden": sorted({m for r in records
                                      for m in r["forbidden_modules"]})}
    return finish(registry, ctx, bool(args.trace), first["kind"], info)


def _stopper(seconds: float, every: int, group, rank: int):
    """``stop(n, start)``: every ``every`` calls, rank 0's clock decides
    for all ranks over the gloo ``group``."""
    import torch
    import torch.distributed as dist

    def stop(n, start):
        if n % every:
            return False
        flag = torch.tensor([int(rank == 0
                                 and time.perf_counter() - start >= seconds)])
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=group)
        return bool(flag.item())
    return stop


def _fault(name: str):
    """A fault planted under the sharded chain (tests): the exchange
    between the ranks left out, each shard starting from the stream's
    incoming state as if it were the first."""
    if name != "no_exchange":
        raise ValueError(f"unknown fault {name!r}")
    from simpledsp_tpu_torch.kernels import chain as kchain

    def shard_states(group, shard_powers, s0, k_shard):
        import torch
        apow = torch.as_tensor(shard_powers, dtype=s0.dtype,
                               device=s0.device)
        return s0, s0 @ apow[-1].T + k_shard
    kchain._shard_states = shard_states


def rank_main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m dspbench.pod")
    for name in ("--rank", "--world"):
        p.add_argument(name, type=int, required=True)
    p.add_argument("--dir", required=True)
    p.add_argument("--cell", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--sizes", default="[{}, {}]")
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault")
    args = p.parse_args(argv)
    set_cache_dirs()
    import torch
    import torch.distributed as dist
    from simpledsp_tpu_torch.parallel.mesh import (backend, make_mesh,
                                                   mesh_device)
    torch.set_num_threads(4 if args.device == "cuda" else 1)
    cell = Cell.from_entry(Registry(), json.loads(args.cell),
                           *json.loads(args.sizes))
    dist.init_process_group(
        backend(torch.device(args.device)),
        init_method=f"file://{os.path.join(args.dir, 'store')}",
        rank=args.rank, world_size=args.world)
    records = []
    try:
        gloo = dist.new_group(backend="gloo")
        shape = cell.traffic["mesh"]
        mesh = make_mesh(shape["dp"], shape["sp"], args.device)
        device = mesh_device(mesh)
        if args.fault:
            _fault(args.fault)
        for seed in args.seeds:
            records.append(run_cell(
                cell, seed, args.seconds, bool(args.trace), device,
                mesh=mesh, control=args.control,
                stop_window=_stopper(args.seconds,
                                     cell.traffic["stop_every"], gloo,
                                     args.rank),
                before_window=lambda: dist.barrier(group=gloo)))
            dist.barrier(group=gloo)
    finally:
        dist.destroy_process_group()
    from simpledsp_tpu_torch.kernels import _build
    for record in records:
        record.update(build_seconds=dict(_build.build_seconds),
                      forbidden_modules=forbidden_modules(),
                      kind=(torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu"))
    with open(Path(args.dir) / f"rank{args.rank}.json", "w") as f:
        json.dump(records, f)
    return 0


if __name__ == "__main__":
    sys.exit(rank_main())
