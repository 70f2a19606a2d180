"""The readings that a cell's limits are set from: the program's sound runs
and the control's, over many seeds in one process.

    python3 -m dspbench.controls --workload <cell> --seeds 1 2 3 \\
        [--seconds 2] [--control]

Each seed runs the cell as the benchmark does (``harness.run_cell``: the
pool made from the seed, the warm-up, a window of ``--seconds`` at the
cell's own load, the check of the kept calls), with the program, or with
``--control`` the cell's control in the program's place (the system's
``control``: the chain's matmuls in TF32; the bank's reference computed in
TF32).  A cell over several cards runs its ranks once for all the seeds
(``pod.spawn``) and reads each number as the worst over the ranks.  Prints
a JSON line a seed and, last, the largest and the smallest reading of each
number.  The benchmark's runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys

from dspbench.harness import Cell, run_cell, set_cache_dirs, worse
from dspbench.registry import Registry


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m dspbench.controls")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--control", action="store_true")
    args = p.parse_args(argv)
    set_cache_dirs()
    import torch
    cell = Cell.load(Registry(), args.workload)
    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"dspbench.controls: needs {chips} CUDA card(s)",
              file=sys.stderr)
        return 2
    if cell.traffic.get("ranks", 1) > 1:
        from dspbench.pod import spawn
        runs = spawn(cell, args.seeds, args.seconds, False,
                     control=args.control)
    else:
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        runs = [[run_cell(cell, seed, args.seconds, False, device,
                          control=args.control)] for seed in args.seeds]
    readings = {}
    for seed, records in zip(args.seeds, runs):
        numbers = {}
        for r in records:
            for name, value in r["numbers"].items():
                numbers[name] = worse(numbers.get(name, 0.0), value)
                readings.setdefault(name, [])
        print(json.dumps({"seed": seed, "control": args.control,
                          "numbers": numbers,
                          "calls": records[0]["attempted"]}), flush=True)
        for name, value in numbers.items():
            readings[name].append(value)
    print(json.dumps({"workload": args.workload, "control": args.control,
                      "seeds": len(args.seeds),
                      "largest": {k: max(v) for k, v in readings.items()},
                      "smallest": {k: min(v) for k, v in readings.items()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
