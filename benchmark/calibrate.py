"""Readings that the limits of ``correct`` are set from, at a cell's own
size, many seeds in one process:

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 3 ... \\
        [--controls fp8 int4 ...] [--out FILE]

For each seed, one run of the harness (``harness.run_cell``) with the
program, then one with each control in the program's place
(``controls.py``; ``--controls`` with no name: none), each giving every
number its check computes and whether the cell's limits held. A run's
window is its first ``checked_requests`` requests (one training step),
which its check then compares.

One JSON line per seed on standard output (and in ``--out``).
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--controls", nargs="*", default=["fp8"])
    ap.add_argument("--out", default=None)
    ap.add_argument("--tiny", action="store_true",
                    help="rehearse on the CPU at the tests' tiny size")
    args = ap.parse_args(argv)

    import torch

    from benchmark.controls import control
    from benchmark.harness import load_cell, run_cell

    if args.tiny:
        from benchmark.tests.tiny import tiny_cell
        cell, dev = tiny_cell(args.workload), "cpu"
    else:
        cell, dev = load_cell(args.workload), "cuda"
        if not torch.cuda.is_available():
            raise SystemExit("calibrate runs on the card")
    cell = copy.deepcopy(cell)
    k = int(cell.traffic.get("checked_requests", 1))
    if "checked_among" in cell.traffic:
        cell.traffic["checked_among"] = k
    for seed in args.seeds:
        row = {"workload": cell.name, "seed": seed}
        for name in ["program", *args.controls]:
            t0 = time.time()
            logged = []
            result = run_cell(
                cell, seed, 0.0, False, device=dev, log=logged.append,
                driver_cls=None if name == "program" else control(cell, name),
                min_requests=k)
            row[name] = {"correct": result["correct"],
                         "numbers": next(json.loads(line)["numbers"]
                                         for line in logged
                                         if '"numbers"' in line),
                         "seconds": time.time() - t0}
            if dev == "cuda":
                torch.cuda.empty_cache()
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")


if __name__ == "__main__":
    main()
