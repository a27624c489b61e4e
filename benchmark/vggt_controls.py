"""The controls of ``correct`` in a ``vggt_scene`` cell: the reference one
step lower in precision, in the program's place, as a driver class of the
cell's kind that the harness runs like the program's
(``harness.run_cell(..., driver_cls=control(cell, name))``):

* ``fp8``: the reference with the operands of the aggregator's products
  (its linear maps, the patch embedding and both attention products)
  rounded to float8 e4m3, a step below the bfloat16 it is stated in;
* ``heads_bf16``: the reference with the camera and DPT heads in bfloat16,
  a step below the float32 they are stated in.

The control's ``heads_stage`` is its own heads against the float32
reference's on its own aggregator outputs; its cameras (``c2w``,
``focal``) are read from its pose encoding in the heads' dtype.

Readings for the limits, many seeds in one process (as ``calibrate.py``
reads the other cells):

    python3 benchmark/vggt_controls.py --workload <cell> --seeds 1 2 3 \\
        [--controls fp8 heads_bf16] [--out FILE] [--tiny]
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.drivers.vggt_scene import CAMERAS, OUTPUTS  # noqa: E402
from benchmark.harness import Cell, driver_class  # noqa: E402
from benchmark.reference import vggt as ref  # noqa: E402
from benchmark.vggt_weights import make_weights  # noqa: E402

NUMERICS = {"fp8": ref.Numerics(products="fp8"),
            "heads_bf16": ref.Numerics(heads_dtype="bfloat16")}


def names(cell: Cell) -> list:
    return list(NUMERICS)


def control(cell: Cell, name: str):
    nm = NUMERICS[name]

    class Control(driver_class(cell)):
        """The reference's outputs, in ``nm``, as a request's."""

        def setup(self):
            self.weights = make_weights(self.cfg, self.seed, self.dev)
            self.pool = self.make_inputs()
            self.staged = {}

        def _run(self, i):
            with torch.no_grad():
                out = ref.forward(self.weights, self.cfg, self.frames(i), nm,
                                  return_layers=True)
                out.update(ref.cameras(out["pose_enc"], self.hw,
                                       nm.heads_dtype))
            return out.pop("layers"), {k: out[k].cpu()
                                       for k in OUTPUTS + CAMERAS}

        def request(self, i):
            layers, out = self._run(i)
            if i in self.kept.want:
                self.staged[i] = layers, out
            self.kept.offer(i, {k: v.numpy() for k, v in out.items()})
            return self.per_request

        def stage(self, i):
            return self.staged.pop(i) if i in self.staged else self._run(i)

        def counters(self):
            return {}

        def free_program(self):
            self.__dict__.pop("weights", None)
            super().free_program()

    return Control


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--controls", nargs="*", default=list(NUMERICS))
    ap.add_argument("--out", default=None)
    ap.add_argument("--tiny", action="store_true",
                    help="rehearse on the CPU at the tests' tiny size")
    args = ap.parse_args(argv)

    from benchmark.harness import load_cell, run_cell

    if args.tiny:
        from benchmark.tests.tiny_vggt import tiny_vggt_cell
        cell, dev = tiny_vggt_cell(args.workload), "cpu"
    else:
        cell, dev = load_cell(args.workload), "cuda"
        if not torch.cuda.is_available():
            raise SystemExit("the readings are taken on the card")
    cell = copy.deepcopy(cell)
    k = int(cell.traffic["checked_requests"])
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
