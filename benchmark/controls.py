"""The controls of ``correct``: what is put in the program's place to show
that the check fails it. ``control(cell, name)`` is a driver class of the
cell's own kind, which the harness runs like the program's
(``harness.run_cell(..., driver_cls=control(cell, name))``):

* ``fp8`` (every cell): the reference with the operands of every product
  rounded to float8 e4m3, a step below the bfloat16 that the
  configurations state (offline, its camera stage in bfloat16 too);
* ``int4`` (offline cells whose memory is 8-bit): the reference in float32
  with its token memory quantized to int4 codes, a step below the int8
  memory that the cell states;
* ``half_batch``, ``token`` (training): the reference with the loss and
  gradient of half of the batch, or with one token of the decoder's
  output altered where it is produced.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.harness import Cell, driver_class
from benchmark.reference import must3r as ref
from benchmark.weights import make_weights

INT4 = 7.0


def names(cell: Cell) -> list:
    """The controls that apply to ``cell``."""
    if cell.traffic["kind"] == "train_step":
        return ["fp8", "half_batch", "token"]
    return ["fp8"] + (["int4"] if cell.traffic.get("kv_quant") else [])


def control(cell: Cell, name: str):
    if name not in names(cell):
        raise ValueError(f"no control {name!r} for {cell.name} "
                         f"(have {names(cell)})")
    base = driver_class(cell)
    if cell.traffic["kind"] == "train_step":
        return _train(base, ({"nm": ref.Numerics("fp8")} if name == "fp8"
                             else {"fault": name}))
    if name == "fp8":
        return _offline(base, lambda q: ref.Numerics("fp8", q),
                        torch.bfloat16)
    return _offline(base, lambda q: ref.Numerics("fp32", INT4),
                    torch.float32)


def _offline(base, numerics, camera_dtype):
    class Control(base):
        """The reference's outputs of the checked views (zeros for the
        others), and its memory, as a request's."""

        def setup(self):
            self.weights = make_weights(self.cfg, self.seed, self.dev)
            self.pool = self.make_inputs()

        def _call(self, imgs):
            i = next(j for j, p in enumerate(self.pool) if p is imgs)
            nm = numerics(self.numerics().memory_qmax)
            views = self.checked_views()
            outs = []
            for s in range(self.n_scenes):
                c = self.reference_outputs(self.weights, i, s, nm)
                self.memory = c.pop("memory", None)
                c = {k: v.cpu().numpy() for k, v in c.items()}
                c["c2w"] = self.camera(c, camera_dtype)["c2w"].cpu().numpy()
                full = {}
                for k, v in c.items():
                    full[k] = np.zeros((self.n_views, *v.shape[1:]), v.dtype)
                    full[k][views] = v
                outs.append(full)
            return {k: np.stack([o[k] for o in outs]) for k in outs[0]}

        def free_program(self):
            self.__dict__.pop("weights", None)
            super().free_program()

    return Control


def _train(base, kw):
    class Control(base):
        """The reference's checked steps as the program's readings."""

        def setup(self):
            self.losses, self.grad_norms, self.change_norms = \
                self.reference_steps(**kw)

        def request(self, i):
            return 1

        def free_program(self):
            pass

    return Control
