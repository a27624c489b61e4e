"""What the offline traffic drivers share: weights and inputs from the seed,
one request at a time, a sample of the requests' outputs kept for the
check, and the check against the reference once the window has closed.

A driver subclass sets ``per_request`` (views a request completes) and
implements ``_load(enc, dec, enc_cfg, dec_cfg)`` (the program's entry),
``_call(imgs)`` (one request on a host stack of images [S, V, H, W, 3]:
the program's outputs as numpy [S, V, ...]) and ``_work()``;
``reference_outputs`` gives the reference's for the same images.
"""

from __future__ import annotations

import gc
from typing import Dict, List

import torch

from benchmark.compare import Sample, offline_gaps, worst
from benchmark.program import load_program_model
from benchmark.reference import must3r as ref
from benchmark.weights import make_weights

# offsets of the generators' seeds from the run's seed
INPUT_SEED, SAMPLE_SEED = 1, 2


class OfflineDriver:
    units = "views"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.t, self.seed, self.dev = cfg, traffic, seed, device
        self.hw = tuple(traffic["img_hw"])
        self.n_scenes = int(traffic.get("n_scenes", 1))
        self.n_views = int(traffic["n_views"])
        self.per_request = self.n_scenes * self.n_views
        self.kept = Sample(int(traffic["checked_requests"]),
                           int(traffic["checked_among"]), seed + SAMPLE_SEED)
        self.pool: List[torch.Tensor] = []

    # -- set-up ------------------------------------------------------------
    def make_inputs(self) -> List[torch.Tensor]:
        """``input_pool`` distinct host stacks [S, V, H, W, 3] float32 in
        [-1, 1), drawn on the device from the seed, then moved to the host
        (where a loader would hand them over)."""
        gen = torch.Generator(device=self.dev).manual_seed(
            self.seed + INPUT_SEED)
        shape = (self.n_scenes, self.n_views, *self.hw, 3)
        return [(torch.rand(shape, generator=gen, device=self.dev) * 2 - 1
                 ).cpu() for _ in range(int(self.t["input_pool"]))]

    def setup(self):
        from must3r_tpu_torch.ops.attention import reset_launch_counts

        enc, dec, enc_cfg, dec_cfg = load_program_model(self.cfg, self.seed,
                                                        self.dev)
        self._load(enc, dec, enc_cfg, dec_cfg)
        self.pool = self.make_inputs()
        for imgs in self.pool[:1]:          # every shape of the cell
            self._call(imgs)
        reset_launch_counts()

    # -- the window ------------------------------------------------------
    def request(self, i: int) -> int:
        out = self._call(self.pool[i % len(self.pool)])
        self.kept.offer(i, out)
        return self.per_request

    def counters(self) -> Dict[str, int]:
        from must3r_tpu_torch.ops.attention import launch_counts
        return launch_counts()

    def work(self):
        return self._work()

    # -- after the window --------------------------------------------------
    def free_program(self):
        for name in ("core", "entry"):
            if hasattr(self, name):
                delattr(self, name)
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def checked_views(self):
        """Views of a checked collection that are compared (all)."""
        return list(range(self.n_views))

    def reference_outputs(self, weights, i: int, scene: int,
                          nm: ref.Numerics = ref.REFERENCE) -> dict:
        """The reference's outputs of the checked views of collection
        ``scene`` of request ``i``."""
        raise NotImplementedError

    def numerics(self) -> ref.Numerics:
        """The reference's numerics: float32, and the memory's codes where
        the traffic stores it 8-bit."""
        q = self.t.get("kv_quant")
        return ref.Numerics(memory_qmax=None if q is None else
                            {"int8": 127.0}[q])

    def check(self) -> Dict[str, float]:
        self.free_program()
        ref.full_precision()
        weights = make_weights(self.cfg, self.seed, self.dev)
        rows = []
        with torch.no_grad():
            for i, out in self.kept.items:
                for s in range(self.n_scenes):
                    prog = {k: v[s][self.checked_views()]
                            for k, v in out.items()}
                    r = self.reference_outputs(weights, i, s, self.numerics())
                    rows.append({**offline_gaps(prog, r, self.camera(prog)),
                                 **self.memory_gaps(i, r)})
        return worst(rows)

    def memory_gaps(self, i: int, ref_out: dict) -> Dict[str, float]:
        """Numbers of the token memory that request ``i`` left (none)."""
        return {}

    def camera(self, prog, dtype=torch.float32) -> Dict[str, torch.Tensor]:
        """The reference's camera stage on the program's own pointmaps."""
        focal, c2w = ref.camera(*(torch.from_numpy(prog[k]).to(self.dev)
                                  for k in ("pts3d", "pts3d_local", "conf")),
                                dtype=dtype)
        return {"focal": focal, "c2w": c2w}
