"""Traffic kind ``vggt_scene``: each request is ``n_scenes`` (1) scene of
``n_views`` frames of ``img_hw``, host float32 images in [0, 1], through
the program's ``demo.inference.vggt_inference`` (one pinned upload, VGGT
in one pass, one pinned fetch of every output as numpy). Parameters:
``img_hw``, ``n_views``, ``n_scenes``, ``input_pool`` (distinct scenes
cycled through), ``checked_requests`` (requests the check compares, drawn
from the seed among the first ``checked_among``).

The check compares, over every frame of a checked request, the worst
frame's relative gap of each output (``world_points``,
``world_points_conf``, ``depth``, ``depth_conf``, ``pose_enc``) with the
float32 reference (``reference/vggt.py``) on the same weights and frames;
``heads_stage``: the program's camera and DPT heads against the
reference's, both run on the program's own aggregator outputs of that
request (the program run again on it after the window), the worst of the
five outputs' gaps; and ``cameras_stage``: the program's ``c2w``, and its
``focal`` over the frames whose fields of view are both positive (a field
of view of 0 makes the focal infinite), against the reference's reading
of the program's own ``pose_enc``, the worse of the two gaps.
"""

from __future__ import annotations

import gc
from typing import Dict, List

import numpy as np
import torch

from benchmark.compare import Sample, rel_gap, worst
from benchmark.offline import INPUT_SEED, SAMPLE_SEED
from benchmark.reference import vggt as ref
from benchmark.vggt_weights import make_weights
from benchmark.vggt_work import vggt_request

OUTPUTS = ("world_points", "world_points_conf", "depth", "depth_conf",
           "pose_enc")
CAMERAS = ("c2w", "focal")


def camera_gap(out, hw) -> float:
    """``cameras_stage`` of one request's outputs (module docstring)."""
    enc = torch.as_tensor(np.asarray(out["pose_enc"]))
    rc = ref.cameras(enc, hw)
    gap = rel_gap(out["c2w"], rc["c2w"])
    seen = (enc[:, 7:] > 0).all(-1).numpy()
    if seen.any():
        gap = max(gap, rel_gap(np.asarray(out["focal"])[seen],
                               rc["focal"][seen]))
    return gap


def program_config(cfg: dict):
    """The program's ``VGGTConfig`` of a configuration file."""
    from must3r_tpu_torch.config import RoPEConfig, VGGTConfig

    enc, dec = cfg["encoder"], cfg["decoder"]
    cam, dpt = cfg["camera_head"], cfg["dpt_head"]
    if cam["dim"] != 2 * dec["embed_dim"] or \
            enc["num_heads"] != dec["num_heads"]:
        raise ValueError("the program ties the camera width to twice the "
                         "aggregator's and the tower's heads to its")
    return VGGTConfig(
        img_size=enc["img_size"], patch_size=enc["patch_size"],
        embed_dim=enc["embed_dim"], num_heads=dec["num_heads"],
        mlp_ratio=float(dec["mlp_ratio"]), tower_depth=enc["depth"],
        num_register_tokens=enc["num_register_tokens"],
        tower_ln_eps=enc["ln_eps"], depth=dec["depth"], ln_eps=dec["ln_eps"],
        rope=RoPEConfig(base=float(dec["rope_base"])),
        camera_trunk_depth=cam["trunk_depth"],
        camera_num_heads=cam["num_heads"],
        camera_iterations=cam["iterations"], dpt_features=dpt["features"],
        dpt_out_channels=tuple(dpt["out_channels"]),
        dpt_layers=tuple(dpt["layers"]),
        dpt_frames_chunk=dpt["frames_chunk"])


class Driver:
    units = "views"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.t, self.seed, self.dev = cfg, traffic, seed, device
        self.hw = tuple(traffic["img_hw"])
        self.n_views = int(traffic["n_views"])
        if int(traffic.get("n_scenes", 1)) != 1:
            raise ValueError("vggt_scene takes one scene a request")
        self.per_request = self.n_views
        self.kept = Sample(int(traffic["checked_requests"]),
                           int(traffic["checked_among"]), seed + SAMPLE_SEED)
        self.pool: List[List[np.ndarray]] = []

    # -- set-up ------------------------------------------------------------
    def make_inputs(self) -> List[List[np.ndarray]]:
        """``input_pool`` distinct scenes, each a list of host float32
        frames [H, W, 3] in [0, 1), drawn on the device from the seed."""
        gen = torch.Generator(device=self.dev).manual_seed(
            self.seed + INPUT_SEED)
        shape = (self.n_views, *self.hw, 3)
        return [list(torch.rand(shape, generator=gen, device=self.dev)
                     .cpu().numpy()) for _ in range(int(self.t["input_pool"]))]

    def setup(self):
        from must3r_tpu_torch.checkpoint import load_vggt
        from must3r_tpu_torch.engine.inference import VGGTCore

        weights = make_weights(self.cfg, self.seed, self.dev)
        model = load_vggt(weights, program_config(self.cfg), self.dev)
        del weights
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        dtype = getattr(torch, self.cfg["dtype"])
        self.core = VGGTCore(model, dtype=dtype)
        self.pool = self.make_inputs()
        self._call(self.pool[0])            # every shape of the cell
        self.reset_counters()

    def _call(self, frames) -> Dict[str, np.ndarray]:
        from must3r_tpu_torch.demo.inference import vggt_inference
        return vggt_inference(self.core, frames)

    # -- the window --------------------------------------------------------
    def request(self, i: int) -> int:
        out = self._call(self.pool[i % len(self.pool)])
        self.kept.offer(i, {k: out[k] for k in OUTPUTS + CAMERAS})
        return self.per_request

    def reset_counters(self):
        from must3r_tpu_torch.models.vggt import reset_vggt_counts
        from must3r_tpu_torch.ops.attention import reset_launch_counts
        reset_launch_counts()
        reset_vggt_counts()

    def counters(self) -> Dict[str, int]:
        from must3r_tpu_torch.models.vggt import vggt_counts
        from must3r_tpu_torch.ops.attention import launch_counts
        return {**launch_counts(), **vggt_counts()}

    def work(self):
        return vggt_request(self.cfg, self.hw, self.n_views)

    # -- after the window --------------------------------------------------
    def frames(self, i: int) -> torch.Tensor:
        return torch.from_numpy(np.stack(self.pool[i % len(self.pool)])
                                ).to(self.dev)

    def stage(self, i: int):
        """(the aggregator's kept iterations, the heads' outputs) of the
        program on request ``i``'s scene, run again."""
        from must3r_tpu_torch.engine.inference import vggt_reconstruction
        out = vggt_reconstruction(self.core, self.frames(i),
                                  return_layers=True)
        return out["layers"], {k: out[k].cpu() for k in OUTPUTS}

    def free_program(self):
        self.__dict__.pop("core", None)
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def numerics(self) -> ref.Numerics:
        return ref.REFERENCE

    def check(self) -> Dict[str, float]:
        with torch.no_grad():
            stages = {i: self.stage(i) for i, _ in self.kept.items}
        self.free_program()
        ref.full_precision()
        weights = make_weights(self.cfg, self.seed, self.dev)
        rows = []
        with torch.no_grad():
            for i, out in self.kept.items:
                r = ref.forward(weights, self.cfg, self.frames(i),
                                self.numerics())
                row = {k: rel_gap(out[k], r[k].cpu()) for k in OUTPUTS}
                del r
                layers, heads = stages.pop(i)
                rh = ref.heads(weights, self.cfg,
                               {k: v.float() for k, v in layers.items()},
                               self.hw)
                del layers
                row["heads_stage"] = max(rel_gap(heads[k], rh[k].cpu())
                                         for k in OUTPUTS)
                row["cameras_stage"] = camera_gap(out, self.hw)
                rows.append(row)
        return worst(rows)
