"""Traffic kind ``train_step``: one optimizer step of the program's causal
training (``engine.train.make_train_step``) per request, on a batch made
on the device from the seed: ``batch`` samples of ``n_views`` views of
``img_hw`` in causal memory steps ``mem_batches``, ``render_ids``
rendered, token dropout ``dropout_p``, bf16, the encoder frozen, AdamW
(``weight_decay``, ``b1``, ``b2``) on a warm-up cosine schedule (``lr``:
base, warm-up steps, total steps). Set-up builds the one training step and
drives it from the seed through its first ``checked_steps`` steps (which
also warm up every shape), recording their losses, the first gradient as
the optimizer got it and the parameters' change; the window goes on
stepping the same object. The reference then follows those steps from
the same weights, batches and dropout draws."""

from __future__ import annotations

import gc
from typing import Dict, List

import numpy as np
import torch

from benchmark import work
from benchmark.compare import leaf_gap
from benchmark.program import load_program_model
from benchmark.reference import must3r as ref
from benchmark.reference import train as ref_train
from benchmark.weights import make_weights

BATCH_SEED, DROPOUT_SEED = 1, 2
# leaves whose reference gradient is under this share of the median
# leaf's move by round-off alone (a key projection's bias under softmax)
NULL_GRADIENT = 1e-3


def train_batch(gen: torch.Generator, dev, b: int, v: int, hw, patch: int,
                render_ids) -> dict:
    """A seeded batch on the device: images in [-1, 1), ground-truth
    points around distance 3, random camera translations, 90 % valid
    pixels, 5 % sky."""
    h, w = hw
    c2w = torch.eye(4, device=dev).expand(b, v, 4, 4).clone()
    c2w[..., :3, 3] = torch.randn(b, v, 3, generator=gen, device=dev)
    ys, xs = torch.meshgrid(torch.arange(h // patch, device=dev),
                            torch.arange(w // patch, device=dev),
                            indexing="ij")
    pos = torch.stack([ys, xs], -1).reshape(-1, 2).to(torch.int32)
    return {
        "img": torch.rand(b, v, h, w, 3, generator=gen, device=dev) * 2 - 1,
        "pos": pos.expand(b, v, -1, -1).contiguous(),
        "pts3d": torch.randn(b, v, h, w, 3, generator=gen, device=dev) + 3,
        "camera_pose": c2w,
        "valid_mask": torch.rand(b, v, h, w, generator=gen, device=dev) > 0.1,
        "sky_mask": torch.rand(b, v, h, w, generator=gen, device=dev) > 0.95,
        "is_metric_scale": torch.zeros(b, dtype=torch.bool, device=dev),
        "render_ids": torch.tensor(render_ids, device=dev),
    }


def gaps(prog, refr) -> Dict[str, float]:
    """The check's numbers: the relative loss gap of each step and the
    worst of them; the worst leaf's gap of the first gradient's norm and
    of the change's norm (leaves with a null reference gradient left
    out). The harness compares those that ``limits/<cell>.json`` names."""
    (p_loss, p_grad, p_change), (r_loss, r_grad, r_change) = prog, refr
    med = float(np.median(list(r_grad.values())))
    keep = [k for k, g in r_grad.items() if g >= NULL_GRADIENT * med]
    steps = [abs(p - r) / abs(r) for p, r in zip(p_loss, r_loss)]
    return {"loss": max(steps),
            **{f"loss_step{i + 1}": g for i, g in enumerate(steps)},
            "grad": leaf_gap(p_grad, r_grad, keep),
            "update": leaf_gap(p_change, r_change, keep)}


class Driver:
    units = "steps"
    gaps = staticmethod(gaps)

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.t, self.seed, self.dev = cfg, traffic, seed, device
        self.hw = tuple(traffic["img_hw"])
        self.mem_batches = tuple(int(g) for g in traffic["mem_batches"])
        self.n_views = sum(self.mem_batches)
        self.b = int(traffic["batch"])
        self.n_checked = int(traffic["checked_steps"])
        n = work.tokens_per_view(cfg, self.hw)
        block = int(traffic["capacity_block"])
        self.capacity = -(-self.n_views * n // block) * block

    def _gens(self):
        return (torch.Generator(device=self.dev).manual_seed(
                    self.seed + BATCH_SEED),
                torch.Generator(device=self.dev).manual_seed(
                    self.seed + DROPOUT_SEED))

    def next_batch(self, gen) -> dict:
        return train_batch(gen, self.dev, self.b, self.n_views, self.hw,
                           self.cfg["decoder"]["patch_size"],
                           self.t["render_ids"])

    # -- set-up and window ------------------------------------------------
    def setup(self):
        from must3r_tpu_torch.engine.train import (TrainSettings,
                                                   cast_frozen_params,
                                                   cosine_schedule,
                                                   make_optimizer,
                                                   make_train_step,
                                                   trainable_subset)
        from must3r_tpu_torch.ops.attention import reset_launch_counts

        t = self.t
        enc, dec, enc_cfg, dec_cfg = load_program_model(
            self.cfg, self.seed, self.dev, causal=True)
        ts = TrainSettings(mem_batches=self.mem_batches,
                           n_render=len(t["render_ids"]),
                           dropout_p=float(t["dropout_p"]),
                           capacity_block=int(t["capacity_block"]),
                           dtype="bfloat16")
        self.params = cast_frozen_params({"encoder": enc, "decoder": dec}, ts)
        opt = make_optimizer(cosine_schedule(*t["lr"]),
                             weight_decay=float(t["weight_decay"]),
                             b1=float(t["b1"]), b2=float(t["b2"]))
        train = trainable_subset(self.params, ts)
        self.state = opt.init(train)
        self.step = make_train_step(enc_cfg, dec_cfg, ts, opt)
        self.batch_gen, self.drop_gen = self._gens()
        start = {k: p.detach().clone() for k, p in train.items()}
        self.losses: List[float] = []
        for s in range(self.n_checked):
            self.request(-1 - s)
            if s == 0:
                self.grad_norms = {
                    k: float(m.norm()) / (1.0 - float(t["b1"]))
                    for k, m in self.state["mu"].items()}
        self.change_norms = {k: float((p.detach() - start[k]).norm())
                             for k, p in train.items()}
        del start
        reset_launch_counts()

    def request(self, i: int) -> int:
        batch = self.next_batch(self.batch_gen)
        self.params, self.state, loss, _ = self.step(
            self.params, self.state, batch, self.drop_gen)
        loss = float(loss)                  # waits for the whole step
        if i < 0:
            self.losses.append(loss)
        return 1

    def counters(self) -> Dict[str, int]:
        from must3r_tpu_torch.ops.attention import launch_counts
        return launch_counts()

    def work(self):
        return work.train_step(self.cfg, self.hw, self.b, self.mem_batches,
                               len(self.t["render_ids"]),
                               float(self.t["dropout_p"]),
                               int(self.cfg["decoder"].get("protected_imgs",
                                                           1)))

    # -- after the window --------------------------------------------------
    def recipe(self) -> dict:
        return {"mem_batches": self.mem_batches,
                "render_ids": list(self.t["render_ids"]),
                "protected_imgs": int(self.cfg["decoder"].get(
                    "protected_imgs", 1)),
                "alpha": float(self.t["alpha"]),
                "sky_loss_value": float(self.t["sky_loss_value"])}

    def reference_steps(self, nm: ref.Numerics = ref.REFERENCE, fault=None):
        """(losses, first gradient norms, change norms) of the reference
        over the checked steps, from the same weights, batches and
        dropout draws (``fault``: see ``ref_train.loss_and_grads``)."""
        t = self.t
        ref.full_precision()
        weights = make_weights(self.cfg, self.seed, self.dev)
        train = {k: w.requires_grad_(True) for k, w in weights.items()
                 if k.startswith("decoder.")}
        start = {k: w.detach().clone() for k, w in train.items()}
        opt = ref_train.AdamW(ref_train.cosine_lr(*t["lr"]),
                              float(t["weight_decay"]), float(t["b1"]),
                              float(t["b2"]))
        batch_gen, drop_gen = self._gens()
        losses, grad_norms = [], {}
        for s in range(self.n_checked):
            batch = self.next_batch(batch_gen)
            draws = [torch.rand((self.b, g, self.capacity), generator=drop_gen,
                                device=self.dev) < float(t["dropout_p"])
                     for g in self.mem_batches]
            loss, grads = ref_train.loss_and_grads(
                weights, self.cfg, batch, draws, self.recipe(), nm,
                samples=int(t["reference_samples"]), fault=fault)
            losses.append(loss)
            if s == 0:
                grad_norms = {k: float(g.norm()) for k, g in grads.items()}
            opt.step(train, grads)
        change = {k: float((w.detach() - start[k]).norm())
                  for k, w in train.items()}
        return losses, grad_norms, change

    def readings(self):
        """The program's (losses, first gradient norms, change norms)."""
        return self.losses, self.grad_norms, self.change_norms

    def free_program(self):
        for name in ("params", "state", "step"):
            if hasattr(self, name):
                delattr(self, name)
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> Dict[str, float]:
        self.free_program()
        return self.gaps(self.readings(), self.reference_steps())

