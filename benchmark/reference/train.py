"""Plain training step of MUSt3R in PyTorch: the benchmark's reference for
the training cells. Imports nothing of the program under test.

One step of the published recipe (MUSt3R's causal training):

* the frozen encoder over every view;
* causal memory steps over ``mem_batches`` (blocks of views), each with its
  token dropout: a Bernoulli(p) draw over the memory's slots per image of
  the step, blocking the slots it hits except the protected prefix (the
  tokens of the first ``protected_imgs`` images);
* the rendered views against the final memory;
* the head, the norm-exp activations and ConfLoss(Regr3D(L21)): ground
  truth in view 0's camera frame (global) and in each view's own frame
  (local), both pointmaps normalised by their average distance over the
  valid pixels of a sample ('?avg_dis': a sample that is not metric scale
  normalises its prediction by its own), sky pixels counted with the loss
  fixed at ``sky_loss_value``, conf-weighted with ``- alpha * log conf``,
  each term a mean over the masked pixels of the whole batch;
* AdamW as the JAX package's optax chain: Adam (b1, b2, eps 1e-8, bias
  corrected), plus weight decay on the decayed set (every parameter of a
  transformer block, and the other parameters of two or more dims except
  ``image2_embed``), times -lr(step) of a linear warm-up from 0 and a
  cosine decay.

The loss is a sum over samples of per-sample terms over whole-batch pixel
counts, so the step runs ``samples`` samples at a time and adds their
gradients: the result is the whole batch's.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List

import torch

from benchmark.reference.must3r import (REFERENCE, Numerics, decoder_render,
                                        decoder_update, empty_memory, encode,
                                        head, norm_exp)


def cosine_lr(base: float, warmup: int, total: int) -> Callable[[int], float]:
    """Linear from 0 over ``warmup`` steps, then a cosine to 0 at
    ``total``."""
    def lr(step: int) -> float:
        if step < warmup:
            return base * step / warmup
        t = min(step - warmup, total - warmup)
        return base * 0.5 * (1.0 + math.cos(math.pi * t / (total - warmup)))
    return lr


def decayed(name: str, p: torch.Tensor) -> bool:
    if ".blocks_" in name:
        return True
    return p.dim() >= 2 and not name.endswith("image2_embed")


def _inv_se3(t: torch.Tensor) -> torch.Tensor:
    r = t[..., :3, :3].transpose(-1, -2)
    out = torch.zeros_like(t)
    out[..., :3, :3] = r
    out[..., :3, 3] = -(r @ t[..., :3, 3:4])[..., 0]
    out[..., 3, 3] = 1.0
    return out


def _apply(t: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """t [..., 4, 4] applied to pts [..., M, 3]."""
    return pts @ t[..., :3, :3].transpose(-1, -2) + t[..., None, :3, 3]


def _avg_dist(pts, valid):
    """[B] mean distance over the valid pixels of each sample."""
    b = pts.shape[0]
    d = torch.where(valid[..., None], pts, torch.zeros_like(pts)).norm(dim=-1)
    return (d.reshape(b, -1).sum(-1)
            / (valid.reshape(b, -1).sum(-1) + 1e-8)).clamp_min(1e-8)


def loss_terms(gt: dict, pred: dict, alpha: float, sky_value: float):
    """Per-sample numerators and the masks of the two ConfLoss terms.
    Returns ([num_global, num_local] each [B], [mask_global, mask_local])."""
    b, v, h, w, _ = gt["pts3d"].shape
    w2c = _inv_se3(gt["camera_pose"])
    flat = gt["pts3d"].reshape(b, v, h * w, 3)
    gt_l = _apply(w2c, flat).reshape(b, v, h, w, 3)
    gt_g = _apply(w2c[:, :1], flat.reshape(b, 1, -1, 3)).reshape(
        b, v, h, w, 3)
    valid = gt["valid_mask"]
    f_gt = _avg_dist(gt_g, valid).reshape(b, 1, 1, 1, 1)
    f_pr = _avg_dist(pred["pts3d"], valid).reshape(b, 1, 1, 1, 1)
    metric = gt["is_metric_scale"].reshape(b, 1, 1, 1, 1)
    f_pr = torch.where(metric, f_gt, f_pr)
    sky = gt["sky_mask"] & ~valid
    log_conf = torch.log(pred["conf"].clamp_min(1e-8))
    nums, masks = [], []
    for g_t, p_t in ((gt_g, pred["pts3d"]), (gt_l, pred["pts3d_local"])):
        err = (p_t / f_pr - g_t / f_gt).norm(dim=-1)
        err = torch.where(sky, torch.full_like(err, sky_value), err)
        mask = valid | sky
        term = err * pred["conf"] - alpha * log_conf
        nums.append(torch.where(mask, term, torch.zeros_like(term)
                                ).reshape(b, -1).sum(-1))
        masks.append(mask)
    return nums, masks


def forward(W, cfg: dict, x_enc, pos, hw, draws: List[torch.Tensor],
            recipe: dict, nm: Numerics, alter_token: bool = False):
    """Predictions of the decoder for a block of samples: x_enc [B, V, N,
    D] frozen encoder tokens, pos [B, V, N, 2], ``draws`` the dropout draws
    [B, G, S] of each memory step (True = fires). Returns pred over the
    memory views, then the rendered views."""
    dec = cfg["decoder"]
    b = x_enc.shape[0]
    mem = empty_memory(dec, b, x_enc.device)
    toks, cur = [], 0
    for g, drw in zip(recipe["mem_batches"], draws):
        slots = torch.arange(drw.shape[-1], device=drw.device)
        drop = drw & (slots >= mem.protected_tokens)
        toks.append(decoder_update(W, dec, mem, x_enc[:, cur:cur + g],
                                   pos[:, cur:cur + g], nm, causal=True,
                                   drop=drop,
                                   protected_limit=recipe["protected_imgs"]))
        cur += g
    ids = list(recipe["render_ids"])
    toks.append(decoder_render(W, dec, mem, x_enc[:, ids], pos[:, ids], nm))
    toks = torch.cat(toks, dim=1)
    if alter_token:                 # a fault: one output token changed
        toks = toks.clone()
        toks[0, 0, 0] = -toks[0, 0, 0]
    raw = head(W, dec, toks, hw)
    return {"pts3d": norm_exp(raw[..., :3]),
            "pts3d_local": norm_exp(raw[..., 3:6]),
            "conf": 1.0 + torch.exp(raw[..., 6])}


def loss_and_grads(W, cfg: dict, batch: dict, draws: List[torch.Tensor],
                   recipe: dict, nm: Numerics = REFERENCE, samples: int = 2,
                   fault=None):
    """The whole batch's loss and the gradient of every decoder parameter
    (``W``'s leaves that require grad), ``samples`` samples at a time.
    ``fault`` plants one for the check's own test: "half_batch" (the
    first half of the batch alone, the mean over it) or "token" (one
    output token altered)."""
    if fault == "half_batch":
        half = batch["img"].shape[0] // 2
        batch = {k: (v[:half] if k not in ("render_ids",) else v)
                 for k, v in batch.items()}
        draws = [d[:half] for d in draws]
    b = batch["img"].shape[0]
    with torch.no_grad():
        imgs = batch["img"]
        x_enc = encode(W, cfg["encoder"], imgs.reshape(-1, *imgs.shape[2:]),
                       nm).reshape(b, imgs.shape[1], -1,
                                   cfg["encoder"]["embed_dim"])
    train = {k: t for k, t in W.items() if t.requires_grad}
    grads = {k: torch.zeros_like(t) for k, t in train.items()}
    ids = list(range(sum(recipe["mem_batches"]))) + list(recipe["render_ids"])
    gt = {k: batch[k][:, ids] for k in ("pts3d", "camera_pose", "valid_mask",
                                        "sky_mask")}
    gt["is_metric_scale"] = batch["is_metric_scale"]
    valid, sky = gt["valid_mask"], gt["sky_mask"] & ~gt["valid_mask"]
    count = (valid | sky).sum().clamp_min(1).float()
    total = 0.0
    for s0 in range(0, b, samples):
        sl = slice(s0, s0 + samples)
        pred = forward(W, cfg, x_enc[sl], batch["pos"][sl],
                       batch["img"].shape[2:4], [d[sl] for d in draws],
                       recipe, nm, alter_token=fault == "token" and s0 == 0)
        nums, _ = loss_terms({k: t[sl] for k, t in gt.items()}, pred,
                             recipe["alpha"], recipe["sky_loss_value"])
        loss = (nums[0].sum() + nums[1].sum()) / count
        got = torch.autograd.grad(loss, list(train.values()),
                                  allow_unused=True)
        for k, gk in zip(train, got):
            if gk is not None:
                grads[k] += gk
        total += float(loss.detach())
    return total, grads


class AdamW:
    """The optax chain of the recipe over named float32 leaves."""

    def __init__(self, lr: Callable[[int], float], weight_decay: float,
                 b1: float, b2: float, eps: float = 1e-8):
        self.lr, self.wd, self.b1, self.b2, self.eps = (lr, weight_decay,
                                                        b1, b2, eps)
        self.count = 0
        self.mu: Dict[str, torch.Tensor] = {}
        self.nu: Dict[str, torch.Tensor] = {}

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads):
        lr = self.lr(self.count)
        self.count += 1
        c1, c2 = 1 - self.b1 ** self.count, 1 - self.b2 ** self.count
        for k, p in params.items():
            g = grads[k]
            mu = self.mu.get(k, torch.zeros_like(g))
            nu = self.nu.get(k, torch.zeros_like(g))
            self.mu[k] = self.b1 * mu + (1 - self.b1) * g
            self.nu[k] = self.b2 * nu + (1 - self.b2) * g * g
            u = (self.mu[k] / c1) / ((self.nu[k] / c2).sqrt() + self.eps)
            if self.wd and decayed(k, p):
                u = u + self.wd * p
            p.sub_(lr * u)
