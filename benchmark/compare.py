"""The numbers that decide ``correct``: gaps between what the timed path
produced and what the reference computes from the same weights and
inputs, each the worst over the views (or leaves) compared."""

from __future__ import annotations

import random
from typing import Dict, List

import numpy as np
import torch


def _f64(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x)).double()


def rel_gap(prog, ref) -> float:
    """Worst view's ||prog - ref|| / ||ref|| (views on the first axis)."""
    p, r = _f64(prog), _f64(ref).to(_f64(prog).device)
    v = p.shape[0]
    num = (p - r).reshape(v, -1).norm(dim=1)
    den = r.reshape(v, -1).norm(dim=1).clamp_min(1e-30)
    return float((num / den).max())


OFFLINE_KEYS = ("pts3d", "pts3d_local", "conf", "c2w")


def offline_gaps(prog: Dict[str, np.ndarray], ref: Dict[str, torch.Tensor],
                 stage: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Gaps of one collection's outputs, every view checked: against the
    reference's whole pipeline, and (``c2w_stage``) the program's pose
    against the reference's camera stage run on the program's own
    pointmaps (``stage``)."""
    out = {k: rel_gap(prog[k], ref[k].cpu()) for k in OFFLINE_KEYS}
    out["c2w_stage"] = rel_gap(prog["c2w"], stage["c2w"].cpu())
    return out


def memory_gap(prog, ref) -> float:
    """Worst layer's ||prog - ref|| / ||ref|| over the keys and the values
    of a token memory, each given per layer as (k, v) [H, S, Dh] (the
    program's as its codes times their scales); inf where the two hold
    different numbers of tokens."""
    gaps = []
    for (pk, pv), (rk, rv) in zip(prog, ref):
        for p, r in ((pk, rk), (pv, rv)):
            if p.shape != r.shape:
                return float("inf")
            p, r = p.double(), r.double().to(p.device)
            gaps.append(float((p - r).norm() / r.norm().clamp_min(1e-30)))
    return max(gaps) if gaps else float("inf")


def worst(rows: List[Dict[str, float]]) -> Dict[str, float]:
    return {k: max(r[k] for r in rows) for k in rows[0]}


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
             keep: List[str]) -> float:
    """Worst leaf's |norm - norm_ref| over the larger of its norm_ref and
    the median leaf's, over the leaves ``keep``."""
    med = float(np.median([ref[k] for k in keep]))
    return max(abs(prog[k] - ref[k]) / max(ref[k], med) for k in keep)


class Sample:
    """The requests the check compares: ``k`` request indices drawn from
    the seed among the first ``among`` of the window. A drawn request's
    outputs are kept; a drawn index that the window never reached is
    replaced by the window's last request."""

    def __init__(self, k: int, among: int, seed: int):
        self.k = k
        self.want = set(random.Random(seed).sample(range(among), k))
        self.kept: list = []
        self.last = None

    def offer(self, key, out):
        if key in self.want:
            self.kept.append((key, out))
        self.last = (key, out)

    @property
    def items(self) -> list:
        if len(self.kept) < self.k and self.last is not None and \
                self.last[0] not in self.want:
            return self.kept + [self.last]
        return self.kept
