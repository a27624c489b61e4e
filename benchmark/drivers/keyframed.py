"""Traffic kind ``keyframed``: each request is one ordered collection of
``n_views`` views through the program's ``demo.inference.must3r_inference``
(``is_sequence``: ``num_mem_images`` linspace keyframes build the memory
as [2, 1, 1, ...] steps, then every view is rendered against it, in chunks
of ``render_bs``; the encoder runs in chunks of ``encode_bs``), taking the
views as host numpy arrays and returning numpy outputs. Parameters:
``img_hw``, ``n_views``, ``num_mem_images``, ``encode_bs``, ``render_bs``,
``kv_quant`` (optional: 'int8'), ``input_pool``, ``checked_requests``
and ``checked_among`` (as in ``fused_bulk``),
``checked_views`` (views of a checked request compared, drawn from the
seed: the reference builds the whole memory and renders those). Where
the memory is stored 8-bit (``kv_quant``), the check also compares the
token memory that a checked request left, codes times scales, with the
reference's memory quantized alike (``memory``)."""

from __future__ import annotations

import random

import numpy as np
import torch

from benchmark import work
from benchmark.compare import memory_gap
from benchmark.offline import SAMPLE_SEED, OfflineDriver
from benchmark.reference import must3r as ref

KEYS = {"pts3d": "pts3d", "pts3d_local": "pts3d_local", "conf": "conf",
        "focal": "focals", "c2w": "cams2world"}


def keyframes(n_views: int, n_mem: int):
    """The linspace keyframes of an ordered collection, then the others:
    the processing order."""
    kf = list(dict.fromkeys(
        int(k) for k in np.linspace(0, n_views - 1, n_mem).astype(int)))
    return kf, kf + sorted(set(range(n_views)) - set(kf))


def memory_layers(mem):
    """A memory as per-layer (k, v) [H, S, Dh] float32: the program's
    ``MemoryState`` (packed (k | v) slots [L, B, H, S, 2 Dh], 8-bit codes
    times their scales [L, B, H, 2, S]), read over its filled slots of
    batch element 0; a list of (k, v) as it is."""
    if isinstance(mem, list):
        return mem
    n, dh = mem.length, mem.kv.shape[-1] // 2
    layers = []
    for layer in range(mem.kv.shape[0]):
        x = mem.kv[layer, 0, :, :n].float()
        k, v = x[..., :dh], x[..., dh:]
        if mem.kv_scale is not None:
            scale = mem.kv_scale[layer, 0, :, :, :n]
            k, v = k * scale[:, 0, :, None], v * scale[:, 1, :, None]
        layers.append((k, v))
    return layers


class Driver(OfflineDriver):

    def __init__(self, *args):
        super().__init__(*args)
        self.checks_memory = self.t.get("kv_quant") is not None
        self.memory = None            # the memory the last request left
        self.memories = {}            # request -> its memory, if checked

    def _load(self, enc, dec, enc_cfg, dec_cfg):
        from must3r_tpu_torch.engine.inference import InferenceCore
        self.core = InferenceCore(enc, dec, enc_cfg, dec_cfg,
                                  dtype=torch.bfloat16,
                                  kv_quant=self.t.get("kv_quant"))
        if self.checks_memory:
            update = self.core.update

            def update_and_keep(mem, *a, **k):
                mem, toks = update(mem, *a, **k)
                self.memory = mem
                return mem, toks
            self.core.update = update_and_keep

    def request(self, i: int) -> int:
        # the last request's memory goes before this one makes its own,
        # unless the check compares it
        self.memory = None
        self.memories = {j: m for j, m in self.memories.items()
                         if j in self.kept.want}
        n = super().request(i)
        if self.memory is not None:
            self.memories[i], self.memory = self.memory, None
        return n

    def memory_gaps(self, i, ref_out):
        if not self.checks_memory:
            return {}
        mem = self.memories.get(i)
        if mem is None:
            return {"memory": float("inf")}
        return {"memory": memory_gap(memory_layers(mem), ref_out["memory"])}

    def make_inputs(self):
        """Each stack as the list of per-view dicts a caller hands over."""
        h, w = self.hw
        return [[{"img": v.numpy(), "true_shape": np.array([h, w]),
                  "portrait": False} for v in stack[0]]
                for stack in super().make_inputs()]

    def _call(self, views):
        from must3r_tpu_torch.demo.inference import must3r_inference
        scene = must3r_inference(
            self.core, views, num_mem_images=int(self.t["num_mem_images"]),
            is_sequence=True, encode_bs=int(self.t["encode_bs"]),
            render_bs=int(self.t["render_bs"]))
        return {k: getattr(scene, a)[None] for k, a in KEYS.items()}

    def _work(self):
        n_mem = len(keyframes(self.n_views, int(self.t["num_mem_images"]))[0])
        return work.offline_request(
            self.cfg, self.hw, self.n_views, n_mem, 2, 1,
            1 if self.t.get("kv_quant") else work.BF16)

    def checked_views(self):
        return sorted(random.Random(self.seed + SAMPLE_SEED).sample(
            range(self.n_views), int(self.t["checked_views"])))

    def reference_outputs(self, weights, i, scene, nm=ref.REFERENCE):
        """The checked views' outputs: the keyframes build the memory, the
        checked views are rendered against it."""
        views = self.pool[i % len(self.pool)]
        kf, _ = keyframes(self.n_views, int(self.t["num_mem_images"]))
        checked = self.checked_views()
        extra = [j for j in checked if j not in kf]
        encoded = kf + extra
        imgs = torch.from_numpy(np.stack([views[j]["img"] for j in encoded]))
        return ref.reconstruct(weights, self.cfg, imgs.to(self.dev),
                               n_mem=len(kf), nm=nm,
                               render=[encoded.index(j) for j in checked],
                               keep_memory=self.checks_memory)
