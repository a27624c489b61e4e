"""Traffic kind ``fused_bulk``: each request reconstructs ``n_scenes``
collections of ``n_views`` views at once, on the scene axis of the
program's ``engine.inference.make_fused_offline`` (encode every view, a
memory of [``init_images``, 1, 1, ...] steps per collection, render every
view, head and postprocess), from a host stack of images uploaded by the
call; the outputs (pts3d, pts3d_local, conf, focal, c2w) are fetched to
the host with a plain ``.cpu()``, as a caller of the entry does. Parameters:
``img_hw``, ``n_views``, ``n_scenes``, ``init_images``, ``kv_quant``
(optional: 'int8'), ``input_pool`` (distinct stacks cycled through),
``checked_requests`` (requests the check compares, drawn from the seed
among the first ``checked_among``)."""

from __future__ import annotations

import torch

from benchmark import work
from benchmark.offline import OfflineDriver
from benchmark.reference import must3r as ref


class Driver(OfflineDriver):

    def _load(self, enc, dec, enc_cfg, dec_cfg):
        from must3r_tpu_torch.engine.inference import (InferenceCore,
                                                       make_fused_offline)
        self.core = InferenceCore(enc, dec, enc_cfg, dec_cfg,
                                  dtype=torch.bfloat16,
                                  kv_quant=self.t.get("kv_quant"))
        self.entry = make_fused_offline(
            self.core, self.n_views, self.hw,
            init_num_images=int(self.t["init_images"]),
            n_scenes=self.n_scenes)

    def _call(self, imgs):
        return {k: v.cpu().numpy() for k, v in self.entry(imgs).items()}

    def _work(self):
        return work.offline_request(
            self.cfg, self.hw, self.n_views, self.n_views,
            int(self.t["init_images"]), self.n_scenes,
            1 if self.t.get("kv_quant") else work.BF16)

    def reference_outputs(self, weights, i, scene, nm=ref.REFERENCE):
        imgs = self.pool[i % len(self.pool)][scene].to(self.dev)
        return ref.reconstruct(weights, self.cfg, imgs, n_mem=self.n_views,
                               init_images=int(self.t["init_images"]), nm=nm)
