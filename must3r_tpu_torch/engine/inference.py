"""Inference engine of the port (counterpart of
``must3r_tpu/engine/inference.py``).

* :func:`postprocess`: channel split, norm-exp activation, confidence,
  Weiszfeld focal and weighted Procrustes c2w, in fp32.
* :class:`InferenceCore`: the encoder and decoder on one device, weights
  cast to the compute dtype except the fp32 islands (patch embed, head);
  ``kv_quant`` ('int8' / 'fp8') stores the token memory 8-bit; ``mesh``
  shards it over the mesh's ``sp`` axis (every rank runs the same steps on
  its slice of the memory, the CA merging across ranks).
* :func:`offline_reconstruction`: the host-driven loop (encode, memory
  updates [init, 1, 1, ...], refinement passes, batched render, head,
  postprocess).
* :func:`offline_reconstruction_multi_ar`: the same over a collection of
  several aspect-ratio buckets sharing one memory.
* :func:`make_fused_offline`: the steps of one uniform aspect-ratio bucket
  as one function over [S, V] image stacks. JAX compiles it into one
  program; here it runs eagerly. With a ``dp`` mesh each rank runs its
  share of the scenes and every rank returns all of them.
* :class:`VGGTCore` and :func:`vggt_reconstruction`: VGGT on its device,
  a scene of frames in, maps and cameras out, device tensors both ways.

Everything runs where the weights are: there is no device fallback.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from must3r_tpu_torch.config import ActivationType, DecoderConfig, EncoderConfig
import numpy as np

from must3r_tpu_torch.memory import (QUANT_DTYPES, MemoryState, init_memory,
                                     round_capacity)
from must3r_tpu_torch.models.decoder import (Decoder, decoder_head,
                                             decoder_refine, decoder_render,
                                             decoder_update)
from must3r_tpu_torch.models.encoder import Encoder, encoder_forward
from must3r_tpu_torch.models.vggt import VGGT, vggt_forward
from must3r_tpu_torch.ops.geometry import apply_exp_to_norm
from must3r_tpu_torch.ops.patch import patchify_positions
from must3r_tpu_torch.ops.pose import (estimate_focal_weiszfeld, make_c2w,
                                       pose_encoding_to_cameras,
                                       rigid_points_registration)
from must3r_tpu_torch.parallel import gather, replicate, shard_memory


def use_full_fp32_matmuls():
    """The fp32 islands (patch embed, head, postprocess) need true fp32
    products: keep TF32 off for matmuls and for cuDNN (whose default is on).
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------------------
# Postprocess
# ---------------------------------------------------------------------------

def postprocess(pointmaps: torch.Tensor,
                activation: ActivationType = ActivationType.NORM_EXP,
                compute_cam: bool = False) -> dict:
    """Split the raw head output [..., H, W, C] into 'pts3d', 'pts3d_local',
    'conf' and, with ``compute_cam``, 'focal' [...] and 'c2w' [..., 4, 4]."""
    pm = pointmaps.float()
    channels = pm.shape[-1]

    def act(x):
        return apply_exp_to_norm(x) if activation == \
            ActivationType.NORM_EXP else x

    out = {"pts3d": act(pm[..., :3])}
    if channels >= 6:
        out["pts3d_local"] = act(pm[..., 3:6])
    if channels in (4, 7):
        out["conf"] = 1.0 + torch.exp(pm[..., -1])
    if compute_cam:
        lead = out["pts3d"].shape[:-3]
        h, w = pm.shape[-3:-1]
        out["focal"] = estimate_focal_weiszfeld(
            out["pts3d_local"].reshape(-1, h, w, 3)).reshape(lead)
        r, t = rigid_points_registration(
            out["pts3d_local"].reshape(*lead, -1, 3),
            out["pts3d"].reshape(*lead, -1, 3),
            weights=out["conf"].reshape(*lead, -1) - 1.0)
        out["c2w"] = make_c2w(r, t)
    return out


def view_positions(img_hw, patch_size: int, portrait=None, batch_shape=(),
                   device=None) -> torch.Tensor:
    """(y, x) patch coords [*batch_shape, N, 2] int32 for views stored in
    landscape at img_hw; portrait views (stored transposed) get swapped
    coordinates."""
    hp, wp = img_hw[0] // patch_size, img_hw[1] // patch_size
    pos = patchify_positions(hp, wp, device).expand(*batch_shape, hp * wp, 2)
    if portrait is None:
        return pos
    sel = torch.as_tensor(portrait, device=pos.device)[..., None, None]
    return torch.where(sel, pos.flip(-1), pos)


# ---------------------------------------------------------------------------
# Core
# ---------------------------------------------------------------------------

def cast_params_(module: torch.nn.Module, dtype, keep=()):
    """Cast weights of two or more dims to ``dtype`` in place; 1-D
    parameters (LayerNorm, biases) and the submodules named in ``keep``
    stay as they are."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            if p.dim() >= 2 and p.is_floating_point() and \
                    name.split(".")[0] not in keep:
                p.data = p.data.to(dtype)
    return module


class InferenceCore:
    """The encoder and decoder on their device, with the step functions of
    the offline paths. The modules are cast in place (bf16 by default;
    patch embed and head stay fp32), so cores built on the same modules
    share one copy of the weights. ``kv_quant`` ('int8' or 'fp8') stores the
    token memory 8-bit with per-token scales; compute stays in ``dtype``.
    ``mesh`` (a ``parallel.Mesh`` with an 'sp' axis): the weights are
    broadcast from the mesh's first rank, and memories from
    :meth:`new_memory` are sharded over 'sp', which every step reads."""

    def __init__(self, encoder: Encoder, decoder: Decoder,
                 enc_cfg: EncoderConfig, dec_cfg: DecoderConfig,
                 dtype=torch.bfloat16, impl: Optional[str] = None,
                 kv_quant: Optional[str] = None, mesh=None):
        if kv_quant is not None and kv_quant not in QUANT_DTYPES:
            raise ValueError(f"kv_quant must be one of {list(QUANT_DTYPES)}, "
                             f"got {kv_quant!r}")
        use_full_fp32_matmuls()
        cast_params_(encoder, dtype, keep=("patch_embed",))
        cast_params_(decoder, dtype, keep=("head_dec",))
        self.encoder = encoder.requires_grad_(False)
        self.decoder = decoder.requires_grad_(False)
        self.enc_cfg = enc_cfg
        self.dec_cfg = dec_cfg
        self.dtype = dtype
        self.impl = impl
        self.kv_quant = kv_quant
        self.device = next(decoder.parameters()).device
        self.mesh = mesh
        if mesh is not None:
            replicate(mesh, self.encoder)
            replicate(mesh, self.decoder)

    @property
    def mem_dtype(self):
        """Storage dtype of the token memory (8-bit with ``kv_quant``)."""
        if self.kv_quant is not None:
            return QUANT_DTYPES[self.kv_quant][0]
        return self.dtype

    def new_memory(self, max_images: int, img_hw, batch: int = 1,
                   block: int = 1024) -> MemoryState:
        p = self.dec_cfg.patch_size
        n = (img_hw[0] // p) * (img_hw[1] // p)
        return self.memory_for(max_images * n, block, batch)

    def memory_for(self, n_tokens: int, block: int = 1024,
                   batch: int = 1) -> MemoryState:
        """An empty memory of at least ``n_tokens`` slots, rounded to
        ``block`` (to ``block`` x sp and sharded over 'sp' with a mesh)."""
        sp = 1 if self.mesh is None else self.mesh.shape.get("sp", 1)
        mem = init_memory(self.dec_cfg.depth, batch, self.dec_cfg.num_heads,
                          self.dec_cfg.head_dim,
                          round_capacity(n_tokens, block * sp),
                          dtype=self.mem_dtype, device=self.device)
        return mem if self.mesh is None else shard_memory(self.mesh, mem)

    def encode(self, imgs, positions):
        """imgs [B, H, W, 3] -> tokens [B, N, Denc] fp32."""
        return encoder_forward(self.encoder, self.enc_cfg, imgs, positions,
                               dtype=self.dtype, impl=self.impl)

    def encode_all(self, imgs, positions, max_bs: int = 8):
        """Encode V views in chunks of max_bs (the last chunk padded to
        max_bs when there is more than one chunk)."""
        v = imgs.shape[0]
        outs = []
        for i in range(0, v, max_bs):
            chunk, cpos = imgs[i:i + max_bs], positions[i:i + max_bs]
            pad = max_bs - chunk.shape[0] if v > max_bs else 0
            if pad:
                chunk = torch.cat([chunk,
                                   chunk.new_zeros(pad, *chunk.shape[1:])])
                cpos = torch.cat([cpos, cpos.new_zeros(pad, *cpos.shape[1:])])
            toks = self.encode(chunk, cpos)
            outs.append(toks[:max_bs - pad])
        return torch.cat(outs)

    def update(self, mem, x_enc, pos):
        return decoder_update(self.decoder, self.dec_cfg, mem, x_enc, pos,
                              causal=False, dtype=self.dtype, impl=self.impl,
                              mesh=self.mesh)

    def update_seq(self, mem, xs, ps):
        """1-view updates over xs [V, N, Denc], ps [V, N, 2], in order."""
        for xi, pi in zip(xs, ps):
            mem, _ = self.update(mem, xi[None, None], pi[None, None])
        return mem

    def refine(self, mem, x_enc, pos, labels):
        return decoder_refine(self.decoder, self.dec_cfg, mem, x_enc, pos,
                              labels, dtype=self.dtype, impl=self.impl,
                              mesh=self.mesh)

    def render(self, mem, x_enc, pos):
        return decoder_render(self.decoder, self.dec_cfg, mem, x_enc, pos,
                              dtype=self.dtype, impl=self.impl,
                              mesh=self.mesh)

    def head(self, tokens, img_hw, portrait_mask=None):
        return decoder_head(self.decoder, self.dec_cfg, tokens,
                            tuple(img_hw), portrait_mask)

    def render_post(self, mem, x_enc, pos, portrait_mask, img_hw,
                    compute_cam: bool = True) -> dict:
        """Render + head + postprocess of the batch element 0."""
        pm = self.head(self.render(mem, x_enc, pos), img_hw, portrait_mask)
        return postprocess(pm[0], self.dec_cfg.pointmaps_activation,
                           compute_cam=compute_cam)


# ---------------------------------------------------------------------------
# Offline reconstruction loop
# ---------------------------------------------------------------------------

def default_mem_batches(n_views: int, init_num_images: int = 2):
    """Memory schedule [init, 1, 1, ...]."""
    init = min(init_num_images, n_views)
    return [init] + [1] * (n_views - init)


def offline_reconstruction(core: InferenceCore, imgs: torch.Tensor,
                           img_hw=None, portrait=None,
                           mem_views: Optional[Sequence[int]] = None,
                           init_num_images: int = 2,
                           num_refinement_iterations: int = 0,
                           to_render: Optional[Sequence[int]] = None,
                           render_bs: int = 8, encode_bs: int = 8,
                           capacity_images: Optional[int] = None,
                           compute_cam: bool = True,
                           return_mem: bool = False, on_update=None):
    """Offline pipeline for one aspect-ratio bucket.

    imgs: [V, H, W, 3] normalised images (landscape storage) in processing
    order; portrait: optional bool [V]; mem_views: views that build the
    memory (default all); to_render: views to predict (default all);
    num_refinement_iterations: passes that re-run every memory batch
    against the full memory and overwrite its tokens; capacity_images:
    memory capacity in images (default: the memory views); on_update(
    view_ids, partial_result) is called after every memory batch with that
    batch's first-pass predictions (numpy).

    Returns dict pts3d, pts3d_local, conf [V, H, W, ...], focal [V],
    c2w [V, 4, 4] (and the final memory with ``return_mem``)."""
    v = imgs.shape[0]
    dev = core.device
    imgs = imgs.to(dev)
    img_hw = tuple(img_hw) if img_hw is not None else tuple(imgs.shape[1:3])
    portrait = (torch.zeros(v, dtype=torch.bool, device=dev)
                if portrait is None else
                torch.as_tensor(portrait, dtype=torch.bool, device=dev))
    mem_views = list(mem_views) if mem_views is not None else list(range(v))
    to_render = list(to_render) if to_render is not None else list(range(v))

    pos = view_positions(img_hw, core.enc_cfg.patch_size, portrait,
                         batch_shape=(v,), device=dev)
    x = core.encode_all(imgs, pos, max_bs=encode_bs)        # [V, N, Denc]
    # slack for refinement passes, which append before truncating back
    slack = init_num_images if num_refinement_iterations > 0 else 0
    mem = core.new_memory((capacity_images or len(mem_views)) + slack, img_hw)

    batches = default_mem_batches(len(mem_views), init_num_images)
    labels_of = {}
    cursor = 0
    for bsize in batches:
        ids = mem_views[cursor:cursor + bsize]
        cursor += bsize
        base = len(labels_of)
        mem, toks = core.update(mem, x[ids][None], pos[ids][None])
        labels_of.update((vid, base + j) for j, vid in enumerate(ids))
        if on_update is not None:
            pm = core.head(toks, img_hw, portrait[ids][None])
            partial = postprocess(pm[0], core.dec_cfg.pointmaps_activation,
                                  compute_cam=compute_cam)
            on_update(ids, {k: t.cpu().numpy() for k, t in partial.items()})

    # refinement: refresh each view's tokens against the full memory
    for _ in range(num_refinement_iterations):
        cursor = 0
        for bsize in batches:
            ids = mem_views[cursor:cursor + bsize]
            cursor += bsize
            mem, _ = core.refine(mem, x[ids][None], pos[ids][None],
                                 [labels_of[i] for i in ids])

    outs = []
    for i in range(0, len(to_render), render_bs):
        ids = to_render[i:i + render_bs]
        pad = render_bs - len(ids) if len(to_render) > render_bs else 0
        ids_p = ids + [ids[-1]] * pad
        toks = core.render(mem, x[ids_p][None], pos[ids_p][None])
        pm = core.head(toks, img_hw, portrait[ids_p][None])
        outs.append(pm[0, :len(ids)])
    result = postprocess(torch.cat(outs), core.dec_cfg.pointmaps_activation,
                         compute_cam=compute_cam)
    return (result, mem) if return_mem else result


# ---------------------------------------------------------------------------
# Mixed aspect-ratio collections
# ---------------------------------------------------------------------------

def group_views_by_shape(views: Sequence[dict]) -> dict:
    """{stored image shape (H, W): [view indices]}, in order within each."""
    groups = {}
    for i, vw in enumerate(views):
        groups.setdefault(tuple(vw["img"].shape[:2]), []).append(i)
    return groups


def offline_reconstruction_multi_ar(core: InferenceCore,
                                    views: Sequence[dict],
                                    mem_views: Optional[Sequence[int]] = None,
                                    init_num_images: int = 2,
                                    encode_bs: int = 8, render_bs: int = 8,
                                    compute_cam: bool = True,
                                    capacity_slack: int = 4) -> list:
    """Offline reconstruction of a collection of several aspect-ratio
    buckets: encode per bucket, update one shared memory (the init views
    jointly when they share a bucket, else one by one; then 1-view updates
    in order), render per bucket.

    views: dicts with 'img' [H, W, 3] (numpy, landscape storage) and
    'portrait'. Returns a list of per-view postprocess dicts of numpy
    arrays, in input order."""
    dev = core.device
    v = len(views)
    mem_views = list(mem_views) if mem_views is not None else list(range(v))
    patch = core.dec_cfg.patch_size
    groups = group_views_by_shape(views)

    def portrait_of(ids):
        return torch.tensor([bool(views[i].get("portrait")) for i in ids],
                            device=dev)

    x, pos = [None] * v, [None] * v
    for shape, ids in groups.items():
        imgs = torch.from_numpy(np.stack([views[i]["img"] for i in ids]))
        p = view_positions(shape, patch, portrait_of(ids),
                           batch_shape=(len(ids),), device=dev)
        toks = core.encode_all(imgs.to(dev), p, max_bs=encode_bs)
        for j, i in enumerate(ids):
            x[i], pos[i] = toks[j], p[j]

    def n_tokens(i):
        h, w = views[i]["img"].shape[:2]
        return (h // patch) * (w // patch)

    mem = core.memory_for(sum(n_tokens(i) for i in mem_views)
                          + capacity_slack
                          * max(n_tokens(i) for i in mem_views), 512)

    init, rest = mem_views[:init_num_images], mem_views[init_num_images:]
    if len(init) > 1 and len({views[i]["img"].shape[:2] for i in init}) == 1:
        mem, _ = core.update(mem, torch.stack([x[i] for i in init])[None],
                             torch.stack([pos[i] for i in init])[None])
    else:
        rest = init + rest
    mem = core.update_seq(mem, [x[i] for i in rest], [pos[i] for i in rest])

    results = [None] * v
    for shape, ids in groups.items():
        for s in range(0, len(ids), render_bs):
            chunk = ids[s:s + render_bs]
            pad = render_bs - len(chunk) if len(ids) > render_bs else 0
            chunk_p = chunk + [chunk[-1]] * pad
            out = core.render_post(
                mem, torch.stack([x[i] for i in chunk_p])[None],
                torch.stack([pos[i] for i in chunk_p])[None],
                portrait_of(chunk_p)[None], shape, compute_cam=compute_cam)
            for j, i in enumerate(chunk):
                results[i] = {k: t[j].cpu().numpy() for k, t in out.items()}
    return results


# ---------------------------------------------------------------------------
# Fused single-bucket pipeline
# ---------------------------------------------------------------------------

def make_fused_offline(core: InferenceCore, n_views: int, img_hw,
                       init_num_images: int = 2, compute_cam: bool = True,
                       n_scenes: int = 1, mesh=None):
    """The whole offline reconstruction of a uniform bucket as one function:
    encode all views -> init update -> 1-view updates -> batched render ->
    head -> postprocess.

    ``run(imgs [V, H, W, 3], portrait=None)``, or with a scene axis
    ``run(imgs [S, V, H, W, 3], portrait [S, V])`` for S independent
    collections, each with its own memory on the batch axis of every op.

    ``mesh`` (a ``parallel.Mesh`` with a 'dp' axis, every rank calling
    ``run`` with the same inputs): the weights are broadcast from the
    mesh's first rank once; each rank reconstructs its n_scenes / dp
    scenes with the whole pipeline and no communication, then the outputs
    are all-gathered over 'dp', so every rank returns all S scenes, as a
    single JAX caller sees them. n_scenes must divide over 'dp'.
    """
    dp, rank = 1, 0
    if mesh is not None:
        dp, rank = mesh.shape["dp"], mesh.rank("dp")
        if n_scenes % dp:
            raise ValueError(f"n_scenes={n_scenes} must divide over the dp "
                             f"axis ({dp})")
        replicate(mesh, core.encoder)
        replicate(mesh, core.decoder)
    enc_cfg, dec_cfg = core.enc_cfg, core.dec_cfg
    h, w = img_hw
    n = (h // dec_cfg.patch_size) * (w // dec_cfg.patch_size)
    cap = round_capacity(n_views * n)
    g0 = min(init_num_images, n_views)

    def pipeline(imgs, pos, portrait):
        sl = imgs.shape[0]
        x = encoder_forward(core.encoder, enc_cfg,
                            imgs.reshape(sl * n_views, h, w, 3),
                            pos.reshape(sl * n_views, n, 2),
                            dtype=core.dtype, impl=core.impl)
        x = x.reshape(sl, n_views, n, -1)
        mem = init_memory(dec_cfg.depth, sl, dec_cfg.num_heads,
                          dec_cfg.head_dim, cap, dtype=core.mem_dtype,
                          device=core.device)
        mem, _ = decoder_update(core.decoder, dec_cfg, mem, x[:, :g0],
                                pos[:, :g0], causal=False, dtype=core.dtype,
                                impl=core.impl)
        for i in range(g0, n_views):
            mem, _ = decoder_update(core.decoder, dec_cfg, mem,
                                    x[:, i:i + 1], pos[:, i:i + 1],
                                    causal=False, dtype=core.dtype,
                                    impl=core.impl)
        toks = decoder_render(core.decoder, dec_cfg, mem, x, pos,
                              dtype=core.dtype, impl=core.impl)
        pm = decoder_head(core.decoder, dec_cfg, toks, (h, w), portrait)
        return postprocess(pm, dec_cfg.pointmaps_activation,
                           compute_cam=compute_cam)

    def run(imgs, portrait=None):
        scene_dim = imgs.dim() == 5
        imgs = imgs.to(core.device)
        if not scene_dim:
            imgs = imgs[None]
        if portrait is None:
            portrait = torch.zeros((n_scenes, n_views), dtype=torch.bool)
        elif not scene_dim:
            portrait = torch.as_tensor(portrait)[None]
        portrait = torch.as_tensor(portrait, dtype=torch.bool,
                                   device=core.device)
        pos = view_positions(img_hw, enc_cfg.patch_size, portrait,
                             batch_shape=tuple(portrait.shape),
                             device=core.device)
        if mesh is None:
            out = pipeline(imgs, pos, portrait)
        else:
            if imgs.shape[0] != n_scenes:
                raise ValueError(f"{imgs.shape[0]} scenes, expected "
                                 f"{n_scenes}")
            mine = slice(rank * n_scenes // dp, (rank + 1) * n_scenes // dp)
            out = pipeline(imgs[mine], pos[mine], portrait[mine])
            out = {k: torch.cat(gather(mesh, "dp", t.contiguous()))
                   for k, t in out.items()}
        if not scene_dim:
            out = {k: t[0] for k, t in out.items()}
        return out

    return run



# ---------------------------------------------------------------------------
# VGGT
# ---------------------------------------------------------------------------

class VGGTCore:
    """A VGGT model on its device. The aggregator's matrices (its linear
    layers and the patch projection) are cast in place to ``dtype``, once;
    biases, norms, embeddings, tokens and both heads stay fp32. ``impl``:
    the aggregator's attention, as :class:`InferenceCore`'s."""

    def __init__(self, model: VGGT, dtype=torch.bfloat16,
                 impl: Optional[str] = None):
        with torch.no_grad():
            agg = model.aggregator
            mats = [agg.patch_embed.patch_embed.proj] + [
                m for m in agg.modules() if isinstance(m, torch.nn.Linear)]
            for m in mats:
                m.weight.data = m.weight.data.to(dtype)
        self.model = model.requires_grad_(False)
        self.cfg = model.cfg
        self.dtype = dtype
        self.impl = impl
        self.device = next(model.parameters()).device


def vggt_reconstruction(core: VGGTCore, imgs: torch.Tensor,
                        return_layers: bool = False) -> dict:
    """The model's entry: imgs [S, H, W, 3] in [0, 1] on the core's device
    (a scene of S frames, H and W multiples of the patch) -> device
    tensors, fp32: depth [S, H, W, 1], depth_conf [S, H, W], world_points
    [S, H, W, 3], world_points_conf [S, H, W], pose_enc [S, 9], and from
    it c2w [S, 4, 4] and focal [S, 2] (f_x, f_y). With ``return_layers``
    also the aggregator's iterations the heads read ('layers')."""
    with torch.no_grad():
        out = vggt_forward(core.model, imgs, dtype=core.dtype,
                           return_layers=return_layers, impl=core.impl)
    out["c2w"], out["focal"] = pose_encoding_to_cameras(
        out["pose_enc"], tuple(imgs.shape[1:3]))
    return out
