"""Demo entry points of the port (counterpart of
``must3r_tpu/demo/inference.py``): keyframe choice, reconstruction and the
``SceneState`` that exports read.

:func:`vggt_inference` is VGGT's: a scene of frames in one pass, host
arrays in and out.

Offline collections take their keyframes by retrieval (unordered
collections: ASMK similarity of the encoder's local features, FPS anchors,
greedy ordering; :func:`select_keyframes`) or by linspace (ordered
sequences, ``is_sequence``), with refinement iterations; video runs in
``mode="interval"`` and ``mode="slam"`` (overlap keyframes against the SLAM
overlap index, ``slam/nns.py``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch
from torch.profiler import record_function

from must3r_tpu_torch.engine.inference import (InferenceCore, VGGTCore,
                                               offline_reconstruction,
                                               view_positions,
                                               vggt_reconstruction)
from must3r_tpu_torch.engine.video import video_reconstruction
from must3r_tpu_torch.ops.transfer import fetch, stage_in, upload
from must3r_tpu_torch.retrieval.asmk import ASMK, train_codebook
from must3r_tpu_torch.retrieval.graph import (farthest_point_sampling,
                                              greedy_keyframe_ordering)
from must3r_tpu_torch.retrieval.model import RetrievalHead, identity_head
from must3r_tpu_torch.slam.nns import get_searcher
from must3r_tpu_torch.tools.image import denormalize_images


@dataclasses.dataclass
class SceneState:
    """Everything needed to re-threshold and re-export without inference."""
    pts3d: np.ndarray          # [V, H, W, 3]
    pts3d_local: np.ndarray    # [V, H, W, 3]
    conf: np.ndarray           # [V, H, W]
    imgs: np.ndarray           # [V, H, W, 3] uint8 RGB
    true_shape: np.ndarray     # [V, 2]
    focals: np.ndarray         # [V]
    cams2world: np.ndarray     # [V, 4, 4]
    image_list: List[str]


def select_keyframes(core: Optional[InferenceCore], x_tokens,
                     num_mem_images: int,
                     head: Optional[RetrievalHead] = None,
                     codebook: Optional[np.ndarray] = None,
                     seed: int = 0) -> List[int]:
    """Keyframes of an unordered collection, in processing order: ASMK
    similarity of the local features that ``head`` selects from the encoder
    tokens ``x_tokens`` ([V, N, D] or a list; default head: the identity
    with 300 features an image), FPS anchors on 1 - similarity, then the
    greedy ordering by similarity to the anchors already chosen. Without a
    ``codebook``, one of min(1024, max(64, 8 V)) cells is trained on the
    collection. The assignment and k-means run on the core's device."""
    n = len(x_tokens)
    num_mem_images = min(num_mem_images, n)
    dev = core.device if core is not None else None
    if head is None:
        head = identity_head(np.shape(x_tokens[0])[-1])
    feats, ids = head.extract_local_features(x_tokens)
    if codebook is None:
        codebook = train_codebook(feats, k=min(1024, max(64, 8 * n)),
                                  device=dev)
    sim = ASMK(codebook, device=dev).similarity_matrix(feats, ids)
    anchor_idx, _ = farthest_point_sampling(1.0 - sim, n=num_mem_images,
                                            seed=seed)
    order = greedy_keyframe_ordering(sim[np.ix_(anchor_idx, anchor_idx)])
    return [int(anchor_idx[k]) for k in order]


def must3r_inference(core: InferenceCore, views: Sequence[dict],
                     num_mem_images: int = 20, init_num_images: int = 2,
                     batch_num_views: int = 1, render_once: bool = False,
                     is_sequence: bool = False,
                     retrieval_head: Optional[RetrievalHead] = None,
                     codebook: Optional[np.ndarray] = None,
                     num_refinements_iterations: int = 0,
                     encode_bs: int = 8, render_bs: int = 8,
                     verbose: bool = False, on_update=None) -> SceneState:
    """Offline reconstruction of a single-bucket collection.

    views: dicts from ``tools.image.preprocess_image`` ('img' [H, W, 3]
    float normalised landscape, 'true_shape', 'portrait', optional 'path').
    Keyframes come from retrieval (:func:`select_keyframes` over the
    encoded collection) or, with ``is_sequence``, linspace over the
    sequence. They are processed first; every view is rendered against the
    final memory. The reconstruction encodes the collection again, as the
    JAX package does.

    on_update(view_ids, partial): called after every memory batch with the
    batch's first-pass predictions (numpy), ``view_ids`` in input order
    (the batches themselves run keyframes first). It only reads: the
    result and the kernels launched are those of a run without it, plus
    the head and postprocess of each batch. ``batch_num_views`` and
    ``render_once`` are accepted as the JAX package accepts them: the
    memory schedule is [init, 1, 1, ...] and every view is rendered
    against the final memory either way.

    The views go to the core's device once (on a card: stacked into pinned
    memory, one non-blocking copy); the keyframe order, the outputs' return
    to input order and the images' denormalisation run there, and every
    output comes back in one fetch. On a card the returned arrays are numpy
    views of pinned host memory, which returns to PyTorch's pinned-memory
    cache when the ``SceneState`` is dropped."""
    v = len(views)
    num_mem_images = min(num_mem_images, v)
    dev = core.device
    with record_function("must3r_inference.stage_in"):
        imgs = stage_in([np.asarray(vw["img"]) for vw in views], dev)
        portrait = upload([bool(vw.get("portrait")) for vw in views], dev)
        rgb = denormalize_images(imgs)
    img_hw = tuple(imgs.shape[1:3])

    if is_sequence:
        keyframes = np.linspace(0, v - 1,
                                num_mem_images).astype(int).tolist()
    else:
        pos = view_positions(img_hw, core.enc_cfg.patch_size, portrait,
                             batch_shape=(v,), device=dev)
        x = core.encode_all(imgs, pos, max_bs=encode_bs)
        keyframes = select_keyframes(core, x, num_mem_images,
                                     retrieval_head, codebook)
        del x
    keyframes = list(dict.fromkeys(int(k) for k in keyframes))
    order = keyframes + sorted(set(range(v)) - set(keyframes))
    if verbose:
        print(f"keyframes: {keyframes}")

    hook = None
    if on_update is not None:
        def hook(ids, partial):
            on_update([order[i] for i in ids], partial)

    # processing order on the device; rendered in input order (to_render)
    idx = upload(order, dev)
    imgs, portrait = imgs.index_select(0, idx), portrait.index_select(0, idx)
    out = offline_reconstruction(
        core, imgs, img_hw=img_hw, portrait=portrait,
        mem_views=list(range(len(keyframes))),
        init_num_images=init_num_images,
        num_refinement_iterations=num_refinements_iterations,
        to_render=np.argsort(order).tolist(),
        render_bs=render_bs, encode_bs=encode_bs, compute_cam=True,
        on_update=hook)
    with record_function("must3r_inference.fetch"):
        out = fetch({**{k: t.float() for k, t in out.items()}, "imgs": rgb})
    return _scene_state(views, out)


def vggt_inference(core: VGGTCore, frames: Sequence[np.ndarray]) -> dict:
    """VGGT on one scene: ``frames``, host float32 images [H, W, 3] in [0,
    1] of one size, go to the core's device once (on a card: stacked into
    pinned memory, one non-blocking copy); every output of
    :func:`engine.inference.vggt_reconstruction` comes back in one fetch,
    as numpy arrays (on a card, views of pinned host memory)."""
    with record_function("vggt_inference.stage_in"):
        imgs = stage_in([np.asarray(f, dtype=np.float32) for f in frames],
                        core.device)
    out = vggt_reconstruction(core, imgs)
    with record_function("vggt_inference.fetch"):
        return fetch(out)


def vggt_scene_state(frames: Sequence[np.ndarray], out: dict,
                     image_list: Optional[List[str]] = None) -> SceneState:
    """A :class:`SceneState` of VGGT's outputs (for the exports): its world
    points and their confidence, the camera-frame points of its depth
    through each frame's intrinsics, the mean of f_x and f_y."""
    s, h, w = out["depth"].shape[:3]
    ys, xs = np.meshgrid(np.arange(h, dtype=np.float32),
                         np.arange(w, dtype=np.float32), indexing="ij")
    fx, fy = out["focal"][:, 0, None, None], out["focal"][:, 1, None, None]
    z = out["depth"][..., 0]
    local = np.stack([(xs - w / 2.0) / fx * z, (ys - h / 2.0) / fy * z, z],
                     axis=-1)
    imgs = np.stack([np.asarray(f) for f in frames])
    return SceneState(
        pts3d=out["world_points"], pts3d_local=local.astype(np.float32),
        conf=out["world_points_conf"],
        imgs=np.clip(imgs * 255.0, 0, 255).round().astype(np.uint8),
        true_shape=np.tile(np.array([h, w]), (s, 1)),
        focals=out["focal"].mean(axis=-1), cams2world=out["c2w"],
        image_list=image_list or [str(i) for i in range(s)])


def _scene_state(views: Sequence[dict], out: dict) -> SceneState:
    """The SceneState of per-view numpy outputs in input order, the
    denormalised images among them ('imgs')."""
    return SceneState(
        pts3d=out["pts3d"], pts3d_local=out["pts3d_local"], conf=out["conf"],
        imgs=out["imgs"],
        true_shape=np.asarray([vw["true_shape"] for vw in views]),
        focals=out["focal"], cams2world=out["c2w"],
        image_list=[vw.get("path", str(i)) for i, vw in enumerate(views)])


def slam_is_keyframe_fn(searcher_state=None, subsample: int = 4,
                        min_conf_keyframe: float = 1.5,
                        keyframe_overlap_thr: float = 0.15,
                        overlap_percentile: float = 70.0):
    """SLAM-style keyframe callback for video reconstruction (reference
    demo/inference.py:79-92): a frame is a keyframe when the given
    percentile of its confident points' NN distance to the keyframe map,
    over depth, exceeds the threshold."""

    def fn(fid, res, state):
        conf = np.asarray(res["conf"])[::subsample, ::subsample]
        msk = conf > min_conf_keyframe
        if msk.sum() == 0 or state is None:
            return False
        pts = np.asarray(res["pts3d"])[::subsample, ::subsample][msk]
        cam = np.asarray(res["c2w"])[:3, 3]
        d = state.query(pts, cam_center=cam)
        depth = np.asarray(res["pts3d_local"])[::subsample, ::subsample,
                                               2][msk]
        d = d / (depth + 1e-9)
        d = np.where(np.isposinf(d), np.finfo(np.float32).max, d)
        return float(np.percentile(d, overlap_percentile)) \
            > keyframe_overlap_thr

    return fn


def slam_update_scene_state_fn(subsample: int = 4,
                               min_conf_keyframe: float = 1.5):
    """Insert a new keyframe's confident points into the overlap index
    (reference demo/inference.py:95-106)."""

    def fn(res, state):
        if state is None:
            state = get_searcher("kdtree-quadrant_x2")
        conf = np.asarray(res["conf"])[::subsample, ::subsample]
        msk = conf > min_conf_keyframe
        if msk.sum():
            pts = np.asarray(res["pts3d"])[::subsample, ::subsample][msk]
            cam = np.asarray(res["c2w"])[:3, 3]
            state.add_pts(pts, cam_center=cam)
        return state

    return fn


def must3r_inference_video(core: InferenceCore, views: Sequence[dict],
                           init_num_images: int = 2,
                           local_context_size: int = 25,
                           num_refinements_iterations: int = 0,
                           mode: str = "slam", keyframe_interval: int = 3,
                           subsample: int = 4,
                           min_conf_keyframe: float = 1.5,
                           keyframe_overlap_thr: float = 0.15,
                           overlap_percentile: float = 70.0,
                           encode_bs: int = 8,
                           verbose: bool = False) -> SceneState:
    """Ordered-video reconstruction (reference demo/inference.py:244-331):
    ``mode="slam"`` takes overlap keyframes (the SLAM overlap index,
    ``subsample``, ``min_conf_keyframe``, ``keyframe_overlap_thr`` and
    ``overlap_percentile`` as in :class:`slam.SlamConfig`),
    ``mode="interval"`` every ``keyframe_interval``-th frame."""
    if mode == "slam":
        is_kf = slam_is_keyframe_fn(None, subsample, min_conf_keyframe,
                                    keyframe_overlap_thr,
                                    overlap_percentile)
        upd = slam_update_scene_state_fn(subsample, min_conf_keyframe)
        state = get_searcher("kdtree-quadrant_x2")
    elif mode == "interval":
        def is_kf(fid, res, st):
            return fid % keyframe_interval == 0

        def upd(res, st):
            return st
        state = None
    else:
        raise ValueError(f"video mode must be 'slam' or 'interval', got "
                         f"{mode!r}")
    imgs = torch.from_numpy(np.stack([vw["img"] for vw in views]))
    portrait = torch.tensor([bool(vw.get("portrait")) for vw in views])
    out = video_reconstruction(
        core, imgs, img_hw=imgs.shape[1:3], portrait=portrait,
        init_num_images=init_num_images,
        local_context_size=local_context_size,
        num_refinement_iterations=num_refinements_iterations,
        is_keyframe_fn=is_kf, scene_state=state, scene_state_update_fn=upd,
        encode_bs=encode_bs, compute_cam=True)
    if verbose:
        print(f"keyframes: {out['keyframes']}")
    return _scene_state(views,
                        {**out, "imgs": denormalize_images(imgs).numpy()})
