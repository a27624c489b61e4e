"""Reconstruction CLI of the port: images in; ``scene.pkl``, ``scene.html``
and one GLB and one PLY per confidence threshold out. Or, with ``--web``,
the interactive web demo.

    python -m must3r_tpu_torch.cli.reconstruct --chkpt X.npz --input DIR \\
        --output_dir OUT [--mode retrieval|linseq|vidseq|vidslam] \\
        [--retrieval HEAD.pth] [--kv_quant int8|fp8] \\
        [--num_refinements_iterations 1] [--live [--live_port 8642]]
    python -m must3r_tpu_torch.cli.reconstruct --web [--web_port 8643] \\
        [--web_hold SECONDS]

``--preset vggt_1b`` runs VGGT instead (``demo.inference.vggt_inference``:
every image one frame of one scene, in one pass, ``--image_size`` wide,
default 518), from ``--chkpt`` (a ``save_vggt_checkpoint`` file, whose
config it takes, or the published ``model.pt``) or at random.

Flags are those of ``must3r_tpu.cli.reconstruct`` plus ``--device``
(default ``cuda``; there is no silent CPU fallback) and ``--seed`` for
random-init presets. ``--chkpt`` takes a ``save_params_npz`` bundle or a
reference ``.pth``; without it, ``--preset`` is initialised at random.
Modes: ``retrieval`` (the default: an unordered collection, offline, its
keyframes chosen by ASMK similarity of the encoder's local features, with
the retrieval head of ``--retrieval``, a reference ``*_trainingfree.pth``,
or without one the identity head and a codebook trained on the
collection), ``linseq`` (offline, linspace keyframes), ``vidseq`` (video,
every ``--keyframe_interval``-th frame a keyframe) and ``vidslam`` (video,
overlap keyframes: ``--keyframe_overlap_thr``, ``--min_conf_keyframe``);
``--kv_quant`` stores the token memory 8-bit in each. ``--live`` serves
the live viewer (``demo/live.py``) on 127.0.0.1 while an offline mode runs,
fed the points of every memory batch, then re-thresholds the finished
scene for ``--live_hold`` seconds. ``--web`` serves the web demo
(``demo/webapp.py``: upload, run, export) for ``--web_hold`` seconds, or
until interrupted.
"""

from __future__ import annotations

import argparse
import os
import pickle


def get_args_parser():
    p = argparse.ArgumentParser("must3r_tpu_torch reconstruct")
    p.add_argument("--chkpt", default=None,
                   help="save_params_npz bundle (.npz) or reference .pth")
    p.add_argument("--preset", default="512",
                   choices=["224", "512", "tiny", "vggt_1b"])
    p.add_argument("--input", default=None,
                   help="image folder or list file (omit with --web)")
    p.add_argument("--output_dir", default=None)
    p.add_argument("--image_size", type=int, default=None,
                   help="MUSt3R: the long side (default 512); VGGT: the "
                   "width (default 518)")
    p.add_argument("--num_mem_images", type=int, default=20)
    p.add_argument("--init_num_images", type=int, default=2)
    p.add_argument("--retrieval", default=None,
                   help="retrieval head (*_trainingfree.pth) for keyframes")
    p.add_argument("--mode", default="retrieval",
                   choices=["retrieval", "linseq", "vidslam", "vidseq"])
    p.add_argument("--is_sequence", action="store_true",
                   help="alias for --mode linseq")
    p.add_argument("--local_context_size", type=int, default=25)
    p.add_argument("--keyframe_interval", type=int, default=3)
    p.add_argument("--keyframe_overlap_thr", type=float, default=0.15)
    p.add_argument("--min_conf_keyframe", type=float, default=1.5)
    p.add_argument("--num_refinements_iterations", type=int, default=0)
    p.add_argument("--max_bs", type=int, default=8)
    p.add_argument("--conf_thrs", type=float, nargs="+",
                   default=[1.5, 3.0, 5.0])
    p.add_argument("--amp", default="bf16",
                   choices=["bf16", "fp32", "bfloat16", "float32"])
    p.add_argument("--kv_quant", default=None, choices=["fp8", "int8"])
    p.add_argument("--live", action="store_true", default=False)
    p.add_argument("--live_port", type=int, default=8642)
    p.add_argument("--live_hold", type=float, default=0.0)
    p.add_argument("--web", action="store_true", default=False)
    p.add_argument("--web_port", type=int, default=8643)
    p.add_argument("--web_hold", type=float, default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device the model runs on")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random init when no --chkpt is given")
    return p


def load_or_init_model(chkpt, preset: str = "512", img_size=None,
                       seed: int = 0, device="cuda"):
    """(encoder, decoder, enc_cfg, dec_cfg) from a checkpoint (a ``.npz``
    bundle, a reference ``.pth`` or a training checkpoint directory of the
    port), or a preset initialised at random from ``seed``."""
    from must3r_tpu_torch.config import (DecoderConfig, EncoderConfig,
                                         must3r_224_configs,
                                         must3r_512_configs, set_image_size)
    from must3r_tpu_torch.checkpoint import (init_model, load_checkpoint,
                                             load_model, load_params_npz,
                                             load_torch_checkpoint,
                                             params_from_jax)

    if chkpt:
        if chkpt.endswith(".npz"):
            params, enc_cfg, dec_cfg = load_params_npz(chkpt)
            enc, dec = load_model(*params_from_jax(params, enc_cfg, dec_cfg),
                                  enc_cfg, dec_cfg, device)
            return enc, dec, enc_cfg, dec_cfg
        if os.path.isdir(chkpt):
            params, enc_cfg, dec_cfg, _, _ = load_checkpoint(chkpt, device)
            enc, dec = load_model(params["encoder"], params["decoder"],
                                  enc_cfg, dec_cfg, device)
            return enc, dec, enc_cfg, dec_cfg
        return load_torch_checkpoint(chkpt, img_size=img_size, device=device)
    if preset == "tiny":
        enc_cfg = EncoderConfig(img_size=(64, 64), patch_size=16,
                                embed_dim=64, depth=2, num_heads=2)
        dec_cfg = DecoderConfig(img_size=(64, 64), enc_embed_dim=64,
                                patch_size=16, embed_dim=32,
                                output_dim=16 * 16 * 7, depth=2, num_heads=2)
    else:
        enc_cfg, dec_cfg = (must3r_224_configs() if preset == "224"
                            else must3r_512_configs())
    if img_size is not None:
        enc_cfg = set_image_size(enc_cfg, img_size)
        dec_cfg = set_image_size(dec_cfg, img_size)
    enc, dec = init_model(enc_cfg, dec_cfg, seed=seed, device=device)
    return enc, dec, enc_cfg, dec_cfg


def main(argv=None):
    args = get_args_parser().parse_args(argv)
    if args.preset == "vggt_1b":
        return run_vggt(args)
    if args.image_size is None:
        args.image_size = 512
    mode = "linseq" if args.is_sequence else args.mode

    import time

    import numpy as np
    import torch

    from must3r_tpu_torch.demo.inference import (must3r_inference,
                                                 must3r_inference_video)
    from must3r_tpu_torch.engine.inference import InferenceCore
    from must3r_tpu_torch.tools.image import list_images, load_images

    def make_core():
        enc, dec, enc_cfg, dec_cfg = load_or_init_model(
            args.chkpt, args.preset, img_size=args.image_size,
            seed=args.seed, device=args.device)
        dtype = torch.bfloat16 if args.amp in ("bf16", "bfloat16") \
            else torch.float32
        return InferenceCore(enc, dec, enc_cfg, dec_cfg, dtype=dtype,
                             kv_quant=args.kv_quant)

    def retrieval_head():
        if not args.retrieval:
            return None
        from must3r_tpu_torch.retrieval.model import \
            load_retrieval_checkpoint
        return load_retrieval_checkpoint(args.retrieval, device=args.device)

    if args.web:
        from must3r_tpu_torch.demo.webapp import WebDemo

        app = WebDemo(make_core(), image_size=args.image_size,
                      port=args.web_port, retrieval_head=retrieval_head())
        try:
            if args.web_hold is not None:
                time.sleep(args.web_hold)
            else:
                while True:
                    time.sleep(3600)
        except KeyboardInterrupt:
            pass
        finally:
            app.close()
        return

    if not args.input or not args.output_dir:
        raise SystemExit("--input and --output_dir are required "
                         "(or use --web)")
    os.makedirs(args.output_dir, exist_ok=True)
    if os.path.isdir(args.input):
        paths = list_images(args.input)
    else:
        with open(args.input) as f:
            paths = [ln.strip() for ln in f
                     if ln.strip() and not ln.startswith("#")]
    print(f"found {len(paths)} images")

    core = make_core()
    views = load_images(paths, args.image_size, verbose=True)
    shapes = {v["img"].shape for v in views}
    if len(shapes) != 1:
        raise SystemExit(f"mixed aspect buckets {shapes}: run per bucket, "
                         "or use --web (multi-aspect uploads) or "
                         "engine.inference.offline_reconstruction_multi_ar")
    if mode in ("vidseq", "vidslam"):
        scene = must3r_inference_video(
            core, views, init_num_images=args.init_num_images,
            local_context_size=args.local_context_size,
            num_refinements_iterations=args.num_refinements_iterations,
            mode="slam" if mode == "vidslam" else "interval",
            keyframe_interval=args.keyframe_interval,
            keyframe_overlap_thr=args.keyframe_overlap_thr,
            min_conf_keyframe=args.min_conf_keyframe,
            encode_bs=args.max_bs, verbose=True)
    else:
        viewer = on_update = None
        if args.live:
            from must3r_tpu_torch.demo.live import LiveViewer

            viewer = LiveViewer(port=args.live_port)
            on_update = viewer.update_callback(
                imgs=np.stack([v["img"] for v in views]))
        try:
            scene = must3r_inference(
                core, views, num_mem_images=args.num_mem_images,
                init_num_images=args.init_num_images,
                is_sequence=mode == "linseq", retrieval_head=retrieval_head(),
                num_refinements_iterations=args.num_refinements_iterations,
                encode_bs=args.max_bs, render_bs=args.max_bs, verbose=True,
                on_update=on_update)
            if viewer is not None:
                # the page's slider and keyframes-only toggle now
                # re-filter the finished scene, with no inference
                viewer.serve_scene(scene)
                if args.live_hold > 0:
                    print(f"viewer at {viewer.url} for {args.live_hold:g}s "
                          "(interactive re-thresholding)")
                    time.sleep(args.live_hold)
        finally:
            if viewer is not None:
                viewer.close()

    write_scene(scene, args)


def run_vggt(args):
    """``--preset vggt_1b``: the images of ``--input`` as one scene."""
    import torch

    from must3r_tpu_torch.checkpoint import init_vggt, load_vggt_checkpoint
    from must3r_tpu_torch.config import vggt_1b_config
    from must3r_tpu_torch.demo.inference import (vggt_inference,
                                                 vggt_scene_state)
    from must3r_tpu_torch.engine.inference import VGGTCore
    from must3r_tpu_torch.tools.image import list_images, load_vggt_frames

    if not args.input or not args.output_dir:
        raise SystemExit("--input and --output_dir are required")
    model = (load_vggt_checkpoint(args.chkpt, device=args.device)
             if args.chkpt else
             init_vggt(vggt_1b_config(), seed=args.seed, device=args.device))
    dtype = torch.bfloat16 if args.amp in ("bf16", "bfloat16") \
        else torch.float32
    core = VGGTCore(model, dtype=dtype)
    paths = list_images(args.input) if os.path.isdir(args.input) else [
        ln.strip() for ln in open(args.input)
        if ln.strip() and not ln.startswith("#")]
    print(f"found {len(paths)} images")
    frames = load_vggt_frames(paths, args.image_size or 518,
                              core.cfg.patch_size)
    if len({f.shape for f in frames}) != 1:
        raise SystemExit("VGGT takes frames of one size: crop the images "
                         "to one aspect")
    out = vggt_inference(core, frames)
    os.makedirs(args.output_dir, exist_ok=True)
    write_scene(vggt_scene_state(frames, out, paths), args)


def write_scene(scene, args):
    """scene.pkl, scene.html and a GLB and a PLY per --conf_thrs."""
    from must3r_tpu_torch.demo.export import scene_to_glb, scene_to_ply
    from must3r_tpu_torch.tools.viz import scene_to_html

    with open(os.path.join(args.output_dir, "scene.pkl"), "wb") as f:
        pickle.dump(scene, f)
    scene_to_html(scene, os.path.join(args.output_dir, "scene.html"),
                  conf_thr=args.conf_thrs[0])
    for thr in args.conf_thrs:
        glb = os.path.join(args.output_dir, f"scene_conf{thr:g}.glb")
        ply = os.path.join(args.output_dir, f"scene_conf{thr:g}.ply")
        scene_to_glb(scene, glb, conf_thr=thr)
        scene_to_ply(scene, ply, conf_thr=thr)
        print(f"wrote {glb} and {ply}")


if __name__ == "__main__":
    main()
