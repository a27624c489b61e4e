"""Weights for the port, without jax.

* :func:`params_from_jax` turns the JAX package's parameter tree (nested
  dicts of numpy arrays: blocks stacked as [depth, ...], linear ``w`` as
  [din, dout]) into the port's state dicts under the reference key names.
  It is the inverse of ``must3r_tpu.checkpoint.convert_*_state_dict``.
* :func:`load_params_npz` reads a ``save_params_npz`` bundle with numpy
  alone and upcasts every float leaf narrower than fp32 (fp16 and bf16).
* :func:`load_model` / :func:`init_model` build the encoder and decoder
  modules on a device, from state dicts or from a seed.
* :func:`save_checkpoint` / :func:`load_checkpoint` /
  :func:`latest_checkpoint`: the training checkpoints, a directory holding
  ``state.pth`` (fp32 parameters, optimizer state and step, written with
  ``torch.save``) and ``meta.json`` (the configs and step). The format is
  the port's own; it does not read or write the JAX package's.
* :func:`params_to_jax` (the inverse of :func:`params_from_jax`) and
  :func:`save_params_npz`: the single-file bundle of the JAX package
  (float leaves fp16, the configs as JSON inside), which its
  ``load_params_npz`` and this module's read.
* :func:`export_torch_checkpoint`: a reference-layout ``.pth`` (the state
  dicts and the constructor strings), read by the reference codebase, by
  :func:`load_torch_checkpoint` and by the JAX package's
  ``convert_torch_checkpoint``.
* :func:`rename_dust3r_keys` / :func:`init_from_dust3r`: a training warm
  start from a dust3r / croco checkpoint (reference ``train.py:274-293``).
* :func:`load_vggt` / :func:`init_vggt`: a VGGT model from a state dict
  under the published key names (the track head's keys, which the port
  does not run, are dropped) or from a seed; :func:`save_vggt_checkpoint`
  / :func:`load_vggt_checkpoint`: a ``.pt`` holding that state dict and
  the config, or a published bare state dict (``model.pt``).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from must3r_tpu_torch.config import (DecoderConfig, EncoderConfig,
                                     VGGTConfig, config_from_json,
                                     config_to_json,
                                     decoder_config_to_arg_string,
                                     encoder_config_to_arg_string,
                                     vggt_1b_config)
from must3r_tpu_torch.models.decoder import Decoder, init_decoder
from must3r_tpu_torch.models.encoder import Encoder, init_encoder
from must3r_tpu_torch.models.vggt import VGGT, init_vggt_


def _to_f32(a: np.ndarray) -> np.ndarray:
    """Upcast a float leaf narrower than fp32. bf16 arrives either as
    ml_dtypes' bfloat16 or, where that package is absent, as raw 2-byte
    void records; both carry the top 16 bits of an fp32."""
    if a.dtype == np.float16:
        return a.astype(np.float32)
    if a.dtype.name == "bfloat16" or (a.dtype.kind == "V"
                                      and a.dtype.itemsize == 2):
        bits = np.ascontiguousarray(a).view(np.uint16).astype(np.uint32)
        return (bits << 16).view(np.float32)
    return a


def load_params_npz(path: str):
    """Returns (params, enc_cfg, dec_cfg) from a ``save_params_npz``
    bundle; params is a nested dict of numpy arrays, floats as fp32."""
    with np.load(path) as blob:
        enc_cfg = config_from_json(bytes(blob["__enc_cfg__"]).decode())
        dec_cfg = config_from_json(bytes(blob["__dec_cfg__"]).decode())
        params: Dict[str, Any] = {}
        for key in blob.files:
            if not key.startswith("p:"):
                continue
            node = params
            parts = key[2:].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = _to_f32(blob[key])
    return params, enc_cfg, dec_cfg


def _lin(sd, prefix, p, index=None):
    w = np.asarray(p["w"] if index is None else p["w"][index])
    sd[prefix + ".weight"] = w.T
    if "b" in p:
        sd[prefix + ".bias"] = np.asarray(
            p["b"] if index is None else p["b"][index])


def _ln(sd, prefix, p, index=None):
    sd[prefix + ".weight"] = np.asarray(
        p["scale"] if index is None else p["scale"][index])
    sd[prefix + ".bias"] = np.asarray(
        p["bias"] if index is None else p["bias"][index])


def _mlp(sd, prefix, p, index=None):
    _lin(sd, prefix + ".fc1", p["fc1"], index)
    _lin(sd, prefix + ".fc2", p["fc2"], index)


def _torch_sd(sd):
    return {k: torch.from_numpy(np.ascontiguousarray(v, np.float32))
            for k, v in sd.items()}


def params_from_jax(tree, enc_cfg: EncoderConfig, dec_cfg: DecoderConfig
                    ) -> Tuple[Dict[str, torch.Tensor],
                               Dict[str, torch.Tensor]]:
    """JAX parameter tree {'encoder', 'decoder'} -> (encoder state dict,
    decoder state dict) of fp32 CPU tensors under the reference keys."""
    enc, dec = tree["encoder"], tree["decoder"]
    esd: Dict[str, np.ndarray] = {}
    w = np.asarray(enc["patch_embed"]["w"])                  # [3*P*P, D]
    p_sz = enc_cfg.patch_size
    esd["patch_embed.proj.weight"] = w.T.reshape(enc_cfg.embed_dim, 3, p_sz,
                                                 p_sz)
    esd["patch_embed.proj.bias"] = np.asarray(enc["patch_embed"]["b"])
    blocks = enc["blocks"]
    for i in range(enc_cfg.depth):
        pre = f"blocks_enc.{i}"
        _ln(esd, f"{pre}.norm1", blocks["norm1"], i)
        _lin(esd, f"{pre}.attn.qkv", blocks["attn"]["qkv"], i)
        _lin(esd, f"{pre}.attn.proj", blocks["attn"]["proj"], i)
        _ln(esd, f"{pre}.norm2", blocks["norm2"], i)
        _mlp(esd, f"{pre}.mlp", blocks["mlp"], i)
    _ln(esd, "norm_enc", enc["norm"])

    dsd: Dict[str, np.ndarray] = {}
    _lin(dsd, "feat_embed_enc_to_dec", dec["feat_embed"])
    dsd["image2_embed"] = np.asarray(dec["image2_embed"]).reshape(1, 1, -1)
    blocks = dec["blocks"]
    for i in range(dec_cfg.depth):
        pre = f"blocks_dec.{i}"
        _ln(dsd, f"{pre}.norm1", blocks["norm1"], i)
        _lin(dsd, f"{pre}.attn.qkv", blocks["attn"]["qkv"], i)
        _lin(dsd, f"{pre}.attn.proj", blocks["attn"]["proj"], i)
        _ln(dsd, f"{pre}.norm2", blocks["norm2"], i)
        _ln(dsd, f"{pre}.norm_y", blocks["norm_y"], i)
        _lin(dsd, f"{pre}.cross_attn.projq", blocks["projq"], i)
        _lin(dsd, f"{pre}.cross_attn.projk", blocks["projk"], i)
        _lin(dsd, f"{pre}.cross_attn.projv", blocks["projv"], i)
        _lin(dsd, f"{pre}.cross_attn.proj", blocks["proj_ca"], i)
        _ln(dsd, f"{pre}.norm3", blocks["norm3"], i)
        _mlp(dsd, f"{pre}.mlp", blocks["mlp"], i)
    _ln(dsd, "norm_dec", dec["norm_dec"])
    _lin(dsd, "head_dec.proj", dec["head_proj"])
    if "feedback" in dec:
        if "fc1" in dec["feedback"]:
            _mlp(dsd, "feedback_layer", dec["feedback"])
        else:
            _lin(dsd, "feedback_layer", dec["feedback"])
        _ln(dsd, "feedback_norm", dec["feedback_norm"])
    return _torch_sd(esd), _torch_sd(dsd)


def _state_dict(m) -> Dict[str, torch.Tensor]:
    """fp32 CPU tensors of a module's state dict (or of a state dict)."""
    sd = m.state_dict() if hasattr(m, "state_dict") else m
    return {k: v.detach().float().cpu() if v.is_floating_point()
            else v.detach().cpu() for k, v in sd.items()}


def params_to_jax(enc, dec, enc_cfg: EncoderConfig,
                  dec_cfg: DecoderConfig) -> Dict[str, Any]:
    """The port's encoder and decoder (modules or reference-key state
    dicts) -> the JAX package's parameter tree {'encoder', 'decoder'} of
    fp32 numpy arrays (blocks stacked, linear ``w`` as [din, dout]); the
    inverse of :func:`params_from_jax`."""
    esd = {k: v.numpy() for k, v in _state_dict(enc).items()}
    dsd = {k: v.numpy() for k, v in _state_dict(dec).items()}

    def lin(sd, prefix):
        p = {"w": np.ascontiguousarray(sd[prefix + ".weight"].T)}
        if prefix + ".bias" in sd:
            p["b"] = sd[prefix + ".bias"]
        return p

    def ln(sd, prefix):
        return {"scale": sd[prefix + ".weight"], "bias": sd[prefix + ".bias"]}

    def mlp(sd, prefix):
        return {"fc1": lin(sd, prefix + ".fc1"), "fc2": lin(sd, prefix + ".fc2")}

    def stack(blocks):
        def rec(*xs):
            if isinstance(xs[0], dict):
                return {k: rec(*(x[k] for x in xs)) for k in xs[0]}
            return np.stack(xs)
        return rec(*blocks)

    w = esd["patch_embed.proj.weight"]
    encoder = {
        "patch_embed": {"w": np.ascontiguousarray(w.reshape(w.shape[0], -1).T),
                        "b": esd["patch_embed.proj.bias"]},
        "blocks": stack([{
            "norm1": ln(esd, f"blocks_enc.{i}.norm1"),
            "attn": {"qkv": lin(esd, f"blocks_enc.{i}.attn.qkv"),
                     "proj": lin(esd, f"blocks_enc.{i}.attn.proj")},
            "norm2": ln(esd, f"blocks_enc.{i}.norm2"),
            "mlp": mlp(esd, f"blocks_enc.{i}.mlp")}
            for i in range(enc_cfg.depth)]),
        "norm": ln(esd, "norm_enc")}
    decoder = {
        "feat_embed": lin(dsd, "feat_embed_enc_to_dec"),
        "image2_embed": dsd["image2_embed"].reshape(-1),
        "blocks": stack([{
            "norm1": ln(dsd, f"{p}.norm1"),
            "attn": {"qkv": lin(dsd, f"{p}.attn.qkv"),
                     "proj": lin(dsd, f"{p}.attn.proj")},
            "norm2": ln(dsd, f"{p}.norm2"),
            "norm_y": ln(dsd, f"{p}.norm_y"),
            "projq": lin(dsd, f"{p}.cross_attn.projq"),
            "projk": lin(dsd, f"{p}.cross_attn.projk"),
            "projv": lin(dsd, f"{p}.cross_attn.projv"),
            "proj_ca": lin(dsd, f"{p}.cross_attn.proj"),
            "norm3": ln(dsd, f"{p}.norm3"),
            "mlp": mlp(dsd, f"{p}.mlp")}
            for p in (f"blocks_dec.{i}" for i in range(dec_cfg.depth))]),
        "norm_dec": ln(dsd, "norm_dec"),
        "head_proj": lin(dsd, "head_dec.proj")}
    if "feedback_layer.fc1.weight" in dsd:
        decoder["feedback"] = mlp(dsd, "feedback_layer")
        decoder["feedback_norm"] = ln(dsd, "feedback_norm")
    elif "feedback_layer.weight" in dsd:
        decoder["feedback"] = lin(dsd, "feedback_layer")
        decoder["feedback_norm"] = ln(dsd, "feedback_norm")
    return {"encoder": encoder, "decoder": decoder}


def save_params_npz(path: str, params, enc_cfg: EncoderConfig,
                    dec_cfg: DecoderConfig, dtype=np.float16):
    """Write the JAX package's single-file bundle: ``params``
    {'encoder', 'decoder'} (modules or state dicts) in its tree layout
    under 'p:<path>' keys, float leaves stored as ``dtype`` (fp16 halves
    the file), the configs as JSON bytes."""
    tree = params_to_jax(params["encoder"], params["decoder"], enc_cfg,
                         dec_cfg)
    flat = {"__enc_cfg__": np.frombuffer(config_to_json(enc_cfg).encode(),
                                         dtype=np.uint8),
            "__dec_cfg__": np.frombuffer(config_to_json(dec_cfg).encode(),
                                         dtype=np.uint8)}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + k + "/")
            else:
                a = np.asarray(v)
                flat["p:" + prefix + k] = (a.astype(dtype)
                                           if a.dtype == np.float32 else a)
    walk(tree, "")
    np.savez_compressed(path, **flat)


def export_torch_checkpoint(path: str, params, enc_cfg: EncoderConfig,
                            dec_cfg: DecoderConfig, epoch: int = 0):
    """Write a reference-layout ``.pth``: the encoder and decoder state
    dicts as fp32 CPU tensors and the constructor strings that the
    reference's ``load_model`` evaluates (``model/__init__.py:30-39``)."""
    import argparse

    torch.save({"encoder": _state_dict(params["encoder"]),
                "decoder": _state_dict(params["decoder"]),
                "args": argparse.Namespace(
                    encoder=encoder_config_to_arg_string(enc_cfg),
                    decoder=decoder_config_to_arg_string(dec_cfg)),
                "epoch": epoch}, path)


_DUST3R_RENAMES = (
    # dust3r / croco key prefix -> must3r prefix (reference
    # encoder.py:54-65, decoder.py:83-96, from_dust3r / from_croco)
    ("enc_blocks.", "blocks_enc."),
    ("enc_norm.", "norm_enc."),
    ("dec_blocks.", "blocks_dec."),
    ("decoder_embed.", "feat_embed_enc_to_dec."),
    ("dec_norm.", "norm_dec."),
    ("downstream_head.proj.", "head_dec.proj."),
)


def rename_dust3r_keys(sd: Dict[str, Any]) -> Dict[str, Any]:
    """A dust3r / croco state dict under the reference's MUSt3R keys."""
    out = {}
    for k, v in sd.items():
        for old, new in _DUST3R_RENAMES:
            if k.startswith(old):
                k = new + k[len(old):]
                break
        out[k] = v
    return out


def init_from_dust3r(path: str, enc_cfg: EncoderConfig,
                     dec_cfg: DecoderConfig, seed: int = 0,
                     load_head: bool = False):
    """A training warm start from a dust3r / croco checkpoint (reference
    ``train.py:274-293``): the port's seeded init (:func:`init_model` on
    the CPU), then, under the renamed keys, the whole encoder from the
    file where it holds every encoder key, and of the decoder the parts the
    file holds whole (the feature embedding, the final norm, the head with
    ``load_head``, the blocks when every block key is there: a dust3r
    decoder lacks ``image2_embed``, so its blocks stay fresh, as in the
    JAX package). The reference's ``strict=False`` load. Returns
    ({'encoder', 'decoder'} fp32 CPU state dicts, {'encoder_loaded',
    'decoder_parts_loaded'})."""
    enc, dec = init_model(enc_cfg, dec_cfg, seed=seed, device="cpu")
    esd, dsd = _state_dict(enc), _state_dict(dec)
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = rename_dust3r_keys({k: v.float() for k, v in
                             ckpt.get("model", ckpt).items()})

    def take(dst, prefix, also=()):
        keys = [k for k in dst if k.startswith(prefix)]
        if not keys or any(k not in sd for k in keys + list(also)):
            return 0
        for k in keys:
            dst[k] = sd[k].reshape(dst[k].shape).clone()
        return 1

    enc_loaded = bool(take(esd, ""))
    # the blocks as the JAX package converts them: with the rest of a
    # whole decoder in the file
    dec_loaded = (take(dsd, "feat_embed_enc_to_dec.")
                  + take(dsd, "norm_dec.")
                  + (take(dsd, "head_dec.proj.") if load_head else 0)
                  + take(dsd, "blocks_dec.", also=(
                      "feat_embed_enc_to_dec.weight", "image2_embed",
                      "norm_dec.weight", "head_dec.proj.weight")))
    return {"encoder": esd, "decoder": dsd}, {
        "encoder_loaded": enc_loaded, "decoder_parts_loaded": dec_loaded}


def load_model(enc_sd, dec_sd, enc_cfg: EncoderConfig,
               dec_cfg: DecoderConfig, device="cuda"
               ) -> Tuple[Encoder, Decoder]:
    """Encoder and decoder on ``device`` from reference-key state dicts
    (strict: every key must match)."""
    with torch.device("meta"):
        enc, dec = Encoder(enc_cfg), Decoder(dec_cfg)
    enc = enc.to_empty(device=device)
    dec = dec.to_empty(device=device)
    with torch.no_grad():
        enc.load_state_dict(enc_sd)
        dec.load_state_dict(dec_sd)
    return enc.requires_grad_(False), dec.requires_grad_(False)


def init_model(enc_cfg: EncoderConfig, dec_cfg: DecoderConfig,
               seed: int = 0, device="cuda") -> Tuple[Encoder, Decoder]:
    """Random encoder and decoder drawn from one ``torch.Generator``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return (init_encoder(enc_cfg, gen, device),
            init_decoder(dec_cfg, gen, device))


def load_torch_checkpoint(path: str, img_size=None, device="cuda"):
    """A reference ``.pth`` (state dicts under 'encoder' / 'decoder' plus the
    constructor strings in 'args'): the state dicts load without a
    converter. Returns (encoder, decoder, enc_cfg, dec_cfg)."""
    from must3r_tpu_torch.config import (decoder_config_from_arg_string,
                                         encoder_config_from_arg_string,
                                         set_image_size)

    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    args = ckpt["args"]
    get = (lambda k: getattr(args, k)) if hasattr(args, "encoder") else \
        (lambda k: args[k])
    enc_cfg = encoder_config_from_arg_string(get("encoder"))
    dec_cfg = decoder_config_from_arg_string(get("decoder"))
    dec_cfg = dec_cfg.inference_variant()
    if img_size is not None:
        enc_cfg = set_image_size(enc_cfg, img_size)
        dec_cfg = set_image_size(dec_cfg, img_size)

    def f32(sd):
        return {k: v.float() for k, v in sd.items()}

    enc, dec = load_model(f32(ckpt["encoder"]), f32(ckpt["decoder"]),
                          enc_cfg, dec_cfg, device)
    return enc, dec, enc_cfg, dec_cfg


# ---------------------------------------------------------------------------
# Training checkpoints
# ---------------------------------------------------------------------------

def save_checkpoint(path: str, params, enc_cfg: EncoderConfig,
                    dec_cfg: DecoderConfig, opt_state=None, step: int = 0):
    """Write a checkpoint directory. ``params`` maps a name to a module or
    a state dict; every float tensor is stored fp32 on the CPU (bf16 ->
    fp32 is exact), whatever dtype and device it is held in. The state
    file is written under a temporary name and renamed, so an interrupted
    write leaves the previous checkpoint whole."""
    def host(x):
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu()
            return x.float() if x.is_floating_point() else x
        if isinstance(x, dict):
            return {k: host(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(host(v) for v in x)
        return x

    os.makedirs(path, exist_ok=True)
    state = {"params": {k: host(m.state_dict() if hasattr(m, "state_dict")
                                else m) for k, m in params.items()},
             "opt_state": host(opt_state), "step": int(step)}
    tmp = os.path.join(path, f"state.pth.{os.getpid()}.tmp")
    torch.save(state, tmp)
    os.replace(tmp, os.path.join(path, "state.pth"))
    meta = {"encoder_config": config_to_json(enc_cfg),
            "decoder_config": config_to_json(dec_cfg), "step": int(step)}
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)


def load_checkpoint(path: str, device="cuda"):
    """Returns (params, enc_cfg, dec_cfg, opt_state or None, meta): params
    maps a name to an fp32 state dict; tensors of the optimizer state are
    moved to ``device``."""
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    state = torch.load(os.path.join(path, "state.pth"), map_location="cpu",
                       weights_only=True)

    def to_dev(x):
        if isinstance(x, torch.Tensor):
            return x.to(device)
        if isinstance(x, dict):
            return {k: to_dev(v) for k, v in x.items()}
        return x

    return (state["params"], config_from_json(meta["encoder_config"]),
            config_from_json(meta["decoder_config"]),
            to_dev(state["opt_state"]), meta)


def latest_checkpoint(output_dir: str) -> Optional[str]:
    """The newest ``checkpoint-*`` directory under ``output_dir`` (numbered
    ones by number, then 'last' / 'final'), or None."""
    if not os.path.isdir(output_dir):
        return None
    cands = [d for d in os.listdir(output_dir)
             if d.startswith("checkpoint-")
             and os.path.isfile(os.path.join(output_dir, d, "meta.json"))]
    if not cands:
        return None

    def key(d):
        tag = d.split("-", 1)[1]
        return (1, int(tag)) if tag.isdigit() else (2, 0)

    return os.path.join(output_dir, max(cands, key=key))


# ---------------------------------------------------------------------------
# VGGT
# ---------------------------------------------------------------------------

VGGT_LEFT_OUT = ("track_head.",)


def load_vggt(sd: Dict[str, torch.Tensor], cfg: VGGTConfig,
              device="cuda") -> VGGT:
    """A VGGT on ``device`` from a state dict under the published key
    names, fp32 (strict: every key of the model must be there, and no
    other but the track head's)."""
    with torch.device("meta"):
        model = VGGT(cfg)
    model = model.to_empty(device=device)
    sd = {k: v.float() for k, v in sd.items()
          if not k.startswith(VGGT_LEFT_OUT)}
    with torch.no_grad():
        model.load_state_dict(sd)
    return model.requires_grad_(False)


def init_vggt(cfg: VGGTConfig, seed: int = 0, device="cuda") -> VGGT:
    """A random VGGT drawn from one ``torch.Generator`` on ``device``."""
    with torch.device("meta"):
        model = VGGT(cfg)
    model = model.to_empty(device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    return init_vggt_(model, gen).requires_grad_(False)


def save_vggt_checkpoint(path: str, model: VGGT):
    """``path`` (.pt): {'model': the fp32 state dict on the CPU, 'config':
    the config as JSON}, written under a temporary name and renamed."""
    state = {"model": {k: v.detach().cpu().float()
                       for k, v in model.state_dict().items()},
             "config": config_to_json(model.cfg)}
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)


def load_vggt_checkpoint(path: str, device="cuda",
                         cfg: Optional[VGGTConfig] = None) -> VGGT:
    """A model from :func:`save_vggt_checkpoint`'s file (its config), or
    from a published bare state dict (``cfg``, default VGGT-1B)."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if "config" in state and "model" in state:
        return load_vggt(state["model"], config_from_json(state["config"]),
                         device)
    return load_vggt(state, cfg or vggt_1b_config(), device)
