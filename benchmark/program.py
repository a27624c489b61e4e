"""The benchmark's side of the program under test: a configuration file's
sizes as the program's config objects, and a model loaded from the
benchmark's weights. Only the traffic drivers and the tests import this
module; the reference never does."""

from __future__ import annotations

import dataclasses

import torch

from must3r_tpu_torch.checkpoint import load_model
from must3r_tpu_torch.config import (ActivationType, DecoderConfig,
                                     EncoderConfig, FeedbackType, MemoryMode,
                                     RoPEConfig)

from benchmark.weights import make_weights, split


def program_configs(cfg: dict, causal=None):
    """(EncoderConfig, DecoderConfig) of a configuration file."""
    enc, dec = cfg["encoder"], cfg["decoder"]
    enc_cfg = EncoderConfig(
        img_size=tuple(enc["img_size"]), patch_size=enc["patch_size"],
        embed_dim=enc["embed_dim"], depth=enc["depth"],
        num_heads=enc["num_heads"], mlp_ratio=float(enc["mlp_ratio"]),
        rope=RoPEConfig(base=float(enc["rope_base"])))
    dec_cfg = DecoderConfig(
        img_size=tuple(dec["img_size"]), enc_embed_dim=dec["enc_embed_dim"],
        patch_size=dec["patch_size"], embed_dim=dec["embed_dim"],
        output_dim=dec["output_dim"], depth=dec["depth"],
        num_heads=dec["num_heads"], mlp_ratio=float(dec["mlp_ratio"]),
        rope=RoPEConfig(base=float(dec["rope_base"])),
        feedback=FeedbackType(dec["feedback"]),
        memory_mode=MemoryMode(dec["memory_mode"]),
        pointmaps_activation=ActivationType(dec["pointmaps_activation"]),
        causal=bool(dec["causal"]),
        protected_imgs=int(dec.get("protected_imgs", 1)))
    if causal is not None:
        dec_cfg = dataclasses.replace(dec_cfg, causal=causal)
    return enc_cfg, dec_cfg


def load_program_model(cfg: dict, seed: int, device, causal=None):
    """(encoder, decoder, enc_cfg, dec_cfg): the program's modules holding
    the benchmark's weights of ``seed``."""
    enc_cfg, dec_cfg = program_configs(cfg, causal)
    weights = make_weights(cfg, seed, device)
    enc_sd, dec_sd = split(weights)
    enc, dec = load_model(enc_sd, dec_sd, enc_cfg, dec_cfg, device)
    del weights, enc_sd, dec_sd
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return enc, dec, enc_cfg, dec_cfg
