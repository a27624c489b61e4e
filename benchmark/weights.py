"""Seeded random weights of a MUSt3R configuration, made on the device.

Every leaf is drawn from one float32 uniform tensor, generated by one call
on the device's own ``torch.Generator``: matrices uniform in +-sqrt(6 /
(fan_in + fan_out)) (Xavier), biases in +-0.02, LayerNorm gains in 1 +-
0.1 and shifts in +-0.02, ``image2_embed`` in +-0.02. No leaf is zero, so
every term of the model (biases, the feedback MLP, the LayerNorms)
reaches the outputs. The same seed gives the same weights on the same
device; the program and the reference each get them from here.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch


def _linear(name: str, n_in: int, n_out: int):
    return [(f"{name}.weight", (n_out, n_in), "matrix"),
            (f"{name}.bias", (n_out,), "bias")]


def _norm(name: str, d: int):
    return [(f"{name}.weight", (d,), "gain"), (f"{name}.bias", (d,), "bias")]


def _mlp(name: str, d: int, hidden: int):
    return _linear(f"{name}.fc1", d, hidden) + _linear(f"{name}.fc2", hidden,
                                                        d)


def leaves(cfg: dict) -> List[Tuple[str, tuple, str]]:
    """(name, shape, kind) of every leaf, under the published key names."""
    enc, dec = cfg["encoder"], cfg["decoder"]
    de, p = enc["embed_dim"], enc["patch_size"]
    out = [("encoder.patch_embed.proj.weight", (de, 3, p, p), "matrix"),
           ("encoder.patch_embed.proj.bias", (de,), "bias")]
    he = int(de * enc["mlp_ratio"])
    for i in range(enc["depth"]):
        pre = f"encoder.blocks_enc.{i}"
        out += (_norm(f"{pre}.norm1", de) + _linear(f"{pre}.attn.qkv", de,
                                                    3 * de)
                + _linear(f"{pre}.attn.proj", de, de)
                + _norm(f"{pre}.norm2", de) + _mlp(f"{pre}.mlp", de, he))
    out += _norm("encoder.norm_enc", de)
    d = dec["embed_dim"]
    hd = int(d * dec["mlp_ratio"])
    out += _linear("decoder.feat_embed_enc_to_dec", dec["enc_embed_dim"], d)
    out.append(("decoder.image2_embed", (1, 1, d), "bias"))
    for i in range(dec["depth"]):
        pre = f"decoder.blocks_dec.{i}"
        out += (_norm(f"{pre}.norm1", d) + _linear(f"{pre}.attn.qkv", d, 3 * d)
                + _linear(f"{pre}.attn.proj", d, d) + _norm(f"{pre}.norm2", d)
                + _norm(f"{pre}.norm_y", d))
        for proj in ("projq", "projk", "projv", "proj"):
            out += _linear(f"{pre}.cross_attn.{proj}", d, d)
        out += _norm(f"{pre}.norm3", d) + _mlp(f"{pre}.mlp", d, hd)
    out += _mlp("decoder.feedback_layer", d, 4 * d)
    out += _norm("decoder.feedback_norm", d)
    out += _norm("decoder.norm_dec", d)
    out += _linear("decoder.head_dec.proj", d, dec["output_dim"])
    return out


def _range(shape, kind) -> Tuple[float, float]:
    """(centre, half-width) of a leaf's uniform distribution."""
    if kind == "matrix":
        fan_out = shape[0]
        fan_in = 1
        for s in shape[1:]:
            fan_in *= s
        return 0.0, (6.0 / (fan_in + fan_out)) ** 0.5
    if kind == "gain":
        return 1.0, 0.1
    return 0.0, 0.02


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor} on ``device`` from ``seed``: one uniform draw
    in [-1, 1) for every leaf, then each leaf scaled and shifted in place
    (views of the one buffer)."""
    spec = leaves(cfg)
    sizes = [int(torch.Size(shape).numel()) for _, shape, _ in spec]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(sum(sizes), generator=gen, device=device)
    flat.mul_(2.0).sub_(1.0)
    out = {}
    for (name, shape, kind), t in zip(spec, torch.split(flat, sizes)):
        centre, half = _range(shape, kind)
        out[name] = t.mul_(half).add_(centre).view(shape)
    return out


def split(weights: Dict[str, torch.Tensor]):
    """(encoder state dict, decoder state dict) with the module prefixes
    taken off, as a model's modules hold them."""
    parts = ({}, {})
    for name, t in weights.items():
        mod, key = name.split(".", 1)
        parts[mod == "decoder"][key] = t
    return parts
