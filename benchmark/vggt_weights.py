"""Seeded random weights of a VGGT configuration, made on the device,
under the published state-dict key names (the track head left out).

As ``weights.py`` does for MUSt3R, every leaf is drawn from one float32
uniform tensor by one call on the device's own ``torch.Generator``:
matrices and convolution kernels uniform in +-sqrt(6 / (fan_in +
fan_out)) (fan_in: every dimension but the first; fan_out: the first),
biases, embeddings and tokens in +-0.02, LayerNorm gains in 1 +- 0.1,
LayerScale vectors in their init +- half of it (1.0 in the DINOv2 tower,
0.01 in the aggregator and the camera trunk). The DPT heads' last 1 x 1
convolutions are drawn at a tenth of Xavier's range (``OUT_SCALE``): their
outputs are what exp and expm1 take (log-depth, the points' log-magnitude,
the confidences' logits), O(1) in a trained model; at Xavier's range the
heads' residual stack carries them to +-20, where exp turns the bf16
rounding of the aggregator into tens of per cent and confidences reach
1e10. No leaf is zero, so every term of the model reaches the outputs. The same seed gives the same
weights on the same device; the program and the reference each get them
from here.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from benchmark.weights import _linear, _mlp, _norm, _range

POSE_DIM, DPT_HIDDEN = 9, 32
OUT_SCALE = 0.1


def _scale(name: str, d: int, init: float):
    return [(f"{name}.gamma", (d,), f"scale:{init}")]


def _block(pre: str, d: int, hidden: int, ls: float, qk_dim: int = 0):
    out = _norm(f"{pre}.norm1", d) + _linear(f"{pre}.attn.qkv", d, 3 * d)
    if qk_dim:
        out += _norm(f"{pre}.attn.q_norm", qk_dim) + _norm(
            f"{pre}.attn.k_norm", qk_dim)
    out += _linear(f"{pre}.attn.proj", d, d) + _scale(f"{pre}.ls1", d, ls)
    out += _norm(f"{pre}.norm2", d) + _mlp(f"{pre}.mlp", d, hidden)
    return out + _scale(f"{pre}.ls2", d, ls)


def _conv(name: str, c_in: int, c_out: int, k: int, bias: bool = True):
    out = [(f"{name}.weight", (c_out, c_in, k, k), "matrix")]
    return out + ([(f"{name}.bias", (c_out,), "bias")] if bias else [])


def _dpt(pre: str, c: int, f: int, oc, n_out: int):
    out = _norm(f"{pre}.norm", c)
    for i, o in enumerate(oc):
        out += _conv(f"{pre}.projects.{i}", c, o, 1)
    for i, (k, o) in enumerate(((4, oc[0]), (2, oc[1]))):
        # transposed convolutions hold [in, out, k, k]
        out += [(f"{pre}.resize_layers.{i}.weight", (o, o, k, k), "matrix"),
                (f"{pre}.resize_layers.{i}.bias", (o,), "bias")]
    out += _conv(f"{pre}.resize_layers.3", oc[3], oc[3], 3)
    for i, o in enumerate(oc):
        out += _conv(f"{pre}.scratch.layer{i + 1}_rn", o, f, 3, bias=False)
    for i in range(4):
        r = f"{pre}.scratch.refinenet{i + 1}"
        out += _conv(f"{r}.out_conv", f, f, 1)
        for unit in (("resConfUnit1", "resConfUnit2") if i < 3
                     else ("resConfUnit2",)):
            out += _conv(f"{r}.{unit}.conv1", f, f, 3)
            out += _conv(f"{r}.{unit}.conv2", f, f, 3)
    out += _conv(f"{pre}.scratch.output_conv1", f, f // 2, 3)
    out += _conv(f"{pre}.scratch.output_conv2.0", f // 2, DPT_HIDDEN, 3)
    out += [(f"{pre}.scratch.output_conv2.2.weight", (n_out, DPT_HIDDEN, 1,
                                                       1), "out"),
            (f"{pre}.scratch.output_conv2.2.bias", (n_out,), "bias")]
    return out


def leaves(cfg: dict) -> List[Tuple[str, tuple, str]]:
    """(name, shape, kind) of every leaf, under the published key names."""
    enc, dec = cfg["encoder"], cfg["decoder"]
    cam, dpt = cfg["camera_head"], cfg["dpt_head"]
    d, p = enc["embed_dim"], enc["patch_size"]
    pre = "aggregator.patch_embed"
    grid = (enc["img_size"] // p) ** 2
    r = enc["num_register_tokens"]
    out = [(f"{pre}.cls_token", (1, 1, d), "bias"),
           (f"{pre}.pos_embed", (1, 1 + grid, d), "bias"),
           (f"{pre}.register_tokens", (1, r, d), "bias"),
           (f"{pre}.mask_token", (1, d), "bias")]
    out += _conv(f"{pre}.patch_embed.proj", 3, d, p)
    hidden = int(d * enc["mlp_ratio"])
    for i in range(enc["depth"]):
        out += _block(f"{pre}.blocks.{i}", d, hidden,
                      enc["layerscale_init"])
    out += _norm(f"{pre}.norm", d)
    dd = dec["embed_dim"]
    hd = int(dd * dec["mlp_ratio"])
    for kind in ("frame", "global"):
        for i in range(dec["depth"]):
            out += _block(f"aggregator.{kind}_blocks.{i}", dd, hd,
                          dec["layerscale_init"],
                          dd // dec["num_heads"] if dec["qk_norm"] else 0)
    out += [("aggregator.camera_token", (1, 2, 1, dd), "bias"),
            ("aggregator.register_token", (1, 2, r, dd), "bias")]
    c = cam["dim"]
    for i in range(cam["trunk_depth"]):
        out += _block(f"camera_head.trunk.{i}", c, int(c * cam["mlp_ratio"]),
                      cam["layerscale_init"])
    out += _norm("camera_head.token_norm", c) + _norm(
        "camera_head.trunk_norm", c)
    out += [("camera_head.empty_pose_tokens", (1, 1, POSE_DIM), "bias")]
    out += _linear("camera_head.embed_pose", POSE_DIM, c)
    out += _linear("camera_head.poseLN_modulation.1", c, 3 * c)
    out += _mlp("camera_head.pose_branch", c, c // 2)[:2] + _linear(
        "camera_head.pose_branch.fc2", c // 2, POSE_DIM)
    for name, n_out in (("depth_head", dpt["depth_channels"]),
                        ("point_head", dpt["point_channels"])):
        out += _dpt(name, c, dpt["features"], dpt["out_channels"], n_out)
    return out


def _leaf_range(shape, kind) -> Tuple[float, float]:
    if kind.startswith("scale:"):
        init = float(kind.split(":")[1])
        return init, init / 2
    if kind == "out":
        return 0.0, OUT_SCALE * _range(shape, "matrix")[1]
    return _range(shape, kind)


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
        centre, half = _leaf_range(shape, kind)
        out[name] = t.mul_(half).add_(centre).view(shape)
    return out
