"""Plain VGGT in PyTorch: the benchmark's reference for the ``vggt_*``
configurations.

Written from the published description of VGGT (Wang et al., CVPR 2025,
arXiv:2503.11651) and its code (github.com/facebookresearch/vggt). It
imports nothing of the program under test: every tensor here is computed
from the weights and inputs that the benchmark made, in float32 with TF32
off, with plain matrix products, a dense softmax and ``torch.nn.functional``
convolutions.

Weights are a dict of float32 tensors under the published state-dict key
names (``aggregator.frame_blocks.0.attn.qkv.weight`` ...);
``benchmark/vggt_weights.py`` makes them. A configuration file's sections
give the sizes: ``encoder`` (the DINOv2 tower), ``decoder`` (the
aggregator), ``camera_head`` and ``dpt_head``.

The forward, for S frames [S, H, W, 3] in [0, 1]:

* normalise by the ImageNet mean and std; the tower embeds 14 x 14 patches
  (a product over unfolded patches, the conv weight flattened), prepends
  the cls token, adds the position embedding (its patch part bicubic-
  resized with antialias from the learned square to the frame's grid),
  inserts the register tokens after cls, runs pre-norm blocks with
  LayerScale (eps 1e-6, exact GELU), a final LayerNorm, and keeps the
  patch tokens;
* the aggregator prepends [camera, registers] (frame 0 index 0, the others
  index 1) and runs, per iteration, a frame block (attention within each
  frame) and a global block (over all S x P tokens): LN, qkv, LayerNorm of
  each head's q and k, RoPE2D of base 100 at (0, 0) for the special
  tokens and (row + 1, col + 1) for the patches, softmax(q k^T / sqrt(Dh))
  v, proj, LayerScale; then LN, the MLP, LayerScale (LN eps 1e-5).
  Iteration i gives concat(frame_i, global_i);
* the camera head: LN of the last iteration's camera tokens, 4 times: the
  pose so far (the learned empty pose first) embedded, SiLU, a linear map
  to (shift, scale, gate), gate * (LN_noaffine(t) (1 + scale) + shift) +
  t, the trunk (LayerScale blocks, dense softmax), LN, the pose branch's
  correction added; ReLU on the fields of view of the last;
* each DPT head: LN of the patch tokens of four iterations, 1 x 1
  projections, the sine-cosine embedding of the aspect-normalised grid
  (x 0.1), resizing (transposed convolutions x 4 and x 2, identity, a
  stride-2 convolution), 3 x 3 convolutions to the features, fusion from
  the coarsest: path + RCU(skip), RCU, a bilinear resize (align_corners),
  a 1 x 1 convolution; then a 3 x 3 convolution, a bilinear resize to
  H x W, the embedding again, a 3 x 3 convolution, ReLU, a 1 x 1
  convolution; depth exp, points sign expm1 |x|, confidences 1 + exp.

Departures, each deliberate:

* Global attention runs in blocks of query rows (``Q_BLOCK``) against all
  keys, so that a 66,624-token layer fits; each row's softmax is whole,
  so the result is the dense one.
* The DPT heads run over ``FRAMES_CHUNK`` frames at a time (frames are
  independent there), to bound the float32 maps' memory.
* The RCU's skip carries relu(x): the published fusion blocks' ReLU is in
  place, so the input it adds back has been rectified.
* RoPE's tables are float32 (the published code builds them in the
  tokens' dtype, float32 here as well).

``Numerics`` selects the controls: the aggregator's products (its linear
maps, the patch embedding and both attention products) with their
operands rounded to float8 e4m3 (``products="fp8"``), or the heads
computed in bfloat16 (``heads_dtype``), a step below the float32 that the
configuration states for them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from benchmark.reference.must3r import fp8_round, full_precision  # noqa: F401

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
Q_BLOCK = 512
FRAMES_CHUNK = 8


@dataclass(frozen=True)
class Numerics:
    """``products``: "fp32" or "fp8" (the aggregator's product operands in
    e4m3, a scale per row); ``heads_dtype``: "float32" or "bfloat16"."""
    products: str = "fp32"
    heads_dtype: str = "float32"

    def mm(self, a, b):
        if self.products == "fp8":
            a, b = fp8_round(a, -1), fp8_round(b, -2)
        return torch.matmul(a, b)


REFERENCE = Numerics()
FP32 = Numerics()            # the heads' own products, whatever the control


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def linear(W, name, x, nm: Numerics = FP32):
    y = nm.mm(x, W[name + ".weight"].t().to(x.dtype))
    b = W.get(name + ".bias")
    return y if b is None else y + b.to(x.dtype)


def layer_norm(W, name, x, eps):
    return F.layer_norm(x, (x.shape[-1],), W[name + ".weight"].to(x.dtype),
                        W[name + ".bias"].to(x.dtype), eps)


def mlp(W, name, x, nm=FP32):
    return linear(W, name + ".fc2", F.gelu(linear(W, name + ".fc1", x, nm)),
                  nm)


def rope_tables(pos, head_dim: int, base: float):
    """RoPE2D: the first half of a head rotates by y, the second by x, each
    half's two quarters paired at frequencies base^(-2k / (Dh / 2)).
    pos [N, 2] -> (cos, sin) [N, 2, Dh / 2]."""
    d = head_dim // 2
    inv = 1.0 / base ** (torch.arange(0, d, 2, dtype=torch.float32,
                                      device=pos.device) / d)
    ang = pos.float()[..., None] * inv
    ang = torch.cat([ang, ang], dim=-1)
    return ang.cos(), ang.sin()


def apply_rope(t, cos, sin):
    """t [B, H, N, Dh] with tables [N, 2, Dh / 2]."""
    out = []
    for axis, half in enumerate(t.chunk(2, dim=-1)):
        a, b = half.chunk(2, dim=-1)
        rot = torch.cat([-b, a], dim=-1)
        out.append(half * cos[:, axis] + rot * sin[:, axis])
    return torch.cat(out, dim=-1)


def attention(q, k, v, nm: Numerics):
    """softmax(q k^T / sqrt(Dh)) v, [B, H, N, Dh], in blocks of query
    rows."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    out = []
    for r0 in range(0, q.shape[2], Q_BLOCK):
        s = nm.mm(q[:, :, r0:r0 + Q_BLOCK] * scale, k.transpose(-1, -2))
        out.append(nm.mm(torch.softmax(s, dim=-1), v))
    return torch.cat(out, dim=2)


def block(W, name, x, n_heads, eps, nm, rope=None, qk_norm=False):
    """A pre-norm LayerScale block over x [B, N, C]."""
    b, n, c = x.shape
    qkv = linear(W, name + ".attn.qkv", layer_norm(W, name + ".norm1", x,
                                                     eps), nm)
    q, k, v = qkv.reshape(b, n, 3, n_heads, c // n_heads).permute(
        2, 0, 3, 1, 4)
    if qk_norm:
        q = layer_norm(W, name + ".attn.q_norm", q, eps)
        k = layer_norm(W, name + ".attn.k_norm", k, eps)
    if rope is not None:
        q, k = apply_rope(q, *rope), apply_rope(k, *rope)
    o = attention(q, k, v, nm).transpose(1, 2).reshape(b, n, c)
    x = x + W[name + ".ls1.gamma"].to(x.dtype) * linear(
        W, name + ".attn.proj", o, nm)
    h = mlp(W, name + ".mlp", layer_norm(W, name + ".norm2", x, eps), nm)
    return x + W[name + ".ls2.gamma"].to(x.dtype) * h


# ---------------------------------------------------------------------------
# Aggregator
# ---------------------------------------------------------------------------

def tower(W, enc: dict, imgs, nm: Numerics):
    """imgs [S, H, W, 3] normalised -> patch tokens [S, hp * wp, D]."""
    s, h, w, _ = imgs.shape
    p, d = enc["patch_size"], enc["embed_dim"]
    pre = "aggregator.patch_embed."
    hp, wp = h // p, w // p
    patches = imgs.reshape(s, hp, p, wp, p, 3).permute(0, 1, 3, 5, 2, 4)
    x = nm.mm(patches.reshape(s, hp * wp, 3 * p * p),
              W[pre + "patch_embed.proj.weight"].reshape(d, -1).t())
    x = x + W[pre + "patch_embed.proj.bias"]
    pe = W[pre + "pos_embed"]
    m = int(round(math.sqrt(pe.shape[1] - 1)))
    patch_pe = pe[:, 1:]
    if (hp, wp) != (m, m):
        grid = patch_pe.reshape(1, m, m, d).permute(0, 3, 1, 2)
        patch_pe = F.interpolate(grid, size=(hp, wp), mode="bicubic",
                                 antialias=True).permute(0, 2, 3, 1)
        patch_pe = patch_pe.reshape(1, hp * wp, d)
    x = torch.cat([W[pre + "cls_token"].expand(s, -1, -1), x], dim=1)
    x = x + torch.cat([pe[:, :1], patch_pe], dim=1)
    x = torch.cat([x[:, :1], W[pre + "register_tokens"].expand(s, -1, -1),
                   x[:, 1:]], dim=1)
    for i in range(enc["depth"]):
        x = block(W, f"{pre}blocks.{i}", x, enc["num_heads"], enc["ln_eps"],
                  nm)
    x = layer_norm(W, pre + "norm", x, enc["ln_eps"])
    return x[:, 1 + enc["num_register_tokens"]:]


def positions(hp: int, wp: int, n_special: int, device):
    ys, xs = torch.meshgrid(torch.arange(hp, device=device),
                            torch.arange(wp, device=device), indexing="ij")
    grid = torch.stack([ys, xs], dim=-1).reshape(-1, 2) + 1
    return torch.cat([torch.zeros(n_special, 2, dtype=grid.dtype,
                                  device=device), grid])


def aggregator(W, cfg: dict, imgs, nm: Numerics = REFERENCE,
               fault: Optional[str] = None) -> Dict[int, torch.Tensor]:
    """imgs [S, H, W, 3] in [0, 1] -> {iteration: [S, P, 2 D]} for the
    iterations the heads read. ``fault`` (the rehearsals' faults):
    "first_frame" gives frame 0 the others' camera and register tokens,
    "frame_only_global" restricts global attention to each frame."""
    enc, dec = cfg["encoder"], cfg["decoder"]
    s, h, w, _ = imgs.shape
    p = enc["patch_size"]
    mean = torch.tensor(MEAN, device=imgs.device)
    std = torch.tensor(STD, device=imgs.device)
    x = tower(W, enc, (imgs - mean) / std, nm)
    idx = [0 if (j == 0 and fault != "first_frame") else 1 for j in range(s)]
    cam = W["aggregator.camera_token"][0, idx]
    reg = W["aggregator.register_token"][0, idx]
    x = torch.cat([cam, reg, x], dim=1)
    n_special = 1 + enc["num_register_tokens"]
    pos = positions(h // p, w // p, n_special, imgs.device)
    d, heads = dec["embed_dim"], dec["num_heads"]
    rope = rope_tables(pos, d // heads, dec["rope_base"])
    glob_rope = tuple(t.repeat(s, 1, 1) for t in rope)
    keep = set(cfg["dpt_head"]["layers"]) | {dec["depth"] - 1}
    n = x.shape[1]
    out = {}
    for i in range(dec["depth"]):
        x = block(W, f"aggregator.frame_blocks.{i}", x, heads,
                  dec["ln_eps"], nm, rope, qk_norm=True)
        frame = x
        if fault == "frame_only_global":
            x = block(W, f"aggregator.global_blocks.{i}", x, heads,
                      dec["ln_eps"], nm, rope, qk_norm=True)
        else:
            x = block(W, f"aggregator.global_blocks.{i}",
                      x.reshape(1, s * n, d), heads, dec["ln_eps"], nm,
                      glob_rope, qk_norm=True).reshape(s, n, d)
        if i in keep:
            out[i] = torch.cat([frame, x], dim=-1)
    return out


# ---------------------------------------------------------------------------
# Heads
# ---------------------------------------------------------------------------

def _dt(nm: Numerics):
    return getattr(torch, nm.heads_dtype)


def camera_head(W, cfg: dict, tokens, nm: Numerics = REFERENCE):
    """tokens [S, P, 2 D] of the last iteration -> pose encoding [S, 9]."""
    cam, eps = cfg["camera_head"], cfg["decoder"]["ln_eps"]
    dt = _dt(nm)
    pre = "camera_head."
    t = layer_norm(W, pre + "token_norm", tokens[:, 0].to(dt), eps)[None]
    pose = None
    for _ in range(cam["iterations"]):
        src = W[pre + "empty_pose_tokens"].to(dt).expand(1, t.shape[1], -1) \
            if pose is None else pose
        e = linear(W, pre + "embed_pose", src)
        shift, scale, gate = linear(W, pre + "poseLN_modulation.1",
                                    F.silu(e)).chunk(3, dim=-1)
        u = F.layer_norm(t, (t.shape[-1],), eps=cam["adaln_eps"])
        u = gate * (u * (1 + scale) + shift) + t
        for i in range(cam["trunk_depth"]):
            u = block(W, f"{pre}trunk.{i}", u, cam["num_heads"], eps, FP32)
        delta = mlp(W, pre + "pose_branch",
                    layer_norm(W, pre + "trunk_norm", u, eps))
        pose = delta if pose is None else pose + delta
    pose = pose[0].float()
    return torch.cat([pose[:, :7], F.relu(pose[:, 7:])], dim=-1)


def uv_embedding(c: int, hp: int, wp: int, aspect: float, device):
    """[1, C, hp, wp]: x and y of the grid (spanning the aspect, unit
    diagonal, pixel centres), each as C/2 channels of sin then cos at
    frequencies 100^(-k / (C / 4)), times 0.1."""
    diag = (aspect ** 2 + 1.0) ** 0.5
    sx, sy = aspect / diag, 1.0 / diag
    xs = torch.linspace(-sx * (wp - 1) / wp, sx * (wp - 1) / wp, wp,
                        device=device)
    ys = torch.linspace(-sy * (hp - 1) / hp, sy * (hp - 1) / hp, hp,
                        device=device)
    uu, vv = torch.meshgrid(xs, ys, indexing="xy")            # [hp, wp]
    omega = torch.arange(c // 4, dtype=torch.float64, device=device)
    omega = 1.0 / 100.0 ** (omega / (c / 4.0))

    def emb(t):
        a = t.reshape(-1).double()[:, None] * omega[None]
        return torch.cat([a.sin(), a.cos()], dim=1)
    e = torch.cat([emb(uu), emb(vv)], dim=1).float().reshape(hp, wp, c)
    return 0.1 * e.permute(2, 0, 1)[None]


def conv(W, name, x, **kw):
    b = W.get(name + ".bias")
    return F.conv2d(x, W[name + ".weight"].to(x.dtype),
                    None if b is None else b.to(x.dtype), **kw)


def rcu(W, name, x):
    x = F.relu(x)
    return x + conv(W, name + ".conv2",
                    F.relu(conv(W, name + ".conv1", x, padding=1)),
                    padding=1)


def fuse(W, name, path, skip, size=None):
    out = path if skip is None else path + rcu(W, name + ".resConfUnit1",
                                               skip)
    out = rcu(W, name + ".resConfUnit2", out)
    if size is None:
        size = (out.shape[2] * 2, out.shape[3] * 2)
    out = F.interpolate(out, size=tuple(size), mode="bilinear",
                        align_corners=True)
    return conv(W, name + ".out_conv", out)


def dpt_head(W, cfg: dict, name: str, layers: List[torch.Tensor], hw,
             nm: Numerics = REFERENCE):
    """The raw map [s, C, H, W] of one DPT head for the frames of
    ``layers`` (each [s, P, 2 D])."""
    dt = _dt(nm)
    h, w = hw
    p = cfg["encoder"]["patch_size"]
    hp, wp = h // p, w // p
    ns = 1 + cfg["encoder"]["num_register_tokens"]
    eps = cfg["decoder"]["ln_eps"]
    pre = name + "."
    aspect = w / h
    feats = []
    for i, t in enumerate(layers):
        x = layer_norm(W, pre + "norm", t[:, ns:].to(dt), eps)
        x = x.transpose(1, 2).reshape(x.shape[0], -1, hp, wp)
        x = conv(W, f"{pre}projects.{i}", x)
        x = x + uv_embedding(x.shape[1], hp, wp, aspect, x.device).to(dt)
        r = f"{pre}resize_layers.{i}"
        if i < 2:
            x = F.conv_transpose2d(x, W[r + ".weight"].to(dt),
                                   W[r + ".bias"].to(dt), stride=4 - 2 * i)
        elif i == 3:
            x = conv(W, r, x, stride=2, padding=1)
        feats.append(x)
    l1, l2, l3, l4 = (conv(W, f"{pre}scratch.layer{i + 1}_rn", x, padding=1)
                      for i, x in enumerate(feats))
    out = fuse(W, pre + "scratch.refinenet4", l4, None, l3.shape[2:])
    out = fuse(W, pre + "scratch.refinenet3", out, l3, l2.shape[2:])
    out = fuse(W, pre + "scratch.refinenet2", out, l2, l1.shape[2:])
    out = fuse(W, pre + "scratch.refinenet1", out, l1)
    out = conv(W, pre + "scratch.output_conv1", out, padding=1)
    out = F.interpolate(out, size=(h, w), mode="bilinear",
                        align_corners=True)
    out = out + uv_embedding(out.shape[1], h, w, aspect, out.device).to(dt)
    out = F.relu(conv(W, pre + "scratch.output_conv2.0", out, padding=1))
    return conv(W, pre + "scratch.output_conv2.2", out).float()


def heads(W, cfg: dict, layers: Dict[int, torch.Tensor], hw,
          nm: Numerics = REFERENCE) -> dict:
    """The outputs of the camera head and both DPT heads from the kept
    iterations."""
    dec, dpt = cfg["decoder"], cfg["dpt_head"]
    out = {"pose_enc": camera_head(W, cfg, layers[dec["depth"] - 1], nm)}
    toks = [layers[i] for i in dpt["layers"]]
    s = toks[0].shape[0]
    for name, key in (("depth_head", "depth"), ("point_head",
                                                 "world_points")):
        preds, confs = [], []
        for c0 in range(0, s, FRAMES_CHUNK):
            raw = dpt_head(W, cfg, name, [t[c0:c0 + FRAMES_CHUNK]
                                          for t in toks], hw, nm)
            raw = raw.permute(0, 2, 3, 1)
            x = raw[..., :-1]
            preds.append(torch.exp(x) if key == "depth"
                         else torch.sign(x) * torch.expm1(x.abs()))
            confs.append(1.0 + torch.exp(raw[..., -1]))
        out[key], out[key + "_conf"] = torch.cat(preds), torch.cat(confs)
    return out


def cameras(pose_enc, hw, dtype: str = "float32") -> dict:
    """The cameras of pose encodings [S, 9] as the published
    ``pose_encoding_to_extri_intri`` reads them, computed in ``dtype``:
    the extrinsic [R | T] (the camera from the world) with R from the
    quaternion (x, y, z, w: the scalar last; 2 / |q|^2 in place of a
    normalisation, as its ``quat_to_mat``), inverted in closed form to c2w
    [S, 4, 4]; focal [S, 2] = (f_x, f_y) = ((W / 2) / tan(FoV_w / 2),
    (H / 2) / tan(FoV_h / 2)). Both float32."""
    p = pose_enc.to(getattr(torch, dtype))
    t, q = p[:, :3], p[:, 3:7]
    i, j, k, r = q.unbind(-1)
    two_s = 2.0 / (q * q).sum(-1)
    rot = torch.stack([
        1 - two_s * (j * j + k * k), two_s * (i * j - k * r),
        two_s * (i * k + j * r),
        two_s * (i * j + k * r), 1 - two_s * (i * i + k * k),
        two_s * (j * k - i * r),
        two_s * (i * k - j * r), two_s * (j * k + i * r),
        1 - two_s * (i * i + j * j)], dim=-1).reshape(-1, 3, 3)
    c2w = torch.zeros(p.shape[0], 4, 4, dtype=p.dtype, device=p.device)
    c2w[:, :3, :3] = rot.transpose(1, 2)
    c2w[:, :3, 3] = -(rot.transpose(1, 2) @ t[:, :, None])[:, :, 0]
    c2w[:, 3, 3] = 1.0
    h, w = hw
    focal = torch.stack([(w / 2.0) / torch.tan(p[:, 8] / 2.0),
                         (h / 2.0) / torch.tan(p[:, 7] / 2.0)], dim=-1)
    return {"c2w": c2w.float(), "focal": focal.float()}


def forward(W, cfg: dict, imgs, nm: Numerics = REFERENCE,
            fault: Optional[str] = None, return_layers: bool = False):
    """imgs [S, H, W, 3] in [0, 1] -> depth [S, H, W, 1], depth_conf,
    world_points [S, H, W, 3], world_points_conf, pose_enc [S, 9]."""
    layers = aggregator(W, cfg, imgs.float(), nm, fault)
    out = heads(W, cfg, layers, tuple(imgs.shape[1:3]), nm)
    if return_layers:
        out["layers"] = layers
    return out
