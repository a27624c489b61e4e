"""VGGT of the port (Wang et al., CVPR 2025, arXiv:2503.11651;
github.com/facebookresearch/vggt): S frames in, depth, world points, their
confidences and a camera per frame out, in one pass.

* The tower (``aggregator.patch_embed``): DINOv2 ViT-L/14 with 4 register
  tokens, run on each frame alone. Its position embedding, learned on a
  square grid, is resized bicubically with antialias to the frame's patch
  grid, once per shape.
* The aggregator: each frame is [camera, registers, patches]; frame 0
  takes camera and register tokens of its own (index 0), the others share
  index 1. Each of ``depth`` iterations runs a frame block (attention
  within each frame) and then a global block (attention over every token
  of the scene); both have QK-LayerNorm, LayerScale and 2D RoPE of base
  100 at positions (0, 0) for the special tokens and (row + 1, col + 1)
  for the patches. Iteration i yields concat(frame_i, global_i) along
  channels; only the iterations the heads read are kept.
* The camera head: a 2048-wide trunk of LayerScale blocks over the scene's
  camera tokens, run ``camera_iterations`` times, each time modulated
  (adaLN: shift, scale, gate) by an embedding of the pose so far, adding a
  correction to the 9-number pose encoding [T, quaternion, FoV_h, FoV_w].
* Two DPT heads (depth: 2 channels, world points: 4): the patch tokens of
  four iterations, LayerNorm, 1x1 projections, a sine-cosine position
  embedding, resizing to four scales, fusion with residual conv units from
  the coarsest up, then convolutions to full resolution.

Modules here hold parameters under the published state-dict key names
(``aggregator.frame_blocks.0.attn.q_norm.weight`` ...); the forwards are
plain functions, as in the rest of the port.

Precision: the aggregator (its tower included) computes its products and
attention in ``dtype`` (bf16 on the card: the matrices are cast once, the
attention is K1) with fp32 LayerNorm statistics, fp32 RoPE, and an fp32
residual stream to which LayerScale adds in fp32; the iterations kept for
the heads are fp32. The heads compute in fp32: matmuls in full fp32,
convolutions as cuDNN takes them with TF32 allowed (PyTorch's default for
convolutions). The camera trunk's attention (head dim 128, which K1 does
not take; one token a frame, 64 a scene) is the plain attention of
``ops/attention.py`` (``impl="plain"``) in fp32; K1 is never asked there.

Where the published forward's ReLU is in place (the DPT fusion blocks),
the residual conv unit's skip carries relu(x), as it does there.
"""

from __future__ import annotations

import contextlib
import math
from types import SimpleNamespace
from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.profiler import record_function

from must3r_tpu_torch.config import VGGTConfig
from must3r_tpu_torch.models.layers import (EncoderBlock, Mlp,
                                            encoder_block, layer_norm,
                                            linear, mlp)
from must3r_tpu_torch.ops.patch import (patchify_image,
                                        positions_with_special_tokens)
from must3r_tpu_torch.ops.rope import make_rope_tables

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
POSE_DIM = 9                 # T (3), quaternion (4, scalar last), FoV h, w
ADALN_EPS = 1e-6
DPT_POS_SCALE = 0.1
DPT_HIDDEN = 32              # channels before the last 1x1 convolution

# work run since the last reset_vggt_counts(): frames through the model,
# tokens through global attention (summed over its layers), DPT chunks
_counts = {"frames": 0, "global_tokens": 0, "dpt_chunks": 0}


def vggt_counts() -> dict:
    return dict(_counts)


def reset_vggt_counts():
    for k in _counts:
        _counts[k] = 0


# ---------------------------------------------------------------------------
# Parameter holders (published key names)
# ---------------------------------------------------------------------------

class DinoTower(nn.Module):
    """DINOv2 ViT with registers (``aggregator.patch_embed``)."""

    def __init__(self, cfg: VGGTConfig):
        super().__init__()
        d, p = cfg.embed_dim, cfg.patch_size
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(3, d, p, stride=p)
        self.cls_token = nn.Parameter(torch.empty(1, 1, d))
        self.pos_embed = nn.Parameter(
            torch.empty(1, 1 + (cfg.img_size // p) ** 2, d))
        self.register_tokens = nn.Parameter(
            torch.empty(1, cfg.num_register_tokens, d))
        self.mask_token = nn.Parameter(torch.empty(1, d))     # unused
        self.blocks = nn.ModuleList(
            EncoderBlock(d, cfg.mlp_ratio, cfg.tower_ln_eps, layer_scale=True)
            for _ in range(cfg.tower_depth))
        self.norm = nn.LayerNorm(d, eps=cfg.tower_ln_eps)


class Aggregator(nn.Module):
    def __init__(self, cfg: VGGTConfig):
        super().__init__()
        d = cfg.embed_dim
        self.patch_embed = DinoTower(cfg)

        def blocks():
            return nn.ModuleList(
                EncoderBlock(d, cfg.mlp_ratio, cfg.ln_eps, layer_scale=True,
                             qk_norm=True, num_heads=cfg.num_heads,
                             qk_eps=cfg.ln_eps)
                for _ in range(cfg.depth))
        self.frame_blocks = blocks()
        self.global_blocks = blocks()
        # index 0: the first frame's; index 1: every other frame's
        self.camera_token = nn.Parameter(torch.empty(1, 2, 1, d))
        self.register_token = nn.Parameter(
            torch.empty(1, 2, cfg.num_register_tokens, d))


class CameraHead(nn.Module):
    def __init__(self, cfg: VGGTConfig):
        super().__init__()
        c = cfg.camera_dim
        self.trunk = nn.Sequential(*(
            EncoderBlock(c, cfg.mlp_ratio, cfg.ln_eps, layer_scale=True)
            for _ in range(cfg.camera_trunk_depth)))
        self.token_norm = nn.LayerNorm(c, eps=cfg.ln_eps)
        self.trunk_norm = nn.LayerNorm(c, eps=cfg.ln_eps)
        self.empty_pose_tokens = nn.Parameter(torch.empty(1, 1, POSE_DIM))
        self.embed_pose = nn.Linear(POSE_DIM, c)
        self.poseLN_modulation = nn.Sequential(nn.SiLU(),
                                               nn.Linear(c, 3 * c))
        self.pose_branch = Mlp(c, c // 2, POSE_DIM)


class ResidualConvUnit(nn.Module):
    def __init__(self, f: int):
        super().__init__()
        self.conv1 = nn.Conv2d(f, f, 3, padding=1)
        self.conv2 = nn.Conv2d(f, f, 3, padding=1)


class FusionBlock(nn.Module):
    def __init__(self, f: int, has_residual: bool = True):
        super().__init__()
        self.out_conv = nn.Conv2d(f, f, 1)
        if has_residual:
            self.resConfUnit1 = ResidualConvUnit(f)
        self.resConfUnit2 = ResidualConvUnit(f)


class DPTHead(nn.Module):
    def __init__(self, cfg: VGGTConfig, out_channels: int):
        super().__init__()
        c, f, oc = cfg.camera_dim, cfg.dpt_features, cfg.dpt_out_channels
        self.norm = nn.LayerNorm(c, eps=cfg.ln_eps)
        self.projects = nn.ModuleList(nn.Conv2d(c, o, 1) for o in oc)
        self.resize_layers = nn.ModuleList([
            nn.ConvTranspose2d(oc[0], oc[0], 4, stride=4),
            nn.ConvTranspose2d(oc[1], oc[1], 2, stride=2),
            nn.Identity(),
            nn.Conv2d(oc[3], oc[3], 3, stride=2, padding=1)])
        self.scratch = nn.Module()
        for i, o in enumerate(oc):
            setattr(self.scratch, f"layer{i + 1}_rn",
                    nn.Conv2d(o, f, 3, padding=1, bias=False))
            setattr(self.scratch, f"refinenet{i + 1}",
                    FusionBlock(f, has_residual=i < 3))
        self.scratch.output_conv1 = nn.Conv2d(f, f // 2, 3, padding=1)
        self.scratch.output_conv2 = nn.Sequential(
            nn.Conv2d(f // 2, DPT_HIDDEN, 3, padding=1), nn.ReLU(),
            nn.Conv2d(DPT_HIDDEN, out_channels, 1))


class VGGT(nn.Module):
    """The whole model; ``cfg`` is kept on it."""

    def __init__(self, cfg: VGGTConfig):
        super().__init__()
        self.cfg = cfg
        self.aggregator = Aggregator(cfg)
        self.camera_head = CameraHead(cfg)
        self.depth_head = DPTHead(cfg, 2)
        self.point_head = DPTHead(cfg, 4)


def init_vggt_(model: VGGT, generator: torch.Generator) -> VGGT:
    """Random weights in place from ``generator`` (on the model's device):
    xavier-uniform matrices and kernels, zero biases, unit LayerNorms,
    LayerScale at its init (1.0 in the tower, 0.01 elsewhere), the
    embeddings and tokens uniform in +-0.02."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "gamma":
                p.fill_(1.0 if ".patch_embed.blocks." in name else 0.01)
            elif leaf == "bias":
                p.zero_()
            elif p.dim() == 1:
                p.fill_(1.0)
            elif leaf == "weight":
                fan_out, fan_in = p.shape[0], p[0].numel()
                bound = math.sqrt(6.0 / (fan_in + fan_out))
                p.uniform_(-bound, bound, generator=generator)
            else:
                p.uniform_(-0.02, 0.02, generator=generator)
    return model


# ---------------------------------------------------------------------------
# Aggregator
# ---------------------------------------------------------------------------

def resized_pos_embed(tower: DinoTower, hp: int, wp: int) -> torch.Tensor:
    """The tower's position embedding for a grid of hp x wp patches, fp32
    [1, 1 + hp * wp, D]: the patch part bicubic-resized with antialias
    from its learned square (unchanged at that square); the last shape's
    is kept on the module, made again only when the shape or the weights
    change."""
    cache = tower.__dict__.setdefault("_pos_cache", {})
    pe = tower.pos_embed
    key = (hp, wp, pe.device, pe._version, pe.data_ptr())
    if key not in cache:
        pe32 = pe.detach().float()
        d = pe32.shape[-1]
        m = math.isqrt(pe32.shape[1] - 1)
        patch = pe32[:, 1:]
        if (hp, wp) != (m, m):
            grid = patch.reshape(1, m, m, d).permute(0, 3, 1, 2)
            grid = F.interpolate(grid, size=(hp, wp), mode="bicubic",
                                 antialias=True)
            patch = grid.permute(0, 2, 3, 1).reshape(1, hp * wp, d)
        cache.clear()
        cache[key] = torch.cat([pe32[:, :1], patch], dim=1)
    return cache[key]


def tower_forward(tower: DinoTower, cfg: VGGTConfig, imgs: torch.Tensor,
                  dtype=torch.bfloat16, impl=None) -> torch.Tensor:
    """imgs [S, H, W, 3] normalised -> the patch tokens after the final
    LayerNorm, fp32 [S, hp * wp, D]. The patch embedding is a product over
    unfolded patches (the conv weight flattened in (c, i, j) order). The
    span ``vggt.patch_embed`` is the whole tower, the module of that name
    in the published model."""
    s, h, w, _ = imgs.shape
    p, d = cfg.patch_size, cfg.embed_dim
    proj = tower.patch_embed.proj
    with record_function("vggt.patch_embed"):
        x = linear(SimpleNamespace(weight=proj.weight.reshape(d, -1),
                                   bias=proj.bias),
                   patchify_image(imgs.float(), p).to(dtype)).float()
        x = torch.cat([tower.cls_token.float().expand(s, -1, -1), x], dim=1)
        x = x + resized_pos_embed(tower, h // p, w // p)
        x = torch.cat([x[:, :1], tower.register_tokens.float().expand(
            s, -1, -1), x[:, 1:]], dim=1)
        for blk in tower.blocks:
            x = encoder_block(blk, x, None, cfg.num_heads, impl=impl,
                              dtype=dtype)
        return layer_norm(tower.norm, x)[:, 1 + cfg.num_register_tokens:]


def global_block(p: EncoderBlock, x: torch.Tensor, rope, num_heads: int,
                 impl=None, dtype=None) -> torch.Tensor:
    """A block over every token of the scene: x [S, P, D] as one sequence
    of S * P tokens; rope: the frame's tables tiled S times, [1, S * P,
    ...]. The norms, products and MLP act per token, so only the attention
    sees the scene as one."""
    s, n, d = x.shape
    return encoder_block(p, x.reshape(1, s * n, d), rope, num_heads,
                         impl=impl, dtype=dtype).reshape(s, n, d)


def aggregator_forward(agg: Aggregator, cfg: VGGTConfig, imgs: torch.Tensor,
                       dtype=torch.bfloat16, impl=None
                       ) -> Dict[int, torch.Tensor]:
    """imgs [S, H, W, 3] in [0, 1] -> {iteration: fp32 [S, P, 2 D]} for
    the iterations the heads read, P = the special tokens and the patches
    of a frame."""
    s, h, w, _ = imgs.shape
    p = cfg.patch_size
    keep = set(cfg.dpt_layers) | {cfg.depth - 1}
    mean = torch.tensor(IMAGENET_MEAN, device=imgs.device)
    std = torch.tensor(IMAGENET_STD, device=imgs.device)
    patches = tower_forward(agg.patch_embed, cfg, (imgs.float() - mean) / std,
                            dtype, impl)
    idx = torch.ones(s, dtype=torch.long, device=imgs.device)
    idx[0] = 0
    special = torch.cat([agg.camera_token[0].index_select(0, idx),
                         agg.register_token[0].index_select(0, idx)], dim=1)
    x = torch.cat([special.float(), patches], dim=1)
    pos = positions_with_special_tokens(h // p, w // p, cfg.n_special,
                                        imgs.device)
    rope = make_rope_tables(pos[None], cfg.head_dim, base=cfg.rope.base,
                            f0=cfg.rope.f0)
    rope_scene = tuple(t.repeat(1, s, 1, 1) for t in rope)
    out = {}
    for i in range(cfg.depth):
        with record_function("vggt.frame_attn"):
            x = encoder_block(agg.frame_blocks[i], x, rope, cfg.num_heads,
                              impl=impl, dtype=dtype)
        frame = x
        with record_function("vggt.global_attn"):
            x = global_block(agg.global_blocks[i], x, rope_scene,
                             cfg.num_heads, impl, dtype)
        _counts["global_tokens"] += x.shape[0] * x.shape[1]
        if i in keep:
            out[i] = torch.cat([frame, x], dim=-1)
    _counts["frames"] += s
    return out


# ---------------------------------------------------------------------------
# Camera head
# ---------------------------------------------------------------------------

def _trunk_block(p: EncoderBlock, x: torch.Tensor,
                 num_heads: int) -> torch.Tensor:
    """A LayerScale block without RoPE or QK-norm in fp32, its attention
    the plain version (head dim 128). x: [B, N, C]."""
    return encoder_block(p, x, None, num_heads, impl="plain")


def activate_pose(enc: torch.Tensor) -> torch.Tensor:
    """Translation and quaternion as they are, ReLU on the fields of
    view."""
    return torch.cat([enc[..., :7], F.relu(enc[..., 7:])], dim=-1)


def camera_head_forward(head: CameraHead, cfg: VGGTConfig,
                        tokens: torch.Tensor) -> torch.Tensor:
    """tokens: the last iteration's [S, P, 2 D] -> the pose encoding of
    each frame, fp32 [S, 9]. Each refinement embeds the pose so far (the
    learned empty pose at first), modulates the normalised camera tokens
    by it, runs the trunk and adds the pose branch's correction."""
    with record_function("vggt.camera_head"):
        t = layer_norm(head.token_norm, tokens[:, 0].float())[None]
        c = t.shape[-1]
        modulation = head.poseLN_modulation[1]
        pose = None
        for _ in range(cfg.camera_iterations):
            e = linear(head.embed_pose,
                       head.empty_pose_tokens.float().expand(*t.shape[:2], -1)
                       if pose is None else pose)
            shift, scale, gate = linear(modulation, F.silu(e)).chunk(3, -1)
            u = F.layer_norm(t, (c,), eps=ADALN_EPS)
            u = gate * (u * (1 + scale) + shift) + t
            for blk in head.trunk:
                u = _trunk_block(blk, u, cfg.camera_num_heads)
            delta = mlp(head.pose_branch, layer_norm(head.trunk_norm, u))
            pose = delta if pose is None else pose + delta
        return activate_pose(pose[0])


# ---------------------------------------------------------------------------
# DPT heads
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _convolutions_in_tf32():
    """cuDNN may take fp32 convolutions in TF32, PyTorch's default,
    whatever the process set before (the MUSt3R path turns it off)."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def uv_embedding(channels: int, hp: int, wp: int, aspect: float,
                 device) -> torch.Tensor:
    """The DPT heads' position embedding of an hp x wp grid, fp32 [1, C,
    hp, wp] (times 0.1): the grid spans the image's aspect, normalised to
    a unit diagonal, at pixel centres; each of x and y takes C/2 channels
    of sin then cos at frequencies 100^(-k / (C/4))."""
    diag = math.sqrt(aspect ** 2 + 1.0)
    sx, sy = aspect / diag, 1.0 / diag
    xs = torch.linspace(-sx * (wp - 1) / wp, sx * (wp - 1) / wp, wp,
                        device=device)
    ys = torch.linspace(-sy * (hp - 1) / hp, sy * (hp - 1) / hp, hp,
                        device=device)
    omega = 1.0 / 100.0 ** (torch.arange(channels // 4, dtype=torch.float64,
                                         device=device) / (channels / 4))

    def sincos(t):
        a = t.double()[:, None] * omega
        return torch.cat([a.sin(), a.cos()], dim=-1)
    emb = torch.cat([sincos(xs)[None, :, :].expand(hp, -1, -1),
                     sincos(ys)[:, None, :].expand(-1, wp, -1)], dim=-1)
    return (DPT_POS_SCALE * emb).float().permute(2, 0, 1)[None]


_uv_cache: Dict[tuple, torch.Tensor] = {}


def _uv(x: torch.Tensor, aspect: float) -> torch.Tensor:
    """:func:`uv_embedding` for x [s, C, h, w], made once per shape."""
    key = (*x.shape[1:], aspect, x.device)
    if key not in _uv_cache:
        _uv_cache[key] = uv_embedding(*x.shape[1:], aspect, x.device)
    return _uv_cache[key]


def _conv(m, x, **kw):
    return F.conv2d(x, m.weight.float(), None if m.bias is None
                    else m.bias.float(), **kw)


def _rcu(p: ResidualConvUnit, x: torch.Tensor) -> torch.Tensor:
    x = F.relu(x)
    return x + _conv(p.conv2, F.relu(_conv(p.conv1, x, padding=1)),
                     padding=1)


def _fuse(p: FusionBlock, path, skip, size=None) -> torch.Tensor:
    out = path if skip is None else path + _rcu(p.resConfUnit1, skip)
    out = _rcu(p.resConfUnit2, out)
    out = F.interpolate(out, size=size, scale_factor=None if size else 2,
                        mode="bilinear", align_corners=True)
    return _conv(p.out_conv, out)


def _dpt_chunk(head: DPTHead, cfg: VGGTConfig, layers, hw) -> torch.Tensor:
    """The raw map [s, C, H, W] of a chunk of frames from its layers'
    tokens (each [s, P, 2 D])."""
    h, w = hw
    hp, wp = h // cfg.patch_size, w // cfg.patch_size
    aspect = w / h
    feats = []
    for i, t in enumerate(layers):
        x = layer_norm(head.norm, t[:, cfg.n_special:].float())
        x = x.transpose(1, 2).reshape(x.shape[0], -1, hp, wp)
        x = _conv(head.projects[i], x)
        x = x + _uv(x, aspect)
        r = head.resize_layers[i]
        if i < 2:
            x = F.conv_transpose2d(x, r.weight.float(), r.bias.float(),
                                   stride=r.stride)
        elif i == 3:
            x = _conv(r, x, stride=2, padding=1)
        feats.append(x)
    sc = head.scratch
    l1, l2, l3, l4 = (_conv(getattr(sc, f"layer{i + 1}_rn"), x, padding=1)
                      for i, x in enumerate(feats))
    out = _fuse(sc.refinenet4, l4, None, l3.shape[2:])
    out = _fuse(sc.refinenet3, out, l3, l2.shape[2:])
    out = _fuse(sc.refinenet2, out, l2, l1.shape[2:])
    out = _fuse(sc.refinenet1, out, l1)
    out = _conv(sc.output_conv1, out, padding=1)
    out = F.interpolate(out, size=(h, w), mode="bilinear",
                        align_corners=True)
    out = out + _uv(out, aspect)
    conv2 = sc.output_conv2
    out = F.relu(_conv(conv2[0], out, padding=1))
    return _conv(conv2[2], out)


def dpt_head_forward(head: DPTHead, cfg: VGGTConfig,
                     layers: Dict[int, torch.Tensor], hw, points: bool):
    """(prediction [S, H, W, C - 1], confidence [S, H, W]), fp32, over
    chunks of ``cfg.dpt_frames_chunk`` frames: world points
    (``points``: sign(x) expm1(|x|)) or depth (exp(x)); confidence
    1 + exp(c)."""
    toks = [layers[i] for i in cfg.dpt_layers]
    s = toks[0].shape[0]
    pred = conf = None
    with _convolutions_in_tf32():
        for c0 in range(0, s, cfg.dpt_frames_chunk):
            c1 = min(c0 + cfg.dpt_frames_chunk, s)
            raw = _dpt_chunk(head, cfg, [t[c0:c1] for t in toks], hw)
            raw = raw.permute(0, 2, 3, 1)
            if pred is None:
                pred = raw.new_empty((s, *raw.shape[1:-1],
                                      raw.shape[-1] - 1))
                conf = raw.new_empty((s, *raw.shape[1:-1]))
            x = raw[..., :-1]
            pred[c0:c1] = (torch.sign(x) * torch.expm1(x.abs()) if points
                           else torch.exp(x))
            conf[c0:c1] = 1.0 + torch.exp(raw[..., -1])
            _counts["dpt_chunks"] += 1
    return pred, conf


# ---------------------------------------------------------------------------
# The whole model
# ---------------------------------------------------------------------------

def heads_forward(model: VGGT, layers: Dict[int, torch.Tensor], hw) -> dict:
    """The camera head and both DPT heads on the kept iterations."""
    cfg = model.cfg
    out = {"pose_enc": camera_head_forward(model.camera_head, cfg,
                                           layers[cfg.depth - 1])}
    with record_function("vggt.depth_head"):
        out["depth"], out["depth_conf"] = dpt_head_forward(
            model.depth_head, cfg, layers, hw, points=False)
    with record_function("vggt.point_head"):
        out["world_points"], out["world_points_conf"] = dpt_head_forward(
            model.point_head, cfg, layers, hw, points=True)
    return out


def vggt_forward(model: VGGT, imgs: torch.Tensor, dtype=torch.bfloat16,
                 return_layers: bool = False, impl=None) -> dict:
    """imgs [S, H, W, 3] in [0, 1] (H, W multiples of the patch) -> depth
    [S, H, W, 1], depth_conf [S, H, W], world_points [S, H, W, 3],
    world_points_conf [S, H, W], pose_enc [S, 9], all fp32; with
    ``return_layers`` also the kept iterations ('layers'); ``impl``: the
    aggregator's attention (None: K1 on a card, "plain": its plain
    version)."""
    cfg = model.cfg
    if imgs.shape[1] % cfg.patch_size or imgs.shape[2] % cfg.patch_size:
        raise ValueError(f"frames of {tuple(imgs.shape[1:3])} do not tile "
                         f"into {cfg.patch_size}-pixel patches")
    layers = aggregator_forward(model.aggregator, cfg, imgs, dtype, impl)
    out = heads_forward(model, layers, tuple(imgs.shape[1:3]))
    if return_layers:
        out["layers"] = layers
    return out
