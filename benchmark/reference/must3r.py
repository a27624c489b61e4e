"""Plain MUSt3R in PyTorch: the benchmark's reference.

Written from the published description of MUSt3R (Cabon et al., CVPR 2025:
a DUSt3R / CroCo ViT encoder with 2D RoPE, a ViT decoder that reads and
writes a per-layer token memory through cross-attention, a linear head)
and from the semantics that the repository's JAX package gives it. It
imports nothing of the program under test: every tensor here is computed
from the weights and inputs that the benchmark made, in float32 with TF32
off, with plain matrix products and a dense softmax.

Weights are a dict of float32 tensors under the published state-dict key
names (``encoder.blocks_enc.0.attn.qkv.weight`` ...); ``benchmark/weights.py``
makes them.

Semantics kept (each also a property of the published model):

* encoder: patch embedding (a 16 x 16 convolution, written as a product
  over unfolded patches), pre-norm blocks (self-attention with 2D RoPE of
  base 100 on q and k, exact GELU MLP), a final LayerNorm; eps 1e-6.
* decoder step over G images: project the encoder tokens to the decoder
  width, add ``image2_embed`` to every image but the first of an empty
  memory; in each layer, the tokens entering it are written to that
  layer's memory (LayerNorm ``norm_y``, then the k and v projections)
  before the layer's cross-attention reads the memory; after the last
  layer, the feedback MLP of the last layer's entering tokens is added to
  every earlier layer's entering tokens and their memory rows are written
  again. Inference masks an image's own tokens (except a single-image
  first step); the causal training masks keep strictly earlier images,
  with image 0 of the first step attending itself and image 1.
* render: every view against the frozen memory, no image masked.
* head: LayerNorm, a linear map to 16 x 16 x 7 values a patch, pixel
  shuffle; postprocess: the norm-exp activation of both pointmaps,
  confidence 1 + exp, Weiszfeld focal (10 iterations) and a weighted
  Procrustes pose by Horn's quaternion method.

Departures, each deliberate:

* Horn's top eigenvector is taken by the JAX package's fixed scheme (the
  4 x 4 matrix shifted by its Frobenius norm, 6 normalised squarings, a
  fixed seed vector), not by an exact eigendecomposition: the pose is the
  one that scheme defines, which the program is asked to reproduce.
* A query row that every key masks does not occur on these paths; the
  softmax here would make it NaN, which fails every comparison.

``Numerics`` selects the control: the same computation with the operands
of every matrix product rounded to float8 e4m3 (a scale per row), and
optionally a token memory quantized with fewer bits.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

INF_LABEL = 2 ** 31 - 1
LN_EPS = 1e-6


def full_precision():
    """float32 products in full float32 (TF32 off for matmuls and cuDNN)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------------------
# Numerics: the reference, or the control's lower precision
# ---------------------------------------------------------------------------

def fp8_round(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per slice along ``dim``
    (the slice's largest magnitude maps to 448), back in float32. The
    gradient passes straight through."""
    s = x.detach().abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / 448.0
    q = (x.detach() / s).to(torch.float8_e4m3fn).float() * s
    return x + (q - x).detach()


def quantize_tokens(t: torch.Tensor, qmax: float) -> torch.Tensor:
    """Symmetric per-token quantization of t [..., T, Dh] to integer codes
    of largest magnitude ``qmax`` (127: int8, 7: int4), scale =
    max(amax / qmax, 1e-30), codes rounded half to even; returns codes *
    scale in float32."""
    scale = (t.abs().amax(dim=-1, keepdim=True) / qmax).clamp_min(1e-30)
    return torch.round(t / scale) * scale


@dataclass(frozen=True)
class Numerics:
    """``products``: "fp32" (the reference) or "fp8" (the control: operands
    of every product rounded to e4m3); ``memory_qmax``: None for a float
    token memory, 127 for int8 codes (the 8-bit memory), 7 for int4."""
    products: str = "fp32"
    memory_qmax: Optional[float] = None

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a [..., M, K] @ b [..., K, N]."""
        if self.products == "fp8":
            a, b = fp8_round(a, -1), fp8_round(b, -2)
        return torch.matmul(a, b)


REFERENCE = Numerics()


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def linear(W, name: str, x: torch.Tensor, nm: Numerics) -> torch.Tensor:
    y = nm.mm(x, W[name + ".weight"].t())
    b = W.get(name + ".bias")
    return y if b is None else y + b


def layer_norm(W, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), W[name + ".weight"],
                        W[name + ".bias"], LN_EPS)


def mlp(W, name: str, x, nm):
    return linear(W, name + ".fc2", F.gelu(linear(W, name + ".fc1", x, nm)),
                  nm)


def rope_tables(pos: torch.Tensor, head_dim: int, base: float):
    """CroCo's RoPE2D: each half of a head (y, then x) rotates its two
    quarters by the axis coordinate at frequencies base^(-2k / (Dh/2)).
    pos [..., N, 2] (y, x) -> (cos, sin) [..., N, 2, Dh/2]."""
    d = head_dim // 2
    inv = 1.0 / base ** (torch.arange(0, d, 2, dtype=torch.float32,
                                      device=pos.device) / d)
    ang = pos.float()[..., None] * inv                        # ..., N, 2, d/2
    ang = torch.cat([ang, ang], dim=-1)                       # ..., N, 2, d
    return ang.cos(), ang.sin()


def apply_rope(t: torch.Tensor, cos, sin) -> torch.Tensor:
    """t [B, H, N, Dh]; tables [B, N, 2, Dh/2]."""
    b, h, n, dh = t.shape
    halves = t.reshape(b, h, n, 2, dh // 2)
    c, s = cos[:, None], sin[:, None]
    x1, x2 = halves.chunk(2, dim=-1)
    rot = torch.cat([-x2, x1], dim=-1)
    return (halves * c + rot * s).reshape(b, h, n, dh)


def attention(q, k, v, nm: Numerics, allow=None) -> torch.Tensor:
    """softmax(q k^T / sqrt(Dh)) v, dense. q [..., M, Dh], k, v [..., S,
    Dh]; allow: bool broadcastable to [..., M, S] or None."""
    s = nm.mm(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if allow is not None:
        s = s.masked_fill(~allow, float("-inf"))
    return nm.mm(torch.softmax(s, dim=-1), v)


def heads(x: torch.Tensor, h: int) -> torch.Tensor:
    """[B, N, D] -> [B, H, N, Dh]."""
    b, n, d = x.shape
    return x.reshape(b, n, h, d // h).transpose(1, 2)


def merge(x: torch.Tensor) -> torch.Tensor:
    """[B, H, N, Dh] -> [B, N, D]."""
    b, h, n, dh = x.shape
    return x.transpose(1, 2).reshape(b, n, h * dh)


def self_attention(W, name: str, x, rope, n_heads: int, nm):
    """x [B, N, D]; full attention with RoPE on q and k."""
    q, k, v = linear(W, name + ".qkv", x, nm).chunk(3, dim=-1)
    q, k, v = (heads(t, n_heads) for t in (q, k, v))
    q, k = apply_rope(q, *rope), apply_rope(k, *rope)
    return linear(W, name + ".proj", merge(attention(q, k, v, nm)), nm)


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

def patch_positions(hp: int, wp: int, device) -> torch.Tensor:
    ys, xs = torch.meshgrid(torch.arange(hp, device=device),
                            torch.arange(wp, device=device), indexing="ij")
    return torch.stack([ys, xs], dim=-1).reshape(hp * wp, 2)


def encode(W, enc: dict, imgs: torch.Tensor, nm: Numerics = REFERENCE,
           chunk: int = 8) -> torch.Tensor:
    """imgs [V, H, W, 3] -> tokens [V, N, D], ``chunk`` views at a time."""
    outs = [_encode(W, enc, imgs[i:i + chunk], nm)
            for i in range(0, imgs.shape[0], chunk)]
    return torch.cat(outs)


def _encode(W, enc, imgs, nm):
    p, d, nh = enc["patch_size"], enc["embed_dim"], enc["num_heads"]
    v, h, w, _ = imgs.shape
    patches = F.unfold(imgs.permute(0, 3, 1, 2).float(), p, stride=p)
    x = nm.mm(patches.transpose(1, 2),
              W["encoder.patch_embed.proj.weight"].reshape(d, -1).t())
    x = x + W["encoder.patch_embed.proj.bias"]
    pos = patch_positions(h // p, w // p, imgs.device).expand(v, -1, -1)
    rope = rope_tables(pos, d // nh, enc["rope_base"])
    for i in range(enc["depth"]):
        pre = f"encoder.blocks_enc.{i}"
        x = x + self_attention(W, pre + ".attn",
                               layer_norm(W, pre + ".norm1", x), rope, nh, nm)
        x = x + mlp(W, pre + ".mlp", layer_norm(W, pre + ".norm2", x), nm)
    return layer_norm(W, "encoder.norm_enc", x)


# ---------------------------------------------------------------------------
# Decoder and its memory
# ---------------------------------------------------------------------------

@dataclass
class Memory:
    """Per layer, the keys and values [B, H, S, Dh] of every token written
    so far (dequantized where the memory is 8-bit), and their labels."""
    k: List[torch.Tensor]
    v: List[torch.Tensor]
    labels: torch.Tensor                      # [B, S]
    n_imgs: int = 0
    protected_imgs: int = 0
    protected_tokens: int = 0
    tokens_per_img: int = 0
    extra: Dict = field(default_factory=dict)

    @property
    def length(self) -> int:
        return self.labels.shape[1]


def empty_memory(dec: dict, batch: int, device) -> Memory:
    dh = dec["embed_dim"] // dec["num_heads"]
    z = torch.zeros(batch, dec["num_heads"], 0, dh, device=device)
    return Memory(k=[z] * dec["depth"], v=[z] * dec["depth"],
                  labels=torch.zeros(batch, 0, dtype=torch.long,
                                     device=device))


def memory_tokens(W, dec, layer: int, y: torch.Tensor, nm: Numerics):
    """Memory keys and values of tokens y [B, T, D] entering ``layer``:
    [B, H, T, Dh] each, quantized as the memory stores them."""
    pre = f"decoder.blocks_dec.{layer}"
    y = layer_norm(W, pre + ".norm_y", y)
    k = heads(linear(W, pre + ".cross_attn.projk", y, nm), dec["num_heads"])
    v = heads(linear(W, pre + ".cross_attn.projv", y, nm), dec["num_heads"])
    if nm.memory_qmax is not None:
        k, v = (quantize_tokens(t, nm.memory_qmax) for t in (k, v))
    return k, v


def _write(mem: Memory, layer: int, start: int, k, v):
    mem.k[layer] = torch.cat([mem.k[layer][:, :, :start], k], dim=2)
    mem.v[layer] = torch.cat([mem.v[layer][:, :, :start], v], dim=2)


def decoder_block(W, dec, layer: int, x, rope, mem: Memory, allow, nm):
    """x [B, G, N, D]: per-image self-attention, cross-attention to the
    layer's memory (allow [B, G, S] bool), MLP."""
    pre = f"decoder.blocks_dec.{layer}"
    b, g, n, d = x.shape
    nh = dec["num_heads"]
    xf = x.reshape(b * g, n, d)
    xf = xf + self_attention(W, pre + ".attn",
                             layer_norm(W, pre + ".norm1", xf), rope, nh, nm)
    x = xf.reshape(b, g, n, d)
    q = linear(W, pre + ".cross_attn.projq",
               layer_norm(W, pre + ".norm2", x), nm)           # B,G,N,D
    q = q.reshape(b, g * n, nh, d // nh).transpose(1, 2)        # B,H,GN,Dh
    a = allow[:, :, None, :].expand(b, g, n, allow.shape[-1])
    a = a.reshape(b, 1, g * n, allow.shape[-1])
    o = attention(q, mem.k[layer], mem.v[layer], nm, a)         # B,H,GN,Dh
    x = x + linear(W, pre + ".cross_attn.proj", merge(o), nm).reshape(
        b, g, n, d)
    return x + mlp(W, pre + ".mlp", layer_norm(W, pre + ".norm3", x), nm)


def _embed(W, x_enc, nm, first_skipped: bool):
    x = linear(W, "decoder.feat_embed_enc_to_dec", x_enc, nm)
    emb = W["decoder.image2_embed"].reshape(-1)
    g = x.shape[1]
    add = torch.ones(g, device=x.device)
    if first_skipped:
        add[0] = 0.0
    return x + emb * add[None, :, None, None]


def _update_limits(n_imgs: int, g: int, causal: bool):
    """(self label, upper label) of each of the step's g images: slots
    with the image's own label, or a label at or above the upper one, are
    masked."""
    own = [n_imgs + i for i in range(g)]
    first = n_imgs == 0
    if not causal:
        if first and g == 1:
            return [-2], [INF_LABEL]
        return own, [INF_LABEL] * g
    selfs, uppers = list(own), list(own)
    if first:
        selfs[0], uppers[0] = -2, (2 if g > 1 else INF_LABEL)
    return selfs, uppers


def decoder_update(W, dec, mem: Memory, x_enc, pos, nm: Numerics = REFERENCE,
                   causal: bool = False, drop=None, protected_limit=None):
    """One memory step over G images: x_enc [B, G, N, Denc], pos [B, G, N,
    2]; drop: optional bool [B, G, S_final] token dropout (True = blocked)
    over the slots as they stand after this step's write. Returns the final
    tokens [B, G, N, D]; ``mem`` advances."""
    b, g, n, _ = x_enc.shape
    d, nh, depth = dec["embed_dim"], dec["num_heads"], dec["depth"]
    x = _embed(W, x_enc, nm, first_skipped=mem.n_imgs == 0)
    rope = rope_tables(pos.reshape(b * g, n, 2), d // nh, dec["rope_base"])
    start = mem.length
    new = torch.arange(mem.n_imgs, mem.n_imgs + g,
                       device=x.device).repeat_interleave(n)
    mem.labels = torch.cat([mem.labels, new.expand(b, -1)], dim=1)
    selfs, uppers = _update_limits(mem.n_imgs, g, causal)
    lab = mem.labels[:, None, :]                               # B,1,S
    sel = torch.tensor(selfs, device=x.device)[None, :, None]
    upp = torch.tensor(uppers, device=x.device)[None, :, None]
    allow = (lab >= 0) & (lab != sel) & (lab < upp)            # B,G,S
    if drop is not None:
        allow = allow & ~drop[:, :, :mem.length]
    raws = []
    for layer in range(depth):
        raw = x.reshape(b, g * n, d)
        _write(mem, layer, start, *memory_tokens(W, dec, layer, raw, nm))
        x = decoder_block(W, dec, layer, x, rope, mem, allow, nm)
        raws.append(raw)
    offset = mlp(W, "decoder.feedback_layer",
                 layer_norm(W, "decoder.feedback_norm", raws[-1]), nm)
    for layer in range(depth - 1):
        _write(mem, layer, start,
               *memory_tokens(W, dec, layer, raws[layer] + offset, nm))
    mem.n_imgs += g
    if protected_limit is None:
        mem.protected_imgs, mem.protected_tokens = mem.n_imgs, mem.length
    else:
        grow = min(protected_limit, mem.protected_imgs + g) - \
            mem.protected_imgs
        mem.protected_imgs += grow
        mem.protected_tokens += grow * n
    return x


def decoder_render(W, dec, mem: Memory, x_enc, pos, nm: Numerics = REFERENCE,
                   chunk: int = 2):
    """Every view of x_enc [B, G, N, Denc] against the frozen memory, in
    chunks of ``chunk`` views (views do not interact). Returns [B, G, N,
    D]."""
    return torch.cat([_render(W, dec, mem, x_enc[:, i:i + chunk],
                              pos[:, i:i + chunk], nm)
                      for i in range(0, x_enc.shape[1], chunk)], dim=1)


def _render(W, dec, mem, x_enc, pos, nm):
    b, g, n, _ = x_enc.shape
    d, nh = dec["embed_dim"], dec["num_heads"]
    x = _embed(W, x_enc, nm, first_skipped=False)
    rope = rope_tables(pos.reshape(b * g, n, 2), d // nh, dec["rope_base"])
    allow = (mem.labels >= 0)[:, None, :].expand(b, g, -1)
    for layer in range(dec["depth"]):
        x = decoder_block(W, dec, layer, x, rope, mem, allow, nm)
    return x


def head(W, dec, tokens: torch.Tensor, hw) -> torch.Tensor:
    """tokens [..., N, D] -> raw head output [..., H, W, C]: LayerNorm,
    linear, pixel shuffle (feature c*P*P + i*P + j is channel c of pixel
    (i, j) of the patch)."""
    lead = tokens.shape[:-2]
    p = dec["patch_size"]
    h, w = hw
    t = layer_norm(W, "decoder.norm_dec", tokens)
    y = linear(W, "decoder.head_dec.proj", t, REFERENCE)
    c = y.shape[-1] // (p * p)
    y = y.reshape(-1, h // p, w // p, c, p, p).permute(0, 1, 4, 2, 5, 3)
    return y.reshape(*lead, h, w, c)


# ---------------------------------------------------------------------------
# Postprocess
# ---------------------------------------------------------------------------

def norm_exp(xyz: torch.Tensor) -> torch.Tensor:
    d = xyz.norm(dim=-1, keepdim=True)
    return xyz / d.clamp_min(1e-8) * torch.expm1(d)


def weiszfeld_focal(pts: torch.Tensor, iters: int = 10) -> torch.Tensor:
    """Focal of camera-frame points [B, H, W, 3] with the principal point
    at the image centre: the focal minimising sum |pixel - f * xy / z|,
    by Weiszfeld's reweighting from the least-squares start, at least 0."""
    b, h, w, _ = pts.shape
    ys, xs = torch.meshgrid(torch.arange(h, device=pts.device),
                            torch.arange(w, device=pts.device),
                            indexing="ij")
    px = torch.stack([xs, ys], dim=-1).reshape(1, h * w, 2).to(pts.dtype)
    px = px - torch.tensor([w / 2.0, h / 2.0], dtype=pts.dtype,
                           device=pts.device)
    p = pts.reshape(b, h * w, 3)
    z = p[..., 2:3]
    z = torch.where(z.abs() < 1e-8, torch.full_like(z, 1e-8), z)
    r = torch.nan_to_num(p[..., :2] / z, nan=0.0, posinf=0.0, neginf=0.0)
    dot_rp = (r * px).sum(-1)
    dot_rr = (r * r).sum(-1)
    f = dot_rp.mean(1) / dot_rr.mean(1).clamp_min(1e-8)
    for _ in range(iters):
        wgt = 1.0 / (px - f[:, None, None] * r).norm(dim=-1).clamp_min(1e-8)
        f = (wgt * dot_rp).mean(1) / (wgt * dot_rr).mean(1).clamp_min(1e-8)
    return f.clamp_min(0.0)


def horn_procrustes(x: torch.Tensor, y: torch.Tensor, wgt: torch.Tensor):
    """R, t minimising sum w |R x + t - y|^2 (x, y [B, M, 3], w [B, M]):
    Horn's 4 x 4 matrix of the weighted cross-covariance, its top
    eigenvector by the fixed power scheme (module docstring), the unit
    quaternion's rotation. Returns the [B, 4, 4] rigid transform."""
    wn = wgt.clamp_min(0.0)
    wn = wn / wn.sum(-1, keepdim=True).clamp_min(1e-8)
    cx = (wn[..., None] * x).sum(1)
    cy = (wn[..., None] * y).sum(1)
    s = torch.einsum("bm,bmi,bmj->bij", wn, x - cx[:, None], y - cy[:, None])
    (xx, xy, xz), (yx, yy, yz), (zx, zy, zz) = (s[:, i].unbind(-1)
                                                for i in range(3))
    n = torch.stack([
        torch.stack([xx + yy + zz, yz - zy, zx - xz, xy - yx], -1),
        torch.stack([yz - zy, xx - yy - zz, xy + yx, zx + xz], -1),
        torch.stack([zx - xz, xy + yx, yy - xx - zz, yz + zy], -1),
        torch.stack([xy - yx, zx + xz, yz + zy, zz - xx - yy], -1)], dim=-2)

    def fro(m):
        return m.square().sum((-2, -1), keepdim=True).sqrt()

    m = n + (fro(n) + 1e-8) * torch.eye(4, dtype=n.dtype, device=n.device)
    m = m / fro(m).clamp_min(1e-8)
    for _ in range(6):
        m = m @ m
        m = m / fro(m).clamp_min(1e-8)
    q = m @ torch.tensor([1.0, 0.011, 0.017, 0.023], dtype=n.dtype,
                         device=n.device)
    q = q / q.norm(dim=-1, keepdim=True).clamp_min(1e-8)
    qw, qx, qy, qz = q.unbind(-1)
    r = torch.stack([
        1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz),
        2 * (qx * qz + qw * qy),
        2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz),
        2 * (qy * qz - qw * qx),
        2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx),
        1 - 2 * (qx * qx + qy * qy)], -1).reshape(-1, 3, 3)
    t = cy - (r @ cx[..., None])[..., 0]
    out = torch.zeros(r.shape[0], 4, 4, dtype=r.dtype, device=r.device)
    out[:, :3, :3], out[:, :3, 3], out[:, 3, 3] = r, t, 1.0
    return out


def camera(pts3d, pts3d_local, conf, dtype=torch.float32):
    """Focal [V] and camera-to-world [V, 4, 4] of V views' pointmaps:
    Weiszfeld on the local pointmap, Procrustes from the local to the
    global one weighted by conf - 1; computed in ``dtype`` (the control
    of the float32 stage takes bfloat16), returned in float32."""
    v = pts3d.shape[0]
    p, pl, c = (torch.as_tensor(t).to(dtype) for t in (pts3d, pts3d_local,
                                                       conf))
    focal = weiszfeld_focal(pl)
    c2w = horn_procrustes(pl.reshape(v, -1, 3), p.reshape(v, -1, 3),
                          (c - 1.0).reshape(v, -1))
    return focal.float(), c2w.float()


def postprocess(raw: torch.Tensor) -> dict:
    """raw [V, H, W, 7] -> pts3d, pts3d_local [V, H, W, 3], conf [V, H, W],
    focal [V], c2w [V, 4, 4]."""
    out = {"pts3d": norm_exp(raw[..., :3]),
           "pts3d_local": norm_exp(raw[..., 3:6]),
           "conf": 1.0 + torch.exp(raw[..., 6])}
    out["focal"], out["c2w"] = camera(out["pts3d"], out["pts3d_local"],
                                      out["conf"])
    return out


# ---------------------------------------------------------------------------
# Offline reconstruction of one collection
# ---------------------------------------------------------------------------

def reconstruct(W, cfg: dict, imgs: torch.Tensor, n_mem: int,
                init_images: int = 2, nm: Numerics = REFERENCE,
                render=None, keep_memory: bool = False) -> dict:
    """One collection imgs [V, H, W, 3] in processing order: the first
    ``n_mem`` views build the memory ([init_images jointly, then one at a
    time]), then the views ``render`` (indices, default all) are rendered
    against it. Returns their postprocessed outputs, in that order, and
    with ``keep_memory`` the memory as it stores them (``memory``: per
    layer (k, v) [H, S, Dh], dequantized where it is 8-bit)."""
    enc, dec = cfg["encoder"], cfg["decoder"]
    v, h, w, _ = imgs.shape
    p = dec["patch_size"]
    x = encode(W, enc, imgs, nm)[None]                          # 1,V,N,D
    pos = patch_positions(h // p, w // p, imgs.device).expand(1, v, -1, -1)
    mem = empty_memory(dec, 1, imgs.device)
    g0 = min(init_images, n_mem)
    decoder_update(W, dec, mem, x[:, :g0], pos[:, :g0], nm)
    for i in range(g0, n_mem):
        decoder_update(W, dec, mem, x[:, i:i + 1], pos[:, i:i + 1], nm)
    if render is not None:
        x, pos = x[:, render], pos[:, render]
        v = len(render)
    toks = decoder_render(W, dec, mem, x, pos, nm)[0]            # V,N,D
    outs = [postprocess(head(W, dec, toks[i:i + 8], (h, w)))
            for i in range(0, v, 8)]
    out = {k: torch.cat([o[k] for o in outs]) for k in outs[0]}
    if keep_memory:
        out["memory"] = [(k[0], v[0]) for k, v in zip(mem.k, mem.v)]
    return out
