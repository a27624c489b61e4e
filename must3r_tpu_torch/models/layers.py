"""Transformer layers of the port (counterpart of
``must3r_tpu/models/layers.py``).

Modules here only hold parameters, under the reference state-dict key names
(``attn.qkv``, ``cross_attn.projq`` ...); the forward passes are plain
functions that take a module and tensors, as the JAX functions take a
parameter dict.

Numerics follow the JAX package: ``linear`` accumulates in fp32, adds the
bias in fp32 and rounds once to the input dtype; ``layer_norm`` takes its
statistics in fp32; ``gelu`` is the exact erf form.

On a CUDA tensor below fp32, ``linear`` runs as ``_Linear32``: bf16
products with fp32 accumulation (``torch.mm(..., out_dtype=float32)``)
forward and backward, so autograd needs no derivative of that op. The
weight gradient comes out fp32, the dtype of the trainable weights.

``encoder_block`` takes a fused path where its input allows
(:func:`use_block_glue`): on the card, with no gradient, a bf16 branch and
64-channel heads, the glue between its products runs as four kernels
(``ops/block_glue.py``), each reading a product's fp32 output once, with the
roundings of the plain composition below. :func:`glue_counts` counts the
blocks that took each path.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from must3r_tpu_torch.ops import block_glue
from must3r_tpu_torch.ops._kernels import GLUE_MAX_WIDTH, GLUE_VEC
from must3r_tpu_torch.ops.attention import (memory_cross_attention,
                                            self_attention)
from must3r_tpu_torch.ops.rope import apply_rope2d
from must3r_tpu_torch.parallel.sharded_attention import \
    sharded_memory_cross_attention


# ---------------------------------------------------------------------------
# Parameter holders (reference key names)
# ---------------------------------------------------------------------------

class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, out: Optional[int] = None):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, out or dim)


class Attention(nn.Module):
    """``qk_norm`` (VGGT's aggregator): LayerNorms ``q_norm`` / ``k_norm``
    over each head's ``head_dim`` channels of q and k."""

    def __init__(self, dim: int, qk_norm: bool = False, head_dim: int = 64,
                 eps: float = 1e-5):
        super().__init__()
        self.qkv = nn.Linear(dim, 3 * dim)
        if qk_norm:
            self.q_norm = nn.LayerNorm(head_dim, eps=eps)
            self.k_norm = nn.LayerNorm(head_dim, eps=eps)
        self.proj = nn.Linear(dim, dim)


class LayerScale(nn.Module):
    """A learned per-channel scale of a residual branch (``gamma``)."""

    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.empty(dim))


class CrossAttention(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.projq = nn.Linear(dim, dim)
        self.projk = nn.Linear(dim, dim)
        self.projv = nn.Linear(dim, dim)
        self.proj = nn.Linear(dim, dim)


class EncoderBlock(nn.Module):
    """A pre-norm ViT block; ``layer_scale`` adds ``ls1`` / ``ls2`` (DINOv2,
    VGGT), ``qk_norm`` the attention's ``q_norm`` / ``k_norm`` (VGGT's
    aggregator, whose QK-norm LayerNorms take ``qk_eps``)."""

    def __init__(self, dim: int, mlp_ratio: float, eps: float,
                 layer_scale: bool = False, qk_norm: bool = False,
                 num_heads: int = 16, qk_eps: float = 1e-5):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=eps)
        self.attn = Attention(dim, qk_norm, dim // num_heads, qk_eps)
        if layer_scale:
            self.ls1 = LayerScale(dim)
        self.norm2 = nn.LayerNorm(dim, eps=eps)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        if layer_scale:
            self.ls2 = LayerScale(dim)


class DecoderBlock(nn.Module):
    def __init__(self, dim: int, mlp_ratio: float, eps: float):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=eps)
        self.attn = Attention(dim)
        self.norm2 = nn.LayerNorm(dim, eps=eps)
        self.norm_y = nn.LayerNorm(dim, eps=eps)
        self.cross_attn = CrossAttention(dim)
        self.norm3 = nn.LayerNorm(dim, eps=eps)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))


def init_module_(module: nn.Module, generator: torch.Generator):
    """JAX-package init in place: xavier-uniform linear weights, zero
    biases, unit / zero LayerNorms."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Linear):
                xavier_uniform_(m.weight, m.in_features, m.out_features,
                                generator)
                m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()


def xavier_uniform_(w: torch.Tensor, fan_in: int, fan_out: int,
                    generator: torch.Generator):
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        w.uniform_(-bound, bound, generator=generator)


# ---------------------------------------------------------------------------
# Primitive forwards
# ---------------------------------------------------------------------------

def _mm32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of two CUDA tensors below fp32, accumulated and returned in
    fp32."""
    return torch.mm(a, b, out_dtype=torch.float32)


class _Linear32(torch.autograd.Function):
    """y = round_to(x.dtype)(x @ W^T (fp32 accumulation) + b (fp32)) for
    a CUDA x below fp32; W and b in any float dtype."""

    @staticmethod
    def forward(ctx, x, w, b):
        x2 = x.reshape(-1, x.shape[-1])
        wx = w.to(x.dtype)
        y = _mm32(x2, wx.t())
        if b is not None:
            y = y + b.float()
        ctx.save_for_backward(x2, wx)
        ctx.meta = (x.shape, w.dtype, None if b is None else b.dtype)
        return y.to(x.dtype).reshape(*x.shape[:-1], -1)

    @staticmethod
    def backward(ctx, gy):
        x2, wx = ctx.saved_tensors
        shape, w_dtype, b_dtype = ctx.meta
        g2 = gy.reshape(-1, gy.shape[-1]).to(x2.dtype)
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = _mm32(g2, wx).to(x2.dtype).reshape(shape)
        if ctx.needs_input_grad[1]:
            dw = _mm32(g2.t(), x2).to(w_dtype)
        if b_dtype is not None and ctx.needs_input_grad[2]:
            db = g2.float().sum(0).to(b_dtype)
        return dx, dw, db


def linear(p: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """x @ W^T + b: fp32 accumulation, bias added in fp32, one rounding to
    x's dtype. fp32 inputs multiply in full fp32 (TF32 stays off)."""
    w = p.weight
    if x.dtype == torch.float32:
        y = F.linear(x, w.float())
    elif x.is_cuda:
        if torch.is_grad_enabled() and any(
                t is not None and t.requires_grad for t in (x, w, p.bias)):
            return _Linear32.apply(x, w, p.bias)
        y = _mm32(x.reshape(-1, x.shape[-1]), w.to(x.dtype).t()
                  ).reshape(*x.shape[:-1], -1)
    else:
        y = F.linear(x.float(), w.to(x.dtype).float())
    if p.bias is not None:
        y = y + p.bias.float()
    return y.to(x.dtype)


def layer_norm(p: nn.LayerNorm, x: torch.Tensor,
               dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """LayerNorm over the last axis with fp32 statistics, rounded once to
    ``dtype`` (default: x's)."""
    y = F.layer_norm(x.float(), p.normalized_shape, p.weight.float(),
                     p.bias.float(), p.eps)
    return y.to(dtype or x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU."""
    return F.gelu(x)


def mlp(p: Mlp, x: torch.Tensor) -> torch.Tensor:
    return linear(p.fc2, gelu(linear(p.fc1, x)))


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[..., N, D] -> [..., N, H, Dh]."""
    return x.reshape(*x.shape[:-1], num_heads, x.shape[-1] // num_heads)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[..., N, H, Dh] -> [..., N, D]."""
    return x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])


# ---------------------------------------------------------------------------
# Attention modules
# ---------------------------------------------------------------------------

def self_attn(p: Attention, x: torch.Tensor, rope=None, num_heads: int = 12,
              impl: Optional[str] = None) -> torch.Tensor:
    """Fused-qkv self-attention with RoPE on q, k. x: [B, N, D];
    rope: (cos, sin) [B, N, 2, Dh//4] (or [1, N, ...] for every batch
    element). Where ``p`` holds ``q_norm`` / ``k_norm`` (QK-norm), each
    head's q and k go through them first and stay fp32 through RoPE,
    rounded once to x's dtype."""
    b, n, d = x.shape
    qk_norm = hasattr(p, "q_norm")
    q, k, v = linear(p.qkv, x).chunk(3, dim=-1)
    q, k, v = (split_heads(t, num_heads) for t in (q, k, v))
    if qk_norm:
        q = layer_norm(p.q_norm, q, torch.float32)
        k = layer_norm(p.k_norm, k, torch.float32)
    if rope is not None:
        q = apply_rope2d(q, *rope)
        k = apply_rope2d(k, *rope)
    if qk_norm:
        q, k = q.to(x.dtype), k.to(x.dtype)
    o = self_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                       impl=impl)
    return linear(p.proj, merge_heads(o))


def prepare_kv(p: DecoderBlock, y: torch.Tensor,
               num_heads: int = 12) -> torch.Tensor:
    """Memory tokens of one block: LayerNorm(norm_y) -> projk / projv ->
    per-head pack. y: [B, T, D] raw tokens -> [B, H, T, 2*Dh]."""
    y_ = layer_norm(p.norm_y, y)
    k = split_heads(linear(p.cross_attn.projk, y_), num_heads)
    v = split_heads(linear(p.cross_attn.projv, y_), num_heads)
    return torch.cat([k, v], dim=-1).permute(0, 2, 1, 3)


def cross_attn(p: DecoderBlock, x: torch.Tensor, kv, labels: torch.Tensor,
               q_self=None, q_upper=None, kv_len: Optional[int] = None,
               extra_mask=None, layer: Optional[int] = None,
               num_heads: int = 12, impl: Optional[str] = None,
               kv_scale: Optional[torch.Tensor] = None, mesh=None,
               sp_axis: str = "sp", extra_kv=None,
               extra_labels=None) -> torch.Tensor:
    """Memory read: q = projq(norm2(x)); label-masked flash CA against the
    packed cache (``extra_mask`` [B, G, S] bool: token dropout, True =
    blocked; ``kv_scale``: the scales of an 8-bit cache); out projection.
    With ``mesh`` the cache is this rank's shard of a memory sharded over
    ``sp_axis`` and the read is the sharded CA, with ``extra_kv`` /
    ``extra_labels`` as its replicated second source (no dropout mask
    there). x: [B, G, N, D] -> [B, G, N, D]."""
    q = split_heads(linear(p.cross_attn.projq, layer_norm(p.norm2, x)),
                    num_heads)
    if mesh is not None:
        if extra_mask is not None:
            raise ValueError("a dropout mask runs on the unsharded CA only")
        o = sharded_memory_cross_attention(
            mesh, q, kv if layer is None else kv[layer], labels,
            q_self=q_self, q_upper=q_upper, axis=sp_axis, impl=impl,
            kv_len=kv_len, extra_kv=extra_kv, extra_labels=extra_labels,
            kv_scale=(kv_scale if kv_scale is None or layer is None
                      else kv_scale[layer]))
    else:
        o = memory_cross_attention(q, kv, labels, q_self=q_self,
                                   q_upper=q_upper, kv_len=kv_len,
                                   extra_mask=extra_mask, layer=layer,
                                   impl=impl, kv_scale=kv_scale)
    return linear(p.cross_attn.proj, merge_heads(o))


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def scaled_add(x: torch.Tensor, branch: torch.Tensor,
                ls: LayerScale) -> torch.Tensor:
    """x + gamma * branch in fp32, rounded once to x's dtype."""
    return torch.addcmul(x.float(), branch.float(), ls.gamma.float()
                         ).to(x.dtype)


# encoder_block calls since the last reset_glue_counts(), by path
_glue_counts = {"fused_blocks": 0, "plain_blocks": 0}


def glue_counts() -> dict:
    return dict(_glue_counts)


def reset_glue_counts():
    for k in _glue_counts:
        _glue_counts[k] = 0


def _f32(*ts):
    return tuple(t.float() for t in ts)


def use_block_glue(on_cuda: bool, impl: Optional[str], needs_grad: bool,
                   branch_dtype: torch.dtype, stream_dtype: torch.dtype,
                   width: int, hidden: int, num_heads: int) -> bool:
    """Whether :func:`encoder_block` takes its fused path: x on the card
    with the kernels asked for (``impl`` None), no gradient needed, the
    branches in bf16 over an fp32 or bf16 residual stream, heads of 64
    channels, and widths the kernels take (rows of at most 2048, multiples
    of 8). Everything else (the CPU, ``impl="plain"``, fp32 blocks, a
    backward) runs the plain composition."""
    if impl not in (None, "plain"):
        raise ValueError(f"impl must be None or 'plain', got {impl!r}")
    return (on_cuda and impl is None and not needs_grad
            and branch_dtype == torch.bfloat16
            and stream_dtype in (torch.float32, torch.bfloat16)
            and width == num_heads * block_glue.HEAD_DIM
            and width <= GLUE_MAX_WIDTH and hidden % GLUE_VEC == 0)


def glued_block(p: EncoderBlock, x: torch.Tensor, rope,
                glue=block_glue.KERNELS) -> torch.Tensor:
    """:func:`encoder_block` as its fused path runs it: G1, the qkv
    product, G2, K1, the proj product, G3 (a new x, and norm2's output),
    fc1, G4, fc2, G3 (into that x); with ``glue`` ``PLAIN`` their plain
    statements and the plain attention. Each product's fp32 output is read
    once, by the glue that follows it. x: [B, N, D], heads of 64 channels."""
    b, n, d = x.shape
    a, m = p.attn, p.mlp
    gamma1, gamma2 = ((p.ls1.gamma.float(), p.ls2.gamma.float())
                      if hasattr(p, "ls1") else (None, None))
    qk = {}
    if hasattr(a, "q_norm"):
        qk = dict(q_norm=_f32(a.q_norm.weight, a.q_norm.bias),
                  k_norm=_f32(a.k_norm.weight, a.k_norm.bias),
                  eps=a.q_norm.eps)
    if rope is not None:
        rope = tuple(t.contiguous() for t in rope)
    x = x.reshape(b * n, d).contiguous()
    h = glue.ln_cast(x, *_f32(p.norm1.weight, p.norm1.bias), p.norm1.eps)
    q, k, v = glue.qkv_glue(glue.product(h, a.qkv.weight),
                            a.qkv.bias.float(), b, n, rope=rope, **qk)
    o = glue.attention(q, k, v)
    x, h = glue.residual_glue(
        glue.product(o.reshape(b * n, d), a.proj.weight), a.proj.bias.float(),
        x, gamma1, norm=_f32(p.norm2.weight, p.norm2.bias), eps=p.norm2.eps)
    h = glue.bias_gelu(glue.product(h, m.fc1.weight), m.fc1.bias.float())
    x, _ = glue.residual_glue(glue.product(h, m.fc2.weight),
                              m.fc2.bias.float(), x, gamma2, inplace=True)
    return x.reshape(b, n, d)


def encoder_block(p: EncoderBlock, x: torch.Tensor, rope, num_heads: int,
                  impl: Optional[str] = None,
                  dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x += SA(norm1(x)); x += MLP(norm2(x)). Where ``p`` holds LayerScale
    (``ls1`` / ``ls2``) each branch is scaled by it and added in fp32;
    ``dtype``: the branches compute in
    it (the LayerNorms' outputs rounded to it) while the residual stream x
    keeps its own dtype (default: x's). Where :func:`use_block_glue` holds
    it runs as :func:`glued_block`."""
    needs_grad = torch.is_grad_enabled() and (
        x.requires_grad or any(t.requires_grad for t in p.parameters()))
    if use_block_glue(x.is_cuda, impl, needs_grad, dtype or x.dtype, x.dtype,
                      x.shape[-1], p.mlp.fc1.out_features, num_heads):
        _glue_counts["fused_blocks"] += 1
        return glued_block(p, x, rope)
    _glue_counts["plain_blocks"] += 1
    layer_scale = hasattr(p, "ls1")
    h = self_attn(p.attn, layer_norm(p.norm1, x, dtype), rope=rope,
                  num_heads=num_heads, impl=impl)
    x = scaled_add(x, h, p.ls1) if layer_scale else x + h
    h = mlp(p.mlp, layer_norm(p.norm2, x, dtype))
    return scaled_add(x, h, p.ls2) if layer_scale else x + h


def _block_sa(p: DecoderBlock, x: torch.Tensor, rope, num_heads: int,
              impl: Optional[str]) -> torch.Tensor:
    """x + per-image SA(norm1(x)); x: [B, G, N, D]."""
    b, g, n, d = x.shape
    rope_f = None
    if rope is not None:
        rope_f = tuple(t.reshape(b * g, *t.shape[-3:]) for t in rope)
    sa = self_attn(p.attn, layer_norm(p.norm1, x.reshape(b * g, n, d)),
                   rope=rope_f, num_heads=num_heads, impl=impl)
    return x + sa.reshape(b, g, n, d)


def decoder_block(p: DecoderBlock, x: torch.Tensor, kv, rope,
                  labels: torch.Tensor, q_self=None, q_upper=None,
                  kv_len: Optional[int] = None, extra_mask=None,
                  layer: Optional[int] = None, num_heads: int = 12,
                  impl: Optional[str] = None,
                  kv_scale: Optional[torch.Tensor] = None, mesh=None,
                  sp_axis: str = "sp", extra_kv=None,
                  extra_labels=None) -> torch.Tensor:
    """SA (per image) + memory CA + MLP, pre-norm. x: [B, G, N, D]. With
    ``mesh``, the CA is the sharded one (see :func:`cross_attn`)."""
    x = _block_sa(p, x, rope, num_heads, impl)
    x = x + cross_attn(p, x, kv, labels, q_self=q_self, q_upper=q_upper,
                       kv_len=kv_len, extra_mask=extra_mask, layer=layer,
                       num_heads=num_heads, impl=impl, kv_scale=kv_scale,
                       mesh=mesh, sp_axis=sp_axis, extra_kv=extra_kv,
                       extra_labels=extra_labels)
    return x + mlp(p.mlp, layer_norm(p.norm3, x))


def decoder_block_pre_ca(p: DecoderBlock, x: torch.Tensor, rope,
                         num_heads: int = 12, impl: Optional[str] = None):
    """SA half of :func:`decoder_block` and the CA query projection, split
    out so that training can recompute the projections while the CA kernel
    stays outside the recomputed region. Returns (x after SA [B, G, N, D],
    q [B, G, N, H, Dh])."""
    x = _block_sa(p, x, rope, num_heads, impl)
    q = split_heads(linear(p.cross_attn.projq, layer_norm(p.norm2, x)),
                    num_heads)
    return x, q


def decoder_block_post_ca(p: DecoderBlock, x: torch.Tensor,
                          o: torch.Tensor) -> torch.Tensor:
    """CA out-projection + MLP half of :func:`decoder_block`. x: [B, G, N,
    D] after SA; o: [B, G, N, H, Dh] CA output."""
    x = x + linear(p.cross_attn.proj, merge_heads(o))
    return x + mlp(p.mlp, layer_norm(p.norm3, x))
