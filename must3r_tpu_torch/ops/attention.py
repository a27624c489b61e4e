"""Attention for the PyTorch port: flash-attention forwards and the CA
backward of the offline and training paths, each CUDA kernel with a plain
PyTorch version beside it.

* :func:`self_attention` -- full (unmasked) per-image self-attention,
  counterpart of ``must3r_tpu.ops.attention.self_attention``. Kernel K1
  (``csrc/attention_sm90.cu``) replaces the TPU kernel ``_sa_pallas``. Where a
  gradient is needed, the backward recomputes through the plain version
  (as ``_sa_hybrid_bwd`` does through ``_sa_chunked``; there is no SA
  backward kernel).
* :func:`memory_cross_attention` -- queries against the packed token memory
  with the label predicate computed from an ``[S]`` label vector::

      allow(g, j) = j < kv_len AND label[j] >= 0 AND label[j] != q_self[g]
                    AND label[j] < q_upper[g] AND NOT extra_mask[g, j]

  counterpart of ``must3r_tpu.ops.attention.memory_cross_attention``.
  Kernel K2 replaces ``_ca_pallas`` (serving, and with the ``return_stats``
  / ``ext`` flags the training forward); against an 8-bit cache
  (``kv_scale`` given) kernel K2(d) ``ca_fwd_q8`` replaces its
  ``kv_scales`` variant and dequantizes in flight (no gradient: serving
  only). Differentiable (full-precision cache): the backward
  (``_MemoryCA``) computes ``delta = rowsum(dO * O)`` in fp32 and routes as
  the JAX package does, by ``_fold_stripe(G, N)``: K5 ``ca_bwd_fused``
  (replaces ``_ca_bwd_fused_pallas``) where it holds, else K3 ``ca_bwd_dq``
  + K4 ``ca_bwd_dkv`` (``_ca_bwd_dq_pallas`` + ``_ca_bwd_dkv_pallas``); all
  three are TMA + wgmma programs of ``csrc/attention_bwd_sm90.cu``.

``impl``: ``None`` launches the kernels for a CUDA tensor and runs the plain
versions for a CPU tensor; ``"plain"`` forces the plain versions (tests and
the chip smoke's comparisons). A kernel that cannot run raises; nothing
falls back.

The plain versions are explicit chunked formulas, never autograd over a
dense [N, S] score matrix (at the render shape that would be 2.8 GB): the
forwards are ports of the JAX ``_sa_chunked`` / ``_ca_chunked`` (online
softmax over 1024-key chunks, fp32 statistics, probabilities rounded to the
input dtype before P.V), the backwards follow the Pallas backward kernels
(p recomputed from the saved LSE, ds rounded to the input dtype before its
products, fp32 accumulation).

A query row that attends no key (every label masked, or kv_len == 0)
returns 0 and has LSE = +1e30, so the backward's p = exp(s - lse) is 0
there: dq = 0 and no dK/dV contribution. The JAX chunked path returns the
mean of V over all slots there, and the Pallas kernel the mean over its
first block; the main paths never make such a row.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from must3r_tpu_torch.memory import dequantize_kv
from must3r_tpu_torch.ops import _kernels

INT32_MAX = 2 ** 31 - 1
_NEG_INF = -1e30
EMPTY_LSE = 1e30          # LSE of a row that attends nothing
_IMPLS = (None, "plain")
_FOLD_MAX_ROWS = 2048


def launch_counts() -> dict:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return {k.__name__: k.launches for k in _kernels.KERNELS}


def reset_launch_counts():
    for k in _kernels.KERNELS:
        k.launches = 0


def _use_plain(impl: Optional[str], t: torch.Tensor) -> bool:
    if impl not in _IMPLS:
        raise ValueError(f"impl must be one of {_IMPLS}, got {impl!r}")
    return impl == "plain" or (impl is None and not t.is_cuda)


def _online_softmax(qf: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    wd: torch.dtype, chunk: int,
                    allow: Optional[Callable] = None,
                    return_stats: bool = False):
    """softmax(qf k^T) v over key chunks, fp32 m / l / acc.

    qf: [..., N, Dh] fp32 (already scaled); k, v: [..., S, Dh] broadcasting
    against qf's leading dims; allow(c0, c1): bool mask broadcastable to
    [..., N, c1 - c0], or None for every key. Masked keys get probability 0,
    so a row with nothing attended comes out 0. With ``return_stats`` also
    the row log-sum-exp [..., N] (EMPTY_LSE for such a row)."""
    m = torch.full((*qf.shape[:-1], 1), _NEG_INF, dtype=torch.float32,
                   device=qf.device)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    for c0 in range(0, k.shape[-2], chunk):
        c1 = min(c0 + chunk, k.shape[-2])
        s = torch.matmul(qf, k[..., c0:c1, :].float().transpose(-1, -2))
        a = None if allow is None else allow(c0, c1)
        if a is not None:
            s = s.masked_fill(~a, _NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        if a is not None:
            p = p.masked_fill(~a, 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.matmul(p.to(wd).float(),
                                        v[..., c0:c1, :].float())
        m = m_new
    out = acc / l.clamp_min(1e-30)
    if not return_stats:
        return out
    lse = torch.where(l > 0, m + torch.log(l.clamp_min(1e-30)),
                      torch.full_like(m, EMPTY_LSE))
    return out, lse[..., 0]


# ---------------------------------------------------------------------------
# Self-attention
# ---------------------------------------------------------------------------

def self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   impl: Optional[str] = None) -> torch.Tensor:
    """Full multi-head attention. q, k, v: [B, N, H, Dh] -> [B, N, H, Dh]."""
    plain = _use_plain(impl, q)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _SelfAttention.apply(q, k, v, plain)
    return _sa_plain(q, k, v) if plain else _kernels.sa_fwd(q, k, v)


def _sa_plain(q, k, v, chunk: int = 1024):
    """Plain version of K1 (port of the JAX ``_sa_chunked``)."""
    wd = q.dtype
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf = (q * scale).to(wd).transpose(1, 2).float()          # B,H,N,Dh
    out = _online_softmax(qf, k.transpose(1, 2), v.transpose(1, 2), wd,
                          chunk)
    return out.transpose(1, 2).to(q.dtype)


class _SelfAttention(torch.autograd.Function):
    """K1 (or its plain version) forward; the backward recomputes through
    the plain version with autograd, as the JAX package's ``_sa_hybrid``
    does through ``_sa_chunked``: no score matrix is kept from the
    forward."""

    @staticmethod
    def forward(ctx, q, k, v, plain: bool):
        ctx.save_for_backward(q, k, v)
        return _sa_plain(q, k, v) if plain else _kernels.sa_fwd(q, k, v)

    @staticmethod
    def backward(ctx, dout):
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            out = _sa_plain(*leaves)
            grads = torch.autograd.grad(out, leaves, dout)
        return (*grads, None)


# ---------------------------------------------------------------------------
# Memory cross-attention
# ---------------------------------------------------------------------------

def memory_cross_attention(q: torch.Tensor, kv, labels: torch.Tensor,
                           q_self: Optional[torch.Tensor] = None,
                           q_upper: Optional[torch.Tensor] = None,
                           kv_len: Optional[int] = None,
                           extra_mask: Optional[torch.Tensor] = None,
                           layer: Optional[int] = None,
                           impl: Optional[str] = None,
                           kv_scale: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Label-masked flash cross-attention against the token memory.

    Args:
      q: [B, G, N, H, Dh] queries (G = images in this step).
      kv: packed memory keys|values [B, H, S, 2*Dh], or with ``layer`` the
        whole per-layer cache (a [L, B, H, S, 2*Dh] tensor, whose layer is a
        view, or the training path's list of L per-layer tensors).
      labels: [B, S'] int32 image label per slot (S' >= S; slots past S are
        not read); -1 = free slot.
      q_self: [B, G] int32; slots with this label are masked (-2 disables).
      q_upper: [B, G] int32; slots with label >= q_upper are masked
        (INT32_MAX disables).
      kv_len: host int high-water mark; keys at or past it are not read.
        Defaults to S.
      extra_mask: optional bool [B, G, S'] token-dropout mask, True =
        blocked.
      layer: host int selecting the layer of a per-layer ``kv``.
      kv_scale: the fp32 dequant scales of an 8-bit (int8 / fp8 e4m3)
        cache, [B, H, 2, S] (or [L, B, H, 2, S] with ``layer``), or None for
        a bf16 / fp32 cache. The quantized read is for serving: it has no
        gradient, and a call that needs one raises.
    Returns: [B, G, N, H, Dh]. Differentiable in q and kv (full-precision
    cache).
    """
    b, g, n, h, dh = q.shape
    kv_l = kv if layer is None else kv[layer]
    if kv_l.dim() != 4:
        raise ValueError(f"kv must be [B, H, S, 2*Dh] (or per-layer with "
                         f"layer), got {tuple(kv_l.shape)}")
    s_cap = kv_l.shape[2]
    if labels.shape[1] != s_cap:
        labels = labels[:, :s_cap].contiguous()
    if extra_mask is not None:
        extra_mask = extra_mask[:, :, :s_cap].to(torch.bool).contiguous()
    if q_self is None:
        q_self = torch.full((b, g), -2, dtype=torch.int32, device=q.device)
    if q_upper is None:
        q_upper = torch.full((b, g), INT32_MAX, dtype=torch.int32,
                             device=q.device)
    kv_len = s_cap if kv_len is None else int(kv_len)
    if not 0 <= kv_len <= s_cap:
        raise ValueError(f"kv_len {kv_len} outside [0, {s_cap}]")
    plain = _use_plain(impl, q)
    if kv_scale is not None:
        scale_l = kv_scale if layer is None else kv_scale[layer]
        if torch.is_grad_enabled() and q.requires_grad:
            raise ValueError("the 8-bit cache read has no gradient (serving "
                             "paths only)")
        if plain:
            return _ca_q8_plain(q, kv_l, scale_l, labels, q_self, q_upper,
                                kv_len, extra_mask)
        return _kernels.ca_fwd_q8(q, kv_l, scale_l, labels, q_self, q_upper,
                                  kv_len, ext=extra_mask)
    if torch.is_grad_enabled() and (q.requires_grad or kv_l.requires_grad):
        return _MemoryCA.apply(q, kv_l, labels, q_self, q_upper, kv_len,
                               extra_mask, plain)
    if plain:
        return _ca_plain(q, kv_l[..., :dh], kv_l[..., dh:], labels, q_self,
                         q_upper, kv_len, extra_mask)
    return _kernels.ca_fwd(q, kv_l, labels, q_self, q_upper, kv_len,
                           ext=extra_mask)


def _ca_allow(labels, q_self, q_upper, ext):
    """allow(c0, c1) -> bool [B, G, c] of the label predicate (and the
    dropout mask) over keys [c0, c1)."""
    qs = q_self.to(labels.dtype)[..., None]                    # B,G,1
    qu = q_upper.to(labels.dtype)[..., None]

    def allow(c0, c1):
        lb = labels[:, None, c0:c1]                            # B,1,c
        a = (lb >= 0) & (lb != qs) & (lb < qu)                 # B,G,c
        if ext is not None:
            a = a & ~ext[:, :, c0:c1]
        return a
    return allow


def _ca_plain(q, k, v, labels, q_self, q_upper, kv_len: int,
              extra_mask=None, return_stats: bool = False,
              chunk: int = 1024):
    """Plain version of K2 (port of the JAX ``_ca_chunked``, reading only
    the first ``kv_len`` slots). k, v: [B, H, S, Dh]. With
    ``return_stats`` also the fp32 row LSE [B, G, H, N]."""
    wd = q.dtype
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf = (q * scale).to(wd).permute(0, 1, 3, 2, 4).float()    # B,G,H,N,Dh
    allow = _ca_allow(labels, q_self, q_upper, extra_mask)
    res = _online_softmax(
        qf, k[:, None, :, :kv_len], v[:, None, :, :kv_len], wd, chunk,
        lambda c0, c1: allow(c0, c1)[:, :, None, None, :], return_stats)
    if not return_stats:
        return res.permute(0, 1, 3, 2, 4).to(q.dtype)
    out, lse = res
    return out.permute(0, 1, 3, 2, 4).to(q.dtype), lse


def _ca_q8_plain(q, kv, scale, labels, q_self, q_upper, kv_len: int,
                 extra_mask=None, return_stats: bool = False):
    """Plain version of K2(d), the 8-bit cache read: the JAX chunked
    semantics, which dequantize the layer's first ``kv_len`` slots (kv [B,
    H, S, 2*Dh] codes, scale [B, H, 2, S]) to q's dtype and attend them."""
    dh = q.shape[-1]
    deq = dequantize_kv(kv[:, :, :kv_len], scale[..., :kv_len], q.dtype)
    return _ca_plain(q, deq[..., :dh], deq[..., dh:], labels, q_self,
                     q_upper, kv_len, extra_mask, return_stats=return_stats)


# ---------------------------------------------------------------------------
# CA backward: plain versions of K3 / K4 / K5, and the autograd Function
# ---------------------------------------------------------------------------

def _fold_stripe(g: int, n: int) -> Optional[int]:
    """The JAX package's routing predicate for the CA backward (its
    folded-G row layout): several images per step whose 128-aligned rows
    fit 2048 take the fused kernel, the rest take dq + dkv. Kept so that
    the same calls reach the same counterparts."""
    stripe = -(-n // 128) * 128
    if g > 1 and g * stripe <= _FOLD_MAX_ROWS:
        return stripe
    return None


def _ca_bwd_chunks(q, kv, labels, q_self, q_upper, kv_len, lse, delta, dout,
                   ext, chunk: int = 1024):
    """Per key chunk [c0, c1): (c0, c1, p, ds, k, v) with
    p = allow * exp(q.k * scale - lse) and ds = p * (dO.v - delta), both
    fp32 [B, G, H, N, c]; k, v fp32 [B, 1, H, c, Dh]."""
    dh = q.shape[-1]
    scale = 1.0 / math.sqrt(dh)
    qt = q.permute(0, 1, 3, 2, 4).float()                     # B,G,H,N,Dh
    dot = dout.permute(0, 1, 3, 2, 4).float()
    lse_, dlt = lse[..., None], delta[..., None]
    allow = _ca_allow(labels, q_self, q_upper, ext)
    for c0 in range(0, kv_len, chunk):
        c1 = min(c0 + chunk, kv_len)
        k = kv[:, None, :, c0:c1, :dh].float()
        v = kv[:, None, :, c0:c1, dh:].float()
        s = torch.matmul(qt, k.transpose(-1, -2)) * scale
        p = torch.where(allow(c0, c1)[:, :, None, None, :],
                        torch.exp(s - lse_), torch.zeros_like(s))
        ds = p * (torch.matmul(dot, v.transpose(-1, -2)) - dlt)
        yield c0, c1, p, ds, k, v


def _dq_of(q, ds, k, acc):
    """acc += ds (rounded to the input dtype) . k."""
    part = torch.matmul(ds.to(q.dtype).float(), k)
    return part if acc is None else acc + part


def _dq_out(q, acc):
    scale = 1.0 / math.sqrt(q.shape[-1])
    if acc is None:
        return torch.zeros_like(q)
    return (acc * scale).permute(0, 1, 3, 2, 4).to(q.dtype)


def _dkv_chunk(q, dout, p, ds):
    """(dk, dv) fp32 [B, H, c, Dh] of one key chunk, summed over G and N."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qt = q.permute(0, 1, 3, 2, 4).float()
    dot = dout.permute(0, 1, 3, 2, 4).float()
    dv = torch.einsum("bghnc,bghnd->bhcd", p.to(dout.dtype).float(), dot)
    dk = torch.einsum("bghnc,bghnd->bhcd", ds.to(q.dtype).float(), qt)
    return dk * scale, dv


def _ca_bwd_dq_plain(q, kv, labels, q_self, q_upper, kv_len, lse, delta,
                     dout, ext=None):
    """Plain version of K3: dQ [B, G, N, H, Dh]."""
    acc = None
    for _, _, _, ds, k, _ in _ca_bwd_chunks(q, kv, labels, q_self, q_upper,
                                            kv_len, lse, delta, dout, ext):
        acc = _dq_of(q, ds, k, acc)
    return _dq_out(q, acc)


def _ca_bwd_dkv_plain(q, kv, labels, q_self, q_upper, kv_len, lse, delta,
                      dout, ext=None):
    """Plain version of K4: dK|dV [B, H, S, 2*Dh] (0 past kv_len)."""
    dh = q.shape[-1]
    dkv = torch.zeros_like(kv)
    for c0, c1, p, ds, _, _ in _ca_bwd_chunks(q, kv, labels, q_self, q_upper,
                                              kv_len, lse, delta, dout, ext):
        dk, dv = _dkv_chunk(q, dout, p, ds)
        dkv[:, :, c0:c1, :dh] = dk.to(kv.dtype)
        dkv[:, :, c0:c1, dh:] = dv.to(kv.dtype)
    return dkv


def _ca_bwd_fused_plain(q, kv, labels, q_self, q_upper, kv_len, lse, delta,
                        dout, ext=None):
    """Plain version of K5: (dQ, dK|dV) from one pass over the keys."""
    dh = q.shape[-1]
    dkv = torch.zeros_like(kv)
    acc = None
    for c0, c1, p, ds, k, _ in _ca_bwd_chunks(q, kv, labels, q_self,
                                              q_upper, kv_len, lse, delta,
                                              dout, ext):
        acc = _dq_of(q, ds, k, acc)
        dk, dv = _dkv_chunk(q, dout, p, ds)
        dkv[:, :, c0:c1, :dh] = dk.to(kv.dtype)
        dkv[:, :, c0:c1, dh:] = dv.to(kv.dtype)
    return _dq_out(q, acc), dkv


class _MemoryCA(torch.autograd.Function):
    """CA with the flash backward: K2 with LSE (and ext) forward, K3 + K4
    or K5 backward (or their plain versions for CPU tensors / impl
    "plain"). Gradients flow to q and to the layer's kv."""

    @staticmethod
    def forward(ctx, q, kv, labels, q_self, q_upper, kv_len: int, ext,
                plain: bool):
        dh = q.shape[-1]
        if plain:
            out, lse = _ca_plain(q, kv[..., :dh], kv[..., dh:], labels,
                                 q_self, q_upper, kv_len, ext,
                                 return_stats=True)
        else:
            out, lse = _kernels.ca_fwd(q, kv, labels, q_self, q_upper,
                                       kv_len, ext=ext, return_stats=True)
        ctx.save_for_backward(q, kv, labels, q_self, q_upper, ext, lse, out)
        ctx.kv_len, ctx.plain = kv_len, plain
        return out

    @staticmethod
    def backward(ctx, dout):
        q, kv, labels, q_self, q_upper, ext, lse, out = ctx.saved_tensors
        dout = dout.contiguous()
        delta = (dout.float() * out.float()).sum(-1).permute(
            0, 1, 3, 2).contiguous()                           # B,G,H,N
        args = (q, kv, labels, q_self, q_upper, ctx.kv_len, lse, delta, dout,
                ext)
        if _fold_stripe(q.shape[1], q.shape[2]) is not None:
            fused = _ca_bwd_fused_plain if ctx.plain else _kernels.ca_bwd_fused
            dq, dkv = fused(*args)
        elif ctx.plain:
            dq, dkv = _ca_bwd_dq_plain(*args), _ca_bwd_dkv_plain(*args)
        else:
            dq, dkv = _kernels.ca_bwd_dq(*args), _kernels.ca_bwd_dkv(*args)
        return dq, dkv, None, None, None, None, None, None
