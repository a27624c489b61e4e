"""The pre-norm encoder block's glue between its products: the plain
PyTorch statements of G1-G4, beside their kernels (``_kernels.ln_cast``,
``qkv_glue``, ``residual_glue``, ``bias_gelu``, ``csrc/block_glue_sm90.cu``).

Each plain statement computes what its kernel computes, from the same
operands and with the same roundings, as the plain composition of
``models/layers.py`` (``linear``, ``layer_norm``, ``self_attn``,
``scaled_add``) and ``ops/rope.py`` does it:

* G1 ``ln_cast``: LayerNorm with fp32 statistics, rounded once to bf16.
* G2 ``qkv_glue``: the qkv product's fp32 output plus its bias in fp32,
  rounded to bf16; q and k LayerNormed per head (QK-norm) and rotated (2D
  RoPE) in fp32 and rounded once; q, k, v as [B, N, H, 64], contiguous.
* G3 ``residual_glue``: a branch product's fp32 output plus its bias,
  rounded to bf16; x + gamma * h in fp32 (LayerScale) or x + h, rounded to
  x's dtype; optionally the next LayerNorm of the new x, rounded to bf16.
* G4 ``bias_gelu``: fc1's fp32 output plus its bias, rounded to bf16, then
  the exact erf GELU, rounded to bf16.

``PLAIN`` and ``KERNELS`` hold the four with the product that feeds them
(``product``: fp32 output of bf16 operands) and the attention between them
(K1, or its plain version), so that one block function runs on either:
:func:`models.layers.encoder_block`'s fused path takes ``KERNELS``, the CPU
tests ``PLAIN``.
"""

from __future__ import annotations

from functools import partial
from types import SimpleNamespace
from typing import Optional

import torch
import torch.nn.functional as F

from must3r_tpu_torch.ops import _kernels
from must3r_tpu_torch.ops.attention import self_attention
from must3r_tpu_torch.ops.rope import apply_rope2d

HEAD_DIM = _kernels.GLUE_HEAD_DIM


def product(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a @ w^T with a's dtype operands, fp32 out: ``linear``'s product on
    the CPU (a [T, K], w [N, K] -> [T, N])."""
    return F.linear(a.float(), w.to(a.dtype).float())


def product32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The same on the card: ``torch.mm`` with fp32 output, as ``linear``
    runs it there."""
    return torch.mm(a, w.to(a.dtype).t(), out_dtype=torch.float32)


def _ln(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
        eps: float) -> torch.Tensor:
    return F.layer_norm(x.float(), (x.shape[-1],), w, b, eps)


def ln_cast(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
            eps: float) -> torch.Tensor:
    """Plain G1: bf16(LayerNorm(x) * w + b), fp32 statistics."""
    return _ln(x, w, b, eps).to(torch.bfloat16)


def qkv_glue(y: torch.Tensor, bias: torch.Tensor, b: int, n: int,
             q_norm=None, k_norm=None, eps: float = 0.0, rope=None):
    """Plain G2: y [B * N, 3 * D] fp32, bias [3 * D] -> q, k, v [B, N, H,
    64] bf16 (see ``_kernels.qkv_glue``)."""
    r = (y + bias).to(torch.bfloat16)
    q, k, v = (t.reshape(b, n, -1, HEAD_DIM) for t in r.chunk(3, dim=-1))
    if q_norm is not None:
        q, k = _ln(q, *q_norm, eps), _ln(k, *k_norm, eps)
    if rope is not None:
        q, k = apply_rope2d(q, *rope), apply_rope2d(k, *rope)
    return tuple(t.to(torch.bfloat16).contiguous() for t in (q, k, v))


def residual_glue(y: torch.Tensor, bias: torch.Tensor, x: torch.Tensor,
                  gamma: Optional[torch.Tensor] = None, norm=None,
                  eps: float = 0.0, inplace: bool = False):
    """Plain G3: (x', xn) from y [T, D] fp32, bias [D], x [T, D] (see
    ``_kernels.residual_glue``)."""
    h = (y + bias).to(torch.bfloat16)
    if gamma is not None:
        new = torch.addcmul(x.float(), h.float(), gamma).to(x.dtype)
    else:
        new = (x + h).to(x.dtype)
    xn = None if norm is None else ln_cast(new, *norm, eps)
    if inplace:
        new = x.copy_(new)
    return new, xn


def bias_gelu(y: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Plain G4: bf16(gelu(bf16(y + bias))), the exact erf GELU."""
    return F.gelu((y + bias).to(torch.bfloat16))


PLAIN = SimpleNamespace(product=product, ln_cast=ln_cast, qkv_glue=qkv_glue,
                        attention=partial(self_attention, impl="plain"),
                        residual_glue=residual_glue, bias_gelu=bias_gelu)
KERNELS = SimpleNamespace(product=product32, ln_cast=_kernels.ln_cast,
                          qkv_glue=_kernels.qkv_glue,
                          attention=_kernels.sa_fwd,
                          residual_glue=_kernels.residual_glue,
                          bias_gelu=_kernels.bias_gelu)
