"""The kernels of the JAX package's two microbenchmarks, each a CUDA kernel
with its plain PyTorch version beside it. No serving or training path runs
them; the bench tools (``tools/bench_ca_kernel.py``,
``tools/bench_fused_chain.py``) do.

* :func:`memory_cross_attention_2h` -- kernel K6 ``ca_fwd_2h``
  (``csrc/attention_sm90.cu``, the TMA + wgmma forward program with a
  head pair a block), replacing ``_ca_pallas_2h`` of
  ``scripts/bench_ca_kernel.py``: the memory cross-attention forward with
  two heads per block over one shared label tile. Its limits are the TPU
  kernel's: one image of queries (G = 1), an even head count, a key j is
  attended when ``j < kv_len and labels[b, j] >= 0`` (no q_self / q_upper /
  dropout mask), no LSE, a bf16 cache. Where the TPU kernel's precondition
  fails (a query row attends nothing) the port keeps K2's definition, out =
  0; the TPU kernel gives NaN or a mean of V there.
* :func:`ln_matmul` -- kernel K7 (``csrc/ln_matmul_sm90.cu``, a TMA +
  wgmma program), replacing
  ``pallas_ln_matmul`` of ``scripts/bench_fused_chain.py``: LayerNorm (fp32
  statistics, population variance, eps 1e-6) with the normalised rows
  rounded to x's dtype, then the product with w at fp32 accumulation,
  rounded to x's dtype. It adds no residual, as the TPU kernel adds none.

``impl``: ``None`` launches the kernel for a CUDA tensor and runs the plain
version for a CPU tensor; ``"plain"`` forces the plain version. Nothing
falls back. Each kernel counts its launches in
``ops.attention.launch_counts``.
"""

from __future__ import annotations

from typing import Optional

import torch

from must3r_tpu_torch.ops import _kernels
from must3r_tpu_torch.ops.attention import INT32_MAX, _ca_plain, _use_plain

LN_EPS = 1e-6


def _ca_2h_plain(q: torch.Tensor, kv_cache: torch.Tensor,
                 labels: torch.Tensor, kv_len: int, layer: int
                 ) -> torch.Tensor:
    """Plain version of K6: K2's plain version on layer ``layer`` with the
    label predicate reduced to ``label >= 0`` (q_self -1, no upper bound)."""
    b, g, _, _, dh = q.shape
    kv = kv_cache[int(layer)]
    q_self = torch.full((b, g), -1, dtype=torch.int32, device=q.device)
    q_upper = torch.full((b, g), INT32_MAX, dtype=torch.int32,
                         device=q.device)
    return _ca_plain(q, kv[..., :dh], kv[..., dh:], labels, q_self, q_upper,
                     int(kv_len))


def memory_cross_attention_2h(q: torch.Tensor, kv_cache: torch.Tensor,
                              labels: torch.Tensor, kv_len: int, layer: int,
                              impl: Optional[str] = None) -> torch.Tensor:
    """Label-masked memory cross-attention, two heads per block.

    q [B, 1, N, H, Dh] (H even); kv_cache [L, B, H, S, 2*Dh] packed k|v;
    labels [B, S] int32 (-1 = free slot); kv_len a host int (keys at or
    past it are not read); layer the cache layer to read. Returns [B, 1, N,
    H, Dh]."""
    _kernels.check_2h(q, kv_cache, labels, kv_len, layer)
    if _use_plain(impl, q):
        return _ca_2h_plain(q, kv_cache, labels, kv_len, layer)
    return _kernels.ca_fwd_2h(q, kv_cache, labels, kv_len, layer)


def _ln_matmul_plain(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
                     w: torch.Tensor) -> torch.Tensor:
    """Plain version of K7 (the arithmetic of ``pallas_ln_matmul``)."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    xn = ((xf - mu) * torch.rsqrt(var + LN_EPS) * g.float()
          + b.float()).to(x.dtype)
    return torch.matmul(xn.float(), w.float()).to(x.dtype)


def ln_matmul(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
              w: torch.Tensor, impl: Optional[str] = None) -> torch.Tensor:
    """LayerNorm(x) * g + b, rounded to x's dtype, times w at fp32
    accumulation; x [M, K], g / b [K], w [K, N] -> [M, N] in x's dtype."""
    if x.dim() != 2 or w.dim() != 2 or w.shape[0] != x.shape[1]:
        raise ValueError(f"ln_matmul: x [M, K] @ w [K, N], got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    if _use_plain(impl, x):
        return _ln_matmul_plain(x, g, b, w)
    return _kernels.ln_matmul(x, g, b, w)
