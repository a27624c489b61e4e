"""The work of a request or a training step, from the configuration and the
traffic alone: floating-point operations (2 per multiply-add) and, for each
memory cross-attention call, the least time the card could take for it.

Counting rules. A product of an [M, K] and a [K, N] matrix is 2 M K N. An
attention over q query rows is 4 Dh per head per (query, key) pair that
the masks let attend (QK^T and PV), summed over heads; its backward is 10
Dh per pair (the scores recomputed, dP, dV, dQ, dK). A call's bytes count
each input read once and each output written once: q, the keys and values
up to the high-water mark, their labels (and the scales of an 8-bit
memory), the output (backward: q, k, v, o, dO, the row statistics read;
dQ, dK, dV written). The least time of a call is max(FLOPs / peak, bytes /
bandwidth) at the H100 SXM's published dense bf16 rate and memory
bandwidth. Token dropout blocks a fraction p of the slots that are not
protected; its pairs are counted at their expected number, (1 - p) of
those slots. Nothing here reads the program: the same configuration and
traffic give the same numbers whatever implements them.
"""

from __future__ import annotations

from dataclasses import dataclass

PEAK_FLOPS = 989e12          # H100 SXM, dense bf16, FLOP/s
PEAK_BYTES = 3.35e12         # H100 SXM HBM3, bytes/s
BF16, FP32 = 2, 4


@dataclass
class Work:
    flops: float = 0.0
    ca_fwd_s: float = 0.0        # least time of every CA forward
    ca_bwd_s: float = 0.0        # least time of every CA backward
    ca_fwd_calls: int = 0
    ca_bwd_calls: int = 0

    def scaled(self, k: float) -> "Work":
        return Work(self.flops * k, self.ca_fwd_s * k, self.ca_bwd_s * k,
                    int(self.ca_fwd_calls * k), int(self.ca_bwd_calls * k))


def least_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def tokens_per_view(cfg: dict, hw) -> int:
    p = cfg["decoder"]["patch_size"]
    return (hw[0] // p) * (hw[1] // p)


# ---------------------------------------------------------------------------
# Towers
# ---------------------------------------------------------------------------

def encoder_flops(cfg: dict, n_views: int, n: int) -> float:
    """Patch embedding, every block (products and self-attention)."""
    enc = cfg["encoder"]
    d, p = enc["embed_dim"], enc["patch_size"]
    hidden = int(d * enc["mlp_ratio"])
    per_token = 2 * (3 * p * p * d)
    per_token += enc["depth"] * 2 * (3 * d * d + d * d + 2 * d * hidden)
    attn = enc["depth"] * 4 * n * n * d
    return n_views * (n * per_token + attn)


def _block_token_flops(cfg: dict) -> float:
    """Products of one decoder block for one query token (SA qkv and
    output, CA q and output, MLP)."""
    dec = cfg["decoder"]
    d = dec["embed_dim"]
    hidden = int(d * dec["mlp_ratio"])
    return 2 * (3 * d * d + d * d + d * d + d * d + 2 * d * hidden)


def _kv_token_flops(cfg: dict) -> float:
    """Memory keys and values of one token in one layer (k and v
    projections)."""
    d = cfg["decoder"]["embed_dim"]
    return 2 * 2 * d * d


def decoder_pass_flops(cfg: dict, n_images: int, n: int, write: bool
                       ) -> float:
    """Every product of one decoder pass over ``n_images`` images (without
    the cross-attention, counted by :func:`ca_call`): the embedding, the
    blocks, per-image self-attention and, for a memory step
    (``write``), the memory writes and the feedback (its MLP and the
    second write of every layer but the last)."""
    dec = cfg["decoder"]
    d, depth = dec["embed_dim"], dec["depth"]
    t = n_images * n
    flops = 2 * t * dec["enc_embed_dim"] * d
    flops += depth * (t * _block_token_flops(cfg) + n_images * 4 * n * n * d)
    if write:
        flops += depth * t * _kv_token_flops(cfg)
        flops += 2 * t * (2 * d * 4 * d)                 # feedback MLP
        flops += (depth - 1) * t * _kv_token_flops(cfg)
    return flops


def head_flops(cfg: dict, n_views: int, n: int) -> float:
    dec = cfg["decoder"]
    return 2 * n_views * n * dec["embed_dim"] * dec["output_dim"]


# ---------------------------------------------------------------------------
# Memory cross-attention
# ---------------------------------------------------------------------------

def ca_call(cfg: dict, q_rows: int, pairs: float, kv_len: int,
            batch: int = 1, mem_bytes: int = BF16, backward: bool = False):
    """(flops, least seconds) of one CA call (one layer, every batch
    element): ``q_rows`` query rows and ``pairs`` allowed (query, key)
    pairs per batch element, keys up to ``kv_len``."""
    dec = cfg["decoder"]
    d, h = dec["embed_dim"], dec["num_heads"]
    dh = d // h
    per_pair = (10 if backward else 4) * dh * h
    flops = batch * per_pair * pairs
    kv = kv_len * 2 * d * mem_bytes + kv_len * 4      # keys, values, labels
    if mem_bytes == 1:
        kv += kv_len * h * 2 * FP32                      # per-token scales
    rows = q_rows * d * BF16
    if backward:
        nbytes = batch * (kv + 4 * rows + 2 * q_rows * h * FP32
                          + kv_len * 2 * d * BF16)
    else:
        nbytes = batch * (kv + 2 * rows)
    return flops, least_s(flops, nbytes)


def _add_ca(w: Work, cfg, q_rows, pairs, kv_len, batch, mem_bytes,
            backward=False, flops_times=1):
    """Add one CA call: its least time, and ``flops_times`` times its
    FLOPs to the model's."""
    f, s = ca_call(cfg, q_rows, pairs, kv_len, batch, mem_bytes, backward)
    w.flops += flops_times * f
    if backward:
        w.ca_bwd_s += s
        w.ca_bwd_calls += 1
    else:
        w.ca_fwd_s += s
        w.ca_fwd_calls += 1


# ---------------------------------------------------------------------------
# Offline reconstruction
# ---------------------------------------------------------------------------

def offline_request(cfg: dict, hw, n_views: int, n_mem: int,
                    init_images: int = 2, n_scenes: int = 1,
                    mem_bytes: int = BF16) -> Work:
    """One request of ``n_scenes`` collections of ``n_views`` views: encode
    every view; memory steps [init_images, 1, 1, ...] over the first
    ``n_mem`` views (each image attends every other image's tokens in the
    memory, a single first image itself); render every view against the
    whole memory; the head of every rendered view."""
    n = tokens_per_view(cfg, hw)
    depth = cfg["decoder"]["depth"]
    w = Work()
    w.flops += n_scenes * (encoder_flops(cfg, n_views, n)
                           + head_flops(cfg, n_views, n))
    g0 = min(init_images, n_mem)
    steps = [(0, g0)] + [(i, 1) for i in range(g0, n_mem)]
    for n_imgs, g in steps:
        w.flops += n_scenes * decoder_pass_flops(cfg, g, n, write=True)
        kv_len = (n_imgs + g) * n
        seen = 1 if (n_imgs == 0 and g == 1) else n_imgs + g - 1
        for _ in range(depth):
            _add_ca(w, cfg, g * n, g * n * seen * n, kv_len, n_scenes,
                    mem_bytes)
    w.flops += n_scenes * decoder_pass_flops(cfg, n_views, n, write=False)
    kv_len = n_mem * n
    for _ in range(depth):
        _add_ca(w, cfg, n_views * n, n_views * n * kv_len, kv_len, n_scenes,
                mem_bytes)
    return w


# ---------------------------------------------------------------------------
# Training step
# ---------------------------------------------------------------------------

def train_step(cfg: dict, hw, batch: int, mem_batches, n_render: int,
               dropout_p: float, protected_imgs: int = 1) -> Work:
    """One causal training step: the frozen encoder forward over every
    view; the decoder's memory steps, render and head forward and backward
    (the backward at twice the forward's products, so 3 x the forward in
    all; recomputation not counted); the least time of each CA call
    forward and backward. Causal masks: an image
    attends strictly earlier images, image 0 of the first step itself and
    image 1; dropout at its expected count."""
    n = tokens_per_view(cfg, hw)
    depth = cfg["decoder"]["depth"]
    n_views = sum(mem_batches)
    w = Work()
    w.flops += batch * encoder_flops(cfg, n_views, n)
    dec_fwd = head_flops(cfg, n_views + n_render, n)
    n_imgs, protected = 0, 0
    for g in mem_batches:
        dec_fwd += decoder_pass_flops(cfg, g, n, write=True)
        kv_len = (n_imgs + g) * n
        pairs = 0.0
        for i in range(g):
            label = n_imgs + i
            seen = [0, 1] if (n_imgs == 0 and i == 0 and g > 1) else \
                list(range(label)) if (n_imgs or i) else [0]
            for s in seen:
                kept = n if s < protected else (1 - dropout_p) * n
                pairs += n * kept
        for _ in range(depth):
            _add_ca(w, cfg, g * n, pairs, kv_len, batch, BF16, False, 3)
            _add_ca(w, cfg, g * n, pairs, kv_len, batch, BF16, True, 0)
        n_imgs += g
        protected = min(protected_imgs, protected + g)
    dec_fwd += decoder_pass_flops(cfg, n_render, n, write=False)
    kv_len = n_imgs * n
    for _ in range(depth if n_render else 0):
        for backward, times in ((False, 3), (True, 0)):
            _add_ca(w, cfg, n_render * n, n_render * n * kv_len, kv_len,
                    batch, BF16, backward, times)
    w.flops += 3 * batch * dec_fwd
    return w
