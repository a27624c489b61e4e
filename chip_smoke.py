#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``must3r_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each ending in ``torch.cuda.synchronize()``; any failure exits
non-zero:

  A. Build the CUDA kernels from ``must3r_tpu_torch/csrc`` (nvcc, sm_90a)
     and print the toolchain and the card.
  B. K1 (``sa_fwd``) at its four main-path shapes and K2 (``ca_fwd``) at
     the update, init and render of a 10-view collection, both the TMA +
     wgmma program of ``csrc/attention_sm90.cu``, against their plain
     PyTorch versions on the card, bf16: max abs error <= min(0.05, 2e-2 x
     max|plain|) and relative RMSE <= 1e-2, no NaN, a fully-masked CA row =
     0. Kernels and the library yardstick (``scaled_dot_product_attention``)
     are timed on the device (a CUDA graph of 20 calls replayed,
     ``must3r_tpu_torch/tools/timing.py``), the plain versions with CUDA
     events around a Python loop; each kernel's events-over-Python-launches
     time is printed beside its device time, and its bound beside both.
  B'. The training kernels against their plain versions at the training
     path's shapes (512 and 224): K2 with the LSE and the token-dropout mask
     (LSE within 1e-2 absolute), K3 + K4 and K5 (the TMA + wgmma programs
     of ``csrc/attention_bwd_sm90.cu``; dq, dk, dv each within phase B's
     bounds); an image that attends nothing gets zero gradients, slots past
     kv_len get dK|dV = 0. Kernel, plain version and
     ``scaled_dot_product_attention`` (a yardstick only) timed as in B, with
     the achieved TFLOP/s and share of the bound; at each shape K3 + K4
     beside K5 and the route ``_fold_stripe`` takes (the routing evidence).
  C. The main path at full width: MUSt3R_512 (ViT-L encoder 24 x 1024,
     ViT-B decoder 12 x 768) with seeded random weights, bf16, 10 views of
     512 x 384 per collection. Three requests: two collections through
     ``make_fused_offline`` and one through ``must3r_inference`` (linseq, the
     function behind the CLI). Launch counters are zeroed just before and
     read just after, and must match the schedule. Outputs must be finite,
     of the expected shapes, with proper rotations, and within 2e-2 relative
     RMSE of the same requests run with the plain attention.
  B''. K2(d), the 8-bit cache read (the TMA + wgmma program with the
     producer warpgroup converting the codes), against its plain version for
     int8 and fp8 caches (phase B's bounds): the render and the update of a
     10-view collection, a masked step (q_self, q_upper, dropout mask,
     kv_len < S whose later slots hold the largest codes and scales of 1e30,
     which must not move the output), a row that attends nothing (= 0), the
     LSE. The library yardstick is SDPA on the dequantized bf16 cache.
  B'''. The fp8 probe: fp8 -> bf16 conversion exact, the dequant dot within
     fp32 summation noise, each timed beside the fewest PyTorch calls of the
     same function (``x.to(torch.bfloat16) * 2``; ``torch.matmul`` of x and
     w in fp32); its entry point run with counted launches.
  B''''. The microbenchmark kernels: K6 (``ca_fwd_2h``, the head pair of the
     TMA + wgmma forward program of ``csrc/attention_sm90.cu``) against its
     plain version (phase B's bounds) and against K2 at the three cases of
     ``scripts/bench_ca_kernel.py`` (render N = S = 7680; one view against
     a 64-keyframe memory, S = 49152; the same with kv_len 9216), library
     SDPA with a boolean mask; K7 (``ln_matmul``, the TMA + wgmma program of
     ``csrc/ln_matmul_sm90.cu``) against its plain version at the three
     cases of ``scripts/bench_fused_chain.py`` with phase B's bound plus one
     bf16 ulp of max|plain| (its output is a 768-term fp32 sum of bf16
     products rounded to bf16, after the normalised rows were rounded to
     bf16: an ulp of difference in one of those roundings is not a fault),
     library ``F.layer_norm`` + ``torch.matmul`` (two calls), and
     ``torch.matmul`` alone beside it. Then ``tools/bench_ca_kernel.py
     --check`` and ``tools/bench_fused_chain.py`` as their users run them,
     counted: their launches must equal the tools' schedules.
  D. The training path at full width, bf16, seeded random weights: D1 three
     ``make_train_step`` steps of MUSt3R_512 (batch 2, 4 views of 512 x 384,
     update steps of 2, 1, 1 views, 2 rendered, remat, dropout 0.1) whose
     launch counts must equal the schedule's, one step's loss and decoder
     gradient against the plain attention; two steps through ``Trainer`` on
     ``SyntheticScenes`` with checkpoint save and resume; D2 the training
     recipe (MUSt3R_224, 20 views in causal blocks of 5), steps/s.
  E. The 8-bit memory at full width (MUSt3R_512, seeded random weights,
     bf16): E1 the fused 10-view 512 x 384 collection with an int8 and an fp8
     memory (distance to the bf16 memory printed); E2 offline_reconstruction
     with one refinement iteration, int8; E3 offline_reconstruction_multi_ar
     on 4 views at 512 x 384 and 4 at 512 x 288, int8; E4
     video_reconstruction with interval keyframes on 16 frames, window 6,
     one refinement pass, int8 (keyframes = the interval rule, the final
     memory = the keyframes' tokens). Each counted: every CA launches K2(d)
     and the bf16 K2 never; outputs finite and within 2e-2 relative RMSE of
     the same request with the plain attention.

The last three lines are the card's name and power limit, every kernel's
JSON record (launches summed over the counted runs of C, D, E, the probe
and the bench tools, device times at one main-path shape each, bound and
library time) and ``{"ok": true, "device": {...}}``. About two minutes on
an H100, the build (four sources, one nvcc each, in parallel) included.
"""

import json
import math
import os
import subprocess
import time

import torch

# Kernel vs plain, bf16: the bounds of tools/parity.py (max abs error <=
# min(TOL, MAX_ERR_REL x max|plain|), relative RMSE <= RMSE_REL).
from must3r_tpu_torch.tools.parity import (MAX_ERR_REL, RMSE_REL, TOL,
                                           kernel_error, rel_rmse)
# Kernel and library times: device_ms (a CUDA graph of REPS calls replayed);
# plain versions: events_ms (CUDA events around a Python loop of calls, their
# many small ops' launch path being part of what they cost).
from must3r_tpu_torch.tools.timing import (REPS, WARMUP, capture_stream,
                                           device_ms, events_ms)

ROOT = os.path.dirname(os.path.abspath(__file__))
RMSE_TOL = 2e-2       # relative RMSE of the slice vs its plain run
N_VIEWS = 10
HW = (384, 512)
SEED = 0


def log(*args):
    print(*args, flush=True)


def sync():
    torch.cuda.synchronize()


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# A. build
# ---------------------------------------------------------------------------

def phase_build():
    from must3r_tpu_torch.ops import _kernels

    t0 = time.perf_counter()
    libs = _kernels.build()
    log(f"[A] built {', '.join(os.path.relpath(p, ROOT) for p in libs)} "
        f"in {time.perf_counter() - t0:.1f} s (one nvcc per source, in "
        f"parallel)")
    for line in _kernels.build_log().splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"[A] ptxas: {line.strip()}")
    nvcc = subprocess.run([_kernels._nvcc(), "--version"], check=True,
                          capture_output=True, text=True).stdout
    log(f"[A] torch {torch.__version__} cuda {torch.version.cuda} "
        f"nvcc {nvcc.strip().splitlines()[-1]}")
    log(f"[A] device {torch.cuda.get_device_name(0)} capability "
        f"{torch.cuda.get_device_capability(0)}; nvidia-smi: {card_line()}")
    sync()


# ---------------------------------------------------------------------------
# B. kernels vs plain
# ---------------------------------------------------------------------------

# The least time the card could take for a kernel's work: the larger of its
# bytes (each input read once, each output written once) over the memory
# rate and its operations over the bf16 tensor-core rate (NVIDIA H100 SXM
# data sheet, dense, at the 700 W limit).
PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def bound(flops: float, nbytes: float) -> dict:
    t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return dict(bound_ms=max(t_ops, t_bytes) * 1e3,
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                gflop=flops / 1e9, mbytes=nbytes / 1e6)


def _compare(name, kernel, plain, results, work, library=None, tag="B",
             library_label="", ulp_allowance=False):
    """Kernel vs its plain version: errors within the bounds, then the
    device times of the kernel and the library yardstick and the CUDA-event
    time of the plain version."""
    got = kernel()
    want = plain()
    sync()
    e = kernel_error(got, want, ulp_allowance)
    ms, plain_ms = device_ms(kernel), events_ms(plain, 5)
    ev_ms = events_ms(kernel)
    lib_ms = None if library is None else device_ms(library)
    log(f"[{tag}] {name}: max_abs_err {e['max_abs_err']:.3e} (bound "
        f"{e['max_abs_bound']:.3e} = min({TOL}, {MAX_ERR_REL} x max|plain| "
        f"{e['max_abs_plain']:.3e}){' + 1 bf16 ulp' if ulp_allowance else ''})"
        f"  rel_rmse {e['rel_rmse']:.3e} (bound "
        f"{RMSE_REL})  kernel {ms:.4f} ms (events over Python launches "
        f"{ev_ms:.4f})  plain {plain_ms:.4f} ms  "
        f"library{library_label} "
        f"{lib_ms if lib_ms is None else round(lib_ms, 4)} ms  "
        f"bound {work['bound_ms']:.4f} ms ({work['bound_by']}: "
        f"{work['gflop']:.2f} GFLOP, {work['mbytes']:.1f} MB); achieved "
        f"{work['gflop'] / ms:.1f} TFLOP/s, {work['bound_ms'] / ms:.1%} of "
        f"the bound")
    if not e["ok"]:
        raise AssertionError(f"{name}: kernel disagrees with plain: {e}")
    results.append(dict(shape=name, max_abs_err=e["max_abs_err"], ms=ms,
                        plain_ms=plain_ms, library_ms=lib_ms,
                        bound_ms=work["bound_ms"], bound_by=work["bound_by"]))


def sa_work(shape) -> dict:
    b, n, h, dh = shape
    return bound(4.0 * b * h * n * n * dh, 4.0 * b * n * h * dh * 2)


def sdpa_sa(q, k, v):
    """The library yardstick of K1: one scaled_dot_product_attention call
    on the same tensors in its [B, H, N, Dh] layout."""
    import torch.nn.functional as F
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    return lambda: F.scaled_dot_product_attention(qt, kt, vt)


def ca_allowed(labels, q_self, q_upper, kv_len, ext=None):
    """bool [B, G, kv_len]: the keys each image of the step attends."""
    lab = labels[:, None, :kv_len]
    a = (lab >= 0) & (lab != q_self[..., None]) & (lab < q_upper[..., None])
    if ext is not None:
        a = a & ~ext[:, :, :kv_len]
    return a


def ca_work(q, labels, q_self, q_upper, kv_len, ext=None, stats=False,
            n_mm=2, n_act=2, key_bytes=None) -> dict:
    """Operations and bytes of a CA kernel at this run's data: n_mm products
    of Dh per (query row, head, attended key); n_act [B, G, N, H, Dh]
    activations read or written (q, out; q, dO, dq; ...); key_bytes per
    (key, head) of the cache (bf16 k|v by default; an 8-bit cache: 2 * Dh
    codes and its two fp32 scales)."""
    b, g, n, h, dh = q.shape
    key_bytes = 2 * dh * 2 if key_bytes is None else key_bytes
    pairs = float(ca_allowed(labels, q_self, q_upper, kv_len, ext).sum())
    nbytes = (n_act * q.numel() * 2 + b * h * kv_len * key_bytes
              + b * kv_len * 4 + 2 * b * g * 4
              + (0 if ext is None else b * g * kv_len)
              + (b * g * h * n * 4 if stats else 0))
    return pairs, nbytes, bound(2.0 * n_mm * pairs * n * h * dh, nbytes)


def sdpa_ca(q, kv, labels, q_self, q_upper, kv_len, ext=None,
            backward_of=None):
    """The library yardstick of a CA kernel: scaled_dot_product_attention
    with the boolean mask of the label predicate (and the dropout mask),
    the G images as batch entries. With ``backward_of`` = dO, the timed call
    is the backward alone (dq, dk, dv from a kept graph)."""
    import torch.nn.functional as F
    b, g, n, h, dh = q.shape
    qt = q.permute(0, 1, 3, 2, 4).reshape(b * g, h, n, dh).contiguous()
    kv_l = kv[:, :, :kv_len]
    kt, vt = (t[:, None].expand(b, g, h, kv_len, dh).reshape(
        b * g, h, kv_len, dh).contiguous()
        for t in (kv_l[..., :dh], kv_l[..., dh:]))
    mask = ca_allowed(labels, q_self, q_upper, kv_len, ext).reshape(
        b * g, 1, 1, kv_len)
    if backward_of is None:
        return lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                      attn_mask=mask)
    leaves = [t.requires_grad_() for t in (qt, kt, vt)]
    # autograd runs each backward op on its forward's stream: the forward
    # runs on the stream that device_ms captures on
    stream = capture_stream(q.device)
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        out = F.scaled_dot_product_attention(*leaves, attn_mask=mask)
    stream.synchronize()
    dot = backward_of.permute(0, 1, 3, 2, 4).reshape(b * g, h, n, dh
                                                       ).contiguous()
    return lambda: torch.autograd.grad(out, leaves, dot, retain_graph=True)


def phase_kernels(dev):
    from must3r_tpu_torch.ops.attention import (INT32_MAX,
                                                memory_cross_attention,
                                                self_attention)

    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev
                           ).to(torch.bfloat16)

    sa, ca = [], []
    for shape in [(10, 768, 16, 64), (10, 768, 12, 64), (1, 768, 12, 64),
                  (2, 196, 12, 64)]:
        q, k, v = randn(*shape), randn(*shape), randn(*shape)
        _compare(f"sa {list(shape)}",
                 lambda: self_attention(q, k, v, impl=None),
                 lambda: self_attention(q, k, v, impl="plain"), sa,
                 sa_work(shape), sdpa_sa(q, k, v))

    # the memory of a 10-view collection: 12 layers, 8192 slots, 7680 live
    cache = randn(12, 1, 12, 8192, 128)
    lab10 = torch.full((1, 8192), -1, dtype=torch.int32, device=dev)
    lab10[0, :7680] = torch.arange(7680, dtype=torch.int32, device=dev) // 768
    lab2 = torch.where(lab10 < 2, lab10, -1)

    def ca_case(name, g, n, labels, q_self, q_upper, kv_len, layer=5):
        q = randn(1, g, n, 12, 64)
        qs = torch.tensor([q_self], dtype=torch.int32, device=dev)
        qu = torch.tensor([q_upper], dtype=torch.int32, device=dev)

        def run(impl):
            return memory_cross_attention(q, cache, labels, qs, qu, kv_len,
                                          layer=layer, impl=impl)
        lab = labels[:, :cache.shape[3]]
        _compare(name, lambda: run(None), lambda: run("plain"), ca,
                 ca_work(q, lab, qs, qu, kv_len)[2],
                 sdpa_ca(q, cache[layer], lab, qs, qu, kv_len))

    ca_case("ca update [1,1,768,12,64] kv_len 7680", 1, 768, lab10, [9],
            [INT32_MAX], 7680)
    ca_case("ca init [1,2,768,12,64] kv_len 1536", 2, 768, lab2, [0, 1],
            [INT32_MAX, INT32_MAX], 1536)
    ca_case("ca render [1,1,7680,12,64] kv_len 7680", 1, 7680, lab10, [-2],
            [INT32_MAX], 7680)

    # rows that attend nothing are 0: every live slot carries the query's
    # own label, or the memory is empty
    q = randn(1, 2, 100, 12, 64)
    only9 = torch.where(lab10 == 9, lab10, -1)
    qs = torch.tensor([[9, -2]], dtype=torch.int32, device=dev)
    qu = torch.full((1, 2), INT32_MAX, dtype=torch.int32, device=dev)
    out = memory_cross_attention(q, cache, only9, qs, qu, 7680, layer=0,
                                 impl=None)
    empty = memory_cross_attention(q, cache, lab10, qs, qu, 0, layer=0,
                                   impl=None)
    sync()
    masked_max = float(out[:, 0].abs().max())
    empty_max = float(empty.abs().max())
    log(f"[B] fully-masked rows: max |out| {masked_max} (labels), "
        f"{empty_max} (kv_len 0); attended image max |out| "
        f"{float(out[:, 1].abs().max()):.3e}")
    if masked_max != 0.0 or empty_max != 0.0:
        raise AssertionError("fully-masked CA rows must be exactly 0")
    if not torch.isfinite(out).all():
        raise AssertionError("CA kernel output has NaN/Inf")
    sync()
    return sa, ca


# ---------------------------------------------------------------------------
# B'. the training kernels vs plain
# ---------------------------------------------------------------------------

# The LSE is m + log(l) of fp32 scores of bf16 inputs; kernel and plain sum
# them in another order, which moves it by a few fp32 ulps of |lse| ~ 5-10
# (far below 1e-2), while a wrong mask or scale moves it by O(1).
LSE_TOL = 1e-2


def train_case(dev, gen, b, g, n, n_imgs, per_img, q_self, q_upper, ext_p,
               s_extra=0):
    """A CA call of the training path: a memory of ``n_imgs`` images of
    ``per_img`` tokens each (labels 0..n_imgs-1), kv of the out-of-place
    training cache ([B, H, kv_len, 128], plus ``s_extra`` dead slots), the
    step's masks and a token-dropout mask drawn at ``ext_p``."""
    from must3r_tpu_torch.ops import attention as tatt

    kv_len = n_imgs * per_img
    s_cap = kv_len + s_extra

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev
                           ).to(torch.bfloat16)

    q, dout = randn(b, g, n, 12, 64), randn(b, g, n, 12, 64)
    kv = randn(b, 12, s_cap, 128)
    labels = torch.full((b, s_cap), -1, dtype=torch.int32, device=dev)
    labels[:, :kv_len] = torch.arange(kv_len, dtype=torch.int32,
                                      device=dev) // per_img
    qs = torch.tensor([q_self] * b, dtype=torch.int32, device=dev)
    qu = torch.tensor([q_upper] * b, dtype=torch.int32, device=dev)
    ext = None
    if ext_p:
        ext = torch.rand(b, g, s_cap, generator=gen, device=dev) < ext_p
    out, lse = tatt._ca_plain(q, kv[..., :64], kv[..., 64:], labels, qs, qu,
                              kv_len, ext, return_stats=True)
    delta = (dout.float() * out.float()).sum(-1).permute(0, 1, 3, 2
                                                         ).contiguous()
    return dict(q=q, kv=kv, labels=labels, qs=qs, qu=qu, kv_len=kv_len,
                ext=ext, dout=dout, lse=lse, delta=delta)


def _check_out(name, got, want, bound_fn=kernel_error):
    e = bound_fn(got, want)
    log(f"[B'] {name}: max_abs_err {e['max_abs_err']:.3e} (bound "
        f"{e['max_abs_bound']:.3e})  rel_rmse {e['rel_rmse']:.3e} (bound "
        f"{RMSE_REL})")
    if not e["ok"]:
        raise AssertionError(f"{name}: kernel disagrees with plain: {e}")
    return e["max_abs_err"]


def phase_train_kernels(dev):
    """K2 with LSE and dropout mask, K3 + K4 and K5 against their plain
    versions at the training path's shapes, with times of kernel, plain
    version and the scaled_dot_product_attention yardstick."""
    from must3r_tpu_torch.ops import _kernels
    from must3r_tpu_torch.ops import attention as tatt
    from must3r_tpu_torch.ops.attention import INT32_MAX

    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    rec = {k: [] for k in ("ca_fwd_train", "ca_bwd_dq", "ca_bwd_dkv",
                           "ca_bwd_fused")}
    cases = [
        # name, b, g, n, n_imgs, per_img, q_self, q_upper, ext_p
        ("512 update 4th view [2,1,768] vs 3072 keys", 2, 1, 768, 4, 768,
         [3], [3], 0.1),
        ("512 render [2,1,1536] vs 3072 keys", 2, 1, 1536, 4, 768,
         [-2], [INT32_MAX], 0.0),
        ("512 init pair [2,2,768] vs 1536 keys", 2, 2, 768, 2, 768,
         [-2, 1], [2, 1], 0.1),
        ("224 last block [1,5,196] vs 3920 keys", 1, 5, 196, 20, 196,
         [15, 16, 17, 18, 19], [15, 16, 17, 18, 19], 0.1),
    ]
    for name, b, g, n, n_imgs, per_img, qs, qu, p in cases:
        c = train_case(dev, gen, b, g, n, n_imgs, per_img, qs, qu, p)
        q, kv, lab, kv_len, ext = (c["q"], c["kv"], c["labels"],
                                   c["kv_len"], c["ext"])
        cq = (q, kv, lab, c["qs"], c["qu"], kv_len)
        args = (*cq, c["lse"], c["delta"], c["dout"], ext)
        pairs, _, w_fwd = ca_work(q, lab, c["qs"], c["qu"], kv_len, ext,
                                  stats=True)

        # forward with LSE (and the dropout mask)
        out, lse = _kernels.ca_fwd(*cq, ext=ext, return_stats=True)
        want_out, want_lse = tatt._ca_plain(q, kv[..., :64], kv[..., 64:],
                                            lab, c["qs"], c["qu"], kv_len,
                                            ext, return_stats=True)
        sync()
        err = _check_out(f"ca_fwd+lse {name}", out, want_out)
        lse_err = float((lse - want_lse).abs().max())
        log(f"[B'] ca_fwd+lse {name}: lse max_abs_err {lse_err:.3e} (bound "
            f"{LSE_TOL}); {pairs:.4g} attended (image, key) pairs")
        if not lse_err <= LSE_TOL:
            raise AssertionError(f"{name}: LSE off by {lse_err}")
        rec["ca_fwd_train"].append(dict(
            shape=name, max_abs_err=err,
            ms=device_ms(lambda: _kernels.ca_fwd(*cq, ext=ext,
                                                 return_stats=True)),
            plain_ms=events_ms(lambda: tatt._ca_plain(
                q, kv[..., :64], kv[..., 64:], lab, c["qs"], c["qu"], kv_len,
                ext, return_stats=True), 3),
            library_ms=device_ms(sdpa_ca(q, kv, lab, c["qs"], c["qu"],
                                         kv_len, ext)),
            **{k: w_fwd[k] for k in ("bound_ms", "bound_by")}))
        r = rec["ca_fwd_train"][-1]
        ev = events_ms(lambda: _kernels.ca_fwd(*cq, ext=ext,
                                               return_stats=True))
        log(f"[B'] ca_fwd+lse {name}: kernel {r['ms']:.4f} ms (events over "
            f"Python launches {ev:.4f})  plain "
            f"{r['plain_ms']:.4f} ms  library (sdpa, boolean mask) "
            f"{r['library_ms']:.4f} ms  bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']})")

        # backward: K3 + K4 and K5 against the plain versions
        want_dq = tatt._ca_bwd_dq_plain(*args)
        want_dkv = tatt._ca_bwd_dkv_plain(*args)
        dq, dkv = _kernels.ca_bwd_dq(*args), _kernels.ca_bwd_dkv(*args)
        dq5, dkv5 = _kernels.ca_bwd_fused(*args)
        sync()
        errs = {}
        for tag, (gq, gkv) in (("K3/K4", (dq, dkv)), ("K5", (dq5, dkv5))):
            errs[tag] = [
                _check_out(f"{tag} dq {name}", gq, want_dq),
                _check_out(f"{tag} dk {name}", gkv[..., :64],
                           want_dkv[..., :64]),
                _check_out(f"{tag} dv {name}", gkv[..., 64:],
                           want_dkv[..., 64:])]
        lib_bwd = sdpa_ca(q, kv, lab, c["qs"], c["qu"], kv_len, ext,
                          backward_of=c["dout"])
        lib_ms = device_ms(lib_bwd)
        for key, fn, plain_fn, n_mm, n_act, e in (
                ("ca_bwd_dq", lambda: _kernels.ca_bwd_dq(*args),
                 lambda: tatt._ca_bwd_dq_plain(*args), 3, 3,
                 errs["K3/K4"][0]),
                ("ca_bwd_dkv", lambda: _kernels.ca_bwd_dkv(*args),
                 lambda: tatt._ca_bwd_dkv_plain(*args), 4, 2,
                 max(errs["K3/K4"][1:])),
                ("ca_bwd_fused", lambda: _kernels.ca_bwd_fused(*args),
                 lambda: tatt._ca_bwd_fused_plain(*args), 5, 3,
                 max(errs["K5"]))):
            _, nbytes, w = ca_work(q, lab, c["qs"], c["qu"], kv_len, ext,
                                   stats=True, n_mm=n_mm, n_act=n_act)
            if key != "ca_bwd_dq":      # dK|dV written for every slot
                w = bound(w["gflop"] * 1e9,
                          nbytes + kv.numel() * 2 + c["delta"].numel() * 4)
            else:
                w = bound(w["gflop"] * 1e9, nbytes + c["delta"].numel() * 4)
            rec[key].append(dict(
                shape=name, max_abs_err=e, ms=device_ms(fn),
                plain_ms=events_ms(plain_fn, 3), library_ms=lib_ms,
                bound_ms=w["bound_ms"], bound_by=w["bound_by"]))
            r = rec[key][-1]
            log(f"[B'] {key} {name}: kernel {r['ms']:.4f} ms (events over "
                f"Python launches {events_ms(fn):.4f})  plain "
                f"{r['plain_ms']:.4f} ms  library (sdpa backward, dq+dk+dv) "
                f"{lib_ms:.4f} ms  bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']}); achieved {w['gflop'] / r['ms']:.1f} "
                f"TFLOP/s, {r['bound_ms'] / r['ms']:.1%} of the bound")
        ms = {k: rec[k][-1]["ms"] for k in ("ca_bwd_dq", "ca_bwd_dkv",
                                            "ca_bwd_fused")}
        route = ("K5" if tatt._fold_stripe(g, n) is not None
                 else "K3 + K4")
        log(f"[B'] routing {name}: K3 + K4 "
            f"{ms['ca_bwd_dq'] + ms['ca_bwd_dkv']:.4f} ms "
            f"({ms['ca_bwd_dq']:.4f} + {ms['ca_bwd_dkv']:.4f}) against K5 "
            f"{ms['ca_bwd_fused']:.4f} ms, SDPA's backward {lib_ms:.4f} ms; "
            f"_fold_stripe sends this shape to {route}")

    # a query image that attends nothing gets dq = 0 and adds nothing to
    # dK|dV; slots at or past kv_len get dK|dV = 0 exactly
    c = train_case(dev, gen, 2, 2, 300, 3, 300, [-2, 0], [1, 1], 0.0,
                   s_extra=200)
    dout = c["dout"].clone()
    dout[:, 0] = 0                              # gradient into image 1 only
    if not bool((c["lse"][:, 1] == tatt.EMPTY_LSE).all()):
        raise AssertionError("the empty image's LSE is not +1e30")
    args = (c["q"], c["kv"], c["labels"], c["qs"], c["qu"], c["kv_len"],
            c["lse"], torch.zeros_like(c["delta"]), dout, None)
    dq5, dkv5 = _kernels.ca_bwd_fused(*args)
    for t in (_kernels.ca_bwd_dq(*args), _kernels.ca_bwd_dkv(*args), dq5,
              dkv5):
        if not (torch.isfinite(t).all() and float(t.abs().max()) == 0.0):
            raise AssertionError("an image that attends nothing must get "
                                 "zero gradients")
    args = (*args[:7], c["delta"], c["dout"], None)
    for name, dkv in (("K4", _kernels.ca_bwd_dkv(*args)),
                      ("K5", _kernels.ca_bwd_fused(*args)[1])):
        dead, live = dkv[:, :, c["kv_len"]:], dkv[:, :, :300]
        if float(dead.abs().max()) != 0.0 or float(live.abs().max()) == 0.0:
            raise AssertionError(f"{name}: slots past kv_len must get "
                                 f"exactly 0 (and attended ones not)")
    sync()
    log("[B'] an image that attends nothing: dq = dK|dV = 0 from K3, K4, K5; "
        "slots past kv_len: dK|dV exactly 0 from K4, K5")
    return rec


# ---------------------------------------------------------------------------
# B''. K2(d), the 8-bit cache read, vs plain
# ---------------------------------------------------------------------------

Q8_FORMATS = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}


def _fill_codes(codes, value):
    """Every code of ``codes`` (int8 / fp8) <- the code of ``value``."""
    byte = torch.tensor([value]).to(codes.dtype).view(torch.uint8)
    codes.view(torch.uint8).fill_(int(byte))


def phase_q8_kernels(dev):
    """K2(d) against its plain version for int8 and fp8 caches: the render
    and the update of a 10-view collection, a masked step (q_self, q_upper,
    dropout mask, kv_len < S with the largest codes and scales of 1e30 past
    it), a row that attends nothing, and the LSE at the update shape. Times
    of the kernel, the plain version and the library yardstick (SDPA on the
    dequantized bf16 cache with the boolean mask)."""
    from must3r_tpu_torch.memory import dequantize_kv, quantize_kv
    from must3r_tpu_torch.ops import _kernels
    from must3r_tpu_torch.ops import attention as tatt
    from must3r_tpu_torch.ops.attention import INT32_MAX

    gen = torch.Generator(device=dev).manual_seed(SEED + 5)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev
                           ).to(torch.bfloat16)

    lab10 = torch.full((1, 8192), -1, dtype=torch.int32, device=dev)
    lab10[0, :7680] = torch.arange(7680, dtype=torch.int32, device=dev) // 768
    rows = []
    for fmt, qdtype in Q8_FORMATS.items():
        # two layers of a 10-view memory, 8192 slots, 7680 live
        codes, scale = quantize_kv(randn(2, 1, 12, 8192, 128), qdtype)
        deq = dequantize_kv(codes[1], scale[1], torch.bfloat16)

        def case(name, g, n, q_self, q_upper, kv_len, ext=None):
            q = randn(1, g, n, 12, 64)
            qs = torch.tensor([q_self], dtype=torch.int32, device=dev)
            qu = torch.tensor([q_upper], dtype=torch.int32, device=dev)

            def run(impl):
                return tatt.memory_cross_attention(
                    q, codes, lab10, qs, qu, kv_len, extra_mask=ext,
                    layer=1, impl=impl, kv_scale=scale)
            _compare(f"ca_q8 {fmt} {name}", lambda: run(None),
                     lambda: run("plain"), rows,
                     ca_work(q, lab10, qs, qu, kv_len, ext,
                             key_bytes=2 * 64 + 8)[2],
                     sdpa_ca(q, deq, lab10, qs, qu, kv_len, ext))
            return run

        case("render [1,1,7680,12,64] vs 7680 keys", 1, 7680, [-2],
             [INT32_MAX], 7680)
        case("update [1,1,768,12,64] vs 7680 keys", 1, 768, [9],
             [INT32_MAX], 7680)
        ext = torch.rand(1, 2, 8192, generator=gen, device=dev) < 0.1
        run = case("masked [1,2,768] q_self/q_upper/ext vs kv_len 5000",
                   2, 768, [3, -2], [INT32_MAX, 5], 5000, ext)
        before = run(None)
        saved = codes[1, :, :, 5000:].clone(), scale[1, ..., 5000:].clone()
        _fill_codes(codes[1, :, :, 5000:], 448.0 if fmt == "fp8" else 127.0)
        scale[1, ..., 5000:] = 1e30
        after = run(None)
        sync()
        codes[1, :, :, 5000:], scale[1, ..., 5000:] = saved
        if not (torch.isfinite(after).all() and torch.equal(before, after)):
            raise AssertionError(f"ca_q8 {fmt}: slots past kv_len were read")
        # rows that attend nothing are 0
        only9 = torch.where(lab10 == 9, lab10, -1)
        qs = torch.tensor([[9, -2]], dtype=torch.int32, device=dev)
        qu = torch.full((1, 2), INT32_MAX, dtype=torch.int32, device=dev)
        out = tatt.memory_cross_attention(randn(1, 2, 100, 12, 64), codes,
                                          only9, qs, qu, 7680, layer=1,
                                          kv_scale=scale)
        sync()
        if float(out[:, 0].abs().max()) != 0.0 or \
                not torch.isfinite(out).all():
            raise AssertionError(f"ca_q8 {fmt}: a row that attends nothing "
                                 "must be exactly 0")
        # STATS at the update shape
        q = randn(1, 1, 768, 12, 64)
        qs, qu = qs[:, :1].contiguous(), qu[:, :1].contiguous()
        got, lse = _kernels.ca_fwd_q8(q, codes[1], scale[1], lab10, qs, qu,
                                      7680, return_stats=True)
        want, want_lse = tatt._ca_q8_plain(q, codes[1], scale[1], lab10, qs,
                                           qu, 7680, return_stats=True)
        sync()
        e = kernel_error(got, want)
        lse_err = float((lse - want_lse).abs().max())
        log(f"[B''] ca_q8 {fmt}: slots past kv_len never read (outputs "
            f"bitwise equal with the largest codes and scales 1e30 there); "
            f"a row that attends nothing = 0; with lse at the update shape: "
            f"max_abs_err {e['max_abs_err']:.3e} (bound "
            f"{e['max_abs_bound']:.3e}), rel_rmse {e['rel_rmse']:.3e}, lse "
            f"max_abs_err {lse_err:.3e} (bound {LSE_TOL})")
        if not (e["ok"] and lse_err <= LSE_TOL):
            raise AssertionError(f"ca_q8 {fmt} with lse: {e}, lse {lse_err}")
        del codes, scale, deq
    sync()
    return rows


# ---------------------------------------------------------------------------
# B'''. the fp8 probe (B7)
# ---------------------------------------------------------------------------

def phase_probe(dev):
    """The fp8 probe's kernels against their plain versions at its shapes
    (the conversion exact, the dot within fp32 summation noise), timed; then
    the probe's entry point as its users run it, with the launch counts set
    to 0 just before and read just after."""
    from must3r_tpu_torch.ops import fp8
    from must3r_tpu_torch.tools import probe_fp8

    x, w = probe_fp8.probe_inputs(dev)
    r = probe_fp8.run(dev)
    log(f"[B'''] fp8 -> bf16 x 2: max_abs_err {r['conv_max_abs_err']} "
        f"(exact: {r['conv_ok']}); fp8 dequant dot: max_abs_err "
        f"{r['dot_max_abs_err']:.3e} (bound {r['dot_bound']:.3e})")
    if not (r["conv_ok"] and r["dot_ok"]):
        raise AssertionError(f"fp8 probe kernels disagree: {r}")
    (m, k), n = x.shape, w.shape[1]
    rec = {}
    # the library: the fewest PyTorch calls of each function (e4m3 -> fp32
    # is exact, as e4m3 -> bf16 is)
    for name, kern, plain, library, err, work in (
            ("fp8_to_bf16_x2", lambda: fp8.fp8_to_bf16_x2(x),
             lambda: fp8.fp8_to_bf16_x2(x, impl="plain"),
             lambda: x.to(torch.bfloat16) * 2,
             r["conv_max_abs_err"], bound(m * k, m * k * (1 + 2))),
            ("fp8_dequant_dot", lambda: fp8.fp8_dequant_dot(x, w),
             lambda: fp8.fp8_dequant_dot(x, w, impl="plain"),
             lambda: torch.matmul(x.float(), w.float()),
             r["dot_max_abs_err"],
             bound(2.0 * m * k * n, m * k + k * n * 2 + m * n * 4))):
        rec[name] = dict(max_abs_err=err, ms=device_ms(kern, 50),
                         plain_ms=events_ms(plain, 50),
                         library_ms=device_ms(library, 50),
                         bound_ms=work["bound_ms"],
                         bound_by=work["bound_by"])
        log(f"[B'''] {name} {list(x.shape)}: kernel {rec[name]['ms']:.4f} ms"
            f" (events over Python launches {events_ms(kern, 50):.4f})"
            f"  plain {rec[name]['plain_ms']:.4f} ms  library "
            f"{rec[name]['library_ms']:.4f} ms (kernel / library "
            f"{rec[name]['ms'] / rec[name]['library_ms']:.2f})  bound "
            f"{work['bound_ms']:.6f} ms ({work['bound_by']})")
    _, counts = _counted(lambda: probe_fp8.main(["--device", str(dev)]))
    log(f"[B'''] python -m must3r_tpu_torch.tools.probe_fp8: launches "
        f"{counts}")
    if counts["fp8_to_bf16_x2"] != 1 or counts["fp8_dequant_dot"] != 1:
        raise AssertionError(f"the probe did not run its kernels: {counts}")
    return rec, counts


# ---------------------------------------------------------------------------
# B''''. the microbenchmark kernels: K6 (two heads per block), K7 (LN+matmul)
# ---------------------------------------------------------------------------

# name, N, S, kv_len: the parity cases of scripts/bench_ca_kernel.py
B6_CASES = [("render_10v_512", 7680, 7680, 7680),
            ("update_1v_64kf", 768, 49152, 49152),
            ("partial_fill", 768, 49152, 9216)]
# name, M (rows padded to 256), N: the cases of scripts/bench_fused_chain.py
B8_CASES = [("update_qkv", 1024, 2304), ("render_qkv", 3072, 2304),
            ("update_mlp_in", 1024, 3072)]
LN_K = 768


def phase_bench_kernels(dev):
    """K6 against its plain version and against K2 at the three B6 cases (q
    [1, 1, N, 12, 64], a 12-layer cache of S slots, layer 3, labels 0 below
    kv_len and -1 past it), K7 against its plain version at the three B8
    cases (x [M, 768], random g and b, bound + 1 bf16 ulp), each timed beside
    its library yardstick (and K7 beside ``torch.matmul`` alone); then both
    bench tools' main(), each with the launch counts set to 0 just before
    and read just after: they must equal the tools' schedules."""
    import torch.nn.functional as F

    from must3r_tpu_torch.ops import bench_kernels as bk
    from must3r_tpu_torch.ops.attention import (INT32_MAX,
                                                memory_cross_attention)
    from must3r_tpu_torch.tools import bench_ca_kernel, bench_fused_chain

    gen = torch.Generator(device=dev).manual_seed(SEED + 7)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale
                ).to(torch.bfloat16)

    rows_2h, rows_ln = [], []
    layer = 3
    for name, n, s_cap, kv_len in B6_CASES:
        q = randn(1, 1, n, 12, 64)
        cache = randn(12, 1, 12, s_cap, 128)
        labels = torch.where(torch.arange(s_cap, device=dev) < kv_len, 0,
                             -1)[None].to(torch.int32)
        qs = torch.full((1, 1), -1, dtype=torch.int32, device=dev)
        qu = torch.full((1, 1), INT32_MAX, dtype=torch.int32, device=dev)

        def k6(impl=None):
            return bk.memory_cross_attention_2h(q, cache, labels, kv_len,
                                                layer, impl=impl)

        def k2():
            return memory_cross_attention(q, cache, labels, qs, qu, kv_len,
                                          layer=layer)
        e = kernel_error(k6(), k2())
        tag = f"ca_fwd_2h {name} [1,1,{n},12,64] vs {kv_len} of {s_cap} keys"
        _compare(tag, k6, lambda: k6("plain"), rows_2h,
                 ca_work(q, labels, qs, qu, kv_len)[2],
                 sdpa_ca(q, cache[layer], labels, qs, qu, kv_len),
                 tag="B''''", library_label=" (sdpa, boolean mask)")
        k2_ms = device_ms(k2)
        log(f"[B''''] {tag}: vs K2 max_abs_err {e['max_abs_err']:.3e} (bound "
            f"{e['max_abs_bound']:.3e}), rel_rmse {e['rel_rmse']:.3e}; K2 "
            f"{k2_ms:.4f} ms, K6 / K2 = {rows_2h[-1]['ms'] / k2_ms:.3f}")
        if not e["ok"]:
            raise AssertionError(f"{tag}: K6 disagrees with K2: {e}")
        rows_2h[-1]["k2_ms"] = k2_ms
        del q, cache

    for name, m, nout in B8_CASES:
        x = randn(m, LN_K)
        g = (1 + 0.1 * torch.randn(LN_K, generator=gen, device=dev)
             ).to(torch.bfloat16)
        b = randn(LN_K, scale=0.1)
        w = randn(LN_K, nout, scale=0.02)
        flops = 2.0 * m * LN_K * nout
        nbytes = (m * LN_K + 2 * LN_K + LN_K * nout + m * nout) * 2
        _compare(f"ln_matmul {name} [{m},{LN_K}]->{nout}",
                 lambda: bk.ln_matmul(x, g, b, w),
                 lambda: bk.ln_matmul(x, g, b, w, impl="plain"), rows_ln,
                 bound(flops, nbytes),
                 lambda: F.layer_norm(x, (LN_K,), g, b, bk.LN_EPS) @ w,
                 tag="B''''",
                 library_label=" (F.layer_norm + torch.matmul, two calls)",
                 ulp_allowance=True)
        r = rows_ln[-1]
        r["matmul_ms"] = device_ms(lambda: torch.matmul(x, w))
        log(f"[B''''] ln_matmul {name}: torch.matmul alone "
            f"{r['matmul_ms']:.4f} ms; K7 / matmul = "
            f"{r['ms'] / r['matmul_ms']:.3f}, K7 / library = "
            f"{r['ms'] / r['library_ms']:.3f}")

    # the bench tools as their users run them, counted
    per_timing = WARMUP + REPS
    runs = (
        ("bench_ca_kernel --check", lambda: bench_ca_kernel.main(
            ["--check", "--device", str(dev)]),
         {"ca_fwd": len(bench_ca_kernel.CASES) * per_timing,
          "ca_fwd_2h": len(bench_ca_kernel.CHECK_CASES)
          + len(bench_ca_kernel.CASES) * per_timing}),
        ("bench_fused_chain", lambda: bench_fused_chain.main(
            ["--device", str(dev)]),
         {"ln_matmul": len(bench_fused_chain.CASES) * (per_timing + 1)}))
    totals = {}
    for what, fn, want in runs:
        _, counts = _counted(fn)
        launched = {k: v for k, v in counts.items() if v}
        log(f"[B''''] python -m must3r_tpu_torch.tools.{what}: launches "
            f"{launched} (schedule {want})")
        if launched != want:
            raise AssertionError(f"{what}: launches {launched} != {want}")
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
    sync()
    return rows_2h, rows_ln, totals


# ---------------------------------------------------------------------------
# C. the slice
# ---------------------------------------------------------------------------

def expected_launches(enc_cfg, dec_cfg, n_views, fused, encode_bs=8,
                      render_bs=8, init=2):
    """(SA, CA) launches of one offline request at this schedule."""
    updates = 1 + max(n_views - init, 0)
    if fused:
        enc_calls, render_calls = 1, 1
    else:
        enc_calls = math.ceil(n_views / encode_bs)
        render_calls = math.ceil(n_views / render_bs)
    sa = (enc_calls * enc_cfg.depth + updates * dec_cfg.depth
          + render_calls * dec_cfg.depth)
    ca = (updates + render_calls) * dec_cfg.depth
    return sa, ca


def check_result(tag, out, n_views, hw):
    h, w = hw
    want = {"pts3d": (n_views, h, w, 3), "pts3d_local": (n_views, h, w, 3),
            "conf": (n_views, h, w), "focal": (n_views,),
            "c2w": (n_views, 4, 4)}
    for key, shape in want.items():
        t = torch.as_tensor(out[key])
        if tuple(t.shape) != shape:
            raise AssertionError(f"{tag} {key}: shape {tuple(t.shape)} != "
                                 f"{shape}")
        if not torch.isfinite(t).all():
            raise AssertionError(f"{tag} {key}: not finite")
    det = torch.linalg.det(torch.as_tensor(out["c2w"])[:, :3, :3].double())
    if float((det - 1).abs().max()) > 1e-3:
        raise AssertionError(f"{tag}: det(R) {det.tolist()}")


def make_views(imgs):
    """Request payloads as must3r_inference takes them (numpy, landscape)."""
    arr = imgs.float().cpu().numpy()
    return [{"img": arr[i], "true_shape": arr.shape[1:3], "portrait": False,
             "path": f"view{i}"} for i in range(arr.shape[0])]


def phase_slice(dev, enc_cfg, dec_cfg, n_views=N_VIEWS, hw=HW):
    from must3r_tpu_torch.checkpoint import init_model
    from must3r_tpu_torch.demo.inference import must3r_inference
    from must3r_tpu_torch.engine.inference import (InferenceCore,
                                                   make_fused_offline)
    from must3r_tpu_torch.ops.attention import (launch_counts,
                                                reset_launch_counts)

    t0 = time.perf_counter()
    enc, dec = init_model(enc_cfg, dec_cfg, seed=SEED, device=dev)
    core = InferenceCore(enc, dec, enc_cfg, dec_cfg, dtype=torch.bfloat16)
    plain = InferenceCore(enc, dec, enc_cfg, dec_cfg, dtype=torch.bfloat16,
                          impl="plain")
    sync()
    n_par = sum(p.numel() for m in (enc, dec) for p in m.parameters())
    log(f"[C] model: {n_par / 1e6:.1f} M params, init "
        f"{time.perf_counter() - t0:.1f} s")

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    imgs = torch.rand(3, n_views, *hw, 3, generator=gen, device=dev) * 2 - 1
    run = make_fused_offline(core, n_views, hw)
    run_plain = make_fused_offline(plain, n_views, hw)

    def infer(c, x):
        scene = must3r_inference(c, make_views(x), num_mem_images=n_views,
                                 is_sequence=True)
        return {"pts3d": scene.pts3d, "pts3d_local": scene.pts3d_local,
                "conf": scene.conf, "focal": scene.focals,
                "c2w": scene.cams2world}

    requests = [("fused collection 0", lambda: run(imgs[0]), True),
                ("fused collection 1", lambda: run(imgs[1]), True),
                ("must3r_inference collection 2", lambda: infer(core, imgs[2]),
                 False)]
    plain_requests = [lambda: run_plain(imgs[0]), lambda: run_plain(imgs[1]),
                      lambda: infer(plain, imgs[2])]

    # the counted run of the main path: three requests
    sync()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    outs, secs, per_request = [], [], []
    for tag, fn, fused in requests:
        before = launch_counts()
        t0 = time.perf_counter()
        outs.append(fn())
        sync()
        secs.append(time.perf_counter() - t0)
        after = launch_counts()
        per_request.append({k: after[k] - before[k] for k in after})
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()

    for (tag, _, fused), moved, s in zip(requests, per_request, secs):
        want = expected_launches(enc_cfg, dec_cfg, n_views, fused)
        log(f"[C] {tag}: {s * 1e3:.1f} ms, launches {moved} "
            f"(expected sa_fwd {want[0]}, ca_fwd {want[1]})")
        if (moved["sa_fwd"], moved["ca_fwd"]) != want:
            raise AssertionError(f"{tag}: launches {moved} != {want}")

    for (tag, _, _), out, fn in zip(requests, outs, plain_requests):
        check_result(tag, out, n_views, hw)
        ref = fn()
        sync()
        errs = {k: rel_rmse(torch.as_tensor(out[k]), torch.as_tensor(ref[k]))
                for k in ("pts3d", "pts3d_local")}
        log(f"[C] {tag}: relative RMSE vs plain {errs}")
        for k, e in errs.items():
            if not e <= RMSE_TOL:
                raise AssertionError(f"{tag} {k}: relative RMSE {e} > "
                                     f"{RMSE_TOL}")

    # throughput of the fused request, kernels vs plain, in turns
    times = {"kernel": [], "plain": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        fn = run if which == "kernel" else run_plain
        sync()
        t0 = time.perf_counter()
        fn(imgs[1])
        sync()
        times[which].append(time.perf_counter() - t0)
    vps = {k: n_views / (sum(v) / len(v)) for k, v in times.items()}
    log(f"[C] fused offline {hw[1]}x{hw[0]} {n_views} views: "
        f"{vps['kernel']:.2f} views/s with kernels, {vps['plain']:.2f} "
        f"views/s plain (host clock, warm, mean of 2 each)")
    log(f"[C] peak device memory over the three requests: "
        f"{peak / 2**30:.2f} GiB")
    sync()
    return counts


# ---------------------------------------------------------------------------
# D. the training path
# ---------------------------------------------------------------------------

LOSS_TOL = 1e-2       # relative: kernel step's loss vs the plain step's
GRAD_RMSE_TOL = 5e-2  # relative RMSE of the concatenated decoder gradient


def expected_train_launches(enc_cfg, dec_cfg, ts, n_tokens) -> dict:
    """Launches of one make_train_step call at this schedule. The frozen
    encoder: one SA per block. Each update step: per block one SA, and with
    remat (and a gradient) a second SA when the backward recomputes the
    block's projections; one CA forward (K2 with LSE); its backward K5
    where the JAX routing folds (G > 1, G x 128-aligned N <= 2048), else
    K3 + K4. The render (G folded into the CA's query axis): one SA and one
    CA per block, backward K3 + K4. The SA backward recomputes through the
    plain version (no kernel)."""
    from must3r_tpu_torch.ops.attention import _fold_stripe, launch_counts

    depth = dec_cfg.depth
    c = {k: 0 for k in launch_counts()}
    c["sa_fwd"] = enc_cfg.depth
    for i, g in enumerate(ts.mem_batches):
        grad = i >= ts.train_decoder_skip
        c["sa_fwd"] += depth * (2 if (grad and ts.remat) else 1)
        c["ca_fwd"] += depth
        if grad and _fold_stripe(g, n_tokens) is not None:
            c["ca_bwd_fused"] += depth
        elif grad:
            c["ca_bwd_dq"] += depth
            c["ca_bwd_dkv"] += depth
    if ts.n_render:
        for k in ("sa_fwd", "ca_fwd", "ca_bwd_dq", "ca_bwd_dkv"):
            c[k] += depth
    return c


def _counted(fn):
    """fn() with every launch count set to 0 just before; returns (result,
    counts just after)."""
    from must3r_tpu_torch.ops.attention import (launch_counts,
                                                reset_launch_counts)
    sync()
    reset_launch_counts()
    out = fn()
    sync()
    return out, launch_counts()


def _check_counts(tag, got, want):
    log(f"[D] {tag}: launches {got} (expected {want})")
    if got != want:
        raise AssertionError(f"{tag}: launches {got} != {want}")


def phase_train(dev, totals):
    """D1: three optimizer steps of MUSt3R_512 at 512x384 (batch 2, the
    TrainSettings defaults, dropout 0.1) with the launch counts of the
    schedule, and one step's loss and gradient against the plain attention.
    The Trainer: two steps on SyntheticScenes at 512x384, checkpoint save
    and resume. D2: the training recipe of bench.py (MUSt3R_224, 20 views
    in causal blocks of 5, 2 rendered, dropout 0.1, batch 1), steps/s."""
    import dataclasses
    import shutil
    import tempfile

    from must3r_tpu_torch import must3r_224_configs, must3r_512_configs
    from must3r_tpu_torch.checkpoint import init_model
    from must3r_tpu_torch.datasets import SyntheticScenes, get_data_loader
    from must3r_tpu_torch.engine.loop import Trainer, TrainLoopConfig
    from must3r_tpu_torch.engine.train import (TrainSettings,
                                               cast_frozen_params,
                                               cosine_schedule, make_loss_fn,
                                               make_optimizer,
                                               make_train_step,
                                               trainable_subset)
    from must3r_tpu_torch.tools.profile_train import \
        random_train_batch as train_batch

    def add(counts):
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v

    # -- D1 ------------------------------------------------------------------
    enc_cfg, dec_cfg = must3r_512_configs()
    dec_cfg = dataclasses.replace(dec_cfg, causal=True)
    enc, dec = init_model(enc_cfg, dec_cfg, seed=SEED, device=dev)
    params = {"encoder": enc, "decoder": dec}
    ts = TrainSettings(dropout_p=0.1)
    params = cast_frozen_params(params, ts)
    dec.requires_grad_(True)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    b, v = 2, sum(ts.mem_batches)
    batch = train_batch(dev, gen, b, v, HW, enc_cfg.patch_size, [v - 1, 1])
    n_tok = (HW[0] // enc_cfg.patch_size) * (HW[1] // enc_cfg.patch_size)

    losses, grads = {}, {}
    for impl in ("plain", None):
        loss_fn = make_loss_fn(enc_cfg, dec_cfg, ts, impl=impl)
        step_gen = torch.Generator(device=dev).manual_seed(SEED + 4)
        loss, _ = loss_fn(params, batch, step_gen)   # same dropout draws
        grads[impl] = torch.cat([
            (torch.zeros_like(p) if g is None else g).float().reshape(-1)
            for p, g in zip(dec.parameters(), torch.autograd.grad(
                loss, list(dec.parameters()), allow_unused=True))])
        losses[impl] = float(loss.detach())
    sync()
    loss_rel = abs(losses[None] / losses["plain"] - 1)
    grad_rmse = rel_rmse(grads[None], grads["plain"])
    log(f"[D1] one step, kernels vs plain: loss {losses[None]:.6f} vs "
        f"{losses['plain']:.6f} (relative {loss_rel:.3e}, bound {LOSS_TOL}); "
        f"decoder gradient relative RMSE {grad_rmse:.3e} (bound "
        f"{GRAD_RMSE_TOL}) over {grads[None].numel()} entries")
    if not (loss_rel <= LOSS_TOL and grad_rmse <= GRAD_RMSE_TOL):
        raise AssertionError("the kernel step disagrees with the plain one")
    del grads

    opt = make_optimizer(cosine_schedule(1e-4, 1, 1000), weight_decay=0.05)
    opt_state = opt.init(trainable_subset(params, ts))
    step = make_train_step(enc_cfg, dec_cfg, ts, opt)
    before = {k: p.detach().clone() for k, p in dec.named_parameters()}
    want = expected_train_launches(enc_cfg, dec_cfg, ts, n_tok)
    torch.cuda.reset_peak_memory_stats()
    for i in range(3):
        t0 = time.perf_counter()
        (params, opt_state, loss, _), counts = _counted(
            lambda: step(params, opt_state, batch, gen))
        ms = (time.perf_counter() - t0) * 1e3
        log(f"[D1] step {i}: loss {float(loss):.6f}, {ms:.1f} ms (host "
            f"clock, synced)")
        _check_counts(f"D1 step {i}", counts, want)
        add(counts)
        if not math.isfinite(float(loss)):
            raise AssertionError(f"D1 step {i}: loss {float(loss)}")
    moved = max(float((p.detach() - before[k]).abs().max())
                for k, p in dec.named_parameters())
    log(f"[D1] decoder params moved by up to {moved:.3e}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if not moved > 0:
        raise AssertionError("D1: the decoder did not change")
    del before, opt_state, step

    # -- the Trainer (the CLI's function) ------------------------------------
    out_dir = tempfile.mkdtemp(prefix="must3r_train_")
    try:
        ds = SyntheticScenes(num_views=4, resolutions=((512, 384),),
                             render_hw=(384, 512), epoch_size=4, seed=SEED)
        loader = get_data_loader(ds, 2, num_workers=2)
        cfg = TrainLoopConfig(epochs=1, batch_size=2, memory_num_views=4,
                              memory_batch_views=2, causal=True, lr=1e-4,
                              print_freq=1, output_dir=out_dir)
        t0 = time.perf_counter()
        trainer = Trainer(enc_cfg, dec_cfg, params, loader, cfg, ts,
                          device=dev)
        stats, counts = _counted(trainer.train)
        add(counts)
        log(f"[D] Trainer: 2 steps + 2 checkpoints in "
            f"{time.perf_counter() - t0:.1f} s, loss {stats['loss']:.6f}, "
            f"launches {counts}")
        if not (math.isfinite(stats["loss"]) and all(
                counts[k] for k in ("sa_fwd", "ca_fwd", "ca_bwd_dq",
                                    "ca_bwd_dkv", "ca_bwd_fused"))):
            raise AssertionError(f"Trainer run: {stats}, {counts}")
        saved = {k: t.clone() for k, t in dec.state_dict().items()}
        with torch.no_grad():
            for p in dec.parameters():
                p.add_(1.0)
        resumed = Trainer(enc_cfg, dec_cfg, params, loader, cfg, ts,
                          device=dev)
        ok = resumed.try_resume() and resumed.start_epoch == 1 and all(
            torch.equal(t, saved[k]) for k, t in dec.state_dict().items())
        log(f"[D] Trainer resume from {out_dir}/checkpoint-last: "
            f"{'restored' if ok else 'FAILED'}")
        if not ok:
            raise AssertionError("Trainer resume did not restore the state")
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    del params, enc, dec, trainer, resumed, saved
    torch.cuda.empty_cache()

    # -- D2 ------------------------------------------------------------------
    enc_cfg, dec_cfg = must3r_224_configs()
    dec_cfg = dataclasses.replace(dec_cfg, causal=True)
    enc, dec = init_model(enc_cfg, dec_cfg, seed=SEED, device=dev)
    ts = TrainSettings(mem_batches=(5, 5, 5, 5), n_render=2, dropout_p=0.1)
    params = cast_frozen_params({"encoder": enc, "decoder": dec}, ts)
    opt = make_optimizer(cosine_schedule(1e-4, 10, 1000), weight_decay=0.05)
    opt_state = opt.init(trainable_subset(params, ts))
    step = make_train_step(enc_cfg, dec_cfg, ts, opt)
    batch = train_batch(dev, gen, 1, 20, (224, 224), enc_cfg.patch_size,
                        [18, 19])
    params, opt_state, loss, _ = step(params, opt_state, batch, gen)  # warm
    sync()
    want = expected_train_launches(enc_cfg, dec_cfg, ts, 196)
    t0 = time.perf_counter()
    for i in range(2):
        (params, opt_state, loss, _), counts = _counted(
            lambda: step(params, opt_state, batch, gen))
        _check_counts(f"D2 step {i}", counts, want)
        add(counts)
    secs = time.perf_counter() - t0
    if not math.isfinite(float(loss)):
        raise AssertionError(f"D2: loss {float(loss)}")
    log(f"[D2] MUSt3R_224 20 views (causal blocks of 5, 2 rendered, dropout "
        f"0.1, bf16, batch 1): {2 / secs:.3f} steps/s ({secs / 2 * 1e3:.1f} "
        f"ms/step, host clock, synced, mean of 2 after 1 warm-up) on "
        f"{card_line()}")
    del params, enc, dec, opt_state, step
    torch.cuda.empty_cache()
    sync()


# ---------------------------------------------------------------------------
# E. the 8-bit cache, refinement, multi-aspect and video at full width
# ---------------------------------------------------------------------------

def expected_offline_launches(enc_cfg, dec_cfg, n_views, refine=0,
                              encode_bs=8, render_bs=8, init=2):
    """(SA, CA) launches of offline_reconstruction: encoder chunks, the
    update steps (again for each refinement pass), the render chunks."""
    steps = (1 + max(n_views - init, 0)) * (1 + refine)
    enc = math.ceil(n_views / encode_bs) * enc_cfg.depth
    render = math.ceil(n_views / render_bs)
    return (enc + (steps + render) * dec_cfg.depth,
            (steps + render) * dec_cfg.depth)


def _check_q8_counts(tag, counts, want):
    """An 8-bit request launches only K2(d) for its CA."""
    got = (counts["sa_fwd"], counts["ca_fwd_q8"], counts["ca_fwd"])
    log(f"[E] {tag}: launches sa_fwd {got[0]}, ca_fwd_q8 {got[1]}, ca_fwd "
        f"{got[2]} (expected {want[0]}, {want[1]}, 0)")
    if got != (*want, 0):
        raise AssertionError(f"{tag}: launches {got} != {(*want, 0)}")


def _vs_plain(tag, out, ref, keys=("pts3d", "pts3d_local")):
    errs = {k: rel_rmse(torch.as_tensor(out[k]), torch.as_tensor(ref[k]))
            for k in keys}
    log(f"[E] {tag}: relative RMSE vs plain {errs} (bound {RMSE_TOL})")
    for k, e in errs.items():
        if not e <= RMSE_TOL:
            raise AssertionError(f"{tag} {k}: relative RMSE {e} > {RMSE_TOL}")


def phase_q8_slice(dev, enc_cfg, dec_cfg, totals):
    """E1 the fused 10-view 512x384 collection with an int8 and an fp8
    memory; E2 offline_reconstruction with one refinement iteration; E3
    offline_reconstruction_multi_ar on 4 views at 512x384 and 4 at 512x288;
    E4 video_reconstruction (interval keyframes) on 16 frames with a working
    window of 6 and one refinement pass. Each counted run checks its
    launches (K2(d) for every CA, the bf16 K2 never), finite outputs and the
    same request with the plain attention."""
    from must3r_tpu_torch.checkpoint import init_model
    from must3r_tpu_torch.engine.inference import (
        InferenceCore, make_fused_offline, offline_reconstruction,
        offline_reconstruction_multi_ar)
    from must3r_tpu_torch.engine.video import video_reconstruction

    enc, dec = init_model(enc_cfg, dec_cfg, seed=SEED, device=dev)

    def core(kv_quant, impl=None):
        return InferenceCore(enc, dec, enc_cfg, dec_cfg, impl=impl,
                             kv_quant=kv_quant)

    def counted(fn):
        out, counts = _counted(fn)
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
        return out, counts

    n_tok = (HW[0] // dec_cfg.patch_size) * (HW[1] // dec_cfg.patch_size)
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    imgs = torch.rand(N_VIEWS, *HW, 3, generator=gen, device=dev) * 2 - 1
    bf16 = make_fused_offline(core(None), N_VIEWS, HW)(imgs)
    want = expected_launches(enc_cfg, dec_cfg, N_VIEWS, fused=True)
    for fmt in ("int8", "fp8"):
        t0 = time.perf_counter()
        out, counts = counted(
            lambda: make_fused_offline(core(fmt), N_VIEWS, HW)(imgs))
        ms = (time.perf_counter() - t0) * 1e3
        _check_q8_counts(f"E1 fused {fmt} collection ({ms:.1f} ms)", counts,
                         want)
        check_result(f"E1 {fmt}", out, N_VIEWS, HW)
        _vs_plain(f"E1 fused {fmt}", out, make_fused_offline(
            core(fmt, "plain"), N_VIEWS, HW)(imgs))
        gap = {k: rel_rmse(out[k], bf16[k]) for k in ("pts3d", "conf")}
        log(f"[E] E1 fused {fmt}: relative RMSE vs the bf16 memory {gap}")

    kw = dict(num_refinement_iterations=1, return_mem=True)
    t0 = time.perf_counter()
    (out, mem), counts = counted(
        lambda: offline_reconstruction(core("int8"), imgs, **kw))
    _check_q8_counts(f"E2 offline int8, 1 refinement iteration "
                     f"({(time.perf_counter() - t0) * 1e3:.1f} ms)", counts,
                     expected_offline_launches(enc_cfg, dec_cfg, N_VIEWS,
                                               refine=1))
    check_result("E2", out, N_VIEWS, HW)
    if (mem.length, mem.n_imgs) != (N_VIEWS * n_tok, N_VIEWS):
        raise AssertionError(f"E2: memory length {mem.length}, images "
                             f"{mem.n_imgs} after refinement")
    _vs_plain("E2 offline int8 refined", out, offline_reconstruction(
        core("int8", "plain"), imgs, num_refinement_iterations=1))
    del mem

    hw2 = (288, 512)
    imgs2 = torch.rand(4, *hw2, 3, generator=gen, device=dev) * 2 - 1
    views = make_views(imgs[:4]) + make_views(imgs2)
    t0 = time.perf_counter()
    res, counts = counted(
        lambda: offline_reconstruction_multi_ar(core("int8"), views))
    n2 = (hw2[0] // dec_cfg.patch_size) * (hw2[1] // dec_cfg.patch_size)
    want_sa = 2 * enc_cfg.depth + (7 + 2) * dec_cfg.depth
    _check_q8_counts(f"E3 multi-aspect int8, 4 x 512x384 + 4 x 512x288 "
                     f"({(time.perf_counter() - t0) * 1e3:.1f} ms)", counts,
                     (want_sa, (7 + 2) * dec_cfg.depth))
    ref = offline_reconstruction_multi_ar(core("int8", "plain"), views)
    for part, ids, hw in (("512x384", range(4), HW), ("512x288", range(4, 8),
                                                       hw2)):
        out = {k: torch.stack([torch.as_tensor(res[i][k]) for i in ids])
               for k in res[0]}
        check_result(f"E3 {part}", out, 4, hw)
        _vs_plain(f"E3 multi-aspect {part}", out, {
            k: torch.stack([torch.as_tensor(ref[i][k]) for i in ids])
            for k in ("pts3d", "pts3d_local")})
    log(f"[E] E3: {4 * n_tok + 4 * n2} tokens in one memory")

    n_frames = 16
    frames = torch.rand(n_frames, *HW, 3, generator=gen, device=dev) * 2 - 1
    kw = dict(local_context_size=6, num_refinement_iterations=1,
              return_mem=True)
    t0 = time.perf_counter()
    (out, mem), counts = counted(
        lambda: video_reconstruction(core("int8"), frames, **kw))
    steps = 2 * (1 + n_frames - 2)
    _check_q8_counts(f"E4 video int8, {n_frames} frames, window 6, 1 "
                     f"refinement pass ({(time.perf_counter() - t0) * 1e3:.1f}"
                     f" ms)", counts,
                     (2 * enc_cfg.depth + steps * dec_cfg.depth,
                      steps * dec_cfg.depth))
    check_result("E4", {k: v for k, v in out.items() if k != "keyframes"},
                 n_frames, HW)
    keyframes = sorted({0, 1} | set(range(0, n_frames, 3)))
    live = mem.labels[0][mem.labels[0] >= 0]
    log(f"[E] E4: keyframes {out['keyframes']}, final memory {live.numel()} "
        f"tokens of labels {sorted(set(live.tolist()))}")
    if out["keyframes"] != keyframes:
        raise AssertionError(f"E4 keyframes {out['keyframes']} != "
                             f"{keyframes}")
    if live.numel() != len(keyframes) * n_tok or \
            len(set(live.tolist())) != len(keyframes) or \
            mem.length != live.numel():
        raise AssertionError("E4: the final memory does not hold exactly "
                             "the keyframes' tokens")
    _vs_plain("E4 video int8 first pass", out, video_reconstruction(
        core("int8", "plain"), frames, local_context_size=6,
        num_refinement_iterations=1))
    del enc, dec, mem
    torch.cuda.empty_cache()
    sync()


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this smoke test needs an NVIDIA GPU")
    from must3r_tpu_torch import must3r_512_configs
    from must3r_tpu_torch.engine.inference import use_full_fp32_matmuls

    use_full_fp32_matmuls()
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    phase_build()
    sa, ca = phase_kernels(dev)
    train_k = phase_train_kernels(dev)
    q8 = phase_q8_kernels(dev)
    probe, probe_counts = phase_probe(dev)
    rows_2h, rows_ln, bench_counts = phase_bench_kernels(dev)
    counts = dict(phase_slice(dev, *must3r_512_configs()))
    phase_train(dev, counts)
    phase_q8_slice(dev, *must3r_512_configs(), counts)
    for extra in (probe_counts, bench_counts):
        for k, v in extra.items():
            counts[k] += v

    def entry(name, source, replaces, rows, pick):
        r = rows[pick]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": counts[name],
                "max_abs_err": max(x["max_abs_err"] for x in rows),
                "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r["library_ms"]}

    sm90, bwd90, fp8, ln = (
        "must3r_tpu_torch/csrc/attention_sm90.cu",
        "must3r_tpu_torch/csrc/attention_bwd_sm90.cu",
        "must3r_tpu_torch/csrc/probe_fp8.cu",
        "must3r_tpu_torch/csrc/ln_matmul_sm90.cu")
    ca_all = ca + train_k["ca_fwd_train"]
    record = {"kernels": [
        entry("sa_fwd", sm90, "must3r_tpu/ops/attention.py:213", sa, 0),
        entry("ca_fwd", sm90, "must3r_tpu/ops/attention.py:554", ca_all,
              len(ca) - 1),
        entry("ca_bwd_dq", bwd90, "must3r_tpu/ops/attention.py:936",
              train_k["ca_bwd_dq"], 1),
        entry("ca_bwd_dkv", bwd90, "must3r_tpu/ops/attention.py:1112",
              train_k["ca_bwd_dkv"], 1),
        entry("ca_bwd_fused", bwd90, "must3r_tpu/ops/attention.py:1335",
              train_k["ca_bwd_fused"], 2),
        entry("ca_fwd_q8", sm90, "must3r_tpu/ops/attention.py:627", q8, 0),
        entry("fp8_to_bf16_x2", fp8, "scripts/probe_fp8.py:19",
              [probe["fp8_to_bf16_x2"]], 0),
        entry("fp8_dequant_dot", fp8, "scripts/probe_fp8.py:41",
              [probe["fp8_dequant_dot"]], 0),
        entry("ca_fwd_2h", sm90, "scripts/bench_ca_kernel.py:25", rows_2h,
              0),
        entry("ln_matmul", ln, "scripts/bench_fused_chain.py:38", rows_ln,
              0),
    ]}
    log(f"[R] record times: sa_fwd at {sa[0]['shape']}, ca_fwd at "
        f"{ca[-1]['shape']}, ca_bwd_dq / ca_bwd_dkv at "
        f"{train_k['ca_bwd_dq'][1]['shape']}, ca_bwd_fused at "
        f"{train_k['ca_bwd_fused'][2]['shape']}, ca_fwd_q8 at "
        f"{q8[0]['shape']}, the probe kernels at the probe's shapes, "
        f"ca_fwd_2h at {rows_2h[0]['shape']}, ln_matmul at "
        f"{rows_ln[0]['shape']}; launches summed over the counted runs of "
        f"phases C, D and E, the probe's entry point and the two bench "
        f"tools; {time.perf_counter() - t_start:.1f} s in all")
    for k in record["kernels"]:
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']} never launched on the path")
    log(card_line())
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
