#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``must3r_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each ending in ``torch.cuda.synchronize()``; any failure exits
non-zero:

  A. Build the CUDA kernels from ``must3r_tpu_torch/csrc`` (nvcc, sm_90a)
     and the SLAM overlap index's KD-tree from ``must3r_tpu_torch/native``
     (g++), and print the toolchains and the card.
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
     read just after, and must match the schedule (K1, K2, and G1-G4 for
     every encoder block: the fused path, bf16 without a gradient).
     Outputs must be finite, of the expected shapes, with proper rotations,
     and within 2e-2 relative RMSE of the same requests run with the plain
     attention.
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
  L. The encoder block's glue (``csrc/block_glue_sm90.cu``): G1 ``ln_cast``,
     G2 ``qkv_glue``, G3 ``residual_glue`` (after proj with norm2's output,
     after fc2 in place) and G4 ``bias_gelu`` against their plain chains
     (``ops/block_glue.py``) at VGGT's shapes (66,624 tokens; 1024, 3072,
     4096 wide; the fp32 stream, LayerScale, QK-norm, the scene's tiled
     RoPE tables) and MUSt3R's (80 x 768 tokens; the bf16 stream, a table
     per view): bf16 outputs by ``tools/parity.py::bf16_agreement`` (one
     ulp, or a few fp32 ulps of the terms where a value cancels to near 0;
     99.9 % equal), the fp32 stream within one rounding of each term;
     kernel and plain chain timed on the device, with the bytes moved, GB/s
     and the share of 3.35 TB/s.
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
  F. SLAM / VO at full width (MUSt3R_512, seeded random weights, bf16,
     512 x 384 uint8 frames made from the seed): F1 always-commit over 24
     frames at max_keyframes 16 with next_frame (frames 17..24 take the
     capacity-full render), F2 never-commit over 8 frames (after each,
     committed_len = one frame and the labels past it -1), F3 F1's settings
     on an int8 memory over 12 frames (every CA launches K2(d), the bf16 K2
     never); each counted against the schedule (the encoder's and decoder's
     SA and CA per frame, G1-G4 for every encoder block, every other kernel
     0), pts3d and pts3d_local
     within 2e-2 relative RMSE of the same stream with the plain attention
     frame by frame, every c2w a finite proper rotation; a frame after
     rolled-back ones equal to a stream that never saw them (bf16, int8).
     F4 the default thresholds over 24 frames and rerender_all_frames:
     committed_len = keyframes x tokens, keyframes with next_frame = those
     without, per-frame latency with and without next_frame, peak memory,
     and the frames/s of bench.py's online_vo protocol. F5 ``cli.slam_cli``
     and ``must3r_inference_video(mode="slam")`` on 12 PNG frames, counted.
  G. Retrieval keyframing and evaluation at full width (MUSt3R_512, seeded
     random weights, bf16, 512 x 384): G1 ``must3r_inference`` of an
     unordered collection (50 images made from the seed as 10 groups of 5
     exact copies, shuffled; 10 keyframes, no codebook: the port's k-means)
     whose keyframes must be one from each group, counted against the
     schedule (two encodes, the keyframes' updates, the render chunks),
     within 2e-2 relative RMSE of the same view order on the plain
     attention, with its peak memory; then ``bench.py``'s ``retrieval_50``
     protocol (identity head, 100 features an image, a 512-cell codebook,
     best of 3) with images/s and the ms of each part. G2 the reconstruct
     CLI on 12 PNGs in its default retrieval mode, bare and with a seeded
     ``--retrieval`` head, counted. G3 the eval CLI on a scene directory
     written from the seed (2 scenes x 4 views, batch 2, pose, depth and
     cloud metrics), counted, every metric finite, its L21 means within
     2e-2 of the same evaluation on the plain attention.

  H. ``parallel/`` on the one card: two ranks, subprocesses of this script
     (``--rank-worker``) on cuda:0 joined by gloo (which stages every
     collective through host memory; NCCL refuses two ranks on one
     device), each with a hard timeout. H1 the sharded CA at sp = 2 over a
     10-view memory of 8192 slots (4096 a rank): the render, an update at
     the start of view 9 with its 768-token extra source (attended, and
     masked by q_self), a kv_len below one shard (rank 1 launches
     nothing), the int8 render and update through K2(d); each against the
     unsharded K2 / K2(d) over the same memory (for an update, the memory
     with the new tokens appended at compute precision), phase B's bounds;
     launches per rank equal to the schedule, every K2 with the LSE. H2
     ``offline_reconstruction`` with one refinement through
     ``InferenceCore(mesh=sp2)`` at full width (MUSt3R_512, 10 views of
     512 x 384): bf16 within 2e-2 relative RMSE of the unsharded run, int8
     of the sp = 1 sharded path; launches per rank equal to the schedule
     (K2 with the LSE and K2(d) the only CA launches); a request's ms at
     sp = 1 (one process) and sp = 2 (two ranks sharing the card: no
     speed-up claimed). H3 ``make_fused_offline(mesh=dp2, n_scenes=2)``
     within 2e-2 of the one-process 2-scene run, and ``cli.train`` as two
     processes through MUST3R_* (MUSt3R_512, batch 1 a process, 4 views of
     512 x 384, dropout 0.1, two steps) against one process with batch 2:
     each step's loss within 2e-2 relative, rank 0 alone writing the log
     and checkpoints; each rank's peak device memory. H4
     ``video_reconstruction`` of 16 frames (a window of 3, one refinement)
     on the sp = 2 core at a capacity of 16 images, so that its sharded
     memory compacts twice mid-run and once at the end (tokens moving
     between the ranks): within 2e-2 relative RMSE of the sp = 1 run, the
     same update steps and compactions, launches per rank equal to the
     schedule of those steps.
  I. The surfaces at full width (MUSt3R_512, 512 x 384, bf16), the smoke
     its own HTTP client on 127.0.0.1 (every request a 10 s timeout, every
     poll a deadline; a /status of "error" raises). I1 ``cli.reconstruct``
     on 10 PNGs (retrieval) with and without ``--live``, bf16 and int8
     (K2(d)): the viewer's versions grow while it runs, the last snapshot
     (after the run) parses, ``scene.pkl`` is bitwise the run without the
     viewer, launches equal G2's schedule, every GLB's points those of
     ``gather_scene_points`` and scene.html carries its count. I2
     ``WebDemo``: the 10 PNGs uploaded, a retrieval run bitwise the direct
     ``must3r_inference``, GLB / PLY exports; a mixed-aspect upload (6 at
     4:3, 4 at 16:9) through the multi-aspect driver, counted. I3
     ``cli.slam_cli`` on 48 frames (keyframes forced up to 16) bare, with
     ``--web`` (PNG panels every second frame), with ``--web`` and a pause
     / resume (no frame advances while paused; the panels decode to the
     frame's size) and with ``--live`` (a snapshot a keyframe): each
     ``all_poses.npz`` bitwise the bare run's, launches the schedule's. I4
     ``tools.soak_vo`` (300 frames into 128 keyframes: frames/s by window,
     the KD-tree's ms at 64 and 128 keyframes, peak memory; 120 video
     frames compacted vs uncompacted within 2e-2). I5 ``utils.profiling.
     trace`` around one C request: its Chrome trace holds the schedule's
     K1 and K2 kernels. I6 ``tools.quant_accuracy`` on the tiny fixture
     (K2(d) at its width; the numbers have no bound).
  J. The learning demo (``tools/train_synthetic_demo.py``), bf16 through
     the kernels. J1 the tiny preset (encoder 6 x 256 finetuned with remat,
     decoder 4 x 192, 64 x 48 views, batch 4, dropout 0.05) for
     ``J1_EPOCHS`` epochs of 160 steps between two evaluations (2 memory
     views, pose): every step's launches the schedule's, every loss
     finite, l21_global_mean after <= 0.7 x before. J2 20 steps with the
     kernels and 20 with the plain versions from the same init, loader and
     Trainer seed: the largest relative per-step loss gap <= 5e-2. J3 the
     trained tiny fixture on the ``docs/EVAL_ANCHOR.json`` protocol (10
     views, pose, 6 scenes) within ``tests/test_eval_anchor.py``'s
     tolerances, then bf16 kernels vs fp32 plain on the same views (pts3d
     within 2e-2; the focal's and the pose's deltas printed). J4 the 224
     preset (the MUSt3R_224 towers, causal, the encoder frozen, batch 1)
     for one epoch of 160 steps between two evaluations, every step's
     launches the schedule's.
  K. VGGT-1B (``models/vggt.py``). K1 against its plain version at VGGT's
     two shapes, phase B's bounds and times: global attention, one
     sequence of 64 x 1041 tokens [1, 66624, 16, 64], and frame attention,
     64 ragged sequences [64, 1041, 16, 64]. Then one request at full
     width (64 frames of 518 x 392, host float32, the benchmark's seeded
     weights of ``vggt_1b``) through ``demo.inference.vggt_inference``:
     launch counts, ``vggt_counts()`` and ``glue_counts()`` zeroed just
     before and read just after must equal the schedule (K1, G1, G2 and G4
     24 + 24 + 24 times, G3 twice that, no other kernel; 64 frames, 24 x
     66,624 global tokens, 16 DPT chunks; 72 blocks fused, the camera
     trunk's 4 x 4 plain); every output of
     its shape and finite, every c2w a proper rotation; the maps, pose_enc
     and c2w within 2e-2 relative RMSE of the same request with the plain
     attention (the focal's printed: with random weights some fields of
     view lie near 0, where the focal magnifies any difference in them).

The last three lines are the card's name and power limit, every kernel's
JSON record (launches summed over the counted runs of C, D, E, F, G, both
ranks of H, I, J but J2's comparison runs, K, the probe and the bench
tools, device times at one main-path shape each, bound and library time)
and ``{"ok": true, "device": {...}}``. About twelve to fifteen minutes on
an H100, the build (five sources, one nvcc each, in parallel) included.
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
                                           bf16_agreement, kernel_error,
                                           rel_rmse)
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
    from must3r_tpu_torch import native
    from must3r_tpu_torch.slam.nns import KDTree3

    t0 = time.perf_counter()
    lib = native.build()
    if not KDTree3().native:
        raise AssertionError("the native KD-tree did not load")
    log(f"[A] native KD-tree: {os.path.relpath(lib, ROOT)} by "
        f"{native.compiler_version()} ({' '.join(native.CXX_FLAGS)}) in "
        f"{time.perf_counter() - t0:.1f} s")
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
# L. the encoder block's glue, G1-G4
# ---------------------------------------------------------------------------

GLUE_VGGT = (64, 1041)    # a VGGT scene: 64 frames of 1,041 tokens
GLUE_MUST3R = (80, 768)   # the bulk cell's encode: 80 views of 512 x 384


def phase_glue(dev):
    """L. G1-G4 (``csrc/block_glue_sm90.cu``) against their plain chains
    (``ops/block_glue.py``: what ``encoder_block`` ran between its products
    before them) at VGGT's shapes (66,624 tokens of a 64-frame scene; D
    1024, 3D 3072, F 4096; the fp32 stream with LayerScale, QK-norm and the
    scene's tiled RoPE tables) and MUSt3R's (80 views of 768 tokens; the
    bf16 stream, a table per view): every bf16 output by
    ``tools/parity.py::bf16_agreement``, the fp32 stream within one fp32
    rounding of each term;
    then both timed on the device (a CUDA graph replayed), with the bytes
    each kernel must move, its GB/s and its share of 3.35 TB/s. Returns
    the rows of each kernel for the record."""
    from must3r_tpu_torch.models.layers import EncoderBlock
    from must3r_tpu_torch.ops import _kernels as K
    from must3r_tpu_torch.ops import block_glue as G
    from must3r_tpu_torch.ops.rope import make_rope_tables

    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 30)
    d, f = 1024, 4096

    def randn(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale + shift

    blk = EncoderBlock(d, 4.0, 1e-6, layer_scale=True, qk_norm=True,
                       num_heads=16).to(dev).requires_grad_(False)
    with torch.no_grad():
        for name, t in blk.named_parameters():
            if name.endswith("gamma"):
                t.copy_(randn(*t.shape, scale=0.005, shift=0.01))
            elif t.dim() == 1:
                t.copy_(randn(*t.shape, scale=0.1,
                              shift=float(name.endswith("weight"))))
    a = blk.attn
    qk = dict(q_norm=(a.q_norm.weight, a.q_norm.bias),
              k_norm=(a.k_norm.weight, a.k_norm.bias), eps=1e-5)
    norm2 = (blk.norm2.weight, blk.norm2.bias)

    def tables(b, n):
        pos = torch.randint(0, 40, (b, n, 2), device=dev)
        return make_rope_tables(pos, 64, base=100.0)

    rows = {k: [] for k in GLUE_KERNELS}

    def case(kernel, tag, fn, plain, nbytes, check):
        got, want = fn(), plain()
        sync()
        err = check(got, want)
        ms, plain_ms = device_ms(fn), device_ms(plain)
        work = bound(0.0, nbytes)
        log(f"[L] {kernel} {tag}: {err}; kernel {ms:.4f} ms, plain chain "
            f"{plain_ms:.4f} ms ({plain_ms / ms:.2f}x); {nbytes / 1e6:.1f} MB"
            f" moved, {nbytes / ms / 1e6:.0f} GB/s, {work['bound_ms'] / ms:.1%}"
            f" of 3.35 TB/s")
        rows[kernel].append(dict(shape=tag, max_abs_err=err["max_abs_err"],
                                 ms=ms, plain_ms=plain_ms, library_ms=None,
                                 bound_ms=work["bound_ms"],
                                 bound_by=work["bound_by"]))

    def ulp_check(got, want):
        """Every bf16 output by ``tools/parity.py::bf16_agreement``."""
        gots = got if isinstance(got, tuple) else (got,)
        wants = want if isinstance(want, tuple) else (want,)
        res = {"ulps": 0, "equal": 1.0, "max_abs_err": 0.0, "past_limit": 0}
        for g_, w_ in zip(gots, wants):
            if g_ is None or g_.dtype == torch.float32:
                continue                      # the fp32 stream: stream_check
            e = bf16_agreement(g_, w_)
            if not e["ok"]:
                raise AssertionError(f"[L] the kernel disagrees: {e}")
            res = {k: (min if k == "equal" else max)(res[k], e[k])
                   for k in res}
        return res

    def stream_check(x0, y, bias, gamma):
        """G3's outputs: the new x (in fp32 within one fp32 rounding of
        each of its terms: addcmul may fuse gamma * h into the add, the
        kernel rounds the product first; in bf16 equal), then xn."""
        def check(got, want):
            res = ulp_check((got[1],), (want[1],)) if got[1] is not None \
                else {"max_abs_err": 0.0}
            if got[0].dtype == torch.bfloat16:
                res.update(x_equal=bool(torch.equal(got[0], want[0])))
                if not res["x_equal"]:
                    raise AssertionError("[L] the bf16 stream differs")
                return res
            h = (y + bias).to(torch.bfloat16).float()
            lim = 2.0 ** -23 * (x0.abs() + (gamma * h).abs())
            over = int(((got[0] - want[0]).abs() > lim).sum())
            res.update(x_max_abs_err=float((got[0] - want[0]).abs().max()),
                       x_over_one_rounding=over)
            if over:
                raise AssertionError(f"[L] fp32 stream: {over} elements "
                                     f"past one rounding")
            return res
        return check

    for cell, (b, n), stream in (("VGGT", GLUE_VGGT, torch.float32),
                                 ("MUSt3R", GLUE_MUST3R, torch.bfloat16)):
        t = b * n
        vggt = cell == "VGGT"
        sz = stream.itemsize
        # G1, norm1
        x = randn(t, d, scale=3.0, shift=0.5).to(stream)
        w, bias = blk.norm1.weight, blk.norm1.bias
        case("ln_cast", f"{cell} [{t},{d}] {str(stream)[6:]}",
             lambda: K.ln_cast(x, w, bias, 1e-6),
             lambda: G.ln_cast(x, w, bias, 1e-6), t * d * (sz + 2),
             ulp_check)
        # G2: VGGT's global block (one sequence, the frame's tables tiled),
        # MUSt3R's encoder (a table per view)
        y = randn(t, 3 * d)
        if vggt:
            rope = tuple(tb.repeat(1, b, 1, 1) for tb in tables(1, n))
            gb, gn, kw = 1, t, qk
        else:
            rope, gb, gn, kw = tables(b, n), b, n, {}
        nbytes = t * 3 * d * 6 + t * 2 * 2 * 16 * 4
        case("qkv_glue", f"{cell} [{t},{3 * d}]"
             f"{' QK-norm' if vggt else ''} RoPE",
             lambda: K.qkv_glue(y, a.qkv.bias, gb, gn, rope=rope, **kw),
             lambda: G.qkv_glue(y, a.qkv.bias, gb, gn, rope=rope, **kw),
             nbytes, ulp_check)
        del y, rope
        # G3 after proj (a new x and norm2's output), after fc2 (in place)
        y = randn(t, d)
        gamma = blk.ls1.gamma if vggt else None
        check = stream_check(x.float(), y, a.proj.bias, gamma)
        case("residual_glue", f"{cell} after proj [{t},{d}]"
             f"{' LayerScale' if vggt else ''} + norm2",
             lambda: K.residual_glue(y, a.proj.bias, x, gamma, norm2, 1e-6),
             lambda: G.residual_glue(y, a.proj.bias, x, gamma, norm2, 1e-6),
             t * d * (4 + 2 * sz + 2), check)
        xi = x.clone()
        case("residual_glue", f"{cell} after fc2 [{t},{d}] in place",
             lambda: K.residual_glue(y, a.proj.bias, xi, gamma,
                                     inplace=True),
             lambda: G.residual_glue(y, a.proj.bias, x, gamma),
             t * d * (4 + 2 * sz), check)
        del y, x, xi
        # G4
        y = randn(t, f, scale=3.0)
        case("bias_gelu", f"{cell} [{t},{f}]",
             lambda: K.bias_gelu(y, blk.mlp.fc1.bias),
             lambda: G.bias_gelu(y, blk.mlp.fc1.bias), t * f * 6, ulp_check)
        del y
        torch.cuda.empty_cache()
    sync()
    log(f"[L] phase L: {time.perf_counter() - t_phase:.1f} s")
    return rows


# ---------------------------------------------------------------------------
# C. the slice
# ---------------------------------------------------------------------------

GLUE_KERNELS = ("ln_cast", "qkv_glue", "residual_glue", "bias_gelu")


def add_glue(c: dict, blocks: int) -> dict:
    """c plus the glue launches of ``blocks`` encoder blocks on the fused
    path (``models/layers.py::glued_block``): G1, G2 and G4 once a block,
    G3 twice (after proj and after fc2)."""
    for k, n in zip(GLUE_KERNELS, (1, 1, 2, 1)):
        c[k] = c.get(k, 0) + n * blocks
    return c


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
        enc_calls = 1 if fused else math.ceil(n_views / 8)
        glue = add_glue({}, enc_calls * enc_cfg.depth)
        log(f"[C] {tag}: {s * 1e3:.1f} ms, launches {moved} "
            f"(expected sa_fwd {want[0]}, ca_fwd {want[1]}, glue {glue})")
        if (moved["sa_fwd"], moved["ca_fwd"]) != want or \
                {k: moved[k] for k in glue} != glue:
            raise AssertionError(f"{tag}: launches {moved} != {want}, "
                                 f"{glue}")

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
    encoder: one SA per block; a finetuned one with remat a second SA per
    block when the backward recomputes the block. Each update step: per
    block one SA, and with remat (and a gradient) a second SA when the
    backward recomputes the block's projections; one CA forward (K2 with
    LSE); its backward K5 where the JAX routing folds (G > 1, G x
    128-aligned N <= 2048), else K3 + K4. The render (G folded into the
    CA's query axis): one SA and one CA per block, backward K3 + K4. The SA
    backward recomputes through the plain version (no kernel). The frozen
    encoder's blocks take the fused path (no gradient; bf16); a finetuned
    one's need a gradient and run plain."""
    from must3r_tpu_torch.engine.train import compute_dtype
    from must3r_tpu_torch.ops.attention import _fold_stripe, launch_counts

    depth = dec_cfg.depth
    c = {k: 0 for k in launch_counts()}
    c["sa_fwd"] = enc_cfg.depth * (2 if (ts.finetune_encoder and ts.remat)
                                   else 1)
    if not ts.finetune_encoder and compute_dtype(ts) == torch.bfloat16:
        add_glue(c, enc_cfg.depth)
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


def _check_counts(tag, got, want, phase="D"):
    log(f"[{phase}] {tag}: launches {got} (expected {want})")
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


# ---------------------------------------------------------------------------
# F. SLAM / VO at full width
# ---------------------------------------------------------------------------

def slam_frames(n, seed):
    """n RGB uint8 frames of 512 x 384 made from the seed (numpy, host)."""
    gen = torch.Generator().manual_seed(seed)
    return list(torch.randint(0, 256, (n, *HW, 3), generator=gen,
                              dtype=torch.uint8).numpy())


def run_stream(slam, frames, spec=True, return_maps=True, check=None,
               latencies=None):
    """The frames through ``slam.__call__`` as a streaming caller feeds
    them: with ``spec`` the next frame goes along as ``next_frame``;
    ``check(i, out)`` after every frame; per-frame host latencies appended
    to ``latencies``."""
    outs = []
    for i, f in enumerate(frames):
        nxt = frames[i + 1] if spec and i + 1 < len(frames) else None
        t0 = time.perf_counter()
        out = slam(f, i, return_maps=return_maps, next_frame=nxt,
                   next_frame_id=None if nxt is None else i + 1)
        if latencies is not None:
            latencies.append(time.perf_counter() - t0)
        outs.append(out)
        if check is not None:
            check(i, out)
    return outs


def slam_launches(enc_cfg, dec_cfg, encodes, steps=None, q8=False) -> dict:
    """Launches of ``encodes`` encoder calls (one SA per block) and
    ``steps`` decoder steps (default: as many; one SA and one CA per block,
    the tentative update, the capacity-full render and a batched re-render
    alike, a batch being one launch)."""
    from must3r_tpu_torch.ops.attention import launch_counts

    steps = encodes if steps is None else steps
    c = {k: 0 for k in launch_counts()}
    c["sa_fwd"] = encodes * enc_cfg.depth + steps * dec_cfg.depth
    c["ca_fwd_q8" if q8 else "ca_fwd"] = steps * dec_cfg.depth
    return add_glue(c, encodes * enc_cfg.depth)


def _check_slam_counts(tag, got, want):
    log(f"[F] {tag}: launches {got} (expected {want})")
    if got != want:
        raise AssertionError(f"{tag}: launches {got} != {want}")


def _check_frames(tag, outs, refs=None):
    """Finite outputs of the expected shapes, proper rotations; with refs,
    pts3d and pts3d_local within RMSE_TOL of the plain run, frame by
    frame."""
    worst = {"pts3d": 0.0, "pts3d_local": 0.0}
    for i, o in enumerate(outs):
        c2w = torch.as_tensor(o["c2w"]).double()
        if not torch.isfinite(c2w).all():
            raise AssertionError(f"{tag} frame {i}: c2w not finite")
        r = c2w[:3, :3]
        if float((r.T @ r - torch.eye(3, dtype=r.dtype)).abs().max()) > 1e-3 \
                or abs(float(torch.linalg.det(r)) - 1) > 1e-3:
            raise AssertionError(f"{tag} frame {i}: not a rotation {r}")
        for k in worst:
            if k not in o:
                continue
            t = torch.as_tensor(o[k])
            if tuple(t.shape) != (*HW, 3) or not torch.isfinite(t).all():
                raise AssertionError(f"{tag} frame {i} {k}: shape "
                                     f"{tuple(t.shape)} or not finite")
            if refs is not None:
                e = rel_rmse(t, torch.as_tensor(refs[i][k]))
                worst[k] = max(worst[k], e)
                if not e <= RMSE_TOL:
                    raise AssertionError(f"{tag} frame {i} {k}: relative "
                                         f"RMSE {e} > {RMSE_TOL}")
    if refs is not None:
        log(f"[F] {tag}: worst per-frame relative RMSE vs plain {worst} "
            f"(bound {RMSE_TOL})")


def _no_trace(tag, slam_of, frames, rolled):
    """A stream whose frames 1..k-1 were rolled back leaves frame k's maps
    equal to those of a stream that saw only frames 0 and k."""
    fresh = slam_of()
    run_stream(fresh, [frames[0]], spec=False)
    got = fresh(frames[-1], len(frames) - 1)
    diff = max(float(abs(got[k] - rolled[k]).max())
               for k in ("pts3d", "pts3d_local", "conf"))
    log(f"[F] {tag}: frame {len(frames) - 1} after {len(frames) - 2} "
        f"rolled-back frames vs a stream without them: max abs difference "
        f"{diff}")
    if diff != 0.0:
        raise AssertionError(f"{tag}: a rolled-back frame left a trace")


def phase_slam(dev, enc_cfg, dec_cfg, totals):
    """F1 always-commit over 24 frames at max_keyframes 16 (frames 17..24
    take the capacity-full render), with next_frame; F2 never-commit, 8
    frames; F3 F1 on an int8 memory, 12 frames; each counted and compared
    frame by frame with the same stream on the plain attention. F4 the
    default thresholds, 24 frames and rerender_all_frames, latency with and
    without next_frame, peak memory, and the frames/s of bench.py's
    online_vo protocol. F5 the SLAM CLI and must3r_inference_video(mode=
    'slam') on 12 PNG frames, counted."""
    import statistics
    import tempfile

    import numpy as np

    from must3r_tpu_torch.checkpoint import init_model
    from must3r_tpu_torch.slam import Must3rSLAM, SlamConfig

    enc, dec = init_model(enc_cfg, dec_cfg, seed=SEED, device=dev)
    n_tok = (HW[0] // dec_cfg.patch_size) * (HW[1] // dec_cfg.patch_size)
    always = dict(keyframe_overlap_thr=-math.inf, min_conf_keyframe=0.0)

    def engine(impl=None, **kw):
        return Must3rSLAM(enc, dec, enc_cfg, dec_cfg,
                          SlamConfig(res=HW[1], **kw), impl=impl)

    def counted(fn):
        out, counts = _counted(fn)
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
        return out, counts

    # F1: always-commit, the memory fills at frame 16
    frames = slam_frames(24, SEED + 10)
    kw = dict(max_keyframes=16, num_init_frames=1, **always)
    slam = engine(**kw)
    t0 = time.perf_counter()
    outs, counts = counted(lambda: run_stream(slam, frames))
    _check_slam_counts(f"F1 always-commit, 24 frames "
                       f"({(time.perf_counter() - t0) * 1e3:.1f} ms)",
                       counts, slam_launches(enc_cfg, dec_cfg, 24))
    if slam.keyframes != list(range(16)) or not slam._warned_full or \
            slam.committed_len != 16 * n_tok or \
            slam.mem.capacity != 16 * n_tok:
        raise AssertionError(f"F1: keyframes {slam.keyframes}, committed "
                             f"{slam.committed_len} of {slam.mem.capacity}")
    log(f"[F] F1: 16 keyframes fill {slam.mem.capacity} slots; frames 17..24 "
        f"took the capacity-full render")
    _check_frames("F1", outs, run_stream(engine("plain", **kw), frames))
    del slam

    # F2: never-commit; every frame rolled back
    frames = slam_frames(8, SEED + 11)
    kw = dict(max_keyframes=16, num_init_frames=1,
              keyframe_overlap_thr=math.inf)
    slam = engine(**kw)

    def rolled_back(i, out):
        lab = slam.mem.labels[0]
        if slam.committed_len != n_tok or slam.mem.length != n_tok or \
                bool((lab[n_tok:] != -1).any()) or bool((lab[:n_tok] != 0)
                                                        .any()):
            raise AssertionError(f"F2 frame {i}: committed "
                                 f"{slam.committed_len}, labels not rolled "
                                 f"back")
    outs, counts = counted(lambda: run_stream(slam, frames,
                                              check=rolled_back))
    _check_slam_counts("F2 never-commit, 8 frames", counts,
                       slam_launches(enc_cfg, dec_cfg, 8))
    _check_frames("F2", outs, run_stream(engine("plain", **kw), frames))
    _no_trace("F2", lambda: engine(**kw), frames, outs[-1])
    del slam

    # F3: F1's settings on an int8 memory, and its rollback
    frames = slam_frames(12, SEED + 12)
    kw = dict(max_keyframes=16, num_init_frames=1, kv_quant="int8", **always)
    slam = engine(**kw)
    outs, counts = counted(lambda: run_stream(slam, frames))
    _check_slam_counts("F3 int8 always-commit, 12 frames", counts,
                       slam_launches(enc_cfg, dec_cfg, 12, q8=True))
    _check_frames("F3", outs, run_stream(engine("plain", **kw), frames))
    del slam
    kw = dict(max_keyframes=16, num_init_frames=1, kv_quant="int8",
              keyframe_overlap_thr=math.inf)
    rolled = run_stream(engine(**kw), frames[:4])
    _no_trace("F3 int8", lambda: engine(**kw), frames[:4], rolled[-1])

    # F4: the default thresholds (num_init_frames 2: frame 1 re-initialises
    # the map, replaying frame 0 and dropping frame 1's speculative encode:
    # 26 encodes, 25 steps), then 3 batches of 8 re-rendered; latency with
    # and without next_frame
    frames = slam_frames(24, SEED + 13)
    sync()
    torch.cuda.reset_peak_memory_stats()
    slam = engine(rerender=True)
    lat_spec, lat_plain = [], []
    _, counts = counted(lambda: (
        run_stream(slam, frames, return_maps=False, latencies=lat_spec),
        slam.rerender_all_frames()))
    peak = torch.cuda.max_memory_allocated()
    n_kf = len(slam.keyframes)
    _check_slam_counts(f"F4 default thresholds, 24 frames + "
                       f"rerender_all_frames ({n_kf} keyframes)", counts,
                       slam_launches(enc_cfg, dec_cfg, 26 + 3, 25 + 3))
    if slam.committed_len != n_kf * n_tok or slam.all_pts3d.shape != \
            (24, *HW, 3) or not np.isfinite(slam.all_pts3d).all():
        raise AssertionError(f"F4: committed {slam.committed_len} for {n_kf} "
                             f"keyframes, or a bad re-render")
    _check_frames("F4 re-rendered", [{"c2w": c} for c in slam.all_poses])
    keyframes = slam.keyframes
    del slam
    slam = engine(rerender=True)
    run_stream(slam, frames, spec=False, return_maps=False,
               latencies=lat_plain)
    if slam.keyframes != keyframes:
        raise AssertionError(f"F4: keyframes with next_frame {keyframes} != "
                             f"without {slam.keyframes}")
    del slam
    log(f"[F] F4: {n_kf} keyframes of 24 frames; median per-frame latency of "
        f"__call__ (frames 3..24, host clock) "
        f"{statistics.median(lat_spec[2:]) * 1e3:.2f} ms with next_frame, "
        f"{statistics.median(lat_plain[2:]) * 1e3:.2f} ms without; peak "
        f"device memory {peak / 2**30:.2f} GiB (max_keyframes 256: "
        f"{256 * n_tok} slots); {card_line()}")

    # bench.py's online_vo protocol: max_keyframes 64, always-commit, 20
    # frames back to back, one sync at the end, 2 warm-up frames
    slam = engine(max_keyframes=64)
    slam._ensure_memory(HW)
    from must3r_tpu_torch.ops.transfer import upload
    img = upload(slam_frames(1, SEED + 14)[0][None], dev)
    pos = slam._positions(HW)

    def vo(n):
        for _ in range(n):
            slam._pack(slam._frame_step(img, pos, False, 500.0))
        sync()
    vo(2)
    rates = []
    for _ in range(3):
        t0 = time.perf_counter()
        vo(20)
        rates.append(20 / (time.perf_counter() - t0))
    log(f"[F] online_vo protocol 512x384: {statistics.median(rates):.2f} "
        f"frames/s "
        f"(median of 3 runs of 20 frames: {[round(r, 2) for r in rates]}); "
        f"{card_line()}")
    del slam

    # F5: the entry points on 12 PNG frames
    import PIL.Image

    from must3r_tpu_torch.cli import slam_cli
    from must3r_tpu_torch.demo.inference import must3r_inference_video
    from must3r_tpu_torch.engine.inference import InferenceCore
    from must3r_tpu_torch.tools.image import list_images, load_images

    with tempfile.TemporaryDirectory() as tmp:
        src, out_dir = os.path.join(tmp, "frames"), os.path.join(tmp, "out")
        os.makedirs(src)
        for i, f in enumerate(slam_frames(12, SEED + 15)):
            PIL.Image.fromarray(f).save(os.path.join(src, f"{i:03d}.png"))
        t0 = time.perf_counter()
        _, counts = counted(lambda: slam_cli.main(
            ["--preset", "512", "--input", src, "--output_dir", out_dir,
             "--subsamp", "1", "--seed", str(SEED)]))
        _check_slam_counts(f"F5 slam_cli, 12 frames "
                           f"({time.perf_counter() - t0:.1f} s with the model "
                           f"init)", counts,
                           slam_launches(enc_cfg, dec_cfg, 12))
        poses = np.load(os.path.join(out_dir, "all_poses.npz"),
                        allow_pickle=True)["poses"]
        if poses.shape != (12, 4, 4) or not np.isfinite(poses).all():
            raise AssertionError(f"F5: all_poses.npz {poses.shape}")
        _check_frames("F5 slam_cli", [{"c2w": c} for c in poses])
        views = load_images(list_images(src), HW[1])
        core = InferenceCore(enc, dec, enc_cfg, dec_cfg)
        scene, counts = counted(lambda: must3r_inference_video(
            core, views, mode="slam"))
        want = slam_launches(enc_cfg, dec_cfg, 2, 11)
        _check_slam_counts("F5 must3r_inference_video(mode='slam'), 12 "
                           "frames (2 encoder chunks, 11 update steps)",
                           counts, want)
        _check_frames("F5 video slam", [
            {"c2w": scene.cams2world[i], "pts3d": scene.pts3d[i],
             "pts3d_local": scene.pts3d_local[i]} for i in range(12)])
    del enc, dec, core
    torch.cuda.empty_cache()
    sync()


# ---------------------------------------------------------------------------
# G. retrieval keyframing and evaluation at full width
# ---------------------------------------------------------------------------

def retrieval_launches(enc_cfg, dec_cfg, n_views, n_mem, encodes=2,
                       encode_bs=8, render_bs=8, init=2) -> dict:
    """Launches of must3r_inference(is_sequence=False): ``encodes`` encodes
    of the collection in chunks of encode_bs (retrieval, then the
    reconstruction), the update steps [init, 1, ...] of the keyframes, the
    render chunks of every view."""
    from must3r_tpu_torch.ops.attention import launch_counts

    steps = 1 + max(n_mem - init, 0) + math.ceil(n_views / render_bs)
    c = {k: 0 for k in launch_counts()}
    enc_blocks = encodes * math.ceil(n_views / encode_bs) * enc_cfg.depth
    c["sa_fwd"] = enc_blocks + steps * dec_cfg.depth
    c["ca_fwd"] = steps * dec_cfg.depth
    return add_glue(c, enc_blocks)


def eval_launches(enc_cfg, dec_cfg, passes) -> dict:
    """Launches of the evaluation's forward passes, each (batches, memory
    views): per batch one encode of every view (one call), the init update
    and 1-view updates of the memory views, one render of every view."""
    from must3r_tpu_torch.ops.attention import launch_counts

    c = {k: 0 for k in launch_counts()}
    for batches, k in passes:
        steps = 1 + max(k - 2, 0) + 1
        c["sa_fwd"] += batches * (enc_cfg.depth + steps * dec_cfg.depth)
        c["ca_fwd"] += batches * steps * dec_cfg.depth
        add_glue(c, batches * enc_cfg.depth)
    return c


def _keyframes_printed(text):
    line = [ln for ln in text.splitlines() if ln.startswith("keyframes:")]
    return json.loads(line[-1].split(":", 1)[1])


def retrieval_head_file(path, dim, seed):
    """A reference-layout ``*_trainingfree.pth`` made from the seed:
    prewhitening, a 2-layer projector (dim -> 512 -> 128) and
    postwhitening."""
    import argparse

    gen = torch.Generator().manual_seed(seed)

    def rand(*shape, s=1.0):
        return torch.randn(*shape, generator=gen) * s

    sd = {"prewhiten.m": rand(1, dim, s=0.1),
          "prewhiten.p": torch.eye(dim) + rand(dim, dim, s=0.01),
          "projector.0.weight": rand(512, dim, s=dim ** -0.5),
          "projector.0.bias": rand(512, s=0.01),
          "projector.1.weight": 1 + rand(512, s=0.1),
          "projector.1.bias": rand(512, s=0.1),
          "projector.3.weight": rand(128, 512, s=512 ** -0.5),
          "projector.3.bias": rand(128, s=0.01),
          "postwhiten.m": rand(1, 128, s=0.1),
          "postwhiten.p": torch.eye(128) + rand(128, 128, s=0.01)}
    torch.save({"model": sd, "args": argparse.Namespace(nfeat=300,
                                                        residual=False)},
               path)


def write_scene_dir(root, seed, n_scenes=2, n_views=4, hw=HW):
    """Scene directories as tests/test_scenedir.py writes them (PNG images,
    .npy depths, cameras.npz with a pair chain), rendered at 512 x 384 by
    the port's SyntheticScenes from the seed."""
    import numpy as np
    import PIL.Image

    from must3r_tpu_torch.datasets.synthetic import SyntheticScenes, _look_at

    gen = SyntheticScenes(num_views=n_views, render_hw=hw, seed=seed)
    k = np.asarray([[0.9 * hw[1], 0, hw[1] / 2], [0, 0.9 * hw[1], hw[0] / 2],
                    [0, 0, 1]], np.float32)
    for s in range(n_scenes):
        scene = gen._scene(seed + s)
        d = os.path.join(root, f"scene{s}")
        os.makedirs(os.path.join(d, "images"))
        os.makedirs(os.path.join(d, "depths"))
        poses, frames = [], []
        for i in range(n_views):
            ang = 0.3 * i + s
            eye = np.asarray([4 * np.sin(ang), 0.3, -4 * np.cos(ang)],
                             np.float32)
            c2w = _look_at(eye, (0, 0, 0))
            img, depth = gen._render(scene, c2w, k, hw)
            name = f"frame{i:04d}"
            PIL.Image.fromarray(img).save(
                os.path.join(d, "images", name + ".png"))
            np.save(os.path.join(d, "depths", name + ".npy"), depth)
            poses.append(c2w)
            frames.append(name)
        np.savez(os.path.join(d, "cameras.npz"),
                 intrinsics=np.stack([k] * n_views), poses=np.stack(poses),
                 frames=np.asarray(frames),
                 pairs=np.stack([np.arange(n_views - 1),
                                 np.arange(1, n_views)], 1))


def phase_retrieval_eval(dev, enc_cfg, dec_cfg, totals, preset="512"):
    """G1 must3r_inference(is_sequence=False) on 50 images of 512 x 384 (10
    groups of 5 exact copies, shuffled) with 10 keyframes and no codebook,
    counted, against the same view order on the plain attention; then
    bench.py's retrieval_50 protocol with the time of each part. G2 the
    reconstruct CLI on 12 PNGs, bare (retrieval) and with --retrieval.
    G3 the eval CLI on a scene directory (2 scenes x 4 views, batch 2),
    counted, its L21 means against the plain attention. ``preset`` is the
    CLIs' model, the one enc_cfg / dec_cfg describe."""
    import contextlib
    import io
    import pickle
    import tempfile

    import numpy as np
    import PIL.Image

    from must3r_tpu_torch.checkpoint import init_model
    from must3r_tpu_torch.cli import eval_cli
    from must3r_tpu_torch.cli import reconstruct as reconstruct_cli
    from must3r_tpu_torch.cli.train import build_dataset
    from must3r_tpu_torch.datasets import get_data_loader
    from must3r_tpu_torch.demo.inference import (must3r_inference,
                                                 select_keyframes)
    from must3r_tpu_torch.engine.evaluate import evaluate
    from must3r_tpu_torch.engine.inference import (InferenceCore,
                                                   offline_reconstruction,
                                                   view_positions)
    from must3r_tpu_torch.retrieval.asmk import ASMK, _assign, train_codebook
    from must3r_tpu_torch.retrieval.graph import (farthest_point_sampling,
                                                  greedy_keyframe_ordering)
    from must3r_tpu_torch.retrieval.model import identity_head

    def counted(fn):
        out, counts = _counted(fn)
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
        return out, counts

    t_phase = time.perf_counter()
    enc, dec = init_model(enc_cfg, dec_cfg, seed=SEED, device=dev)
    core = InferenceCore(enc, dec, enc_cfg, dec_cfg)
    plain = InferenceCore(enc, dec, enc_cfg, dec_cfg, impl="plain")

    # -- G1: 50 images, 10 groups of 5 exact copies, shuffled ----------------
    n, n_mem, groups = 50, 10, 10
    gen = torch.Generator(device=dev).manual_seed(SEED + 20)
    base = torch.rand(groups, *HW, 3, generator=gen, device=dev) * 2 - 1
    group_of = torch.randperm(n, generator=torch.Generator().manual_seed(
        SEED + 21)) % groups
    imgs = base[group_of.to(dev)]
    views = make_views(imgs)
    sync()
    torch.cuda.reset_peak_memory_stats()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        scene, counts = counted(lambda: must3r_inference(
            core, views, num_mem_images=n_mem, verbose=True))
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    kfs = _keyframes_printed(buf.getvalue())
    kf_groups = sorted(int(group_of[k]) for k in kfs)
    log(f"[G] G1 must3r_inference(is_sequence=False), {n} views, "
        f"{n_mem} keyframes, no codebook: {secs:.2f} s; keyframes {kfs} "
        f"from groups {kf_groups}")
    if len(set(kfs)) != n_mem or kf_groups != list(range(groups)):
        raise AssertionError(f"G1: keyframes {kfs} are not one from each "
                             f"of the {groups} groups ({kf_groups})")
    _check_counts("G1", counts,
                  retrieval_launches(enc_cfg, dec_cfg, n, n_mem), "G")
    out = {"pts3d": scene.pts3d, "pts3d_local": scene.pts3d_local,
           "conf": scene.conf, "focal": scene.focals,
           "c2w": scene.cams2world}
    check_result("G1", out, n, HW)
    order = kfs + sorted(set(range(n)) - set(kfs))
    ref = offline_reconstruction(plain, imgs[order],
                                 mem_views=list(range(n_mem)))
    inv = torch.as_tensor(np.argsort(order), device=dev)
    errs = {k: rel_rmse(torch.as_tensor(out[k]), ref[k][inv].cpu())
            for k in ("pts3d", "pts3d_local")}
    log(f"[G] G1: relative RMSE vs plain (the same view order) {errs} "
        f"(bound {RMSE_TOL}); peak device memory {peak / 2**30:.2f} GiB; "
        f"{card_line()}")
    for k, e in errs.items():
        if not e <= RMSE_TOL:
            raise AssertionError(f"G1 {k}: relative RMSE {e} > {RMSE_TOL}")
    del scene, out, ref

    # bench.py's retrieval_50 protocol: identity head (100 features an
    # image), a 512-cell codebook trained outside the timed region,
    # encode_all(max_bs=10) + select_keyframes, best of 3; then the same
    # steps one by one, timed
    pos = view_positions(HW, enc_cfg.patch_size, batch_shape=(n,),
                         device=dev)
    head = identity_head(enc_cfg.embed_dim, nfeat=100)
    feats, _ = head.extract_local_features(core.encode_all(imgs, pos,
                                                           max_bs=10))
    codebook = train_codebook(feats, k=512, device=dev)

    def run():
        x = core.encode_all(imgs, pos, max_bs=10)
        return select_keyframes(core, x, n_mem, head, codebook)

    want = run()
    times = []
    for _ in range(3):
        sync()
        t0 = time.perf_counter()
        got = run()
        times.append(time.perf_counter() - t0)
        if got != want:
            raise AssertionError(f"retrieval_50: keyframes {got} != {want}")
    parts = {k: [] for k in ("encode", "head_fetch", "assign",
                             "similarity", "fps_order")}
    asmk = ASMK(codebook, device=dev)
    for _ in range(3):
        sync()
        t0 = time.perf_counter()
        x = core.encode_all(imgs, pos, max_bs=10)
        sync()
        t1 = time.perf_counter()
        feats, ids = head.extract_local_features(x)
        t2 = time.perf_counter()
        _assign(feats, codebook, asmk.database_ma, device=dev)
        _assign(feats, codebook, asmk.query_ma, device=dev)
        t3 = time.perf_counter()
        sim = asmk.similarity_matrix(feats, ids)
        t4 = time.perf_counter()
        anchors, _ = farthest_point_sampling(1.0 - sim, n=n_mem, seed=0)
        kf = [int(anchors[k]) for k in greedy_keyframe_ordering(
            sim[np.ix_(anchors, anchors)])]
        t5 = time.perf_counter()
        if kf != want:
            raise AssertionError(f"retrieval_50 parts: {kf} != {want}")
        for k, a, b in (("encode", t0, t1), ("head_fetch", t1, t2),
                        ("assign", t2, t3), ("similarity", t3, t4),
                        ("fps_order", t4, t5)):
            parts[k].append((b - a) * 1e3)
    med = {k: sorted(v)[1] for k, v in parts.items()}
    log(f"[G] retrieval_50 protocol {HW[1]}x{HW[0]}: "
        f"{n / min(times):.2f} images/s (best of 3: "
        f"{[round(t * 1e3, 2) for t in times]} ms); parts, median of 3, "
        f"ms: encode {med['encode']:.2f}, head + fetch "
        f"{med['head_fetch']:.2f}, assign on the card (MA 1 and 5) "
        f"{med['assign']:.2f}, aggregate + query on the host "
        f"{med['similarity'] - med['assign']:.2f} (similarity_matrix "
        f"{med['similarity']:.2f}, its assign included), FPS + ordering "
        f"{med['fps_order']:.2f}; {len(feats)} features; {card_line()}")
    del x, feats, sim

    with tempfile.TemporaryDirectory() as tmp:
        # -- G2: the reconstruct CLI on 12 PNGs -------------------------------
        src = os.path.join(tmp, "imgs")
        os.makedirs(src)
        for i, f in enumerate(slam_frames(12, SEED + 22)):
            PIL.Image.fromarray(f).save(os.path.join(src, f"{i:03d}.png"))
        head_path = os.path.join(tmp, "head_trainingfree.pth")
        retrieval_head_file(head_path, enc_cfg.embed_dim, SEED + 23)
        for tag, extra in (("bare", []),
                           ("--retrieval", ["--retrieval", head_path])):
            out_dir = os.path.join(tmp, "out_" + tag.strip("-"))
            t0 = time.perf_counter()
            _, counts = counted(lambda: reconstruct_cli.main(
                ["--input", src, "--output_dir", out_dir, "--preset", preset,
                 "--seed", str(SEED), *extra]))
            _check_counts(
                f"G2 cli.reconstruct {tag}, 12 views "
                f"({time.perf_counter() - t0:.1f} s with the model init)",
                counts, retrieval_launches(enc_cfg, dec_cfg, 12, 12), "G")
            with open(os.path.join(out_dir, "scene.pkl"), "rb") as f:
                scene = pickle.load(f)
            check_result(f"G2 {tag}", {
                "pts3d": scene.pts3d, "pts3d_local": scene.pts3d_local,
                "conf": scene.conf, "focal": scene.focals,
                "c2w": scene.cams2world}, 12, HW)
            plys = sorted(p for p in os.listdir(out_dir)
                          if p.endswith(".ply"))
            if len(plys) != 3:
                raise AssertionError(f"G2 {tag}: PLY files {plys}")

        # -- G3: the eval CLI on a scene directory ---------------------------
        root = os.path.join(tmp, "scenes")
        write_scene_dir(root, SEED + 24)
        spec = (f"ScanNetpp({root!r}, num_views=4, resolutions=((512, 384),),"
                f" epoch_size=4, seed={SEED})")
        out_json = os.path.join(tmp, "r.json")
        t0 = time.perf_counter()
        report, counts = counted(lambda: eval_cli.main(
            ["--dataset", spec, "--preset", preset, "--num_views", "2", "4",
             "--batch_size", "2", "--pose_eval", "--depth_eval",
             "--recon_eval", "--seed", str(SEED), "--output", out_json]))
        secs = time.perf_counter() - t0
        _check_counts("G3 cli.eval_cli, batch 2, 2 batches, views 2 and "
                      "4, then the reconstruction metrics at 4", counts,
                      eval_launches(enc_cfg, dec_cfg,
                                    [(2, 2), (2, 4), (2, 4)]), "G")
        with open(out_json) as f:
            report = json.load(f)
        flat = {f"{g}.{k}": v for g, r in report.items() for k, v in r.items()}
        bad = [k for k, v in flat.items() if not math.isfinite(v)]
        if bad:
            raise AssertionError(f"G3: metrics not finite {bad}")
        loader = get_data_loader(build_dataset(spec), 2,
                                 patch_size=dec_cfg.patch_size)
        ref = evaluate(plain, loader, num_views_list=(2, 4), verbose=False)
        worst = 0.0
        for g, r in ref.items():
            for k in ("l21_global_mean", "l21_local_mean"):
                e = abs(report[g][k] - r[k]) / abs(r[k])
                worst = max(worst, e)
                if not e <= RMSE_TOL:
                    raise AssertionError(f"G3 {g} {k}: {report[g][k]} vs "
                                         f"plain {r[k]} (relative {e})")
        log(f"[G] G3 cli.eval_cli at 512x384: {secs:.2f} s for 6 forward "
            f"batches of 2 x 4 views ({secs / 6:.3f} s a batch, the model "
            f"init included); report {report}; L21 means vs plain: worst "
            f"relative difference {worst:.3g} (bound {RMSE_TOL}); "
            f"{card_line()}")
    del enc, dec, core, plain
    torch.cuda.empty_cache()
    sync()
    log(f"[G] phase G: {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# H. parallel/: the sharded memory (sp = 2), dp bulk serving, the dp Trainer
# ---------------------------------------------------------------------------

# Two ranks share cuda:0 and talk through gloo, which stages every
# collective through host memory (NCCL refuses two ranks on one device):
# this checks the semantics and the wiring of the collectives, not scaling.
H_RANKS = 2
H_TIMEOUT = 420          # seconds a launch of ranks may take in all
H_MEM_SLOTS = 8192       # H1: a 10-view memory, 4096 slots a rank
H1_TOK, H1_HEADS = 768, 12   # H1: tokens a view, heads (head dim 64)
# H4: video_reconstruction of 16 frames (every 3rd a keyframe) with a
# working window of 3 and one refinement pass, at a capacity of 16 images
# (12,288 slots: a whole number of 1024-slot blocks at sp = 1 and of 2048
# at sp = 2, so that both compact at the same steps: twice mid-run, then at
# the end)
H4_FRAMES, H4_KW = 16, dict(local_context_size=3, num_refinement_iterations=1,
                            capacity_images=16)


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_procs(tag, cmds, envs, out_dir):
    """Start every command, wait at most H_TIMEOUT s for all of them, kill
    what is left, and fail unless each exited 0. Returns their outputs."""
    logs = [os.path.join(out_dir, f"{tag}_{i}.log") for i in range(len(cmds))]
    procs = []
    try:
        for cmd, env, path in zip(cmds, envs, logs):
            with open(path, "w") as f:
                procs.append(subprocess.Popen(cmd, cwd=ROOT, env=env,
                                              stdout=f,
                                              stderr=subprocess.STDOUT))
        deadline = time.monotonic() + H_TIMEOUT
        for p in procs:
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 1))
            except subprocess.TimeoutExpired:
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    texts = [open(path).read() for path in logs]
    bad = [(i, p.returncode) for i, p in enumerate(procs) if p.returncode]
    if bad:
        tails = "\n".join(f"--- {i}:\n{texts[i][-4000:]}" for i, _ in bad)
        raise AssertionError(f"[H] {tag}: processes failed {bad}:\n{tails}")
    return texts


def h1_memory(dev, seed):
    """H1's one-layer memory: 10 views of H1_TOK tokens (labels 0..9) in
    H_MEM_SLOTS slots, kv [1, H, S, 128] bf16, a step's H1_TOK new tokens,
    and queries of one view and of ten."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev
                           ).to(torch.bfloat16)

    kv = randn(1, H1_HEADS, H_MEM_SLOTS, 128)
    labels = torch.full((1, H_MEM_SLOTS), -1, dtype=torch.int32, device=dev)
    labels[0, :10 * H1_TOK] = torch.arange(
        10, dtype=torch.int32, device=dev).repeat_interleave(H1_TOK)
    new = randn(1, H1_HEADS, H1_TOK, 128)
    q = {v: randn(1, 1, v * H1_TOK, H1_HEADS, 64) for v in (1, 10)}
    return kv, labels, new, q


def h1_cases():
    """name: (query views, kv_len, q_self, 8-bit, extra source). The render
    reads all 10 views; the update at the start of view 9 attends views
    0..8 and, through the extra source, the step's new tokens (label 9)
    where q_self allows; a kv_len below one shard leaves rank 1 empty."""
    t = H1_TOK
    return {"render": (10, 10 * t, -2, False, False),
            "update": (1, 9 * t, -2, False, True),
            "update_self_masked": (1, 9 * t, 9, False, True),
            "rank1_empty": (1, 4 * t, -2, False, False),
            "render_int8": (10, 10 * t, -2, True, False),
            "update_int8": (1, 9 * t, -2, True, True)}


def h1_launches(rank) -> dict:
    """This rank's K2 / K2(d) launches over H1's cases: one for its shard
    where it holds slots below kv_len, one for an extra source."""
    s_loc = H_MEM_SLOTS // H_RANKS
    c = {"ca_fwd": 0, "ca_fwd_q8": 0}
    for n, kv_len, _, q8, extra in h1_cases().values():
        if kv_len > rank * s_loc:
            c["ca_fwd_q8" if q8 else "ca_fwd"] += 1
        c["ca_fwd"] += int(extra)
    return c


def sharded_offline_launches(enc_cfg, dec_cfg, n_views, n_tok, s_loc, rank,
                             q8=False, refine=1, encode_bs=8, render_bs=8,
                             init=2) -> dict:
    """Launches of offline_reconstruction on one rank of an sp-sharded
    memory: the encoder and decoder SA as unsharded; per decoder layer and
    update step one K2 with the LSE on the step's new tokens (the extra
    source, bf16 also for an 8-bit memory) and one K2 (K2(d) for 8-bit) on
    this rank's shard where it holds slots below the step's start; the
    render reads the shard where it holds slots below the fill."""
    depth = dec_cfg.depth
    starts = [0] + [(init + i) * n_tok for i in range(n_views - init)]
    full = n_views * n_tok
    starts += [full] * ((1 + n_views - init) * refine)
    renders = math.ceil(n_views / render_bs)
    c = {"sa_fwd": (math.ceil(n_views / encode_bs) * enc_cfg.depth
                    + (len(starts) + renders) * depth),
         "ca_fwd": 0, "ca_fwd_q8": 0}
    shard = "ca_fwd_q8" if q8 else "ca_fwd"
    for st in starts:
        c["ca_fwd"] += depth
        c[shard] += depth * int(st > rank * s_loc)
    c[shard] += renders * depth * int(full > rank * s_loc)
    return c


def h4_video(core, frames):
    """video_reconstruction at H4_KW; (outputs, the memory length at the
    start of every update step, the lengths it compacted at)."""
    from must3r_tpu_torch.engine import video as video_mod

    starts, compactions = [], []
    update, compact = core.update, video_mod.compact

    def counted_update(mem, *a, **kw):
        starts.append(mem.length)
        return update(mem, *a, **kw)

    def counted_compact(mem):
        compactions.append(mem.length)
        return compact(mem)

    core.update, video_mod.compact = counted_update, counted_compact
    try:
        out = video_mod.video_reconstruction(core, frames, **H4_KW)
    finally:
        del core.update
        video_mod.compact = compact
    return out, starts, compactions


def h4_launches(enc_cfg, dec_cfg, starts, s_loc, rank) -> dict:
    """Launches of H4 on one rank: the encoder in chunks of 8, per update
    step and decoder layer one SA, one K2 with the LSE on the step's new
    tokens and one on this rank's shard where it holds slots below the
    step's start (the memory's length then, which compaction resets)."""
    depth = dec_cfg.depth
    return {"sa_fwd": (math.ceil(H4_FRAMES / 8) * enc_cfg.depth
                       + len(starts) * depth),
            "ca_fwd": depth * (len(starts)
                               + sum(st > rank * s_loc for st in starts)),
            "ca_fwd_q8": 0}


def _h_images(dev, seed, shape):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.rand(*shape, generator=gen, device=dev) * 2 - 1


def rank_worker(rank, port, out_dir):
    """One rank of phase H (H1, H2, H3's fused scenes) on cuda:0, gloo;
    writes its outputs, launch counts, times and peak memory."""
    import faulthandler

    faulthandler.dump_traceback_later(H_TIMEOUT - 20, exit=True)
    from must3r_tpu_torch import must3r_512_configs
    from must3r_tpu_torch.checkpoint import init_model
    from must3r_tpu_torch.engine.inference import (InferenceCore,
                                                   make_fused_offline,
                                                   offline_reconstruction,
                                                   use_full_fp32_matmuls)
    from must3r_tpu_torch.memory import quantize_kv
    from must3r_tpu_torch.ops import _kernels
    from must3r_tpu_torch.ops.attention import (launch_counts,
                                                reset_launch_counts)
    from must3r_tpu_torch.parallel import (Mesh, barrier, describe,
                                           init_distributed, make_mesh,
                                           pick_device,
                                           sharded_memory_cross_attention)

    use_full_fp32_matmuls()
    if not init_distributed(f"127.0.0.1:{port}", H_RANKS, rank):
        raise AssertionError("rank worker: no process group")
    dev = pick_device(rank)
    log(f"[H] {describe(dev)}")
    # every K2 on the sharded path asks for the LSE: count the calls that
    # do not (the K2 wrapper's own counter counts both)
    no_stats = []

    class CountedK2:
        """K2 with its calls without the LSE counted; the wrapper's own
        launch counter (which it reaches by its module name) is kept."""
        fn = staticmethod(_kernels.ca_fwd)
        launches = property(lambda self: self.fn.launches,
                            lambda self, v: setattr(self.fn, "launches", v))

        def __call__(self, *a, return_stats=False, **kw):
            if not return_stats:
                no_stats.append(1)
            return self.fn(*a, return_stats=return_stats, **kw)

    _kernels.ca_fwd = CountedK2()
    sp = make_mesh(mp=H_RANKS, axis_names=("dp", "sp"))
    res = {"rank": rank}
    totals = {}

    def counted(fn):
        sync()
        barrier()
        reset_launch_counts()
        del no_stats[:]
        t0 = time.perf_counter()
        out = fn()
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        counts = launch_counts()
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
        return out, counts, ms, len(no_stats)

    # -- H1: the sharded CA at its kernel ----------------------------------
    kv, labels, new, q = h1_memory(dev, SEED + 30)
    codes, scale = quantize_kv(kv, torch.int8)
    s_loc = H_MEM_SLOTS // H_RANKS
    mine = slice(rank * s_loc, (rank + 1) * s_loc)

    def h1():
        outs = {}
        for name, (n, kv_len, q_self, q8, extra) in h1_cases().items():
            qs = torch.full((1, 1), q_self, dtype=torch.int32, device=dev)
            outs[name] = sharded_memory_cross_attention(
                sp, q[n], (codes if q8 else kv)[:, :, mine].contiguous(),
                labels[:, mine].contiguous(), q_self=qs, kv_len=kv_len,
                extra_kv=new if extra else None,
                extra_labels=(torch.full((1, H1_TOK), 9, dtype=torch.int32,
                                         device=dev) if extra else None),
                kv_scale=scale[..., mine].contiguous() if q8 else None)
        return outs

    outs, counts, _, ns = counted(h1)
    res["h1"] = {k: v.cpu() for k, v in outs.items()}
    res["h1_counts"], res["h1_no_stats"] = counts, ns
    del kv, labels, new, q, codes, scale, outs

    # -- H2: sp = 2 at full width ------------------------------------------
    enc_cfg, dec_cfg = must3r_512_configs()
    enc, dec = init_model(enc_cfg, dec_cfg, seed=SEED, device=dev)
    imgs = _h_images(dev, SEED + 31, (N_VIEWS, *HW, 3))
    for tag, quant in (("bf16", None), ("int8", "int8")):
        core = InferenceCore(enc, dec, enc_cfg, dec_cfg, kv_quant=quant,
                             mesh=sp)
        out, counts, ms, ns = counted(lambda: offline_reconstruction(
            core, imgs, num_refinement_iterations=1))
        res[f"h2_{tag}"] = {k: v.cpu() for k, v in out.items()}
        res[f"h2_{tag}_counts"], res[f"h2_{tag}_no_stats"] = counts, ns
        res[f"h2_{tag}_ms"] = ms
    # a warm request, timed (host clock, synced, both ranks started together)
    core = InferenceCore(enc, dec, enc_cfg, dec_cfg, mesh=sp)
    _, _, res["h2_warm_ms"], _ = counted(lambda: offline_reconstruction(
        core, imgs, num_refinement_iterations=1))

    # -- H4: video on the sp = 2 core, its sharded memory compacting -------
    frames = _h_images(dev, SEED + 33, (H4_FRAMES, *HW, 3))
    (out, starts, compactions), counts, ms, ns = counted(
        lambda: h4_video(core, frames))
    res["h4"] = {k: (v if k == "keyframes" else torch.as_tensor(v))
                 for k, v in out.items()}
    res["h4_starts"], res["h4_compactions"] = starts, compactions
    res["h4_counts"], res["h4_no_stats"], res["h4_ms"] = counts, ns, ms

    # -- H3: dp = 2 fused scenes -------------------------------------------
    dp = Mesh((H_RANKS,), ("dp",))
    core = InferenceCore(enc, dec, enc_cfg, dec_cfg)
    scenes = _h_images(dev, SEED + 32, (2, N_VIEWS, *HW, 3))
    run = make_fused_offline(core, N_VIEWS, HW, n_scenes=2, mesh=dp)
    out, counts, ms, _ = counted(lambda: run(scenes))
    res["h3"] = {k: v.cpu() for k, v in out.items()}
    res["h3_counts"], res["h3_ms"] = counts, ms
    res["totals"] = totals
    res["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    barrier()
    import torch.distributed as dist
    dist.destroy_process_group()


def _step_losses(out_dir):
    """Per-step losses of a one-step-an-epoch run, from its log (the
    logged loss is the running mean)."""
    with open(os.path.join(out_dir, "log.txt")) as f:
        means = [json.loads(x)["loss"] for x in f.read().splitlines()]
    return [m * (i + 1) - (means[i - 1] * i if i else 0.0)
            for i, m in enumerate(means)]


def phase_parallel(dev, enc_cfg, dec_cfg, totals):
    """H1 the sharded CA (K2 / K2(d) with the LSE, and the merge) at sp = 2
    against the unsharded kernel; H2 offline_reconstruction with one
    refinement through InferenceCore(mesh=sp2) at full width, bf16 against
    the unsharded run and int8 against the sp = 1 sharded path; H3
    make_fused_offline over dp = 2 against the one-process 2-scene run, and
    cli.train as two processes through MUST3R_* against one process with
    the same global batch. Ranks are subprocesses of this script on
    cuda:0."""
    import re
    import sys
    import tempfile

    from must3r_tpu_torch.checkpoint import init_model
    from must3r_tpu_torch.engine.inference import (InferenceCore,
                                                   make_fused_offline,
                                                   offline_reconstruction)
    from must3r_tpu_torch.memory import (dequantize_kv, quantize_kv,
                                         round_capacity)
    from must3r_tpu_torch.ops import _kernels
    from must3r_tpu_torch.parallel import Mesh

    t_phase = time.perf_counter()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("MUST3R_")}
    with tempfile.TemporaryDirectory() as tmp:
        port = _free_port()
        _run_procs("ranks", [[sys.executable, os.path.abspath(__file__),
                              "--rank-worker", str(r), "--port", str(port),
                              "--out", tmp] for r in range(H_RANKS)],
                   [env] * H_RANKS, tmp)
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                            weights_only=False) for r in range(H_RANKS)]
        for r in ranks:
            for k, v in r["totals"].items():
                totals[k] = totals.get(k, 0) + v

        # -- H1 ----------------------------------------------------------
        kv, labels, new, q = h1_memory(dev, SEED + 30)
        codes, scale = quantize_kv(kv, torch.int8)
        for name, (n, kv_len, q_self, q8, extra) in h1_cases().items():
            qs = torch.full((1, 1), q_self, dtype=torch.int32, device=dev)
            qu = torch.full((1, 1), 2 ** 31 - 1, dtype=torch.int32,
                            device=dev)
            if q8 and not extra:
                want = _kernels.ca_fwd_q8(q[n], codes, scale, labels, qs, qu,
                                          kv_len)
            else:
                mem = dequantize_kv(codes, scale) if q8 else kv
                cat = torch.cat([mem[:, :, :kv_len], new], dim=2) \
                    if extra else mem
                lab = torch.cat([labels[:, :kv_len], torch.full(
                    (1, H1_TOK), 9, dtype=torch.int32, device=dev)], dim=1) \
                    if extra else labels
                want = _kernels.ca_fwd(q[n], cat.contiguous(),
                                       lab.contiguous(), qs, qu,
                                       kv_len + (H1_TOK if extra else 0))
            for r in ranks:
                e = kernel_error(r["h1"][name].to(dev), want)
                if not e["ok"]:
                    raise AssertionError(f"H1 {name} rank {r['rank']}: {e}")
            log(f"[H] H1 {name}: sharded vs unsharded kernel max_abs_err "
                f"{e['max_abs_err']:.3e} (bound {e['max_abs_bound']:.3e}), "
                f"rel_rmse {e['rel_rmse']:.3e}")
        for r in ranks:
            want = h1_launches(r["rank"])
            got = {k: r["h1_counts"][k] for k in want}
            log(f"[H] H1 rank {r['rank']}: launches {got} (expected {want}),"
                f" K2 calls without the LSE {r['h1_no_stats']}")
            if got != want or r["h1_no_stats"]:
                raise AssertionError(f"H1 rank {r['rank']}: {got} != {want}")
        del kv, labels, new, q, codes, scale

        # -- H2 ----------------------------------------------------------
        n_tok = (HW[0] // dec_cfg.patch_size) * (HW[1] // dec_cfg.patch_size)
        enc, dec = init_model(enc_cfg, dec_cfg, seed=SEED, device=dev)
        imgs = _h_images(dev, SEED + 31, (N_VIEWS, *HW, 3))
        core = InferenceCore(enc, dec, enc_cfg, dec_cfg)
        ref = offline_reconstruction(core, imgs, num_refinement_iterations=1)
        sp1 = Mesh((1,), ("sp",))
        q8_ref = offline_reconstruction(
            InferenceCore(enc, dec, enc_cfg, dec_cfg, kv_quant="int8",
                          mesh=sp1), imgs, num_refinement_iterations=1)
        sharded1 = InferenceCore(enc, dec, enc_cfg, dec_cfg, mesh=sp1)
        offline_reconstruction(sharded1, imgs, num_refinement_iterations=1)
        sync()
        t0 = time.perf_counter()
        offline_reconstruction(sharded1, imgs, num_refinement_iterations=1)
        sync()
        sp1_ms = (time.perf_counter() - t0) * 1e3
        # the memory of 10 views and the refinement's 2 of slack, in
        # blocks of 1024 x sp
        s_loc = round_capacity((N_VIEWS + 2) * n_tok, 1024 * H_RANKS
                               ) // H_RANKS
        for tag, want_out in (("bf16", ref), ("int8", q8_ref)):
            for r in ranks:
                got = r[f"h2_{tag}"]
                check_result(f"H2 {tag} rank {r['rank']}", got, N_VIEWS, HW)
                errs = {k: rel_rmse(got[k], want_out[k].cpu())
                        for k in ("pts3d", "pts3d_local")}
                want = sharded_offline_launches(
                    enc_cfg, dec_cfg, N_VIEWS, n_tok, s_loc, r["rank"],
                    q8=tag == "int8")
                counts = {k: r[f"h2_{tag}_counts"][k] for k in want}
                log(f"[H] H2 {tag} rank {r['rank']}: relative RMSE vs "
                    f"{'the unsharded run' if tag == 'bf16' else 'sp = 1'} "
                    f"{errs} (bound {RMSE_TOL}); launches {counts} "
                    f"(expected {want}), K2 without the LSE "
                    f"{r[f'h2_{tag}_no_stats']}; "
                    f"{r[f'h2_{tag}_ms']:.1f} ms (first request)")
                if counts != want or r[f"h2_{tag}_no_stats"]:
                    raise AssertionError(f"H2 {tag} rank {r['rank']}: "
                                         f"launches {counts} != {want}")
                for k, e in errs.items():
                    if not e <= RMSE_TOL:
                        raise AssertionError(f"H2 {tag} {k}: {e}")
        log(f"[H] H2 request, MUSt3R_512 {N_VIEWS} views {HW[1]}x{HW[0]} "
            f"bf16, one refinement, warm, host clock, synced: sp = 1 "
            f"{sp1_ms:.1f} ms (one process); sp = 2 "
            f"{max(r['h2_warm_ms'] for r in ranks):.1f} ms (two ranks "
            f"sharing one card, gloo staging every collective through the "
            f"host: no speed-up is claimed); {card_line()}")
        del ref, q8_ref

        # -- H4 ----------------------------------------------------------
        frames = _h_images(dev, SEED + 33, (H4_FRAMES, *HW, 3))
        sync()
        t0 = time.perf_counter()
        want_out, want_starts, want_comp = h4_video(sharded1, frames)
        sync()
        sp1_ms = (time.perf_counter() - t0) * 1e3
        s_loc = H4_KW["capacity_images"] * n_tok // H_RANKS
        if len(want_comp) < 3 or len(want_starts) != 2 * (H4_FRAMES - 1):
            raise AssertionError(f"H4 sp = 1: compactions {want_comp}, "
                                 f"{len(want_starts)} update steps")
        for r in ranks:
            got = r["h4"]
            check_result(f"H4 rank {r['rank']}", {
                k: v for k, v in got.items() if k != "keyframes"},
                H4_FRAMES, HW)
            errs = {k: rel_rmse(got[k], torch.as_tensor(want_out[k]))
                    for k in ("pts3d", "pts3d_local")}
            want = h4_launches(enc_cfg, dec_cfg, r["h4_starts"], s_loc,
                               r["rank"])
            counts = {k: r["h4_counts"][k] for k in want}
            log(f"[H] H4 video rank {r['rank']}, {H4_FRAMES} frames, window "
                f"3, one refinement, capacity 16 images: compacted at "
                f"lengths {r['h4_compactions']} (sp = 1: {want_comp}); "
                f"keyframes {got['keyframes']}; relative RMSE vs sp = 1 "
                f"{errs} (bound {RMSE_TOL}); launches {counts} (expected "
                f"{want}), K2 without the LSE {r['h4_no_stats']}; "
                f"{r['h4_ms']:.1f} ms (sp = 1: {sp1_ms:.1f} ms)")
            if r["h4_starts"] != want_starts or \
                    r["h4_compactions"] != want_comp or \
                    got["keyframes"] != want_out["keyframes"]:
                raise AssertionError(f"H4 rank {r['rank']}: schedule "
                                     f"{r['h4_starts']} != {want_starts}")
            if counts != want or r["h4_no_stats"]:
                raise AssertionError(f"H4 rank {r['rank']}: launches "
                                     f"{counts} != {want}")
            for k, e in errs.items():
                if not e <= RMSE_TOL:
                    raise AssertionError(f"H4 {k}: {e}")
        del sharded1, want_out

        # -- H3: fused scenes over dp --------------------------------------
        scenes = _h_images(dev, SEED + 32, (2, N_VIEWS, *HW, 3))
        want_out = make_fused_offline(core, N_VIEWS, HW, n_scenes=2)(scenes)
        for r in ranks:
            got = r["h3"]
            errs = {k: rel_rmse(got[k], want_out[k].cpu())
                    for k in ("pts3d", "pts3d_local")}
            sa, ca = expected_launches(enc_cfg, dec_cfg, N_VIEWS, True)
            counts = (r["h3_counts"]["sa_fwd"], r["h3_counts"]["ca_fwd"])
            log(f"[H] H3 fused dp = 2 rank {r['rank']}: 2 scenes returned "
                f"({tuple(got['pts3d'].shape)}), relative RMSE vs the "
                f"one-process run {errs}; launches {counts} (expected "
                f"{(sa, ca)}: one scene a rank); {r['h3_ms']:.1f} ms; peak "
                f"device memory {r['peak_gib']:.2f} GiB")
            if tuple(got["pts3d"].shape[:2]) != (2, N_VIEWS) or \
                    counts != (sa, ca):
                raise AssertionError(f"H3 rank {r['rank']}: {counts}")
            for k, e in errs.items():
                if not e <= RMSE_TOL:
                    raise AssertionError(f"H3 {k}: {e}")
        del enc, dec, core, want_out, ranks
        torch.cuda.empty_cache()
        sync()

        # -- H3: cli.train, two processes vs one --------------------------
        spec = ("SyntheticScenes(num_views=4, resolutions=((512, 384),), "
                "render_hw=(384, 512), epoch_size=2, min_memory_num_views=4,"
                f" seed={SEED})")

        def args(out, batch):
            return [sys.executable, "-m", "must3r_tpu_torch.cli.train",
                    "--preset", "512", "--causal", "--dataset", spec,
                    "--epochs", "2", "--batch_size", str(batch),
                    "--memory_batch_views", "2", "--mem_dropout", "0.1",
                    "--num_workers", "0", "--print_freq", "1", "--seed",
                    str(SEED), "--output_dir", os.path.join(tmp, out)]

        port = _free_port()
        envs = [dict(env, MUST3R_COORDINATOR=f"127.0.0.1:{port}",
                     MUST3R_NUM_PROCESSES=str(H_RANKS),
                     MUST3R_PROCESS_ID=str(r)) for r in range(H_RANKS)]
        t0 = time.perf_counter()
        texts = _run_procs("train_dp", [args("dp", 1)] * H_RANKS, envs, tmp)
        dp_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        one = _run_procs("train_one", [args("one", 2)], [env], tmp)[0]
        one_s = time.perf_counter() - t0
        for r, text in enumerate(texts):
            want = f"process {r} of {H_RANKS}: backend gloo, device cuda:0"
            if want not in text or ("[1/1]" in text) != (r == 0):
                raise AssertionError(f"H3 cli rank {r}:\n{text[-2000:]}")
        with open(os.path.join(tmp, "dp", "log.txt")) as f:
            n_lines = len(f.read().splitlines())
        # one log line an epoch: rank 1 wrote none
        if n_lines != 2 or not os.path.exists(os.path.join(
                tmp, "dp", "checkpoint-final", "state.pth")):
            raise AssertionError(f"H3 cli: {n_lines} log lines, or no "
                                 f"checkpoint-final")
        got, want = _step_losses(os.path.join(tmp, "dp")), \
            _step_losses(os.path.join(tmp, "one"))
        rel = [abs(a / b - 1) for a, b in zip(got, want)]
        peaks = [re.findall(r"peak device memory ([0-9.]+) GiB", t)
                 for t in texts + [one]]
        log(f"[H] H3 cli.train MUSt3R_512, 4 views 512x384, dropout 0.1: "
            f"dp = 2 (batch 1 a rank) step losses {got} vs one process "
            f"(batch 2) {want}: relative {rel} (bound {RMSE_TOL}); "
            f"{dp_s:.1f} s vs {one_s:.1f} s with start-up and checkpoints; "
            f"peak device memory GiB per rank {peaks[:H_RANKS]} (two ranks "
            f"sharing one card), one process {peaks[H_RANKS]}; "
            f"{card_line()}")
        if len(got) != 2 or not all(e <= RMSE_TOL for e in rel):
            raise AssertionError(f"H3 cli: losses {got} vs {want}")
    sync()
    log(f"[H] phase H: {time.perf_counter() - t_phase:.1f} s")

# ---------------------------------------------------------------------------
# I. the surfaces: the live viewer, the web demo, the SLAM web GUI, the
#    soak, profiling and the 8-bit accuracy tool
# ---------------------------------------------------------------------------

# The smoke is its own HTTP client, on 127.0.0.1: every request has a
# timeout of I_TIMEOUT s and every poll a deadline of I_DEADLINE s; an
# expired deadline, a /status of "error" or a failed check raises.
I_TIMEOUT = 10
I_DEADLINE = 300
I_VIEWS = 10
I_SLAM_FRAMES = 48


def http(port, path, body=None):
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                 method="GET" if body is None else "POST")
    with urllib.request.urlopen(req, timeout=I_TIMEOUT) as r:
        return r.read()


def wait_for(what, fn, deadline=I_DEADLINE, every=0.02):
    """Call fn() until it returns a true value; raise after ``deadline``
    seconds. fn's OSError (the server not up yet) counts as false."""
    end = time.monotonic() + deadline
    while time.monotonic() < end:
        try:
            got = fn()
        except OSError:
            got = None
        if got:
            return got
        time.sleep(every)
    raise AssertionError(f"[I] {what}: no result within {deadline} s")


def parse_snapshot(tag, blob):
    """(version, points, cameras) of a live-viewer snapshot; its header's
    counts must match its payload and the cameras be finite."""
    import struct

    import numpy as np

    magic, version, n, ncam = struct.unpack("<IIII", blob[:16])
    want = 16 + 12 * n + -(-3 * n // 4) * 4 + 12 * ncam
    if magic != 0x4D553352 or len(blob) != want:
        raise AssertionError(f"[I] {tag}: snapshot magic {magic:#x}, "
                             f"{len(blob)} bytes for {n} points and {ncam} "
                             f"cameras ({want} expected)")
    cams = np.frombuffer(blob[want - 12 * ncam:], "<f4")
    if not np.isfinite(cams).all():
        raise AssertionError(f"[I] {tag}: cameras not finite")
    return version, n, ncam


def glb_points(tag, path) -> int:
    """Points of a GLB's POINTS primitives, checking its header and chunk
    lengths."""
    import struct

    with open(path, "rb") as f:
        blob = f.read()
    magic, version, total = struct.unpack("<III", blob[:12])
    jlen, jtype = struct.unpack("<II", blob[12:20])
    blen, btype = struct.unpack("<II", blob[20 + jlen:28 + jlen])
    if (magic, version, total, jtype, btype) != (
            0x46546C67, 2, len(blob), 0x4E4F534A, 0x004E4942) or \
            28 + jlen + blen != len(blob):
        raise AssertionError(f"[I] {tag}: {path} is not a glTF 2.0 binary")
    doc = json.loads(blob[20:20 + jlen])
    return sum(doc["accessors"][m["primitives"][0]["attributes"]
                                ["POSITION"]]["count"]
               for m in doc["meshes"] if m["primitives"][0]["mode"] == 0)


def same_scene(tag, a, b):
    import numpy as np

    for k in ("pts3d", "pts3d_local", "conf", "focals", "cams2world",
              "image_list"):
        if not np.array_equal(getattr(a, k), getattr(b, k)):
            raise AssertionError(f"[I] {tag}: {k} differs")


def multi_ar_launches(enc_cfg, dec_cfg, buckets, joint_init=True,
                      encode_bs=8, render_bs=8) -> dict:
    """Launches of offline_reconstruction_multi_ar with every view in the
    memory: per bucket the encoder and render chunks, the init pair as one
    update where it shares a bucket, then 1-view updates."""
    n = sum(buckets)
    updates = (1 + n - 2) if joint_init else n
    enc = sum(math.ceil(b / encode_bs) for b in buckets)
    render = sum(math.ceil(b / render_bs) for b in buckets)
    return {"sa_fwd": enc * enc_cfg.depth + (updates + render) * dec_cfg.depth,
            "ca_fwd": (updates + render) * dec_cfg.depth}


def phase_surfaces(dev, enc_cfg, dec_cfg, totals, preset="512"):
    """I1 cli.reconstruct --live (bf16 and int8) against the same runs
    without the viewer; I2 WebDemo over HTTP (retrieval, bitwise the direct
    must3r_inference; then a mixed-aspect upload through the multi-aspect
    driver); I3 cli.slam_cli --web (panels, pause / resume) and --live
    against the run without them; I4 tools.soak_vo at 512; I5
    utils.profiling.trace around one C request; I6 tools.quant_accuracy on
    the tiny fixture."""
    import contextlib
    import io
    import pickle
    import re
    import tempfile
    import threading

    import numpy as np
    import PIL.Image

    from must3r_tpu_torch.checkpoint import init_model
    from must3r_tpu_torch.cli import reconstruct as reconstruct_cli
    from must3r_tpu_torch.cli import slam_cli
    from must3r_tpu_torch.demo import inference as demo_inference
    from must3r_tpu_torch.demo.export import gather_scene_points
    from must3r_tpu_torch.demo.webapp import WebDemo
    from must3r_tpu_torch.engine.inference import InferenceCore
    from must3r_tpu_torch.tools import quant_accuracy, soak_vo
    from must3r_tpu_torch.tools.image import preprocess_image
    from must3r_tpu_torch.tools.profile_offline import kernel_group
    from must3r_tpu_torch.utils.profiling import (PhaseTimer,
                                                  device_memory_stats, trace)

    mine = {}

    def counted(fn):
        out, counts = _counted(fn)
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
            mine[k] = mine.get(k, 0) + v
        return out, counts

    t_phase = time.perf_counter()
    card = card_line()
    retrieval = retrieval_launches(enc_cfg, dec_cfg, I_VIEWS, I_VIEWS)

    def q8_of(c):
        return dict(c, ca_fwd=0, ca_fwd_q8=c["ca_fwd"])

    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "imgs")
        os.makedirs(src)
        pngs = []
        for i, f in enumerate(slam_frames(I_VIEWS, SEED + 40)):
            path = os.path.join(src, f"{i:03d}.png")
            PIL.Image.fromarray(f).save(path)
            pngs.append(path)

        # -- I1: cli.reconstruct, with and without --live -----------------
        request_ms = []
        infer = demo_inference.must3r_inference

        def timed_infer(*a, **kw):
            sync()
            t0 = time.perf_counter()
            out = infer(*a, **kw)
            sync()
            request_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        def cli(out_dir, extra):
            demo_inference.must3r_inference = timed_infer
            try:
                return counted(lambda: reconstruct_cli.main(
                    ["--input", src, "--output_dir", out_dir, "--preset",
                     preset, "--seed", str(SEED), *extra]))[1]
            finally:
                demo_inference.must3r_inference = infer

        for quant in ([], ["--kv_quant", "int8"]):
            tag = "int8" if quant else "bf16"
            want = q8_of(retrieval) if quant else retrieval
            bare_dir = os.path.join(tmp, f"bare_{tag}")
            counts = cli(bare_dir, quant)
            _check_counts(f"I1 cli.reconstruct {tag} without --live "
                          f"({request_ms[-1]:.1f} ms must3r_inference)",
                          {k: counts[k] for k in want}, want, "I")
            port = _free_port()
            seen, last, stop = [], [], threading.Event()

            def poll():
                end = time.monotonic() + I_DEADLINE
                while not stop.is_set() and time.monotonic() < end:
                    try:
                        v = int(http(port, "/version"))
                        if not seen or v != seen[-1]:
                            seen.append(v)
                            last[:] = [http(port, "/data.bin")]
                    except OSError:
                        pass
                    time.sleep(0.02)

            poller = threading.Thread(target=poll, daemon=True)
            poller.start()
            live_dir = os.path.join(tmp, f"live_{tag}")
            try:
                counts = cli(live_dir, quant + ["--live", "--live_port",
                                                str(port), "--live_hold",
                                                "1.5"])
            finally:
                stop.set()
                poller.join(I_TIMEOUT + 5)
            _check_counts(f"I1 cli.reconstruct {tag} --live "
                          f"({request_ms[-1]:.1f} ms must3r_inference)",
                          {k: counts[k] for k in want}, want, "I")
            # versions grow: one a memory batch (the init pair, then one a
            # view), then the finished scene, published after the run
            batches = 1 + I_VIEWS - 2
            if seen != sorted(set(seen)) or not last or \
                    seen[-1] != batches + 1:
                raise AssertionError(f"[I] I1 {tag}: versions seen {seen}, "
                                     f"{batches + 1} expected last")
            version, n_pts, n_cams = parse_snapshot(f"I1 {tag}", last[0])
            scenes = []
            for d in (live_dir, bare_dir):
                with open(os.path.join(d, "scene.pkl"), "rb") as f:
                    scenes.append(pickle.load(f))
            same_scene(f"I1 {tag} scene.pkl with --live vs without",
                       *scenes)
            # the finished scene at the page's threshold, at most the
            # viewer's 400k points
            if n_pts != min(int((scenes[0].conf > 1.5).sum()), 400_000) or \
                    n_cams != I_VIEWS:
                raise AssertionError(f"[I] I1 {tag}: last snapshot {n_pts} "
                                     f"points, {n_cams} cameras")
            glbs = {}
            for thr in (1.5, 3.0, 5.0):
                glbs[thr] = glb_points(f"I1 {tag}", os.path.join(
                    live_dir, f"scene_conf{thr:g}.glb"))
                want_n = len(gather_scene_points(scenes[0], thr)[0])
                if glbs[thr] != want_n:
                    raise AssertionError(f"[I] I1 {tag}: GLB at {thr} holds "
                                         f"{glbs[thr]} points, not {want_n}")
            with open(os.path.join(live_dir, "scene.html")) as f:
                html = f.read()
            n_html = len(gather_scene_points(scenes[0], 1.5, 400_000)[0])
            if f"{n_html} points" not in html:
                raise AssertionError(f"[I] I1 {tag}: scene.html does not "
                                     f"carry {n_html} points")
            log(f"[I] I1 cli.reconstruct {tag}, {I_VIEWS} PNGs "
                f"{HW[1]}x{HW[0]}, retrieval: must3r_inference "
                f"{request_ms[-2]:.1f} ms without --live, "
                f"{request_ms[-1]:.1f} ms with it (host clock, synced, the "
                f"first request of each process's model); versions seen "
                f"{seen}; last snapshot v{version}, {n_pts} points, "
                f"{n_cams} cameras; scene.pkl bitwise equal; GLB points "
                f"{glbs}; scene.html {n_html} points; {card}")

        # -- I2: the web demo ---------------------------------------------
        enc, dec = init_model(enc_cfg, dec_cfg, seed=SEED, device=dev)
        core = InferenceCore(enc, dec, enc_cfg, dec_cfg)
        app = WebDemo(core, image_size=HW[1], port=0, verbose=False)
        port = app.viewer.port
        try:
            def run_web(settings):
                sync()
                t0 = time.perf_counter()
                if not json.loads(http(port, "/run", json.dumps(
                        settings).encode())).get("ok"):
                    raise AssertionError("[I] I2: /run refused")
                st = wait_for("I2 /status", lambda: (lambda s: s if s[
                    "state"] in ("done", "error") else None)(
                        json.loads(http(port, "/status"))))
                sync()
                if st["state"] != "done":
                    raise AssertionError(f"[I] I2: {st}")
                return (time.perf_counter() - t0) * 1e3

            blobs = []
            for i, path in enumerate(pngs):
                with open(path, "rb") as f:
                    blobs.append(f.read())
                got = json.loads(http(port, f"/upload?name=im{i}.png",
                                      blobs[-1]))
                if got != {"count": i + 1}:
                    raise AssertionError(f"[I] I2 upload: {got}")
            web_ms, counts = counted(lambda: run_web({"mode": "retrieval"}))
            _check_counts(f"I2 WebDemo retrieval, {I_VIEWS} uploads "
                          f"({web_ms:.1f} ms from /run to done)",
                          {k: counts[k] for k in retrieval}, retrieval, "I")
            glb_path = os.path.join(tmp, "web.glb")
            with open(glb_path, "wb") as f:
                f.write(http(port, "/export.glb?conf_thr=1.5"))
            n_glb = glb_points("I2", glb_path)
            if http(port, "/export.ply?conf_thr=1.5")[:3] != b"ply":
                raise AssertionError("[I] I2: /export.ply is not a PLY")
            views = []
            for i, b in enumerate(blobs):
                v = preprocess_image(np.asarray(PIL.Image.open(
                    io.BytesIO(b)).convert("RGB")), HW[1])
                v["path"] = f"im{i}.png"
                views.append(v)
            direct = infer(core, views)
            same_scene("I2 WebDemo vs must3r_inference", app._scene, direct)
            if n_glb != len(gather_scene_points(direct, 1.5)[0]):
                raise AssertionError(f"[I] I2: GLB {n_glb} points")

            if json.loads(http(port, "/reset", b"")) != {"ok": True}:
                raise AssertionError("[I] I2: /reset refused")
            wide = (HW[1] * 9 // 16, HW[1])
            gen = torch.Generator().manual_seed(SEED + 42)
            for i in range(I_VIEWS):
                hw = HW if i < 6 else wide
                img = torch.randint(0, 256, (*hw, 3), generator=gen,
                                    dtype=torch.uint8).numpy()
                buf = io.BytesIO()
                PIL.Image.fromarray(img).save(buf, "PNG")
                http(port, f"/upload?name=m{i}.png", buf.getvalue())
            mixed_ms, counts = counted(lambda: run_web({"mode":
                                                        "retrieval"}))
            want = multi_ar_launches(enc_cfg, dec_cfg, [6, 4])
            _check_counts(f"I2 WebDemo mixed aspect (6 x {HW[1]}x{HW[0]}, "
                          f"4 x {wide[1]}x{wide[0]}) through the multi-aspect"
                          f" driver ({mixed_ms:.1f} ms)",
                          {k: counts[k] for k in want}, want, "I")
            shapes = sorted({tuple(p.shape[:2]) for p in app._scene.pts3d})
            if shapes != sorted([HW, wide]):
                raise AssertionError(f"[I] I2 mixed: shapes {shapes}")
        finally:
            app.close()
        log(f"[I] I2 WebDemo at {HW[1]}x{HW[0]}: retrieval request "
            f"{web_ms:.1f} ms from /run to done (host clock, status polled "
            f"every 20 ms), scene bitwise the direct must3r_inference, GLB "
            f"{n_glb} points; mixed aspect {mixed_ms:.1f} ms; {card}")
        del app, core, direct

        # -- I3: cli.slam_cli --web and --live -----------------------------
        frames_dir = os.path.join(tmp, "frames")
        os.makedirs(frames_dir)
        for i, f in enumerate(slam_frames(I_SLAM_FRAMES, SEED + 41)):
            PIL.Image.fromarray(f).save(os.path.join(frames_dir,
                                                     f"{i:03d}.png"))
        slam_want = slam_launches(enc_cfg, dec_cfg, I_SLAM_FRAMES)

        def slam_args(out, extra=()):
            # keyframes forced open (random weights) up to 16: the map
            # grows, then every frame renders against the full memory
            return ["--preset", preset, "--seed", str(SEED), "--input",
                    frames_dir, "--output_dir", os.path.join(tmp, out),
                    "--subsamp", "1", "--keyframe_overlap_thr", "-1",
                    "--min_conf_keyframe", "0", "--max_keyframes", "16",
                    *extra]

        def slam_run(out, extra=(), client=None):
            """slam_cli on a worker thread while ``client`` (if any) runs
            here; (counts, fps and keyframes the CLI printed)."""
            buf, err = io.StringIO(), []

            def run():
                try:
                    slam_cli.main(slam_args(out, extra))
                except BaseException as e:
                    err.append(e)

            worker = threading.Thread(target=run, daemon=True)

            def go():
                worker.start()
                try:
                    if client is not None:
                        client()
                finally:
                    worker.join(I_DEADLINE)
                if worker.is_alive():
                    raise AssertionError(f"[I] I3 {out}: still running "
                                         f"after {I_DEADLINE} s")
                if err:
                    raise err[0]

            with contextlib.redirect_stdout(buf):
                _, counts = counted(go)
            m = re.search(r"processed (\d+) frames in [0-9.]+s \(([0-9.]+) "
                          r"fps\), (\d+) keyframes", buf.getvalue())
            _check_counts(f"I3 slam_cli {out}", {k: counts[k] for k in
                                                 slam_want}, slam_want, "I")
            return float(m.group(2)), int(m.group(3))

        def poses(out):
            z = np.load(os.path.join(tmp, out, "all_poses.npz"),
                        allow_pickle=True)
            return {k: z[k] for k in z.files if k != "fps"}

        def same_poses(tag, a, b):
            for k in a:
                same = (repr(a[k].tolist()) == repr(b[k].tolist())
                        if a[k].dtype == object else np.array_equal(a[k],
                                                                    b[k]))
                if not same:
                    raise AssertionError(f"[I] I3 {tag}: {k} differs")

        fps_bare, n_kf = slam_run("slam_bare")
        want_poses = poses("slam_bare")
        gport = _free_port()
        fps_web, _ = slam_run("slam_web", ["--web", "--web_every", "2",
                                           "--live_port", str(gport)])
        same_poses("--web", poses("slam_web"), want_poses)

        gport = _free_port()
        pause = {}

        def gui_client():
            def gui():
                return json.loads(http(gport, "/gui"))
            wait_for("I3 first panel", lambda: gui()["panels_version"] >= 1)
            http(gport, "/gui", json.dumps({"paused": True}).encode())
            time.sleep(1.0)             # the frame under way finishes
            g1 = gui()
            time.sleep(1.0)
            g2 = gui()
            if not g1["paused"] or g1 != g2:
                raise AssertionError(f"[I] I3: frames advanced while "
                                     f"paused: {g1} then {g2}")
            sizes = {}
            for name in ("frame", "depth", "conf"):
                img = PIL.Image.open(io.BytesIO(http(
                    gport, f"/panel/{name}.png")))
                sizes[name] = (img.height, img.width)
            if set(sizes.values()) != {HW}:
                raise AssertionError(f"[I] I3 panel sizes {sizes}")
            http(gport, "/gui", json.dumps({"paused": False}).encode())
            last = wait_for("I3 panels after the pause", lambda: (
                lambda g: g if g["panels_version"] > g1["panels_version"]
                else None)(gui()))
            pause.update(before=g1, after=last, sizes=sizes)

        slam_run("slam_pause", ["--web", "--web_every", "2", "--live_port",
                                str(gport), "--web_hold", "0.5"], gui_client)
        same_poses("--web with a pause", poses("slam_pause"), want_poses)

        lport = _free_port()
        live = {}

        def live_client():
            # the viewer is up 1.5 s after the last frame: its version then
            # counts every snapshot published
            def done():
                v = int(http(lport, "/version"))
                live["version"] = v
                return v >= n_kf
            wait_for("I3 --live snapshots", done)
            live["snapshot"] = parse_snapshot("I3 --live",
                                              http(lport, "/data.bin"))

        fps_live, _ = slam_run("slam_live", ["--live", "--live_port",
                                             str(lport), "--web_hold", "1.5"],
                               live_client)
        same_poses("--live", poses("slam_live"), want_poses)
        log(f"[I] I3 slam_cli {I_SLAM_FRAMES} frames {HW[1]}x{HW[0]}, "
            f"keyframes forced to {n_kf}: {fps_bare:.2f} frames/s bare, "
            f"{fps_web:.2f} with --web --web_every 2 (PNG panels on the "
            f"host), {fps_live:.2f} with --live (the CLI's own clock, the "
            f"model init excluded); pause held {pause['before']} for 1 s, "
            f"then {pause['after']}; panels {pause['sizes']}; --live "
            f"version {live['version']} for {n_kf} keyframes, last snapshot "
            f"{live['snapshot']}; all_poses.npz bitwise equal in each; "
            f"{card}")

        # -- I4: the soak at 512 --------------------------------------------
        out = os.path.join(tmp, "soak.json")
        t0 = time.perf_counter()
        report, _ = counted(lambda: soak_vo.main(
            ["--frames", "300", "--max_keyframes", "128", "--video_frames",
             "120", "--out", out]))
        video, slam = report["video"], report["slam"]
        log(f"[I] I4 soak_vo {HW[1]}x{HW[0]} ({time.perf_counter() - t0:.1f}"
            f" s): video {json.dumps(video)}; slam {json.dumps(slam)}; "
            f"{card}")
        if video["compactions"] < 2 or not video["keyframes_equal"] or \
                not video["pts3d_rel_rmse"] <= RMSE_TOL:
            raise AssertionError(f"[I] I4 video: {video}")
        if slam["keyframes"] != 128 or set(slam["kdtree_at_keyframes"]) != \
                {"64", "128"}:
            raise AssertionError(f"[I] I4 slam: {slam}")

        # -- I5: profiling around one C request ------------------------------
        gen = torch.Generator(device=dev).manual_seed(SEED + 43)
        imgs = torch.rand(N_VIEWS, *HW, 3, generator=gen, device=dev) * 2 - 1
        core = InferenceCore(enc, dec, enc_cfg, dec_cfg)
        timer = PhaseTimer()
        views = make_views(imgs)
        with timer.phase("warm request"):
            infer(core, views, num_mem_images=N_VIEWS, is_sequence=True)
        logdir = os.path.join(tmp, "trace")
        with trace(logdir):
            timer.materializing_phase("traced request", lambda: infer(
                core, views, num_mem_images=N_VIEWS, is_sequence=True))
        with open(os.path.join(logdir, "trace.json")) as f:
            events = json.load(f)["traceEvents"]
        kernels = {}
        for e in events:
            if e.get("cat") == "kernel":
                g = kernel_group(e.get("name", ""))
                kernels[g] = kernels.get(g, 0) + 1
        sa, ca = (kernels.get("attn_fwd_sm90<false", 0),
                  kernels.get("attn_fwd_sm90<true", 0))
        want_sa, want_ca = expected_launches(enc_cfg, dec_cfg, N_VIEWS, False)
        log(f"[I] I5 utils.profiling.trace around one C request: "
            f"{len(events)} events, kernel events by group {kernels}; "
            f"PhaseTimer:\n{timer.report()}\n[I] device_memory_stats "
            f"{device_memory_stats()}; {card}")
        if (sa, ca) != (want_sa, want_ca):
            raise AssertionError(f"[I] I5: the trace holds {sa} sa_fwd and "
                                 f"{ca} ca_fwd kernels, not {want_sa} and "
                                 f"{want_ca}")
        del enc, dec, core

        # -- I6: the 8-bit accuracy tool on the tiny fixture --------------
        out = os.path.join(tmp, "quant.json")
        report, counts = counted(lambda: quant_accuracy.main(
            ["--chkpt", os.path.join(ROOT, "tests", "fixtures",
                                     "demo_tiny_params.npz"),
             "--scenes", "4", "--out", out]))
        log(f"[I] I6 quant_accuracy, tiny fixture, 4 scenes of 4 views "
            f"64x48, bf16: {json.dumps(report['report'])}; launches "
            f"{counts}; {card}")
        if counts["ca_fwd_q8"] <= 0:
            raise AssertionError("[I] I6: K2(d) never launched")
    torch.cuda.empty_cache()
    sync()
    log(f"[I] phase I: {time.perf_counter() - t_phase:.1f} s; launches "
        f"{ {k: v for k, v in mine.items() if v} }")


# ---------------------------------------------------------------------------
# J. the learning demo
# ---------------------------------------------------------------------------

J1_EPOCHS = 3         # the tiny preset's epochs of 160 steps (phase J ~250 s)
J1_L21_RATIO = 0.7    # l21_global_mean after training <= this x before
J2_STEPS = 20
J2_LOSS_GAP = 5e-2    # largest relative per-step loss gap, kernels vs plain
J3_SCENES = 6         # tests/test_eval_anchor.py's slice of the protocol
J3_L21_REL = 0.35     # its tolerances against docs/EVAL_ANCHOR.json
J3_POSE_SHARE = 0.5


def _recording(trainer, n_tok, schedule=True):
    """Wrap a Trainer's step: every step's loss and launches are kept,
    and a step whose launches differ from its schedule's (from none, with
    ``schedule`` False: the plain versions) is kept in 'bad'."""
    import dataclasses

    from must3r_tpu_torch.ops.attention import launch_counts

    rec = {"losses": [], "launches": [], "bad": []}
    make = trainer._step

    def step_of(sched):
        fn = make(sched)
        ts = dataclasses.replace(trainer.ts, mem_batches=sched.mem_batches,
                                 train_decoder_skip=sched.skip_batches,
                                 n_render=len(sched.render_ids))
        want = (expected_train_launches(trainer.enc_cfg, trainer.dec_cfg,
                                        ts, n_tok) if schedule else
                {k: 0 for k in launch_counts()})

        def run(*args):
            before = launch_counts()
            out = fn(*args)
            got = {k: v - before[k] for k, v in launch_counts().items()}
            rec["losses"].append(float(out[2]))
            rec["launches"].append(got)
            if got != want:
                rec["bad"].append((sched, got, want))
            return out
        return run

    trainer._step = step_of
    return rec


def _quiet(fn):
    """fn() with its standard output kept, not printed (the Trainer's
    progress lines); returns (result, the output's last line)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    lines = buf.getvalue().strip().splitlines()
    return out, (lines[-1] if lines else "")


def _rot_deg(a, b):
    """Rotation angles (degrees) between the [..., 4, 4] poses a and b."""
    rel = a[..., :3, :3].transpose(-1, -2) @ b[..., :3, :3]
    tr = rel.diagonal(dim1=-2, dim2=-1).sum(-1)
    return torch.rad2deg(torch.arccos(((tr - 1) / 2).clamp(-1, 1)))


def phase_learning(dev, totals):
    """J1 the learning demo's tiny preset (encoder 6 x 256 finetuned,
    decoder 4 x 192, 64 x 48, batch 4, dropout 0.05, bf16) through the
    kernels: J1_EPOCHS epochs of 160 steps between two evaluations,
    every step's launches the schedule's, l21_global_mean after <=
    J1_L21_RATIO x before. J2 J2_STEPS steps from the same init, loader and
    Trainer seed with the kernels and with the plain versions: the largest
    relative per-step loss gap <= J2_LOSS_GAP. J3 the trained tiny fixture
    on the EVAL_ANCHOR protocol (10 views, pose, 6 scenes), bf16 through
    the kernels, within tests/test_eval_anchor.py's tolerances; on the same
    views bf16 kernels vs fp32 plain: pts3d relative RMSE <= RMSE_TOL, the
    focal's relative error and the pose deltas printed. J4 the 224 preset
    (MUSt3R_224 towers, causal, encoder frozen, batch 1) for one epoch of
    160 steps between two evaluations, every step's launches the
    schedule's."""
    import copy
    import shutil
    import tempfile

    from must3r_tpu_torch.checkpoint import (load_model, load_params_npz,
                                             params_from_jax)
    from must3r_tpu_torch.datasets import SyntheticScenes, get_data_loader
    from must3r_tpu_torch.engine import evaluate as ev
    from must3r_tpu_torch.engine.inference import InferenceCore
    from must3r_tpu_torch.ops.pose import estimate_focal_weiszfeld
    from must3r_tpu_torch.tools import train_synthetic_demo as demo

    t_phase = time.perf_counter()
    card = card_line()
    mine = {}

    def counted(fn):
        out, counts = _counted(fn)
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
            mine[k] = mine.get(k, 0) + v
        return out, counts

    def summed(launches):
        return {k: sum(c[k] for c in launches) for k in launches[0]}

    def evaluated(tag, p, params):
        want = eval_launches(p.enc, p.dec, [(demo.EVAL_BATCHES, 2)])
        rep, counts = counted(lambda: demo.run_eval(params, p))
        _check_counts(f"{tag} eval", counts, want, phase="J")
        return rep

    def tokens(p):
        return ((p.render_hw[0] // p.enc.patch_size)
                * (p.render_hw[1] // p.enc.patch_size))

    def short(rep):
        return {k: round(rep[k], 4) for k in ("l21_global_mean",
                                              "l21_local_mean", "rra@30",
                                              "rta@30", "auc@30")}

    def trained(tag, trainer, n_tok):
        rec = _recording(trainer, n_tok)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        (stats, last), counts = counted(lambda: _quiet(trainer.train))
        secs = time.perf_counter() - t0
        steps = len(rec["losses"])
        log(f"[J] {tag}: {steps} steps in {secs:.1f} s, {steps / secs:.3f} "
            f"steps/s (host clock, the loss read every step, checkpoints "
            f"included); loss first {rec['losses'][0]:.6f} last "
            f"{rec['losses'][-1]:.6f} (smoothed {stats['loss']:.6f}); peak "
            f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
            f"GiB; launches {counts}; {card}\n[J] {tag} Trainer: {last}")
        if rec["bad"]:
            sched, got, want = rec["bad"][0]
            raise AssertionError(f"[J] {tag}: {len(rec['bad'])} of {steps} "
                                 f"steps off the schedule, first {sched}: "
                                 f"{got} != {want}")
        if counts != summed(rec["launches"]):
            raise AssertionError(f"[J] {tag}: launches outside the steps")
        if not all(math.isfinite(x) for x in rec["losses"]):
            raise AssertionError(f"[J] {tag}: a loss is not finite")

    tmp = tempfile.mkdtemp(prefix="must3r_demo_")
    try:
        # -- J1: the tiny preset through the kernels ----------------------
        p = demo.preset()
        params = demo.init_params(p, dev)
        before = evaluated("J1 before", p, params)
        trainer = demo.make_trainer(p, params, J1_EPOCHS, dev,
                                    os.path.join(tmp, "j1"))
        trained(f"J1 tiny, {J1_EPOCHS} epochs", trainer, tokens(p))
        after = evaluated("J1 after", p, trainer.params)
        ratio = after["l21_global_mean"] / before["l21_global_mean"]
        log(f"[J] J1 eval (views2, pose, 8 batches of 4, bf16) before "
            f"{short(before)}; after {short(after)}; l21_global_mean "
            f"after / before {ratio:.4f} (bound {J1_L21_RATIO})")
        if not ratio <= J1_L21_RATIO:
            raise AssertionError(f"[J] J1: l21_global_mean fell only to "
                                 f"{ratio:.4f} x")
        del params, trainer

        # -- J2: kernels vs plain over 20 steps ---------------------------
        losses = {}
        for impl in (None, "plain"):
            trainer = demo.make_trainer(
                p, demo.init_params(p, dev), 1, dev,
                os.path.join(tmp, f"j2_{impl}"),
                loader=demo.make_train_loader(p, batches=J2_STEPS),
                impl=impl)
            rec = _recording(trainer, tokens(p), schedule=impl is None)
            _quiet(trainer.train)
            if rec["bad"]:
                raise AssertionError(f"[J] J2 impl={impl}: launches "
                                     f"{rec['bad'][0][1]}, not "
                                     f"{rec['bad'][0][2]}")
            losses[impl] = rec["losses"]
        gaps = [abs(a / b - 1) for a, b in zip(losses[None],
                                                losses["plain"])]
        log(f"[J] J2 {J2_STEPS} steps, kernels vs plain: losses "
            f"{[round(x, 5) for x in losses[None]]} vs "
            f"{[round(x, 5) for x in losses['plain']]}; largest relative "
            f"gap {max(gaps):.3e} at step {gaps.index(max(gaps))} (bound "
            f"{J2_LOSS_GAP})")
        if not (len(gaps) == J2_STEPS and max(gaps) <= J2_LOSS_GAP):
            raise AssertionError(f"[J] J2: gap {max(gaps):.3e}")
        del trainer

        # -- J3: the trained fixture on the EVAL_ANCHOR protocol ----------
        tree, enc_cfg, dec_cfg = load_params_npz(os.path.join(
            ROOT, "tests", "fixtures", "demo_tiny_params.npz"))
        enc, dec = load_model(*params_from_jax(tree, enc_cfg, dec_cfg),
                              enc_cfg, dec_cfg, device=dev)
        with open(os.path.join(ROOT, "docs", "EVAL_ANCHOR.json")) as f:
            anchor = json.load(f)["views10"]
        loader = get_data_loader(
            SyntheticScenes(num_views=10, epoch_size=20,
                            resolutions=((64, 48),), render_hw=(48, 64),
                            seed=11),
            batch_size=1, patch_size=dec_cfg.patch_size)
        core = InferenceCore(copy.deepcopy(enc), copy.deepcopy(dec),
                             enc_cfg, dec_cfg, dtype=torch.bfloat16)
        got, counts = counted(lambda: ev.evaluate(
            core, loader, num_views_list=(10,), pose_eval=True,
            max_batches=J3_SCENES, verbose=False)["views10"])
        _check_counts("J3 eval", counts,
                      eval_launches(enc_cfg, dec_cfg, [(J3_SCENES, 10)]),
                      phase="J")
        log(f"[J] J3 EVAL_ANCHOR protocol on the tiny fixture (views10, "
            f"pose, {J3_SCENES} scenes, bf16 kernels): {short(got)}; anchor "
            f"{short(anchor)}")
        for k in ("l21_global_mean", "l21_local_mean"):
            if not abs(got[k] - anchor[k]) <= J3_L21_REL * anchor[k]:
                raise AssertionError(f"[J] J3 {k}: {got[k]} vs the anchor's "
                                     f"{anchor[k]} (rel {J3_L21_REL})")
        for k in ("rra@30", "rta@30"):
            if not got[k] >= J3_POSE_SHARE * anchor[k]:
                raise AssertionError(f"[J] J3 {k}: {got[k]} < "
                                     f"{J3_POSE_SHARE} x {anchor[k]}")
        ref = InferenceCore(enc, dec, enc_cfg, dec_cfg, dtype=torch.float32,
                            impl="plain")
        rmse, focal, rot, trans = [], [], [], []
        for bi, batch in enumerate(loader):
            if bi >= J3_SCENES:
                break
            a = ev._forward_views(core, batch, 10)
            b = ev._forward_views(ref, batch, 10)
            rmse.append(max(rel_rmse(a[k], b[k])
                            for k in ("pts3d", "pts3d_local")))
            h, w = a["pts3d_local"].shape[-3:-1]
            fa, fb = (estimate_focal_weiszfeld(
                x["pts3d_local"].reshape(-1, h, w, 3)) for x in (a, b))
            focal.append(float(((fa - fb).abs() / fb.abs()).max()))
            ca, cb = (torch.from_numpy(ev._pred_c2w(x, "procrustes"))
                      for x in (a, b))
            rot.append(float(_rot_deg(ca, cb).max()))
            trans.append(float((ca[..., :3, 3] - cb[..., :3, 3]).abs().max()))
        log(f"[J] J3 bf16 kernels vs fp32 plain on the same "
            f"{J3_SCENES} x 10 views: pts3d relative RMSE up to "
            f"{max(rmse):.3e} (bound {RMSE_TOL}); focal relative error up "
            f"to {max(focal):.3e}; pose rotation up to {max(rot):.3f} deg, "
            f"translation up to {max(trans):.3e}")
        if not max(rmse) <= RMSE_TOL:
            raise AssertionError(f"[J] J3: pts3d {max(rmse):.3e} from fp32")
        del enc, dec, core, ref
        torch.cuda.empty_cache()

        # -- J4: the 224 preset at full width ------------------------------
        p = demo.preset(flagship=True)
        params = demo.init_params(p, dev)
        before = evaluated("J4 before", p, params)
        trainer = demo.make_trainer(p, params, 1, dev,
                                    os.path.join(tmp, "j4"))
        trained("J4 224, 1 epoch", trainer, tokens(p))
        after = evaluated("J4 after", p, trainer.params)
        log(f"[J] J4 eval (views2, pose, 8 batches of 1, bf16) before "
            f"{short(before)}; after {short(after)}")
        del params, trainer
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    sync()
    log(f"[J] phase J: {time.perf_counter() - t_phase:.1f} s; launches "
        f"{ {k: v for k, v in mine.items() if v} }")


# ---------------------------------------------------------------------------
# K. VGGT-1B
# ---------------------------------------------------------------------------

VGGT_FRAMES = 64
VGGT_HW = (392, 518)
VGGT_SEED = 2 ** 31 + 19
VGGT_MAPS = ("depth", "depth_conf", "world_points", "world_points_conf")


def vggt_schedule(cfg, n_frames: int, hw) -> tuple:
    """(launches, vggt_counts, glue_counts) of one VGGT request: K1 and the
    block glue G1-G4 once a block of the tower, the frame and the global
    attention (G3 twice), no other kernel; the frames, the tokens through
    global attention summed over its layers, and the DPT chunks of both
    heads; those blocks fused, the fp32 camera trunk's plain, each run
    camera_iterations times."""
    from must3r_tpu_torch.ops.attention import launch_counts
    tokens = cfg.n_special + (hw[0] // cfg.patch_size) * (
        hw[1] // cfg.patch_size)
    blocks = cfg.tower_depth + 2 * cfg.depth
    launches = {k: 0 for k in launch_counts()}
    launches["sa_fwd"] = blocks
    add_glue(launches, blocks)
    return launches, {
        "frames": n_frames, "global_tokens": cfg.depth * n_frames * tokens,
        "dpt_chunks": 2 * math.ceil(n_frames / cfg.dpt_frames_chunk)}, {
        "fused_blocks": blocks,
        "plain_blocks": cfg.camera_trunk_depth * cfg.camera_iterations}


def check_vggt(tag, out, n_frames, hw):
    """Every output of the expected shape and finite (the focal where both
    fields of view are positive: a field of view of 0 makes it infinite),
    every c2w a proper rotation."""
    h, w = hw
    want = {"depth": (n_frames, h, w, 1), "depth_conf": (n_frames, h, w),
            "world_points": (n_frames, h, w, 3),
            "world_points_conf": (n_frames, h, w), "pose_enc": (n_frames, 9),
            "c2w": (n_frames, 4, 4), "focal": (n_frames, 2)}
    seen = torch.as_tensor(out["pose_enc"])[:, 7:].gt(0).all(-1)
    for key, shape in want.items():
        t = torch.as_tensor(out[key])
        if tuple(t.shape) != shape:
            raise AssertionError(f"{tag} {key}: shape {tuple(t.shape)} != "
                                 f"{shape}")
        if not torch.isfinite(t[seen] if key == "focal" else t).all():
            raise AssertionError(f"{tag} {key}: not finite")
    det = torch.linalg.det(torch.as_tensor(out["c2w"])[:, :3, :3].double())
    if float((det - 1).abs().max()) > 1e-3:
        raise AssertionError(f"{tag}: det(R) {det.tolist()}")
    return seen


def phase_vggt(dev, totals, sa):
    """K1 at VGGT-1B's shapes against its plain version (phase B's bounds
    and times; the rows join B's ``sa``): global attention, one sequence
    of 64 x 1041 tokens, and frame attention, 64 ragged sequences of 1041.
    Then one request at full width (64 frames of 518 x 392, the
    benchmark's seeded weights of ``vggt_1b``) through ``vggt_inference``,
    counted against the schedule, its maps, pose_enc and c2w within
    RMSE_TOL of the same request with the plain attention."""
    import numpy as np

    from benchmark.vggt_weights import make_weights
    from must3r_tpu_torch.checkpoint import load_vggt
    from must3r_tpu_torch.config import vggt_1b_config
    from must3r_tpu_torch.demo.inference import vggt_inference
    from must3r_tpu_torch.engine.inference import VGGTCore
    from must3r_tpu_torch.models.layers import glue_counts, reset_glue_counts
    from must3r_tpu_torch.models.vggt import reset_vggt_counts, vggt_counts
    from must3r_tpu_torch.ops.attention import (launch_counts,
                                                reset_launch_counts,
                                                self_attention)

    t_phase = time.perf_counter()
    cfg = vggt_1b_config()
    n_tok = cfg.n_special + (VGGT_HW[0] // cfg.patch_size) * (
        VGGT_HW[1] // cfg.patch_size)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for name, shape in (
            ("global", (1, VGGT_FRAMES * n_tok, cfg.num_heads, cfg.head_dim)),
            ("frame", (VGGT_FRAMES, n_tok, cfg.num_heads, cfg.head_dim))):
        q, k, v = (torch.randn(*shape, generator=gen, device=dev
                               ).to(torch.bfloat16) for _ in range(3))
        _compare(f"sa {list(shape)} (VGGT {name})",
                 lambda: self_attention(q, k, v, impl=None),
                 lambda: self_attention(q, k, v, impl="plain"), sa,
                 sa_work(shape), sdpa_sa(q, k, v), tag="K")
        del q, k, v
        torch.cuda.empty_cache()

    with open(os.path.join(ROOT, "benchmark", "configs", "vggt_1b.json")) as f:
        weights = make_weights(json.load(f), VGGT_SEED, dev)
    model = load_vggt(weights, cfg, dev)
    del weights
    torch.cuda.empty_cache()
    core = VGGTCore(model)
    plain = VGGTCore(model, impl="plain")
    log(f"[K] VGGT-1B: {sum(p.numel() for p in model.parameters()) / 1e6:.1f}"
        f" M params")
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    frames = list(torch.rand(VGGT_FRAMES, *VGGT_HW, 3, generator=gen,
                             device=dev).cpu().numpy())

    tag = f"vggt_inference {VGGT_FRAMES} x {VGGT_HW[1]}x{VGGT_HW[0]}"
    sync()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    reset_vggt_counts()
    reset_glue_counts()
    t0 = time.perf_counter()
    out = vggt_inference(core, frames)
    secs = time.perf_counter() - t0
    got, got_v, got_g = launch_counts(), vggt_counts(), glue_counts()
    peak = torch.cuda.max_memory_allocated()
    want, want_v, want_g = vggt_schedule(cfg, VGGT_FRAMES, VGGT_HW)
    _check_counts(tag, got, want, phase="K")
    _check_counts(f"{tag} vggt_counts", got_v, want_v, phase="K")
    _check_counts(f"{tag} glue_counts", got_g, want_g, phase="K")
    for key, n in got.items():
        totals[key] += n
    out = {key: np.array(a) for key, a in out.items()}
    seen = check_vggt(tag, out, VGGT_FRAMES, VGGT_HW)

    t0 = time.perf_counter()
    ref = vggt_inference(plain, frames)
    plain_secs = time.perf_counter() - t0
    errs = {key: rel_rmse(torch.as_tensor(out[key]),
                          torch.as_tensor(ref[key]))
            for key in (*VGGT_MAPS, "pose_enc", "c2w")}
    # the focal, (W / 2) / tan(FoV / 2), is printed without a bound: with
    # random weights some fields of view come out near 0 (ReLU of a small
    # number), where it turns the FoV's bf16 difference (compared in
    # pose_enc) into a large relative one, and those frames' large focals
    # rule the RMSE
    fov = torch.as_tensor(out["pose_enc"])[seen][:, 7:]
    focal = (rel_rmse(torch.as_tensor(out["focal"])[seen],
                      torch.as_tensor(ref["focal"])[seen])
             if bool(seen.any()) else None)
    log(f"[K] {tag}: {secs:.2f} s with K1 (the first request), "
        f"{plain_secs:.2f} s plain; peak device memory "
        f"{peak / 2**30:.2f} GiB; relative RMSE vs plain "
        f"{ {key: float(f'{e:.3e}') for key, e in errs.items()} }; focal "
        f"{focal} over the {int(seen.sum())} frames with both fields of "
        f"view positive (FoV min {float(fov.min()) if fov.numel() else 0:.3e}"
        f", median {float(fov.median()) if fov.numel() else 0:.3e} rad)")
    for key, e in errs.items():
        if not e <= RMSE_TOL:
            raise AssertionError(f"{tag} {key}: relative RMSE {e} > "
                                 f"{RMSE_TOL}")
    del model, core, plain, out, ref
    torch.cuda.empty_cache()
    sync()
    log(f"[K] phase K: {time.perf_counter() - t_phase:.1f} s")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this smoke test needs an NVIDIA GPU")
    import sys
    if "--rank-worker" in sys.argv:
        a = sys.argv
        rank_worker(int(a[a.index("--rank-worker") + 1]),
                    int(a[a.index("--port") + 1]), a[a.index("--out") + 1])
        return
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
    glue_rows = phase_glue(dev)
    counts = dict(phase_slice(dev, *must3r_512_configs()))
    phase_train(dev, counts)
    phase_q8_slice(dev, *must3r_512_configs(), counts)
    phase_slam(dev, *must3r_512_configs(), counts)
    phase_retrieval_eval(dev, *must3r_512_configs(), counts)
    phase_parallel(dev, *must3r_512_configs(), counts)
    phase_surfaces(dev, *must3r_512_configs(), counts)
    phase_learning(dev, counts)
    phase_vggt(dev, counts, sa)
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
        *(entry(k, "must3r_tpu_torch/csrc/block_glue_sm90.cu",
                "none (XLA fuses the block's glue)", glue_rows[k], 0)
          for k in GLUE_KERNELS),
    ]}
    log(f"[R] record times: sa_fwd at {sa[0]['shape']}, ca_fwd at "
        f"{ca[-1]['shape']}, ca_bwd_dq / ca_bwd_dkv at "
        f"{train_k['ca_bwd_dq'][1]['shape']}, ca_bwd_fused at "
        f"{train_k['ca_bwd_fused'][2]['shape']}, ca_fwd_q8 at "
        f"{q8[0]['shape']}, the probe kernels at the probe's shapes, "
        f"ca_fwd_2h at {rows_2h[0]['shape']}, ln_matmul at "
        f"{rows_ln[0]['shape']}, G1-G4 at phase L's first VGGT rows; "
        f"launches summed over the counted runs of "
        f"phases C, D, E, F, G, H (both ranks), I, J (not J2's "
        f"comparison runs) and K, the probe's entry point "
        f"and the two bench "
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
