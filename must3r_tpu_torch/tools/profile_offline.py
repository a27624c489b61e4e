"""Where the time of one offline request goes, on one CUDA device.

    python -m must3r_tpu_torch.tools.profile_offline \
        [--out chiprun_out/profile_offline.txt] [--kv_quant int8|fp8]

MUSt3R_512 at full width with seeded random weights, bf16, one 10-view
512x384 collection through ``make_fused_offline`` (its token memory 8-bit
with ``--kv_quant``), once with the attention kernels (``impl=None``) and
once with the plain attention (``"plain"``):

1. phases: encoder, memory updates, render, head + postprocess, each ended
   by a synchronize (host clock, warm, median of 3);
2. spread: 10 alternating pairs of kernel / plain requests on the host
   clock (``alternating_pairs``); median, quartiles and range of views/s,
   and the median of the per-pair ratio kernel / plain;
3. one traced request per impl under ``torch.profiler``. Device time is the
   union of the intervals of every device activity (kernels, copies,
   memsets) in that request; the idle share is 1 - device time / the host
   time of the same traced request. The profiler's own host cost inflates
   that host time, so the untraced median is printed beside it. The device
   time of each group of kernels (the port's attention kernels by name,
   matrix products, everything else) is summed.

The top device kernels of each traced request go to ``--out``; the last
line of standard output is one JSON object with every number above.
"""

from __future__ import annotations

import argparse
import functools
import json
import re
import statistics
import subprocess
import time
from collections import defaultdict
from typing import Callable, Dict

import torch
from torch.profiler import ProfilerActivity, profile

from must3r_tpu_torch import must3r_512_configs
from must3r_tpu_torch.checkpoint import init_model
from must3r_tpu_torch.engine.inference import (InferenceCore,
                                               make_fused_offline,
                                               postprocess, view_positions)

IMPLS = {"kernel": None, "plain": "plain"}
# the port's attention kernels by (demangled) name, each group with the
# pattern its names match: K1, K2 and K2(d) (int8, fp8) of the TMA + wgmma
# forward program (template flags CA, STATS, EXT, QUANT, NC); K5 and K4 of
# the TMA + wgmma key-block backward (flags EXT, DQ: K4 is DQ = false); K3,
# the TMA + wgmma query-block backward; K6 (WMMA)
KERNEL_GROUPS = (
    ("attn_fwd_sm90<false", r"attn_fwd_sm90<false"),
    ("attn_fwd_sm90<true", r"attn_fwd_sm90<true, \w+, \w+, 0,"),
    ("attn_fwd_sm90 q8 int8", r"attn_fwd_sm90<true, \w+, \w+, 1,"),
    ("attn_fwd_sm90 q8 fp8", r"attn_fwd_sm90<true, \w+, \w+, 2,"),
    ("ca_bwd_fused_sm90", r"ca_bwd_fused_sm90<\w+, true>"),
    ("ca_bwd_fused_sm90 dkv", r"ca_bwd_fused_sm90<\w+, false>"),
    ("ca_bwd_dq_sm90", r"ca_bwd_dq_sm90<"),
    ("ca_fwd_2h_kernel", r"ca_fwd_2h_kernel"))
N_VIEWS = 10
HW = (384, 512)
PAIRS = 10
SEED = 0


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def phase_times(core: InferenceCore, imgs, reps: int = 3) -> dict:
    """Host ms of each phase of one request, synchronised between phases
    (median of ``reps`` warm runs)."""
    v, hw, dev = imgs.shape[0], tuple(imgs.shape[1:3]), imgs.device
    portrait = torch.zeros(1, v, dtype=torch.bool, device=dev)
    pos = view_positions(hw, core.enc_cfg.patch_size, portrait,
                         batch_shape=(1, v), device=dev)
    runs = defaultdict(list)
    for _ in range(reps):
        _sync(dev)
        t0 = time.perf_counter()
        x = core.encode(imgs, pos[0])[None]
        _sync(dev)
        t1 = time.perf_counter()
        mem = core.new_memory(v, hw)
        mem, _ = core.update(mem, x[:, :2], pos[:, :2])
        for i in range(2, v):
            mem, _ = core.update(mem, x[:, i:i + 1], pos[:, i:i + 1])
        _sync(dev)
        t2 = time.perf_counter()
        toks = core.render(mem, x, pos)
        _sync(dev)
        t3 = time.perf_counter()
        postprocess(core.head(toks, hw, portrait),
                    core.dec_cfg.pointmaps_activation, compute_cam=True)
        _sync(dev)
        t4 = time.perf_counter()
        for key, a, b in (("encoder", t0, t1), ("updates", t1, t2),
                          ("render", t2, t3), ("head_post", t3, t4),
                          ("total", t0, t4)):
            runs[key].append((b - a) * 1e3)
    return {f"{k}_ms": statistics.median(ts) for k, ts in runs.items()}


def alternating_pairs(runs: Dict[str, Callable[[], None]], pairs: int,
                      per_call: float = 1.0,
                      sync: Callable[[], None] = lambda: None,
                      clock: Callable[[], float] = time.perf_counter) -> dict:
    """Seconds of each of ``runs`` over ``pairs`` rounds in turns: round i
    runs them in their order when i is even, in reverse when it is odd,
    each call ended by ``sync``. Returns, per run, the median, quartiles
    and range of its rate (``per_call`` units a call: views of a request,
    1 for a training step), and (with two runs) the median of the
    per-round ratio of the first run's rate to the second's. Both runs of a
    round share the host's state of the moment, so a slow stretch of the
    host moves both."""
    names = list(runs)
    secs = {k: [] for k in names}
    for i in range(pairs):
        for k in (names if i % 2 == 0 else names[::-1]):
            sync()
            t0 = clock()
            runs[k]()
            sync()
            secs[k].append(clock() - t0)
    out = {}
    for k, ss in secs.items():
        rates = sorted(per_call / s for s in ss)
        q = statistics.quantiles(rates, n=4) if len(rates) > 1 else rates * 3
        out[k] = {"per_s_median": statistics.median(rates), "q1": q[0],
                  "q3": q[2], "min": rates[0], "max": rates[-1],
                  "host_ms_median": statistics.median(ss) * 1e3}
    if len(names) == 2:
        a, b = names
        out[f"{a}_over_{b}_median"] = statistics.median(
            sb / sa for sa, sb in zip(secs[a], secs[b]))
    return out


def kernel_group(name: str) -> str:
    """The group of a device activity: one of KERNEL_GROUPS, "matrix
    products" or "other"."""
    for group, pattern in KERNEL_GROUPS:
        if re.search(pattern, name):
            return group
    if "gemm" in name or "Gemm" in name or "cutlass" in name or \
            "sm90_xmma" in name or "nvjet" in name:
        return "matrix products"
    return "other"


def _union_us(intervals) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def traced(run, imgs, top: int = 15):
    """One request under torch.profiler: (summary dict, kernel table)."""
    dev = imgs.device
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    _sync(dev)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run(imgs)
        _sync(dev)
        host_ms = (time.perf_counter() - t0) * 1e3
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = _union_us((e.time_range.start, e.time_range.end)
                        for e in dev_events) / 1e3
    per_name = defaultdict(lambda: [0.0, 0])
    groups = defaultdict(lambda: [0.0, 0])
    for e in dev_events:
        ms = e.time_range.elapsed_us() / 1e3
        for acc in (per_name[e.name], groups[kernel_group(e.name)]):
            acc[0] += ms
            acc[1] += 1
    rows = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:top]
    table = "\n".join(f"{ms:10.3f} ms {n:6d}x  {name[:100]}"
                      for name, (ms, n) in rows)
    summary = {"host_ms": host_ms, "device_busy_ms": busy_ms,
               "device_events": len(dev_events),
               "idle_share": 1.0 - busy_ms / host_ms,
               "device_ms_launches_by_group": dict(sorted(
                   groups.items(), key=lambda kv: -kv[1][0]))}
    return summary, table


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None,
                    help="file for the top-kernel tables")
    ap.add_argument("--kv_quant", default=None, choices=["int8", "fp8"],
                    help="store the token memory 8-bit")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_offline needs a CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)

    enc_cfg, dec_cfg = must3r_512_configs()
    enc, dec = init_model(enc_cfg, dec_cfg, seed=SEED, device=dev)
    cores = {k: InferenceCore(enc, dec, enc_cfg, dec_cfg, impl=impl,
                              kv_quant=args.kv_quant)
             for k, impl in IMPLS.items()}
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    imgs = torch.rand(N_VIEWS, *HW, 3, generator=gen, device=dev) * 2 - 1
    runs = {k: make_fused_offline(c, N_VIEWS, HW)
            for k, c in cores.items()}
    for run in runs.values():
        run(imgs)
        run(imgs)

    result = {"card": card, "n_views": N_VIEWS, "hw": list(HW),
              "kv_quant": args.kv_quant,
              "phases": {k: phase_times(c, imgs) for k, c in cores.items()},
              "spread": alternating_pairs(
                  {k: functools.partial(run, imgs) for k, run in runs.items()},
                  PAIRS, per_call=N_VIEWS, sync=lambda: _sync(dev)),
              "traced": {}}
    tables = []
    for k, run in runs.items():
        summary, table = traced(run, imgs)
        result["traced"][k] = summary
        tables.append(f"== {k}: {json.dumps(summary)}\n{table}")
    if args.out:
        with open(args.out, "w") as f:
            f.write(card + "\n" + "\n\n".join(tables) + "\n")
    else:
        print("\n\n".join(tables))
    print(json.dumps(result))


if __name__ == "__main__":
    main()
