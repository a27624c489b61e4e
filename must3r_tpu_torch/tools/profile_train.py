"""Where the device time of one training step goes, on one CUDA device.

    python -m must3r_tpu_torch.tools.profile_train \\
        [--out profile_train.txt]

Two configurations, seeded random weights, bf16, frozen encoder, remat,
token dropout 0.1, through ``make_train_step``:

  * ``512``: MUSt3R_512, batch 2, 4 views of 512 x 384, the
    ``TrainSettings`` defaults (update steps of 2, 1, 1 views, 2 rendered);
  * ``224``: MUSt3R_224, batch 1, 20 views of 224 x 224 in causal blocks of
    5, 2 rendered (the JAX package's training recipe).

For each: the host time of 5 warm steps, each ended by a synchronize
(median and range), then one step under ``torch.profiler``: device busy
time (the union of every device activity's interval), the idle share
(1 - busy / host time of that traced step), the device time of each group
of kernels (the port's attention kernels by name, matrix products,
everything else) and the top kernels, which go to ``--out``. The last line
of standard output is one JSON object with every number.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

from must3r_tpu_torch import must3r_224_configs, must3r_512_configs
from must3r_tpu_torch.checkpoint import init_model
from must3r_tpu_torch.engine.inference import view_positions
from must3r_tpu_torch.engine.train import (TrainSettings, cast_frozen_params,
                                           cosine_schedule, make_optimizer,
                                           make_train_step, trainable_subset)
from must3r_tpu_torch.tools.profile_offline import _union_us, kernel_group

SEED = 0
CONFIGS = {
    "512": dict(cfgs=must3r_512_configs, b=2, hw=(384, 512),
                ts=TrainSettings(dropout_p=0.1), render=[3, 1]),
    "224": dict(cfgs=must3r_224_configs, b=1, hw=(224, 224),
                ts=TrainSettings(mem_batches=(5, 5, 5, 5), n_render=2,
                                 dropout_p=0.1), render=[18, 19]),
}


def random_train_batch(dev, gen, b, v, hw, patch, render):
    """A seeded random training batch on the device (views [B, V, H, W])."""
    h, w = hw
    c2w = torch.eye(4, device=dev).expand(b, v, 4, 4).clone()
    c2w[..., :3, 3] = torch.randn(b, v, 3, generator=gen, device=dev)
    return {
        "img": torch.rand(b, v, h, w, 3, generator=gen, device=dev) * 2 - 1,
        "pos": view_positions(hw, patch, batch_shape=(b, v), device=dev),
        "pts3d": torch.randn(b, v, h, w, 3, generator=gen, device=dev) + 3,
        "camera_pose": c2w,
        "valid_mask": torch.rand(b, v, h, w, generator=gen, device=dev) > 0.1,
        "sky_mask": torch.rand(b, v, h, w, generator=gen, device=dev) > 0.95,
        "is_metric_scale": torch.zeros(b, dtype=torch.bool, device=dev),
        "render_ids": torch.tensor(render, device=dev),
    }


def profile_config(name: str, dev, top: int = 20):
    c = CONFIGS[name]
    enc_cfg, dec_cfg = c["cfgs"]()
    dec_cfg = dataclasses.replace(dec_cfg, causal=True)
    ts = c["ts"]
    enc, dec = init_model(enc_cfg, dec_cfg, seed=SEED, device=dev)
    params = cast_frozen_params({"encoder": enc, "decoder": dec}, ts)
    opt = make_optimizer(cosine_schedule(1e-4, 10, 1000), weight_decay=0.05)
    state = opt.init(trainable_subset(params, ts))
    step = make_train_step(enc_cfg, dec_cfg, ts, opt)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    batch = random_train_batch(dev, gen, c["b"], sum(ts.mem_batches),
                               c["hw"], enc_cfg.patch_size, c["render"])

    for _ in range(2):                                  # warm-up
        params, state, loss, _ = step(params, state, batch, gen)
    torch.cuda.synchronize(dev)
    host = []
    torch.cuda.reset_peak_memory_stats(dev)
    for _ in range(5):
        t0 = time.perf_counter()
        params, state, loss, _ = step(params, state, batch, gen)
        torch.cuda.synchronize(dev)
        host.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated(dev)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, state, loss, _ = step(params, state, batch, gen)
        torch.cuda.synchronize(dev)
        traced_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = _union_us((e.time_range.start, e.time_range.end)
                        for e in events) / 1e3
    groups = defaultdict(float)
    per_name = defaultdict(lambda: [0.0, 0])
    for e in events:
        ms = e.time_range.elapsed_us() / 1e3
        groups[kernel_group(e.name)] += ms
        per_name[e.name][0] += ms
        per_name[e.name][1] += 1
    rows = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:top]
    table = "\n".join(f"{ms:10.3f} ms {n:6d}x  {nm[:110]}"
                      for nm, (ms, n) in rows)
    summary = {
        "loss": float(loss), "host_ms_median": statistics.median(host),
        "host_ms_min": min(host), "host_ms_max": max(host),
        "steps_per_s": 1e3 / statistics.median(host),
        "peak_gib": peak / 2**30, "traced_host_ms": traced_ms,
        "device_busy_ms": busy_ms, "idle_share": 1 - busy_ms / traced_ms,
        "device_ms_by_group": dict(sorted(groups.items(),
                                          key=lambda kv: -kv[1])),
    }
    del params, state, step, enc, dec
    torch.cuda.empty_cache()
    return summary, table


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="file for the kernel tables")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    result, tables = {"card": card}, []
    for name in CONFIGS:
        summary, table = profile_config(name, dev)
        result[name] = summary
        tables.append(f"== {name}: {json.dumps(summary)}\n{table}")
        print(tables[-1], flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(card + "\n" + "\n\n".join(tables) + "\n")
    print(json.dumps(result))


if __name__ == "__main__":
    main()
