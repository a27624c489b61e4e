"""The headroom of fusing the decoder block's LayerNorm into the linear that
follows it, on the card (counterpart of ``scripts/bench_fused_chain.py``).

    python -m must3r_tpu_torch.tools.bench_fused_chain [case ...]
        [--device cuda] [--tiny]

At the training shapes of the decoder's front end (the update step sees
5 x 196 rows of width 768, the render step 15 x 196; rows padded to a
multiple of 256 as in the script), for each case it prints:

  matmul  ``x @ w`` (``torch.matmul``), the floor
  chain   ``F.layer_norm(x) @ w + residual``, two library calls and an add,
          what an unfused decoder block pays (the script's xla-chain)
  fused   K7 ``ln_matmul`` (LayerNorm + matmul in one launch, no residual)

as device times (a CUDA graph of ``timing.REPS`` calls replayed,
``tools/timing.py``), with the TF/s of the 2 * M * K * N product, and the
max abs error of K7 against its plain version. x [M, 768] and the residual
from a seeded normal, w normal x 0.02, g = 1, b = 0, all bf16 (the script's
inputs). ``--device cpu`` runs the plain versions on the CPU (host-clock
times); ``--tiny`` divides the rows by 49 and the widths by 6 (a smoke
run).
"""

from __future__ import annotations

import argparse

import torch
import torch.nn.functional as F

from must3r_tpu_torch.ops.bench_kernels import LN_EPS, ln_matmul
from must3r_tpu_torch.tools import timing

D = 768
# name: (rows, output width)
CASES = {"update_qkv": (5 * 196, 3 * D), "render_qkv": (15 * 196, 3 * D),
         "update_mlp_in": (5 * 196, 4 * D)}
ROW_PAD = 256
TINY_ROWS, TINY_WIDTH = 49, 6
HOST_REPS = 3


def inputs(dev, m: int, d: int, nout: int, seed: int = 0):
    """x [m, d], g, b [d], w [d, nout], residual [m, nout] (bf16 on the
    card, fp32 on the CPU)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = torch.bfloat16 if dev.type == "cuda" else torch.float32
    x = torch.randn(m, d, generator=gen, device=dev, dtype=dt)
    w = (torch.randn(d, nout, generator=gen, device=dev) * 0.02).to(dt)
    res = torch.randn(m, nout, generator=gen, device=dev, dtype=dt)
    g = torch.ones(d, device=dev, dtype=dt)
    b = torch.zeros(d, device=dev, dtype=dt)
    return x, g, b, w, res


def main(argv=None) -> dict:
    p = argparse.ArgumentParser("must3r_tpu_torch bench_fused_chain")
    p.add_argument("cases", nargs="*", help=f"any of {list(CASES)} (all)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--tiny", action="store_true")
    args = p.parse_args(argv)
    unknown = [c for c in args.cases if c not in CASES]
    if unknown:
        p.error(f"unknown case(s) {unknown}; known: {list(CASES)}")
    dev = torch.device(args.device)
    on_card = dev.type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise SystemExit("bench_fused_chain: no CUDA device (pass --device "
                         "cpu for the plain versions)")
    print(f"device: {torch.cuda.get_device_name(dev) if on_card else 'cpu'}",
          flush=True)
    rows = []
    for name in args.cases or list(CASES):
        n_rows, nout = CASES[name]
        d = D
        if args.tiny:
            n_rows, d, nout = (n_rows // TINY_ROWS, d // TINY_WIDTH,
                               nout // TINY_WIDTH)
        m = -(-n_rows // ROW_PAD) * ROW_PAD
        x, g, b, w, res = inputs(dev, m, d, nout)
        calls = {
            "matmul": lambda: x @ w,
            "chain": lambda: F.layer_norm(x, (d,), g, b, LN_EPS) @ w + res,
            "fused": lambda: ln_matmul(x, g, b, w)}
        times = {}
        for variant, fn in calls.items():
            if on_card:
                times[variant] = timing.device_ms(fn)
            else:
                times[variant] = timing.host_ms(fn, HOST_REPS)
        err = float((ln_matmul(x, g, b, w).float()
                     - ln_matmul(x, g, b, w, impl="plain").float()
                     ).abs().max())
        rate = {k: (f"{2.0 * m * d * nout / (v * 1e-3) / 1e12:6.1f} TF/s"
                    if on_card else "- TF/s") for k, v in times.items()}
        how = (f"device, CUDA graph of {timing.REPS}" if on_card
               else "cpu, host clock")
        label = f"{name} [{m},{d}]->{nout}"
        print(f"{label:32s} matmul {times['matmul'] * 1e3:8.1f} us "
              f"({rate['matmul']})  chain {times['chain'] * 1e3:8.1f} us "
              f"(+{(times['chain'] - times['matmul']) * 1e3:7.1f})  fused "
              f"{times['fused'] * 1e3:8.1f} us ({rate['fused']})  ({how})",
              flush=True)
        print(f"{'':32s} fused-vs-plain max_err {err:.2e}", flush=True)
        rows.append(dict(case=name, m=m, k=d, n=nout, max_abs_err=err,
                         **{f"{k}_ms": v for k, v in times.items()}))
        del x, g, b, w, res
    return {"rows": rows}


if __name__ == "__main__":
    main()
