"""Variant builds of K2(d), K5, K6 and K7: where their time and registers go.

    python -m must3r_tpu_torch.tools.ablate_kernels [--out FILE]
        [--groups q8 k5 2h ln]

Each variant is a kernel source of ``csrc/`` with one part of its program
switched off by text edits (``VARIANTS``), compiled with the flags of
``ops/_kernels.py`` into a library of its own under ``build/ablate/``. For
each variant the ptxas report of its kernels (registers, spill bytes) is
printed, and its device time (``tools/timing.device_ms``):

  * K2(d) (``csrc/attention_sm90.cu``, flag QUANT) at the int8 render
    [1,1,7680,12,64] and update [1,1,768,12,64] against 7,680 keys of an
    8,192-slot layer, as in ``chip_smoke.py`` phase B'', beside the bf16 K2
    on the dequantized layer. A variant that skips work computes something
    else: its output's largest difference to the unchanged kernel's is
    printed, and only its time means anything.
  * K5 (``csrc/attention_bwd_sm90.cu``) at the init pair [2,2,768] against
    1,536 keys, for variants that add setmaxnreg (the register split
    between the producer and the consumer warpgroups that K1 / K2 use).
  * K6 (``csrc/attention_sm90.cu``, HP = 2) at the render [1,1,7680,12,64]
    against 7,680 keys and the update [1,1,768,12,64] against 49,152 (the
    cases of ``scripts/bench_ca_kernel.py``), beside K2 on the same layer:
    with its ring at K2's 4 stages instead of 6, K2's epilogue (4-byte
    stores) instead of the TMA store, no store, no K / V loads.
  * K7 (``csrc/ln_matmul_sm90.cu``) at the three cases of
    ``scripts/bench_fused_chain.py`` (x [M, 768] with M = 1024 / 3072 /
    1024, w [768, N] with N = 2304 / 2304 / 3072), beside ``torch.matmul``
    alone on the same x and w: with the normalisation off (the x chunk is
    fed to wgmma as it is), the statistics off (mean 0, rstd 1), both off
    (the TMA + wgmma product alone), 128 columns a block always, the TMA
    ring alone, everything but the loads, no output store, and the product
    launched after the statistics kernel ends.

The wrappers of ``ops/_kernels.py`` make every call (their library is
swapped for the variant's while it is timed). Needs a CUDA device and
nvcc. The last line of standard output is one JSON object.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
from pathlib import Path

import torch

from must3r_tpu_torch.memory import dequantize_kv, quantize_kv
from must3r_tpu_torch.ops import _kernels
from must3r_tpu_torch.ops.attention import INT32_MAX
from must3r_tpu_torch.tools.timing import device_ms

SEED = 0
ABLATE_DIR = _kernels.BUILD_DIR.parent / "ablate"
Q8, K5, LN = "attention_sm90", "attention_bwd_sm90", "ln_matmul_sm90"
# group of variants -> (source stem, what they are timed beside: None for
# nothing)
GROUPS = {"q8": (Q8, "bf16 K2"), "k5": (K5, None), "2h": (Q8, "K2"),
          "ln": (LN, "torch.matmul")}

# the edits, each (text of the source, its replacement); every text must
# occur exactly once
_NO_SCALE_PASSES = [
    ("if constexpr (QUANT != 0) {\n          // the k scale",
     "if constexpr (false) {\n          // the k scale"),
    ("if constexpr (QUANT != 0) {\n          // P.V takes",
     "if constexpr (false) {\n          // P.V takes")]
_NO_SCALE_LOADS = [("if (ct < kKeys) {", "if (false) {")]
_NO_CONVERSION = [
    ("for (int u = ct; u < kKeys * 8; u += kConverters) {",
     "for (int u = ct; u < 0; u += kConverters) {")]
_NO_CODE_TMA = [
    ("mbar_expect_tx(&sm.full[stage], 2 * kCodeBytes);\n"
     "              tma_load_4d(sm.kc[stage], &kmap, &sm.full[stage], 0, j0,"
     " h, b);\n"
     "              tma_load_4d(sm.vc[stage], &vmap, &sm.full[stage], kDh, j0,"
     " h,\n                          b);",
     "mbar_arrive(&sm.full[stage]);")]

_LN_NO_NORM = [
    ("        a[kk][2 * h + i] =\n"
     "            pack_bf16(fmaf((x0 - mean[i]) * rstd[i], p.x, p.z),\n"
     "                      fmaf((x1 - mean[i]) * rstd[i], p.y, p.w));",
     "        a[kk][2 * h + i] = u;")]
_LN_NO_STATS = [("  ln_row_stats<<<", "  if (false) ln_row_stats<<<"),
                ("    if (m0 + row + 8 * i < M) {", "    if (false) {")]
_LN_128_COLS = [("return N % 192 == 0 && cost(3) < cost(2) ? 3 : 2;",
                 "return 2;")]
_LN_NO_PRODUCTS = [
    ("        wgmma_rs(d[nb], a[kk], sw128_desc(ring.w(stage, nb)) + 128 *"
     " kk);", "        ;")]
_LN_NO_LOADS = [
    ("      mbar_expect_tx(ring.full(stage), Ring<NB>::kStageBytes);\n"
     "      tma_load_2d(ring.x(stage), &xmap, ring.full(stage), c * kChunk,"
     " m0);\n#pragma unroll\n"
     "      for (int nb = 0; nb < NB; ++nb)\n"
     "        tma_load_2d(ring.w(stage, nb), &wmap, ring.full(stage), n0 +"
     " 64 * nb,\n                    c * kChunk);",
     "      mbar_arrive(ring.full(stage));")]
_LN_NO_STORES = [("      tma_store_2d(&omap,",
                  "      if (false) tma_store_2d(&omap,")]
_2H_NO_STORES = [("        tma_store_4d(&omap,",
                  "        if (false) tma_store_4d(&omap,")]
_2H_DIRECT_STORES = [("    if constexpr (HP == 2) {\n      // K6: into",
                      "    if constexpr (false) {\n      // K6: into")]
_LN_NO_PDL = [("  cfg.numAttrs = 1;", "  cfg.numAttrs = 0;")]
_2H_NO_LOADS = [
    ("              mbar_expect_tx(&sm.full[stage], 2 * HP * kTileBytes);\n"
     "#pragma unroll\n"
     "              for (int hp = 0; hp < HP; ++hp) {\n"
     "                tma_load_4d(sm.k[stage][hp], &kmap, &sm.full[stage], 0,"
     " j0,\n                            h + hp, b);\n"
     "                tma_load_4d(sm.v[stage][hp], &vmap, &sm.full[stage],"
     " kDh, j0,\n                            h + hp, b);\n"
     "              }",
     "              mbar_arrive(&sm.full[stage]);")]
_2H_4_STAGES = [("constexpr int kStagesPair = 6;",
                 "constexpr int kStagesPair = 4;")]


def _k5_setmaxnreg(consumer_regs: int):
    """K5 with its registers moved from the producer warpgroup to the
    consumers, as K1 / K2 do."""
    return [
        ("    // ---------------- producer warpgroup: one warp loads "
         "----------------\n",
         "    // ---------------- producer warpgroup: one warp loads "
         "----------------\n    regs_dec<24>();\n"),
        ("  // ---------------- consumer warpgroup wg: 64 keys "
         "----------------\n",
         "  // ---------------- consumer warpgroup wg: 64 keys "
         f"----------------\n  regs_inc<{consumer_regs}>();\n")]


# name -> (group, what is switched off, edits)
VARIANTS = {
    "q8_full": ("q8", "nothing (the kernel as shipped)", []),
    "q8_no_scale_passes": (
        "q8", "consumers: the k-scale multiply of S and the v-scale select "
        "on P", _NO_SCALE_PASSES),
    "q8_no_scale_loads": (
        "q8", "converters: the loads of the tile's 64 k and 64 v scales",
        _NO_SCALE_LOADS),
    "q8_no_conversion": (
        "q8", "converters: the code -> bf16 conversion and the stores into "
        "the swizzled stage", _NO_CONVERSION),
    "q8_no_code_tma": (
        "q8", "producer: the TMA loads of the codes (the stage is marked "
        "full at once)", _NO_CODE_TMA),
    "q8_rings_only": (
        "q8", "all four above: only the rings' handshakes beside the bf16 "
        "program's work",
        _NO_SCALE_PASSES + _NO_SCALE_LOADS + _NO_CONVERSION + _NO_CODE_TMA),
    "k5_full": ("k5", "nothing (the kernel as shipped: every warp keeps "
                "the launch bound's 168 registers)", []),
    "k5_setmaxnreg_240": (
        "k5", "nothing; added: setmaxnreg 24 for the producer, 240 for the "
        "consumers", _k5_setmaxnreg(240)),
    "k5_setmaxnreg_200": (
        "k5", "nothing; added: setmaxnreg 24 for the producer, 200 for the "
        "consumers", _k5_setmaxnreg(200)),
    "ln_full": ("ln", "nothing (the kernel as shipped)", []),
    "ln_no_norm": (
        "ln", "consumers: the normalisation (x fed to wgmma as it is)",
        _LN_NO_NORM),
    "ln_no_stats": (
        "ln", "the statistics kernel and the consumers' read of its "
        "output (mean 0, rstd 1)",
        _LN_NO_STATS),
    "ln_product_only": (
        "ln", "both above: the TMA ring and the wgmma product alone",
        _LN_NO_NORM + _LN_NO_STATS),
    "ln_128_cols": (
        "ln", "nothing; 128 columns a block at every shape (no 192)",
        _LN_128_COLS),
    "ln_loads_only": (
        "ln", "the products, the normalisation and the statistics: the "
        "TMA ring and its handshakes alone", _LN_NO_PRODUCTS + _LN_NO_NORM
        + _LN_NO_STATS),
    "ln_no_loads": (
        "ln", "the producer's TMA loads (each stage is marked full at "
        "once): products, normalisation and handshakes on stale tiles",
        _LN_NO_LOADS),
    "ln_no_stores": (
        "ln", "the epilogue's TMA stores of out", _LN_NO_STORES),
    "ln_no_pdl": (
        "ln", "nothing; the product launched after the statistics kernel "
        "ends (no programmatic dependent launch)", _LN_NO_PDL),
    "2h_full": ("2h", "nothing (the kernel as shipped)", []),
    "2h_4_stages": ("2h", "nothing; a ring of 4 stages (K2's) instead of 6",
                    _2H_4_STAGES),
    "2h_no_stores": ("2h", "the epilogue's TMA store of out",
                     _2H_NO_STORES),
    "2h_direct_stores": ("2h", "nothing; the epilogue of K1 / K2 (4-byte "
                         "stores from the accumulators) instead of the TMA "
                         "store", _2H_DIRECT_STORES),
    "2h_no_loads": ("2h", "the producer's K / V loads (each stage is marked "
                    "full at once): the products and softmax on stale tiles",
                    _2H_NO_LOADS),
}


def variant_stem(name: str) -> str:
    """The source stem (``csrc/<stem>.cu``) a variant edits."""
    return GROUPS[VARIANTS[name][0]][0]


def variant_source(name: str) -> str:
    stem, (_, _, edits) = variant_stem(name), VARIANTS[name]
    text = (_kernels._CSRC / f"{stem}.cu").read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise ValueError(f"{name}: the edit's text occurs "
                             f"{text.count(old)} times in {stem}.cu: "
                             f"{old[:60]!r}")
        text = text.replace(old, new)
    return text


def build_variants(names) -> dict:
    """Compile every variant, one nvcc each, all started together; returns
    name -> (library path, compiler log)."""
    ABLATE_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        src = ABLATE_DIR / f"{name}.cu"
        src.write_text(variant_source(name))
        out = ABLATE_DIR / f"lib{name}.so"
        cmd = [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-I",
               str(_kernels._CSRC), "-o", str(out), str(src)]
        jobs[name] = (out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    built = {}
    for name, (out, proc) in jobs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed with code "
                               f"{proc.returncode}:\n{stderr[-4000:]}")
        built[name] = (out, stdout + stderr)
    return built


_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_TARGS = re.compile(
    r"(attn_fwd_sm90|ca_bwd_fused_sm90|ca_bwd_dq_sm90|ln_matmul_sm90)"
    r"I((?:L[bi]\d+E)+)E")


def ptxas_report(log: str, keep=lambda name: True) -> dict:
    """kernel (with its template arguments) -> registers and spill bytes,
    from the ``-Xptxas -v`` log of one library, for the kernels ``keep``
    names."""
    out, name = {}, None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            t = _TARGS.search(m.group(1))
            name = (f"{t.group(1)}<"
                    + ", ".join(re.findall(r"L[bi](\d+)E", t.group(2)))
                    + ">") if t else None
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out.setdefault(name, {}).update(spill_stores=int(m.group(1)),
                                            spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(name, {})["registers"] = int(m.group(1))
            name = None
    return {k: v for k, v in out.items() if keep(k)}


# the kernels whose registers are reported: the int8 K2(d) of the render
# and update (no STATS, no EXT; 64- and 192-row blocks) and K6 (the head
# pair), whose library the K2(d) variants rebuild; K5 and K4 (flags EXT,
# DQ) and K3 (EXT, NC), whose library the K5 variants rebuild; K7 (NB)
REPORTED = ("attn_fwd_sm90<1, 0, 0, 1,", "attn_fwd_sm90<1, 0, 0, 0, 2,",
            "ca_bwd_fused_sm90<", "ca_bwd_dq_sm90<", "ln_matmul_sm90<")


def _load_variant(stem: str, path: Path):
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _kernels.ENTRIES[stem].items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return lib


def _timed(stem, lib, call):
    """(output, device ms) of ``call`` with ``stem``'s library swapped."""
    saved = _kernels._load(stem)
    _kernels._libs[stem] = lib
    try:
        out = call()
        torch.cuda.synchronize()
        return out, device_ms(call)
    finally:
        _kernels._libs[stem] = saved


def q8_cases(dev):
    """The int8 render and update of chip_smoke.py phase B'': name ->
    (K2(d) call, bf16 K2 call on the dequantized layer)."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    codes, scale = quantize_kv(torch.randn(1, 12, 8192, 128, generator=gen,
                                           device=dev).to(torch.bfloat16),
                               torch.int8)
    deq = dequantize_kv(codes, scale, torch.bfloat16)
    labels = torch.full((1, 8192), -1, dtype=torch.int32, device=dev)
    labels[0, :7680] = torch.arange(7680, dtype=torch.int32,
                                    device=dev) // 768
    cases = {}
    for name, n, q_self in (("render [1,1,7680] vs 7680", 7680, -2),
                            ("update [1,1,768] vs 7680", 768, 9)):
        q = torch.randn(1, 1, n, 12, 64, generator=gen, device=dev
                        ).to(torch.bfloat16)
        qs = torch.tensor([[q_self]], dtype=torch.int32, device=dev)
        qu = torch.tensor([[INT32_MAX]], dtype=torch.int32, device=dev)
        cases[name] = (
            lambda q=q, qs=qs, qu=qu: _kernels.ca_fwd_q8(
                q, codes, scale, labels, qs, qu, 7680),
            lambda q=q, qs=qs, qu=qu: _kernels.ca_fwd(q, deq, labels, qs, qu,
                                                      7680))
    return cases


def k5_case(dev):
    """K5 at the init pair of the 512 step: [2,2,768] against 1,536 keys
    (+100 dead slots), causal, dropout mask 0.1."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev
                           ).to(torch.bfloat16)

    b, g, n, s = 2, 2, 768, 1636
    q, dout, kv = randn(b, g, n, 12, 64), randn(b, g, n, 12, 64), \
        randn(b, 12, s, 128)
    labels = torch.full((b, s), -1, dtype=torch.int32, device=dev)
    labels[:, :1536] = torch.arange(1536, dtype=torch.int32,
                                    device=dev) // 768
    qs = torch.tensor([[-2, 1]] * b, dtype=torch.int32, device=dev)
    qu = torch.tensor([[2, 1]] * b, dtype=torch.int32, device=dev)
    ext = torch.rand(b, g, s, generator=gen, device=dev) < 0.1
    out, lse = _kernels.ca_fwd(q, kv, labels, qs, qu, 1536, ext=ext,
                               return_stats=True)
    delta = (dout.float() * out.float()).sum(-1).permute(0, 1, 3, 2
                                                         ).contiguous()
    return lambda: _kernels.ca_bwd_fused(q, kv, labels, qs, qu, 1536, lse,
                                         delta, dout, ext)


# name, M, N of scripts/bench_fused_chain.py (rows padded to 256), K = 768
LN_CASES = (("update_qkv", 1024, 2304), ("render_qkv", 3072, 2304),
            ("update_mlp_in", 1024, 3072))


def ln_cases(dev):
    """K7 at the bench cases: name -> (K7 call, torch.matmul of x and w)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    cases = {}
    for name, m, n in LN_CASES:
        x = torch.randn(m, 768, generator=gen, device=dev).to(torch.bfloat16)
        g = (1 + 0.1 * torch.randn(768, generator=gen, device=dev)
             ).to(torch.bfloat16)
        b = (0.1 * torch.randn(768, generator=gen, device=dev)
             ).to(torch.bfloat16)
        w = (0.02 * torch.randn(768, n, generator=gen, device=dev)
             ).to(torch.bfloat16)
        cases[f"{name} [{m},768]->{n}"] = (
            lambda x=x, g=g, b=b, w=w: _kernels.ln_matmul(x, g, b, w),
            lambda x=x, w=w: torch.matmul(x, w))
    return cases


def k6_cases(dev):
    """K6 at the render and the 64-keyframe update of bench_ca_kernel (a
    12-layer cache, layer 3, every slot live): name -> (K6 call, K2 call on
    the same layer)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    cases = {}
    for name, n, s in (("render [1,1,7680] vs 7680", 7680, 7680),
                       ("update [1,1,768] vs 49152", 768, 49152)):
        q = torch.randn(1, 1, n, 12, 64, generator=gen, device=dev
                        ).to(torch.bfloat16)
        cache = torch.randn(12, 1, 12, s, 128, generator=gen, device=dev
                            ).to(torch.bfloat16)
        labels = torch.zeros(1, s, dtype=torch.int32, device=dev)
        qs = torch.full((1, 1), -1, dtype=torch.int32, device=dev)
        qu = torch.full((1, 1), INT32_MAX, dtype=torch.int32, device=dev)
        cases[name] = (
            lambda q=q, c=cache, lab=labels, s=s: _kernels.ca_fwd_2h(
                q, c, lab, s, 3),
            lambda q=q, c=cache, lab=labels, qs=qs, qu=qu, s=s:
                _kernels.ca_fwd(q, c[3], lab, qs, qu, s))
    return cases


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None,
                    help="file for the variants' compiler logs")
    ap.add_argument("--groups", nargs="+", default=list(GROUPS),
                    choices=list(GROUPS),
                    help="the groups of variants built and timed")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ablate_kernels needs a CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    built = build_variants([name for name, (group, _, _) in VARIANTS.items()
                            if group in args.groups])
    if args.out:
        Path(args.out).write_text("".join(
            f"== {k}\n{log}\n" for k, (_, log) in built.items()))
    make_cases = {"q8": q8_cases, "k5": lambda dev: {
        "init pair [2,2,768] vs 1536": (k5_case(dev), None)},
        "2h": k6_cases, "ln": ln_cases}
    result = {"card": card, "variants": {}}
    for group in args.groups:
        stem, beside = GROUPS[group]
        cases = make_cases[group](dev)
        ref = {}
        for case, (_, yardstick) in cases.items():
            if yardstick is not None:
                torch.cuda.synchronize()
                result[f"{beside} {case} ms"] = device_ms(yardstick)
        for name, (var_group, off, _) in VARIANTS.items():
            if var_group != group:
                continue
            path, log = built[name]
            lib = _load_variant(stem, path)
            row = {"off": off, "ptxas": ptxas_report(
                log, lambda k: k.startswith(REPORTED))}
            for case, (call, _) in cases.items():
                out, ms = _timed(stem, lib, call)
                out = torch.cat([t.float().flatten() for t in out]) \
                    if isinstance(out, tuple) else out.float()
                ref.setdefault(case, out)          # the unchanged kernel's
                row[case] = {"ms": ms, "max_abs_diff_to_full": float(
                    (out - ref[case]).abs().nan_to_num(float("inf")).max())}
            result["variants"][name] = row
            print(name, json.dumps(row), flush=True)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
