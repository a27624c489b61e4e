"""Build and bind the hand-written CUDA kernels of ``csrc/``.

Each source (``attention_sm90.cu``: the forwards K1, K2, K2(d) (the
8-bit cache read) and K6 (two heads per block), one TMA + wgmma program;
``attention_bwd_sm90.cu``: the CA backwards K3 (dQ), K4 (dK|dV) and K5
(both), TMA + wgmma programs; ``probe_fp8.cu``: the fp8 probe kernels;
``ln_matmul_sm90.cu``: K7, LayerNorm + matmul, a TMA + wgmma program;
``block_glue_sm90.cu``: the pre-norm encoder block's glue between its
products, G1 ``ln_cast``, G2 ``qkv_glue``, G3 ``residual_glue`` and G4
``bias_gelu``, row kernels) is compiled with ``nvcc`` at first use into its
own shared library with a plain C interface (no PyTorch headers, so a build
takes seconds), bound by ``ENTRIES``, and keyed on a hash of the source,
the shared headers and the flags, under ``build/kernels/`` at the root of
the checkout. The sources are compiled in parallel, one ``nvcc`` each, and
the libraries loaded with ``ctypes``. Nothing is built or loaded when this
module is imported.

Each wrapper checks device, dtype, shape, head dim and contiguity, allocates
its outputs with ``torch.empty``, launches on PyTorch's current stream, raises
if the launch was refused, and counts its launches in ``<wrapper>.launches``.
There is no fallback: a CPU tensor, a failed build or a refused launch raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional

import torch

_PKG = Path(__file__).resolve().parents[1]
_CSRC = _PKG / "csrc"
SOURCES = (_CSRC / "attention_sm90.cu", _CSRC / "attention_bwd_sm90.cu",
           _CSRC / "probe_fp8.cu", _CSRC / "ln_matmul_sm90.cu",
           _CSRC / "block_glue_sm90.cu")
HEADERS = (_CSRC / "common.cuh", _CSRC / "sm90.cuh")
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SUPPORTED_HEAD_DIMS = (64,)
_GRID_YZ_MAX = 65535
# K7's tiling (csrc/ln_matmul_sm90.cu): K in 64-deep chunks, g and b of a
# block in shared memory as fp32 (K at most 8192), N in tiles of 128 (or
# 192) columns, 128 rows a block
LN_K_STEP, LN_MAX_K, LN_N_STEP, LN_ROWS = 64, 8192, 128, 128
# G1-G4 (csrc/block_glue_sm90.cu): 8-element (16-byte) chunks, a row held
# in one warp's registers (G1, G3: at most 2048 wide), 64-channel heads
GLUE_VEC, GLUE_MAX_WIDTH, GLUE_HEAD_DIM = 8, 2048, 64

_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: building the attention kernels "
                           "needs the CUDA toolkit")
    return path


def library_path(src: Path) -> Path:
    """Where the library of one source, for its current text, the shared
    header and the flags, lives."""
    digest = hashlib.sha256()
    for path in (src, *HEADERS):
        digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}_{digest.hexdigest()[:16]}.so"


def build() -> list:
    """Compile every source whose library does not exist yet, one ``nvcc``
    per source, all started together. The compiler's output (``-Xptxas
    -v``: registers, shared memory, spills) is kept beside each library as
    ``.log``. Returns the library paths."""
    outs = [library_path(src) for src in SOURCES]
    jobs = []
    for src, out in zip(SOURCES, outs):
        if out.exists():
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        jobs.append((out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for out, tmp, proc in jobs:
        stdout, stderr = proc.communicate()
        out.with_suffix(".log").write_text(stdout + stderr)
        if proc.returncode != 0:
            failed.append(f"{out.name}: nvcc failed with code "
                          f"{proc.returncode}:\n{stderr[-6000:]}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


def build_log() -> str:
    logs = [library_path(src).with_suffix(".log") for src in SOURCES]
    return "".join(p.read_text() for p in logs if p.exists())


_PTR, _I32, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the C entries of each source's library, with their argument types (every
# one returns an int: 0, or the cudaError_t of a refused launch)
ENTRIES = {
    "attention_sm90": {
        "must3r_sa_fwd_bf16": [_PTR] * 4 + [_I32] * 4 + [_PTR],
        "must3r_ca_fwd_bf16": [_PTR] * 6 + [_I32] * 7 + [_PTR],
        "must3r_ca_fwd_train_bf16": [_PTR] * 8 + [_I32] * 7 + [_PTR],
        "must3r_ca_fwd_q8": [_PTR] * 9 + [_I32] * 8 + [_PTR],
        "must3r_ca_fwd_2h_bf16": [_PTR] * 4 + [_I32] * 7 + [_PTR]},
    "attention_bwd_sm90": {
        "must3r_ca_bwd_fused_bf16": [_PTR] * 11 + [_I32] * 7 + [_PTR],
        "must3r_ca_bwd_dkv_bf16": [_PTR] * 10 + [_I32] * 7 + [_PTR],
        "must3r_ca_bwd_dq_bf16": [_PTR] * 10 + [_I32] * 7 + [_PTR]},
    "probe_fp8": {
        "must3r_fp8_to_bf16_x2": [_PTR] * 2 + [_I32] + [_PTR],
        "must3r_fp8_dequant_dot": [_PTR] * 3 + [_I32] * 3 + [_PTR]},
    "ln_matmul_sm90": {
        "must3r_ln_matmul_bf16": [_PTR] * 6 + [_I32] * 3 + [_PTR]},
    "block_glue_sm90": {
        "must3r_ln_cast": [_PTR] * 4 + [_I32] * 3 + [_F32, _PTR],
        "must3r_qkv_glue": [_PTR] * 11 + [_I32] * 4 + [_F32, _PTR],
        "must3r_residual_glue": [_PTR] * 8 + [_I32] * 3 + [_F32, _PTR],
        "must3r_bias_gelu": [_PTR] * 3 + [_I32] * 2 + [_PTR]},
}


def _load(stem: str) -> ctypes.CDLL:
    """The library of ``csrc/<stem>.cu`` (every source is built first)."""
    if not _libs:
        for src, path in zip(SOURCES, build()):
            lib = ctypes.CDLL(str(path))
            for name, argtypes in ENTRIES[src.stem].items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = argtypes, _I32
            _libs[src.stem] = lib
    return _libs[stem]


def _check(name: str, t: torch.Tensor, dtype, ndim: int, device,
           align: int = 16):
    if not t.is_cuda:
        raise ValueError(f"{name}: the CUDA kernel needs a CUDA tensor, got "
                         f"{t.device}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: the kernel takes {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{name}: data must be {align}-byte aligned")


def _raise_on(err: int, what: str):
    if err:
        raise RuntimeError(f"{what}: kernel launch refused (cudaError {err})")


def sa_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """K1: full self-attention, q/k/v [B, N, H, Dh] bf16 -> [B, N, H, Dh].

    Runs the TMA + wgmma program of ``csrc/attention_sm90.cu``, which picks
    the query rows per block from the grid: 192 (three consumer warpgroups,
    one block an SM) when ceil(N / 192) * H * B >= 2 * the SM count, else 64
    (one warpgroup, two blocks an SM), so that a small grid still fills the
    card. The same rule holds for :func:`ca_fwd` with B * G images."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(name, t, torch.bfloat16, 4, q.device)
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"sa_fwd: q/k/v shapes differ: {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, n, h, dh = q.shape
    if dh not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"sa_fwd: head dim {dh} not in {SUPPORTED_HEAD_DIMS}")
    if h > _GRID_YZ_MAX or b > _GRID_YZ_MAX:
        raise ValueError(f"sa_fwd: grid too large for {tuple(q.shape)}")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    lib = _load("attention_sm90")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.must3r_sa_fwd_bf16(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                     out.data_ptr(), b, n, h, dh, stream)
    _raise_on(err, "sa_fwd")
    sa_fwd.launches += 1
    return out


sa_fwd.launches = 0


def _check_ca(what: str, q, kv, labels, q_self, q_upper, kv_len, ext,
              kv_dtype=torch.bfloat16):
    """Validate the CA operands shared by K2..K5; returns (b, g, n, h, dh,
    s_cap, kv_len)."""
    dev = q.device
    _check("q", q, torch.bfloat16, 5, dev)
    _check("kv", kv, kv_dtype, 4, dev)
    _check("labels", labels, torch.int32, 2, dev)
    _check("q_self", q_self, torch.int32, 2, dev)
    _check("q_upper", q_upper, torch.int32, 2, dev)
    b, g, n, h, dh = q.shape
    s_cap = kv.shape[2]
    if dh not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"{what}: head dim {dh} not in {SUPPORTED_HEAD_DIMS}")
    if tuple(kv.shape) != (b, h, s_cap, 2 * dh):
        raise ValueError(f"{what}: kv {tuple(kv.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if tuple(labels.shape) != (b, s_cap):
        raise ValueError(f"{what}: labels {tuple(labels.shape)}, expected "
                         f"{(b, s_cap)}")
    if tuple(q_self.shape) != (b, g) or tuple(q_upper.shape) != (b, g):
        raise ValueError(f"{what}: q_self / q_upper must be [B, G]")
    if ext is not None:
        _check("ext", ext, torch.bool, 3, dev)
        if tuple(ext.shape) != (b, g, s_cap):
            raise ValueError(f"{what}: ext {tuple(ext.shape)}, expected "
                             f"{(b, g, s_cap)}")
    kv_len = int(kv_len)
    if not 0 <= kv_len <= s_cap:
        raise ValueError(f"{what}: kv_len {kv_len} outside [0, {s_cap}]")
    if h > _GRID_YZ_MAX or b * g > _GRID_YZ_MAX:
        raise ValueError(f"{what}: grid too large for {tuple(q.shape)}")
    return b, g, n, h, dh, s_cap, kv_len


def _check_bwd(what, q, lse, delta, dout):
    b, g, n, h, dh = q.shape
    _check("dout", dout, torch.bfloat16, 5, q.device)
    _check("lse", lse, torch.float32, 4, q.device)
    _check("delta", delta, torch.float32, 4, q.device)
    if dout.shape != q.shape:
        raise ValueError(f"{what}: dout {tuple(dout.shape)} != q "
                         f"{tuple(q.shape)}")
    if tuple(lse.shape) != (b, g, h, n) or delta.shape != lse.shape:
        raise ValueError(f"{what}: lse / delta must be {(b, g, h, n)}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def ca_fwd(q: torch.Tensor, kv: torch.Tensor, labels: torch.Tensor,
           q_self: torch.Tensor, q_upper: torch.Tensor, kv_len: int,
           ext: Optional[torch.Tensor] = None, return_stats: bool = False):
    """K2: label-masked memory cross-attention against one cache layer.

    q [B, G, N, H, Dh] bf16; kv [B, H, S, 2*Dh] bf16 (packed k|v); labels
    [B, S] int32; q_self / q_upper [B, G] int32 on the device; kv_len a host
    int (keys at or past it are never read); ext [B, G, S] bool (True
    blocks the key for that image) or None. Returns out [B, G, N, H, Dh],
    and with ``return_stats`` also the fp32 row log-sum-exp [B, G, H, N]
    (+1e30 for a row that attends nothing). Every variant runs the program
    of :func:`sa_fwd`, with its rule for the rows per block (192 when
    ceil(N / 192) * H * B * G >= 2 * the SM count, else 64); a key tile that
    no row attends is skipped."""
    b, g, n, h, dh, s_cap, kv_len = _check_ca(
        "ca_fwd", q, kv, labels, q_self, q_upper, kv_len, ext)
    out = torch.empty_like(q)
    lse = (torch.empty((b, g, h, n), dtype=torch.float32, device=q.device)
           if return_stats else None)
    if q.numel():
        with torch.cuda.device(q.device):
            if ext is None and not return_stats:
                err = _load("attention_sm90").must3r_ca_fwd_bf16(
                    q.data_ptr(), kv.data_ptr(), labels.data_ptr(),
                    q_self.data_ptr(), q_upper.data_ptr(), out.data_ptr(),
                    b, g, n, h, dh, s_cap, kv_len, _stream(q.device))
            else:
                err = _load("attention_sm90").must3r_ca_fwd_train_bf16(
                    q.data_ptr(), kv.data_ptr(), labels.data_ptr(),
                    q_self.data_ptr(), q_upper.data_ptr(), _ptr(ext),
                    out.data_ptr(), _ptr(lse), b, g, n, h, dh, s_cap, kv_len,
                    _stream(q.device))
        _raise_on(err, "ca_fwd")
        ca_fwd.launches += 1
    return (out, lse) if return_stats else out


ca_fwd.launches = 0

# K2(d)'s code for each 8-bit cache format (csrc/attention_sm90.cu kQ8*)
_Q8_FORMATS = {torch.int8: 1, torch.float8_e4m3fn: 2}


def ca_fwd_q8(q: torch.Tensor, kv: torch.Tensor, kv_scale: torch.Tensor,
              labels: torch.Tensor, q_self: torch.Tensor,
              q_upper: torch.Tensor, kv_len: int,
              ext: Optional[torch.Tensor] = None, return_stats: bool = False):
    """K2(d): :func:`ca_fwd` against one layer of an 8-bit cache, dequantized
    in flight. kv [B, H, S, 2*Dh] int8 or float8_e4m3fn codes (k | v packed,
    128 bytes a row; its start 16-byte aligned, as TMA reads it: a layer
    slice of the memory's [L, B, H, S, 2*Dh] codes is); kv_scale [B, H, 2,
    S] fp32 (deq = code * scale; the layer slice of the memory's [L, B, H,
    2, S] scales is contiguous). It runs the TMA + wgmma program of
    :func:`ca_fwd`, whose producer warpgroup converts the codes to bf16
    tiles. Everything else as :func:`ca_fwd`; its own launch counter, so
    that the counts show which read ran."""
    b, g, n, h, dh, s_cap, kv_len = _check_ca(
        "ca_fwd_q8", q, kv, labels, q_self, q_upper, kv_len, ext,
        kv_dtype=tuple(_Q8_FORMATS))
    _check("kv_scale", kv_scale, torch.float32, 4, q.device, align=4)
    if tuple(kv_scale.shape) != (b, h, 2, s_cap):
        raise ValueError(f"ca_fwd_q8: kv_scale {tuple(kv_scale.shape)}, "
                         f"expected {(b, h, 2, s_cap)}")
    out = torch.empty_like(q)
    lse = (torch.empty((b, g, h, n), dtype=torch.float32, device=q.device)
           if return_stats else None)
    if q.numel():
        with torch.cuda.device(q.device):
            err = _load("attention_sm90").must3r_ca_fwd_q8(
                q.data_ptr(), kv.data_ptr(), kv_scale.data_ptr(),
                labels.data_ptr(), q_self.data_ptr(), q_upper.data_ptr(),
                _ptr(ext), out.data_ptr(), _ptr(lse), b, g, n, h, dh, s_cap,
                kv_len, _Q8_FORMATS[kv.dtype], _stream(q.device))
        _raise_on(err, "ca_fwd_q8")
        ca_fwd_q8.launches += 1
    return (out, lse) if return_stats else out


ca_fwd_q8.launches = 0


def ca_bwd_dq(q, kv, labels, q_self, q_upper, kv_len, lse, delta, dout,
              ext=None) -> torch.Tensor:
    """K3: dQ [B, G, N, H, Dh] bf16 of the CA, from the forward's lse and
    delta = rowsum(dO * O) (both fp32 [B, G, H, N]). The TMA + wgmma
    program of ``csrc/attention_bwd_sm90.cu`` that owns query rows (the
    rows per block by :func:`sa_fwd`'s rule): dQ stays in registers across
    the key loop and is written once, so it is bitwise reproducible."""
    b, g, n, h, dh, s_cap, kv_len = _check_ca(
        "ca_bwd_dq", q, kv, labels, q_self, q_upper, kv_len, ext)
    _check_bwd("ca_bwd_dq", q, lse, delta, dout)
    dq = torch.empty_like(q)
    if q.numel():
        with torch.cuda.device(q.device):
            err = _load("attention_bwd_sm90").must3r_ca_bwd_dq_bf16(
                q.data_ptr(), kv.data_ptr(), labels.data_ptr(),
                q_self.data_ptr(), q_upper.data_ptr(), _ptr(ext),
                lse.data_ptr(), delta.data_ptr(), dout.data_ptr(),
                dq.data_ptr(), b, g, n, h, dh, s_cap, kv_len,
                _stream(q.device))
        _raise_on(err, "ca_bwd_dq")
        ca_bwd_dq.launches += 1
    return dq


ca_bwd_dq.launches = 0


def ca_bwd_dkv(q, kv, labels, q_self, q_upper, kv_len, lse, delta, dout,
               ext=None) -> torch.Tensor:
    """K4: dK|dV [B, H, S, 2*Dh] bf16 of one cache layer, summed over the G
    images of the step; keys at or past kv_len get 0. K5's program
    (:func:`ca_bwd_fused`) without its dQ."""
    b, g, n, h, dh, s_cap, kv_len = _check_ca(
        "ca_bwd_dkv", q, kv, labels, q_self, q_upper, kv_len, ext)
    _check_bwd("ca_bwd_dkv", q, lse, delta, dout)
    dkv = torch.empty_like(kv)
    if kv.numel():
        with torch.cuda.device(q.device):
            err = _load("attention_bwd_sm90").must3r_ca_bwd_dkv_bf16(
                q.data_ptr(), kv.data_ptr(), labels.data_ptr(),
                q_self.data_ptr(), q_upper.data_ptr(), _ptr(ext),
                lse.data_ptr(), delta.data_ptr(), dout.data_ptr(),
                dkv.data_ptr(), b, g, n, h, dh, s_cap, kv_len,
                _stream(q.device))
        _raise_on(err, "ca_bwd_dkv")
        ca_bwd_dkv.launches += 1
    return dkv


ca_bwd_dkv.launches = 0


def ca_bwd_fused(q, kv, labels, q_self, q_upper, kv_len, lse, delta, dout,
                 ext=None):
    """K5: (dQ [B, G, N, H, Dh] bf16, dK|dV [B, H, S, 2*Dh] bf16) in one
    kernel launch, the TMA + wgmma program of ``csrc/attention_bwd_sm90.cu``:
    a block owns 128 keys and adds each query tile's dQ
    into a zeroed fp32 buffer by TMA reduce-add, which is then rounded to
    bf16 (the adds land in no fixed order: dQ is not bitwise
    reproducible)."""
    b, g, n, h, dh, s_cap, kv_len = _check_ca(
        "ca_bwd_fused", q, kv, labels, q_self, q_upper, kv_len, ext)
    _check_bwd("ca_bwd_fused", q, lse, delta, dout)
    dkv = torch.empty_like(kv)
    dq32 = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    if kv.numel():
        with torch.cuda.device(q.device):
            err = _load("attention_bwd_sm90").must3r_ca_bwd_fused_bf16(
                q.data_ptr(), kv.data_ptr(), labels.data_ptr(),
                q_self.data_ptr(), q_upper.data_ptr(), _ptr(ext),
                lse.data_ptr(), delta.data_ptr(), dout.data_ptr(),
                dkv.data_ptr(), dq32.data_ptr(), b, g, n, h, dh, s_cap,
                kv_len, _stream(q.device))
        _raise_on(err, "ca_bwd_fused")
        ca_bwd_fused.launches += 1
    return dq32.to(q.dtype), dkv


ca_bwd_fused.launches = 0


def fp8_to_bf16_x2(x: torch.Tensor) -> torch.Tensor:
    """B7, the fp8 probe: bf16(x) * 2 for x float8_e4m3fn (any shape,
    contiguous) -> bf16 of x's shape."""
    _check("x", x, torch.float8_e4m3fn, x.dim(), x.device, align=1)
    out = torch.empty(x.shape, dtype=torch.bfloat16, device=x.device)
    if x.numel():
        with torch.cuda.device(x.device):
            err = _load("probe_fp8").must3r_fp8_to_bf16_x2(
                x.data_ptr(), out.data_ptr(), x.numel(), _stream(x.device))
        _raise_on(err, "fp8_to_bf16_x2")
        fp8_to_bf16_x2.launches += 1
    return out


fp8_to_bf16_x2.launches = 0


def fp8_dequant_dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """B7, the fp8 probe: bf16(x) @ w with fp32 accumulation; x [M, K]
    float8_e4m3fn, w [K, N] bf16 -> [M, N] fp32."""
    _check("x", x, torch.float8_e4m3fn, 2, x.device, align=1)
    _check("w", w, torch.bfloat16, 2, x.device, align=2)
    (m, k), (k2, n) = x.shape, w.shape
    if k != k2:
        raise ValueError(f"fp8_dequant_dot: x {tuple(x.shape)} @ w "
                         f"{tuple(w.shape)}")
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if out.numel():
        with torch.cuda.device(x.device):
            err = _load("probe_fp8").must3r_fp8_dequant_dot(
                x.data_ptr(), w.data_ptr(), out.data_ptr(), m, k, n,
                _stream(x.device))
        _raise_on(err, "fp8_dequant_dot")
        fp8_dequant_dot.launches += 1
    return out


fp8_dequant_dot.launches = 0


def check_2h(q: torch.Tensor, kv_cache: torch.Tensor, labels: torch.Tensor,
             kv_len: int, layer: int):
    """Shapes and limits of K6 and its plain version, the TPU kernel's: one
    image of queries (G = 1), an even head count (it asserts both)."""
    if q.dim() != 5 or kv_cache.dim() != 5:
        raise ValueError(f"ca_fwd_2h: q [B, 1, N, H, Dh] and kv_cache [L, B, "
                         f"H, S, 2*Dh], got {tuple(q.shape)}, "
                         f"{tuple(kv_cache.shape)}")
    b, g, n, h, dh = q.shape
    if g != 1:
        raise ValueError(f"ca_fwd_2h: takes one image of queries (G = 1), "
                         f"got G = {g}")
    if h % 2:
        raise ValueError(f"ca_fwd_2h: runs heads in pairs, H must be even, "
                         f"got H = {h}")
    s_cap = kv_cache.shape[3]
    if tuple(kv_cache.shape[1:]) != (b, h, s_cap, 2 * dh) or \
            tuple(labels.shape) != (b, s_cap):
        raise ValueError(f"ca_fwd_2h: kv_cache {tuple(kv_cache.shape)} / "
                         f"labels {tuple(labels.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if not (0 <= int(kv_len) <= s_cap and 0 <= int(layer) < kv_cache.shape[0]):
        raise ValueError(f"ca_fwd_2h: kv_len {kv_len} / layer {layer} "
                         f"outside [0, {s_cap}] / [0, {kv_cache.shape[0]})")


def ca_fwd_2h(q: torch.Tensor, kv_cache: torch.Tensor, labels: torch.Tensor,
              kv_len: int, layer: int) -> torch.Tensor:
    """K6: the CA forward with two heads per block. q [B, 1, N, H, Dh] bf16
    (H even); kv_cache the whole packed cache [L, B, H, S, 2*Dh] bf16, of
    which ``layer`` is read; labels [B, S] int32; kv_len a host int. A key
    j is attended when j < kv_len and labels[b, j] >= 0; a row that
    attends nothing is 0. Returns out [B, 1, N, H, Dh]. It runs the
    program of :func:`ca_fwd` with a head pair a block (template argument
    HP = 2: one 64-row consumer warpgroup for each head, both heads' K and
    V tiles in each stage of one ring, one mask per tile from the
    labels)."""
    dev = q.device
    _check("q", q, torch.bfloat16, 5, dev)
    _check("kv_cache", kv_cache, torch.bfloat16, 5, dev)
    _check("labels", labels, torch.int32, 2, dev)
    check_2h(q, kv_cache, labels, kv_len, layer)
    b, _, n, h, dh = q.shape
    if dh not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"ca_fwd_2h: head dim {dh} not in "
                         f"{SUPPORTED_HEAD_DIMS}")
    if b > _GRID_YZ_MAX:
        raise ValueError(f"ca_fwd_2h: grid too large for {tuple(q.shape)}")
    out = torch.empty_like(q)
    if q.numel():
        with torch.cuda.device(dev):
            err = _load("attention_sm90").must3r_ca_fwd_2h_bf16(
                q.data_ptr(), kv_cache.data_ptr(), labels.data_ptr(),
                out.data_ptr(), b, n, h, dh, kv_cache.shape[3], int(kv_len),
                int(layer), _stream(dev))
        _raise_on(err, "ca_fwd_2h")
        ca_fwd_2h.launches += 1
    return out


ca_fwd_2h.launches = 0


def ln_matmul_limits(k: int, n: int):
    """Raise, naming the limit, where K or N breaks K7's tiling."""
    if k <= 0 or k % LN_K_STEP or k > LN_MAX_K:
        raise ValueError(f"ln_matmul: K = {k} must be a positive multiple of "
                         f"{LN_K_STEP} and at most {LN_MAX_K} (g and b sit "
                         f"in a block's shared memory as fp32)")
    if n <= 0 or n % LN_N_STEP:
        raise ValueError(f"ln_matmul: N = {n} must be a positive multiple of "
                         f"{LN_N_STEP} (the kernel's column tile)")


def ln_matmul(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
              w: torch.Tensor) -> torch.Tensor:
    """K7: bf16(LayerNorm(x) * g + b) @ w, fp32 statistics (population
    variance, eps 1e-6) and fp32 accumulation, no residual. x [M, K], g / b
    [K], w [K, N], all bf16 -> [M, N] bf16; any M. Two kernels of
    ``csrc/ln_matmul_sm90.cu`` in one launch (counted once): the row
    statistics (into fp32 scratch [M, 2]), then the TMA + wgmma program of
    the product, 128 rows a block, 192 columns where N is a multiple of 192
    and that gives fewer waves of blocks, else 128."""
    (m, k), n = x.shape, w.shape[-1]
    ln_matmul_limits(k, n)
    dev = x.device
    _check("x", x, torch.bfloat16, 2, dev)
    _check("g", g, torch.bfloat16, 1, dev)
    _check("b", b, torch.bfloat16, 1, dev)
    _check("w", w, torch.bfloat16, 2, dev)
    if tuple(w.shape) != (k, n) or g.shape[0] != k or b.shape[0] != k:
        raise ValueError(f"ln_matmul: x {tuple(x.shape)}, g "
                         f"{tuple(g.shape)}, b {tuple(b.shape)}, w "
                         f"{tuple(w.shape)} do not match")
    if -(-m // LN_ROWS) > _GRID_YZ_MAX:
        raise ValueError(f"ln_matmul: M = {m} gives more than "
                         f"{_GRID_YZ_MAX} row tiles")
    out = torch.empty((m, n), dtype=x.dtype, device=dev)
    if m:
        stats = torch.empty((m, 2), dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            err = _load("ln_matmul_sm90").must3r_ln_matmul_bf16(
                x.data_ptr(), g.data_ptr(), b.data_ptr(), w.data_ptr(),
                stats.data_ptr(), out.data_ptr(), m, k, n, _stream(dev))
        _raise_on(err, "ln_matmul")
        ln_matmul.launches += 1
    return out


ln_matmul.launches = 0


# ---------------------------------------------------------------------------
# G1-G4: the pre-norm encoder block's glue (csrc/block_glue_sm90.cu)
# ---------------------------------------------------------------------------

_STREAM_DTYPES = (torch.float32, torch.bfloat16)


def _check_rows(what: str, d: int, limit: Optional[int] = GLUE_MAX_WIDTH):
    if d <= 0 or d % GLUE_VEC or (limit is not None and d > limit):
        raise ValueError(f"{what}: width {d} must be a positive multiple of "
                         f"{GLUE_VEC}" + (f" and at most {limit}" if limit
                                          else ""))


def _check_vec(name: str, t: torch.Tensor, n: int, device):
    _check(name, t, torch.float32, 1, device)
    if t.shape[0] != n:
        raise ValueError(f"{name}: {tuple(t.shape)}, expected ({n},)")


def ln_cast(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
            eps: float) -> torch.Tensor:
    """G1: bf16(LayerNorm(x) * w + b) with fp32 statistics; x [T, D] fp32
    or bf16 (D a multiple of 8, at most 2048), w / b [D] fp32 -> [T, D]
    bf16. One warp a row."""
    dev = x.device
    _check("x", x, _STREAM_DTYPES, 2, dev)
    t, d = x.shape
    _check_rows("ln_cast", d)
    _check_vec("w", w, d, dev)
    _check_vec("b", b, d, dev)
    out = torch.empty((t, d), dtype=torch.bfloat16, device=dev)
    if t:
        with torch.cuda.device(dev):
            err = _load("block_glue_sm90").must3r_ln_cast(
                x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), t,
                d, int(x.dtype == torch.bfloat16), float(eps), _stream(dev))
        _raise_on(err, "ln_cast")
        ln_cast.launches += 1
    return out


ln_cast.launches = 0


def qkv_glue(y: torch.Tensor, bias: torch.Tensor, b: int, n: int,
             q_norm=None, k_norm=None, eps: float = 0.0, rope=None):
    """G2: the qkv product's fp32 output y [B * N, 3 * D] (D = H * 64) and
    its bias [3 * D] fp32 -> q, k, v, each [B, N, H, 64] bf16 and
    contiguous (K1's layout). r = bf16(y + bias); v = r; q and k, where
    ``q_norm`` / ``k_norm`` ((w, b), each [64] fp32) are given, LayerNormed
    over each head's 64 channels with ``eps``, and where ``rope`` ((cos,
    sin), each [1 | B, N, 2, 16] fp32, ``ops/rope.py``'s tables) is given,
    rotated; both in fp32, rounded once to bf16."""
    dev = y.device
    _check("y", y, torch.float32, 2, dev)
    t, d3 = y.shape
    d = d3 // 3
    if d3 % 3 or d % GLUE_HEAD_DIM or t != b * n:
        raise ValueError(f"qkv_glue: y {tuple(y.shape)} is not [B * N, 3 * "
                         f"H * {GLUE_HEAD_DIM}] with B = {b}, N = {n}")
    if t * d3 // GLUE_VEC >= 2 ** 31:
        raise ValueError(f"qkv_glue: y {tuple(y.shape)} is too large")
    _check_vec("bias", bias, d3, dev)
    if (q_norm is None) != (k_norm is None):
        raise ValueError("qkv_glue: QK-norm takes both q_norm and k_norm")
    norms = []
    for name, pair in (("q_norm", q_norm), ("k_norm", k_norm)):
        if pair is not None:
            for t_ in pair:
                _check_vec(name, t_, GLUE_HEAD_DIM, dev)
                norms.append(t_)
    batched = 0
    if rope is not None:
        for name, tab in zip(("cos", "sin"), rope):
            _check(name, tab, torch.float32, 4, dev)
            if tab.shape[0] not in (1, b) or tuple(tab.shape[1:]) != (
                    n, 2, GLUE_HEAD_DIM // 4):
                raise ValueError(f"qkv_glue: rope {name} {tuple(tab.shape)},"
                                 f" expected [1 | {b}, {n}, 2, "
                                 f"{GLUE_HEAD_DIM // 4}]")
        batched = int(rope[0].shape[0] == b and b > 1)
        if rope[1].shape != rope[0].shape:
            raise ValueError("qkv_glue: cos and sin differ in shape")
    shape = (b, n, d // GLUE_HEAD_DIM, GLUE_HEAD_DIM)
    q, k, v = (torch.empty(shape, dtype=torch.bfloat16, device=dev)
               for _ in range(3))
    if t:
        qn_w, qn_b, kn_w, kn_b = norms or (None,) * 4
        cos, sin = rope if rope is not None else (None, None)
        with torch.cuda.device(dev):
            err = _load("block_glue_sm90").must3r_qkv_glue(
                y.data_ptr(), bias.data_ptr(), _ptr(qn_w), _ptr(qn_b),
                _ptr(kn_w), _ptr(kn_b), _ptr(cos), _ptr(sin), q.data_ptr(),
                k.data_ptr(), v.data_ptr(), t, d, n, batched, float(eps),
                _stream(dev))
        _raise_on(err, "qkv_glue")
        qkv_glue.launches += 1
    return q, k, v


qkv_glue.launches = 0


def residual_glue(y: torch.Tensor, bias: torch.Tensor, x: torch.Tensor,
                  gamma: Optional[torch.Tensor] = None, norm=None,
                  eps: float = 0.0, inplace: bool = False):
    """G3: a branch product's fp32 output y [T, D] and its bias [D] fp32,
    the residual stream x [T, D] fp32 or bf16 -> (x', xn). h = bf16(y +
    bias); x' = x + gamma * h (``gamma`` [D] fp32, LayerScale) or x + h, in
    fp32, rounded once to x's dtype; written into x with ``inplace``, else
    to a new tensor. xn = bf16(LayerNorm(x') * w + b) with ``norm`` ((w,
    b), each [D] fp32) and ``eps``, else None."""
    dev = x.device
    _check("y", y, torch.float32, 2, dev)
    _check("x", x, _STREAM_DTYPES, 2, dev)
    t, d = x.shape
    if tuple(y.shape) != (t, d):
        raise ValueError(f"residual_glue: y {tuple(y.shape)} != x "
                         f"{tuple(x.shape)}")
    _check_rows("residual_glue", d)
    _check_vec("bias", bias, d, dev)
    if gamma is not None:
        _check_vec("gamma", gamma, d, dev)
    if norm is not None:
        for t_ in norm:
            _check_vec("norm", t_, d, dev)
    out = x if inplace else torch.empty_like(x)
    xn = (torch.empty((t, d), dtype=torch.bfloat16, device=dev)
          if norm is not None else None)
    if t:
        nw, nb = norm if norm is not None else (None, None)
        with torch.cuda.device(dev):
            err = _load("block_glue_sm90").must3r_residual_glue(
                y.data_ptr(), bias.data_ptr(), x.data_ptr(), out.data_ptr(),
                _ptr(gamma), _ptr(nw), _ptr(nb), _ptr(xn), t, d,
                int(x.dtype == torch.bfloat16), float(eps), _stream(dev))
        _raise_on(err, "residual_glue")
        residual_glue.launches += 1
    return out, xn


residual_glue.launches = 0


def bias_gelu(y: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """G4: bf16(gelu(bf16(y + bias))), the exact erf GELU in fp32; y [T,
    F] fp32 (F a multiple of 8), bias [F] fp32 -> [T, F] bf16."""
    dev = y.device
    _check("y", y, torch.float32, 2, dev)
    t, f = y.shape
    _check_rows("bias_gelu", f, limit=None)
    _check_vec("bias", bias, f, dev)
    if t * f // GLUE_VEC >= 2 ** 31:
        raise ValueError(f"bias_gelu: y {tuple(y.shape)} is too large")
    out = torch.empty((t, f), dtype=torch.bfloat16, device=dev)
    if t:
        with torch.cuda.device(dev):
            err = _load("block_glue_sm90").must3r_bias_gelu(
                y.data_ptr(), bias.data_ptr(), out.data_ptr(), t, f,
                _stream(dev))
        _raise_on(err, "bias_gelu")
        bias_gelu.launches += 1
    return out


bias_gelu.launches = 0


KERNELS = (sa_fwd, ca_fwd, ca_bwd_dq, ca_bwd_dkv, ca_bwd_fused, ca_fwd_q8,
           fp8_to_bf16_x2, fp8_dequant_dot, ca_fwd_2h, ln_matmul, ln_cast,
           qkv_glue, residual_glue, bias_gelu)
