// The pre-norm encoder block's glue (models/layers.py::encoder_block on its
// fused path), hand-written for Hopper (sm_90a): four row kernels between
// the block's four products (torch.mm with fp32 output) and K1. Each reads
// a product's fp32 output once and writes the next product's bf16 input
// once, with the residual stream where one is due:
//
//   G1 ln_cast       : out = bf16(LN(x) * w + b); x [T, D] fp32 or bf16
//                      (norm1).
//   G2 qkv_glue      : y [T, 3D] fp32 (the qkv product) -> q, k, v, each
//                      [T, D] = [B, N, H, 64] bf16 (K1's layout): r =
//                      bf16(y + bias); q and k optionally LayerNormed over
//                      each head's 64 channels (QK-norm) and rotated by 2D
//                      RoPE, both in fp32 and rounded once; v = r.
//   G3 residual_glue : h = bf16(y + bias) (proj or fc2); x' = x + gamma *
//                      h (LayerScale) or x + h, in fp32, rounded once to
//                      x's dtype and written to x_out (x itself or a new
//                      tensor); optionally xn = bf16(LN(x') * w + b)
//                      (norm2, the fc1 product's input).
//   G4 bias_gelu     : out = bf16(gelu(bf16(y + bias))), the exact erf
//                      GELU in fp32; y [T, F] fp32 (the fc1 product).
//
// They replace no TPU kernel: the JAX package leaves this glue to XLA,
// which fuses it into its products. Eager PyTorch ran it as ~40 kernels a
// block (bias adds, casts, LayerNorms over 64-channel rows, RoPE's strided
// products, addcmul), each reading and writing fp32 tensors.
//
// Rounding points are those of the plain composition (linear, layer_norm,
// self_attn, scaled_add in models/layers.py, apply_rope2d in ops/rope.py):
// the bias is added in fp32 and the branch rounded to bf16 once; LayerNorm
// statistics are fp32 (two passes over registers: the mean, then the mean
// of (x - mean)^2; rsqrtf as PyTorch); RoPE takes each product and each
// sum rounded on its own (__fmul_rn / __fadd_rn: no contraction into an
// FMA, as PyTorch's separate kernels compute it); LayerScale is x + (gamma
// * h) with the product rounded, as addcmul; GELU is x * 0.5 * (1 +
// erf(x * sqrt(1/2))), PyTorch's form.
//
// What bounds them: bytes. At VGGT's width (D = 1024, F = 4096) a token
// moves 6 KB in G1 (4 KB fp32 in, 2 KB out), 18 KB in G2, 14 KB in G3
// after proj and 12 KB after fc2, 24 KB in G4: ~74 KB a token a block, 1
// flop or less a byte. The design is to touch each byte once, with 16-byte
// vector loads and stores (8 elements a lane), neighbouring lanes on
// neighbouring addresses:
//   - G1 / G3: one warp a row, 4 rows a block. A lane holds its row's
//     8-element chunks c = lane + 32 i in registers (up to 8 chunks: D at
//     most 2048), so the LayerNorm's two passes read registers, not memory;
//     the statistics are warp shuffles.
//   - G2: one thread a chunk of 8 channels, so 8 neighbouring lanes hold one
//     head: QK-norm's sums are 3 shuffles (xor 1, 2, 4), and RoPE's partner
//     (channel d +- 16 within the same axis half) is the lane xor 2. Every
//     lane runs the shuffles (v lanes discard them), so no shuffle sits in a
//     divergent branch. The rope tables ([1 | B, N, 2, 16] fp32, 256 bytes a
//     token) are read from L1 / L2, shared by the token's 16 heads.
//   - G4: one thread a chunk of 8, no reduction.

#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kVec = 8;            // elements a lane moves at once
constexpr int kRowWarps = 4;       // G1 / G3: rows (warps) a block
constexpr int kUnitThreads = 256;  // G2 / G4: threads a block
constexpr int kHeadDim = 64;
constexpr int kRopeFreq = kHeadDim / 4;

__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float round_to(float x, float*) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16*) {
  return round_bf16(x);
}

// r[e] = bf16(y[e] + bias[e]) as floats: the branch, rounded once
__device__ __forceinline__ void bias_round(const float* y, const float* bias,
                                           float* r) {
  float b[kVec];
  load8(y, r);
  load8(bias, b);
#pragma unroll
  for (int e = 0; e < kVec; ++e) r[e] = round_bf16(r[e] + b[e]);
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
  return s;
}

// LayerNorm of one row held by a warp (chunk c = lane + 32 i of 8 values in
// v[i]), fp32 statistics, the affine, rounded to bf16 into out[row].
template <int kC>
__device__ __forceinline__ void row_norm(const float (&v)[kC][kVec],
                                         int lane, int nchunks, int D,
                                         const float* __restrict__ w,
                                         const float* __restrict__ b,
                                         float eps, __nv_bfloat16* out) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kC; ++i) {
    if (lane + 32 * i < nchunks) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) s += v[i][e];
    }
  }
  const float mean = warp_sum(s) / D;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < kC; ++i) {
    if (lane + 32 * i < nchunks) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const float d = v[i][e] - mean;
        q += d * d;
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(q) / D + eps);
#pragma unroll
  for (int i = 0; i < kC; ++i) {
    const int c = lane + 32 * i;
    if (c >= nchunks) continue;
    float g[kVec], bb[kVec], o[kVec];
    load8(w + c * kVec, g);
    load8(b + c * kVec, bb);
#pragma unroll
    for (int e = 0; e < kVec; ++e)
      o[e] = fmaf(g[e], (v[i][e] - mean) * rstd, bb[e]);
    store8(out + c * kVec, o);
  }
}

// G1. grid ceil(T / kRowWarps), kRowWarps warps a block, one warp a row.
template <typename Tx, int kC>
__global__ void __launch_bounds__(kRowWarps * 32)
ln_cast_kernel(const Tx* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ b, __nv_bfloat16* __restrict__ out,
               int T, int D, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  if (row >= T) return;  // the whole warp: its shuffles stay full
  const int nchunks = D / kVec;
  const size_t base = static_cast<size_t>(row) * D;
  float v[kC][kVec] = {};
#pragma unroll
  for (int i = 0; i < kC; ++i) {
    const int c = lane + 32 * i;
    if (c < nchunks) load8(x + base + c * kVec, v[i]);
  }
  row_norm<kC>(v, lane, nchunks, D, w, b, eps, out + base);
}

// G3. As G1. x and x_out may be the same tensor (each element is read and
// then written by one lane), so neither is __restrict__.
template <typename Tx, bool kScale, bool kNorm, int kC>
__global__ void __launch_bounds__(kRowWarps * 32)
residual_glue_kernel(const float* __restrict__ y,
                     const float* __restrict__ bias, const Tx* x, Tx* x_out,
                     const float* __restrict__ gamma,
                     const float* __restrict__ nw,
                     const float* __restrict__ nb,
                     __nv_bfloat16* __restrict__ xn, int T, int D,
                     float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  if (row >= T) return;
  const int nchunks = D / kVec;
  const size_t base = static_cast<size_t>(row) * D;
  float v[kC][kVec] = {};
#pragma unroll
  for (int i = 0; i < kC; ++i) {
    const int c = lane + 32 * i;
    if (c >= nchunks) continue;
    float h[kVec], xv[kVec];
    bias_round(y + base + c * kVec, bias + c * kVec, h);
    load8(x + base + c * kVec, xv);
    if (kScale) {
      float g[kVec];
      load8(gamma + c * kVec, g);
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        v[i][e] = round_to(__fadd_rn(xv[e], __fmul_rn(h[e], g[e])), x_out);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        v[i][e] = round_to(xv[e] + h[e], x_out);
    }
    store8(x_out + base + c * kVec, v[i]);
  }
  if (kNorm) row_norm<kC>(v, lane, nchunks, D, nw, nb, eps, xn + base);
}

// G2. One thread a chunk of 8 channels of one row of y [T, 3D]: grid
// ceil(T * 3D / 8 / kUnitThreads). The 8 chunks of a head are 8
// neighbouring lanes (3D / 8 and D / 8 are multiples of 8).
template <bool kQkNorm, bool kRope>
__global__ void __launch_bounds__(kUnitThreads)
qkv_glue_kernel(const float* __restrict__ y, const float* __restrict__ bias,
                const float* __restrict__ qn_w,
                const float* __restrict__ qn_b,
                const float* __restrict__ kn_w,
                const float* __restrict__ kn_b,
                const float* __restrict__ cos_t,
                const float* __restrict__ sin_t,
                __nv_bfloat16* __restrict__ q, __nv_bfloat16* __restrict__ k,
                __nv_bfloat16* __restrict__ v, int T, int D, int N,
                int rope_batched, float eps) {
  const unsigned per_row = 3u * D / kVec;
  const unsigned u = blockIdx.x * kUnitThreads + threadIdx.x;
  const bool live = u < static_cast<unsigned>(T) * per_row;
  const unsigned row = live ? u / per_row : 0;
  const int col = live ? static_cast<int>(u % per_row) * kVec : 0;
  const int part = col / D;          // 0: q, 1: k, 2: v
  const int ch = col - part * D;     // channel within the part
  const int hc = ch & (kHeadDim - 1);
  float r[kVec] = {};
  if (live) bias_round(y + static_cast<size_t>(row) * 3 * D + col,
                       bias + col, r);
  if (kQkNorm) {
    float s = 0.f;
#pragma unroll
    for (int e = 0; e < kVec; ++e) s += r[e];
    s += __shfl_xor_sync(kFull, s, 1);
    s += __shfl_xor_sync(kFull, s, 2);
    s += __shfl_xor_sync(kFull, s, 4);
    const float mean = s / kHeadDim;
    float sq = 0.f;
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      const float d = r[e] - mean;
      sq += d * d;
    }
    sq += __shfl_xor_sync(kFull, sq, 1);
    sq += __shfl_xor_sync(kFull, sq, 2);
    sq += __shfl_xor_sync(kFull, sq, 4);
    const float rstd = rsqrtf(sq / kHeadDim + eps);
    if (live && part < 2) {
      float g[kVec], b[kVec];
      load8((part ? kn_w : qn_w) + hc, g);
      load8((part ? kn_b : qn_b) + hc, b);
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        r[e] = fmaf(g[e], (r[e] - mean) * rstd, b[e]);
    }
  }
  if (kRope) {
    // head channel d = axis * 32 + half * 16 + f: this lane's partner (the
    // other half, the same axis and frequencies) is the lane xor 2
    float o[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) o[e] = __shfl_xor_sync(kFull, r[e], 2);
    if (live && part < 2) {
      const int axis = hc >> 5;
      const bool second = (hc >> 4) & 1;
      const unsigned trow = rope_batched ? row : row % N;
      const size_t t = (static_cast<size_t>(trow) * 2 + axis) * kRopeFreq +
                       (hc & (kRopeFreq - 1));
      float c[kVec], sn[kVec];
      load8(cos_t + t, c);
      load8(sin_t + t, sn);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const float a = __fmul_rn(r[e], c[e]);
        const float b = __fmul_rn(o[e], sn[e]);
        r[e] = second ? __fadd_rn(a, b) : __fsub_rn(a, b);
      }
    }
  }
  if (live) {
    __nv_bfloat16* dst = part == 0 ? q : (part == 1 ? k : v);
    store8(dst + static_cast<size_t>(row) * D + ch, r);
  }
}

// G4. One thread a chunk of 8 of y [T, F]: grid ceil(T * F / 8 /
// kUnitThreads).
__global__ void __launch_bounds__(kUnitThreads)
bias_gelu_kernel(const float* __restrict__ y, const float* __restrict__ bias,
                 __nv_bfloat16* __restrict__ out, unsigned chunks, int F) {
  const unsigned u = blockIdx.x * kUnitThreads + threadIdx.x;
  if (u >= chunks) return;
  const size_t off = static_cast<size_t>(u) * kVec;
  float r[kVec];
  bias_round(y + off, bias + static_cast<int>(off % F), r);
  constexpr float kAlpha = 0.70710678118654752440f;  // M_SQRT1_2
#pragma unroll
  for (int e = 0; e < kVec; ++e)
    r[e] = r[e] * 0.5f * (1.f + erff(r[e] * kAlpha));
  store8(out + off, r);
}

// a lane's chunks of a row, rounded up to a power of two: 4 (D <= 1024)
// or 8 (D <= 2048)
constexpr int kMaxWidth = 32 * kVec * 8;

inline unsigned row_blocks(int T) { return (T + kRowWarps - 1) / kRowWarps; }

template <typename Tx>
int launch_ln_cast(const void* x, const void* w, const void* b, void* out,
                   int T, int D, float eps, cudaStream_t s) {
  auto* xp = static_cast<const Tx*>(x);
  auto* wp = static_cast<const float*>(w);
  auto* bp = static_cast<const float*>(b);
  auto* op = static_cast<__nv_bfloat16*>(out);
  if (D <= 32 * kVec * 4)
    ln_cast_kernel<Tx, 4><<<row_blocks(T), kRowWarps * 32, 0, s>>>(
        xp, wp, bp, op, T, D, eps);
  else
    ln_cast_kernel<Tx, 8><<<row_blocks(T), kRowWarps * 32, 0, s>>>(
        xp, wp, bp, op, T, D, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename Tx, bool kScale, bool kNorm>
int launch_residual(const void* y, const void* bias, const void* x,
                    void* x_out, const void* gamma, const void* nw,
                    const void* nb, void* xn, int T, int D, float eps,
                    cudaStream_t s) {
  auto args = [&](auto kernel) {
    kernel<<<row_blocks(T), kRowWarps * 32, 0, s>>>(
        static_cast<const float*>(y), static_cast<const float*>(bias),
        static_cast<const Tx*>(x), static_cast<Tx*>(x_out),
        static_cast<const float*>(gamma), static_cast<const float*>(nw),
        static_cast<const float*>(nb), static_cast<__nv_bfloat16*>(xn), T,
        D, eps);
  };
  if (D <= 32 * kVec * 4)
    args(residual_glue_kernel<Tx, kScale, kNorm, 4>);
  else
    args(residual_glue_kernel<Tx, kScale, kNorm, 8>);
  return static_cast<int>(cudaGetLastError());
}

template <typename Tx>
int dispatch_residual(const void* y, const void* bias, const void* x,
                      void* x_out, const void* gamma, const void* nw,
                      const void* nb, void* xn, int T, int D, float eps,
                      cudaStream_t s) {
  const bool scale = gamma != nullptr, norm = xn != nullptr;
  if (scale && norm)
    return launch_residual<Tx, true, true>(y, bias, x, x_out, gamma, nw, nb,
                                           xn, T, D, eps, s);
  if (scale)
    return launch_residual<Tx, true, false>(y, bias, x, x_out, gamma, nw,
                                            nb, xn, T, D, eps, s);
  if (norm)
    return launch_residual<Tx, false, true>(y, bias, x, x_out, gamma, nw,
                                            nb, xn, T, D, eps, s);
  return launch_residual<Tx, false, false>(y, bias, x, x_out, gamma, nw, nb,
                                           xn, T, D, eps, s);
}

bool bad_rows(int T, int D) {
  return T <= 0 || D <= 0 || D % kVec || D > kMaxWidth;
}

}  // namespace

extern "C" {

// Each returns 0 on success, else the cudaError_t of the refused launch.
// x_bf16: 1 for a bf16 residual row, 0 for fp32. Pointers to optional
// operands are NULL where the block has no such part.

int must3r_ln_cast(const void* x, const void* w, const void* b, void* out,
                   int T, int D, int x_bf16, float eps, void* stream) {
  if (bad_rows(T, D)) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  return x_bf16 ? launch_ln_cast<__nv_bfloat16>(x, w, b, out, T, D, eps, s)
                : launch_ln_cast<float>(x, w, b, out, T, D, eps, s);
}

int must3r_qkv_glue(const void* y, const void* bias, const void* qn_w,
                    const void* qn_b, const void* kn_w, const void* kn_b,
                    const void* cos_t, const void* sin_t, void* q, void* k,
                    void* v, int T, int D, int N, int rope_batched,
                    float eps, void* stream) {
  if (T <= 0 || D <= 0 || D % kHeadDim || N <= 0 ||
      static_cast<long long>(T) * 3 * D / kVec >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool norm = qn_w != nullptr, rope = cos_t != nullptr;
  const unsigned units = static_cast<unsigned>(
      static_cast<long long>(T) * 3 * D / kVec);
  const unsigned grid = (units + kUnitThreads - 1) / kUnitThreads;
  auto s = static_cast<cudaStream_t>(stream);
  auto run = [&](auto kernel) {
    kernel<<<grid, kUnitThreads, 0, s>>>(
        static_cast<const float*>(y), static_cast<const float*>(bias),
        static_cast<const float*>(qn_w), static_cast<const float*>(qn_b),
        static_cast<const float*>(kn_w), static_cast<const float*>(kn_b),
        static_cast<const float*>(cos_t), static_cast<const float*>(sin_t),
        static_cast<__nv_bfloat16*>(q), static_cast<__nv_bfloat16*>(k),
        static_cast<__nv_bfloat16*>(v), T, D, N, rope_batched, eps);
  };
  if (norm && rope) run(qkv_glue_kernel<true, true>);
  else if (norm) run(qkv_glue_kernel<true, false>);
  else if (rope) run(qkv_glue_kernel<false, true>);
  else run(qkv_glue_kernel<false, false>);
  return static_cast<int>(cudaGetLastError());
}

int must3r_residual_glue(const void* y, const void* bias, const void* x,
                         void* x_out, const void* gamma, const void* nw,
                         const void* nb, void* xn, int T, int D, int x_bf16,
                         float eps, void* stream) {
  if (bad_rows(T, D)) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  return x_bf16 ? dispatch_residual<__nv_bfloat16>(y, bias, x, x_out, gamma,
                                                   nw, nb, xn, T, D, eps, s)
                : dispatch_residual<float>(y, bias, x, x_out, gamma, nw, nb,
                                           xn, T, D, eps, s);
}

int must3r_bias_gelu(const void* y, const void* bias, void* out, int T,
                     int F, void* stream) {
  if (T <= 0 || F <= 0 || F % kVec ||
      static_cast<long long>(T) * F / kVec >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned chunks = static_cast<unsigned>(
      static_cast<long long>(T) * F / kVec);
  bias_gelu_kernel<<<(chunks + kUnitThreads - 1) / kUnitThreads,
                     kUnitThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), chunks, F);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
