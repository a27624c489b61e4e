// The WMMA attention forward program of the PyTorch port (sm_90a), bf16
// out, fp32 softmax statistics. K1 and the bf16 K2 moved to the TMA + wgmma
// program of attention_sm90.cu; two kernels stay here:
//
//   K2(d) ca_fwd_q8 : label-masked cross-attention of queries against one
//               layer of an 8-bit token memory (template QUANT: int8 or fp8
//               e4m3), replacing the kv_scales variant of
//               must3r_tpu/ops/attention.py::_ca_pallas. q/out [B, G, N, H,
//               Dh] bf16; kv8 [B, H, S, 2*Dh] codes (a row is 128 bytes, 64
//               k codes then 64 v codes); scale [B, H, 2, S] fp32 holds the
//               per-key k and v scales (deq = code * scale); labels [B, S]
//               int32 (-1 = free slot); q_self / q_upper [B, G] int32. A
//               key j is attended when
//                 j < kv_len && lbl >= 0 && lbl != q_self && lbl < q_upper.
//               The codes are loaded with 16-byte vector loads and converted
//               to bf16 while the tile is stored to shared memory: both
//               conversions are exact (|int8| <= 127 fits bf16's 8-bit
//               significand, and e4m3 has a 3-bit mantissa and a narrower
//               exponent range). As in the TPU kernel, the k scale
//               multiplies the score column, s = (q . k_code) *
//               softmax_scale * kscale[j]; the row max and sum use p before
//               the v scale, and p * vscale[j] is rounded to bf16 for the
//               P.V product. It composes with the training flags STATS
//               (fp32 log-sum-exp lse [B, G, H, N]) and EXT (ext [B, G, S]
//               bool, a nonzero entry blocks key j for image g); serving
//               launches it with neither.
//   K6 ca_fwd_2h : two heads per block. Replaces _ca_pallas_2h of
//               scripts/bench_ca_kernel.py, the microbenchmark's variant of
//               _ca_pallas that runs a head pair over one shared label DMA:
//               one image of queries (q/out [B, 1, N, H, Dh], H even), the
//               whole bf16 cache [L, B, H, S, 2*Dh] with a layer index, and
//               the mask j < kv_len && label >= 0 alone (no q_self /
//               q_upper / ext, no LSE, no 8-bit cache).
//
// Both share one block program: a block owns 64 query rows of one
// (batch*image, head). Its Q tile sits in shared memory; the block walks
// 64-key K/V tiles, computes S = Q K^T and O += P V with bf16 WMMA
// (mma.sync) at fp32 accumulation, and keeps the online-softmax row max and
// sum in fp32 registers. Each of the 4 warps owns 16 query rows end to end
// (scores, softmax, output), so only the shared K/V tile needs a
// block-wide barrier. K6 runs that program for a pair of heads in one
// block of 8 warps (4 per head, each head with its own Q/K/V/S/P/O
// regions, ~70 KB each) and computes each tile's allow vector from the
// labels once, into shared memory that both heads read: the TPU kernel's
// shared label DMA.
//
// What bounds it: ~4*Dh flops per (query, key) pair against 2*Dh bytes of
// codes and 8 bytes of scales per key per 64 query rows (K6: 2*Dh*2 bytes
// of bf16): operations, on the tensor cores. This program is built for
// being right, not fast: scores and the output accumulator make a round
// trip through shared memory each tile (the WMMA fragment layout is opaque,
// so the per-row softmax rescale is done on a shared copy), and the tile
// loads do not overlap the products. The K2(d) codes are converted in the
// tile load, which a TMA ring would first have to move to the consumers
// (ROADMAP queue B).
//
// Semantics that differ from the TPU kernel on purpose: a query row with no
// attended key (every label masked, or kv_len == 0) returns 0. The Pallas
// kernel returns the mean of V over its first block there, because a masked
// score of -1e30 minus a running max of -1e30 gives exp(0) = 1; here the
// probability of a masked key is forced to 0. Such a row's LSE is
// kEmptyLse (+1e30), so that the backward recomputes p = 0 for it.

#include <cuda_fp8.h>
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;
using namespace must3r;

namespace {

template <int DH>
struct Layout {
  // Row pitches in elements, padded by 16 bytes so that WMMA tile pointers
  // stay 32-byte aligned and rows do not all start on the same bank.
  static constexpr int LDH = DH + 8;    // bf16 Q / K / V rows
  static constexpr int LDS = kBK + 4;   // fp32 score rows
  static constexpr int LDP = kBK + 8;   // bf16 probability rows
  static constexpr int LDO = DH + 4;    // fp32 output-accumulator rows
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + kBQ * LDH * 2;
  static constexpr int V_OFF = K_OFF + kBK * LDH * 2;
  static constexpr int S_OFF = V_OFF + kBK * LDH * 2;
  static constexpr int P_OFF = S_OFF + kBQ * LDS * 4;
  static constexpr int O_OFF = P_OFF + kBQ * LDP * 2;
  static constexpr int A_OFF = O_OFF + kBQ * LDO * 4;
  static constexpr int BYTES = A_OFF + kBK * 4;
  // K2(d) adds the tile's k and v scales, fp32 [2][kBK], after sAllow
  static constexpr int SC_OFF = BYTES;
  static constexpr int BYTES_Q8 = SC_OFF + 2 * kBK * 4;
  static_assert(DH % 16 == 0, "head dim must be a multiple of 16");
  static_assert(K_OFF % 128 == 0 && V_OFF % 128 == 0 && S_OFF % 128 == 0 &&
                P_OFF % 128 == 0 && O_OFF % 128 == 0 && A_OFF % 128 == 0,
                "shared-memory regions must stay aligned");
};

// STATS: also write the row's log-sum-exp to lse [B*G, H, N].
// EXT: ext [B*G, S] bool; a nonzero entry blocks the key.
// QUANT: kQ8Int8 / kQ8Fp8, the format of the 8-bit cache kv8 ([B, H, S,
//   2*DH] codes), whose scales are in kv_scale [B, H, 2, S].
constexpr int kQ8Int8 = 1;
constexpr int kQ8Fp8 = 2;

// 16 codes (one 16-byte vector) -> 16 bf16 in two 16-byte vectors; exact.
template <int QUANT>
__device__ __forceinline__ void codes_to_bf16(uint4 raw, uint4* dst) {
  const uint8_t* c = reinterpret_cast<const uint8_t*>(&raw);
  __align__(16) __nv_bfloat16 tmp[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    float f;
    if constexpr (QUANT == kQ8Int8) {
      f = static_cast<float>(static_cast<int8_t>(c[e]));
    } else {
      __nv_fp8_e4m3 x;
      x.__x = c[e];
      f = static_cast<float>(x);
    }
    tmp[e] = __float2bfloat16(f);
  }
  dst[0] = reinterpret_cast<const uint4*>(tmp)[0];
  dst[1] = reinterpret_cast<const uint4*>(tmp)[1];
}

using QFrag =
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;

// The per-warp steps of one key tile, shared by K2(d) and K6. A warp owns 16
// query rows: its Q rows as WMMA A fragments, and its rows of the score (S),
// probability (P) and output-accumulator (O) regions in shared memory.

// S_w(16 x kBK) = Q_w K^T, fp32.
template <int DH>
__device__ __forceinline__ void warp_scores(const QFrag (&qa)[DH / 16],
                                            const __nv_bfloat16* sK,
                                            float* sS_w) {
  using L = Layout<DH>;
#pragma unroll
  for (int nt = 0; nt < kBK / 16; ++nt) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> kb;
      wmma::load_matrix_sync(kb, sK + nt * 16 * L::LDH + kk * 16, L::LDH);
      wmma::mma_sync(acc, qa[kk], kb, acc);
    }
    wmma::store_matrix_sync(sS_w + nt * 16, acc, L::LDS, wmma::mem_row_major);
  }
}

// Online softmax over this tile, one row per lane pair (32 columns each):
// updates the row's running max / sum, writes P_w (bf16) and rescales O_w.
// sAllow[j] != 0 admits key j; with QUANT the k scale sKs multiplies the
// score column and P.V takes p * sVs (the row sum takes p before it).
template <int DH, int QUANT>
__device__ __forceinline__ void warp_online_softmax(
    const float* sS_w, const int* sAllow, const float* sKs, const float* sVs,
    __nv_bfloat16* sP_w, float* sO_w, int lane, float scale, float& m_run,
    float& l_run) {
  using L = Layout<DH>;
  const int rr = lane >> 1;
  const int half = lane & 1;
  const float* srow = sS_w + rr * L::LDS + half * 32;
  const int* arow = sAllow + half * 32;
  const float* ks = QUANT ? sKs + half * 32 : nullptr;
  const float* vs = QUANT ? sVs + half * 32 : nullptr;
  float mx = kNegInf;
#pragma unroll
  for (int c = 0; c < 32; ++c) {
    const float sc = QUANT ? srow[c] * scale * ks[c] : srow[c] * scale;
    if (arow[c]) mx = fmaxf(mx, sc);
  }
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  const float m_new = fmaxf(m_run, mx);
  const float corr = expf(m_run - m_new);
  float lsum = 0.f;
  __nv_bfloat16* prow = sP_w + rr * L::LDP + half * 32;
#pragma unroll
  for (int c = 0; c < 32; ++c) {
    const float sc = QUANT ? srow[c] * scale * ks[c] : srow[c] * scale;
    const float p = arow[c] ? expf(sc - m_new) : 0.f;
    // K2(d): the row sum takes p before the v scale, P.V takes p * vs
    // (a masked key's scale is not read: it may be anything)
    prow[c] = __float2bfloat16(QUANT ? (arow[c] ? p * vs[c] : 0.f) : p);
    lsum += p;
  }
  lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
  l_run = l_run * corr + lsum;
  m_run = m_new;
  float* orow = sO_w + rr * L::LDO + half * (DH / 2);
#pragma unroll
  for (int c = 0; c < DH / 2; ++c) orow[c] *= corr;
}

// O_w(16 x DH) += P_w(16 x kBK) V(kBK x DH).
template <int DH>
__device__ __forceinline__ void warp_pv(const __nv_bfloat16* sP_w,
                                        const __nv_bfloat16* sV,
                                        float* sO_w) {
  using L = Layout<DH>;
  QFrag pa[kBK / 16];
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
    wmma::load_matrix_sync(pa[kk], sP_w + kk * 16, L::LDP);
#pragma unroll
  for (int nt = 0; nt < DH / 16; ++nt) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> o;
    wmma::load_matrix_sync(o, sO_w + nt * 16, L::LDO, wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> vb;
      wmma::load_matrix_sync(vb, sV + kk * 16 * L::LDH + nt * 16, L::LDH);
      wmma::mma_sync(o, pa[kk], vb, o);
    }
    wmma::store_matrix_sync(sO_w + nt * 16, o, L::LDO, wmma::mem_row_major);
  }
}

// Normalise one lane's half row (DH / 2 accumulators) and store it as bf16;
// a row with nothing attended has l_run == 0 and a zero accumulator, so it
// writes 0.
template <int DH>
__device__ __forceinline__ void warp_store_half_row(const float* orow,
                                                    float l_run,
                                                    __nv_bfloat16* dst) {
  const float inv = 1.f / fmaxf(l_run, 1e-30f);
#pragma unroll
  for (int c = 0; c < DH / 2; c += 8) {
    __align__(16) __nv_bfloat16 tmp[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) tmp[e] = __float2bfloat16(orow[c + e] * inv);
    *reinterpret_cast<uint4*>(dst + c) = *reinterpret_cast<const uint4*>(tmp);
  }
}

template <int DH, bool STATS, bool EXT, int QUANT>
__global__ void __launch_bounds__(kThreads)
attn_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                const uint8_t* __restrict__ kv8,
                const float* __restrict__ kv_scale,
                const int32_t* __restrict__ labels,
                const int32_t* __restrict__ q_self,
                const int32_t* __restrict__ q_upper,
                const uint8_t* __restrict__ ext,
                __nv_bfloat16* __restrict__ out,
                float* __restrict__ lse,
                int G, int N, int H, int S, int n_keys, float scale) {
  using L = Layout<DH>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem + L::Q_OFF);
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem + L::K_OFF);
  __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(smem + L::V_OFF);
  float* sS = reinterpret_cast<float*>(smem + L::S_OFF);
  __nv_bfloat16* sP = reinterpret_cast<__nv_bfloat16*>(smem + L::P_OFF);
  float* sO = reinterpret_cast<float*>(smem + L::O_OFF);
  int* sAllow = reinterpret_cast<int*>(smem + L::A_OFF);
  float* sKs = reinterpret_cast<float*>(smem + L::SC_OFF);
  float* sVs = sKs + kBK;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int bz = blockIdx.z;          // batch * G + image
  const int b = bz / G;
  const int qs = q_self[bz];
  const int qu = q_upper[bz];
  constexpr int VEC = DH / 8;         // 16-byte vectors per head row

  // Q tile (rows past N are zero) and a zeroed output accumulator.
  for (int i = tid; i < kBQ * VEC; i += kThreads) {
    const int r = i / VEC, c = (i % VEC) * 8;
    const int n = q0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (n < N) val = load16(q + ((size_t)(bz * N + n) * H + h) * DH + c);
    *reinterpret_cast<uint4*>(sQ + r * L::LDH + c) = val;
  }
  for (int i = tid; i < kBQ * L::LDO; i += kThreads) sO[i] = 0.f;
  __syncthreads();

  // This warp's 16 query rows stay in registers as WMMA A fragments.
  QFrag qa[DH / 16];
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    wmma::load_matrix_sync(qa[kk], sQ + warp * 16 * L::LDH + kk * 16, L::LDH);

  float* sS_w = sS + warp * 16 * L::LDS;
  __nv_bfloat16* sP_w = sP + warp * 16 * L::LDP;
  float* sO_w = sO + warp * 16 * L::LDO;
  // softmax work split: two lanes per query row, 32 columns each
  const int rr = lane >> 1;
  const int half = lane & 1;
  float m_run = kNegInf;
  float l_run = 0.f;

  const int n_tiles = (n_keys + kBK - 1) / kBK;
  for (int t = 0; t < n_tiles; ++t) {
    const int j0 = t * kBK;
    __syncthreads();                  // every warp is done with the last tile
    // 8-bit rows: 16 codes per 16-byte load, k codes then v codes
    constexpr int VEC8 = DH / 16;
    for (int i = tid; i < kBK * VEC8; i += kThreads) {
      const int r = i / VEC8, c = (i % VEC8) * 16;
      const int j = j0 + r;
      uint4 kraw = make_uint4(0u, 0u, 0u, 0u);
      uint4 vraw = kraw;
      if (j < n_keys) {
        const uint8_t* row = kv8 + ((size_t)(b * H + h) * S + j) * (2 * DH);
        kraw = *reinterpret_cast<const uint4*>(row + c);
        vraw = *reinterpret_cast<const uint4*>(row + DH + c);
      }
      codes_to_bf16<QUANT>(kraw,
                           reinterpret_cast<uint4*>(sK + r * L::LDH + c));
      codes_to_bf16<QUANT>(vraw,
                           reinterpret_cast<uint4*>(sV + r * L::LDH + c));
    }
    if (tid < kBK) {
      const int j = j0 + tid;
      const float* sc = kv_scale + (size_t)(b * H + h) * 2 * S;
      sKs[tid] = j < n_keys ? sc[j] : 0.f;
      sVs[tid] = j < n_keys ? sc[S + j] : 0.f;
    }
    if (tid < kBK) {
      const int j = j0 + tid;
      int ok = j < n_keys;
      if (ok) ok = slot_allowed(labels[(size_t)b * S + j], qs, qu);
      if constexpr (EXT) {
        if (ok) ok = ext[(size_t)bz * S + j] == 0;
      }
      sAllow[tid] = ok;
    }
    __syncthreads();

    warp_scores<DH>(qa, sK, sS_w);
    __syncwarp();
    warp_online_softmax<DH, QUANT>(sS_w, sAllow, sKs, sVs, sP_w, sO_w, lane,
                                   scale, m_run, l_run);
    __syncwarp();
    warp_pv<DH>(sP_w, sV, sO_w);
  }
  __syncwarp();

  // normalise and write this lane's half row; a row with nothing attended
  // has l_run == 0 and a zero accumulator, so it writes 0
  const int n = q0 + warp * 16 + rr;
  if constexpr (STATS) {
    if (n < N && half == 0)
      lse[((size_t)bz * H + h) * N + n] =
          l_run > 0.f ? m_run + logf(l_run) : kEmptyLse;
  }
  if (n < N)
    warp_store_half_row<DH>(sO_w + rr * L::LDO + half * (DH / 2), l_run,
                            out + ((size_t)(bz * N + n) * H + h) * DH +
                                half * (DH / 2));
}

template <int DH, bool STATS, bool EXT, int QUANT>
cudaError_t launch(const void* q, const void* kv8, const void* kv_scale,
                   const void* labels, const void* q_self,
                   const void* q_upper, const void* ext, void* out,
                   void* lse, int batch, int G, int N, int H, int S,
                   int n_keys, cudaStream_t stream) {
  constexpr int smem = Layout<DH>::BYTES_Q8;
  auto kernel = attn_fwd_kernel<DH, STATS, EXT, QUANT>;
  // Above 48 KB a block's shared memory must be opted into. The attribute
  // belongs to the current device, so it is set on every launch (cheap, and
  // right whichever device and thread launches).
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + kBQ - 1) / kBQ, H, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const uint8_t*>(kv8),
      static_cast<const float*>(kv_scale),
      static_cast<const int32_t*>(labels),
      static_cast<const int32_t*>(q_self),
      static_cast<const int32_t*>(q_upper),
      static_cast<const uint8_t*>(ext), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), G, N, H, S, n_keys,
      1.0f / sqrtf(static_cast<float>(DH)));
  return cudaGetLastError();
}

// K6: two heads per block (see the header). The pair's two head regions
// (Q, K, V, S, P, O of Layout<DH>, up to its A_OFF) sit one after the
// other, and one allow vector after both.
template <int DH>
struct Layout2h {
  static constexpr int HEAD = Layout<DH>::A_OFF;
  static constexpr int A_OFF = 2 * HEAD;
  static constexpr int BYTES = A_OFF + kBK * 4;
  static_assert(HEAD % 128 == 0, "head regions must stay aligned");
};

template <int DH>
__global__ void __launch_bounds__(2 * kThreads)
ca_fwd_2h_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ kv,
                 const int32_t* __restrict__ labels,
                 __nv_bfloat16* __restrict__ out, int B, int N, int H, int S,
                 int n_keys, int layer, float scale) {
  using L = Layout<DH>;
  using L2 = Layout2h<DH>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int pair_tid = threadIdx.x;
  const int which = pair_tid / kThreads;   // head of the pair: 0 or 1
  const int tid = pair_tid % kThreads;     // thread within that head's warps
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y * 2 + which;
  const int b = blockIdx.z;
  unsigned char* base = smem + which * L2::HEAD;
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(base + L::Q_OFF);
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(base + L::K_OFF);
  __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(base + L::V_OFF);
  float* sS = reinterpret_cast<float*>(base + L::S_OFF);
  __nv_bfloat16* sP = reinterpret_cast<__nv_bfloat16*>(base + L::P_OFF);
  float* sO = reinterpret_cast<float*>(base + L::O_OFF);
  int* sAllow = reinterpret_cast<int*>(smem + L2::A_OFF);   // the pair's
  constexpr int VEC = DH / 8;
  // this head's rows of the layer: [L, B, H, S, 2*DH], offsets in size_t
  // (one layer of a 64-keyframe memory is 151 MB, the cache 1.8 GB)
  const __nv_bfloat16* kvh =
      kv + (((size_t)layer * B + b) * H + h) * (size_t)S * (2 * DH);

  for (int i = tid; i < kBQ * VEC; i += kThreads) {
    const int r = i / VEC, c = (i % VEC) * 8;
    const int n = q0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (n < N) val = load16(q + ((size_t)(b * N + n) * H + h) * DH + c);
    *reinterpret_cast<uint4*>(sQ + r * L::LDH + c) = val;
  }
  for (int i = tid; i < kBQ * L::LDO; i += kThreads) sO[i] = 0.f;
  __syncthreads();

  QFrag qa[DH / 16];
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    wmma::load_matrix_sync(qa[kk], sQ + warp * 16 * L::LDH + kk * 16, L::LDH);
  float* sS_w = sS + warp * 16 * L::LDS;
  __nv_bfloat16* sP_w = sP + warp * 16 * L::LDP;
  float* sO_w = sO + warp * 16 * L::LDO;
  float m_run = kNegInf;
  float l_run = 0.f;

  const int n_tiles = (n_keys + kBK - 1) / kBK;
  for (int t = 0; t < n_tiles; ++t) {
    const int j0 = t * kBK;
    __syncthreads();                  // both heads are done with the last tile
    for (int i = tid; i < kBK * VEC; i += kThreads) {
      const int r = i / VEC, c = (i % VEC) * 8;
      const int j = j0 + r;
      uint4 kval = make_uint4(0u, 0u, 0u, 0u);
      uint4 vval = kval;
      if (j < n_keys) {
        const __nv_bfloat16* row = kvh + (size_t)j * (2 * DH);
        kval = load16(row + c);
        vval = load16(row + DH + c);
      }
      *reinterpret_cast<uint4*>(sK + r * L::LDH + c) = kval;
      *reinterpret_cast<uint4*>(sV + r * L::LDH + c) = vval;
    }
    // the tile's labels, read once for both heads
    if (pair_tid < kBK) {
      const int j = j0 + pair_tid;
      sAllow[pair_tid] = j < n_keys && labels[(size_t)b * S + j] >= 0;
    }
    __syncthreads();

    warp_scores<DH>(qa, sK, sS_w);
    __syncwarp();
    warp_online_softmax<DH, 0>(sS_w, sAllow, nullptr, nullptr, sP_w, sO_w,
                               lane, scale, m_run, l_run);
    __syncwarp();
    warp_pv<DH>(sP_w, sV, sO_w);
  }
  __syncwarp();

  const int rr = lane >> 1;
  const int half = lane & 1;
  const int n = q0 + warp * 16 + rr;
  if (n < N)
    warp_store_half_row<DH>(sO_w + rr * L::LDO + half * (DH / 2), l_run,
                            out + ((size_t)(b * N + n) * H + h) * DH +
                                half * (DH / 2));
}

}  // namespace

extern "C" {

// Each returns 0 on success, else the cudaError_t of the refused launch.

// K2(d): the 8-bit cache read. kv8 [B, H, S, 2*Dh] codes (fmt 1 = int8,
// 2 = fp8 e4m3), kv_scale [B, H, 2, S] fp32; lse (fp32 [B, G, H, N])
// written when not null, ext (bool [B, G, S]) read when not null.
int must3r_ca_fwd_q8(const void* q, const void* kv8, const void* kv_scale,
                     const void* labels, const void* q_self,
                     const void* q_upper, const void* ext, void* out,
                     void* lse, int B, int G, int N, int H, int Dh, int S,
                     int kv_len, int fmt, void* stream) {
  if (Dh != 64 || (fmt != kQ8Int8 && fmt != kQ8Fp8))
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  const int bg = B * G;
#define MUST3R_CA_Q8(STATS, EXT, FMT)                                        \
  launch<64, STATS, EXT, FMT>(q, kv8, kv_scale, labels, q_self, q_upper,   \
                              ext, out, lse, bg, G, N, H, S, kv_len, st)
#define MUST3R_CA_Q8_FLAGS(FMT)                                              \
  (lse != nullptr                                                            \
       ? (ext != nullptr ? MUST3R_CA_Q8(true, true, FMT)                     \
                         : MUST3R_CA_Q8(true, false, FMT))                   \
       : (ext != nullptr ? MUST3R_CA_Q8(false, true, FMT)                    \
                         : MUST3R_CA_Q8(false, false, FMT)))
  const cudaError_t err = fmt == kQ8Int8 ? MUST3R_CA_Q8_FLAGS(kQ8Int8)
                                         : MUST3R_CA_Q8_FLAGS(kQ8Fp8);
#undef MUST3R_CA_Q8_FLAGS
#undef MUST3R_CA_Q8
  return static_cast<int>(err);
}

// K6: q / out [B, 1, N, H, Dh] bf16, kv the whole packed cache [L, B, H, S,
// 2*Dh] bf16 with the layer to read, labels [B, S] int32; H even.
int must3r_ca_fwd_2h_bf16(const void* q, const void* kv, const void* labels,
                          void* out, int B, int N, int H, int Dh, int S,
                          int kv_len, int layer, void* stream) {
  if (Dh != 64 || H % 2 != 0) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = Layout2h<64>::BYTES;
  auto kernel = ca_fwd_2h_kernel<64>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((N + kBQ - 1) / kBQ, H / 2, B);
  kernel<<<grid, 2 * kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(kv),
      static_cast<const int32_t*>(labels), static_cast<__nv_bfloat16*>(out),
      B, N, H, S, kv_len, layer, 1.0f / sqrtf(64.0f));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
