// The WMMA attention forward program of the PyTorch port (sm_90a), bf16
// out, fp32 softmax statistics. K1, the bf16 K2 and the 8-bit K2(d) moved
// to the TMA + wgmma program of attention_sm90.cu; one kernel stays here:
//
//   K6 ca_fwd_2h : two heads per block. Replaces _ca_pallas_2h of
//               scripts/bench_ca_kernel.py, the microbenchmark's variant of
//               _ca_pallas that runs a head pair over one shared label DMA:
//               one image of queries (q/out [B, 1, N, H, Dh], H even), the
//               whole bf16 cache [L, B, H, S, 2*Dh] with a layer index, and
//               the mask j < kv_len && label >= 0 alone (no q_self /
//               q_upper / ext, no LSE, no 8-bit cache).
//
// The block program: a block owns 64 query rows of one (batch, head). Its
// Q tile sits in shared memory; the block walks 64-key K/V tiles, computes
// S = Q K^T and O += P V with bf16 WMMA (mma.sync) at fp32 accumulation,
// and keeps the online-softmax row max and sum in fp32 registers. Each of
// the 4 warps owns 16 query rows end to end (scores, softmax, output), so
// only the shared K/V tile needs a block-wide barrier. K6 runs that program
// for a pair of heads in one block of 8 warps (4 per head, each head with
// its own Q/K/V/S/P/O regions, ~70 KB each) and computes each tile's allow
// vector from the labels once, into shared memory that both heads read:
// the TPU kernel's shared label DMA.
//
// What bounds it: ~4*Dh flops per (query, key) pair against 2*Dh*2 bytes of
// bf16 per key per 64 query rows: operations, on the tensor cores. This
// program is built for being right, not fast: scores and the output
// accumulator make a round trip through shared memory each tile (the WMMA
// fragment layout is opaque, so the per-row softmax rescale is done on a
// shared copy), and the tile loads do not overlap the products.
//
// Semantics that differ from the TPU kernel on purpose: a query row with no
// attended key (kv_len == 0, or every label masked) returns 0. The Pallas
// kernel returns NaN or a mean of V there; here the probability of a
// masked key is forced to 0.

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
  static_assert(DH % 16 == 0, "head dim must be a multiple of 16");
  static_assert(K_OFF % 128 == 0 && V_OFF % 128 == 0 && S_OFF % 128 == 0 &&
                P_OFF % 128 == 0 && O_OFF % 128 == 0 && A_OFF % 128 == 0,
                "shared-memory regions must stay aligned");
};

using QFrag =
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;

// The per-warp steps of one key tile. A warp owns 16
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
// sAllow[j] != 0 admits key j.
template <int DH>
__device__ __forceinline__ void warp_online_softmax(
    const float* sS_w, const int* sAllow, __nv_bfloat16* sP_w, float* sO_w,
    int lane, float scale, float& m_run, float& l_run) {
  using L = Layout<DH>;
  const int rr = lane >> 1;
  const int half = lane & 1;
  const float* srow = sS_w + rr * L::LDS + half * 32;
  const int* arow = sAllow + half * 32;
  float mx = kNegInf;
#pragma unroll
  for (int c = 0; c < 32; ++c)
    if (arow[c]) mx = fmaxf(mx, srow[c] * scale);
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  const float m_new = fmaxf(m_run, mx);
  const float corr = expf(m_run - m_new);
  float lsum = 0.f;
  __nv_bfloat16* prow = sP_w + rr * L::LDP + half * 32;
#pragma unroll
  for (int c = 0; c < 32; ++c) {
    const float p = arow[c] ? expf(srow[c] * scale - m_new) : 0.f;
    prow[c] = __float2bfloat16(p);
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
    warp_online_softmax<DH>(sS_w, sAllow, sP_w, sO_w, lane, scale, m_run,
                            l_run);
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

// Returns 0 on success, else the cudaError_t of the refused launch.
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
