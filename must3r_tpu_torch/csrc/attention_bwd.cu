// Flash-attention backward kernels of the memory cross-attention, for the
// PyTorch port's training path, hand-written for Hopper (sm_90a). bf16
// inputs, fp32 accumulation and statistics.
//
// Both recompute the probabilities from the forward's saved log-sum-exp
// instead of storing them, with the label predicate (and the token-dropout
// mask) rebuilt per key:
//
//   p  = allow(g, j) * exp(q.k_j * scale - lse)
//   ds = p * (dO.v_j - delta),   delta = rowsum(dO * O) (fp32, computed by
//                                the caller outside the kernels)
//   dq = sum_j ds * k_j * scale
//   dk_j = sum_(g, i) ds * q_i * scale,   dv_j = sum_(g, i) p * dO_i
//
//   K3 ca_bwd_dq    replaces must3r_tpu/ops/attention.py::_ca_bwd_dq_pallas.
//                   One block per (64 query rows, head, b*g); the key loop
//                   runs inside the block and dq stays in WMMA accumulators,
//                   so no atomics. Output dq [B, G, N, H, Dh] bf16.
//   K4 ca_bwd_dkv   replaces _ca_bwd_dkv_pallas. One block per (64 keys,
//                   head, b); it loops over every image g of the step and
//                   every 64-row query tile, so the G images that share the
//                   cache are summed inside one block with no atomics.
//                   Output dkv [B, H, S, 2*Dh] bf16 (dk | dv packed as the
//                   cache); a key at or past kv_len gets exactly 0.
// The fused K5 (dq and dK|dV in one launch) is the TMA + wgmma program of
// attention_bwd_sm90.cu.
//
// Inputs: q, dO [B, G, N, H, Dh]; kv [B, H, S, 2*Dh] (one cache layer);
// labels [B, S] int32; q_self, q_upper [B, G] int32; ext [B, G, S] bool or
// null; lse, delta [B, G, H, N] fp32. A row with lse = +1e30 (it attended
// nothing in the forward) gets p = 0 for every key.
//
// What bounds them: per (query, key) pair the backward does 4 products of
// Dh (S, dP, and dq or dk|dv) against the forward's 2, on the same bytes,
// so at the training shapes (768..1536 query rows against 768..3072 keys,
// Dh 64) they are compute bound on the tensor cores. This first version is
// the simple WMMA (mma.sync) design: every score and gradient tile makes a
// round trip through shared memory, and there is no cp.async/TMA
// pipelining and no wgmma. Those are the levers for a later pass.

#include <mma.h>

#include "common.cuh"

using namespace nvcuda;
using namespace must3r;

namespace {

template <int DH>
struct BwdLayout {
  static constexpr int LDH = DH + 8;   // bf16 q / dO / k / v rows
  static constexpr int LDS = 64 + 4;   // fp32 score rows (64 columns)
  static constexpr int LDP = 64 + 8;   // bf16 probability / ds rows
  static constexpr int A_OFF = 0;                       // 64 x LDH bf16
  static constexpr int B_OFF = A_OFF + 64 * LDH * 2;    // 64 x LDH bf16
  static constexpr int C_OFF = B_OFF + 64 * LDH * 2;    // 64 x LDH bf16
  static constexpr int D_OFF = C_OFF + 64 * LDH * 2;    // 64 x LDH bf16
  static constexpr int S_OFF = D_OFF + 64 * LDH * 2;    // 64 x LDS fp32
  static constexpr int T_OFF = S_OFF + 64 * LDS * 4;    // 64 x LDS fp32
  static constexpr int P_OFF = T_OFF + 64 * LDS * 4;    // 64 x LDP bf16
  static constexpr int G_OFF = P_OFF + 64 * LDP * 2;    // 64 x LDP bf16
  static constexpr int R_OFF = G_OFF + 64 * LDP * 2;    // 3 x 64 words
  static constexpr int BYTES = R_OFF + 3 * 64 * 4;
  static_assert(DH == 64, "the backward kernels are written for Dh = 64");
  static_assert(B_OFF % 128 == 0 && C_OFF % 128 == 0 && D_OFF % 128 == 0 &&
                S_OFF % 128 == 0 && T_OFF % 128 == 0 && P_OFF % 128 == 0 &&
                G_OFF % 128 == 0 && R_OFF % 128 == 0,
                "shared-memory regions must stay aligned");
};

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                             wmma::row_major>;
using FragBr = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                              wmma::row_major>;
using FragBc = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                              wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// Copy 64 rows of a [.., rows, H, DH] tensor's head h into shared memory
// (row r <- src row r0 + r; rows at or past n_rows are zero).
template <int DH>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int r0,
                                          int n_rows, int H, int h) {
  constexpr int VEC = DH / 8;
  constexpr int LDH = BwdLayout<DH>::LDH;
  for (int i = threadIdx.x; i < 64 * VEC; i += kThreads) {
    const int r = i / VEC, c = (i % VEC) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < n_rows) val = load16(src + ((size_t)(r0 + r) * H + h) * DH + c);
    store16(dst + r * LDH + c, val);
  }
}

// Copy 64 keys of one packed cache layer row block [S, 2*DH] (already
// offset to (b, h)) into k and v tiles; keys at or past n_keys are zero.
template <int DH>
__device__ __forceinline__ void load_kv(__nv_bfloat16* sk, __nv_bfloat16* sv,
                                        const __nv_bfloat16* kv_bh, int j0,
                                        int n_keys) {
  constexpr int VEC = DH / 8;
  constexpr int LDH = BwdLayout<DH>::LDH;
  for (int i = threadIdx.x; i < 64 * VEC; i += kThreads) {
    const int r = i / VEC, c = (i % VEC) * 8;
    uint4 kval = make_uint4(0u, 0u, 0u, 0u), vval = kval;
    if (j0 + r < n_keys) {
      const __nv_bfloat16* row = kv_bh + (size_t)(j0 + r) * (2 * DH);
      kval = load16(row + c);
      vval = load16(row + DH + c);
    }
    store16(sk + r * LDH + c, kval);
    store16(sv + r * LDH + c, vval);
  }
}

// out(16 x 64) = A_w(16 x DH, register fragments) . X^T where X is 64 rows
// of DH in shared memory (row-major [64][LDH]); stored fp32 to dst (ld LDS).
template <int DH>
__device__ __forceinline__ void rows_times_tile_t(const FragA (&a)[DH / 16],
                                                  const __nv_bfloat16* x,
                                                  float* dst) {
  constexpr int LDH = BwdLayout<DH>::LDH;
  constexpr int LDS = BwdLayout<DH>::LDS;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      FragBc bx;
      wmma::load_matrix_sync(bx, x + nt * 16 * LDH + kk * 16, LDH);
      wmma::mma_sync(acc, a[kk], bx, acc);
    }
    wmma::store_matrix_sync(dst + nt * 16, acc, LDS, wmma::mem_row_major);
  }
}

// acc(16 x DH) += A(16 x 64 bf16 at a, ld LDP, row-major) . Y(64 x DH at y,
// row-major [64][LDH]).
template <int DH>
__device__ __forceinline__ void accumulate(FragC (&acc)[DH / 16],
                                           const __nv_bfloat16* a,
                                           const __nv_bfloat16* y) {
  constexpr int LDH = BwdLayout<DH>::LDH;
  constexpr int LDP = BwdLayout<DH>::LDP;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    FragA fa;
    wmma::load_matrix_sync(fa, a + kk * 16, LDP);
#pragma unroll
    for (int nt = 0; nt < DH / 16; ++nt) {
      FragBr fb;
      wmma::load_matrix_sync(fb, y + kk * 16 * LDH + nt * 16, LDH);
      wmma::mma_sync(acc[nt], fa, fb, acc[nt]);
    }
  }
}

// Write a warp's 16 x DH accumulator (through its fp32 scratch tile) times
// `mul` as bf16 rows: row r -> dst + r * row_stride, for rows r < n_valid.
template <int DH>
__device__ __forceinline__ void write_rows(const FragC (&acc)[DH / 16],
                                           float* scratch, float mul,
                                           __nv_bfloat16* dst,
                                           size_t row_stride, int n_valid) {
  constexpr int LDS = BwdLayout<DH>::LDS;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int nt = 0; nt < DH / 16; ++nt)
    wmma::store_matrix_sync(scratch + nt * 16, acc[nt], LDS,
                            wmma::mem_row_major);
  __syncwarp();
  const int rr = lane >> 1, half = lane & 1;
  if (rr < n_valid) {
    const float* src = scratch + rr * LDS + half * (DH / 2);
    __nv_bfloat16* out = dst + rr * row_stride + half * (DH / 2);
#pragma unroll
    for (int c = 0; c < DH / 2; c += 8) {
      __align__(16) __nv_bfloat16 tmp[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) tmp[e] = __float2bfloat16(src[c + e] * mul);
      store16(out + c, *reinterpret_cast<const uint4*>(tmp));
    }
  }
  __syncwarp();
}

// ---------------------------------------------------------------------------
// K3: dq
// ---------------------------------------------------------------------------

template <int DH, bool EXT>
__global__ void __launch_bounds__(kThreads)
ca_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ kv,
                 const int32_t* __restrict__ labels,
                 const int32_t* __restrict__ q_self,
                 const int32_t* __restrict__ q_upper,
                 const uint8_t* __restrict__ ext,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta,
                 const __nv_bfloat16* __restrict__ dout,
                 __nv_bfloat16* __restrict__ dq,
                 int G, int N, int H, int S, int kv_len, float scale) {
  using L = BwdLayout<DH>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem + L::A_OFF);
  __nv_bfloat16* sDO = reinterpret_cast<__nv_bfloat16*>(smem + L::B_OFF);
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem + L::C_OFF);
  __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(smem + L::D_OFF);
  float* sS = reinterpret_cast<float*>(smem + L::S_OFF);
  float* sDP = reinterpret_cast<float*>(smem + L::T_OFF);
  __nv_bfloat16* sDS = reinterpret_cast<__nv_bfloat16*>(smem + L::P_OFF);
  int* sAllow = reinterpret_cast<int*>(smem + L::R_OFF);
  float* sLse = reinterpret_cast<float*>(smem + L::R_OFF + 64 * 4);
  float* sDelta = reinterpret_cast<float*>(smem + L::R_OFF + 128 * 4);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int bz = blockIdx.z;            // b * G + g
  const int b = bz / G;
  const int qs = q_self[bz], qu = q_upper[bz];
  const __nv_bfloat16* q_bz = q + (size_t)bz * N * H * DH;
  const __nv_bfloat16* do_bz = dout + (size_t)bz * N * H * DH;
  const __nv_bfloat16* kv_bh = kv + (size_t)(b * H + h) * S * (2 * DH);

  load_rows<DH>(sQ, q_bz, q0, N, H, h);
  load_rows<DH>(sDO, do_bz, q0, N, H, h);
  if (tid < kBQ) {
    const int n = q0 + tid;
    const size_t row = ((size_t)bz * H + h) * N + n;
    sLse[tid] = n < N ? lse[row] : kEmptyLse;
    sDelta[tid] = n < N ? delta[row] : 0.f;
  }
  __syncthreads();

  FragA qa[DH / 16], da[DH / 16];
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    wmma::load_matrix_sync(qa[kk], sQ + warp * 16 * L::LDH + kk * 16, L::LDH);
    wmma::load_matrix_sync(da[kk], sDO + warp * 16 * L::LDH + kk * 16,
                           L::LDH);
  }
  FragC acc[DH / 16];
#pragma unroll
  for (int nt = 0; nt < DH / 16; ++nt) wmma::fill_fragment(acc[nt], 0.f);

  float* sS_w = sS + warp * 16 * L::LDS;
  float* sDP_w = sDP + warp * 16 * L::LDS;
  __nv_bfloat16* sDS_w = sDS + warp * 16 * L::LDP;
  const int rr = lane >> 1, half = lane & 1;
  const float lse_r = sLse[warp * 16 + rr];
  const float dlt_r = sDelta[warp * 16 + rr];

  const int n_tiles = (kv_len + kBK - 1) / kBK;
  for (int t = 0; t < n_tiles; ++t) {
    const int j0 = t * kBK;
    __syncthreads();                    // every warp is done with the tile
    load_kv<DH>(sK, sV, kv_bh, j0, kv_len);
    if (tid < kBK) {
      const int j = j0 + tid;
      bool ok = j < kv_len && slot_allowed(labels[(size_t)b * S + j], qs, qu);
      if constexpr (EXT) {
        if (ok) ok = ext[(size_t)bz * S + j] == 0;
      }
      sAllow[tid] = ok;
    }
    __syncthreads();

    rows_times_tile_t<DH>(qa, sK, sS_w);     // S  = Q K^T
    rows_times_tile_t<DH>(da, sV, sDP_w);    // dP = dO V^T
    __syncwarp();
    {
      const float* srow = sS_w + rr * L::LDS + half * 32;
      const float* prow = sDP_w + rr * L::LDS + half * 32;
      const int* arow = sAllow + half * 32;
      __nv_bfloat16* drow = sDS_w + rr * L::LDP + half * 32;
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        const float p = arow[c] ? expf(srow[c] * scale - lse_r) : 0.f;
        drow[c] = __float2bfloat16(p * (prow[c] - dlt_r));
      }
    }
    __syncwarp();
    accumulate<DH>(acc, sDS_w, sK);          // dq += dS K
  }

  const int n_valid = min(16, N - (q0 + warp * 16));
  write_rows<DH>(acc, sS_w, scale,
                 dq + (((size_t)bz * N + q0 + warp * 16) * H + h) * DH,
                 (size_t)H * DH, n_valid);
}

// ---------------------------------------------------------------------------
// K4: dk | dv
// ---------------------------------------------------------------------------

template <int DH, bool EXT>
__global__ void __launch_bounds__(kThreads)
ca_bwd_kv_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ kv,
                 const int32_t* __restrict__ labels,
                 const int32_t* __restrict__ q_self,
                 const int32_t* __restrict__ q_upper,
                 const uint8_t* __restrict__ ext,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta,
                 const __nv_bfloat16* __restrict__ dout,
                 __nv_bfloat16* __restrict__ dkv,
                 int G, int N, int H, int S, int kv_len, float scale) {
  using L = BwdLayout<DH>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem + L::A_OFF);
  __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(smem + L::B_OFF);
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem + L::C_OFF);
  __nv_bfloat16* sDO = reinterpret_cast<__nv_bfloat16*>(smem + L::D_OFF);
  float* sS = reinterpret_cast<float*>(smem + L::S_OFF);
  float* sDP = reinterpret_cast<float*>(smem + L::T_OFF);
  __nv_bfloat16* sP = reinterpret_cast<__nv_bfloat16*>(smem + L::P_OFF);
  __nv_bfloat16* sDS = reinterpret_cast<__nv_bfloat16*>(smem + L::G_OFF);
  int* sAllow = reinterpret_cast<int*>(smem + L::R_OFF);
  float* sLse = reinterpret_cast<float*>(smem + L::R_OFF + 64 * 4);
  float* sDelta = reinterpret_cast<float*>(smem + L::R_OFF + 128 * 4);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int j0 = blockIdx.x * kBK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const __nv_bfloat16* kv_bh = kv + (size_t)(b * H + h) * S * (2 * DH);
  __nv_bfloat16* dkv_bh = dkv + (size_t)(b * H + h) * S * (2 * DH);
  constexpr int VEC2 = 2 * DH / 8;

  if (j0 >= kv_len) {                   // a tile of dead keys: zeros
    for (int i = tid; i < kBK * VEC2; i += kThreads) {
      const int r = i / VEC2, c = (i % VEC2) * 8;
      if (j0 + r < S)
        store16(dkv_bh + (size_t)(j0 + r) * (2 * DH) + c,
                make_uint4(0u, 0u, 0u, 0u));
    }
    return;
  }

  load_kv<DH>(sK, sV, kv_bh, j0, kv_len);
  __syncthreads();
  FragA ka[DH / 16], va[DH / 16];
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    wmma::load_matrix_sync(ka[kk], sK + warp * 16 * L::LDH + kk * 16, L::LDH);
    wmma::load_matrix_sync(va[kk], sV + warp * 16 * L::LDH + kk * 16, L::LDH);
  }
  FragC dk[DH / 16], dv[DH / 16];
#pragma unroll
  for (int nt = 0; nt < DH / 16; ++nt) {
    wmma::fill_fragment(dk[nt], 0.f);
    wmma::fill_fragment(dv[nt], 0.f);
  }

  float* sS_w = sS + warp * 16 * L::LDS;     // S^T  (16 keys x 64 rows)
  float* sDP_w = sDP + warp * 16 * L::LDS;   // dP^T
  __nv_bfloat16* sP_w = sP + warp * 16 * L::LDP;
  __nv_bfloat16* sDS_w = sDS + warp * 16 * L::LDP;
  const int rr = lane >> 1, half = lane & 1;
  const int key_w = warp * 16 + rr;          // this lane's key in the tile
  const int n_qt = (N + kBQ - 1) / kBQ;

  for (int g = 0; g < G; ++g) {
    const int bz = b * G + g;
    const int qs = q_self[bz], qu = q_upper[bz];
    const __nv_bfloat16* q_bz = q + (size_t)bz * N * H * DH;
    const __nv_bfloat16* do_bz = dout + (size_t)bz * N * H * DH;
    for (int qt = 0; qt < n_qt; ++qt) {
      const int i0 = qt * kBQ;
      __syncthreads();                  // every warp is done with the tiles
      load_rows<DH>(sQ, q_bz, i0, N, H, h);
      load_rows<DH>(sDO, do_bz, i0, N, H, h);
      if (tid < kBK) {
        const int j = j0 + tid;
        bool ok = j < kv_len &&
                  slot_allowed(labels[(size_t)b * S + j], qs, qu);
        if constexpr (EXT) {
          if (ok) ok = ext[(size_t)bz * S + j] == 0;
        }
        sAllow[tid] = ok;
        const int n = i0 + tid;
        const size_t row = ((size_t)bz * H + h) * N + n;
        sLse[tid] = n < N ? lse[row] : kEmptyLse;
        sDelta[tid] = n < N ? delta[row] : 0.f;
      }
      __syncthreads();

      rows_times_tile_t<DH>(ka, sQ, sS_w);      // S^T  = K Q^T
      rows_times_tile_t<DH>(va, sDO, sDP_w);    // dP^T = V dO^T
      __syncwarp();
      {
        const bool allow = sAllow[key_w] != 0;
        const float* srow = sS_w + rr * L::LDS + half * 32;
        const float* prow = sDP_w + rr * L::LDS + half * 32;
        const float* lrow = sLse + half * 32;
        const float* drow_d = sDelta + half * 32;
        __nv_bfloat16* pout = sP_w + rr * L::LDP + half * 32;
        __nv_bfloat16* dsout = sDS_w + rr * L::LDP + half * 32;
#pragma unroll
        for (int c = 0; c < 32; ++c) {
          const float p = allow ? expf(srow[c] * scale - lrow[c]) : 0.f;
          pout[c] = __float2bfloat16(p);
          dsout[c] = __float2bfloat16(p * (prow[c] - drow_d[c]));
        }
      }
      __syncwarp();
      accumulate<DH>(dv, sP_w, sDO);            // dv += P^T dO
      accumulate<DH>(dk, sDS_w, sQ);            // dk += dS^T Q
    }
  }

  // dk * scale into the first DH features of each key row, dv into the rest
  const int n_valid = min(16, S - (j0 + warp * 16));
  __nv_bfloat16* rows = dkv_bh + (size_t)(j0 + warp * 16) * (2 * DH);
  __syncwarp();
  write_rows<DH>(dk, sS_w, scale, rows, 2 * DH, n_valid);
  write_rows<DH>(dv, sS_w, 1.f, rows + DH, 2 * DH, n_valid);
}

template <int DH>
cudaError_t set_smem(const void* kernel) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              BwdLayout<DH>::BYTES);
}

}  // namespace

extern "C" {

// Each returns 0 on success, else the cudaError_t of the refused launch.
// ext may be null (no token dropout).

int must3r_ca_bwd_dq_bf16(const void* q, const void* kv, const void* labels,
                          const void* q_self, const void* q_upper,
                          const void* ext, const void* lse, const void* delta,
                          const void* dout, void* dq, int B, int G, int N,
                          int H, int Dh, int S, int kv_len, void* stream) {
  if (Dh != 64) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = ext != nullptr ? &ca_bwd_dq_kernel<64, true>
                               : &ca_bwd_dq_kernel<64, false>;
  cudaError_t err = set_smem<64>(reinterpret_cast<const void*>(kernel));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((N + kBQ - 1) / kBQ, H, B * G);
  kernel<<<grid, kThreads, BwdLayout<64>::BYTES,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(kv),
      static_cast<const int32_t*>(labels),
      static_cast<const int32_t*>(q_self),
      static_cast<const int32_t*>(q_upper),
      static_cast<const uint8_t*>(ext), static_cast<const float*>(lse),
      static_cast<const float*>(delta),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<__nv_bfloat16*>(dq), G, N, H, S, kv_len,
      1.0f / sqrtf(static_cast<float>(Dh)));
  return static_cast<int>(cudaGetLastError());
}

// K4: dk | dv [B, H, S, 2*Dh] bf16 of one cache layer.
int must3r_ca_bwd_dkv_bf16(const void* q, const void* kv, const void* labels,
                           const void* q_self, const void* q_upper,
                           const void* ext, const void* lse,
                           const void* delta, const void* dout, void* dkv,
                           int B, int G, int N, int H, int Dh, int S,
                           int kv_len, void* stream) {
  if (Dh != 64) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = ext != nullptr ? &ca_bwd_kv_kernel<64, true>
                               : &ca_bwd_kv_kernel<64, false>;
  cudaError_t err = set_smem<64>(reinterpret_cast<const void*>(kernel));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((S + kBK - 1) / kBK, H, B);
  kernel<<<grid, kThreads, BwdLayout<64>::BYTES,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(kv),
      static_cast<const int32_t*>(labels),
      static_cast<const int32_t*>(q_self),
      static_cast<const int32_t*>(q_upper),
      static_cast<const uint8_t*>(ext), static_cast<const float*>(lse),
      static_cast<const float*>(delta),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<__nv_bfloat16*>(dkv), G, N, H, S, kv_len,
      1.0f / sqrtf(static_cast<float>(Dh)));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
