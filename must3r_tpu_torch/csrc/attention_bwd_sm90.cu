// K5 ca_bwd_fused, the fused backward of the memory cross-attention, as a
// TMA + wgmma program for Hopper (sm_90a): dQ and dK|dV in one launch.
// Replaces must3r_tpu/ops/attention.py::_ca_bwd_fused_pallas. bf16 inputs,
// fp32 accumulation and statistics, head dim 64.
//
//   p    = allow(g, j) * exp(q.k_j * scale - lse)
//   ds   = p * (dO.v_j - delta),   delta = rowsum(dO * O) (the caller's)
//   dq   = sum_j ds * k_j * scale
//   dk_j = sum_(g, i) ds * q_i * scale,   dv_j = sum_(g, i) p * dO_i
//
// Inputs: q, dO [B, G, N, H, Dh]; kv [B, H, S, 2*Dh] (one layer); labels
// [B, S] int32; q_self, q_upper [B, G] int32; ext [B, G, S] bool or null;
// lse, delta [B, G, H, N] fp32. A row with lse = +1e30 (it attended nothing
// in the forward) gets p = 0 for every key. Outputs: dkv [B, H, S, 2*Dh]
// bf16, exactly 0 at or past kv_len (every row is written: the wrapper
// allocates it uninitialised); dq summed into the wrapper's zeroed fp32
// [B, G, N, H, Dh] buffer (the sums of different key blocks land in no
// fixed order, so dq is not bitwise reproducible).
//
// What bounds it: per (query, key) pair 5 products of Dh (S, dP, dV, dK,
// dQ) against the forward's 2, on the same bytes, plus the dQ adds:
// operations on the bf16 tensor cores at the training shapes, with the dQ
// adds (kv_len / 128 x G * N * Dh * 4 bytes a head) the largest memory
// traffic.
//
// The block program (FlashAttention-3's backward, cut to this CA). A block
// owns 128 keys of one (b, head): two consumer warpgroups of 64 keys each,
// and one producer warpgroup whose first warp loads. 64-key blocks (one
// consumer warpgroup) took the same time at the training shapes and moved
// twice the dQ bytes (PERF.md section 6).
//   - K and V of the block's keys are loaded once by TMA (the layer's map
//     has the key extent kv_len, so keys past it arrive as zeros) and stay
//     in shared memory; dK and dV stay in fp32 registers for the whole loop.
//   - The producer walks every image g of the step and every 64-row query
//     tile of that image through a ring of kStages stages: Q and dO tiles by
//     TMA (4-D maps (Dh, H, N, B*G): rows past N are zero-filled), the rows'
//     lse (times log2 e; +1e30 past N) and delta by plain loads, and the
//     block's allow mask for image g (labels, q_self / q_upper, ext), so a
//     step whose image attends none of the block's keys is skipped. All 32
//     lanes arrive on the stage's "full" barrier (lane 0 with the TMA bytes).
//   - A consumer warpgroup computes, per step: S^T = K Q^T and dP^T = V dO^T
//     (wgmma, both operands K-major from shared memory, 128-byte swizzle);
//     P^T and dS^T in registers (a key row's allow bit, ex2 with the scale
//     and lse folded into one FFMA); dV += P^T dO and dK += dS^T Q with A
//     from registers (the m64n64 accumulator layout is the next product's
//     A layout) and B MN-major; dS^T to shared memory (swizzled), then
//     dQ_tile = dS K with A and B both MN-major from shared memory. The
//     stage is then released, and the tile's dQ (times scale) goes through
//     a double-buffered shared tile (two 32-column halves, 128-byte
//     swizzle) to one TMA reduce-add per half (cp.reduce.async.bulk.tensor
//     .add.f32) into the fp32 buffer; rows past N are dropped by the map.
//     The second warpgroup adds its partial to the first's in shared
//     memory, so one reduce-add serves 128 keys.
//   - After the loop dK * scale and dV are written as bf16 rows of dkv.
//   - A block whose keys all lie at or past kv_len writes zeros and exits.
//
// Shared memory: 32 KB of K and V, 3 stages of 16 KB (Q, dO) + 512 bytes,
// 16 KB of dS^T, 32 KB of dQ buffers, on a 1 KB alignment. Registers: one
// block of 384 threads an SM, 168 a thread by the launch bound, within
// which ptxas allocates every warp's code (40 bytes spill); -Xptxas -v in
// build/kernels/libattention_bwd_sm90_*.log. setmaxnreg (24 for the
// producer, 240 or 200 for the consumers) left the consumers' allocation
// and the time as they are (tools/ablate_kernels.py, PERF.md section 6),
// so the kernel does without it.

#include "sm90.cuh"

using namespace must3r;
using namespace must3r::sm90;

namespace {

constexpr int kDh = 64;
constexpr int kRows = 64;                  // query rows per step
constexpr int kStages = 3;
constexpr int kWG = 128;
constexpr int kTileBytes = 64 * kDh * 2;   // one 64 x 64 bf16 tile
constexpr int kNW = 2;                     // consumer warpgroups, 64 keys each
constexpr int kKeys = kNW * 64;            // keys per block
constexpr int kThreads = (kNW + 1) * kWG;
// One block an SM: two would leave 85 registers a thread, and dK, dV, S^T
// and dP^T alone take 128.

struct Smem {
  alignas(1024) __nv_bfloat16 k[kNW][64 * kDh];
  alignas(1024) __nv_bfloat16 v[kNW][64 * kDh];
  alignas(1024) __nv_bfloat16 q[kStages][kRows * kDh];
  alignas(1024) __nv_bfloat16 dout[kStages][kRows * kDh];
  alignas(1024) __nv_bfloat16 dst[kNW][64 * kRows];  // dS^T, keys x rows
  alignas(1024) float dq[2][2][kRows * 32];           // [buffer][half]
  alignas(16) float lse2[kStages][kRows];
  alignas(16) float delta[kStages][kRows];
  uint32_t mask[kStages][2 * kNW];          // bit c of word w: key 32w + c
  uint64_t full[kStages];
  uint64_t empty[kStages];
  uint64_t kv_full;
};

// Named barriers: 1 + wg for one consumer warpgroup, kAllConsumers for all.
constexpr int kAllConsumers = 3;

template <bool EXT>
__global__ void __launch_bounds__(kThreads, 1)
ca_bwd_fused_sm90(const __grid_constant__ CUtensorMap qmap,
                  const __grid_constant__ CUtensorMap domap,
                  const __grid_constant__ CUtensorMap kvmap,
                  const __grid_constant__ CUtensorMap dqmap,
                  const int32_t* __restrict__ labels,
                  const int32_t* __restrict__ q_self,
                  const int32_t* __restrict__ q_upper,
                  const uint8_t* __restrict__ ext,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta,
                  __nv_bfloat16* __restrict__ dkv, int G, int N, int H, int S,
                  int kv_len, float scale) {
  extern __shared__ uint8_t smem_raw[];
  const int j0 = blockIdx.x * kKeys;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  __nv_bfloat16* dkv_bh = dkv + (size_t)(b * H + h) * S * (2 * kDh);

  if (j0 >= kv_len) {                       // keys past kv_len: zeros
    for (int i = threadIdx.x; i < kKeys * 16; i += kThreads) {
      const int r = i / 16, c = (i % 16) * 8;
      if (j0 + r < S)
        store16(dkv_bh + (size_t)(j0 + r) * (2 * kDh) + c,
                make_uint4(0u, 0u, 0u, 0u));
    }
    return;
  }

  const uint32_t pad = (1024u - (smem_u32(smem_raw) & 1023u)) & 1023u;
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw + pad);
  const int wg = threadIdx.x / kWG;
  const int n_qt = (N + kRows - 1) / kRows;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 32);
      mbar_init(&sm.empty[s], kNW * kWG);
    }
    mbar_init(&sm.kv_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == kNW) {
    // ---------------- producer warpgroup: one warp loads ----------------
    const int warp = (threadIdx.x % kWG) / 32;
    const int lane = threadIdx.x % 32;
    if (warp != 0) return;
    if (lane == 0) {
      mbar_expect_tx(&sm.kv_full, kNW * 2 * kTileBytes);
#pragma unroll
      for (int w = 0; w < kNW; ++w) {
        tma_load_4d(sm.k[w], &kvmap, &sm.kv_full, 0, j0 + 64 * w, h, b);
        tma_load_4d(sm.v[w], &kvmap, &sm.kv_full, kDh, j0 + 64 * w, h, b);
      }
    }
    int stage = 0;
    uint32_t phase = 0;
    for (int g = 0; g < G; ++g) {
      const int bz = b * G + g;
      const int qs = q_self[bz], qu = q_upper[bz];
      uint32_t words[2 * kNW];
      uint32_t any = 0;
#pragma unroll
      for (int w = 0; w < 2 * kNW; ++w) {
        const int j = j0 + 32 * w + lane;
        bool a = j < kv_len && slot_allowed(labels[(size_t)b * S + j], qs, qu);
        if (EXT && a) a = ext[(size_t)bz * S + j] == 0;
        words[w] = __ballot_sync(0xffffffffu, a);
        any |= words[w];
      }
      const float* lse_r = lse + ((size_t)bz * H + h) * N;
      const float* dlt_r = delta + ((size_t)bz * H + h) * N;
      for (int qt = 0; qt < n_qt; ++qt) {
        const int n0 = qt * kRows;
        float l2[2], dl[2];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int n = n0 + 32 * half + lane;
          l2[half] = n < N ? lse_r[n] * kLog2e : kEmptyLse * kLog2e;
          dl[half] = n < N ? dlt_r[n] : 0.f;
        }
        mbar_wait(&sm.empty[stage], phase ^ 1);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          sm.lse2[stage][32 * half + lane] = l2[half];
          sm.delta[stage][32 * half + lane] = dl[half];
        }
        if (lane == 0) {
#pragma unroll
          for (int w = 0; w < 2 * kNW; ++w) sm.mask[stage][w] = words[w];
          if (any != 0) {
            mbar_expect_tx(&sm.full[stage], 2 * kTileBytes);
            tma_load_4d(sm.q[stage], &qmap, &sm.full[stage], 0, h, n0, bz);
            tma_load_4d(sm.dout[stage], &domap, &sm.full[stage], 0, h, n0,
                        bz);
          } else {
            mbar_arrive(&sm.full[stage]);
          }
        } else {
          mbar_arrive(&sm.full[stage]);
        }
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // ---------------- consumer warpgroup wg: 64 keys ----------------
  const int t = threadIdx.x % kWG;
  const int warp = t / 32;
  const int lane = t % 32;
  const int quad = lane % 4;
  const bool issuer = threadIdx.x == 0;     // issues the dQ reduce-adds
  const float sl2 = scale * kLog2e;
  // this thread's two key rows (i = 0, 1) within the block: their mask word
  // and bit
  int kword[2], kbit[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kl = 64 * wg + 16 * warp + lane / 4 + 8 * i;
    kword[i] = kl >> 5;
    kbit[i] = kl & 31;
  }

  float dk[32], dv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
  mbar_wait(&sm.kv_full, 0);
  const uint64_t kd = sw128_desc(sm.k[wg]);
  const uint64_t vd = sw128_desc(sm.v[wg]);
  const uint64_t dsd = sw128_desc(sm.dst[wg]);
  uint8_t* dst_tile = reinterpret_cast<uint8_t*>(sm.dst[wg]);

  int stage = 0, it = 0;
  uint32_t phase = 0;
  for (int g = 0; g < G; ++g) {
    for (int qt = 0; qt < n_qt; ++qt) {
      mbar_wait(&sm.full[stage], phase);
      uint32_t any = 0;
#pragma unroll
      for (int w = 0; w < 2 * kNW; ++w) any |= sm.mask[stage][w];
      if (any == 0) {                       // uniform across the block
        mbar_arrive(&sm.empty[stage]);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
        continue;
      }
      bool allow[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        allow[i] = (sm.mask[stage][kword[i]] >> kbit[i]) & 1;
      const uint64_t qd = sw128_desc(sm.q[stage]);
      const uint64_t dod = sw128_desc(sm.dout[stage]);

      // S^T = K Q^T and dP^T = V dO^T
      float s[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kDh / 16; ++kk)
        wgmma_ss(s, kd + 2 * kk, qd + 2 * kk, kk > 0);
#pragma unroll
      for (int kk = 0; kk < kDh / 16; ++kk)
        wgmma_ss(dp, vd + 2 * kk, dod + 2 * kk, kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(s);
      reg_fence(dp);

      // P^T and dS^T: register 4j + 2i + e holds key row i, query column
      // 8j + 2 * quad + e
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(
            &sm.lse2[stage][8 * j + 2 * quad]);
        const float2 dl = *reinterpret_cast<const float2*>(
            &sm.delta[stage][8 * j + 2 * quad]);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = 4 * j + 2 * i;
          const float p0 = allow[i] ? ex2(fmaf(s[r], sl2, -l2.x)) : 0.f;
          const float p1 = allow[i] ? ex2(fmaf(s[r + 1], sl2, -l2.y)) : 0.f;
          s[r] = p0;
          s[r + 1] = p1;
          dp[r] = p0 * (dp[r] - dl.x);
          dp[r + 1] = p1 * (dp[r + 1] - dl.y);
        }
      }
      uint32_t pa[4][4], da[4][4];
      acc_to_a(s, pa);
      acc_to_a(dp, da);
      // dS^T into shared memory (rows = keys, 64 query columns, swizzled):
      // pair x of the A fragments is register pair (j, i) = (x / 2, x % 2)
#pragma unroll
      for (int x = 0; x < 16; ++x) {
        const int row = 16 * warp + lane / 4 + 8 * (x & 1);
        *reinterpret_cast<uint32_t*>(dst_tile + sw128_offset(row, x >> 1) +
                                     4 * quad) = da[x / 4][x % 4];
      }
      fence_proxy_async();
      named_sync(1 + wg, kWG);

      // dV += P^T dO, dK += dS^T Q, dQ_tile = dS K
      float dq[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) dq[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk)
        wgmma_rs(dv, pa[kk], dod + 128 * kk);
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk)
        wgmma_rs(dk, da[kk], qd + 128 * kk);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<1, 1>(dq, dsd + 128 * kk, kd + 128 * kk, kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(dv);
      reg_fence(dk);
      reg_fence(dq);
      reg_fence(pa);
      reg_fence(da);
      mbar_arrive(&sm.empty[stage]);        // Q and dO are no longer read

      // the tile's dQ (times scale) into the fp32 buffer: register
      // 4j + 2i + e holds row 16 * warp + lane / 4 + 8i, feature
      // 8j + 2 * quad + e; the buffer holds two 32-feature halves of 128-byte
      // rows, swizzled as the map's box
      const int buf = it & 1;
      if (issuer) tma_wait_read<1>();       // the add of two steps ago read it
      named_sync(kAllConsumers, kNW * kWG);
#pragma unroll
      for (int wr = 0; wr < kNW; ++wr) {
        if (wr == wg) {
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const int row = 16 * warp + lane / 4 + 8 * i;
              const int chunk = 2 * (j & 3) + (quad >> 1);
              float2* p = reinterpret_cast<float2*>(
                  reinterpret_cast<uint8_t*>(sm.dq[buf][j >> 2]) +
                  sw128_offset(row, chunk) + 8 * (quad & 1));
              float2 val = make_float2(dq[4 * j + 2 * i] * scale,
                                       dq[4 * j + 2 * i + 1] * scale);
              if (wr > 0) {
                const float2 prev = *p;
                val.x += prev.x;
                val.y += prev.y;
              }
              *p = val;
            }
        }
        named_sync(kAllConsumers, kNW * kWG);
      }
      fence_proxy_async();
      named_sync(kAllConsumers, kNW * kWG);
      if (issuer) {
        const int bz = b * G + g;
        tma_reduce_add_4d(&dqmap, sm.dq[buf][0], 0, h, qt * kRows, bz);
        tma_reduce_add_4d(&dqmap, sm.dq[buf][1], 32, h, qt * kRows, bz);
        tma_commit();
      }
      ++it;
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
  if (issuer) tma_wait_all();

  // dk * scale into the first Dh features of each key row, dv into the rest
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int j = j0 + 64 * wg + 16 * warp + lane / 4 + 8 * i;
    if (j >= S) continue;
    __nv_bfloat16* row = dkv_bh + (size_t)j * (2 * kDh) + 2 * quad;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      *reinterpret_cast<uint32_t*>(row + 8 * c) =
          pack_bf16(dk[4 * c + 2 * i] * scale, dk[4 * c + 2 * i + 1] * scale);
      *reinterpret_cast<uint32_t*>(row + kDh + 8 * c) =
          pack_bf16(dv[4 * c + 2 * i], dv[4 * c + 2 * i + 1]);
    }
  }
}

// the fp32 dq buffer [BG, N, H, 64]: dims (64, H, N, BG), boxes of 32
// features x 64 rows (128-byte rows), 128-byte swizzle
bool encode_dq(CUtensorMap* map, const void* base, int bg, int n, int h) {
  const cuuint64_t row = 64 * 4;
  return encode_4d(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, base,
                   {64, (cuuint64_t)h, (cuuint64_t)n, (cuuint64_t)bg},
                   {row, row * h, row * h * n}, {32, 1, 64, 1},
                   CU_TENSOR_MAP_SWIZZLE_128B);
}

template <bool EXT>
cudaError_t launch(const CUtensorMap& qm, const CUtensorMap& dom,
                   const CUtensorMap& kvm, const CUtensorMap& dqm,
                   const void* labels, const void* q_self,
                   const void* q_upper, const void* ext, const void* lse,
                   const void* delta, void* dkv, int B, int G, int N, int H,
                   int S, int kv_len, cudaStream_t stream) {
  constexpr int smem = sizeof(Smem) + 1024;   // + alignment slack
  auto kernel = ca_bwd_fused_sm90<EXT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + kKeys - 1) / kKeys, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      qm, dom, kvm, dqm, static_cast<const int32_t*>(labels),
      static_cast<const int32_t*>(q_self),
      static_cast<const int32_t*>(q_upper), static_cast<const uint8_t*>(ext),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dkv), G, N, H, S, kv_len,
      1.0f / sqrtf(static_cast<float>(kDh)));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K5. Returns 0 on success, else the cudaError_t of the refused launch
// (cudaErrorInvalidValue where a tensor map could not be encoded). ext may
// be null (no token dropout); dq32 [B, G, N, H, Dh] fp32 must be zeroed by
// the caller.
int must3r_ca_bwd_fused_bf16(const void* q, const void* kv,
                             const void* labels, const void* q_self,
                             const void* q_upper, const void* ext,
                             const void* lse, const void* delta,
                             const void* dout, void* dkv, void* dq32, int B,
                             int G, int N, int H, int Dh, int S, int kv_len,
                             void* stream) {
  if (Dh != kDh)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap qm, dom, kvm, dqm;
  if (!encode_rows(&qm, q, B * G, N, H) ||
      !encode_rows(&dom, dout, B * G, N, H) ||
      !encode_layer(&kvm, kv, B, H, S, kv_len) ||
      !encode_dq(&dqm, dq32, B * G, N, H))
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      ext != nullptr
          ? launch<true>(qm, dom, kvm, dqm, labels, q_self, q_upper, ext, lse,
                         delta, dkv, B, G, N, H, S, kv_len, st)
          : launch<false>(qm, dom, kvm, dqm, labels, q_self, q_upper, ext,
                          lse, delta, dkv, B, G, N, H, S, kv_len, st);
  return static_cast<int>(err);
}

}  // extern "C"
