// The backward of the memory cross-attention as TMA + wgmma programs for
// Hopper (sm_90a). bf16 inputs, fp32 accumulation and statistics, head dim
// 64:
//
//   p    = allow(g, j) * exp(q.k_j * scale - lse)
//   ds   = p * (dO.v_j - delta),   delta = rowsum(dO * O) (the caller's)
//   dq   = sum_j ds * k_j * scale
//   dk_j = sum_(g, i) ds * q_i * scale,   dv_j = sum_(g, i) p * dO_i
//
//   K3 ca_bwd_dq    dQ alone. Replaces must3r_tpu/ops/attention.py::
//                   _ca_bwd_dq_pallas. Kernel ca_bwd_dq_sm90.
//   K4 ca_bwd_dkv   dK|dV alone. Replaces _ca_bwd_dkv_pallas. Kernel
//                   ca_bwd_fused_sm90<EXT, DQ = false>: K5's loop without
//                   dQ.
//   K5 ca_bwd_fused dQ and dK|dV in one launch. Replaces
//                   _ca_bwd_fused_pallas. Kernel ca_bwd_fused_sm90<EXT, DQ
//                   = true>.
// The routing (ops/attention.py::_fold_stripe) sends a step of several
// images whose 128-aligned rows fit 2,048 to K5 and every other to K3 + K4,
// as the JAX package does.
//
// Inputs: q, dO [B, G, N, H, Dh]; kv [B, H, S, 2*Dh] (one layer); labels
// [B, S] int32; q_self, q_upper [B, G] int32; ext [B, G, S] bool or null;
// lse, delta [B, G, H, N] fp32. A row with lse = +1e30 (it attended nothing
// in the forward) gets p = 0 for every key, so dq = 0 and no dK|dV. The
// layer's tensor map has the key extent kv_len, so slots at or past it
// arrive as zeros whatever they hold (NaN, 1e30), and their allow bit is 0.
//
// What bounds them: per (query, key) pair 3 (K3), 4 (K4) or 5 (K5) products
// of Dh, against the forward's 2, on the same bytes: operations on the
// bf16 tensor cores at the training shapes (768..1536 query rows against
// 1536..3920 keys), with one ex2 per pair on the SFU beside them; K5 also
// moves its dQ adds (kv_len / 128 x G * N * Dh * 4 bytes a head).
//
// K4 / K5, the key-block program (FlashAttention-3's backward, cut to this
// CA). A block owns 128 keys of one (b, head): two consumer warpgroups of
// 64 keys each, and one producer warpgroup whose first warp loads. 64-key
// blocks (one consumer warpgroup) took the same time at the training shapes
// and moved twice the dQ bytes (PERF.md section 6).
//   - K and V of the block's keys are loaded once by TMA and stay in shared
//     memory; dK and dV stay in fp32 registers for the whole loop.
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
//     A layout) and B MN-major.
//   - DQ (K5): dS^T also goes to shared memory (swizzled), then dQ_tile =
//     dS K with A and B both MN-major from shared memory. The stage is then
//     released, and the tile's dQ (times scale) goes through a
//     double-buffered shared tile (two 32-column halves, 128-byte swizzle)
//     to one TMA reduce-add per half (cp.reduce.async.bulk.tensor.add.f32)
//     into the wrapper's zeroed fp32 [B, G, N, H, Dh] buffer; rows past N
//     are dropped by the map. The second warpgroup adds its partial to the
//     first's in shared memory, so one reduce-add serves 128 keys. The sums
//     of different key blocks land in no fixed order: K5's dq is not
//     bitwise reproducible. Without DQ (K4) none of this is compiled and
//     the shared-memory request shrinks by 48 KB.
//   - After the loop dK * scale and dV are written as bf16 rows of dkv,
//     every row (exactly 0 at or past kv_len: the wrapper allocates dkv
//     uninitialised). A block whose keys all lie at or past kv_len writes
//     zeros and exits.
// Shared memory: 32 KB of K and V, 3 stages of 16 KB (Q, dO) + 512 bytes;
// DQ: + 16 KB of dS^T, 32 KB of dQ buffers; on a 1 KB alignment.
// Registers: one block of 384 threads an SM, 168 a thread by the launch
// bound, within which ptxas allocates every warp's code (K5: 40 bytes
// spill); -Xptxas -v in build/kernels/libattention_bwd_sm90_*.log.
// setmaxnreg (24 for the producer, 240 or 200 for the consumers) left K5's
// consumers' allocation and time as they are (tools/ablate_kernels.py,
// PERF.md section 6), so the program does without it.
//
// K3, the query-block program: the forward's loop (attention_sm90.cu) with
// two products in and one out. A block owns NC * 64 query rows of one
// (b * G + g, head), NC = 1 or 3 by the forward's rule
// (consumers_per_block, sm90.cuh): NC consumer warpgroups of 64 rows and a
// producer warpgroup whose first warp loads.
//   - The producer loads the block's Q and dO tiles once by TMA (the 4-D
//     maps of K5; rows past N are zero-filled), then walks the layer's key
//     tiles (64 keys) through a ring of kDqStages stages: per stage the
//     tile's 64-bit allow mask for the block's image (one image a block), and
//     unless it is 0 (the tile is skipped) K and V as two 64 x 64 boxes of
//     the packed row (128-byte swizzle).
//   - Each consumer thread loads its two rows' lse (times log2 e; +1e30
//     past N) and delta once. Per key tile it computes S = Q K^T and dP =
//     dO V^T (wgmma, both operands K-major from shared memory), P and dS in
//     registers (the allow bit, one ex2 with the scale and lse folded into
//     one FFMA, ds = p * (dp - delta) rounded to bf16 A fragments), then
//     dQ += dS K with A from registers and K MN-major from the stage, and
//     releases the stage.
//   - dQ stays in fp32 registers for the whole loop and is written once,
//     times scale, as bf16 rows of [B, G, N, H, Dh]: no atomics and no
//     scratch buffer, so K3's dq is bitwise reproducible.
// Shared memory: NC * 16 KB of Q and dO + 4 stages of 16 KB (K, V) + masks
// and barriers on a 1 KB alignment (82 KB at NC = 1, two blocks an SM; 115
// KB at NC = 3). Registers: 128 a thread by the launch bound (256 threads,
// two blocks an SM; or 512, one), within which dQ, S and dP (96) fit.

#include <type_traits>

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

// K5's dQ path: dS^T of each consumer and the double-buffered dQ tile
struct DqTiles {
  alignas(1024) __nv_bfloat16 dst[kNW][64 * kRows];  // dS^T, keys x rows
  alignas(1024) float dq[2][2][kRows * 32];           // [buffer][half]
};
struct NoDq {};

template <bool DQ>
struct Smem {
  alignas(1024) __nv_bfloat16 k[kNW][64 * kDh];
  alignas(1024) __nv_bfloat16 v[kNW][64 * kDh];
  alignas(1024) __nv_bfloat16 q[kStages][kRows * kDh];
  alignas(1024) __nv_bfloat16 dout[kStages][kRows * kDh];
  std::conditional_t<DQ, DqTiles, NoDq> t;
  alignas(16) float lse2[kStages][kRows];
  alignas(16) float delta[kStages][kRows];
  uint32_t mask[kStages][2 * kNW];          // bit c of word w: key 32w + c
  uint64_t full[kStages];
  uint64_t empty[kStages];
  uint64_t kv_full;
};

// Named barriers: 1 + wg for one consumer warpgroup, kAllConsumers for all.
constexpr int kAllConsumers = 3;

template <bool EXT, bool DQ>
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
  Smem<DQ>& sm = *reinterpret_cast<Smem<DQ>*>(smem_raw + pad);
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
        words[w] = ballot_allowed<EXT>(labels + (size_t)b * S,
                                       ext + (size_t)bz * S,
                                       j0 + 32 * w + lane, kv_len, qs, qu);
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
  const bool issuer = DQ && threadIdx.x == 0;   // issues the dQ adds
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
  uint64_t dsd = 0;                         // DQ: dS^T, keys x rows
  uint8_t* dst_tile = nullptr;
  if constexpr (DQ) {
    dsd = sw128_desc(sm.t.dst[wg]);
    dst_tile = reinterpret_cast<uint8_t*>(sm.t.dst[wg]);
  }

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
      if constexpr (DQ) {
        // dS^T into shared memory (rows = keys, 64 query columns,
        // swizzled): pair x of the A fragments is register pair (j, i) =
        // (x / 2, x % 2)
#pragma unroll
        for (int x = 0; x < 16; ++x) {
          const int row = 16 * warp + lane / 4 + 8 * (x & 1);
          *reinterpret_cast<uint32_t*>(dst_tile + sw128_offset(row, x >> 1) +
                                       4 * quad) = da[x / 4][x % 4];
        }
        fence_proxy_async();
        named_sync(1 + wg, kWG);
      }

      // dV += P^T dO, dK += dS^T Q, with DQ dQ_tile = dS K
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
      if constexpr (DQ) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<1, 1>(dq, dsd + 128 * kk, kd + 128 * kk, kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(dv);
      reg_fence(dk);
      if constexpr (DQ) reg_fence(dq);
      reg_fence(pa);
      reg_fence(da);
      mbar_arrive(&sm.empty[stage]);        // Q and dO are no longer read
      if constexpr (DQ) {
        // the tile's dQ (times scale) into the fp32 buffer: register
        // 4j + 2i + e holds row 16 * warp + lane / 4 + 8i, feature
        // 8j + 2 * quad + e; the buffer holds two 32-feature halves of
        // 128-byte rows, swizzled as the map's box
        const int buf = it & 1;
        if (issuer) tma_wait_read<1>();     // the add of two steps ago read it
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
                    reinterpret_cast<uint8_t*>(sm.t.dq[buf][j >> 2]) +
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
          tma_reduce_add_4d(&dqmap, sm.t.dq[buf][0], 0, h, qt * kRows, bz);
          tma_reduce_add_4d(&dqmap, sm.t.dq[buf][1], 32, h, qt * kRows, bz);
          tma_commit();
        }
        ++it;
      }
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

// --- K3: the query-block program --------------------------------------

constexpr int kDqStages = 4;

template <int NC>
struct DqConfig {
  static constexpr int kThreads = (NC + 1) * kWG;
  static constexpr int kMinBlocks = NC == 1 ? 2 : 1;
  static_assert(NC == 1 || NC == 3, "one or three consumer warpgroups");
};

template <int NC>
struct DqSmem {
  alignas(1024) __nv_bfloat16 q[NC][kRows * kDh];
  alignas(1024) __nv_bfloat16 dout[NC][kRows * kDh];
  alignas(1024) __nv_bfloat16 k[kDqStages][64 * kDh];
  alignas(1024) __nv_bfloat16 v[kDqStages][64 * kDh];
  uint64_t mask[kDqStages];                 // bit j: key j0 + j attended
  uint64_t full[kDqStages];
  uint64_t empty[kDqStages];
  uint64_t q_full;
};

// Accumulator register d[4j + 2i + e] of a consumer thread holds query row
// 16 * warp + lane / 4 + 8i of its warpgroup's 64 and column 8j + 2 * (lane
// % 4) + e (a key of the tile for S, dP; a feature for dQ).
template <bool EXT, int NC>
__global__ void __launch_bounds__(DqConfig<NC>::kThreads,
                                  DqConfig<NC>::kMinBlocks)
ca_bwd_dq_sm90(const __grid_constant__ CUtensorMap qmap,
               const __grid_constant__ CUtensorMap domap,
               const __grid_constant__ CUtensorMap kvmap,
               const int32_t* __restrict__ labels,
               const int32_t* __restrict__ q_self,
               const int32_t* __restrict__ q_upper,
               const uint8_t* __restrict__ ext,
               const float* __restrict__ lse,
               const float* __restrict__ delta,
               __nv_bfloat16* __restrict__ dq_out, int G, int N, int H, int S,
               int kv_len, float scale) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t pad = (1024u - (smem_u32(smem_raw) & 1023u)) & 1023u;
  DqSmem<NC>& sm = *reinterpret_cast<DqSmem<NC>*>(smem_raw + pad);

  const int wg = threadIdx.x / kWG;
  const int q0 = blockIdx.x * (NC * kRows);
  const int h = blockIdx.y;
  const int bz = blockIdx.z;                // batch * G + image
  const int b = bz / G;
  const int n_tiles = (kv_len + 63) / 64;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kDqStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], NC * kWG);
    }
    mbar_init(&sm.q_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == NC) {
    // -------------- producer warpgroup: warp 0 loads ------------------
    const int warp = (threadIdx.x % kWG) / 32;
    const int lane = threadIdx.x % 32;
    if (warp != 0) return;
    if (lane == 0) {
      mbar_expect_tx(&sm.q_full, 2 * NC * kTileBytes);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        tma_load_4d(sm.q[c], &qmap, &sm.q_full, 0, h, q0 + c * kRows, bz);
        tma_load_4d(sm.dout[c], &domap, &sm.q_full, 0, h, q0 + c * kRows,
                    bz);
      }
    }
    const int32_t* labels_b = labels + (size_t)b * S;
    const uint8_t* ext_bz = ext + (size_t)bz * S;
    const int qs = q_self[bz], qu = q_upper[bz];
    int stage = 0;
    uint32_t phase = 0;
    for (int t = 0; t < n_tiles; ++t) {
      const int j0 = t * 64;
      const uint32_t lo = ballot_allowed<EXT>(labels_b, ext_bz, j0 + lane,
                                              kv_len, qs, qu);
      const uint32_t hi = ballot_allowed<EXT>(labels_b, ext_bz,
                                              j0 + 32 + lane, kv_len, qs, qu);
      mbar_wait(&sm.empty[stage], phase ^ 1);
      if (lane == 0) {
        const uint64_t mask = lo | (static_cast<uint64_t>(hi) << 32);
        sm.mask[stage] = mask;
        if (mask != 0) {
          mbar_expect_tx(&sm.full[stage], 2 * kTileBytes);
          tma_load_4d(sm.k[stage], &kvmap, &sm.full[stage], 0, j0, h, b);
          tma_load_4d(sm.v[stage], &kvmap, &sm.full[stage], kDh, j0, h, b);
        } else {
          mbar_arrive(&sm.full[stage]);     // nothing attended: skip
        }
      }
      __syncwarp();
      if (++stage == kDqStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    return;
  }

  // ---------------- consumer warpgroup wg: 64 query rows ----------------
  const int t = threadIdx.x % kWG;
  const int warp = t / 32;
  const int lane = t % 32;
  const int quad = lane % 4;
  const float sl2 = scale * kLog2e;         // scores to log2 units
  // this thread's two rows: lse in log2 units (+1e30 past N: p = 0) and
  // delta
  float l2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int n = q0 + wg * kRows + 16 * warp + lane / 4 + 8 * i;
    const size_t row = ((size_t)bz * H + h) * N + n;
    l2[i] = (n < N ? lse[row] : kEmptyLse) * kLog2e;
    dl[i] = n < N ? delta[row] : 0.f;
  }

  float dq[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq[i] = 0.f;
  mbar_wait(&sm.q_full, 0);
  const uint64_t qd = sw128_desc(sm.q[wg]);
  const uint64_t dod = sw128_desc(sm.dout[wg]);
  int stage = 0;
  uint32_t phase = 0;
  for (int tile = 0; tile < n_tiles; ++tile) {
    mbar_wait(&sm.full[stage], phase);
    const uint64_t mask = sm.mask[stage];   // uniform across the block
    if (mask != 0) {
      // S = Q K^T and dP = dO V^T (4 steps of 16 features each)
      const uint64_t kd = sw128_desc(sm.k[stage]);
      const uint64_t vd = sw128_desc(sm.v[stage]);
      float s[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kDh / 16; ++kk)
        wgmma_ss(s, qd + 2 * kk, kd + 2 * kk, kk > 0);
#pragma unroll
      for (int kk = 0; kk < kDh / 16; ++kk)
        wgmma_ss(dp, dod + 2 * kk, vd + 2 * kk, kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(s);
      reg_fence(dp);

      // P and dS = P (dP - delta); a key the mask blocks gets p = 0
      const uint64_t mq = mask >> (2 * quad);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int r = 4 * j + 2 * i + e;
            const float p = (mq >> (8 * j + e)) & 1
                                ? ex2(fmaf(s[r], sl2, -l2[i]))
                                : 0.f;
            dp[r] = p * (dp[r] - dl[i]);
          }
      uint32_t da[4][4];
      acc_to_a(dp, da);                     // dS as bf16 A fragments

      // dQ += dS K (4 steps of 16 keys, 16 rows of 128 bytes of K)
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs(dq, da[kk], kd + 128 * kk);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(dq);
      reg_fence(da);
    }
    mbar_arrive(&sm.empty[stage]);          // K and V are no longer read
    if (++stage == kDqStages) {
      stage = 0;
      phase ^= 1;
    }
  }

  // dq * scale as bf16 rows; a row that attends nothing wrote 0
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int n = q0 + wg * kRows + 16 * warp + lane / 4 + 8 * i;
    if (n >= N) continue;
    __nv_bfloat16* dst =
        dq_out + ((size_t)(bz * N + n) * H + h) * kDh + 2 * quad;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<uint32_t*>(dst + 8 * j) =
          pack_bf16(dq[4 * j + 2 * i] * scale, dq[4 * j + 2 * i + 1] * scale);
  }
}

// --- host side ------------------------------------------------------------

template <bool EXT, bool DQ>
cudaError_t launch_keys(const CUtensorMap& qm, const CUtensorMap& dom,
                        const CUtensorMap& kvm, const CUtensorMap& dqm,
                        const void* labels, const void* q_self,
                        const void* q_upper, const void* ext, const void* lse,
                        const void* delta, void* dkv, int B, int G, int N,
                        int H, int S, int kv_len, cudaStream_t stream) {
  constexpr int smem = sizeof(Smem<DQ>) + 1024;   // + alignment slack
  auto kernel = ca_bwd_fused_sm90<EXT, DQ>;
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

template <bool EXT, int NC>
cudaError_t launch_rows(const CUtensorMap& qm, const CUtensorMap& dom,
                        const CUtensorMap& kvm, const void* labels,
                        const void* q_self, const void* q_upper,
                        const void* ext, const void* lse, const void* delta,
                        void* dq, int B, int G, int N, int H, int S,
                        int kv_len, cudaStream_t stream) {
  constexpr int smem = sizeof(DqSmem<NC>) + 1024;  // + alignment slack
  auto kernel = ca_bwd_dq_sm90<EXT, NC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + NC * kRows - 1) / (NC * kRows), H, B * G);
  kernel<<<grid, DqConfig<NC>::kThreads, smem, stream>>>(
      qm, dom, kvm, static_cast<const int32_t*>(labels),
      static_cast<const int32_t*>(q_self),
      static_cast<const int32_t*>(q_upper), static_cast<const uint8_t*>(ext),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dq), G, N, H, S, kv_len,
      1.0f / sqrtf(static_cast<float>(kDh)));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Each returns 0 on success, else the cudaError_t of the refused launch
// (cudaErrorInvalidValue where a tensor map could not be encoded). ext may
// be null (no token dropout).

// K5: dq32 [B, G, N, H, Dh] fp32 must be zeroed by the caller; dkv [B, H,
// S, 2*Dh] bf16.
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
          ? launch_keys<true, true>(qm, dom, kvm, dqm, labels, q_self,
                                    q_upper, ext, lse, delta, dkv, B, G, N, H,
                                    S, kv_len, st)
          : launch_keys<false, true>(qm, dom, kvm, dqm, labels, q_self,
                                     q_upper, ext, lse, delta, dkv, B, G, N,
                                     H, S, kv_len, st);
  return static_cast<int>(err);
}

// K4: dk | dv [B, H, S, 2*Dh] bf16 of one cache layer.
int must3r_ca_bwd_dkv_bf16(const void* q, const void* kv, const void* labels,
                           const void* q_self, const void* q_upper,
                           const void* ext, const void* lse,
                           const void* delta, const void* dout, void* dkv,
                           int B, int G, int N, int H, int Dh, int S,
                           int kv_len, void* stream) {
  if (Dh != kDh) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap qm, dom, kvm;
  if (!encode_rows(&qm, q, B * G, N, H) ||
      !encode_rows(&dom, dout, B * G, N, H) ||
      !encode_layer(&kvm, kv, B, H, S, kv_len))
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  // no dQ: the dQ map is never read, qm stands in for it
  const cudaError_t err =
      ext != nullptr
          ? launch_keys<true, false>(qm, dom, kvm, qm, labels, q_self,
                                     q_upper, ext, lse, delta, dkv, B, G, N,
                                     H, S, kv_len, st)
          : launch_keys<false, false>(qm, dom, kvm, qm, labels, q_self,
                                      q_upper, ext, lse, delta, dkv, B, G, N,
                                      H, S, kv_len, st);
  return static_cast<int>(err);
}

// K3: dq [B, G, N, H, Dh] bf16.
int must3r_ca_bwd_dq_bf16(const void* q, const void* kv, const void* labels,
                          const void* q_self, const void* q_upper,
                          const void* ext, const void* lse, const void* delta,
                          const void* dout, void* dq, int B, int G, int N,
                          int H, int Dh, int S, int kv_len, void* stream) {
  if (Dh != kDh) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap qm, dom, kvm;
  if (!encode_rows(&qm, q, B * G, N, H) ||
      !encode_rows(&dom, dout, B * G, N, H) ||
      !encode_layer(&kvm, kv, B, H, S, kv_len))
    return static_cast<int>(cudaErrorInvalidValue);
  int nc = 1;
  cudaError_t err = consumers_per_block(N, (long long)H * B * G, &nc);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto st = static_cast<cudaStream_t>(stream);
#define MUST3R_DQ(EXT, NC)                                                  \
  launch_rows<EXT, NC>(qm, dom, kvm, labels, q_self, q_upper, ext, lse,     \
                       delta, dq, B, G, N, H, S, kv_len, st)
  if (ext != nullptr)
    err = nc == 3 ? MUST3R_DQ(true, 3) : MUST3R_DQ(true, 1);
  else
    err = nc == 3 ? MUST3R_DQ(false, 3) : MUST3R_DQ(false, 1);
#undef MUST3R_DQ
  return static_cast<int>(err);
}

}  // extern "C"
