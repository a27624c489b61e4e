// The attention forward program of the PyTorch port for Hopper (sm_90a):
// TMA tile ring, wgmma, scores and output in registers. bf16 in / bf16 out,
// fp32 softmax statistics, head dim 64.
//
//   K1 sa_fwd : full unmasked self-attention, q/k/v/out [B, N, H, Dh].
//               Replaces must3r_tpu/ops/attention.py::_sa_pallas.
//   K2 ca_fwd : label-masked cross-attention of queries against one layer
//               of the packed token memory, the bf16 variants of
//               must3r_tpu/ops/attention.py::_ca_pallas: serving (a), and
//               as template flags STATS (b, return_stats: fp32 log-sum-exp
//               lse [B, G, H, N] for the backward) and EXT (c, token
//               dropout: ext [B, G, S] bool, a nonzero entry blocks key j
//               for image g). q/out [B, G, N, H, Dh]; kv [B, H, S, 2*Dh]
//               (k = first Dh features of a row, v = the last Dh); labels
//               [B, S] int32; q_self / q_upper [B, G] int32. Key j is
//               attended when
//                 j < kv_len && lbl >= 0 && lbl != q_self && lbl < q_upper
//               (&& !ext[g, j] with EXT).
// The 8-bit read K2(d) and the two-heads microbenchmark K6 stay on the
// WMMA program of attention.cu.
//
// What bounds it: at every main-path shape (N = 768 for SA; 768..7680 query
// rows against 1536..7680 keys for CA) the work is ~4*Dh flops per (query,
// key) pair against 2*Dh*2 bytes per key per 64 query rows: operations, on
// the bf16 tensor cores (PERF.md section 6). At Dh = 64 the exponentials
// weigh as much: one ex2 per score on the SFU (16 a clock per SM) against
// 256 flops per score on the tensor cores, so the two have to overlap.
//
// The block program. A block owns NC * 64 query rows of one (batch*image,
// head), NC = 1 or 3: NC consumer warpgroups of 64 rows each, then one
// producer warpgroup whose first warp does all the loading (setmaxnreg
// gives its registers to the consumers).
//   - The producer loads the block's Q tiles once, then walks the key tiles
//     (64 keys each) through a ring of kStages stages. Per stage it waits
//     for "empty", computes the tile's allow vector from the labels (the
//     block belongs to one image, so one 64-bit mask serves all its rows),
//     stores it beside the stage and, unless the mask is 0 (the tile is
//     skipped), starts two TMA loads (K and V, 64 x 64 bf16 each, 128-byte
//     swizzle) that complete on the stage's "full" mbarrier.
//   - Tensor maps are encoded on the host per launch
//     (cuTensorMapEncodeTiled, looked up in libcuda at run time with
//     cudaGetDriverEntryPoint: no -lcuda). q/k/v of SA and q of CA are 4-D
//     maps (Dh, H, N, B*G): a tile past N is zero-filled and never reads the
//     next image's rows. The CA layer [B, H, S, 2*Dh] is one map whose key
//     extent is kv_len, not S; K is the box at feature 0 and V the box at
//     feature 64, so slots at or past kv_len arrive as zeros whatever they
//     hold (a NaN there would otherwise become NaN through 0 * NaN in P.V).
//   - A consumer warpgroup computes S = Q K^T with four
//     wgmma.m64n64k16.f32.bf16.bf16 from shared-memory descriptors (both
//     K-major, 128-byte swizzle). S stays in registers: the masked online
//     softmax runs there (a row's max and sum reduce across the 4 threads
//     of a quad; exp2 with the scale folded into one FFMA), P is converted
//     in registers to bf16 A fragments (the accumulator layout of m64n64 is
//     the A-register layout of the next product), and O += P V is four more
//     wgmma with A from registers and V (key-major, so B is MN-major: the
//     transposed-B flag) from shared memory. O stays in fp32 registers until
//     the epilogue, which writes bf16 rows (and the LSE) straight to global
//     memory.
//   - The two products overlap the softmax, as in FlashAttention-3: a tile's
//     S = Q K^T and the previous tile's O += P V go out together, the
//     softmax of the new S runs while P V is still on the tensor cores, and
//     only then is O rescaled. A tile waits one iteration for its P V, so
//     its stage is released one tile late; a skipped tile first finishes the
//     pending P V, so that no stage stays held while the ring comes round.
//
// Tiles, stages, shared memory: 64 keys a tile, kStages = 4; per block NC *
// 8 KB of Q + 4 * 16 KB of K/V + masks and barriers, on a 1 KB alignment:
// 75,776 bytes (NC = 1) / 92,160 (NC = 3) of dynamic shared memory. Blocks
// per SM: 2 of 256 threads (NC = 1) or 1 of 512 (NC = 3), by
// __launch_bounds__. Registers (-Xptxas -v, written to
// build/kernels/libattention_sm90_*.log): 128 a thread at entry, the launch
// bound's, then setmaxnreg 24 for the producer and 232 (NC = 1) / 160
// (NC = 3) for the consumers; no spills. The launch chooses NC from the
// grid (see launch()).
//
// Semantics kept from the WMMA program: a masked key's probability is
// forced to 0 (not exp(-1e30 - m)), so a query row with no attended key
// (every label masked, or kv_len == 0) returns 0, and its LSE is kEmptyLse
// (+1e30). The Pallas kernel returns the mean of V there (ROADMAP queue C).

#include <cuda.h>  // CUtensorMap and its enums (the encoder: see encoder())
#include <cuda_runtime.h>

#include "common.cuh"

using namespace must3r;

namespace {

constexpr int kDh = 64;
constexpr int kRows = 64;                   // query rows per consumer warpgroup
constexpr int kKeys = 64;                   // keys per tile
constexpr int kStages = 4;
constexpr int kWG = 128;                    // threads per warpgroup
constexpr int kTileBytes = 64 * kDh * 2;    // one 64 x 64 bf16 tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kProducerRegs = 24;

// Blocks per SM and the consumers' registers after setmaxnreg: the
// producer's 24 and the consumers' counts stay within what the launch bound
// gives the block (65536 / blocks per SM; 128 a thread either way).
template <int NC>
struct Config {
  static constexpr int kThreads = (NC + 1) * kWG;
  static constexpr int kMinBlocks = NC == 1 ? 2 : 1;
  static constexpr int kConsumerRegs = NC == 1 ? 232 : 160;
  static_assert(NC == 1 || NC == 3, "one or three consumer warpgroups");
  static_assert(kProducerRegs * kWG + NC * kWG * kConsumerRegs <=
                    65536 / kMinBlocks,
                "setmaxnreg must stay within the block's registers");
};

template <int NC>
struct Smem {
  // 1 KB alignment: the 128-byte swizzle repeats every 8 rows of 128 bytes,
  // and the wgmma descriptors assume tiles start on that period
  alignas(1024) __nv_bfloat16 q[NC][kRows * kDh];
  alignas(1024) __nv_bfloat16 k[kStages][kKeys * kDh];
  alignas(1024) __nv_bfloat16 v[kStages][kKeys * kDh];
  uint64_t mask[kStages];                   // bit j: key j0 + j attended
  uint64_t full[kStages];
  uint64_t empty[kStages];
  uint64_t q_full;
};

// --- mbarrier and TMA -----------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Wait until the barrier's phase with this parity has completed. A wait
// that never ends traps (a launch error) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t tries = 0;; ++tries) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (tries > (1u << 26)) __trap();
  }
}

// One box of a 4-D tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// --- wgmma ----------------------------------------------------------------

// Descriptor of a 64-row tile of 128-byte rows written by TMA with the
// 128-byte swizzle: SBO = 1024 bytes between 8-row groups; LBO unused (K-
// major swizzled operands, and an MN-major one exactly 64 wide).
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  return static_cast<uint64_t>((smem_u32(tile) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups of this warpgroup are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads of an accumulator above the wait,
// and the registers of an A operand from being reused before it.
__device__ __forceinline__ void reg_fence(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void reg_fence(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 16; ++i)
    asm volatile("" : "+r"(a[i / 4][i % 4])::"memory");
}

#define MUST3R_D32                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define MUST3R_D32_OPS(d)                                                   \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])

// d (+)= A B, A and B both K-major in shared memory; scale_d = 0 overwrites.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a,
                                         uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MUST3R_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : MUST3R_D32_OPS(d)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d += A B, A (bf16 pairs) in registers, B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MUST3R_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : MUST3R_D32_OPS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The online softmax of a thread's two rows (registers 4j + 2i + e hold row
// i, key 8j + 2 * quad + e of the tile): running max m (log2 units) and
// this thread's part of the running sum l, reduced across the quad at the
// end. update() turns a tile of raw scores into probabilities in place and
// sets corr, the factor by which the output accumulated so far must be
// rescaled. A masked key's probability is forced to 0; FULL is the
// all-attended tile, without the per-key test. Every row of a tile that is
// not skipped has an attended key, so m is finite after the first one.
struct Softmax {
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  float corr[2];

  template <bool FULL>
  __device__ __forceinline__ void update(float (&s)[32],
                                                 uint64_t mask, int quad,
                                                 float sl2) {
    const uint64_t mq = mask >> (2 * quad);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (FULL || ((mq >> (8 * j + e)) & 1))
            mx[i] = fmaxf(mx[i], s[4 * j + 2 * i + e]);
    float neg_m[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i] * sl2);   // sl2 > 0
      corr[i] = ex2(m[i] - m_new);
      m[i] = m_new;
      l[i] *= corr[i];
      neg_m[i] = -m_new;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = 4 * j + 2 * i + e;
          const float p = FULL || ((mq >> (8 * j + e)) & 1)
                              ? ex2(fmaf(s[r], sl2, neg_m[i]))
                              : 0.f;
          s[r] = p;
          l[i] += p;
        }
  }
};

// --- the kernel -----------------------------------------------------------

// CA == false: q/k/v maps are [B, N, H, Dh], keys = N, every key below N is
//   attended. CA == true: k/v maps are both the packed layer [B, H, kv_len,
//   2*Dh] (V at feature 64), keys = kv_len, the label predicate decides.
// Accumulator register d[4j + 2i + e] of a thread holds row
// 16 * warp + lane / 4 + 8i and column 8j + 2 * (lane % 4) + e.
template <bool CA, bool STATS, bool EXT, int NC>
__global__ void __launch_bounds__(Config<NC>::kThreads,
                                  Config<NC>::kMinBlocks)
attn_fwd_sm90(const __grid_constant__ CUtensorMap qmap,
              const __grid_constant__ CUtensorMap kmap,
              const __grid_constant__ CUtensorMap vmap,
              const int32_t* __restrict__ labels,
              const int32_t* __restrict__ q_self,
              const int32_t* __restrict__ q_upper,
              const uint8_t* __restrict__ ext,
              __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int G,
              int N, int H, int S, int n_keys, float scale) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t pad = (1024u - (smem_u32(smem_raw) & 1023u)) & 1023u;
  Smem<NC>& sm = *reinterpret_cast<Smem<NC>*>(smem_raw + pad);

  const int wg = threadIdx.x / kWG;
  const int q0 = blockIdx.x * (NC * kRows);
  const int h = blockIdx.y;
  const int bz = blockIdx.z;                // batch * G + image
  const int n_tiles = (n_keys + kKeys - 1) / kKeys;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], NC * kWG);
    }
    mbar_init(&sm.q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == NC) {
    // ---------------- producer warpgroup: one warp loads ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kProducerRegs));
    const int warp = (threadIdx.x % kWG) / 32;
    const int lane = threadIdx.x % 32;
    if (warp == 0) {
      if (lane == 0) {
        mbar_expect_tx(&sm.q_full, NC * kTileBytes);
#pragma unroll
        for (int c = 0; c < NC; ++c)
          tma_load_4d(sm.q[c], &qmap, &sm.q_full, 0, h, q0 + c * kRows, bz);
      }
      const int b = CA ? bz / G : bz;
      const int qs = CA ? q_self[bz] : 0;
      const int qu = CA ? q_upper[bz] : 0;
      int stage = 0;
      uint32_t phase = 0;
      for (int t = 0; t < n_tiles; ++t) {
        const int j0 = t * kKeys;
        bool ok[2];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int j = j0 + half * 32 + lane;
          bool a = j < n_keys;
          if (CA && a) a = slot_allowed(labels[(size_t)b * S + j], qs, qu);
          if (EXT && a) a = ext[(size_t)bz * S + j] == 0;
          ok[half] = a;
        }
        const uint32_t lo = __ballot_sync(0xffffffffu, ok[0]);
        const uint32_t hi = __ballot_sync(0xffffffffu, ok[1]);
        mbar_wait(&sm.empty[stage], phase ^ 1);
        if (lane == 0) {
          const uint64_t mask = lo | (static_cast<uint64_t>(hi) << 32);
          sm.mask[stage] = mask;
          if (mask != 0) {
            mbar_expect_tx(&sm.full[stage], 2 * kTileBytes);
            if (CA) {
              tma_load_4d(sm.k[stage], &kmap, &sm.full[stage], 0, j0, h, b);
              tma_load_4d(sm.v[stage], &vmap, &sm.full[stage], kDh, j0, h,
                          b);
            } else {
              tma_load_4d(sm.k[stage], &kmap, &sm.full[stage], 0, h, j0, b);
              tma_load_4d(sm.v[stage], &vmap, &sm.full[stage], 0, h, j0, b);
            }
          } else {
            mbar_arrive(&sm.full[stage]);   // nothing attended: skip
          }
        }
        __syncwarp();
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---------------- consumer warpgroup wg: 64 query rows ----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        Config<NC>::kConsumerRegs));
    const int t = threadIdx.x % kWG;
    const int warp = t / 32;
    const int lane = t % 32;
    const int quad = lane % 4;
    const float sl2 = scale * kLog2e;         // scores to log2 units

    float o[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;
    Softmax softmax;
    uint32_t p_prev[4][4] = {};               // P of the tile whose P.V waits
    int prev = -1;                            // its stage, -1 = none

    // O += P V of the pending tile alone, and its stage released
    auto finish_pv = [&]() {
      if (prev < 0) return;
      const uint64_t dv = sw128_desc(sm.v[prev]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk)
        wgmma_rs(o, p_prev[kk], dv + 128 * kk);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(o);
      mbar_arrive(&sm.empty[prev]);
      prev = -1;
    };

    mbar_wait(&sm.q_full, 0);
    const uint64_t dq = sw128_desc(sm.q[wg]);
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = 0; tile < n_tiles; ++tile) {
      mbar_wait(&sm.full[stage], phase);
      const uint64_t mask = sm.mask[stage];   // uniform across the block
      if (mask != 0) {
        // S = Q K^T (4 steps of 16 features, 32 bytes along a row), and
        // behind it the previous tile's O += P V (4 steps of 16 keys, 16
        // rows of 128 bytes of V): the softmax of this tile runs while the
        // tensor cores do that product.
        float s[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] = 0.f;
        const uint64_t dk = sw128_desc(sm.k[stage]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kDh / 16; ++kk)
          wgmma_ss(s, dq + 2 * kk, dk + 2 * kk, kk > 0);
        wgmma_commit();
        if (prev >= 0) {
          const uint64_t dv = sw128_desc(sm.v[prev]);
#pragma unroll
          for (int kk = 0; kk < kKeys / 16; ++kk)
            wgmma_rs(o, p_prev[kk], dv + 128 * kk);
          wgmma_commit();
          wgmma_wait<1>();                    // S is done, P.V may run on
        } else {
          wgmma_wait<0>();
        }
        reg_fence(s);
        if (mask == ~0ull)
          softmax.update<true>(s, mask, quad, sl2);
        else
          softmax.update<false>(s, mask, quad, sl2);
        wgmma_wait<0>();
        reg_fence(o);
        reg_fence(p_prev);
        if (prev >= 0) mbar_arrive(&sm.empty[prev]);
#pragma unroll
        for (int r = 0; r < 32; ++r) o[r] *= softmax.corr[(r >> 1) & 1];
        // P as bf16 A fragments: keys 16kk..16kk+15 are registers 8kk..8kk+7
#pragma unroll
        for (int x = 0; x < 16; ++x)
          p_prev[x / 4][x % 4] = pack_bf16(s[2 * x], s[2 * x + 1]);
        prev = stage;
      } else {
        // nothing attended: skipped. The pending P.V is finished first, so
        // that no stage stays held while the ring comes round to it.
        finish_pv();
        mbar_arrive(&sm.empty[stage]);
      }
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    finish_pv();                              // the last tile's P.V

    // epilogue: normalise and store; a row with nothing attended has
    // l == 0 and a zero accumulator, so it writes 0
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float l = softmax.l[i];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const int n = q0 + wg * kRows + warp * 16 + lane / 4 + 8 * i;
      if (n >= N) continue;
      const float inv = 1.f / fmaxf(l, 1e-30f);
      __nv_bfloat16* dst =
          out + ((size_t)(bz * N + n) * H + h) * kDh + 2 * quad;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<uint32_t*>(dst + 8 * j) =
            pack_bf16(o[4 * j + 2 * i] * inv, o[4 * j + 2 * i + 1] * inv);
      if (STATS && quad == 0)
        lse[((size_t)bz * H + h) * N + n] =
            l > 0.f ? (softmax.m[i] + log2f(l)) * kLn2 : kEmptyLse;
    }
  }
}

// --- host side ------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A 4-D bf16 map (dims innermost first, byte strides of dims 1..3) read in
// boxes of 64 x 64 x 1 x 1 or 64 x 1 x 64 x 1, 128-byte swizzle; elements
// outside the dims are zero-filled.
bool encode_4d(CUtensorMap* map, const void* base, const cuuint64_t (&dims)[4],
               const cuuint64_t (&strides)[3], const cuuint32_t (&box)[4]) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// [BG, N, H, Dh] activations: dims (Dh, H, N, BG), boxes of 64 rows of N
bool encode_rows(CUtensorMap* map, const void* base, int bg, int n, int h) {
  const cuuint64_t row = kDh * 2;
  return encode_4d(map, base, {kDh, (cuuint64_t)h, (cuuint64_t)n,
                               (cuuint64_t)bg},
                   {row, row * h, row * h * n}, {kDh, 1, 64, 1});
}

// the packed layer [B, H, S, 2*Dh] cut at kv_len: dims (2*Dh, kv_len, H, B)
bool encode_layer(CUtensorMap* map, const void* base, int b, int h, int s,
                  int kv_len) {
  const cuuint64_t row = 2 * kDh * 2;
  return encode_4d(map, base, {2 * kDh, (cuuint64_t)(kv_len > 0 ? kv_len : 1),
                               (cuuint64_t)h, (cuuint64_t)b},
                   {row, row * s, row * s * h}, {kDh, 64, 1, 1});
}

template <bool CA, bool STATS, bool EXT, int NC>
cudaError_t launch_nc(const CUtensorMap& qm, const CUtensorMap& km,
                      const CUtensorMap& vm, const void* labels,
                      const void* q_self, const void* q_upper,
                      const void* ext, void* out, void* lse, int bg, int G,
                      int N, int H, int S, int n_keys, cudaStream_t stream) {
  using C = Config<NC>;
  constexpr int smem = sizeof(Smem<NC>) + 1024;   // + alignment slack
  auto kernel = attn_fwd_sm90<CA, STATS, EXT, NC>;
  // the attribute belongs to the current device: set on every launch
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + NC * kRows - 1) / (NC * kRows), H, bg);
  kernel<<<grid, C::kThreads, smem, stream>>>(
      qm, km, vm, static_cast<const int32_t*>(labels),
      static_cast<const int32_t*>(q_self),
      static_cast<const int32_t*>(q_upper), static_cast<const uint8_t*>(ext),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), G, N, H, S,
      n_keys, 1.0f / sqrtf(static_cast<float>(kDh)));
  return cudaGetLastError();
}

// Rows per block: 192 (three consumer warpgroups sharing each K/V stage,
// one block an SM) when that grid still gives every SM two blocks, else 64
// (one warpgroup, two blocks an SM), so that a small grid (one image's 768
// rows x 12 heads: 144 blocks) still fills the SMs.
template <bool CA, bool STATS, bool EXT>
cudaError_t launch(const CUtensorMap& qm, const CUtensorMap& km,
                   const CUtensorMap& vm, const void* labels,
                   const void* q_self, const void* q_upper, const void* ext,
                   void* out, void* lse, int bg, int G, int N, int H, int S,
                   int n_keys, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long blocks192 = (long long)((N + 191) / 192) * H * bg;
  if (blocks192 >= 2LL * sms)
    return launch_nc<CA, STATS, EXT, 3>(qm, km, vm, labels, q_self, q_upper,
                                        ext, out, lse, bg, G, N, H, S, n_keys,
                                        stream);
  return launch_nc<CA, STATS, EXT, 1>(qm, km, vm, labels, q_self, q_upper,
                                      ext, out, lse, bg, G, N, H, S, n_keys,
                                      stream);
}

cudaError_t ca_launch(const void* q, const void* kv, const void* labels,
                      const void* q_self, const void* q_upper,
                      const void* ext, void* out, void* lse, int B, int G,
                      int N, int H, int S, int kv_len, cudaStream_t st) {
  CUtensorMap qm, kvm;
  if (!encode_rows(&qm, q, B * G, N, H) ||
      !encode_layer(&kvm, kv, B, H, S, kv_len))
    return cudaErrorInvalidValue;
  const int bg = B * G;
#define MUST3R_CA(STATS, EXT)                                                \
  launch<true, STATS, EXT>(qm, kvm, kvm, labels, q_self, q_upper, ext, out,  \
                           lse, bg, G, N, H, S, kv_len, st)
  if (lse != nullptr)
    return ext != nullptr ? MUST3R_CA(true, true) : MUST3R_CA(true, false);
  return ext != nullptr ? MUST3R_CA(false, true) : MUST3R_CA(false, false);
#undef MUST3R_CA
}

}  // namespace

extern "C" {

// Each returns 0 on success, else the cudaError_t of the refused launch
// (cudaErrorInvalidValue where a tensor map could not be encoded).
int must3r_sa_fwd_bf16(const void* q, const void* k, const void* v, void* out,
                       int B, int N, int H, int Dh, void* stream) {
  if (Dh != kDh) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap qm, km, vm;
  if (!encode_rows(&qm, q, B, N, H) || !encode_rows(&km, k, B, N, H) ||
      !encode_rows(&vm, v, B, N, H))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch<false, false, false>(
      qm, km, vm, nullptr, nullptr, nullptr, nullptr, out, nullptr, B, 1, N,
      H, 0, N, static_cast<cudaStream_t>(stream)));
}

int must3r_ca_fwd_bf16(const void* q, const void* kv, const void* labels,
                       const void* q_self, const void* q_upper, void* out,
                       int B, int G, int N, int H, int Dh, int S, int kv_len,
                       void* stream) {
  if (Dh != kDh) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(ca_launch(q, kv, labels, q_self, q_upper, nullptr,
                                    out, nullptr, B, G, N, H, S, kv_len,
                                    static_cast<cudaStream_t>(stream)));
}

// The training variants of K2: lse (fp32 [B, G, H, N]) written when not
// null, ext (bool [B, G, S]) read when not null.
int must3r_ca_fwd_train_bf16(const void* q, const void* kv, const void* labels,
                             const void* q_self, const void* q_upper,
                             const void* ext, void* out, void* lse, int B,
                             int G, int N, int H, int Dh, int S, int kv_len,
                             void* stream) {
  if (Dh != kDh) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(ca_launch(q, kv, labels, q_self, q_upper, ext, out,
                                    lse, B, G, N, H, S, kv_len,
                                    static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
