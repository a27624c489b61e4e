// The attention forward program of the PyTorch port for Hopper (sm_90a):
// TMA tile ring, wgmma, scores and output in registers. bf16 out, fp32
// softmax statistics, head dim 64.
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
//   K2(d) ca_fwd_q8 : the same against an 8-bit layer, template flag QUANT
//               (int8 or fp8 e4m3), the kv_scales variant of _ca_pallas
//               (must3r_tpu/ops/attention.py:627-757): kv8 [B, H, S, 128
//               bytes] codes (64 k codes, then 64 v codes), kv_scale [B, H,
//               2, S] fp32 per-key k and v scales (deq = code * scale). As
//               in the TPU kernel the k scale multiplies the score column,
//               s = (q . k_code) * softmax_scale * kscale[j]; the row max
//               and sum take p before the v scale, and p * vscale[j] is
//               rounded to bf16 for P.V. It composes with STATS and EXT.
//   K6 ca_fwd_2h : two heads per block, template argument HP = 2. Replaces
//               _ca_pallas_2h of scripts/bench_ca_kernel.py, the
//               microbenchmark's variant of _ca_pallas that runs a head pair
//               over one shared label DMA: one image of queries (q/out [B,
//               1, N, H, Dh], H even), the whole bf16 cache [L, B, H, S,
//               2*Dh] with a layer index (the layer's base is kv + layer * B
//               * H * S * 2*Dh elements), and the mask j < kv_len && label >=
//               0 alone: K2's predicate with q_self = -1 and q_upper =
//               INT32_MAX as compile-time constants (no ext, no LSE, no
//               8-bit cache).
//
// What bounds it: at every main-path shape (N = 768 for SA; 768..7680 query
// rows against 1536..7680 keys for CA) the work is ~4*Dh flops per (query,
// key) pair against 2*Dh*2 bytes per key per 64 query rows (K2(d): 2*Dh
// bytes of codes and 8 of scales): operations, on the bf16 tensor cores
// (PERF.md section 6). At Dh = 64 the exponentials weigh as much: one ex2
// per score on the SFU (16 a clock per SM) against 256 flops per score on
// the tensor cores, so the two have to overlap.
//
// The block program. A block owns NC / HP * 64 query rows of one
// batch*image and HP heads (HP = 1: NC = 1 or 3; HP = 2, K6: NC = 2): NC
// consumer warpgroups of 64 rows each (warpgroup wg takes head h + wg % HP
// and rows wg / HP), then one producer warpgroup whose first warp does all
// the loading (setmaxnreg gives the rest of its registers to the consumers).
//   - The producer loads the block's Q tiles once, then walks the key tiles
//     (64 keys each) through a ring of kRing stages. Per stage it waits
//     for "empty", computes the tile's allow vector from the labels (the
//     block belongs to one image, so one 64-bit mask serves all its rows
//     and both heads of a pair: K6's shared label tile), stores it beside
//     the stage and, unless the mask is 0 (the tile is skipped), starts two
//     TMA loads per head (K and V, 64 x 64 bf16 each, 128-byte swizzle)
//     that complete on the stage's "full" mbarrier.
//   - QUANT: the two TMA loads bring 64 x 64 bytes of codes each
//     (unswizzled) into a ring of code buffers of their own (full ->
//     code_empty), with the tile's mask. Warps 1..3 of the producer
//     warpgroup convert them: they wait for the codes and for the bf16
//     stage to be empty, write the 128-byte-swizzled bf16 K and V tiles
//     that the consumers' descriptors read (a key the mask does not attend
//     becomes 0 whatever its code, so a NaN code of a masked slot never
//     meets P.V), load the tile's 64 k and 64 v scales beside the mask with
//     plain loads (a TMA map of the fp32 [B, H, 2, S] scales would need
//     S * 4 to be a multiple of 16), fence the writes for the async proxy,
//     release the codes and arrive on "converted", which the consumers
//     wait for instead of "full". The codes are released as soon as they
//     are read, so TMA runs ahead of the conversion while the consumers
//     still hold their stages. A skipped tile is not converted, but passes
//     both rings. Both conversions are exact (int8: one byte permute builds
//     the float 2^23 + code + 128, one FADD takes 2^23 + 128 off, then
//     bf16; e4m3 -> f16x2 by cvt -> float -> bf16). The k scale is one
//     FMUL per score column, the v scale one on P before it becomes the
//     bf16 A fragment; a masked key's p is 0 by a select, so its scales
//     (NaN, inf, 1e30) are never used.
//   - Tensor maps are encoded on the host per launch
//     (cuTensorMapEncodeTiled, looked up in libcuda at run time with
//     cudaGetDriverEntryPoint: no -lcuda). q/k/v of SA and q of CA are 4-D
//     maps (Dh, H, N, B*G): a tile past N is zero-filled and never reads the
//     next image's rows. The CA layer [B, H, S, 2*Dh] is one map whose key
//     extent is kv_len, not S; K is the box at feature (or byte) 0 and V the
//     box at 64, so slots at or past kv_len arrive as zeros whatever they
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
//     memory; K6's writes its tile into its Q tile (read no more) with the
//     128-byte swizzle and stores it by TMA in whole 128-byte rows (4-byte
//     stores write 8 rows x 16 bytes a warp instruction, half a 32-byte
//     sector each: K6 was 3.5 % slower with them at the render on an H100).
//   - The two products overlap the softmax, as in FlashAttention-3: a tile's
//     S = Q K^T and the previous tile's O += P V go out together, the
//     softmax of the new S runs while P V is still on the tensor cores, and
//     only then is O rescaled. A tile waits one iteration for its P V, so
//     its stage is released one tile late; a skipped tile first finishes the
//     pending P V, so that no stage stays held while the ring comes round.
//
// Tiles, stages, shared memory: 64 keys a tile, kStages = 4 (K6: 6 of twice
// the size, 4 % faster than 4 at the render on an H100); per block NC * 8
// KB of Q + stages * HP * 16 KB of K/V (QUANT: + 4 * 8 KB of codes + 4 *
// 512 bytes of scales) + masks and barriers, on a 1 KB alignment: 75,776
// bytes (NC = 1) / 92,160 (NC = 3) of dynamic shared memory; QUANT 110,592
// / 126,976; K6 (NC = HP = 2) 215,040. Blocks per SM: 2 of 256 threads (NC =
// 1), 1 of 384 (K6) or 1 of 512 (NC = 3), by __launch_bounds__. Registers
// (-Xptxas -v, written to build/kernels/libattention_sm90_*.log): 128 a
// thread (K6: 168), the launch bound's, which is what ptxas allocates every
// warp's code within; setmaxnreg then gives the producer 24 (QUANT: 56, for
// the converters) and the consumers the rest. The launch chooses NC from
// the grid for K1 and K2 (see launch()); K6 always runs one 64-row tile of
// a head pair a block (72 blocks for one image of 768 rows x 12 heads,
// against K2's 144 of 64 rows: each SM then runs two consumer warpgroups
// either way).
//
// Semantics kept from the port's first kernels: a masked key's probability
// is forced to 0 (not exp(-1e30 - m)), so a query row with no attended key
// (every label masked, or kv_len == 0) returns 0, and its LSE is kEmptyLse
// (+1e30). The Pallas kernel returns the mean of V there (ROADMAP queue C).

#include <cuda_fp16.h>
#include <cuda_fp8.h>

#include "sm90.cuh"

using namespace must3r;
using namespace must3r::sm90;

namespace {

constexpr int kDh = 64;
constexpr int kRows = 64;                   // query rows per consumer warpgroup
constexpr int kKeys = 64;                   // keys per tile
constexpr int kStages = 4;
constexpr int kStagesPair = 6;              // K6: both heads' tiles a stage
constexpr int kWG = 128;                    // threads per warpgroup
constexpr int kTileBytes = 64 * kDh * 2;    // one 64 x 64 bf16 tile
constexpr int kCodeBytes = 64 * kDh;        // one 64 x 64 tile of 8-bit codes
// QUANT: the format of an 8-bit layer (K2(d)); 0 is a bf16 layer
constexpr int kQ8Int8 = 1;
constexpr int kQ8Fp8 = 2;
constexpr int kConverters = 3 * 32;         // warps 1..3 of the producer

// Blocks per SM and the registers after setmaxnreg: the producer's and the
// consumers' counts stay within what the launch bound gives the block
// (65536 / blocks per SM; 128 a thread at NC = 1 or 3, 168 at NC = 2, which
// is also what ptxas allocates within). With QUANT the producer warpgroup's
// spare warps convert codes, and keep 56 a thread for it.
template <int NC, int QUANT>
struct Config {
  static constexpr int kThreads = (NC + 1) * kWG;
  static constexpr int kMinBlocks = NC == 1 ? 2 : 1;
  static constexpr int kProducerRegs = QUANT ? 56 : 24;
  static constexpr int kConsumerRegs =
      NC == 1 ? (QUANT ? 200 : 232)
              : NC == 2 ? 240 : (QUANT ? 152 : 160);
  static_assert(NC >= 1 && NC <= 3, "one to three consumer warpgroups");
  static_assert(kProducerRegs * kWG + NC * kWG * kConsumerRegs <=
                    65536 / kMinBlocks,
                "setmaxnreg must stay within the block's registers");
};

template <int NC, int QUANT, int HP>
struct Smem {
  static constexpr int kRing = HP == 2 ? kStagesPair : kStages;
  static constexpr int kCodeStages = QUANT ? kRing : 1;
  // 1 KB alignment: the 128-byte swizzle repeats every 8 rows of 128 bytes,
  // and the wgmma descriptors assume tiles start on that period; a stage
  // holds the K and V tiles of each of the block's HP heads
  alignas(1024) __nv_bfloat16 q[NC][kRows * kDh];
  alignas(1024) __nv_bfloat16 k[kRing][HP][kKeys * kDh];
  alignas(1024) __nv_bfloat16 v[kRing][HP][kKeys * kDh];
  // QUANT: a tile's codes as TMA wrote them (64 keys x 64 bytes, K and V)
  // in a ring of their own, with the tile's mask; the bf16 stage's k and v
  // scales, in the order the consumers read them: column 8j + 2 * quad + e
  // has its k scale at (4j + quad) * 4 + e and its v scale 2 further, so a
  // thread reads both scales of its column pair in one 16-byte load
  alignas(128) uint8_t kc[kCodeStages][QUANT ? kCodeBytes : 16];
  alignas(128) uint8_t vc[kCodeStages][QUANT ? kCodeBytes : 16];
  alignas(16) float scl[kCodeStages][QUANT ? 2 * kKeys : 4];
  uint64_t code_mask[kCodeStages];
  uint64_t code_empty[kCodeStages];         // QUANT: the codes were read
  uint64_t mask[kRing];                     // bit j: key j0 + j attended
  uint64_t full[kRing];                     // (QUANT: the codes arrived)
  uint64_t conv[kRing];                     // QUANT: the stage is bf16
  uint64_t empty[kRing];
  uint64_t q_full;
};

// 8 codes (8 bytes) -> 8 bf16 (16 bytes); both conversions are exact: an
// int8 through float (|code| <= 128 fits bf16's 8-bit significand), an
// e4m3 through f16x2 (cvt) and float (3 mantissa bits, a narrower exponent
// range than bf16's). The int8 path builds the float 2^23 + (code + 128)
// with one byte permute and subtracts 2^23 + 128, instead of an I2F a code.
template <int QUANT>
__device__ __forceinline__ uint4 codes8_to_bf16(uint2 raw) {
  uint32_t w[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const uint32_t word = e < 2 ? raw.x : raw.y;
    float lo, hi;
    if constexpr (QUANT == kQ8Int8) {
      const uint32_t biased = word ^ 0x80808080u;     // code + 128, per byte
      const uint32_t sel = 0x7650u + 2 * (e & 1);
      lo = __uint_as_float(__byte_perm(biased, 0x4B000000u, sel)) -
           8388736.f;
      hi = __uint_as_float(__byte_perm(biased, 0x4B000000u, sel + 1)) -
           8388736.f;
    } else {
      const uint32_t pair = (word >> (16 * (e & 1))) & 0xFFFFu;
      const __half2_raw h2 = __nv_cvt_fp8x2_to_halfraw2(
          static_cast<__nv_fp8x2_storage_t>(pair), __NV_E4M3);
      const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&h2));
      lo = f.x;
      hi = f.y;
    }
    // the bf16 pair is the high halves of the two floats: exact, since
    // their low 16 bits are 0 (at most 8 significant bits)
    w[e] = __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
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
//   QUANT != 0: that layer holds 8-bit codes (the map is UINT8, unswizzled,
//   V at byte 64) and kv_scale [B, H, 2, S] its per-key k and v scales.
//   HP = 2 (K6): blockIdx.y is a head pair, q_self / q_upper are not read.
// Accumulator register d[4j + 2i + e] of a thread holds row
// 16 * warp + lane / 4 + 8i and column 8j + 2 * (lane % 4) + e.
template <bool CA, bool STATS, bool EXT, int QUANT, int NC, int HP>
__global__ void __launch_bounds__(Config<NC, QUANT>::kThreads,
                                  Config<NC, QUANT>::kMinBlocks)
attn_fwd_sm90(const __grid_constant__ CUtensorMap qmap,
              const __grid_constant__ CUtensorMap kmap,
              const __grid_constant__ CUtensorMap vmap,
              const __grid_constant__ CUtensorMap omap,
              const float* __restrict__ kv_scale,
              const int32_t* __restrict__ labels,
              const int32_t* __restrict__ q_self,
              const int32_t* __restrict__ q_upper,
              const uint8_t* __restrict__ ext,
              __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int G,
              int N, int H, int S, int n_keys, float scale) {
  static_assert(HP == 1 ? NC != 2
                        : HP == 2 && NC == 2 && CA && !STATS && !EXT &&
                              QUANT == 0,
                "a head pair (K6) is two consumer warpgroups of the bf16 CA");
  using C = Config<NC, QUANT>;
  using Layout = Smem<NC, QUANT, HP>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t pad = (1024u - (smem_u32(smem_raw) & 1023u)) & 1023u;
  Layout& sm = *reinterpret_cast<Layout*>(smem_raw + pad);

  const int wg = threadIdx.x / kWG;
  const int q0 = blockIdx.x * (NC / HP * kRows);
  const int h = blockIdx.y * HP;            // the block's (first) head
  const int bz = blockIdx.z;                // batch * G + image
  const int b = CA ? bz / G : bz;
  const int n_tiles = (n_keys + kKeys - 1) / kKeys;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < Layout::kRing; ++s) {
      mbar_init(&sm.full[s], 1);
      if (QUANT) {
        mbar_init(&sm.conv[s], kConverters);
        mbar_init(&sm.code_empty[s], kConverters);
      }
      mbar_init(&sm.empty[s], NC * kWG);
    }
    mbar_init(&sm.q_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == NC) {
    // ------- producer warpgroup: warp 0 loads, with QUANT 1..3 convert -------
    regs_dec<C::kProducerRegs>();
    const int warp = (threadIdx.x % kWG) / 32;
    const int lane = threadIdx.x % 32;
    if (warp == 0) {
      if (lane == 0) {
        mbar_expect_tx(&sm.q_full, NC * kTileBytes);
#pragma unroll
        for (int c = 0; c < NC; ++c)
          tma_load_4d(sm.q[c], &qmap, &sm.q_full, 0, h + c % HP,
                      q0 + c / HP * kRows, bz);
      }
      // K6 attends every live label: K2's predicate with these constants
      const int qs = !CA ? 0 : HP == 1 ? q_self[bz] : -1;
      const int qu = !CA ? 0 : HP == 1 ? q_upper[bz] : INT32_MAX;
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
        mbar_wait(QUANT ? &sm.code_empty[stage] : &sm.empty[stage],
                  phase ^ 1);
        if (lane == 0) {
          const uint64_t mask = lo | (static_cast<uint64_t>(hi) << 32);
          (QUANT ? sm.code_mask : sm.mask)[stage] = mask;
          if (mask != 0) {
            if constexpr (QUANT != 0) {
              mbar_expect_tx(&sm.full[stage], 2 * kCodeBytes);
              tma_load_4d(sm.kc[stage], &kmap, &sm.full[stage], 0, j0, h, b);
              tma_load_4d(sm.vc[stage], &vmap, &sm.full[stage], kDh, j0, h,
                          b);
            } else if constexpr (CA) {
              mbar_expect_tx(&sm.full[stage], 2 * HP * kTileBytes);
#pragma unroll
              for (int hp = 0; hp < HP; ++hp) {
                tma_load_4d(sm.k[stage][hp], &kmap, &sm.full[stage], 0, j0,
                            h + hp, b);
                tma_load_4d(sm.v[stage][hp], &vmap, &sm.full[stage], kDh, j0,
                            h + hp, b);
              }
            } else {
              mbar_expect_tx(&sm.full[stage], 2 * kTileBytes);
              tma_load_4d(sm.k[stage][0], &kmap, &sm.full[stage], 0, h, j0,
                          b);
              tma_load_4d(sm.v[stage][0], &vmap, &sm.full[stage], 0, h, j0,
                          b);
            }
          } else {
            mbar_arrive(&sm.full[stage]);   // nothing attended: skip
          }
        }
        __syncwarp();
        if (++stage == Layout::kRing) {
          stage = 0;
          phase ^= 1;
        }
      }
    } else if constexpr (QUANT != 0) {
      // Converters: each tile's codes -> the 128-byte-swizzled bf16 K and V
      // tiles that the consumers' descriptors read (a key that the mask
      // does not attend becomes 0, whatever its code), with the tile's
      // mask and scales beside them. The codes have a ring of their own,
      // released as soon as they are read, so TMA runs ahead of the
      // conversion while the consumers still hold bf16 stages. A skipped
      // tile is not converted; its stages are passed on all the same.
      const int ct = threadIdx.x % kWG - 32;
      const float* ksc = kv_scale + (size_t)(b * H + h) * 2 * S;
      int stage = 0;
      uint32_t phase = 0;
      for (int t = 0; t < n_tiles; ++t) {
        mbar_wait(&sm.full[stage], phase);
        mbar_wait(&sm.empty[stage], phase ^ 1);
        const uint64_t mask = sm.code_mask[stage];
        if (ct == 0) sm.mask[stage] = mask;
        if (mask != 0) {
          if (ct < kKeys) {
            const int j = t * kKeys + ct;
            float* dst = &sm.scl[stage][(4 * (ct >> 3) + ((ct & 7) >> 1)) * 4 +
                                        (ct & 1)];
            dst[0] = j < n_keys ? ksc[j] : 0.f;
            dst[2] = j < n_keys ? ksc[S + j] : 0.f;
          }
#pragma unroll 2
          for (int u = ct; u < kKeys * 8; u += kConverters) {
            const int r = u >> 3;
            const int c = u & 7;
            uint4 kb = make_uint4(0u, 0u, 0u, 0u), vb = kb;
            if ((mask >> r) & 1) {
              kb = codes8_to_bf16<QUANT>(*reinterpret_cast<const uint2*>(
                  sm.kc[stage] + r * kDh + c * 8));
              vb = codes8_to_bf16<QUANT>(*reinterpret_cast<const uint2*>(
                  sm.vc[stage] + r * kDh + c * 8));
            }
            const int off = sw128_offset(r, c);
            *reinterpret_cast<uint4*>(
                reinterpret_cast<uint8_t*>(sm.k[stage][0]) + off) = kb;
            *reinterpret_cast<uint4*>(
                reinterpret_cast<uint8_t*>(sm.v[stage][0]) + off) = vb;
          }
          fence_proxy_async();              // the tiles are wgmma operands
        }
        mbar_arrive(&sm.code_empty[stage]);
        mbar_arrive(&sm.conv[stage]);
        if (++stage == Layout::kRing) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ------- consumer warpgroup wg: 64 query rows of head h + wg % HP -------
    regs_inc<C::kConsumerRegs>();
    const int t = threadIdx.x % kWG;
    const int warp = t / 32;
    const int lane = t % 32;
    const int quad = lane % 4;
    const int hw = wg % HP;                   // the head within the block
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
      const uint64_t dv = sw128_desc(sm.v[prev][hw]);
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
      mbar_wait(QUANT ? &sm.conv[stage] : &sm.full[stage], phase);
      const uint64_t mask = sm.mask[stage];   // uniform across the block
      if (mask != 0) {
        // S = Q K^T (4 steps of 16 features, 32 bytes along a row), and
        // behind it the previous tile's O += P V (4 steps of 16 keys, 16
        // rows of 128 bytes of V): the softmax of this tile runs while the
        // tensor cores do that product.
        float s[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] = 0.f;
        const uint64_t dk = sw128_desc(sm.k[stage][hw]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kDh / 16; ++kk)
          wgmma_ss(s, dq + 2 * kk, dk + 2 * kk, kk > 0);
        wgmma_commit();
        if (prev >= 0) {
          const uint64_t dv = sw128_desc(sm.v[prev][hw]);
#pragma unroll
          for (int kk = 0; kk < kKeys / 16; ++kk)
            wgmma_rs(o, p_prev[kk], dv + 128 * kk);
          wgmma_commit();
          wgmma_wait<1>();                    // S is done, P.V may run on
        } else {
          wgmma_wait<0>();
        }
        reg_fence(s);
        float2 vsc[QUANT ? 8 : 1];            // QUANT: the v scales
        if constexpr (QUANT != 0) {
          // the k scale multiplies the score column (one FMUL a score); a
          // masked key's scale may be anything, and its score is not used
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float4 kv = *reinterpret_cast<const float4*>(
                &sm.scl[stage][(4 * j + quad) * 4]);
            vsc[j] = make_float2(kv.z, kv.w);
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              s[4 * j + 2 * i] *= kv.x;
              s[4 * j + 2 * i + 1] *= kv.y;
            }
          }
        }
        const bool full = mask == ~0ull;
        if (full)
          softmax.update<true>(s, mask, quad, sl2);
        else
          softmax.update<false>(s, mask, quad, sl2);
        if constexpr (QUANT != 0) {
          // P.V takes p * vscale[j] (the row sum took p before it); a masked
          // key's p stays 0 by a select, so its scale is never used
          const uint64_t mq = mask >> (2 * quad);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float2 vj = vsc[j];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const int r = 4 * j + 2 * i;
              s[r] = full || ((mq >> (8 * j)) & 1) ? s[r] * vj.x : 0.f;
              s[r + 1] = full || ((mq >> (8 * j + 1)) & 1) ? s[r + 1] * vj.y
                                                            : 0.f;
            }
          }
        }
        wgmma_wait<0>();
        reg_fence(o);
        reg_fence(p_prev);
        if (prev >= 0) mbar_arrive(&sm.empty[prev]);
#pragma unroll
        for (int r = 0; r < 32; ++r) o[r] *= softmax.corr[(r >> 1) & 1];
        acc_to_a(s, p_prev);                  // P as bf16 A fragments
        prev = stage;
      } else {
        // nothing attended: skipped. The pending P.V is finished first, so
        // that no stage stays held while the ring comes round to it.
        finish_pv();
        mbar_arrive(&sm.empty[stage]);
      }
      if (++stage == Layout::kRing) {
        stage = 0;
        phase ^= 1;
      }
    }
    finish_pv();                              // the last tile's P.V

    // epilogue: normalise and store; a row with nothing attended has
    // l == 0 and a zero accumulator, so it writes 0
    if constexpr (HP == 2) {
      // K6: into the warpgroup's Q tile (read no more) as 64 rows of 128
      // bytes with the 128-byte swizzle, then one TMA store of whole rows
      // (rows past N are not written)
      uint8_t* tile = reinterpret_cast<uint8_t*>(sm.q[wg]);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float l = softmax.l[i];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        const float inv = 1.f / fmaxf(l, 1e-30f);
        const int r = warp * 16 + lane / 4 + 8 * i;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<uint32_t*>(tile + sw128_offset(r, j) +
                                       4 * quad) =
              pack_bf16(o[4 * j + 2 * i] * inv, o[4 * j + 2 * i + 1] * inv);
      }
      fence_proxy_async();                  // the tile is TMA's source
      named_sync(1 + wg, kWG);
      if (t == 0) {
        tma_store_4d(&omap, tile, 0, h + hw, q0 + wg / HP * kRows, bz);
        tma_commit();
        tma_wait_read<0>();                 // before the block's exit
      }
      return;
    }
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

// the 8-bit layer [B, H, S, 128 bytes] cut at kv_len: dims (128, kv_len, H,
// B), boxes of 64 bytes x 64 keys (K codes at byte 0, V at 64), unswizzled
bool encode_code_layer(CUtensorMap* map, const void* base, int b, int h,
                       int s, int kv_len) {
  const cuuint64_t row = 2 * kDh;
  return encode_4d(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, base,
                   {2 * kDh, (cuuint64_t)(kv_len > 0 ? kv_len : 1),
                    (cuuint64_t)h, (cuuint64_t)b},
                   {row, row * s, row * s * h}, {kDh, 64, 1, 1},
                   CU_TENSOR_MAP_SWIZZLE_NONE);
}

template <bool CA, bool STATS, bool EXT, int QUANT, int NC, int HP = 1>
cudaError_t launch_nc(const CUtensorMap& qm, const CUtensorMap& km,
                      const CUtensorMap& vm, const CUtensorMap& om,
                      const void* kv_scale,
                      const void* labels, const void* q_self,
                      const void* q_upper, const void* ext, void* out,
                      void* lse, int bg, int G, int N, int H, int S,
                      int n_keys, cudaStream_t stream) {
  using C = Config<NC, QUANT>;
  constexpr int smem = sizeof(Smem<NC, QUANT, HP>) + 1024;  // + alignment
  auto kernel = attn_fwd_sm90<CA, STATS, EXT, QUANT, NC, HP>;
  // the attribute belongs to the current device: set on every launch
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  constexpr int rows = NC / HP * kRows;     // query rows per block
  dim3 grid((N + rows - 1) / rows, H / HP, bg);
  kernel<<<grid, C::kThreads, smem, stream>>>(
      qm, km, vm, om, static_cast<const float*>(kv_scale),
      static_cast<const int32_t*>(labels),
      static_cast<const int32_t*>(q_self),
      static_cast<const int32_t*>(q_upper), static_cast<const uint8_t*>(ext),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), G, N, H, S,
      n_keys, 1.0f / sqrtf(static_cast<float>(kDh)));
  return cudaGetLastError();
}

// Rows per block: 192 (three consumer warpgroups sharing each K/V stage)
// or 64, by consumers_per_block (sm90.cuh).
template <bool CA, bool STATS, bool EXT, int QUANT>
cudaError_t launch(const CUtensorMap& qm, const CUtensorMap& km,
                   const CUtensorMap& vm, const void* kv_scale,
                   const void* labels, const void* q_self,
                   const void* q_upper, const void* ext, void* out, void* lse,
                   int bg, int G, int N, int H, int S, int n_keys,
                   cudaStream_t stream) {
  int nc = 1;
  const cudaError_t err = consumers_per_block(N, (long long)H * bg, &nc);
  if (err != cudaSuccess) return err;
  if (nc == 3)
    return launch_nc<CA, STATS, EXT, QUANT, 3>(
        qm, km, vm, qm, kv_scale, labels, q_self, q_upper, ext, out, lse, bg,
        G, N, H, S, n_keys, stream);
  return launch_nc<CA, STATS, EXT, QUANT, 1>(
      qm, km, vm, qm, kv_scale, labels, q_self, q_upper, ext, out, lse, bg, G,
      N, H, S, n_keys, stream);
}

// The CA variants: STATS when lse is not null, EXT when ext is not null;
// QUANT with an 8-bit layer and its scales.
template <int QUANT>
cudaError_t ca_launch(const void* q, const void* kv, const void* kv_scale,
                      const void* labels, const void* q_self,
                      const void* q_upper, const void* ext, void* out,
                      void* lse, int B, int G, int N, int H, int S,
                      int kv_len, cudaStream_t st) {
  CUtensorMap qm, kvm;
  const bool kv_ok = QUANT ? encode_code_layer(&kvm, kv, B, H, S, kv_len)
                           : encode_layer(&kvm, kv, B, H, S, kv_len);
  if (!encode_rows(&qm, q, B * G, N, H) || !kv_ok)
    return cudaErrorInvalidValue;
  const int bg = B * G;
#define MUST3R_CA(STATS, EXT)                                                \
  launch<true, STATS, EXT, QUANT>(qm, kvm, kvm, kv_scale, labels, q_self,    \
                                  q_upper, ext, out, lse, bg, G, N, H, S,    \
                                  kv_len, st)
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
  return static_cast<int>(launch<false, false, false, 0>(
      qm, km, vm, nullptr, nullptr, nullptr, nullptr, nullptr, out, nullptr,
      B, 1, N, H, 0, N, static_cast<cudaStream_t>(stream)));
}

int must3r_ca_fwd_bf16(const void* q, const void* kv, const void* labels,
                       const void* q_self, const void* q_upper, void* out,
                       int B, int G, int N, int H, int Dh, int S, int kv_len,
                       void* stream) {
  if (Dh != kDh) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(ca_launch<0>(q, kv, nullptr, labels, q_self,
                                       q_upper, nullptr, out, nullptr, B, G,
                                       N, H, S, kv_len,
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
  return static_cast<int>(ca_launch<0>(q, kv, nullptr, labels, q_self,
                                       q_upper, ext, out, lse, B, G, N, H, S,
                                       kv_len,
                                       static_cast<cudaStream_t>(stream)));
}

// K2(d): the 8-bit layer read. kv8 [B, H, S, 2*Dh] codes (fmt 1 = int8,
// 2 = fp8 e4m3; 16-byte aligned), kv_scale [B, H, 2, S] fp32; lse (fp32
// [B, G, H, N]) written when not null, ext (bool [B, G, S]) read when not
// null.
int must3r_ca_fwd_q8(const void* q, const void* kv8, const void* kv_scale,
                     const void* labels, const void* q_self,
                     const void* q_upper, const void* ext, void* out,
                     void* lse, int B, int G, int N, int H, int Dh, int S,
                     int kv_len, int fmt, void* stream) {
  if (Dh != kDh || (fmt != kQ8Int8 && fmt != kQ8Fp8))
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      fmt == kQ8Int8
          ? ca_launch<kQ8Int8>(q, kv8, kv_scale, labels, q_self, q_upper, ext,
                               out, lse, B, G, N, H, S, kv_len, st)
          : ca_launch<kQ8Fp8>(q, kv8, kv_scale, labels, q_self, q_upper, ext,
                              out, lse, B, G, N, H, S, kv_len, st));
}

// K6: q / out [B, 1, N, H, Dh] bf16 (H even), kv the whole packed cache
// [L, B, H, S, 2*Dh] bf16 with the layer to read, labels [B, S] int32.
int must3r_ca_fwd_2h_bf16(const void* q, const void* kv, const void* labels,
                          void* out, int B, int N, int H, int Dh, int S,
                          int kv_len, int layer, void* stream) {
  if (Dh != kDh || H % 2 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const __nv_bfloat16* layer_kv = static_cast<const __nv_bfloat16*>(kv) +
                                  (size_t)layer * B * H * S * (2 * kDh);
  CUtensorMap qm, kvm, om;
  if (!encode_rows(&qm, q, B, N, H) ||
      !encode_layer(&kvm, layer_kv, B, H, S, kv_len) ||
      !encode_rows(&om, out, B, N, H))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_nc<true, false, false, 0, 2, 2>(
      qm, kvm, kvm, om, nullptr, labels, nullptr, nullptr, nullptr, out,
      nullptr, B, 1, N, H, S, kv_len, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
