// K7 ln_matmul: LayerNorm then a matmul in one launch, hand-written for
// Hopper (sm_90a) as a TMA + wgmma program, bf16 in / bf16 out.
//
//   out[m, :] = bf16( bf16( (x[m, :] - mean) * rsqrt(var + 1e-6) * g + b )
//                     @ w )
//
// with the row mean and the population variance of (x - mean) in fp32 (two
// passes), the normalised row rounded to bf16 (x's dtype) and the product
// accumulated in fp32. x [M, K], g / b [K], w [K, N], out [M, N], all bf16
// and contiguous; no residual is added. Replaces pallas_ln_matmul of
// scripts/bench_fused_chain.py, the microbenchmark that asks whether
// folding the decoder block's LayerNorm into the following linear pays.
//
// What bounds it: at the microbenchmark's shapes (K = 768, N = 2304 /
// 3072, M = 1024 / 3072) the product does 2 * M * K * N flops against (M *
// K + K * N + M * N) * 2 bytes, ~370-490 flops a byte: the tensor cores at
// the bound. Below it, the tiles' traffic from L2 (x is read once per
// column tile, w once per row tile) and the normalisation's fp32 work
// (about half of the tensor cores' time per chunk at 192 columns) have to
// hide behind the products.
//
// Two kernels, one launch of the C entry:
//   - ln_row_stats: the statistics of every row, once: one warp a row, 16
//     bytes a lane, the mean, then the mean of (x - mean)^2 from a second
//     read of the warp's row (L1), in fp32; mean and rstd into a scratch
//     [M, 2] fp32 buffer. (A statistics prologue in each block of the
//     product would read the block's 128 rows again for every column tile,
//     12 to 18 of them here, in latency-bound rounds before its first
//     product.) The product is a programmatic dependent launch: its blocks
//     start, stage g and b and fill the ring while the statistics are
//     computed, and its consumers wait for them (griddepcontrol.wait) only
//     where they read them.
//   - ln_matmul_sm90, the product. A block owns 128 rows x 64 * NB columns
//     of out (NB = 2 or 3): two consumer warpgroups of 64 rows that share
//     each w stage, then one producer warpgroup whose first thread does all
//     the loading.
//   - The producer walks K in 64-deep chunks through a ring of stages: per
//     stage it waits for "empty" and starts one TMA load of the
//     x chunk [128 rows x 64] and NB of the w chunk [64 x 64 columns], all
//     with the 128-byte swizzle, completing on the stage's "full" mbarrier.
//     x rows past M arrive as zeros. A w box has the layout of K2's V tile:
//     64 rows of 128 bytes along N, so B is MN-major (the transposed-B flag).
//   - Before its first chunk, the consumers stage g and b once as fp32
//     pairs in shared memory, and each thread reads mean and rstd of its
//     two accumulator rows from the scratch buffer into registers. They are
//     never recomputed per chunk.
//   - Per chunk, a consumer reads its two rows of the swizzled x chunk in
//     the m64 A-fragment layout (a 4-byte bf16 pair per read, conflict-free),
//     applies (x - mean) * rstd * g + b in fp32, rounds to bf16 pairs (the A
//     fragments), and issues 4 * NB wgmma.m64n64k16 with A from registers
//     and B from the w stage. The next chunk is normalised while these run
//     (two A fragment sets); the stage is released when they are done.
//   - NB fp32 accumulators of 32 registers hold the consumer's 64 x 64 * NB
//     tile until the epilogue. It rounds them to bf16 into shared memory
//     (the ring, free by then) as NB boxes of 64 rows of 128 bytes with the
//     128-byte swizzle, and one TMA store a box writes whole rows; rows
//     past M are not written. (4-byte stores straight from the registers,
//     8 rows x 16 bytes a warp instruction, half a 32-byte sector each, made
//     the kernel a quarter slower at the bench's shapes on an H100.)
//
// Columns per block: 192 (NB = 3) where N is a multiple of 192 and fewer
// waves of blocks result (ceil(blocks / SMs) * NB is smaller), else 128: at
// M = 1024, N = 2304 that is 96 blocks in one wave instead of 144 in two.
// Shared memory: 4 stages of 16 KB of x + NB * 8 KB of w, then g and b (K *
// 8 bytes) and the barriers, on a 1 KB alignment: 171,072 bytes at NB = 3,
// K = 768. One block of 384 threads an SM; ptxas allocates within the
// launch bound's 168 registers a thread. Limits: K a multiple of 64 and at
// most 8192 (g and b in shared memory beside the ring), N a multiple of
// 128.

#include "sm90.cuh"

using namespace must3r;
using namespace must3r::sm90;

namespace {

constexpr int kRows = 128;                  // rows of out per block
constexpr int kChunk = 64;                  // K per stage
constexpr int kStages = 4;
constexpr int kWG = 128;
constexpr int kConsumers = 2;               // warpgroups of 64 rows
constexpr int kThreads = (kConsumers + 1) * kWG;
constexpr int kXBytes = kRows * kChunk * 2;
constexpr int kBoxBytes = kChunk * 64 * 2;  // one 64 x 64 box of w
constexpr int kMaxK = 8192;
constexpr float kLnEps = 1e-6f;
constexpr int kStatsRows = 8;               // rows (warps) a statistics block

// The shared memory of a block from a 1 KB boundary (the 128-byte swizzle
// repeats every 8 rows of 128 bytes, and the wgmma descriptors assume tiles
// start on that period): kStages ring stages, each the x chunk and then NB
// w boxes; g and b as K / 2 float4 {g[2c], g[2c + 1], b[2c], b[2c + 1]};
// the stages' "full" and "empty" barriers.
template <int NB>
struct Ring {
  static constexpr int kStageBytes = kXBytes + NB * kBoxBytes;
  uint8_t* base;
  int K;

  __device__ __nv_bfloat16* x(int s) const {
    return reinterpret_cast<__nv_bfloat16*>(base + s * kStageBytes);
  }
  __device__ __nv_bfloat16* w(int s, int nb) const {
    return reinterpret_cast<__nv_bfloat16*>(base + s * kStageBytes +
                                            kXBytes + nb * kBoxBytes);
  }
  __device__ float4* gb() const {
    return reinterpret_cast<float4*>(base + kStages * kStageBytes);
  }
  __device__ uint64_t* full(int s) const {
    return reinterpret_cast<uint64_t*>(gb() + K / 2) + s;
  }
  __device__ uint64_t* empty(int s) const { return full(kStages) + s; }

  // the bytes to ask for (+ 1 KB of alignment slack)
  static int bytes(int K) {
    return 1024 + kStages * kStageBytes + K * 8 + 16 * kStages;
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ uint4 ldg16(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// The 8 bf16 of a 16-byte load as floats: lo and hi halves of each word.
__device__ __forceinline__ void unpack8(uint4 raw, float (&f)[8]) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    f[2 * e] = __uint_as_float(w[e] << 16);
    f[2 * e + 1] = __uint_as_float(w[e] & 0xFFFF0000u);
  }
}

// LayerNorm statistics, one warp a row, 16 bytes a lane: the mean, then
// the mean of (x - mean)^2 from a second read of the row (L1), in fp32;
// stats[m] = (mean, rsqrt(var + eps)).
__global__ void __launch_bounds__(kStatsRows * 32)
ln_row_stats(const __nv_bfloat16* __restrict__ x, float2* __restrict__ stats,
             int M, int K) {
  // the product may start now: it waits for these statistics where it reads
  // them (griddepcontrol.wait), and loads its tiles meanwhile
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int m = blockIdx.x * kStatsRows + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (m >= M) return;
  const __nv_bfloat16* row = x + (size_t)m * K;
  const float inv_k = 1.f / static_cast<float>(K);
  float s = 0.f, sq = 0.f, f[8];
#pragma unroll 4
  for (int c = lane * 8; c < K; c += 256) {
    unpack8(ldg16(row + c), f);
#pragma unroll
    for (int e = 0; e < 8; ++e) s += f[e];
  }
  const float mean = warp_sum(s) * inv_k;
#pragma unroll 4
  for (int c = lane * 8; c < K; c += 256) {
    unpack8(ldg16(row + c), f);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float dv = f[e] - mean;
      sq += dv * dv;
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) * inv_k + kLnEps);
  if (lane == 0) stats[m] = make_float2(mean, rstd);
}

// The bf16 A fragments of one 64-deep chunk for this thread's rows `row`
// and row + 8 of the 128-row x stage (128-byte swizzled, as TMA wrote it):
// a[kk][2h + i] holds row + 8i, columns 16kk + 8h + 2 * quad and the next,
// (x - mean) * rstd * g + b in fp32 rounded to a bf16 pair. gb holds the
// chunk's 32 column pairs of g and b.
__device__ __forceinline__ void normalise(const uint8_t* xs,
                                          const float4* gb, int row,
                                          int quad, const float (&mean)[2],
                                          const float (&rstd)[2],
                                          uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 p = gb[8 * kk + 4 * h + quad];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const uint32_t u = *reinterpret_cast<const uint32_t*>(
            xs + sw128_offset(row + 8 * i, 2 * kk + h) + 4 * quad);
        const float x0 = __uint_as_float(u << 16);
        const float x1 = __uint_as_float(u & 0xFFFF0000u);
        a[kk][2 * h + i] =
            pack_bf16(fmaf((x0 - mean[i]) * rstd[i], p.x, p.z),
                      fmaf((x1 - mean[i]) * rstd[i], p.y, p.w));
      }
    }
}

// Accumulator register d[nb][4j + 2i + e] of a thread holds row 16 * warp +
// lane / 4 + 8i of its warpgroup's 64 and column 64 nb + 8j + 2 * (lane %
// 4) + e of the block's.
template <int NB>
__global__ void __launch_bounds__(kThreads, 1)
ln_matmul_sm90(const __grid_constant__ CUtensorMap xmap,
               const __grid_constant__ CUtensorMap wmap,
               const __grid_constant__ CUtensorMap omap,
               const float2* __restrict__ stats,
               const __nv_bfloat16* __restrict__ g,
               const __nv_bfloat16* __restrict__ b, int M, int K) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t pad = (1024u - (smem_u32(smem_raw) & 1023u)) & 1023u;
  const Ring<NB> ring{smem_raw + pad, K};
  float4* gb = ring.gb();

  const int wg = threadIdx.x / kWG;
  const int n0 = blockIdx.x * (64 * NB);
  const int m0 = blockIdx.y * kRows;
  const int n_chunks = K / kChunk;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(ring.full(s), 1);
      mbar_init(ring.empty(s), kConsumers * kWG);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---------------- producer: one thread loads ----------------
    if (threadIdx.x % kWG != 0) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int c = 0; c < n_chunks; ++c) {
      mbar_wait(ring.empty(stage), phase ^ 1);
      mbar_expect_tx(ring.full(stage), Ring<NB>::kStageBytes);
      tma_load_2d(ring.x(stage), &xmap, ring.full(stage), c * kChunk, m0);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
        tma_load_2d(ring.w(stage, nb), &wmap, ring.full(stage), n0 + 64 * nb,
                    c * kChunk);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    return;
  }

  // ------------- consumer warpgroup wg: rows 64 wg .. 64 wg + 63 -------------
  const int t = threadIdx.x % kWG;
  const int warp = t / 32;
  const int lane = t % 32;
  const int quad = lane % 4;
  const int row = wg * 64 + warp * 16 + lane / 4;   // in the block's 128

  // g and b once per block, as fp32 pairs beside the ring
  for (int i = threadIdx.x; i < K / 2; i += kConsumers * kWG) {
    const __nv_bfloat162 gg = reinterpret_cast<const __nv_bfloat162*>(g)[i];
    const __nv_bfloat162 bb = reinterpret_cast<const __nv_bfloat162*>(b)[i];
    gb[i] = make_float4(__low2float(gg), __high2float(gg), __low2float(bb),
                        __high2float(bb));
  }
  // mean and rstd of this thread's rows (rows past M: 0 and 1, not written),
  // once the statistics kernel is complete
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  float mean[2] = {0.f, 0.f}, rstd[2] = {1.f, 1.f};
#pragma unroll
  for (int i = 0; i < 2; ++i)
    if (m0 + row + 8 * i < M) {
      const float2 st = stats[m0 + row + 8 * i];
      mean[i] = st.x;
      rstd[i] = st.y;
    }
  named_sync(1, kConsumers * kWG);          // g and b are staged

  float d[NB][32];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) d[nb][i] = 0.f;
  uint32_t a0[4][4], a1[4][4];              // this chunk's A, the next one's

  int stage = 0;
  uint32_t phase = 0;
  auto build = [&](int c, int st, uint32_t ph, uint32_t (&a)[4][4]) {
    mbar_wait(ring.full(st), ph);
    normalise(reinterpret_cast<const uint8_t*>(ring.x(st)), gb + 32 * c, row,
              quad, mean, rstd, a);
  };
  // out += A(chunk c) w(chunk c), the next chunk normalised meanwhile
  auto step = [&](int c, uint32_t (&a)[4][4], uint32_t (&a_next)[4][4]) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
        wgmma_rs(d[nb], a[kk], sw128_desc(ring.w(stage, nb)) + 128 * kk);
    wgmma_commit();
    const int next = stage + 1 == kStages ? 0 : stage + 1;
    const uint32_t next_phase = next == 0 ? phase ^ 1 : phase;
    if (c + 1 < n_chunks) build(c + 1, next, next_phase, a_next);
    wgmma_wait<0>();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) reg_fence(d[nb]);
    reg_fence(a);
    mbar_arrive(ring.empty(stage));
    stage = next;
    phase = next_phase;
  };
  build(0, 0, 0, a0);
  for (int c = 0; c < n_chunks; c += 2) {
    step(c, a0, a1);
    if (c + 1 < n_chunks) step(c + 1, a1, a0);
  }

  // epilogue: the warpgroup's bf16 64 x 64 NB tile into shared memory (the
  // ring, once both warpgroups are past their products) as NB boxes of
  // 128-byte rows with the 128-byte swizzle, then one TMA store each
  named_sync(2, kConsumers * kWG);
  uint8_t* tile = reinterpret_cast<uint8_t*>(ring.x(0)) + wg * NB * kBoxBytes;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<uint32_t*>(
            tile + nb * kBoxBytes +
            sw128_offset(warp * 16 + lane / 4 + 8 * i, j) + 4 * quad) =
            pack_bf16(d[nb][4 * j + 2 * i], d[nb][4 * j + 2 * i + 1]);
  fence_proxy_async();                      // the tile is TMA's source
  named_sync(3 + wg, kWG);
  if (t == 0) {
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
      tma_store_2d(&omap, tile + nb * kBoxBytes, n0 + 64 * nb, m0 + 64 * wg);
    tma_commit();
    tma_wait_read<0>();                     // before the block's exit
  }
}

template <int NB>
cudaError_t launch(const CUtensorMap& xm, const CUtensorMap& wm,
                   const CUtensorMap& om, const float2* stats, const void* g,
                   const void* b, int M, int K, int N, cudaStream_t stream) {
  const int smem = Ring<NB>::bytes(K);
  auto kernel = ln_matmul_sm90<NB>;
  // the attribute belongs to the current device: set on every launch
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  // a programmatic dependent launch: it may begin before the statistics
  // kernel ahead of it on the stream ends (see griddepcontrol above)
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(N / (64 * NB), (M + kRows - 1) / kRows);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, xm, wm, om, stats,
                            static_cast<const __nv_bfloat16*>(g),
                            static_cast<const __nv_bfloat16*>(b), M, K);
}

// 64-column boxes of w per block: 3 where N allows it and ceil(blocks /
// SMs) * NB, the waves of blocks times their width, is then smaller; else
// 2.
inline int boxes_per_block(int M, int N, int sms) {
  auto cost = [&](int nb) {
    const long long blocks = (long long)((M + kRows - 1) / kRows) *
                             (N / (64 * nb));
    return (blocks + sms - 1) / sms * nb;
  };
  return N % 192 == 0 && cost(3) < cost(2) ? 3 : 2;
}

}  // namespace

extern "C" {

// Returns 0 on success, else the cudaError_t of the refused launch
// (cudaErrorInvalidValue for a K or N the tiling does not take, or where a
// tensor map could not be encoded). stats is fp32 scratch of M * 2.
int must3r_ln_matmul_bf16(const void* x, const void* g, const void* b,
                          const void* w, void* stats, void* out, int M,
                          int K, int N, void* stream) {
  if (M <= 0 || K <= 0 || K % kChunk != 0 || K > kMaxK || N <= 0 ||
      N % 128 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap xm, wm, om;
  if (!encode_2d(&xm, x, M, K, kRows, kChunk) ||
      !encode_2d(&wm, w, K, N, kChunk, 64) ||
      !encode_2d(&om, out, M, N, 64, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto st = static_cast<cudaStream_t>(stream);
  auto* row_stats = static_cast<float2*>(stats);
  ln_row_stats<<<(M + kStatsRows - 1) / kStatsRows, kStatsRows * 32, 0,
                 st>>>(static_cast<const __nv_bfloat16*>(x), row_stats, M,
                       K);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      boxes_per_block(M, N, sms) == 3
          ? launch<3>(xm, wm, om, row_stats, g, b, M, K, N, st)
          : launch<2>(xm, wm, om, row_stats, g, b, M, K, N, st));
}

}  // extern "C"
