// Device and host helpers of the port's TMA + wgmma programs for Hopper
// (sm_90a): attention_sm90.cu (K1, K2, K2(d)) and attention_bwd_sm90.cu
// (K3, K4, K5). mbarriers, TMA loads and reduce-adds, wgmma with both
// operands in shared memory or A in registers, the key mask of a memory
// CA, the tensor-map encoder and the rule for the query rows of a block.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (the encoder: see encoder())
#include <cuda_runtime.h>

#include "common.cuh"

namespace must3r {
namespace sm90 {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

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

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
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

// Add one box of shared memory (fp32) into the global tensor of a 4-D map;
// elements outside the map's dims are dropped. Completes asynchronously:
// tma_commit() closes the group, tma_wait_read<N>() waits until at most N
// groups still read shared memory, tma_wait_all() until every one is done.
__device__ __forceinline__ void tma_reduce_add_4d(const CUtensorMap* map,
                                                  const void* src, int c0,
                                                  int c1, int c2, int c3) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.4d.global.shared::cta.add.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void tma_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void tma_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void tma_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Shared-memory writes of this thread made by plain stores become visible
// to the async proxy (wgmma operands, TMA stores) after this fence.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A barrier of `count` threads (a multiple of 32) on named barrier `id`
// (0 is __syncthreads').
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

template <int REGS>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS));
}
template <int REGS>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

// Byte offset of (row, 16-byte chunk) in a tile of 128-byte rows written
// with the 128-byte swizzle (the tile starts on a 1024-byte boundary): the
// chunk index is XORed with the row's place in its group of 8 rows.
__device__ __forceinline__ int sw128_offset(int row, int chunk) {
  return row * 128 + ((chunk ^ (row & 7)) << 4);
}

// --- wgmma ----------------------------------------------------------------

// Descriptor of a 64-row tile of 128-byte rows with the 128-byte swizzle:
// SBO = 1024 bytes between 8-row groups; LBO unused (K-major swizzled
// operands, and MN-major ones exactly 64 wide). Stepping 16 elements along
// K adds 2 (K-major: 32 bytes along a row) or 128 (MN-major: 16 rows).
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

// d (+)= A B (m64n64k16, bf16 in, fp32 out), A and B both in shared memory;
// scale_d = 0 overwrites. K-major operands by default; TA / TB read A / B
// MN-major (the transpose flags).
template <int TA = 0, int TB = 0>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a,
                                         uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MUST3R_D32
      ", %32, %33, p, 1, 1, %35, %36;\n}\n"
      : MUST3R_D32_OPS(d)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TA), "n"(TB));
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

// An m64n64 fp32 accumulator as the bf16 A fragments of the next product:
// columns 16kk..16kk+15 (the next product's K) are registers 8kk..8kk+7.
__device__ __forceinline__ void acc_to_a(const float (&s)[32],
                                         uint32_t (&a)[4][4]) {
#pragma unroll
  for (int x = 0; x < 16; ++x)
    a[x / 4][x % 4] = pack_bf16(s[2 * x], s[2 * x + 1]);
}

// Bit `lane` of the result: whether image bz attends key j of the memory
// (j < kv_len, the label predicate, and with EXT no token-dropout mark).
// One call per warp; labels_b and ext_bz point at the rows of b and bz.
template <bool EXT>
__device__ __forceinline__ uint32_t ballot_allowed(
    const int32_t* __restrict__ labels_b, const uint8_t* __restrict__ ext_bz,
    int j, int kv_len, int q_self, int q_upper) {
  bool a = j < kv_len && slot_allowed(labels_b[j], q_self, q_upper);
  if (EXT && a) a = ext_bz[j] == 0;
  return __ballot_sync(0xffffffffu, a);
}

// --- host side ------------------------------------------------------------

// Consumer warpgroups (64 query rows each) per block of the programs that
// own query rows (K1, K2, K3): 3 (one block an SM) when ceil(N / 192) * H
// * B * G blocks still give every SM two, else 1 (two blocks an SM), so
// that a small grid (one image's 768 rows x 12 heads: 144 blocks) still
// fills the SMs.
inline cudaError_t consumers_per_block(int n, long long h_bg, int* nc) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  *nc = (long long)((n + 191) / 192) * h_bg >= 2LL * sms ? 3 : 1;
  return cudaSuccess;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up in libcuda at run time (no -lcuda).
inline EncodeTiled encoder() {
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

// A 4-D map (dims innermost first, byte strides of dims 1..3, box per dim);
// elements outside the dims are zero-filled on loads and dropped on stores.
inline bool encode_4d(CUtensorMap* map, CUtensorMapDataType dtype,
                      const void* base, const cuuint64_t (&dims)[4],
                      const cuuint64_t (&strides)[3],
                      const cuuint32_t (&box)[4],
                      CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, dtype, 4, const_cast<void*>(base), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// [BG, N, H, 64] bf16 activations: dims (64, H, N, BG), boxes of 64 rows
// of N (one head), 128-byte swizzle
inline bool encode_rows(CUtensorMap* map, const void* base, int bg, int n,
                        int h) {
  const cuuint64_t row = 64 * 2;
  return encode_4d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base,
                   {64, (cuuint64_t)h, (cuuint64_t)n, (cuuint64_t)bg},
                   {row, row * h, row * h * n}, {64, 1, 64, 1},
                   CU_TENSOR_MAP_SWIZZLE_128B);
}

// the packed bf16 layer [B, H, S, 128] cut at kv_len: dims (128, kv_len, H,
// B), boxes of 64 features x 64 keys (K at feature 0, V at 64), 128-byte
// swizzle
inline bool encode_layer(CUtensorMap* map, const void* base, int b, int h,
                         int s, int kv_len) {
  const cuuint64_t row = 128 * 2;
  return encode_4d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base,
                   {128, (cuuint64_t)(kv_len > 0 ? kv_len : 1),
                    (cuuint64_t)h, (cuuint64_t)b},
                   {row, row * s, row * s * h}, {64, 64, 1, 1},
                   CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace sm90
}  // namespace must3r
