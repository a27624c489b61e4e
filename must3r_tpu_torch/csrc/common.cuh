// Shared constants and helpers of the port's kernels (attention_sm90.cu:
// K1, K2, K2(d); attention_bwd_sm90.cu: K3, K4, K5; attention.cu: K6;
// ln_matmul.cu: K7). The tile constants are the WMMA program's (K6).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace must3r {

constexpr int kBQ = 64;             // query rows per tile
constexpr int kBK = 64;             // keys per tile
constexpr int kWarps = 4;           // 16 rows per warp
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;
// LSE of a query row that attends no key: exp(s - kEmptyLse) underflows to
// exactly 0 for every finite score, so the backward's recomputed
// probabilities of such a row are 0 with or without the mask (no NaN).
constexpr float kEmptyLse = 1e30f;

__device__ __forceinline__ uint4 load16(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ void store16(__nv_bfloat16* p, uint4 v) {
  *reinterpret_cast<uint4*>(p) = v;
}

// The label predicate of a memory slot for one image of the step.
__device__ __forceinline__ bool slot_allowed(int label, int q_self,
                                             int q_upper) {
  return label >= 0 && label != q_self && label < q_upper;
}

}  // namespace must3r
