// Shared constants and helpers of the port's kernels (attention_sm90.cu:
// K1, K2, K2(d), K6; attention_bwd_sm90.cu: K3, K4, K5; ln_matmul_sm90.cu:
// K7).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace must3r {

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
