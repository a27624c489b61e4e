// The fp8 hardware probe of the PyTorch port, hand-written for Hopper
// (sm_90a). It replaces the two Pallas kernels of scripts/probe_fp8.py
// (`kernel` and `kernel2`), which checked that the TPU loads float8_e4m3fn
// and converts it to bf16, and that a dot after that dequant works: the
// same conversion and the same dequantize-then-dot that K2(d) (ca_fwd_q8 in
// attention_sm90.cu) does on an 8-bit token memory.
//
//   fp8_to_bf16_x2  : o = bf16(x) * 2; x [n] fp8 e4m3 -> o [n] bf16.
//                     Exact (e4m3 fits bf16, and * 2 only moves the
//                     exponent). One thread per element.
//   fp8_dequant_dot : o = bf16(x) @ w with fp32 accumulation; x [M, K] fp8
//                     e4m3, w [K, N] bf16 -> o [M, N] fp32 (the probe's
//                     shapes: [8, 128] @ [128, 128]). A block owns one row
//                     of x, converts it into shared memory, and each thread
//                     sums one output column with fp32 FMAs; each product
//                     of two bf16 values is exact in fp32, so it differs
//                     from any other fp32 sum only by summation order.
//
// What bounds them: nothing measurable at the probe's shapes (37 KB in,
// 4 KB out, 0.26 MFLOP); they are launch-bound and exist to prove the
// conversion on the card, not for speed.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDotThreads = 128;

__device__ __forceinline__ float e4m3_to_float(uint8_t code) {
  __nv_fp8_e4m3 x;
  x.__x = code;
  return static_cast<float>(x);
}

__global__ void fp8_to_bf16_x2_kernel(const uint8_t* __restrict__ x,
                                      __nv_bfloat16* __restrict__ out,
                                      int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = __float2bfloat16(e4m3_to_float(x[i]) * 2.f);
}

// grid (ceil(N / kDotThreads), M); dynamic shared memory: K floats
__global__ void __launch_bounds__(kDotThreads)
fp8_dequant_dot_kernel(const uint8_t* __restrict__ x,
                       const __nv_bfloat16* __restrict__ w,
                       float* __restrict__ out, int M, int K, int N) {
  extern __shared__ float s_row[];
  const int m = blockIdx.y;
  for (int k = threadIdx.x; k < K; k += blockDim.x)
    s_row[k] = __bfloat162float(
        __float2bfloat16(e4m3_to_float(x[(size_t)m * K + k])));
  __syncthreads();
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float acc = 0.f;
  for (int k = 0; k < K; ++k)
    acc = fmaf(s_row[k], __bfloat162float(w[(size_t)k * N + n]), acc);
  out[(size_t)m * N + n] = acc;
}

}  // namespace

extern "C" {

// Each returns 0 on success, else the cudaError_t of the refused launch.
int must3r_fp8_to_bf16_x2(const void* x, void* out, int n, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  fp8_to_bf16_x2_kernel<<<(n + 255) / 256, 256, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<__nv_bfloat16*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

int must3r_fp8_dequant_dot(const void* x, const void* w, void* out, int M,
                           int K, int N, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || M > 65535 || K > 8192)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((N + kDotThreads - 1) / kDotThreads, M);
  fp8_dequant_dot_kernel<<<grid, kDotThreads, K * sizeof(float),
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<float*>(out), M, K, N);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
