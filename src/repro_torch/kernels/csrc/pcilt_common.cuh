// Shared device helpers of the PCILT kernels: the quantizer, dtype
// conversions and the saturation-counter reduction.
//
// The quantizer repeats repro.core.quantization.quantize bit for bit:
// a true division (__fdiv_rn, never a reciprocal multiply), round half to
// even (rintf), + zero_point, clip to [0, 2**bits - 1].  An element is
// saturated iff its pre-clip code leaves that range.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace pcilt {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// One activation -> its code; *sat is set iff the pre-clip code is outside
// [0, kmax].
__device__ __forceinline__ int quantize_code(float x, float scale, int zp,
                                             int kmax, bool* sat) {
  float q = rintf(__fdiv_rn(x, scale)) + (float)zp;
  *sat = (q < 0.f) || (q > (float)kmax);
  q = fminf(fmaxf(q, 0.f), (float)kmax);
  return (int)q;
}

// Saturation counters of one thread -> the call's global counters:
// stats[0] += count (int32), stats[1] = max(stats[1], ratio) on the int bits
// of the non-negative float ratio (ordered like the floats themselves).
// Every thread of the block must call this (warp shuffles).
__device__ __forceinline__ void commit_stats(int cnt, float ratio,
                                             int* stats) {
  for (int o = 16; o > 0; o >>= 1) {
    cnt += __shfl_down_sync(0xffffffffu, cnt, o);
    ratio = fmaxf(ratio, __shfl_down_sync(0xffffffffu, ratio, o));
  }
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  if ((tid & 31) == 0) {
    if (cnt) atomicAdd(&stats[0], cnt);
    atomicMax(&stats[1], __float_as_int(ratio));
  }
}

// Dynamic shared memory above the default 48 KB needs an opt-in per kernel.
template <typename Kernel>
__host__ cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace pcilt
