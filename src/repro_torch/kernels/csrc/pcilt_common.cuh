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

// ---------------------------------------------------------------------------
// Row-tiled fetch-and-add of the conv2d and host-packed GEMV kernels.
//
// A block owns R = blockDim.y * kRowsPerThread output rows (pixels) and one
// O tile of blockDim.x columns; thread (tx, ty) owns column col of rows
// ty * kRowsPerThread + k.  Segments run in chunks of kSegChunk: the block
// stages, in shared memory, each segment's table base (element index of
// row 0 of its [V, O] table, -1 = the segment adds nothing) and each row's
// offset (-1 = no fetch), then every thread adds its rows' table cells.  A
// warp shares one (row, segment), so the offset is a shared-memory
// broadcast and the 32 loads of a table row are neighbouring columns.
constexpr int kRowsPerThread = 8;
constexpr int kSegChunk = 128;
constexpr int kBlockThreads = 256;

// Bytes of dynamic shared memory for R rows: bases, offsets, row bases.
__host__ __device__ __forceinline__ size_t fetch_smem_bytes(int rows) {
  return kSegChunk * sizeof(long long) +
         (size_t)rows * kSegChunk * sizeof(int) +
         (size_t)rows * sizeof(long long);
}

template <typename T>
__device__ __forceinline__ void fetch_chunk(const T* __restrict__ tab,
                                            const long long* s_base,
                                            const int* s_off, int gc,
                                            long long O, int col, int row0,
                                            float* acc) {
#pragma unroll 2
  for (int gg = 0; gg < gc; ++gg) {
    const long long base = s_base[gg];
    if (base < 0) continue;
    const T* seg = tab + base + col;
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
      const int off = s_off[(row0 + k) * kSegChunk + gg];
      if (off >= 0) acc[k] += to_f32(seg[(long long)off * O]);
    }
  }
}

// Launch geometry of the row-tiled kernels: O tile = min(128, O rounded up
// to a warp), 256 threads a block.
__host__ __forceinline__ dim3 fetch_block(int O) {
  int to = ((O + 31) / 32) * 32;
  if (to > 128) to = 128;
  int ty = kBlockThreads / to;
  return dim3(to, ty < 1 ? 1 : ty);
}

// ---------------------------------------------------------------------------
// Wide loads of table cells: a lane loads VB raw bytes (the widest that the
// table's alignment allows) and adds the cells they hold to float32 sums.
template <int VB> struct RawOf;
template <> struct RawOf<16> { using type = uint4; };
template <> struct RawOf<8> { using type = uint2; };
template <> struct RawOf<4> { using type = unsigned int; };
template <> struct RawOf<2> { using type = unsigned short; };

__device__ __forceinline__ unsigned word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}
__device__ __forceinline__ unsigned word(const uint2& v, int i) {
  return i == 0 ? v.x : v.y;
}
__device__ __forceinline__ unsigned word(unsigned v, int) { return v; }

// acc[0 .. VB/itemsize) += the table cells in the VB raw bytes v (bf16 is
// the upper half of a float32, so its conversion is a shift).
template <typename T, int VB>
__device__ __forceinline__ void add_raw(float* acc,
                                        const typename RawOf<VB>::type& v) {
  if constexpr (VB == 2) {
    acc[0] += __uint_as_float((unsigned)v << 16);
  } else {
#pragma unroll
    for (int i = 0; i < VB / 4; ++i) {
      const unsigned w = word(v, i);
      if constexpr (sizeof(T) == 4) {
        acc[i] += __uint_as_float(w);
      } else {
        acc[2 * i] += __uint_as_float(w << 16);
        acc[2 * i + 1] += __uint_as_float(w & 0xffff0000u);
      }
    }
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
