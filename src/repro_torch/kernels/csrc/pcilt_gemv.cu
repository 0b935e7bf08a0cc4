// Host-packed PCILT GEMV:
//   out[m, o] = sum_g tables[g, offsets[m, g], o]
// offsets [M, G] int32 packed by the caller, tables [G, V, O]; an offset
// outside [0, V) adds nothing (the reference's one-hot fetch matches no
// row for it).  Accumulated in float32, cast once to the table dtype.  The
// host-packed conv2d (offsets [B, Ho, Wo, G]) is this kernel over the
// flattened pixels.
//
// Replaces: src/repro/kernels/pcilt_gemv.py pcilt_gemv_pallas and
// src/repro/kernels/pcilt_conv2d.py pcilt_conv2d_pallas.
//
// Bound: at the paper CNN's conv shapes, operations (M*G*O fetch-adds);
// the M*G int32 offsets are read once (3.1e9 of them for conv4 on a
// 1024x768 image, 12.6 GB, indexed in 64 bits), and bytes bound it where O
// is small.
//
// Design: the row-tiled fetch of pcilt_common.cuh with offset rows as rows:
// a block copies a chunk of its rows' offsets into shared memory (reads
// along G, coalesced), then each thread adds its 8 rows' cells of its
// column.  No atomics: deterministic results.
#include "pcilt_common.cuh"

namespace {

using pcilt::kRowsPerThread;
using pcilt::kSegChunk;

template <typename T>
__global__ void gemv_host_kernel(const int* __restrict__ offsets,
                                 const T* __restrict__ tab,
                                 T* __restrict__ out, long long M, int G,
                                 int V, int O) {
  extern __shared__ long long smem[];
  const int R = blockDim.y * kRowsPerThread;
  long long* s_base = smem;                          // [kSegChunk]
  int* s_off = reinterpret_cast<int*>(s_base + kSegChunk + R);  // [R][chunk]
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  const long long VO = (long long)V * O;
  const long long m0 = (long long)blockIdx.x * R;
  const int col = blockIdx.y * blockDim.x + threadIdx.x;
  const int row0 = threadIdx.y * kRowsPerThread;
  float acc[kRowsPerThread];
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) acc[k] = 0.f;

  for (int g0 = 0; g0 < G; g0 += kSegChunk) {
    const int gc = min(kSegChunk, G - g0);
    __syncthreads();
    for (int gg = tid; gg < gc; gg += nthreads)
      s_base[gg] = (long long)(g0 + gg) * VO;
    for (int i = tid; i < R * gc; i += nthreads) {
      const int r = i / gc;
      const int gg = i - r * gc;
      const long long m = m0 + r;
      int off = -1;
      if (m < M) {
        off = offsets[m * G + g0 + gg];
        if (off < 0 || off >= V) off = -1;
      }
      s_off[r * kSegChunk + gg] = off;
    }
    __syncthreads();
    if (col < O)
      pcilt::fetch_chunk(tab, s_base, s_off, gc, (long long)O, col, row0,
                         acc);
  }
  if (col >= O) return;
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const long long m = m0 + row0 + k;
    if (m < M) out[m * O + col] = pcilt::from_f32<T>(acc[k]);
  }
}

template <typename T>
int launch(const int* offsets, const T* tab, T* out, long long M, int G,
           int V, int O, cudaStream_t stream) {
  const dim3 block = pcilt::fetch_block(O);
  const int R = block.y * kRowsPerThread;
  const dim3 grid((unsigned)((M + R - 1) / R), (O + block.x - 1) / block.x);
  const size_t smem = pcilt::fetch_smem_bytes(R);
  cudaError_t err = pcilt::allow_smem(gemv_host_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  gemv_host_kernel<T><<<grid, block, smem, stream>>>(offsets, tab, out, M, G,
                                                     V, O);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int pcilt_gemv_host_f32(const void* offsets, const void* tab,
                                   void* out, long long M, int G, int V,
                                   int O, void* stream) {
  return launch<float>((const int*)offsets, (const float*)tab, (float*)out,
                       M, G, V, O, (cudaStream_t)stream);
}

extern "C" int pcilt_gemv_host_bf16(const void* offsets, const void* tab,
                                    void* out, long long M, int G, int V,
                                    int O, void* stream) {
  return launch<__nv_bfloat16>((const int*)offsets,
                               (const __nv_bfloat16*)tab,
                               (__nv_bfloat16*)out, M, G, V, O,
                               (cudaStream_t)stream);
}
