// Fused PCILT conv2d, dense tables or a shared pool (paper extension 3):
//   out[b, y, x, o] = sum_g T_g[pack(quant(patch[g*group : (g+1)*group])), o]
// over the [kh, kw, C]-flattened patch of the spatially padded float image
// at (y*stride, x*stride); T_g = tables[g] (dense) or pool[seg_idx[g]]
// (shared; a pointer outside [0, X) adds nothing).  Patch slots at and
// past n = kh*kw*C (group alignment, tables built from zero weights) take
// code 0.  Accumulated in float32, cast once to the table dtype.
//
// Replaces: src/repro/kernels/pcilt_fused.py pcilt_fused_conv2d_pallas
// (body _conv_kernel, _strip_offsets) and src/repro/kernels/pcilt_shared.py
// pcilt_shared_conv2d_pallas (without its per-call [V, X, O] transpose).
//
// Bound: operations.  Each output pixel adds G rows of O cells: P*G*O
// fetch-adds (1.4e12 for the paper CNN's conv4 on a 1024x768 image) against
// a table read once (1.8 GB), far above the card's bytes line; in practice
// the gathered cells come from L2/L1, so the kernel is bound by its load
// instructions.
//
// Design: the row-tiled fetch of pcilt_common.cuh with pixels as rows.  A
// block stages, per chunk of segments, every pixel's packed offset in shared
// memory — the quantized patch and its offsets never reach device memory —
// then each thread adds its 8 pixels' cells of its column, 8 independent
// loads per segment.  The G loop stays in the block: no atomics, a fixed
// summation order, deterministic results.
#include "pcilt_common.cuh"

namespace {

using pcilt::kRowsPerThread;
using pcilt::kSegChunk;

template <typename T, bool kShared>
__global__ void conv2d_kernel(const float* __restrict__ x,
                              const T* __restrict__ tab,
                              const int* __restrict__ seg_idx,
                              T* __restrict__ out, long long P, int Hp,
                              int Wp, int C, int Ho, int Wo, int kh, int kw,
                              int stride, int G, int X, int V, int O,
                              int group, int bits, int zp, float scale) {
  extern __shared__ long long smem[];
  const int R = blockDim.y * kRowsPerThread;
  long long* s_base = smem;                              // [kSegChunk]
  long long* s_pix = s_base + kSegChunk;                 // [R]
  int* s_off = reinterpret_cast<int*>(s_pix + R);        // [R][kSegChunk]
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  const int kmax = (1 << bits) - 1;
  const int n = kh * kw * C;
  const long long VO = (long long)V * O;
  const long long pix0 = (long long)blockIdx.x * R;

  // element index of x[b, y*stride, x*stride, 0] for each row; -1 past P
  for (int r = tid; r < R; r += nthreads) {
    const long long p = pix0 + r;
    long long base = -1;
    if (p < P) {
      const long long b = p / ((long long)Ho * Wo);
      const int rem = (int)(p - b * Ho * Wo);
      const int oy = rem / Wo, ox = rem - (rem / Wo) * Wo;
      base = ((b * Hp + (long long)oy * stride) * Wp +
              (long long)ox * stride) * C;
    }
    s_pix[r] = base;
  }

  const int col = blockIdx.y * blockDim.x + threadIdx.x;
  const int row0 = threadIdx.y * kRowsPerThread;
  float acc[kRowsPerThread];
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) acc[k] = 0.f;

  for (int g0 = 0; g0 < G; g0 += kSegChunk) {
    const int gc = min(kSegChunk, G - g0);
    __syncthreads();  // the previous chunk's readers are done; s_pix is set
    for (int gg = tid; gg < gc; gg += nthreads) {
      const int g = g0 + gg;
      long long base = (long long)g * VO;
      if (kShared) {
        const int s = seg_idx[g];
        base = (s >= 0 && s < X) ? (long long)s * VO : -1;
      }
      s_base[gg] = base;
    }
    for (int i = tid; i < R * gc; i += nthreads) {
      const int r = i / gc;
      const int gg = i - r * gc;
      const long long pb = s_pix[r];
      int off = -1;
      if (pb >= 0) {
        off = 0;
        for (int j = 0; j < group; ++j) {
          const int p = (g0 + gg) * group + j;
          if (p >= n) break;  // alignment slots: code 0
          const int tap = p / C;
          const int c = p - tap * C;
          const int ti = tap / kw;
          const int tj = tap - ti * kw;
          bool sat;
          const int code = pcilt::quantize_code(
              x[pb + ((long long)ti * Wp + tj) * C + c], scale, zp, kmax,
              &sat);
          off |= code << (j * bits);
        }
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
    const long long p = pix0 + row0 + k;
    if (p < P) out[p * O + col] = pcilt::from_f32<T>(acc[k]);
  }
}

template <typename T, bool kShared>
int launch(const float* x, const T* tab, const int* seg_idx, T* out, int B,
           int Hp, int Wp, int C, int Ho, int Wo, int kh, int kw, int stride,
           int G, int X, int V, int O, int group, int bits, int zp,
           float scale, cudaStream_t stream) {
  const dim3 block = pcilt::fetch_block(O);
  const int R = block.y * kRowsPerThread;
  const long long P = (long long)B * Ho * Wo;
  const dim3 grid((unsigned)((P + R - 1) / R), (O + block.x - 1) / block.x);
  const size_t smem = pcilt::fetch_smem_bytes(R);
  cudaError_t err = pcilt::allow_smem(conv2d_kernel<T, kShared>, smem);
  if (err != cudaSuccess) return (int)err;
  conv2d_kernel<T, kShared><<<grid, block, smem, stream>>>(
      x, tab, seg_idx, out, P, Hp, Wp, C, Ho, Wo, kh, kw, stride, G, X, V, O,
      group, bits, zp, scale);
  return (int)cudaGetLastError();
}

}  // namespace

#define PCILT_CONV2D_ENTRY(NAME, TYPE, SHARED)                               \
  extern "C" int NAME(const void* x, const void* tab, const void* seg_idx,  \
                      void* out, int B, int Hp, int Wp, int C, int Ho,      \
                      int Wo, int kh, int kw, int stride, int G, int X,     \
                      int V, int O, int group, int bits, int zp,            \
                      float scale, void* stream) {                          \
    return launch<TYPE, SHARED>((const float*)x, (const TYPE*)tab,          \
                                (const int*)seg_idx, (TYPE*)out, B, Hp, Wp, \
                                C, Ho, Wo, kh, kw, stride, G, X, V, O,      \
                                group, bits, zp, scale,                     \
                                (cudaStream_t)stream);                      \
  }

PCILT_CONV2D_ENTRY(pcilt_fused_conv2d_f32, float, false)
PCILT_CONV2D_ENTRY(pcilt_fused_conv2d_bf16, __nv_bfloat16, false)
PCILT_CONV2D_ENTRY(pcilt_shared_conv2d_f32, float, true)
PCILT_CONV2D_ENTRY(pcilt_shared_conv2d_bf16, __nv_bfloat16, true)
