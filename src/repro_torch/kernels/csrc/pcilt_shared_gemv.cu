// Shared-pool fused PCILT GEMV (paper extension 3):
//   out[b, o] = sum_g pool[seg_idx[g], pack(quant(x[b, g*group : ...])), o]
// accumulated in float32 and cast once to the pool dtype.  A pointer
// outside [0, X) selects no pool row and contributes nothing, as the
// reference's pointer-select does.
//
// Replaces: src/repro/kernels/pcilt_shared.py pcilt_shared_gemv_pallas.
//
// Bound: bytes — B*G*O*itemsize of pool rows per call (the Mamba logits
// head: 4 x 384 rows of 50288 floats), one add per byte fetched.
//
// Design: the stacked GEMV's, with pool[seg_idx[g]] as the row base.  One
// block per 128-wide O tile and all B rows; the block quantizes, packs and
// resolves the pointers into B*G pool-row indices in shared memory, then
// thread (tx, ty) owns column o and sums its rows, loads coalesced along o.
// The pool is read in place: no transpose and no padding of the O axis
// (the ragged edge is masked here).
#include "pcilt_common.cuh"

namespace {

constexpr int kTileO = 128;

template <typename T>
__global__ void shared_gemv_kernel(const float* __restrict__ x,
                                   const int* __restrict__ seg_idx,
                                   const T* __restrict__ pool,
                                   T* __restrict__ out, int B, int G, int X,
                                   int V, int O, int group, int bits, int zp,
                                   float scale) {
  extern __shared__ int rows[];  // [B * G] pool row index, -1 = no row
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  const int kmax = (1 << bits) - 1;
  const int n = G * group;
  for (int i = tid; i < B * G; i += nthreads) {
    const int b = i / G;
    const int g = i - b * G;
    const float* xs = x + (size_t)b * n + (size_t)g * group;
    int o = 0;
    for (int j = 0; j < group; ++j) {
      bool sat;
      o |= pcilt::quantize_code(xs[j], scale, zp, kmax, &sat) << (j * bits);
    }
    const int p = seg_idx[g];
    rows[i] = (p >= 0 && p < X) ? p * V + o : -1;
  }
  __syncthreads();
  const int col = blockIdx.x * kTileO + threadIdx.x;
  if (col >= O) return;
  for (int b = threadIdx.y; b < B; b += blockDim.y) {
    const int* rb = rows + b * G;
    float acc = 0.f;
#pragma unroll 8
    for (int g = 0; g < G; ++g) {
      const int r = rb[g];
      if (r >= 0) acc += pcilt::to_f32(pool[(size_t)r * O + col]);
    }
    out[(size_t)b * O + col] = pcilt::from_f32<T>(acc);
  }
}

template <typename T>
int launch(const float* x, const int* seg_idx, const T* pool, T* out, int B,
           int G, int X, int V, int O, int group, int bits, int zp,
           float scale, cudaStream_t stream) {
  const size_t smem = (size_t)B * G * sizeof(int);
  dim3 block(kTileO, B < 8 ? B : 8);
  dim3 grid((O + kTileO - 1) / kTileO);
  cudaError_t err = pcilt::allow_smem(shared_gemv_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  shared_gemv_kernel<T><<<grid, block, smem, stream>>>(
      x, seg_idx, pool, out, B, G, X, V, O, group, bits, zp, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int pcilt_shared_gemv_f32(const void* x, const void* seg_idx,
                                     const void* pool, void* out, int B,
                                     int G, int X, int V, int O, int group,
                                     int bits, int zp, float scale,
                                     void* stream) {
  return launch<float>((const float*)x, (const int*)seg_idx,
                       (const float*)pool, (float*)out, B, G, X, V, O, group,
                       bits, zp, scale, (cudaStream_t)stream);
}

extern "C" int pcilt_shared_gemv_bf16(const void* x, const void* seg_idx,
                                      const void* pool, void* out, int B,
                                      int G, int X, int V, int O, int group,
                                      int bits, int zp, float scale,
                                      void* stream) {
  return launch<__nv_bfloat16>((const float*)x, (const int*)seg_idx,
                               (const __nv_bfloat16*)pool,
                               (__nv_bfloat16*)out, B, G, X, V, O, group,
                               bits, zp, scale, (cudaStream_t)stream);
}
