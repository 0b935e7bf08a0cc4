// Fused PCILT GEMV, unstacked, layer-stacked, paired and plan-gathered:
//   out[b, o] = sum_g T_g[pack(quant(x[b, g*pw : (g+1)*pw])), o]
// where T_g is the [V, O] table of segment g: element
// layer_off + g * seg_stride + off * O + o of the table array.  Accumulated
// in float32 and cast once to the table dtype.  One source, five launches:
//
//   kernel                     tables            pw        seg_stride  layer_off
//   fused GEMV (#9)            [G, V, O]         group     V*O         0
//   layer-stacked (#1)         [L, G, V, O]      group     V*O         l*G*V*O
//   paired (#10)               [G2, V2, O]       2*group   V2*O        0
//   paired stacked (#8)        [G2, L, V2, O]    2*group   L*V2*O      l*V2*O
//   plan (#11)                 [G, V, O]         group     V*O         0
//
// The pack is the little-endian shift-or of pw codes, so a paired offset
// (2*group codes) is off_even + off_odd * V, the row the paired build
// indexes (V2 = V**2).  The plan launch (a generalized SegmentPlan, paper
// Fig. 7) reads slot j of segment g from x[b, plan[g*pw + j]] of an x of
// any width n; a -1 slot reads 0.0 (its code is the zero point, as in the
// reference kernel) and never touches x.  The plan is a template flag, so
// the other four launches compile to the code they had without it.
//
// Replaces: src/repro/kernels/pcilt_fused.py pcilt_fused_gemv_stacked_pallas
// (and its counter body _gemv_stacked_sat_kernel), pcilt_fused_gemv_pallas,
// pcilt_fused_gemv_paired_pallas (_gemv_paired_sat_kernel),
// pcilt_fused_gemv_paired_stacked_pallas (_gemv_paired_stacked_sat_kernel)
// and pcilt_fused_gemv_plan_pallas (no counter variant, as in the
// reference).
//
// Bound: bytes.  A decode call reads one O-wide table row per (b, g) —
// B*G*O*itemsize bytes of a multi-GiB stack that no cache holds — and does one
// add per byte fetched, far below the card's 295 operations per byte.  The
// paired layout halves G, so it halves the rows fetched.
//
// Design: one block per 128-wide O tile and all B rows.  The block quantizes
// and packs the B*G offsets of its rows into shared memory once (the
// offsets never reach device memory); then thread (tx, ty) owns column
// o = tile*128 + tx and loops over g for rows b = ty, ty + blockDim.y, ...,
// loading T_g[off[b, g], o]: a warp reads 32 neighbouring columns of
// one table row, so every load is coalesced.  The layer is selected by the
// 64-bit offset layer_off and the segment by the 64-bit stride seg_stride
// (a paired wo stack at mamba2-130m width spans 1.8e9 elements), so no
// table is sliced, padded or transposed per call; the ragged O edge is
// masked here.  Counter variant: only the blocks of O tile 0 count, so each
// activation is counted once; per-warp shuffle reduction, then one
// atomicAdd / atomicMax.  A first, simple design: at B = 4 the wz projection
// (O = 1536) runs 12 blocks on 132 SMs.
#include "pcilt_common.cuh"

namespace {

constexpr int kTileO = 128;

template <typename T, bool COUNTERS, bool PLAN>
__global__ void gemv_fused_kernel(const float* __restrict__ x,
                                  const T* __restrict__ tab,
                                  T* __restrict__ out, int* __restrict__ stats,
                                  int B, int G, int O, int pw, int bits,
                                  int zp, float scale, long long seg_stride,
                                  const int* __restrict__ plan, int n_plan) {
  extern __shared__ int off[];  // [B * G] packed offsets
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  const int kmax = (1 << bits) - 1;
  const int n = PLAN ? n_plan : G * pw;
  const bool count_here = COUNTERS && blockIdx.x == 0;
  int cnt = 0;
  float ratio = 0.f;
  for (int i = tid; i < B * G; i += nthreads) {
    const int b = i / G;
    const int g = i - b * G;
    const float* xs = x + (size_t)b * n + (PLAN ? 0 : (size_t)g * pw);
    int o = 0;
    for (int j = 0; j < pw; ++j) {
      float xv;
      if (PLAN) {
        const int p = plan[g * pw + j];
        xv = p >= 0 ? xs[p] : 0.f;
      } else {
        xv = xs[j];
      }
      bool sat;
      const int code = pcilt::quantize_code(xv, scale, zp, kmax, &sat);
      if (count_here) {
        cnt += sat ? 1 : 0;
        ratio = fmaxf(ratio, __fdiv_rn(fabsf(xv), scale));
      }
      o |= code << (j * bits);
    }
    off[i] = o;
  }
  if (count_here) pcilt::commit_stats(cnt, ratio, stats);
  __syncthreads();
  const int col = blockIdx.x * kTileO + threadIdx.x;
  if (col >= O) return;
  for (int b = threadIdx.y; b < B; b += blockDim.y) {
    const int* ob = off + b * G;
    float acc = 0.f;
#pragma unroll 8
    for (int g = 0; g < G; ++g) {
      acc += pcilt::to_f32(tab[g * seg_stride + (long long)ob[g] * O + col]);
    }
    out[(size_t)b * O + col] = pcilt::from_f32<T>(acc);
  }
}

template <typename T, bool COUNTERS, bool PLAN>
int launch_as(const float* x, const T* tab, T* out, int* stats, int B, int G,
              int O, int pw, int bits, int zp, float scale,
              long long seg_stride, const int* plan, int n_plan,
              cudaStream_t stream) {
  const size_t smem = (size_t)B * G * sizeof(int);
  dim3 block(kTileO, B < 8 ? B : 8);
  dim3 grid((O + kTileO - 1) / kTileO);
  cudaError_t err =
      pcilt::allow_smem(gemv_fused_kernel<T, COUNTERS, PLAN>, smem);
  if (err != cudaSuccess) return (int)err;
  gemv_fused_kernel<T, COUNTERS, PLAN><<<grid, block, smem, stream>>>(
      x, tab, out, stats, B, G, O, pw, bits, zp, scale, seg_stride, plan,
      n_plan);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const float* x, const T* tables, T* out, int* stats, int B, int G,
           int O, int pw, int bits, int zp, float scale, long long seg_stride,
           long long layer_off, int counters, cudaStream_t stream) {
  const T* tab = tables + layer_off;
  if (counters)
    return launch_as<T, true, false>(x, tab, out, stats, B, G, O, pw, bits,
                                     zp, scale, seg_stride, nullptr, 0,
                                     stream);
  return launch_as<T, false, false>(x, tab, out, stats, B, G, O, pw, bits, zp,
                                    scale, seg_stride, nullptr, 0, stream);
}

}  // namespace

extern "C" int pcilt_gemv_fused_f32(const void* x, const void* tables,
                                    void* out, void* stats, int B, int G,
                                    int O, int pw, int bits, int zp,
                                    float scale, long long seg_stride,
                                    long long layer_off, int counters,
                                    void* stream) {
  return launch<float>((const float*)x, (const float*)tables, (float*)out,
                       (int*)stats, B, G, O, pw, bits, zp, scale, seg_stride,
                       layer_off, counters, (cudaStream_t)stream);
}

extern "C" int pcilt_gemv_fused_bf16(const void* x, const void* tables,
                                     void* out, void* stats, int B, int G,
                                     int O, int pw, int bits, int zp,
                                     float scale, long long seg_stride,
                                     long long layer_off, int counters,
                                     void* stream) {
  return launch<__nv_bfloat16>((const float*)x,
                               (const __nv_bfloat16*)tables,
                               (__nv_bfloat16*)out, (int*)stats, B, G, O, pw,
                               bits, zp, scale, seg_stride, layer_off,
                               counters, (cudaStream_t)stream);
}

// Plan launch: x [B, n], plan [G, group] int32 (-1 = unused slot), tables
// [G, V, O].
extern "C" int pcilt_gemv_plan_f32(const void* x, const void* tables,
                                   void* out, const void* plan, int B, int G,
                                   int O, int n, int group, int bits, int zp,
                                   float scale, void* stream) {
  return launch_as<float, false, true>(
      (const float*)x, (const float*)tables, (float*)out, nullptr, B, G, O,
      group, bits, zp, scale, (long long)(1 << (bits * group)) * O,
      (const int*)plan, n, (cudaStream_t)stream);
}

extern "C" int pcilt_gemv_plan_bf16(const void* x, const void* tables,
                                    void* out, const void* plan, int B, int G,
                                    int O, int n, int group, int bits, int zp,
                                    float scale, void* stream) {
  return launch_as<__nv_bfloat16, false, true>(
      (const float*)x, (const __nv_bfloat16*)tables, (__nv_bfloat16*)out,
      nullptr, B, G, O, group, bits, zp, scale,
      (long long)(1 << (bits * group)) * O, (const int*)plan, n,
      (cudaStream_t)stream);
}
