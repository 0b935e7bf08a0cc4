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
// the other four launches compile to the code they had without it.  The
// layer is selected by the 64-bit offset layer_off and the segment by the
// 64-bit stride seg_stride (a paired wo stack at mamba2-130m width spans
// 1.8e9 elements), so no table is sliced, padded or transposed per call.
//
// Replaces: src/repro/kernels/pcilt_fused.py pcilt_fused_gemv_stacked_pallas
// (and its counter body _gemv_stacked_sat_kernel), pcilt_fused_gemv_pallas,
// pcilt_fused_gemv_paired_pallas (_gemv_paired_sat_kernel),
// pcilt_fused_gemv_paired_stacked_pallas (_gemv_paired_stacked_sat_kernel)
// and pcilt_fused_gemv_plan_pallas (no counter variant, as in the
// reference).
//
// Bound: bytes.  A decode call reads one O-wide table row per (b, g) —
// B*G*O*itemsize bytes of a multi-GiB stack that no cache holds — and does
// one add per byte fetched, far below the card's 295 operations per byte.
// At B = 4 those bytes are few (9.4 MB at mamba2-130m's wz, 2.8 us at
// 3.35 TB/s), so the call is bound in practice by how many of them are in
// flight: the card needs ~2 MB in flight to stream at its rate.
//
// Two designs, chosen by the caller (kernels.ops; "split" unless forced).
// Kernel 9 has a third, "staged", for many rows: pcilt_gemv_staged.cu.
//
// "split" (split-K over G, for Hopper's 132 SMs; its rule, fetch, reduction
// and launch are pcilt_split.cuh, which the host-packed GEMV, kernel 6,
// shares with its own stage):
//  1. The segment loop is cut into S = cluster * warps * groups slices of
//     consecutive segments, in ascending g.  A slot — a group of `lanes`
//     lanes, at most kMaxLanes — owns one slice of one output tile of
//     lanes * 16 bytes of columns, for kRows rows.  A warp holds 32 / lanes
//     slots, so a narrow O (wdt's 24 columns: 6 lanes) puts several
//     segments of a row in one warp instead of idling lanes.  The slots of
//     one output tile spread over the warps of a block and the blocks of a
//     thread-block cluster (up to 16 with the non-portable size), until the
//     grid reaches kTargetBlocks or a slice would hold fewer than kMinSegs
//     segments: 384 blocks at wz, 32 at wB/wC, 16 at wdt (float32, B = 4).
//     Then the cluster doubles on while a block's staged offsets overflow
//     its shared memory (group 1 at d_ff 14336 or 19200 and B >= 16: 2
//     blocks a cluster).  Past a 16-block cluster (~224,000 segments) a
//     block stages its segments in consecutive slabs that fit (`slab`
//     segments each; a kernel of its own, gemv_split_slabs_kernel) and
//     sums each slab into the same registers, so the order of the sum is
//     the one-pass order.  The split is a function of
//     (B, G, O, itemsize) only (split_for, mirrored by kernels.ops.
//     gemv_variant and gemv_slab), never of the plan, so the plan launch
//     sums in the order of the unstacked one.
//  2. A lane owns 16 bytes of neighbouring columns (4 f32, 8 bf16) and
//     loads them with the widest of 16/8/4 bytes (2 for bf16) that the
//     table's address, O * itemsize and seg_stride * itemsize allow (a
//     template argument).  A slot reads its segments in batches of
//     kSegBatch (2 in the counter and bfloat16 instances): the batch's
//     offsets come from shared memory as one int4 per segment, then all
//     the batch's loads, kRows a segment, are in flight before the adds.
//  3. A block quantizes and packs only the kRows x (its segments) offsets
//     it fetches, into shared memory.  The counter variant counts only in
//     the blocks of output tile 0, so each activation is counted once.
//     Past kMaxGridRows row chunks (262,140 rows) the chunks go on in
//     further planes of the grid (gridDim.z), so any B is served.
//  4. Deterministic reduction: each slot's partial sums go to shared
//     memory and are summed in ascending slot order; then the cluster's
//     block sums are read through distributed shared memory and summed in
//     ascending rank order, each output element by one thread (all ranks'
//     loads issued before the adds).  No float atomics: two launches are
//     bit-identical.
// Measured on an H100 (PERF.md): 10.6 us at wz against 33.1 us for the
// kept design and 8.6 us for torch.matmul, whose dense weights are half the
// table rows' bytes at B = 4.  Of the 10.6 us, an empty launch of the same
// cluster grid takes ~3 us and the quantize and reduction stages ~2 us.
//
// "direct" (the first design, kept for comparison and forceable): one
// block per 128-wide O tile and all B rows.  The block quantizes and packs
// the B*G offsets into shared memory; thread (tx, ty) owns column
// o = tile*128 + tx and loops over all g for rows b = ty, ty + blockDim.y,
// ..., one 4-byte load at a time.  At B = 4 the wz projection (O = 1536)
// runs 12 blocks on 132 SMs, with few bytes in flight.
#include "pcilt_split.cuh"

namespace {

// ---------------------------------------------------------------------------
// "split" (the split itself, its fetch, reduction and launch: pcilt_split.cuh)
// ---------------------------------------------------------------------------

using namespace pcilt::split;

// Quantize and pack the kRows x ns offsets (x coalesced along g) into
// s_off[g - t0][row]; the counters of their activations committed (every
// thread of the block calls it).  The fused GEMVs' stage.
template <bool COUNTERS, bool PLAN>
__device__ __forceinline__ void pack_offsets(
    const float* __restrict__ x, const int* __restrict__ plan, int* s_off,
    int* stats, int b0, int nb, int t0, int ns, int n, int pw, int bits,
    int zp, float scale, bool count_here) {
  const int kmax = (1 << bits) - 1;
  int cnt = 0;
  float ratio = 0.f;
  for (int i = threadIdx.x; i < kRows * ns; i += blockDim.x) {
    const int r = i / ns;
    const int gl = i - r * ns;
    int o = 0;
    if (r < nb) {
      const int g = t0 + gl;
      const float* xs = x + (size_t)(b0 + r) * n + (PLAN ? 0 : (size_t)g * pw);
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
        if (COUNTERS && count_here) {
          cnt += sat ? 1 : 0;
          ratio = fmaxf(ratio, __fdiv_rn(fabsf(xv), scale));
        }
        o |= code << (j * bits);
      }
    }
    s_off[gl * kRows + r] = o;
  }
  if (COUNTERS && count_here) pcilt::commit_stats(cnt, ratio, stats);
}

// segments a load batch: 2 in the counter and bfloat16 instances, which
// spilled at 255 registers with kSegBatch (scripts/gemv_split_sweep.py
// batch4 rebuilds them so; no slower at 2, PERF.md)
template <typename T, bool COUNTERS>
constexpr int kBatch = (COUNTERS || sizeof(T) == 2) ? 2 : kSegBatch;

// The one-pass kernel (pcilt_split.cuh one_pass).  One resident block an
// SM is all the split asks (its grid is ~2 blocks an SM); without the 1,
// ptxas capped some instances of both kernels at 64-128 registers and
// spilled, and the narrow decode shapes ran up to 1 us slower
// (scripts/gemv_split_sweep.py, PERF.md).
template <typename T, int VB, bool COUNTERS, bool PLAN>
__global__ void __launch_bounds__(32 * kWarps, 1)
    gemv_split_kernel(const float* __restrict__ x, const T* __restrict__ tab,
                      T* __restrict__ out, int* __restrict__ stats,
                      const int* __restrict__ plan, int B, int G, int O,
                      int n, int pw, int bits, int zp, float scale,
                      long long seg_stride, Split sp) {
  one_pass<T, VB, kBatch<T, COUNTERS>, false>(
      [=](int* s_off, int b0, int nb, int t0, int ns, bool first) {
        pack_offsets<COUNTERS, PLAN>(x, plan, s_off, stats, b0, nb, t0, ns,
                                     n, pw, bits, zp, scale, first);
      },
      tab, out, B, G, O, seg_stride, sp);
}

// The slab kernel (pcilt_split.cuh slab_pass): past a 16-block cluster's
// shared memory a block stages its segments slab by slab.
template <typename T, int VB, bool COUNTERS, bool PLAN>
__global__ void __launch_bounds__(32 * kWarps, 1)
    gemv_split_slabs_kernel(const float* __restrict__ x,
                            const T* __restrict__ tab, T* __restrict__ out,
                            int* __restrict__ stats,
                            const int* __restrict__ plan, int B, int G,
                            int O, int n, int pw, int bits, int zp,
                            float scale, long long seg_stride, Split sp) {
  slab_pass<T, VB, kBatch<T, COUNTERS>, false>(
      [=](int* s_off, int b0, int nb, int t0, int ns, bool first) {
        pack_offsets<COUNTERS, PLAN>(x, plan, s_off, stats, b0, nb, t0, ns,
                                     n, pw, bits, zp, scale, first);
      },
      tab, out, B, G, O, seg_stride, sp);
}

template <typename T, int VB, bool COUNTERS, bool PLAN, bool SLABS>
int launch_split_slabs(const float* x, const T* tab, T* out, int* stats,
                       const int* plan, int B, int G, int O, int n, int pw,
                       int bits, int zp, float scale, long long seg_stride,
                       const Split& sp, cudaStream_t stream) {
  static KernelState state;  // this instance's, per process
  auto kernel = SLABS ? gemv_split_slabs_kernel<T, VB, COUNTERS, PLAN>
                      : gemv_split_kernel<T, VB, COUNTERS, PLAN>;
  return launch_cluster(kernel, sp, state, stream, x, tab, out, stats, plan,
                        B, G, O, n, pw, bits, zp, scale, seg_stride, sp);
}

// The slab-walking instance only where a block's segments overflow a slab.
template <typename T, int VB, bool COUNTERS, bool PLAN>
int launch_split_vb(const float* x, const T* tab, T* out, int* stats,
                    const int* plan, int B, int G, int O, int n, int pw,
                    int bits, int zp, float scale, long long seg_stride,
                    cudaStream_t stream) {
  const Split sp = split_for(B, G, O, (int)sizeof(T));
  if (split_slabs(sp, G))
    return launch_split_slabs<T, VB, COUNTERS, PLAN, true>(
        x, tab, out, stats, plan, B, G, O, n, pw, bits, zp, scale,
        seg_stride, sp, stream);
  return launch_split_slabs<T, VB, COUNTERS, PLAN, false>(
      x, tab, out, stats, plan, B, G, O, n, pw, bits, zp, scale, seg_stride,
      sp, stream);
}

template <typename T, bool COUNTERS, bool PLAN>
int launch_split(const float* x, const T* tab, T* out, int* stats,
                 const int* plan, int B, int G, int O, int n, int pw,
                 int bits, int zp, float scale, long long seg_stride,
                 cudaStream_t stream) {
  return with_load_width(tab, O, seg_stride, [&](auto vb) {
    return launch_split_vb<T, decltype(vb)::value, COUNTERS, PLAN>(
        x, tab, out, stats, plan, B, G, O, n, pw, bits, zp, scale,
        seg_stride, stream);
  });
}

// ---------------------------------------------------------------------------
// "direct"
// ---------------------------------------------------------------------------

constexpr int kTileO = 128;

template <typename T, bool COUNTERS, bool PLAN>
__global__ void gemv_direct_kernel(const float* __restrict__ x,
                                   const T* __restrict__ tab,
                                   T* __restrict__ out,
                                   int* __restrict__ stats, int B, int G,
                                   int O, int pw, int bits, int zp,
                                   float scale, long long seg_stride,
                                   const int* __restrict__ plan, int n) {
  extern __shared__ int off[];  // [B * G] packed offsets
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  const int kmax = (1 << bits) - 1;
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
int launch_direct(const float* x, const T* tab, T* out, int* stats,
                  const int* plan, int B, int G, int O, int n, int pw,
                  int bits, int zp, float scale, long long seg_stride,
                  cudaStream_t stream) {
  const size_t smem = (size_t)B * G * sizeof(int);
  dim3 block(kTileO, B < 8 ? B : 8);
  dim3 grid((O + kTileO - 1) / kTileO);
  cudaError_t err =
      pcilt::allow_smem(gemv_direct_kernel<T, COUNTERS, PLAN>, smem);
  if (err != cudaSuccess) return (int)err;
  gemv_direct_kernel<T, COUNTERS, PLAN><<<grid, block, smem, stream>>>(
      x, tab, out, stats, B, G, O, pw, bits, zp, scale, seg_stride, plan, n);
  return (int)cudaGetLastError();
}

// variant: 0 = "split", 1 = "direct".
template <typename T, bool COUNTERS, bool PLAN>
int launch_as(const float* x, const T* tab, T* out, int* stats,
              const int* plan, int B, int G, int O, int n, int pw, int bits,
              int zp, float scale, long long seg_stride, int variant,
              cudaStream_t stream) {
  if (variant == 0)
    return launch_split<T, COUNTERS, PLAN>(x, tab, out, stats, plan, B, G, O,
                                           n, pw, bits, zp, scale,
                                           seg_stride, stream);
  if (variant == 1)
    return launch_direct<T, COUNTERS, PLAN>(x, tab, out, stats, plan, B, G,
                                            O, n, pw, bits, zp, scale,
                                            seg_stride, stream);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch(const float* x, const T* tables, T* out, int* stats, int B, int G,
           int O, int pw, int bits, int zp, float scale, long long seg_stride,
           long long layer_off, int counters, int variant,
           cudaStream_t stream) {
  const T* tab = tables + layer_off;
  if (counters)
    return launch_as<T, true, false>(x, tab, out, stats, nullptr, B, G, O,
                                     G * pw, pw, bits, zp, scale, seg_stride,
                                     variant, stream);
  return launch_as<T, false, false>(x, tab, out, stats, nullptr, B, G, O,
                                    G * pw, pw, bits, zp, scale, seg_stride,
                                    variant, stream);
}

template <typename T>
int launch_plan(const float* x, const T* tables, T* out, const int* plan,
                int B, int G, int O, int n, int group, int bits, int zp,
                float scale, int variant, cudaStream_t stream) {
  return launch_as<T, false, true>(x, tables, out, nullptr, plan, B, G, O, n,
                                   group, bits, zp, scale,
                                   (long long)(1 << (bits * group)) * O,
                                   variant, stream);
}

}  // namespace

extern "C" int pcilt_gemv_fused_f32(const void* x, const void* tables,
                                    void* out, void* stats, int B, int G,
                                    int O, int pw, int bits, int zp,
                                    float scale, long long seg_stride,
                                    long long layer_off, int counters,
                                    int variant, void* stream) {
  return launch<float>((const float*)x, (const float*)tables, (float*)out,
                       (int*)stats, B, G, O, pw, bits, zp, scale, seg_stride,
                       layer_off, counters, variant, (cudaStream_t)stream);
}

extern "C" int pcilt_gemv_fused_bf16(const void* x, const void* tables,
                                     void* out, void* stats, int B, int G,
                                     int O, int pw, int bits, int zp,
                                     float scale, long long seg_stride,
                                     long long layer_off, int counters,
                                     int variant, void* stream) {
  return launch<__nv_bfloat16>((const float*)x,
                               (const __nv_bfloat16*)tables,
                               (__nv_bfloat16*)out, (int*)stats, B, G, O, pw,
                               bits, zp, scale, seg_stride, layer_off,
                               counters, variant, (cudaStream_t)stream);
}

// Plan launch: x [B, n], plan [G, group] int32 (-1 = unused slot), tables
// [G, V, O].
extern "C" int pcilt_gemv_plan_f32(const void* x, const void* tables,
                                   void* out, const void* plan, int B, int G,
                                   int O, int n, int group, int bits, int zp,
                                   float scale, int variant, void* stream) {
  return launch_plan<float>((const float*)x, (const float*)tables,
                            (float*)out, (const int*)plan, B, G, O, n, group,
                            bits, zp, scale, variant, (cudaStream_t)stream);
}

extern "C" int pcilt_gemv_plan_bf16(const void* x, const void* tables,
                                    void* out, const void* plan, int B, int G,
                                    int O, int n, int group, int bits, int zp,
                                    float scale, int variant, void* stream) {
  return launch_plan<__nv_bfloat16>(
      (const float*)x, (const __nv_bfloat16*)tables, (__nv_bfloat16*)out,
      (const int*)plan, B, G, O, n, group, bits, zp, scale, variant,
      (cudaStream_t)stream);
}

// The split design's constants and its split of one call, for kernels.ops
// to check its mirror against (pcilt_split.cuh write_config, write_plan).
extern "C" int pcilt_gemv_split_config(int* cfg) {
  return pcilt::split::write_config(cfg);
}

extern "C" int pcilt_gemv_split_plan(int B, int G, int O, int itemsize,
                                     int* out) {
  return pcilt::split::write_plan(B, G, O, itemsize, out);
}
