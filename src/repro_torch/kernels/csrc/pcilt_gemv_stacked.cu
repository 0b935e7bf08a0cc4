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
// Two designs, chosen by the caller (kernels.ops; "split" unless forced):
//
// "split" (split-K over G, for Hopper's 132 SMs):
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
#include <cooperative_groups.h>

#include "pcilt_common.cuh"

namespace cg = cooperative_groups;

namespace {

// ---------------------------------------------------------------------------
// "split"
// ---------------------------------------------------------------------------

// The constants were tuned on an H100 with scripts/gemv_split_sweep.py,
// which rebuilds this source with other values of them.
constexpr int kRows = 4;            // rows a block holds (an int4 of offsets)
constexpr int kWarps = 4;           // warps a block, at most
constexpr int kSegBatch = 4;        // segments a load batch
constexpr int kTargetBlocks = 264;  // blocks the split aims for (2 an SM)
constexpr int kMaxCluster = 16;     // blocks a cluster, a power of two
constexpr int kMinSegs = 1;         // least segments a slice
constexpr int kMaxLanes = 16;       // lanes a slot, at most
constexpr int kLaneBytes = 16;      // columns a lane owns, in bytes
// the dynamic shared memory a block may use (kernels.ops.SMEM_LIMIT)
constexpr long long kSmemLimit = 227 * 1024;
constexpr int kMaxGridRows = 65535;  // gridDim.y, the card's most
static_assert((kMaxCluster & (kMaxCluster - 1)) == 0 && kMaxCluster <= 16,
              "cluster sizes are powers of two up to 16");
static_assert(kRows == 4, "a segment's offsets are one int4");
static_assert(kMaxLanes == 8 || kMaxLanes == 16 || kMaxLanes == 32,
              "a slot is a power-of-two part of a warp");

struct Split {
  int lanes;    // lanes of a slot
  int groups;   // slots a warp
  int warps;    // warps a block
  int cluster;  // blocks a cluster (one output tile's slices)
  int tile;     // columns an output tile
  int tiles;    // output tiles
  int chunks;   // row chunks of kRows
  int slab;     // segments a block stages at once
};

__host__ __device__ inline Split split_for(int B, int G, int O,
                                           int itemsize) {
  Split s;
  const int nv = kLaneBytes / itemsize;
  const int need = (O + nv - 1) / nv;
  s.lanes = need < kMaxLanes ? need : kMaxLanes;
  s.groups = 32 / s.lanes;
  s.tile = s.lanes * nv;
  s.tiles = (O + s.tile - 1) / s.tile;
  s.chunks = (B + kRows - 1) / kRows;
  const long long base = (long long)s.tiles * s.chunks;
  int cs = 1;
  while (cs < kMaxCluster && base * cs < kTargetBlocks) cs *= 2;
  while (cs > 1 && (long long)cs * kWarps * s.groups * kMinSegs > G) cs /= 2;
  int w = kWarps;
  if (cs == 1)
    while (w > 1 && w * s.groups * kMinSegs > G) w /= 2;
  // then more ranks, each staging fewer segments' offsets, until a block's
  // shared memory fits (a wide G at many rows: the row chunks alone fill
  // the grid, so the loops above leave the cluster at 1)
  const long long sums = (long long)w * s.groups * kRows * s.tile * 4;
  while (cs < kMaxCluster && 2LL * cs * w * s.groups * kMinSegs <= G &&
         sums + (long long)(G + cs - 1) / cs * kRows * 4 > kSmemLimit)
    cs *= 2;
  s.cluster = cs;
  s.warps = w;
  // a block's ceil(G / cluster) segments in one slab, or in as many slabs
  // of the most segments that fit beside the partial sums
  const long long seg = (G + cs - 1) / cs;
  const long long room =
      (kSmemLimit - (long long)w * s.groups * kRows * s.tile * 4) /
      (kRows * 4);
  s.slab = (int)(seg < room ? seg : room);
  return s;
}

// Planes of the grid (gridDim.z): its rows hold kMaxGridRows row chunks.
__host__ __device__ inline int split_planes(const Split& s) {
  return (s.chunks + kMaxGridRows - 1) / kMaxGridRows;
}

// Dynamic shared memory of a block: the slots' partial sums
// [warps*groups][kRows][tile] float32, then the offsets of one slab of the
// block's segments [slab][kRows] int32.
__host__ __device__ inline size_t split_smem_bytes(const Split& s) {
  return (size_t)s.warps * s.groups * kRows * s.tile * sizeof(float) +
         (size_t)s.slab * kRows * sizeof(int);
}

using pcilt::add_raw;
using pcilt::RawOf;

// The split kernels' stages, shared by the one-pass kernel and the slab
// kernel.  Rows b0 .. b0 + nb - 1 (nb <= 0: a row chunk past the last one,
// which adds nothing); segments t0 .. t0 + ns - 1 staged.

// Quantize and pack the kRows x ns offsets (x coalesced along g) into
// s_off[g - t0][row]; the counters of their activations committed (every
// thread of the block calls it).
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

// A slot's segments ga .. ge - 1 (staged from t0) added to its sums, in
// ascending g: each batch's loads in flight before its adds.
template <typename T, int VB, int BATCH>
__device__ __forceinline__ void add_segments(
    float (&acc)[kRows][kLaneBytes / sizeof(T)], const T* tcol,
    const int4* offs, int t0, int ga, int ge, int nb, int c, int O,
    long long seg_stride) {
  constexpr int VEC = VB / sizeof(T);              // columns a load
  constexpr int NL = kLaneBytes / sizeof(T) / VEC;  // loads a row
  using Raw = typename RawOf<VB>::type;
  for (int g = ga; g < ge; g += BATCH) {
    Raw v[BATCH][kRows][NL];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int gg = g + u;
      const int4 o4 = gg < ge ? offs[gg - t0] : make_int4(0, 0, 0, 0);
      const int o[kRows] = {o4.x, o4.y, o4.z, o4.w};
      const T* seg = tcol + (long long)gg * seg_stride;
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int k = 0; k < NL; ++k) {
          v[u][r][k] = Raw{};
          if (gg < ge && r < nb && c + k * VEC < O)
            v[u][r][k] = __ldg(reinterpret_cast<const Raw*>(
                seg + (long long)o[r] * O + k * VEC));
        }
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u)
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int k = 0; k < NL; ++k)
          if (g + u < ge && r < nb)
            add_raw<T, VB>(&acc[r][k * VEC], v[u][r][k]);
  }
}

// A slot's sums into its place of the block's partial sums part.
template <typename T>
__device__ __forceinline__ void put_partials(
    const float (&acc)[kRows][kLaneBytes / sizeof(T)], float* p, int tile) {
  constexpr int NV = kLaneBytes / sizeof(T);
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int k = 0; k < NV; k += 4)
      *reinterpret_cast<float4*>(p + r * tile + k) =
          make_float4(acc[r][k], acc[r][k + 1], acc[r][k + 2], acc[r][k + 3]);
}

// The block's partial sums added in ascending slot order, then the
// cluster's in ascending rank order, each output element by one thread of
// one block, and stored (every thread of the cluster calls it, after the
// block's partial sums are written and a block barrier).
template <typename T>
__device__ __forceinline__ void reduce_store(cg::cluster_group& cluster,
                                             float* part, T* out, int rank,
                                             int tile_i, int b0, int nb,
                                             int O, int SB, int tile,
                                             int cs) {
  const int E = kRows * tile;
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    float sum = part[e];
    for (int sb = 1; sb < SB; ++sb) sum += part[(size_t)sb * E + e];
    part[e] = sum;
  }
  if (cs == 1) {
    __syncthreads();
  } else {
    cluster.sync();
  }
  for (int e = rank * blockDim.x + threadIdx.x; e < E;
       e += cs * blockDim.x) {
    float sum = part[e];
    if (cs > 1) {  // all the ranks' loads in flight, then the adds
      float peer[kMaxCluster];
#pragma unroll
      for (int q = 0; q < kMaxCluster; ++q)
        if (q < cs) peer[q] = cluster.map_shared_rank(part, q)[e];
      sum = peer[0];
#pragma unroll
      for (int q = 1; q < kMaxCluster; ++q)
        if (q < cs) sum += peer[q];
    }
    const int r = e / tile;
    const int col = tile_i * tile + (e - r * tile);
    if (r < nb && col < O)
      out[(size_t)(b0 + r) * O + col] = pcilt::from_f32<T>(sum);
  }
  if (cs > 1) cluster.sync();  // no block leaves while read
}

// segments a load batch: 2 in the counter and bfloat16 instances, which
// spilled at 255 registers with kSegBatch (scripts/gemv_split_sweep.py
// batch4 rebuilds them so; no slower at 2, PERF.md)
template <typename T, bool COUNTERS>
constexpr int kBatch = (COUNTERS || sizeof(T) == 2) ? 2 : kSegBatch;

// The one-pass kernel: a block's ceil(G / cluster) offsets fit its shared
// memory (every shape up to ~224,000 segments).  Row chunk blockIdx.y of
// grid plane blockIdx.z (past the grid's rows the chunks go on in further
// planes).  One resident block an SM is all the split asks (its grid is ~2
// blocks an SM); without the 1, ptxas capped some instances of both
// kernels at 64-128 registers and spilled, and the narrow decode shapes
// ran up to 1 us slower (scripts/gemv_split_sweep.py, PERF.md).
template <typename T, int VB, bool COUNTERS, bool PLAN>
__global__ void __launch_bounds__(32 * kWarps, 1)
    gemv_split_kernel(const float* __restrict__ x, const T* __restrict__ tab,
                      T* __restrict__ out, int* __restrict__ stats,
                      const int* __restrict__ plan, int B, int G, int O,
                      int n, int pw, int bits, int zp, float scale,
                      long long seg_stride, Split sp) {
  constexpr int NV = kLaneBytes / sizeof(T);  // columns a lane owns
  extern __shared__ __align__(16) unsigned char smem[];
  const int SB = sp.warps * sp.groups;  // slots a block
  const int E = kRows * sp.tile;        // partial sums a slot
  float* part = reinterpret_cast<float*>(smem);
  int* s_off = reinterpret_cast<int*>(part + (size_t)SB * E);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tile_i = blockIdx.x / sp.cluster;
  const int b0 = (blockIdx.z * kMaxGridRows + blockIdx.y) * kRows;
  const int nb = min(kRows, B - b0);
  const int S = sp.cluster * SB;
  const int gb0 = (int)((long long)rank * G / sp.cluster);
  const int nseg = (int)((long long)(rank + 1) * G / sp.cluster) - gb0;

  pack_offsets<COUNTERS, PLAN>(x, plan, s_off, stats, b0, nb, gb0, nseg, n,
                               pw, bits, zp, scale, tile_i == 0);
  __syncthreads();

  // -- fetch: slot sb of this block sums its slice in ascending g
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int grp = lane / sp.lanes;
  const int sl = lane - grp * sp.lanes;
  if (grp < sp.groups) {
    const int sb = warp * sp.groups + grp;
    const int s = rank * SB + sb;
    const int g0 = (int)((long long)s * G / S);
    const int g1 = (int)((long long)(s + 1) * G / S);
    const int c = tile_i * sp.tile + sl * NV;
    float acc[kRows][NV];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int k = 0; k < NV; ++k) acc[r][k] = 0.f;
    add_segments<T, VB, kBatch<T, COUNTERS>>(
        acc, tab + c, reinterpret_cast<const int4*>(s_off), gb0, g0, g1, nb,
        c, O, seg_stride);
    put_partials<T>(acc, part + (size_t)sb * E + sl * NV, sp.tile);
  }
  __syncthreads();
  reduce_store<T>(cluster, part, out, rank, tile_i, b0, nb, O, SB, sp.tile,
                  sp.cluster);
}

// The slab kernel: past a 16-block cluster's shared memory a block stages
// its segments slab by slab (sp.slab segments), each added to the same
// sums in ascending g, so the order of the sum is the one-pass order.
template <typename T, int VB, bool COUNTERS, bool PLAN>
__global__ void __launch_bounds__(32 * kWarps, 1)
    gemv_split_slabs_kernel(const float* __restrict__ x,
                            const T* __restrict__ tab, T* __restrict__ out,
                            int* __restrict__ stats,
                            const int* __restrict__ plan, int B, int G,
                            int O, int n, int pw, int bits, int zp,
                            float scale, long long seg_stride, Split sp) {
  constexpr int NV = kLaneBytes / sizeof(T);  // columns a lane owns
  extern __shared__ __align__(16) unsigned char smem[];
  const int SB = sp.warps * sp.groups;  // slots a block
  const int E = kRows * sp.tile;        // partial sums a slot
  float* part = reinterpret_cast<float*>(smem);
  int* s_off = reinterpret_cast<int*>(part + (size_t)SB * E);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tile_i = blockIdx.x / sp.cluster;
  const int b0 = (blockIdx.z * kMaxGridRows + blockIdx.y) * kRows;
  const int nb = min(kRows, B - b0);
  const int S = sp.cluster * SB;
  const int gb0 = (int)((long long)rank * G / sp.cluster);
  const int gb1 = (int)((long long)(rank + 1) * G / sp.cluster);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int grp = lane / sp.lanes;
  const int sl = lane - grp * sp.lanes;
  const int sb = warp * sp.groups + grp;
  const int s = rank * SB + sb;
  const int g0 = (int)((long long)s * G / S);
  const int g1 = (int)((long long)(s + 1) * G / S);
  const int c = tile_i * sp.tile + sl * NV;
  float acc[kRows][NV];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int k = 0; k < NV; ++k) acc[r][k] = 0.f;
  for (int t0 = gb0; t0 < gb1; t0 += sp.slab) {
    const int ns = min(sp.slab, gb1 - t0);
    if (t0 != gb0) __syncthreads();  // the last slab's offsets are read
    pack_offsets<COUNTERS, PLAN>(x, plan, s_off, stats, b0, nb, t0, ns, n,
                                 pw, bits, zp, scale, tile_i == 0);
    __syncthreads();
    add_segments<T, VB, kBatch<T, COUNTERS>>(
        acc, tab + c, reinterpret_cast<const int4*>(s_off), t0,
        grp < sp.groups ? max(g0, t0) : 0, grp < sp.groups
        ? min(g1, t0 + ns) : 0, nb, c, O, seg_stride);
  }
  if (grp < sp.groups)
    put_partials<T>(acc, part + (size_t)sb * E + sl * NV, sp.tile);
  __syncthreads();
  reduce_store<T>(cluster, part, out, rank, tile_i, b0, nb, O, SB, sp.tile,
                  sp.cluster);
}

template <typename T, int VB, bool COUNTERS, bool PLAN, bool SLABS>
int launch_split_slabs(const float* x, const T* tab, T* out, int* stats,
                       const int* plan, int B, int G, int O, int n, int pw,
                       int bits, int zp, float scale, long long seg_stride,
                       const Split& sp, cudaStream_t stream) {
  const size_t smem = split_smem_bytes(sp);
  auto kernel = SLABS ? gemv_split_slabs_kernel<T, VB, COUNTERS, PLAN>
                      : gemv_split_kernel<T, VB, COUNTERS, PLAN>;
  cudaError_t err = cudaSuccess;
  static size_t smem_allowed = 48 * 1024;  // this instance's, per process
  if (smem > smem_allowed) {
    err = pcilt::allow_smem(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    smem_allowed = smem;
  }
  static bool wide_clusters = false;
  if (sp.cluster > 8 && !wide_clusters) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
    wide_clusters = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(sp.tiles * sp.cluster,
                     sp.chunks < kMaxGridRows ? sp.chunks : kMaxGridRows,
                     split_planes(sp));
  cfg.blockDim = dim3(32 * sp.warps);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = sp.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, x, tab, out, stats, plan, B, G, O,
                           n, pw, bits, zp, scale, seg_stride, sp);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The slab-walking instance only where a block's segments overflow a slab.
template <typename T, int VB, bool COUNTERS, bool PLAN>
int launch_split_vb(const float* x, const T* tab, T* out, int* stats,
                    const int* plan, int B, int G, int O, int n, int pw,
                    int bits, int zp, float scale, long long seg_stride,
                    cudaStream_t stream) {
  const Split sp = split_for(B, G, O, (int)sizeof(T));
  if ((G + sp.cluster - 1) / sp.cluster > sp.slab)
    return launch_split_slabs<T, VB, COUNTERS, PLAN, true>(
        x, tab, out, stats, plan, B, G, O, n, pw, bits, zp, scale,
        seg_stride, sp, stream);
  return launch_split_slabs<T, VB, COUNTERS, PLAN, false>(
      x, tab, out, stats, plan, B, G, O, n, pw, bits, zp, scale, seg_stride,
      sp, stream);
}

// The widest load the table's address, row stride and segment stride allow.
template <typename T, bool COUNTERS, bool PLAN>
int launch_split(const float* x, const T* tab, T* out, int* stats,
                 const int* plan, int B, int G, int O, int n, int pw,
                 int bits, int zp, float scale, long long seg_stride,
                 cudaStream_t stream) {
  const unsigned long long a = (unsigned long long)(uintptr_t)tab |
                               (unsigned long long)O * sizeof(T) |
                               (unsigned long long)seg_stride * sizeof(T);
#define PCILT_SPLIT_VB(VB)                                                 \
  return launch_split_vb<T, VB, COUNTERS, PLAN>(x, tab, out, stats, plan,  \
                                                B, G, O, n, pw, bits, zp,  \
                                                scale, seg_stride, stream)
  if (a % 16 == 0) PCILT_SPLIT_VB(16);
  if (a % 8 == 0) PCILT_SPLIT_VB(8);
  if constexpr (sizeof(T) == 4) {
    PCILT_SPLIT_VB(4);
  } else {
    if (a % 4 == 0) PCILT_SPLIT_VB(4);
    PCILT_SPLIT_VB(2);
  }
#undef PCILT_SPLIT_VB
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

// The split design's constants, for kernels.ops to check its mirror
// against: {rows a block, warps a block, segments a load batch, target
// blocks, largest cluster, least segments a slice, lanes a slot, bytes a
// lane}.
extern "C" int pcilt_gemv_split_config(int* cfg) {
  cfg[0] = kRows;
  cfg[1] = kWarps;
  cfg[2] = kSegBatch;
  cfg[3] = kTargetBlocks;
  cfg[4] = kMaxCluster;
  cfg[5] = kMinSegs;
  cfg[6] = kMaxLanes;
  cfg[7] = kLaneBytes;
  return 0;
}

// The split of one call: {lanes, groups, warps, cluster, tile, tiles,
// chunks, shared-memory bytes, segments a slab, planes of the grid}.
extern "C" int pcilt_gemv_split_plan(int B, int G, int O, int itemsize,
                                     int* out) {
  if (itemsize != 2 && itemsize != 4) return (int)cudaErrorInvalidValue;
  const Split s = split_for(B, G, O, itemsize);
  out[0] = s.lanes;
  out[1] = s.groups;
  out[2] = s.warps;
  out[3] = s.cluster;
  out[4] = s.tile;
  out[5] = s.tiles;
  out[6] = s.chunks;
  out[7] = (int)split_smem_bytes(s);
  out[8] = s.slab;
  out[9] = split_planes(s);
  return 0;
}
