// The split-K GEMV over per-segment tables, shared by the fused GEMVs
// (kernels 1 and 8-11, pcilt_gemv_stacked.cu) and the host-packed GEMV and
// conv (kernels 6 and 7, pcilt_gemv.cu):
//   out[b, o] = sum_g T_g[off[b, g], o]
// T_g the [V, O] table of segment g, at element g * seg_stride of `tab`.
// The sources differ only in where a block's offsets come from, their
// "stage": kernel 9 quantizes and packs x, kernel 6 reads the caller's
// [M, G] int32 array.  The rule that splits a shape (split_for), the
// fetch, the fixed-order reduction and the launch are this one code, so
// kernels 6 and 9 split a shape alike and sum it in one order.  The design
// is described in pcilt_gemv_stacked.cu.
//
// A stage is called by every thread of a block as
//   stage(s_off, b0, nb, t0, ns, first_tile)
// and fills s_off[(g - t0) * kRows + r] for rows b0 .. b0 + kRows - 1 (nb of
// them real; nb <= 0 past the last row chunk) and segments t0 .. t0 + ns -
// 1; first_tile is true in the blocks of output tile 0 (kernel 9 counts its
// activations there only).  With CHECKED, a staged offset below 0 adds
// nothing: no load is made for it and its sum is kept as it is.
#pragma once

#include <cooperative_groups.h>

#include <type_traits>

#include "pcilt_common.cuh"

namespace pcilt {
namespace split {

// The constants were tuned on an H100 with scripts/gemv_split_sweep.py,
// which rebuilds the sources with other values of them.
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

// Whether a shape's block stages its segments in slabs (the slab kernel).
__host__ inline bool split_slabs(const Split& s, int G) {
  return (G + s.cluster - 1) / s.cluster > s.slab;
}

// A slot's segments ga .. ge - 1 (staged from t0) added to its sums, in
// ascending g: each batch's loads in flight before its adds.  With CHECKED
// a row whose staged offset is below 0 loads nothing and keeps its sum.
template <typename T, int VB, int BATCH, bool CHECKED>
__device__ __forceinline__ void add_segments(
    float (&acc)[kRows][kLaneBytes / sizeof(T)], const T* tcol,
    const int4* offs, int t0, int ga, int ge, int nb, int c, int O,
    long long seg_stride) {
  constexpr int VEC = VB / sizeof(T);              // columns a load
  constexpr int NL = kLaneBytes / sizeof(T) / VEC;  // loads a row
  static_assert(BATCH * kRows <= 32, "a bad-row bit a (segment, row)");
  using Raw = typename RawOf<VB>::type;
  for (int g = ga; g < ge; g += BATCH) {
    Raw v[BATCH][kRows][NL];
    unsigned bad = 0u;  // bit u * kRows + r: row r of segment g + u
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int gg = g + u;
      const int4 o4 = gg < ge ? offs[gg - t0] : make_int4(0, 0, 0, 0);
      const int o[kRows] = {o4.x, o4.y, o4.z, o4.w};
      const T* seg = tcol + (long long)gg * seg_stride;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (CHECKED && o[r] < 0) bad |= 1u << (u * kRows + r);
#pragma unroll
        for (int k = 0; k < NL; ++k) {
          v[u][r][k] = Raw{};
          if (gg < ge && r < nb && (!CHECKED || o[r] >= 0) &&
              c + k * VEC < O)
            v[u][r][k] = __ldg(reinterpret_cast<const Raw*>(
                seg + (long long)o[r] * O + k * VEC));
        }
      }
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u)
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int k = 0; k < NL; ++k)
          if (g + u < ge && r < nb &&
              !(CHECKED && ((bad >> (u * kRows + r)) & 1u)))
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
__device__ __forceinline__ void reduce_store(
    cooperative_groups::cluster_group& cluster, float* part, T* out,
    int rank, int tile_i, int b0, int nb, int O, int SB, int tile, int cs) {
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

// The body of the one-pass kernel: a block's ceil(G / cluster) offsets fit
// its shared memory (every shape up to ~224,000 segments).  Row chunk
// blockIdx.y of grid plane blockIdx.z (past the grid's rows the chunks go
// on in further planes).
template <typename T, int VB, int BATCH, bool CHECKED, typename Stage>
__device__ __forceinline__ void one_pass(const Stage& stage,
                                         const T* __restrict__ tab,
                                         T* __restrict__ out, int B, int G,
                                         int O, long long seg_stride,
                                         const Split& sp) {
  constexpr int NV = kLaneBytes / sizeof(T);  // columns a lane owns
  extern __shared__ __align__(16) unsigned char split_smem[];
  const int SB = sp.warps * sp.groups;  // slots a block
  const int E = kRows * sp.tile;        // partial sums a slot
  float* part = reinterpret_cast<float*>(split_smem);
  int* s_off = reinterpret_cast<int*>(part + (size_t)SB * E);

  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tile_i = blockIdx.x / sp.cluster;
  const int b0 = (blockIdx.z * kMaxGridRows + blockIdx.y) * kRows;
  const int nb = min(kRows, B - b0);
  const int S = sp.cluster * SB;
  const int gb0 = (int)((long long)rank * G / sp.cluster);
  const int nseg = (int)((long long)(rank + 1) * G / sp.cluster) - gb0;

  stage(s_off, b0, nb, gb0, nseg, tile_i == 0);
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
    add_segments<T, VB, BATCH, CHECKED>(
        acc, tab + c, reinterpret_cast<const int4*>(s_off), gb0, g0, g1, nb,
        c, O, seg_stride);
    put_partials<T>(acc, part + (size_t)sb * E + sl * NV, sp.tile);
  }
  __syncthreads();
  reduce_store<T>(cluster, part, out, rank, tile_i, b0, nb, O, SB, sp.tile,
                  sp.cluster);
}

// The body of the slab kernel: past a 16-block cluster's shared memory a
// block stages its segments slab by slab (sp.slab segments), each added to
// the same sums in ascending g, so the order of the sum is the one-pass
// order.
template <typename T, int VB, int BATCH, bool CHECKED, typename Stage>
__device__ __forceinline__ void slab_pass(const Stage& stage,
                                          const T* __restrict__ tab,
                                          T* __restrict__ out, int B, int G,
                                          int O, long long seg_stride,
                                          const Split& sp) {
  constexpr int NV = kLaneBytes / sizeof(T);  // columns a lane owns
  extern __shared__ __align__(16) unsigned char split_smem[];
  const int SB = sp.warps * sp.groups;  // slots a block
  const int E = kRows * sp.tile;        // partial sums a slot
  float* part = reinterpret_cast<float*>(split_smem);
  int* s_off = reinterpret_cast<int*>(part + (size_t)SB * E);

  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
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
    stage(s_off, b0, nb, t0, ns, tile_i == 0);
    __syncthreads();
    add_segments<T, VB, BATCH, CHECKED>(
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

// What one kernel instance has been allowed so far in this process (the
// caller keeps one a kernel instance).
struct KernelState {
  size_t smem_allowed = 48 * 1024;
  bool wide_clusters = false;
};

// One launch of a split kernel over sp: the grid of gemv_grid (tiles *
// cluster blocks by the row chunks, further planes past the grid's rows),
// the cluster as a launch attribute, the non-portable cluster size allowed
// where the cluster passes 8.
template <typename Kernel, typename... Args>
int launch_cluster(Kernel kernel, const Split& sp, KernelState& st,
                   cudaStream_t stream, Args... args) {
  const size_t smem = split_smem_bytes(sp);
  cudaError_t err = cudaSuccess;
  if (smem > st.smem_allowed) {
    err = pcilt::allow_smem(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    st.smem_allowed = smem;
  }
  if (sp.cluster > 8 && !st.wide_clusters) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
    st.wide_clusters = true;
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
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// launch(std::integral_constant<int, VB>{}) for the widest load VB of 16,
// 8, 4 (and 2 for bfloat16) bytes that the table's address, its row
// stride O and its segment stride allow.
template <typename T, typename Launch>
int with_load_width(const T* tab, int O, long long seg_stride,
                    Launch&& launch) {
  const unsigned long long a = (unsigned long long)(uintptr_t)tab |
                               (unsigned long long)O * sizeof(T) |
                               (unsigned long long)seg_stride * sizeof(T);
  if (a % 16 == 0) return launch(std::integral_constant<int, 16>{});
  if (a % 8 == 0) return launch(std::integral_constant<int, 8>{});
  if constexpr (sizeof(T) == 4) {
    return launch(std::integral_constant<int, 4>{});
  } else {
    if (a % 4 == 0) return launch(std::integral_constant<int, 4>{});
    return launch(std::integral_constant<int, 2>{});
  }
}

// The split's constants, for kernels.ops to check its mirror against:
// {rows a block, warps a block, segments a load batch, target blocks,
// largest cluster, least segments a slice, lanes a slot, bytes a lane}.
inline int write_config(int* cfg) {
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
inline int write_plan(int B, int G, int O, int itemsize, int* out) {
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

}  // namespace split
}  // namespace pcilt
