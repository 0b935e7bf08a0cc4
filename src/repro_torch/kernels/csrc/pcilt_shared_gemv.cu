// Shared-pool fused PCILT GEMV (paper extension 3):
//   out[b, o] = sum_g pool[seg_idx[g], pack(quant(x[b, g*group : ...])), o]
// accumulated in float32 and cast once to the pool dtype.  A pointer
// outside [0, X) selects no pool row and contributes nothing, as the
// reference's pointer-select does, and is never dereferenced.  Element
// offsets are 64-bit: the Mamba head's pool holds 384 x 256 x 50288 =
// 4.9e9 cells.
//
// Replaces: src/repro/kernels/pcilt_shared.py pcilt_shared_gemv_pallas.
//
// Bound: bytes — one O-wide pool row per distinct (pool row, offset) that
// the B*G pairs name (the logits head: ~1516 of 1536 rows of 50288 floats,
// 305 MB, 91 us at 3.35 TB/s), one add per byte fetched.  At B = 4 that is
// twice the dense weights' 154 MB, so torch.matmul stays ahead there; at
// B = 1 the rows are half the dense bytes.
//
// Two designs, chosen by the caller (kernels.ops; "split" unless forced):
//
// "split" (long row pieces, the segment loop split over a cluster):
//  1. A block owns a column tile of `warps` x 32 lanes x 16 bytes (1024
//     float32 columns, a 4 KB piece of every pool row it reads) and `rows`
//     batch rows (1, 2 or 4: the batch rounded up to a power of two).  A
//     lane owns 16 bytes of neighbouring columns and loads them with the
//     widest of 16/8/4/2 bytes that the pool's address and row pitch allow.
//  2. The segment loop is cut into `cluster` ascending slices, one a block
//     of a thread-block cluster (the cluster doubles until the grid has
//     kTargetBlocks blocks, but no slice falls under kMinSegs segments).
//     A block walks its slice in batches of kLoads / rows segments: every
//     row of the batch is loaded before the adds, so each lane keeps 128
//     bytes in flight whatever the batch.
//  3. A block quantizes and packs only its slice's offsets, once, and
//     resolves each (segment, row) into a pool row (-1: no row).  A row that
//     several batch rows name is loaded by each: the repeats hit L2, and
//     loading it once measured no faster on an H100.
//  4. Deterministic reduction: with a cluster, each block's sums go to its
//     shared memory, and the cluster sums them in ascending rank order
//     through distributed shared memory, each element by one thread.  No
//     float atomics: two launches are bit-identical, and every output is the
//     slices' ascending-segment sums added in slice order
//     (kernels.ops.shared_gemv_variant mirrors the split).
// Measured on an H100 (PERF.md §6): at the head, within ~10% of a probe
// that streams the same bytes contiguously, of which ~7 us is the launch,
// the quantize and the reduction (the kernel with no table loads); at B = 1
// under half the direct design's time.
//
// "direct" (the first design, kept for comparison and forceable): one
// block per 128-wide O tile and all B rows.  The block quantizes, packs
// and resolves the B*G pointers into pool-row indices in shared memory,
// then thread (tx, ty) owns column o and sums its rows with 4-byte loads
// of 512-byte row pieces.  The pool is read in place in both designs: no
// transpose and no padding of the O axis (the ragged edge is masked).
#include <cooperative_groups.h>

#include "pcilt_common.cuh"

namespace cg = cooperative_groups;

namespace {

using pcilt::add_raw;
using pcilt::RawOf;

// ---------------------------------------------------------------------------
// "split"
// ---------------------------------------------------------------------------

// The constants were tuned on an H100 with scripts/shared_dwconv_sweep.py,
// which rebuilds this source with other values of them.
constexpr int kRows = 4;            // batch rows a block, at most
constexpr int kWarps = 8;           // warps a block (its column tile)
constexpr int kLaneBytes = 16;      // columns a lane owns, in bytes
constexpr int kLoads = 8;           // row loads a lane issues a batch
constexpr int kTargetBlocks = 132;  // blocks the split aims for
constexpr int kMaxCluster = 16;     // blocks a cluster, a power of two
constexpr int kMinSegs = 4;         // least segments a slice
// The occupancy __launch_bounds__ asks for, and the H100 SM it must fit:
// blocks an SM, an SM's shared memory, the shared memory kept a block.
constexpr int kBlocksPerSm = 2;
constexpr int kSmSmemBytes = 228 * 1024;
constexpr int kBlockReservedSmem = 1024;
static_assert((kMaxCluster & (kMaxCluster - 1)) == 0 && kMaxCluster <= 16,
              "cluster sizes are powers of two up to 16");
static_assert(kRows == 4 && kLoads % kRows == 0,
              "a batch holds whole segments of 1, 2 or 4 rows");

struct Split {
  int rows;     // batch rows a block (1, 2 or 4)
  int warps;    // warps a block
  int cluster;  // blocks a cluster (one column tile's slices)
  int tile;     // columns a tile
  int tiles;    // column tiles
  int chunks;   // row chunks
};

__host__ __device__ inline Split split_for(int B, int G, int O,
                                           int itemsize) {
  Split s;
  s.rows = B >= 3 ? kRows : B;
  const int nv = kLaneBytes / itemsize;
  const int need = (O + 32 * nv - 1) / (32 * nv);
  s.warps = need < kWarps ? need : kWarps;
  s.tile = s.warps * 32 * nv;
  s.tiles = (O + s.tile - 1) / s.tile;
  s.chunks = (B + s.rows - 1) / s.rows;
  const long long base = (long long)s.tiles * s.chunks;
  int cs = 1;
  while (cs < kMaxCluster && base * cs < kTargetBlocks) cs *= 2;
  while (cs > 1 && cs * kMinSegs > G) cs /= 2;
  // then more ranks, each staging fewer segments' rows, until
  // kBlocksPerSm blocks fit an SM (a slice keeps kMinSegs segments)
  const long long sums = (long long)s.rows * s.tile * 4;
  while (cs < kMaxCluster && 2LL * cs * kMinSegs <= G &&
         kBlocksPerSm * (sums + (long long)(G + cs - 1) / cs * s.rows * 4 +
                         kBlockReservedSmem) > kSmSmemBytes)
    cs *= 2;
  s.cluster = cs;
  return s;
}

// Dynamic shared memory of a block: its float32 sums [rows][tile], then
// the pool rows of its slice [ceil(G / cluster)][rows] int32.
__host__ __device__ inline size_t split_smem_bytes(const Split& s, int G) {
  const size_t seg = (G + s.cluster - 1) / s.cluster;
  return (size_t)s.rows * s.tile * sizeof(float) +
         seg * s.rows * sizeof(int);
}

// A segment's R pool rows from shared memory, one vector load.
template <int R> struct RowsOf;
template <> struct RowsOf<1> {
  __device__ static void get(const int* p, int* r) { r[0] = p[0]; }
};
template <> struct RowsOf<2> {
  __device__ static void get(const int* p, int* r) {
    const int2 v = *reinterpret_cast<const int2*>(p);
    r[0] = v.x, r[1] = v.y;
  }
};
template <> struct RowsOf<4> {
  __device__ static void get(const int* p, int* r) {
    const int4 v = *reinterpret_cast<const int4*>(p);
    r[0] = v.x, r[1] = v.y, r[2] = v.z, r[3] = v.w;
  }
};

constexpr int kNoRow = -1;  // a (segment, row) that adds nothing

template <typename T, int VB, int R>
__global__ void __launch_bounds__(32 * kWarps, kBlocksPerSm)
    shared_split_kernel(const float* __restrict__ x,
                        const int* __restrict__ seg_idx,
                        const T* __restrict__ pool, T* __restrict__ out,
                        int B, int G, int X, int V, int O, int group,
                        int bits, int zp, float scale, Split sp) {
  constexpr int NV = kLaneBytes / sizeof(T);  // columns a lane owns
  constexpr int VEC = VB / sizeof(T);         // columns a load
  constexpr int NL = NV / VEC;                // loads a row
  constexpr int U = kLoads / R;               // segments a batch
  using Raw = typename RawOf<VB>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  float* part = reinterpret_cast<float*>(smem);
  int* s_row = reinterpret_cast<int*>(part + (size_t)R * sp.tile);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tile_i = blockIdx.x / sp.cluster;
  const int b0 = blockIdx.y * R;
  const int nb = min(R, B - b0);
  const int gb0 = (int)((long long)rank * G / sp.cluster);
  const int nseg = (int)((long long)(rank + 1) * G / sp.cluster) - gb0;
  const int n = G * group;

  // -- the slice's pool rows, [g - gb0][row]
  const int kmax = (1 << bits) - 1;
  for (int gl = threadIdx.x; gl < nseg; gl += blockDim.x) {
    const int g = gb0 + gl;
    const int p = seg_idx[g];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      int row = kNoRow;
      if (r < nb && p >= 0 && p < X) {
        const float* xs = x + (size_t)(b0 + r) * n + (size_t)g * group;
        int o = 0;
        for (int j = 0; j < group; ++j) {
          bool sat;
          o |= pcilt::quantize_code(xs[j], scale, zp, kmax, &sat)
               << (j * bits);
        }
        row = p * V + o;
      }
      s_row[gl * R + r] = row;
    }
  }
  __syncthreads();

  // -- fetch: every lane walks the slice in ascending g
  const int c = tile_i * sp.tile + threadIdx.x * NV;
  const T* pcol = pool + c;
  float acc[R][NV];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int k = 0; k < NV; ++k) acc[r][k] = 0.f;
  for (int g = 0; g < nseg; g += U) {
    Raw v[U][R][NL];
    int row[U][R];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (g + u < nseg) {
        RowsOf<R>::get(s_row + (g + u) * R, row[u]);
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r) row[u][r] = kNoRow;
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int k = 0; k < NL; ++k) {
          v[u][r][k] = Raw{};
          if (row[u][r] >= 0 && c + k * VEC < O)
            v[u][r][k] = __ldg(reinterpret_cast<const Raw*>(
                pcol + (long long)row[u][r] * O + k * VEC));
        }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int k = 0; k < NL; ++k)
          if (row[u][r] >= 0) add_raw<T, VB>(&acc[r][k * VEC], v[u][r][k]);
  }

  // -- one block: the sums are the output
  if (sp.cluster == 1) {
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int k = 0; k < NV; ++k)
        if (r < nb && c + k < O)
          out[(size_t)(b0 + r) * O + c + k] = pcilt::from_f32<T>(acc[r][k]);
    return;
  }

  // -- a cluster: the block's sums to shared memory, then the cluster's
  //    sum in ascending rank order, each element by one thread of one block
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int k = 0; k < NV; k += 4)
      *reinterpret_cast<float4*>(part + (size_t)r * sp.tile +
                                 threadIdx.x * NV + k) =
          make_float4(acc[r][k], acc[r][k + 1], acc[r][k + 2],
                      acc[r][k + 3]);
  cluster.sync();
  const int E = R * sp.tile;
  for (int e = rank * blockDim.x + threadIdx.x; e < E;
       e += sp.cluster * blockDim.x) {
    float peer[kMaxCluster];  // all the ranks' loads in flight, then adds
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q)
      if (q < sp.cluster) peer[q] = cluster.map_shared_rank(part, q)[e];
    float sum = peer[0];
#pragma unroll
    for (int q = 1; q < kMaxCluster; ++q)
      if (q < sp.cluster) sum += peer[q];
    const int r = e / sp.tile;
    const int col = tile_i * sp.tile + (e - r * sp.tile);
    if (r < nb && col < O)
      out[(size_t)(b0 + r) * O + col] = pcilt::from_f32<T>(sum);
  }
  cluster.sync();  // no block leaves while read
}

template <typename T, int VB, int R>
int launch_split_vb(const float* x, const int* seg_idx, const T* pool, T* out,
                    int B, int G, int X, int V, int O, int group, int bits,
                    int zp, float scale, cudaStream_t stream) {
  const Split sp = split_for(B, G, O, (int)sizeof(T));
  if (sp.chunks > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = split_smem_bytes(sp, G);
  auto kernel = shared_split_kernel<T, VB, R>;
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
  cfg.gridDim = dim3(sp.tiles * sp.cluster, sp.chunks);
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
  err = cudaLaunchKernelEx(&cfg, kernel, x, seg_idx, pool, out, B, G, X, V,
                           O, group, bits, zp, scale, sp);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The batch rows a block, then the widest load the pool's address and row
// pitch allow.
template <typename T, int R>
int launch_split_rows(const float* x, const int* seg_idx, const T* pool,
                      T* out, int B, int G, int X, int V, int O, int group,
                      int bits, int zp, float scale, cudaStream_t stream) {
  const unsigned long long a = (unsigned long long)(uintptr_t)pool |
                               (unsigned long long)O * sizeof(T);
#define PCILT_SHARED_VB(VB)                                               \
  return launch_split_vb<T, VB, R>(x, seg_idx, pool, out, B, G, X, V, O,  \
                                   group, bits, zp, scale, stream)
  if (a % 16 == 0) PCILT_SHARED_VB(16);
  if (a % 8 == 0) PCILT_SHARED_VB(8);
  if constexpr (sizeof(T) == 4) {
    PCILT_SHARED_VB(4);
  } else {
    if (a % 4 == 0) PCILT_SHARED_VB(4);
    PCILT_SHARED_VB(2);
  }
#undef PCILT_SHARED_VB
}

template <typename T>
int launch_split(const float* x, const int* seg_idx, const T* pool, T* out,
                 int B, int G, int X, int V, int O, int group, int bits,
                 int zp, float scale, cudaStream_t stream) {
  switch (split_for(B, G, O, (int)sizeof(T)).rows) {
    case 1:
      return launch_split_rows<T, 1>(x, seg_idx, pool, out, B, G, X, V, O,
                                     group, bits, zp, scale, stream);
    case 2:
      return launch_split_rows<T, 2>(x, seg_idx, pool, out, B, G, X, V, O,
                                     group, bits, zp, scale, stream);
    default:
      return launch_split_rows<T, 4>(x, seg_idx, pool, out, B, G, X, V, O,
                                     group, bits, zp, scale, stream);
  }
}

// ---------------------------------------------------------------------------
// "direct"
// ---------------------------------------------------------------------------

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
int launch_direct(const float* x, const int* seg_idx, const T* pool, T* out,
                  int B, int G, int X, int V, int O, int group, int bits,
                  int zp, float scale, cudaStream_t stream) {
  const size_t smem = (size_t)B * G * sizeof(int);
  dim3 block(kTileO, B < 8 ? B : 8);
  dim3 grid((O + kTileO - 1) / kTileO);
  cudaError_t err = pcilt::allow_smem(shared_gemv_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  shared_gemv_kernel<T><<<grid, block, smem, stream>>>(
      x, seg_idx, pool, out, B, G, X, V, O, group, bits, zp, scale);
  return (int)cudaGetLastError();
}

// variant: 0 = "split", 1 = "direct".
template <typename T>
int launch(const float* x, const int* seg_idx, const T* pool, T* out, int B,
           int G, int X, int V, int O, int group, int bits, int zp,
           float scale, int variant, cudaStream_t stream) {
  if (variant == 0)
    return launch_split<T>(x, seg_idx, pool, out, B, G, X, V, O, group, bits,
                           zp, scale, stream);
  if (variant == 1)
    return launch_direct<T>(x, seg_idx, pool, out, B, G, X, V, O, group,
                            bits, zp, scale, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int pcilt_shared_gemv_f32(const void* x, const void* seg_idx,
                                     const void* pool, void* out, int B,
                                     int G, int X, int V, int O, int group,
                                     int bits, int zp, float scale,
                                     int variant, void* stream) {
  return launch<float>((const float*)x, (const int*)seg_idx,
                       (const float*)pool, (float*)out, B, G, X, V, O, group,
                       bits, zp, scale, variant, (cudaStream_t)stream);
}

extern "C" int pcilt_shared_gemv_bf16(const void* x, const void* seg_idx,
                                      const void* pool, void* out, int B,
                                      int G, int X, int V, int O, int group,
                                      int bits, int zp, float scale,
                                      int variant, void* stream) {
  return launch<__nv_bfloat16>((const float*)x, (const int*)seg_idx,
                               (const __nv_bfloat16*)pool,
                               (__nv_bfloat16*)out, B, G, X, V, O, group,
                               bits, zp, scale, variant,
                               (cudaStream_t)stream);
}

// The split design's constants, for kernels.ops to check its mirror
// against: {rows a block, warps a block, bytes a lane, loads a batch,
// target blocks, largest cluster, least segments a slice, blocks an SM,
// an SM's shared memory, the shared memory kept a block}.
extern "C" int pcilt_shared_gemv_split_config(int* cfg) {
  cfg[0] = kRows;
  cfg[1] = kWarps;
  cfg[2] = kLaneBytes;
  cfg[3] = kLoads;
  cfg[4] = kTargetBlocks;
  cfg[5] = kMaxCluster;
  cfg[6] = kMinSegs;
  cfg[7] = kBlocksPerSm;
  cfg[8] = kSmSmemBytes;
  cfg[9] = kBlockReservedSmem;
  return 0;
}

// The split of one call: {rows, warps, cluster, tile, tiles, chunks,
// shared-memory bytes}.
extern "C" int pcilt_shared_gemv_split_plan(int B, int G, int O, int itemsize,
                                            int* out) {
  if (itemsize != 2 && itemsize != 4) return (int)cudaErrorInvalidValue;
  const Split s = split_for(B, G, O, itemsize);
  out[0] = s.rows;
  out[1] = s.warps;
  out[2] = s.cluster;
  out[3] = s.tile;
  out[4] = s.tiles;
  out[5] = s.chunks;
  out[6] = (int)split_smem_bytes(s, G);
  return 0;
}
