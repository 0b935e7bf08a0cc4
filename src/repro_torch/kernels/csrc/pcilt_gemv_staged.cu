// Fused PCILT GEMV, kernel 9's "staged" design (many rows; V <= 256):
//   out[b, o] = sum_g T_g[pack(quant(x[b, g*pw : (g+1)*pw])), o]
// T_g the [V, O] table of segment g, at element layer_off + g * seg_stride
// of the table array; accumulated in float32 and cast once to the table
// dtype.  The function and the arguments of pcilt_gemv_stacked.cu's fused
// launch, whose "split" design serves the decode-size calls
// (kernels.ops.gemv_fused_variant chooses between them by rows and bytes
// a segment; gemv_staged_plan mirrors this design's plan), in a source of
// its own so that both build in parallel.
//
// Replaces: src/repro/kernels/pcilt_fused.py pcilt_fused_gemv_pallas (the
// reference has no counter variant; the counter instances serve the
// wrapper's counter launch).
//
// Bound: bytes, the distinct table rows a call's offsets name (each
// (segment, row named, column tile) read once), then, as the rows grow,
// the whole table; at llava-next-mistral-7b's down projection (B 32, G
// 14336, V 16, O 4096, float32) ~1.9 GB, 0.57 ms at 3.35 TB/s, of a 3.76
// GB table.  The split reads one O-wide row per (row, segment): 7.5 GB
// there, 2x the table, since each of its 8 row chunks of 4 re-reads the
// rows the others read, a sweep of ~1 GB apiece that the 50 MB L2 cannot
// carry from one chunk to the next.  This design reads a row once for all
// the rows of a tile:
//  1. A block owns a row tile (all the call's rows up to its largest: 32
//     float32 rows, 16 bfloat16, in the wide layout; 512 / 256 in the
//     narrow one: rpt rows a thread, a template choice, at most 32 float32
//     sums a thread: 64 spilled at the 128 registers the occupancy
//     leaves), a column tile and the segments of its rank of a
//     thread-block cluster (up to 16 with the non-portable size: the
//     cluster that runs the tiles in the fewest waves of the SMs' block
//     slots).  Past 65535 row tiles the tiles go on in further planes of
//     the grid.
//  2. Stage: the block quantizes and packs its row tile x (its segments)
//     offsets once, as bytes, into shared memory, with kernel 9's
//     arithmetic (a true division, round half to even), marking each
//     named table row in its segment's row mask; past shared memory it
//     stages its segments slab by slab.  The counter variant counts only
//     in the blocks of column tile 0.
//  3. Fetch: for each segment the rows its mask names, of the column tile,
//     are copied by 16-byte cp.async (8, 4 or element by element where
//     the table's alignment asks) into a ring of 4 slices, 3 segments
//     ahead; every thread adds its rows' cells from shared memory into
//     float32 registers, one byte of offset (a broadcast) and one 16-byte
//     read a row.  Wide layout (V <= 16): 512 B slice rows (128 float32
//     columns) read by a whole warp, a row at a time, in blocks of 128
//     threads, four an SM (56 KB each); narrow: 128 B rows (32 columns)
//     read by 8 lanes, 4 rows at a time, in blocks of 512 threads, one an
//     SM.  The barrier each segment takes leaves a block waiting on its
//     copies at few rows: one 512-thread block an SM ran llava's down
//     projection in 1.74 ms, two of 256 in 1.31, four of 128 in 1.26;
//     fetching 2-4 segments a barrier, a deeper ring, or copies through
//     registers did not help (scripts/gemv_split_sweep.py st:*; PERF.md).
//     The fetch is B*G*O 4-byte reads of on-chip memory (1.88e9 at
//     llava's shape, ~0.23 ms at 128 B a clock per SM), under the bytes
//     bound.
//  4. Deterministic reduction: ascending g within a rank, then the
//     cluster's partial sums (the ring reused) read through distributed
//     shared memory and added in ascending rank order, each output element
//     by one thread.  No float atomics: two launches are bit-identical.
//
#include <cooperative_groups.h>

#include <type_traits>

#include "pcilt_common.cuh"
#include "pcilt_split.cuh"

namespace {

namespace fstaged {

using pcilt::staged::cp_async;
using pcilt::staged::cp_async_commit;
using pcilt::staged::cp_async_wait;

// The constants were chosen on an H100 with scripts/gemv_split_sweep.py
// (x:rows and the st:* variants rebuild the source with other values).
constexpr int kWideWarps = 4;            // warps a block, wide layout
constexpr int kWideBlocks = 4;           // blocks an SM, wide layout
constexpr int kWideRing = 4;             // ring slices, wide layout
constexpr int kNarrowWarps = 16;         // warps a block, narrow layout
constexpr int kNarrowRing = 4;           // ring slices, narrow layout
constexpr int kMaxSums = 32;             // float32 sums a thread, at most
constexpr int kMaxV = 256;               // offsets are bytes
constexpr int kWideMaxV = 16;            // V of the wide layout, at most
constexpr int kMaxCluster = 16;          // blocks a cluster, a power of two
constexpr int kMinSegs = 16;             // least segments a rank
constexpr int kSms = 132;                // an H100's SMs
constexpr long long kSmemLimit = 227 * 1024;  // a block's, narrow layout
constexpr long long kSmemSm = 228 * 1024;     // an SM's
constexpr long long kSmemReserved = 1024;     // reserved a block
constexpr int kMaxGridRows = 65535;      // gridDim.y, the card's most
static_assert((kMaxCluster & (kMaxCluster - 1)) == 0 && kMaxCluster <= 16,
              "cluster sizes are powers of two up to 16");

// The column layouts.  Wide (V <= kWideMaxV): a row of the slice is 512 B
// (128 float32 columns), read by a whole warp (32 lanes, a 16-byte vector
// each), one row at a time.  Narrow: a row is 128 B, read by 8 lanes, four
// rows at a time.  A quarter warp then reads 128 contiguous bytes of one
// row: no bank conflict in either layout.
__host__ __device__ constexpr int lanes_of(bool wide) { return wide ? 32 : 8; }
__host__ __device__ constexpr int slots_of(bool wide) {
  return 32 / lanes_of(wide);  // rows a warp reads at once
}
__host__ __device__ constexpr int row_bytes(bool wide) {
  return 16 * lanes_of(wide);  // 512 or 128: a 16-byte vector a lane
}
// Threads a block and blocks an SM (its __launch_bounds__): the wide
// layout's few rows leave a block's barriers waiting on its copies, so four
// blocks share an SM and some fetch while others wait; and the shared
// memory each may take.
__host__ __device__ constexpr int threads_of(bool wide) {
  return 32 * (wide ? kWideWarps : kNarrowWarps);
}
__host__ __device__ constexpr int blocks_of(bool wide) {
  return wide ? kWideBlocks : 1;
}
__host__ __device__ constexpr long long smem_limit_of(bool wide) {
  return wide ? kSmemSm / kWideBlocks - kSmemReserved : kSmemLimit;
}
// The slices of the ring: the fetched segment's and ring - 1 in flight
// ahead of it.
__host__ __device__ constexpr int ring_of(bool wide) {
  return wide ? kWideRing : kNarrowRing;
}
static_assert(kWideRing >= 2 && kNarrowRing >= 2,
              "the ring holds the fetched slice and at least one ahead");

// Rows a thread sums: kMaxSums / (its sums a row: a 16-byte vector of
// columns), and its half and quarter, the template choices of each cell
// size (64 sums a thread spilled at the 128 registers of 512 threads an
// SM).  The row tile is rpt * slots * warps rows: 8 to 32 (bfloat16: 4 to
// 16) wide, 128 to 512 (64 to 256) narrow.
__host__ __device__ constexpr int max_rpt(int item) {
  return kMaxSums / (16 / item);
}
__host__ __device__ inline int rpt_choice(int item, int i) {
  return max_rpt(item) >> (2 - i);
}

struct Plan {
  int wide;     // 1: the 1 KB column layout, 0: the 128 B one
  int rpt;      // rows a thread
  int rows;     // rows a block (the row tile)
  int cols;     // columns a block (the column tile)
  int rtiles;   // row tiles
  int ctiles;   // column tiles
  int cluster;  // blocks a cluster: the segment loop cut in cluster ranks
  int slab;     // segments a block stages at once
};

// The ring and, past a 1-block cluster, the float32 partial sums [rows]
// [cols] that reuse it once the segment loop is done.
__host__ __device__ inline long long region_bytes(const Plan& p, int V) {
  const long long ring = (long long)ring_of(p.wide) * V * row_bytes(p.wide);
  const long long part = p.cluster > 1 ? (long long)p.rows * p.cols * 4 : 0;
  return ring > part ? ring : part;
}

// Words of a segment's row mask (a bit for each table row a row names).
__host__ __device__ inline int mask_words(int V) { return (V + 31) / 32; }

__host__ __device__ inline Plan plan_for(int B, int G, int V, int O,
                                         int item) {
  Plan p;
  p.wide = V <= kWideMaxV;
  const int per = slots_of(p.wide) * threads_of(p.wide) / 32;
  p.rpt = rpt_choice(item, 2);
  for (int i = 0; i < 3; ++i)
    if (rpt_choice(item, i) * per >= B) {
      p.rpt = rpt_choice(item, i);
      break;
    }
  p.rows = p.rpt * per;
  p.cols = row_bytes(p.wide) / item;
  p.rtiles = (int)(((long long)B + p.rows - 1) / p.rows);
  p.ctiles = (O + p.cols - 1) / p.cols;
  // the cluster that runs the work in the fewest waves of the SMs' block
  // slots for each block's share, by a sixteenth at least (else the
  // smaller: its reduction is cheaper), no rank under kMinSegs
  const long long base = (long long)p.rtiles * p.ctiles;
  const long long slots = (long long)kSms * blocks_of(p.wide);
  int best = 1;
  long long best_waves = (base + slots - 1) / slots;
  for (int cs = 2; cs <= kMaxCluster && G / cs >= kMinSegs; cs *= 2) {
    const long long waves = (base * cs + slots - 1) / slots;
    if (waves * best * 16 < best_waves * cs * 15) {
      best = cs;
      best_waves = waves;
    }
  }
  p.cluster = best;
  const long long seg = (G + best - 1) / best;
  const long long room = (smem_limit_of(p.wide) - region_bytes(p, V)) /
                         (p.rows + 4LL * mask_words(V));
  p.slab = (int)(seg < room ? seg : room);
  return p;
}

// Dynamic shared memory of a block: the region, then the slab's offset
// bytes [slab][rows], then its row masks [slab][mask_words(V)].
__host__ __device__ inline size_t smem_bytes(const Plan& p, int V) {
  return (size_t)region_bytes(p, V) +
         (size_t)p.slab * (p.rows + 4 * mask_words(V));
}

__host__ __device__ inline int planes(const Plan& p) {
  return (p.rtiles + kMaxGridRows - 1) / kMaxGridRows;
}

// The rows of one slice that the row mask marks: row v of T_g[:, c0:c0 +
// ncols] (src = its row 0) into dst + v * CB, VB bytes a cp.async (0:
// element by element through registers: a bfloat16 table of odd O).
template <typename T, int VB, int CB, int NT>
__device__ __forceinline__ void copy_rows(unsigned char* dst, const T* src,
                                          const unsigned* mask, int V,
                                          long long O, int ncols) {
  if constexpr (VB == 0) {
    constexpr int C = CB / (int)sizeof(T);
    for (int i = threadIdx.x; i < V * C; i += NT) {
      const int v = i / C, c = i - v * C;
      if (((mask[v >> 5] >> (v & 31)) & 1u) && c < ncols)
        reinterpret_cast<T*>(dst + v * CB)[c] = src[v * O + c];
    }
  } else {
    constexpr int kPer = CB / VB;  // copies a row
    constexpr int E = VB / (int)sizeof(T);
    for (int i = threadIdx.x; i < V * kPer; i += NT) {
      const int v = i / kPer, c = i - v * kPer;
      if (((mask[v >> 5] >> (v & 31)) & 1u) && c * E < ncols)
        cp_async<VB>(dst + v * CB + c * VB, src + v * O + c * E);
    }
  }
}

template <typename T, int CB, int NT>
__device__ __forceinline__ void copy_used(unsigned char* dst, const T* src,
                                          const unsigned* mask, int V,
                                          long long O, int ncols, int vb) {
  switch (vb) {
    case 16: copy_rows<T, 16, CB, NT>(dst, src, mask, V, O, ncols); break;
    case 8: copy_rows<T, 8, CB, NT>(dst, src, mask, V, O, ncols); break;
    case 4: copy_rows<T, 4, CB, NT>(dst, src, mask, V, O, ncols); break;
    default: copy_rows<T, 0, CB, NT>(dst, src, mask, V, O, ncols);
  }
}

// N offset bytes (a power of two, aligned to N up to 16) as words.
template <int N>
__device__ __forceinline__ void load_bytes(unsigned (&w)[(N + 3) / 4],
                                           const uint8_t* p) {
  if constexpr (N == 1) {
    w[0] = *p;
  } else if constexpr (N == 2) {
    w[0] = *reinterpret_cast<const unsigned short*>(p);
  } else if constexpr (N == 4) {
    w[0] = *reinterpret_cast<const unsigned*>(p);
  } else if constexpr (N == 8) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x;
    w[1] = v.y;
  } else {
    static_assert(N == 16, "offsets are read 16 bytes at most at a time");
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  }
}

// acc[i] += the staged cells of the thread's rows at one segment: row i of
// the thread is row i * RPW + s of its warp's (off: the warp's offset
// bytes), and its offset byte indexes the slice (a broadcast read of the
// offsets, then one 16-byte read of shared memory a row).
template <typename T, bool WIDE, int RPT>
__device__ __forceinline__ void fetch(float (&acc)[RPT][16 / sizeof(T)],
                                      const unsigned char* col,
                                      const uint8_t* off, int s) {
  constexpr int RPW = slots_of(WIDE), CB = row_bytes(WIDE);
  constexpr int NB = RPT * RPW;          // the warp's offset bytes
  constexpr int CH = NB < 16 ? NB : 16;  // bytes a read
  constexpr int RC = CH / RPW;           // rows a read
#pragma unroll
  for (int c = 0; c < NB / CH; ++c) {
    unsigned w[(CH + 3) / 4];
    load_bytes<CH>(w, off + c * CH);
#pragma unroll
    for (int ii = 0; ii < RC; ++ii) {
      const int k = ii * RPW + s;
      const unsigned v = (w[k >> 2] >> ((k & 3) * 8)) & 0xffu;
      pcilt::add_raw<T, 16>(acc[c * RC + ii],
                            *reinterpret_cast<const uint4*>(col + v * CB));
    }
  }
}

// One block: row tile (blockIdx.z * kMaxGridRows + blockIdx.y), column
// tile blockIdx.x / cluster, segments [rank * G / cluster, (rank + 1) * G
// / cluster) of its cluster rank, staged slab by slab.
template <typename T, bool COUNTERS, bool WIDE, int RPT>
__global__ void __launch_bounds__(threads_of(WIDE), blocks_of(WIDE))
    gemv_staged_kernel(const float* __restrict__ x,
                       const T* __restrict__ tab, T* __restrict__ out,
                       int* __restrict__ stats, int B, int G, int O, int pw,
                       int bits, int zp, float scale, long long seg_stride,
                       Plan p, int vb) {
  constexpr int LPR = lanes_of(WIDE);
  constexpr int RPW = slots_of(WIDE), CB = row_bytes(WIDE);
  constexpr int R = ring_of(WIDE);        // ring slices
  constexpr int VEC = 16 / (int)sizeof(T);
  constexpr int NT = threads_of(WIDE);    // threads a block
  constexpr int NW = NT / 32;             // warps a block
  constexpr int RT = RPT * RPW * NW;      // rows a block
  constexpr int C = CB / (int)sizeof(T);  // columns a block
  extern __shared__ __align__(16) unsigned char smem[];
  const int V = 1 << (bits * pw);
  const int mw = mask_words(V);
  const int slot_bytes = V * CB;
  unsigned char* s_ring = smem;
  uint8_t* s_off = smem + region_bytes(p, V);           // [slab][RT]
  unsigned* s_mask =
      reinterpret_cast<unsigned*>(s_off + (size_t)p.slab * RT);  // [slab][mw]

  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  const int cs = p.cluster;
  const int rank = (int)cluster.block_rank();
  const int ctile = blockIdx.x / cs;
  const int b0 = (int)(((long long)blockIdx.z * kMaxGridRows + blockIdx.y) *
                       RT);
  const int nb = min(RT, B - b0);
  const int c0 = ctile * C;
  const int ncols = min(C, O - c0);
  const int gb0 = (int)((long long)rank * G / cs);
  const int gb1 = (int)((long long)(rank + 1) * G / cs);
  const int n = G * pw;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int s = lane / LPR, q = lane - s * LPR;
  const int wrow0 = warp * RPT * RPW;  // the warp's first row
  const bool fetching = wrow0 < nb;    // uniform across the warp
  const int kmax = (1 << bits) - 1;
  const bool count_here = COUNTERS && ctile == 0;
  const T* tcol = tab + c0;

  float acc[RPT][VEC];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[i][k] = 0.f;

  for (int t0 = gb0; t0 < gb1; t0 += p.slab) {
    const int ns = min(p.slab, gb1 - t0);
    if (t0 != gb0) {  // the last slab's copies landed and were fetched
      cp_async_wait<0>();
      __syncthreads();
    }
    for (int i = threadIdx.x; i < ns * mw; i += NT) s_mask[i] = 0u;
    __syncthreads();
    // -- stage: the RT x ns offsets quantized and packed once (x read along
    //    g, coalesced), each marking its table row in its segment's mask; a
    //    row past B is byte 0 and marks nothing
    int cnt = 0;
    float ratio = 0.f;
    for (int r = warp; r < RT; r += NW) {
      const bool live = r < nb;
      const float* xr = x + (long long)(b0 + (live ? r : 0)) * n;
      for (int gl = lane; gl < ns; gl += 32) {
        int o = 0;
        if (live) {
          const float* xs = xr + (long long)(t0 + gl) * pw;
          for (int j = 0; j < pw; ++j) {
            const float xv = xs[j];
            bool sat;
            const int code = pcilt::quantize_code(xv, scale, zp, kmax, &sat);
            if (count_here) {
              cnt += sat ? 1 : 0;
              ratio = fmaxf(ratio, __fdiv_rn(fabsf(xv), scale));
            }
            o |= code << (j * bits);
          }
          atomicOr(&s_mask[gl * mw + (o >> 5)], 1u << (o & 31));
        }
        s_off[(size_t)gl * RT + r] = (uint8_t)o;
      }
    }
    if (count_here) pcilt::commit_stats(cnt, ratio, stats);
    __syncthreads();
    // -- fetch: segment gl's used rows copied R - 1 segments ahead into
    //    its ring slice, then every thread adds its rows' cells, in
    //    ascending g (one commit group a segment)
    auto issue = [&](int gl) {
      if (gl < ns)
        copy_used<T, CB, NT>(s_ring + (gl % R) * slot_bytes,
                             tcol + (long long)(t0 + gl) * seg_stride,
                             s_mask + gl * mw, V, O, ncols, vb);
      cp_async_commit();
    };
#pragma unroll 1
    for (int k = 0; k < R - 1; ++k) issue(k);
#pragma unroll 1
    for (int gl = 0; gl < ns; ++gl) {
      cp_async_wait<R - 2>();  // this thread's copies of slice gl
      __syncthreads();  // everyone's; slice (gl - 1) % R is free again
      issue(gl + R - 1);
      if (fetching)
        fetch<T, WIDE, RPT>(acc, s_ring + (gl % R) * slot_bytes + q * 16,
                            s_off + (size_t)gl * RT + wrow0, s);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for the partial sums

  if (cs == 1) {
    if (!fetching) return;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = wrow0 + i * RPW + s;
      if (r >= nb) continue;
      T* orow = out + (long long)(b0 + r) * O;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const int col = c0 + q * VEC + e;
        if (col < O) orow[col] = pcilt::from_f32<T>(acc[i][e]);
      }
    }
    return;
  }
  // -- the cluster's partial sums added in ascending rank order, each
  //    output element by one thread (all the ranks' loads in flight first)
  float* part = reinterpret_cast<float*>(s_ring);  // [RT][C]
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    float* prow = part + (size_t)(wrow0 + i * RPW + s) * C;
#pragma unroll
    for (int e = 0; e < VEC; e += 4)
      *reinterpret_cast<float4*>(prow + q * VEC + e) = make_float4(
          acc[i][e], acc[i][e + 1], acc[i][e + 2], acc[i][e + 3]);
  }
  cluster.sync();
  for (int e = rank * NT + (int)pcilt::fresh_tid_x(); e < RT * C;
       e += cs * NT) {
    const int r = e / C, col = c0 + (e - r * C);
    if (r >= nb || col >= O) continue;
    float peer[kMaxCluster];
#pragma unroll
    for (int k = 0; k < kMaxCluster; ++k)
      if (k < cs) peer[k] = cluster.map_shared_rank(part, k)[e];
    float sum = peer[0];
#pragma unroll
    for (int k = 1; k < kMaxCluster; ++k)
      if (k < cs) sum += peer[k];
    out[(long long)(b0 + r) * O + col] = pcilt::from_f32<T>(sum);
  }
  cluster.sync();  // no block leaves while read
}

// Widest cp.async (16, 8 or 4 bytes; 0: element by element) that every
// slice row allows: the table's address, O and the segment stride.
template <typename T>
int copy_width(const T* tab, int O, long long seg_stride) {
  const unsigned long long a = (unsigned long long)(uintptr_t)tab |
                               (unsigned long long)O * sizeof(T) |
                               (unsigned long long)seg_stride * sizeof(T);
  for (int w = 16; w >= 4; w /= 2)
    if (a % w == 0) return w;
  return 0;
}

template <typename T, bool COUNTERS, bool WIDE, int RPT>
int launch_staged_inst(const float* x, const T* tab, T* out, int* stats,
                       int B, int G, int O, int pw, int bits, int zp,
                       float scale, long long seg_stride, const Plan& p,
                       cudaStream_t stream) {
  static pcilt::split::KernelState state;  // this instance's, per process
  auto kernel = gemv_staged_kernel<T, COUNTERS, WIDE, RPT>;
  const size_t smem = smem_bytes(p, 1 << (bits * pw));
  cudaError_t err = cudaSuccess;
  if (smem > state.smem_allowed) {
    err = pcilt::allow_smem(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    state.smem_allowed = smem;
  }
  if (p.cluster > 8 && !state.wide_clusters) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
    state.wide_clusters = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.ctiles * p.cluster,
                     p.rtiles < kMaxGridRows ? p.rtiles : kMaxGridRows,
                     planes(p));
  cfg.blockDim = dim3(threads_of(WIDE));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, x, tab, out, stats, B, G, O, pw,
                           bits, zp, scale, seg_stride, p,
                           copy_width(tab, O, seg_stride));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The instance of the plan's layout and rows a thread.
template <typename T, bool COUNTERS>
int launch_staged(const float* x, const T* tab, T* out, int* stats, int B,
                  int G, int O, int pw, int bits, int zp, float scale,
                  long long seg_stride, cudaStream_t stream) {
  if (B < 1 || G < 1 || O < 1 || bits * pw > 8)
    return (int)cudaErrorInvalidValue;
  const Plan p = plan_for(B, G, 1 << (bits * pw), O, (int)sizeof(T));
  auto go = [&](auto wide, auto rpt) {
    return launch_staged_inst<T, COUNTERS, decltype(wide)::value,
                              decltype(rpt)::value>(
        x, tab, out, stats, B, G, O, pw, bits, zp, scale, seg_stride, p,
        stream);
  };
  constexpr int M = max_rpt(sizeof(T));  // 8 float32, 4 bfloat16
  auto in = [&](auto wide) {
    if (p.rpt == M) return go(wide, std::integral_constant<int, M>{});
    if (p.rpt == M / 2) return go(wide, std::integral_constant<int, M / 2>{});
    if (p.rpt == M / 4) return go(wide, std::integral_constant<int, M / 4>{});
    return (int)cudaErrorInvalidValue;
  };
  return p.wide ? in(std::true_type{}) : in(std::false_type{});
}

// The staged design's constants, for kernels.ops to check its mirror
// against: {warps a block, blocks an SM and ring slices of the wide
// layout; warps a block and ring slices of the narrow one; sums a thread,
// largest V, largest V of the wide layout, largest cluster, least segments
// a rank, SMs, the shared-memory limit of a wide and of a narrow block}.
inline int write_config(int* cfg) {
  cfg[0] = kWideWarps;
  cfg[1] = kWideBlocks;
  cfg[2] = kWideRing;
  cfg[3] = kNarrowWarps;
  cfg[4] = kNarrowRing;
  cfg[5] = kMaxSums;
  cfg[6] = kMaxV;
  cfg[7] = kWideMaxV;
  cfg[8] = kMaxCluster;
  cfg[9] = kMinSegs;
  cfg[10] = kSms;
  cfg[11] = (int)smem_limit_of(true);
  cfg[12] = (int)smem_limit_of(false);
  return 0;
}

// The staged plan of one call: {wide, rows a thread, row tile, column
// tile, row tiles, column tiles, cluster, segments a slab, shared-memory
// bytes, planes of the grid}.
inline int write_plan(int B, int G, int V, int O, int item, int* out) {
  if ((item != 2 && item != 4) || B < 1 || G < 1 || O < 1 || V < 1 ||
      V > kMaxV)
    return (int)cudaErrorInvalidValue;
  const Plan p = plan_for(B, G, V, O, item);
  out[0] = p.wide;
  out[1] = p.rpt;
  out[2] = p.rows;
  out[3] = p.cols;
  out[4] = p.rtiles;
  out[5] = p.ctiles;
  out[6] = p.cluster;
  out[7] = p.slab;
  out[8] = (int)smem_bytes(p, V);
  out[9] = planes(p);
  return 0;
}

}  // namespace fstaged

template <typename T>
int launch(const float* x, const T* tables, T* out, int* stats, int B, int G,
           int O, int pw, int bits, int zp, float scale, long long seg_stride,
           long long layer_off, int counters, cudaStream_t stream) {
  const T* tab = tables + layer_off;
  if (counters)
    return fstaged::launch_staged<T, true>(x, tab, out, stats, B, G, O, pw,
                                           bits, zp, scale, seg_stride,
                                           stream);
  return fstaged::launch_staged<T, false>(x, tab, out, stats, B, G, O, pw,
                                          bits, zp, scale, seg_stride, stream);
}

}  // namespace

// x [B, G*pw] float32, tables [.., G, V, O] (segment g at element
// layer_off + g * seg_stride), out [B, O]; stats {count, max ratio} when
// counters is set.
extern "C" int pcilt_gemv_staged_f32(const void* x, const void* tables,
                                     void* out, void* stats, int B, int G,
                                     int O, int pw, int bits, int zp,
                                     float scale, long long seg_stride,
                                     long long layer_off, int counters,
                                     void* stream) {
  return launch<float>((const float*)x, (const float*)tables, (float*)out,
                       (int*)stats, B, G, O, pw, bits, zp, scale, seg_stride,
                       layer_off, counters, (cudaStream_t)stream);
}

extern "C" int pcilt_gemv_staged_bf16(const void* x, const void* tables,
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

// The staged design's constants and its plan of one call, for kernels.ops
// to check its mirror against (fstaged::write_config, write_plan).
extern "C" int pcilt_gemv_staged_config(int* cfg) {
  return fstaged::write_config(cfg);
}

extern "C" int pcilt_gemv_staged_plan(int B, int G, int V, int O,
                                      int itemsize, int* out) {
  return fstaged::write_plan(B, G, V, O, itemsize, out);
}
