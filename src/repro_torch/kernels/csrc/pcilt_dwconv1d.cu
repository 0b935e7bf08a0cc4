// PCILT depthwise conv1d, fused and host-packed.
//
// Fused:
//   out[b, t, c] = T[c, sum_j code(x[b, t + j, c]) << (j * bits)]
// over a time-padded signal x [B, Tp, C] (To = Tp - k + 1 outputs), one
// table fetch per output, so the result is the table entry bit for bit.
// With counters, stats = {count of padded-signal elements the quantizer
// clipped, max |x| / scale}: each padded row is counted once — tap j of
// output t is row t + j, counted by the output with j == 0, and the last
// k - 1 rows by the last output (t == To - 1).  Pads are zeros, which
// quantize in range, so the count equals the count over the raw signal.
//
// Replaces: src/repro/kernels/pcilt_dwconv1d.py pcilt_fused_dwconv1d_pallas
// (and its counter body _fused_sat_kernel).
//
// Bound: bytes.  Each output is one scattered fetch from a [C, V] table of
// V = 2**(bits*k) entries per channel (65536 at 4 bits x 4 taps), so the
// least traffic is one 32-byte sector per fetch plus the signal read once
// and the output written once; there is no arithmetic to speak of.  At the
// decode window ([4, 4, 1792], one output a channel and slot) that is ~0.1
// us: the launch and two dependent trips to memory (the taps, then the
// table) are the time.  Two designs, chosen by the caller (kernels.ops;
// "tiled" unless forced):
//
// "tiled" (k <= kDwTiledMaxTaps = 8: the taps live in registers):
//  1. The channel and the output row come from the grid (channel tiles
//     times output rows b*To + t, strided past kDwTiledTargetBlocks
//     blocks), not from a 64-bit division per thread; all k taps are
//     loaded before any is quantized.
//  2. The grid follows the shape (dw_tiled_grid; kernels.ops mirrors it).
//     At the decode window ([4, 4, 1792]: one output row per slot) the two
//     dependent trips to memory (the taps, then the table) are the time,
//     so the design spreads them over the most SMs that one cluster holds:
//     a channel a lane, 4 tiles of 448 lanes x 4 rows, 16 blocks.  At the
//     full-sequence signal ([4, 2048, 1792]) a lane owns 4 adjacent
//     channels (16-byte taps and stores) where C % 4 == 0 and the
//     addresses allow, over tiles of 128 lanes, 1056 blocks of ~31 rows.
//  3. The counters are reduced without a buffer zeroed by the caller, so
//     the stats need no fill kernel before the launch (one launch fewer a
//     layer).  Where the data blocks fit one thread-block cluster (at most
//     kDwClusterBlocks = 16), the launch holds a second cluster as large
//     that counts over the padded signal (each element once: the count of
//     each padded row once), reading it once while the data blocks make
//     their two trips to memory; its warps' pairs go to its rank 0 through
//     distributed shared memory, which writes stats.  (Counting in the
//     data blocks and summing them in their own cluster ran 4.52-4.58 us
//     on an H100: the cluster barrier after the gathers cost ~1.1 us.)  A
//     larger grid adds its blocks' pairs into a scratch triple kept by
//     kernels.ops (zeroed once when made) and takes a ticket; the block
//     that takes the last ticket reads the totals into stats and zeroes
//     the triple for the next launch (launches sharing a triple must be
//     ordered: one stream; the ticket at the decode window ran 5.37 us).
//     The count stays exact and the ratio the exact max (an int sum and a
//     max: the blocks' order cannot change them); the ratio is max |x|
//     divided once by the scale, equal to the max of the divisions because
//     the division is monotone.
//
// "direct" (the first design, kept for comparison and forceable): one thread
// per output (b, t, c), neighbouring threads on neighbouring channels, the
// channel from a 64-bit modulo; the thread quantizes its k taps, packs them
// little-endian and makes its one fetch; each warp adds its counters to
// stats with atomics, so the caller zeroes stats before the launch.
//
// Host-packed:
//   out[b, t, c] = T[c, offsets[b, t, c]]
// over offsets [B, T, C] int32 that the caller quantized and packed; an
// offset outside [0, V) adds nothing (the reference's masked sum over the
// V entries matches none), so its output is 0.  One fetch per output, read
// as float32 and cast back once: exact for either table dtype.
// Replaces src/repro/kernels/pcilt_dwconv1d.py pcilt_dwconv1d_pallas.
// Bound: bytes — the offsets read once, the output written once and the
// distinct table cells fetched once (at the single-layer signal [4, 2048,
// 1792], V 256, float32: 119 MB, 35 us at 3.35 TB/s).  Two designs, chosen
// by the caller (kernels.ops; "staged" unless forced or V too large):
//
// "staged" (the table slice in shared memory, the offsets streamed):
//  1. A block owns kDwChans channels and a range of the M = B*T rows (the
//     grid: the channel tiles, times the row groups that bring it to
//     kDwTargetBlocks).  It stages its channels' [kDwChans, V] slice of the
//     table once — one contiguous run of the table, copied 16 bytes at a
//     time while its first offsets are already in flight — and its gathers
//     then read shared memory instead of L2.
//  2. It walks its rows kDwUnroll passes at a time, the next batch's
//     offsets loaded before this one gathers; a lane owns 4 adjacent
//     channels (1 when C is not a multiple of 4), loads their offsets as one
//     16-byte vector and stores their outputs as one vector; the channel
//     comes from the tile and the lane, so no 64-bit division is left.
//  3. The gathers' bank conflicts are left as they fall: a slice stored
//     transposed, whose gathers are free of them, measured no faster on an
//     H100, and staging it transposed cost more than the whole stream.
// The design serves V while the slice fits a block's shared memory
// (kernels.ops.dwconv_host_tiling mirrors the tiling); larger V (up to 65536
// at 4 bits x 4 taps) keeps the direct design.  Measured on an H100
// (PERF.md §6): within ~6% of a probe that copies the same offsets' bytes
// contiguously, under half the direct design's time.
//
// "direct" (the first design, kept for comparison and forceable): one thread
// per output, neighbouring threads on neighbouring channels, the channel
// from a 64-bit modulo, 4-byte offset loads and output stores, each fetch a
// 32-byte L2 sector of the table.
#include <cooperative_groups.h>

#include "pcilt_common.cuh"

namespace cg = cooperative_groups;

namespace {

template <typename T, bool COUNTERS>
__global__ void dwconv1d_kernel(const float* __restrict__ x,
                                const T* __restrict__ tab,
                                T* __restrict__ out, int* __restrict__ stats,
                                int B, int Tp, int C, int V, int k, int bits,
                                int zp, float scale) {
  const int To = Tp - k + 1;
  const long long total = (long long)B * To * C;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int kmax = (1 << bits) - 1;
  int cnt = 0;
  float ratio = 0.f;
  if (i < total) {
    const int c = (int)(i % C);
    const int t = (int)((i / C) % To);
    const int b = (int)(i / ((long long)C * To));
    const float* xs = x + ((size_t)b * Tp + t) * C + c;
    int o = 0;
    for (int j = 0; j < k; ++j) {
      const float xv = xs[(size_t)j * C];
      bool sat;
      const int code = pcilt::quantize_code(xv, scale, zp, kmax, &sat);
      if (COUNTERS) {
        if (sat && (j == 0 || t == To - 1)) ++cnt;
        ratio = fmaxf(ratio, __fdiv_rn(fabsf(xv), scale));
      }
      o |= code << (j * bits);
    }
    out[i] = tab[(size_t)c * V + o];
  }
  if (COUNTERS) pcilt::commit_stats(cnt, ratio, stats);
}

template <typename T>
int launch_direct(const float* x, const T* tab, T* out, int* stats, int B,
                  int Tp, int C, int V, int k, int bits, int zp, float scale,
                  int counters, cudaStream_t stream) {
  const long long total = (long long)B * (Tp - k + 1) * C;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  if (counters) {
    dwconv1d_kernel<T, true><<<blocks, threads, 0, stream>>>(
        x, tab, out, stats, B, Tp, C, V, k, bits, zp, scale);
  } else {
    dwconv1d_kernel<T, false><<<blocks, threads, 0, stream>>>(
        x, tab, out, stats, B, Tp, C, V, k, bits, zp, scale);
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Fused, "tiled"
// ---------------------------------------------------------------------------

// The constants were chosen on an H100 with scripts/host_gemv_sweep.py.
constexpr int kDwTiledThreads = 512;         // lanes a channel tile (at most)
constexpr int kDwWideLanes = 128;            // ... of a 4-channel-lane tile
constexpr int kDwTiledTargetBlocks = 1056;   // 8 blocks an SM of 132
constexpr int kDwTiledMaxTaps = 8;           // k the tiled design serves
constexpr int kDwClusterBlocks = 16;         // largest grid summed in a cluster

// How a tiled launch reduces its counters across blocks.
enum StatsMode { kNoStats = 0, kClusterStats = 1, kTicketStats = 2 };

// The counters of one thread -> the call's stats (see the design note, 3.):
// a warp's sum and max (a non-negative float's bits order like the float,
// so its max is one integer reduction), then, in the counting cluster, each
// warp's pair goes straight into rank 0's slots (rank 0 has started: every
// block arrived at the barrier phase when it began), one cluster barrier,
// and rank 0's first warp sums the slots into stats.  stats[1] is max |x|
// / scale: the division is monotone, so dividing the max once equals the
// max of the divisions.  Every thread of the block must call this.
__device__ __forceinline__ void cluster_stats(int cnt, float amax,
                                              float scale, int* stats) {
  constexpr int kWarps = kDwTiledThreads / 32;
  __shared__ int s_cnt[kDwClusterBlocks * kWarps];
  __shared__ unsigned s_abits[kDwClusterBlocks * kWarps];
  cnt = __reduce_add_sync(0xffffffffu, cnt);
  unsigned abits = __reduce_max_sync(0xffffffffu, __float_as_uint(amax));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = (int)(blockDim.x + 31) / 32;
  cg::cluster_group cluster = cg::this_cluster();
  const int slot = (int)cluster.block_rank() * nwarps + warp;
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (lane == 0) {
    *cluster.map_shared_rank(s_cnt + slot, 0) = cnt;
    *cluster.map_shared_rank(s_abits + slot, 0) = abits;
  }
  cluster.sync();
  if (cluster.block_rank() != 0 || warp != 0) return;
  const int n = (int)cluster.num_blocks() * nwarps;
  cnt = 0;
  abits = 0u;
  for (int i = lane; i < n; i += 32) {
    cnt += s_cnt[i];
    abits = max(abits, s_abits[i]);
  }
  cnt = __reduce_add_sync(0xffffffffu, cnt);
  abits = __reduce_max_sync(0xffffffffu, abits);
  if (lane == 0) {
    stats[0] = cnt;
    stats[1] = __float_as_int(__fdiv_rn(__uint_as_float(abits), scale));
  }
}

// The same through scratch = {count, max |x| bits, ticket}: the block's
// sum and max through shared memory, added into scratch; the block that
// takes the last ticket reads the totals into stats and zeroes scratch.
__device__ __forceinline__ void ticket_stats(int cnt, float amax, float scale,
                                             int* stats, int* scratch) {
  constexpr int kWarps = kDwTiledThreads / 32;
  __shared__ int s_cnt[kWarps];
  __shared__ unsigned s_abits[kWarps];
  cnt = __reduce_add_sync(0xffffffffu, cnt);
  unsigned abits = __reduce_max_sync(0xffffffffu, __float_as_uint(amax));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) s_cnt[warp] = cnt, s_abits[warp] = abits;
  __syncthreads();
  if (threadIdx.x != 0) return;
  for (int w = 1; w < (int)(blockDim.x + 31) / 32; ++w) {
    cnt += s_cnt[w];
    abits = max(abits, s_abits[w]);
  }
  if (cnt) atomicAdd(&scratch[0], cnt);
  atomicMax(reinterpret_cast<unsigned*>(&scratch[1]), abits);
  __threadfence();
  const unsigned last = gridDim.x * gridDim.y - 1;
  if (atomicAdd(reinterpret_cast<unsigned*>(&scratch[2]), 1u) == last) {
    __threadfence();
    stats[0] = atomicExch(&scratch[0], 0);
    stats[1] = __float_as_int(
        __fdiv_rn(__int_as_float(atomicExch(&scratch[1], 0)), scale));
    atomicExch(&scratch[2], 0);
  }
}

// Block s of the ns blocks of the counting cluster: the clipped elements
// and max |x| of its share of the padded signal x (n elements, each counted
// once: the same count as each padded row's once), 16 bytes a load where x
// is aligned, then the cluster's sum into stats.
__device__ __forceinline__ void count_signal(const float* __restrict__ x,
                                             long long n, int s, int ns,
                                             float scale, int zp, int kmax,
                                             int* stats) {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  int cnt = 0;
  float amax = 0.f;
  auto add = [&](float v) {
    bool sat;
    pcilt::quantize_code(v, scale, zp, kmax, &sat);
    cnt += sat;
    amax = fmaxf(amax, fabsf(v));
  };
  const long long stride = (long long)ns * blockDim.x;
  const long long i0 = (long long)s * blockDim.x + threadIdx.x;
  long long done = 0;
  if (((uintptr_t)x & 15) == 0) {
    const long long n4 = n / 4;
    for (long long i = i0; i < n4; i += stride) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(x) + i);
      add(q.x), add(q.y), add(q.z), add(q.w);
    }
    done = n4 * 4;
  }
  for (long long i = done + i0; i < n; i += stride) add(__ldg(x + i));
  cluster_stats(cnt, amax, scale, stats);
}

template <typename T, int NV>
__device__ __forceinline__ void store_cells(T* p, const T (&v)[NV]) {
  if constexpr (NV == 1) {
    *p = v[0];
  } else if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    uint2 w;
    w.x = (unsigned)__bfloat16_as_ushort(v[0]) |
          (unsigned)__bfloat16_as_ushort(v[1]) << 16;
    w.y = (unsigned)__bfloat16_as_ushort(v[2]) |
          (unsigned)__bfloat16_as_ushort(v[3]) << 16;
    *reinterpret_cast<uint2*>(p) = w;
  }
}

// NV channels a lane, up to KT taps (k <= KT); MODE: a StatsMode.  The
// data blocks run channel tile bx over rows by, by + ny, ...: with
// kClusterStats the grid is 1-D, blocks [0, nd = tiles * ry) the data
// blocks (bx = b % tiles, by = b / tiles, ny = ry; one cluster) and blocks
// [nd, 2 nd) the counting cluster, which reads the signal once and writes
// stats while the data blocks make their two trips to memory; otherwise the
// grid is (tiles, ry) and, with kTicketStats, the data blocks count their
// taps (each padded row once) and take the ticket.
template <typename T, int NV, int KT, int MODE>
__global__ void __launch_bounds__(kDwTiledThreads)
    dwconv1d_tiled_kernel(const float* __restrict__ x,
                          const T* __restrict__ tab, T* __restrict__ out,
                          int* __restrict__ stats, int* __restrict__ scratch,
                          int Tp, int C, int V, int k, int bits, int zp,
                          float scale, int rows, int tiles, int ry,
                          long long n_elems) {
  const int kmax = (1 << bits) - 1;
  int bx = blockIdx.x, by = blockIdx.y, ny = gridDim.y;
  if constexpr (MODE == kClusterStats) {
    const int nd = tiles * ry;
    if ((int)blockIdx.x >= nd) {
      count_signal(x, n_elems, (int)blockIdx.x - nd, nd, scale, zp, kmax,
                   stats);
      return;
    }
    bx = (int)blockIdx.x % tiles, by = (int)blockIdx.x / tiles, ny = ry;
  }
  const int To = Tp - k + 1;
  const int c = (bx * blockDim.x + threadIdx.x) * NV;
  int cnt = 0;
  float amax = 0.f;
  if (c < C) {
    for (int row = by; row < rows; row += ny) {
      const int b = row / To, t = row - (row / To) * To;
      const float* xs = x + ((size_t)b * Tp + t) * C + c;
      float v[KT][NV];
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        if (j < k) {
          if constexpr (NV == 4) {
            const float4 q = __ldg(reinterpret_cast<const float4*>(
                xs + (size_t)j * C));
            v[j][0] = q.x, v[j][1] = q.y, v[j][2] = q.z, v[j][3] = q.w;
          } else {
            v[j][0] = __ldg(xs + (size_t)j * C);
          }
        }
      }
      int o[NV];
#pragma unroll
      for (int n = 0; n < NV; ++n) o[n] = 0;
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        if (j < k) {
#pragma unroll
          for (int n = 0; n < NV; ++n) {
            bool sat;
            const int code =
                pcilt::quantize_code(v[j][n], scale, zp, kmax, &sat);
            if (MODE == kTicketStats) {
              if (sat && (j == 0 || t == To - 1)) ++cnt;
              amax = fmaxf(amax, fabsf(v[j][n]));
            }
            o[n] |= code << (j * bits);
          }
        }
      }
      T cell[NV];
#pragma unroll
      for (int n = 0; n < NV; ++n) cell[n] = tab[(size_t)(c + n) * V + o[n]];
      store_cells<T, NV>(out + (size_t)row * C + c, cell);
    }
  }
  if (MODE == kTicketStats) ticket_stats(cnt, amax, scale, stats, scratch);
}

// The tiled grid of one call (kernels.ops.dwconv_tiled_grid mirrors it):
// where a channel a lane over tiles of up to kDwTiledThreads lanes puts
// every output row in one cluster (the decode window: 4 tiles x 4 rows at
// C 1792), it takes that (the most SMs for the two dependent trips to
// memory, the counters summed in the cluster); otherwise 4 channels a lane
// when `wide` (else 1) over tiles of up to kDwWideLanes lanes, rows strided
// past kDwTiledTargetBlocks, the counters through the ticket unless the
// grid fits a cluster.
struct DwTiledGrid {
  int nv, tiles, threads, ry;
};

__host__ __device__ inline DwTiledGrid dw_tiled_grid(int rows, int C,
                                                     bool wide) {
  DwTiledGrid d;
  d.nv = 1;
  d.tiles = (C + kDwTiledThreads - 1) / kDwTiledThreads;
  if ((long long)d.tiles * rows > kDwClusterBlocks) {
    d.nv = wide ? 4 : 1;
    d.tiles = ((C + d.nv - 1) / d.nv + kDwWideLanes - 1) / kDwWideLanes;
  }
  const int lanes = (C + d.nv - 1) / d.nv;
  d.threads = ((lanes + d.tiles - 1) / d.tiles + 31) / 32 * 32;
  const int ry = kDwTiledTargetBlocks / d.tiles;
  d.ry = ry < 1 ? 1 : (ry > rows ? rows : ry);
  return d;
}

template <typename T, int NV, int KT>
int launch_tiled_nk(const float* x, const T* tab, T* out, int* stats,
                    int* scratch, int rows, int Tp, int C, int V, int k,
                    int bits, int zp, float scale, int counters,
                    const DwTiledGrid& d, cudaStream_t stream) {
  const int tiles = d.tiles, threads = d.threads, ry = d.ry;
  const int nd = tiles * ry;
  const dim3 grid(tiles, ry);
  const long long n = (long long)rows / (Tp - k + 1) * Tp * C;  // B * Tp * C
  if (!counters) {
    dwconv1d_tiled_kernel<T, NV, KT, kNoStats><<<grid, threads, 0, stream>>>(
        x, tab, out, stats, scratch, Tp, C, V, k, bits, zp, scale, rows,
        tiles, ry, n);
  } else if (nd > kDwClusterBlocks) {
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    dwconv1d_tiled_kernel<T, NV, KT, kTicketStats>
        <<<grid, threads, 0, stream>>>(x, tab, out, stats, scratch, Tp, C, V,
                                       k, bits, zp, scale, rows, tiles, ry,
                                       n);
  } else {  // the data blocks one cluster, the counting blocks another
    auto kernel = dwconv1d_tiled_kernel<T, NV, KT, kClusterStats>;
    static bool wide_clusters = false;  // this instance's, per process
    if (nd > 8 && !wide_clusters) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return (int)err;
      wide_clusters = true;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(2 * nd);
    cfg.blockDim = dim3(threads);
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = nd;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t err =
        cudaLaunchKernelEx(&cfg, kernel, x, tab, out, stats, scratch, Tp, C,
                           V, k, bits, zp, scale, rows, tiles, ry, n);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

// variant: 0 = "tiled" (k <= kDwTiledMaxTaps), 1 = "direct".  A 4-channel
// lane needs C % 4 == 0 and both addresses to allow 16-byte taps and
// whole-lane stores.
template <typename T>
int launch(const float* x, const T* tab, T* out, int* stats, int* scratch,
           int B, int Tp, int C, int V, int k, int bits, int zp, float scale,
           int counters, int variant, cudaStream_t stream) {
  if (variant == 1)
    return launch_direct(x, tab, out, stats, B, Tp, C, V, k, bits, zp, scale,
                         counters, stream);
  const long long rows = (long long)B * (Tp - k + 1);
  if (variant != 0 || k < 1 || k > kDwTiledMaxTaps || rows < 1 ||
      rows > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const bool wide = C % 4 == 0 && (uintptr_t)x % 16 == 0 &&
                    (uintptr_t)out % (4 * sizeof(T)) == 0;
  const DwTiledGrid d = dw_tiled_grid((int)rows, C, wide);
#define PCILT_TILED(NV, KT)                                                   \
  return launch_tiled_nk<T, NV, KT>(x, tab, out, stats, scratch, (int)rows,  \
                                    Tp, C, V, k, bits, zp, scale, counters,  \
                                    d, stream)
  if (d.nv == 4 && k <= 4) PCILT_TILED(4, 4);
  if (d.nv == 4) PCILT_TILED(4, 8);
  if (k <= 4) PCILT_TILED(1, 4);
  PCILT_TILED(1, 8);
#undef PCILT_TILED
}

// ---------------------------------------------------------------------------
// Host-packed, "staged"
// ---------------------------------------------------------------------------

// The constants were tuned on an H100 with scripts/shared_dwconv_sweep.py,
// which rebuilds this source with other values of them.
constexpr int kDwChans = 32;          // channels a block
constexpr int kDwThreads = 256;       // threads a block
constexpr int kDwUnroll = 2;          // row passes a load batch
constexpr int kDwTargetBlocks = 396;  // blocks the tiling aims for
static_assert(kDwThreads % kDwChans == 0,
              "a block's threads cover whole rows of its channels");

struct DwTiling {
  int tiles;   // channel tiles
  int groups;  // row groups
};

__host__ __device__ inline DwTiling dw_tiling(long long M, int C) {
  DwTiling t;
  t.tiles = (C + kDwChans - 1) / kDwChans;
  long long g = kDwTargetBlocks / t.tiles;
  if (g > M) g = M;
  t.groups = g < 1 ? 1 : (int)g;
  return t;
}

// Dynamic shared memory of a block: the slice [kDwChans][V] of the table.
__host__ __device__ inline size_t dw_smem_bytes(int V, int itemsize) {
  return (size_t)kDwChans * V * itemsize;
}

template <int NV> struct OffsOf;
template <> struct OffsOf<1> {
  __device__ static void get(const int* p, int* o) { o[0] = __ldg(p); }
};
template <> struct OffsOf<4> {
  __device__ static void get(const int* p, int* o) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(p));
    o[0] = v.x, o[1] = v.y, o[2] = v.z, o[3] = v.w;
  }
};

template <typename T, int NV> struct StoreOf;
template <typename T> struct StoreOf<T, 1> {
  __device__ static void put(T* p, const float* v) {
    *p = pcilt::from_f32<T>(v[0]);
  }
};
template <> struct StoreOf<float, 4> {
  __device__ static void put(float* p, const float* v) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  }
};
template <> struct StoreOf<__nv_bfloat16, 4> {
  __device__ static void put(__nv_bfloat16* p, const float* v) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 w;
    w.x = *reinterpret_cast<unsigned*>(&lo);
    w.y = *reinterpret_cast<unsigned*>(&hi);
    __stcs(reinterpret_cast<uint2*>(p), w);
  }
};

template <typename T, int NV>
__global__ void __launch_bounds__(kDwThreads)
    dwconv1d_staged_kernel(const int* __restrict__ offsets,
                           const T* __restrict__ tab, T* __restrict__ out,
                           long long M, int C, int V, DwTiling tl) {
  constexpr int LR = kDwChans / NV;    // lanes a row
  constexpr int RP = kDwThreads / LR;  // rows a pass
  constexpr int U = kDwUnroll;
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_tab = reinterpret_cast<T*>(smem);  // [kDwChans][V]
  const int c0 = (blockIdx.x % tl.tiles) * kDwChans;
  const int grp = blockIdx.x / tl.tiles;
  const long long r0 = M * grp / tl.groups;
  const long long r1 = M * (grp + 1) / tl.groups;
  const int cl = (threadIdx.x % LR) * NV;
  const bool live = c0 + cl < C;  // C % NV == 0: all NV channels or none

  // a batch: U passes of RP rows, each row's NV offsets one vector load
  auto load = [&](int (&o)[U][NV], long long r) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long rr = r + (long long)u * RP;
      if (live && rr < r1) {
        OffsOf<NV>::get(offsets + rr * C + c0 + cl, o[u]);
      } else {
#pragma unroll
        for (int k = 0; k < NV; ++k) o[u][k] = -1;
      }
    }
  };

  // -- the first batch's offsets in flight, then the slice: the tile's
  //    rows of the table are one contiguous run, copied 16 bytes at a time
  long long r = r0 + threadIdx.x / LR;
  int o[U][NV];
  load(o, r);
  {
    const int nch = min(kDwChans, C - c0);
    const T* src = tab + (size_t)c0 * V;
    const int n = nch * V;  // cells
    int done = 0;
    if ((uintptr_t)src % 16 == 0) {
      const int n16 = n * (int)sizeof(T) / 16;
      for (int i = threadIdx.x; i < n16; i += kDwThreads)
        reinterpret_cast<uint4*>(smem)[i] =
            __ldg(reinterpret_cast<const uint4*>(src) + i);
      done = n16 * 16 / (int)sizeof(T);
    }
    for (int i = done + threadIdx.x; i < n; i += kDwThreads)
      s_tab[i] = src[i];
  }
  __syncthreads();

  // -- stream the rows, the next batch's offsets in flight while this one
  //    gathers and stores
  for (; r < r1; r += RP * U) {
    int nx[U][NV];
    load(nx, r + RP * U);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long rr = r + (long long)u * RP;
      if (!live || rr >= r1) continue;
      float val[NV];
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        const int off = o[u][k];
        val[k] = (off >= 0 && off < V)
                     ? pcilt::to_f32(s_tab[(cl + k) * V + off])
                     : 0.f;
      }
      StoreOf<T, NV>::put(out + rr * C + c0 + cl, val);
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int k = 0; k < NV; ++k) o[u][k] = nx[u][k];
  }
}

// ---------------------------------------------------------------------------
// Host-packed, "direct"
// ---------------------------------------------------------------------------

template <typename T>
__global__ void dwconv1d_host_kernel(const int* __restrict__ offsets,
                                     const T* __restrict__ tab,
                                     T* __restrict__ out, long long total,
                                     int C, int V) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int c = (int)(i % C);
  const int off = offsets[i];
  float v = 0.f;
  if (off >= 0 && off < V) v = pcilt::to_f32(tab[(long long)c * V + off]);
  out[i] = pcilt::from_f32<T>(v);
}

template <typename T, int NV>
int launch_staged_nv(const int* offsets, const T* tab, T* out, long long M,
                     int C, int V, cudaStream_t stream) {
  const DwTiling tl = dw_tiling(M, C);
  const size_t smem = dw_smem_bytes(V, (int)sizeof(T));
  auto kernel = dwconv1d_staged_kernel<T, NV>;
  static size_t smem_allowed = 48 * 1024;  // this instance's, per process
  if (smem > smem_allowed) {
    cudaError_t err = pcilt::allow_smem(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    smem_allowed = smem;
  }
  kernel<<<tl.tiles * tl.groups, kDwThreads, smem, stream>>>(
      offsets, tab, out, M, C, V, tl);
  return (int)cudaGetLastError();
}

// variant: 0 = "staged", 1 = "direct".  The staged lanes own 4 channels
// when C and both addresses allow 16-byte offset vectors.
template <typename T>
int launch_host(const int* offsets, const T* tab, T* out, long long total,
                int C, int V, int variant, cudaStream_t stream) {
  if (variant == 0) {
    const long long M = total / C;
    const bool wide = C % 4 == 0 && (uintptr_t)offsets % 16 == 0 &&
                      (uintptr_t)out % (4 * sizeof(T)) == 0;
    if (wide)
      return launch_staged_nv<T, 4>(offsets, tab, out, M, C, V, stream);
    return launch_staged_nv<T, 1>(offsets, tab, out, M, C, V, stream);
  }
  if (variant != 1) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  dwconv1d_host_kernel<T><<<blocks, threads, 0, stream>>>(offsets, tab, out,
                                                          total, C, V);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int pcilt_dwconv1d_host_f32(const void* offsets, const void* tab,
                                       void* out, long long total, int C,
                                       int V, int variant, void* stream) {
  return launch_host<float>((const int*)offsets, (const float*)tab,
                            (float*)out, total, C, V, variant,
                            (cudaStream_t)stream);
}

extern "C" int pcilt_dwconv1d_host_bf16(const void* offsets, const void* tab,
                                        void* out, long long total, int C,
                                        int V, int variant, void* stream) {
  return launch_host<__nv_bfloat16>((const int*)offsets,
                                    (const __nv_bfloat16*)tab,
                                    (__nv_bfloat16*)out, total, C, V, variant,
                                    (cudaStream_t)stream);
}

// The staged design's constants, for kernels.ops to check its mirror
// against: {channels a block, threads a block, passes a batch, target
// blocks}.
extern "C" int pcilt_dwconv1d_staged_config(int* cfg) {
  cfg[0] = kDwChans;
  cfg[1] = kDwThreads;
  cfg[2] = kDwUnroll;
  cfg[3] = kDwTargetBlocks;
  return 0;
}

// The staged tiling of one call over M rows: {channel tiles, row groups,
// shared-memory bytes}.
extern "C" int pcilt_dwconv1d_staged_plan(long long M, int C, int V,
                                          int itemsize, int* out) {
  if (itemsize != 2 && itemsize != 4) return (int)cudaErrorInvalidValue;
  const DwTiling t = dw_tiling(M, C);
  out[0] = t.tiles;
  out[1] = t.groups;
  out[2] = (int)dw_smem_bytes(V, itemsize);
  return 0;
}

// The fused dwconv; scratch: the tiled design's {count, ratio, ticket}
// (zeroed when made, left zeroed by every launch).
extern "C" int pcilt_dwconv1d_f32(const void* x, const void* tables,
                                  void* out, void* stats, void* scratch,
                                  int B, int Tp, int C, int V, int k,
                                  int bits, int zp, float scale, int counters,
                                  int variant, void* stream) {
  return launch<float>((const float*)x, (const float*)tables, (float*)out,
                       (int*)stats, (int*)scratch, B, Tp, C, V, k, bits, zp,
                       scale, counters, variant, (cudaStream_t)stream);
}

extern "C" int pcilt_dwconv1d_bf16(const void* x, const void* tables,
                                   void* out, void* stats, void* scratch,
                                   int B, int Tp, int C, int V, int k,
                                   int bits, int zp, float scale,
                                   int counters, int variant, void* stream) {
  return launch<__nv_bfloat16>((const float*)x, (const __nv_bfloat16*)tables,
                               (__nv_bfloat16*)out, (int*)stats,
                               (int*)scratch, B, Tp, C, V, k, bits, zp, scale,
                               counters, variant, (cudaStream_t)stream);
}

// The tiled design's constants, for kernels.ops to check its mirror
// against: {lanes a channel tile (at most), lanes a 4-channel-lane tile,
// target blocks, largest k, largest grid summed in a cluster}.
extern "C" int pcilt_dwconv1d_tiled_config(int* cfg) {
  cfg[0] = kDwTiledThreads;
  cfg[1] = kDwWideLanes;
  cfg[2] = kDwTiledTargetBlocks;
  cfg[3] = kDwTiledMaxTaps;
  cfg[4] = kDwClusterBlocks;
  return 0;
}

// The tiled grid of one call: {channels a lane, channel tiles, threads a
// block, row blocks}.
extern "C" int pcilt_dwconv1d_tiled_plan(int rows, int C, int wide,
                                         int* out) {
  const DwTiledGrid d = dw_tiled_grid(rows, C, wide != 0);
  out[0] = d.nv;
  out[1] = d.tiles;
  out[2] = d.threads;
  out[3] = d.ry;
  return 0;
}
