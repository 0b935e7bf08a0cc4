// CRC-32 (zlib's polynomial) of streams of byte ranges on the card: the
// integrity record and checks of the PCILT tables, bit-equal to zlib.crc32
// of the same bytes.
//
// Replaces: the host zlib.crc32 of src/repro/core/pcilt.py table_checksum
// (the reference has no TPU kernel here; it copies every table to the host).
//
// Bound: bytes.  Every byte is read once; one table lookup a byte in shared
// memory.  One full-width mamba2-130m layer (2.39 GB) takes 0.71 ms at
// 3.35 TB/s, the shared-pool head (19.8 GB) 5.9 ms.
//
// Function: one launch computes the CRCs of n_streams streams.  The int64
// table holds n_streams stream rows {first range, ranges, bytes, first
// chunk, chunks}, then the range rows {address, length, offset in its
// stream} (a stream's offsets ascending and contiguous).  The kernel
// writes each stream's "pure" CRC (started from 0, no inversion) to
// out[s]; kernels.ops applies zlib's pre- and post-inversion on the host
// (kernels/ref.py crc32_finish).  The pure CRC is linear over GF(2) and
// blind to leading zero bytes:  pure(A || B) = shift(pure(A), |B|) ^ pure(B).
//
// Design (both chunk passes):
//  1. Each stream is padded in FRONT with zero bytes to whole chunks of
//     kChunkBytes (64 KiB), and its chunks with zero chunks in front to
//     N, the power of two at or above the largest stream's chunk count.
//     So every node at level j of a combine tree covers kLaneBytes << j
//     bytes and one operator (a shift by that many bytes, 32 columns over
//     GF(2), computed on the host: kernels/ref.py crc_operators) serves
//     the whole level of every stream.  The ragged edge is a stream's
//     first chunk, whose leading zeros change nothing.
//  2. A chunk pass writes each chunk's CRC: one warp a chunk (a
//     grid-stride loop over the chunks of all streams, back to back; a
//     warp finds its chunk's stream by a binary search), one lane a 2 KiB
//     lane slice of it (a lane finds the ranges its slice crosses by
//     another).  The 32 lane CRCs combine in a shuffle tree (levels 0-4)
//     and lane 0 writes the chunk's.
//  3. crc_combine_kernel: block (b, s) combines up to 1024 consecutive
//     nodes of stream s in a tree in shared memory, in a fixed order
//     (levels 5 on); the host loop launches it until one node a stream is
//     left.  A stream's leading zero chunks are not stored: its first pass
//     reads nodes before N - chunks as 0.
// Two launches on the same bytes are bit-identical (no atomics; and the
// arithmetic is exact over GF(2), so no order of joins changes a bit).
//
// Two chunk passes, chosen by the caller (kernels.ops; "banked" unless
// forced):
//
// "banked" (for Hopper's memory path and shared memory).  Removing a stage
// at a time from the kept design (scripts/crc_ablation.py, PERF.md) showed
// that its pace is set by its loads, not its lookups: each lane streams
// its own slice, so a warp's 16-byte load touches 32 lines 2 KiB apart,
// and without the lookups the same loads alone ran at ~1.8 TB/s.  So:
//  a. Coalesced loads, staged.  A warp reads its chunk as 32 rows (the
//     lane slices) of 16 steps of 128 bytes: a 16-byte load instruction
//     covers 4 rows' whole 128-byte lines.  The 8 loads of step b + 1 are
//     in flight while step b folds; each step goes through the warp's
//     staging tile in shared memory (32 rows of 128 bytes, a 144-byte
//     pitch: the stores and the row reads are free of bank conflicts), so
//     lane l reads back its own row.  64 KiB in flight an SM.
//  b. Lookups without bank conflicts.  slicing-by-4's four tables are
//     replicated across the 32 banks, entry e of table k for lane l at
//     word (k * 256 + e) * 32 + l, so lane l reads only bank l and every
//     lookup instruction is one wavefront (the kept design's random byte
//     indices took ~3.5).
//  128 KiB of tables and 72 KiB of staging tiles: one block of 16 warps an
//  SM, a persistent grid of one block an SM.  A chunk that is not 16-byte
//  aligned or crosses a range (only a stream's first, padded chunk or a
//  range's edges) is folded lane by lane from its own loads.
//
// "kept" (the first design, kept for comparison and forceable): one warp of
// 8 a chunk and up to 8 blocks an SM; each lane folds its whole slice with
// slicing-by-16 tables (16 x 256 words, one copy in shared memory), four
// 16-byte loads of its own slice at a time.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kPoly = 0xEDB88320u;
constexpr int kLaneBytes = 2048;
constexpr int kChunkBytes = 32 * kLaneBytes;
constexpr int kCombine = 1024;             // nodes a combine block reduces
constexpr int kCombineLevels = 10;         // log2(kCombine)
constexpr int kLevels = 48;                // levels of the operator table

// "kept"
constexpr int kWarps = 8;                  // warps (chunks in flight) a block
constexpr int kThreads = 32 * kWarps;      // 256: one table entry a thread
constexpr int kBlocksPerSm = 8;

// "banked"
constexpr int kBankedWarps = 16;           // warps (chunks in flight) a block
constexpr int kBankedThreads = 32 * kBankedWarps;
constexpr int kBankedTables = 4;           // slicing-by-4
constexpr int kTableBytes = kBankedTables * 256 * 32 * 4;  // 128 KiB
constexpr int kRowBlock = 128;             // bytes of a lane slice a step
constexpr int kRowPitch = kRowBlock + 16;  // a staged row, in shared memory
constexpr int kStageBytes = 32 * kRowPitch;       // a warp's staging tile
constexpr int kSteps = kLaneBytes / kRowBlock;    // 16
constexpr int kLoads = 32 * kRowBlock / (32 * 16);  // 16-byte loads a step
constexpr int kBankedSmem = kTableBytes + kBankedWarps * kStageBytes;
static_assert(kLoads == 8 && kRowBlock / 16 * 4 == 32,
              "a load instruction covers 4 rows' 128-byte lines");
static_assert(kBankedSmem <= 227 * 1024, "one block's shared memory");

using Tables = uint32_t[16][256];

// v shifted by the operator whose 32 columns are op[0..31]
__device__ __forceinline__ uint32_t apply_op(const uint32_t* op, uint32_t v) {
  uint32_t r = 0;
#pragma unroll
  for (int i = 0; i < 32; ++i) r ^= op[i] & (0u - ((v >> i) & 1u));
  return r;
}

// ---------------------------------------------------------------------------
// "kept"
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t fold_byte(const Tables& T, uint32_t c,
                                              uint8_t b) {
  return T[0][(c ^ b) & 0xFFu] ^ (c >> 8);
}

// 16 bytes (little-endian words x, y, z, w): byte k reads T[15 - k]
__device__ __forceinline__ uint32_t fold16(const Tables& T, uint32_t c,
                                           uint4 v) {
  const uint32_t a = v.x ^ c;
  return T[15][a & 0xFFu] ^ T[14][(a >> 8) & 0xFFu] ^
         T[13][(a >> 16) & 0xFFu] ^ T[12][a >> 24] ^
         T[11][v.y & 0xFFu] ^ T[10][(v.y >> 8) & 0xFFu] ^
         T[9][(v.y >> 16) & 0xFFu] ^ T[8][v.y >> 24] ^
         T[7][v.z & 0xFFu] ^ T[6][(v.z >> 8) & 0xFFu] ^
         T[5][(v.z >> 16) & 0xFFu] ^ T[4][v.z >> 24] ^
         T[3][v.w & 0xFFu] ^ T[2][(v.w >> 8) & 0xFFu] ^
         T[1][(v.w >> 16) & 0xFFu] ^ T[0][v.w >> 24];
}

// the pure CRC c continued over n bytes at p
__device__ __forceinline__ uint32_t fold_piece(const Tables& T, uint32_t c,
                                               const uint8_t* p, long long n) {
  while (n > 0 && (reinterpret_cast<uintptr_t>(p) & 15u)) {
    c = fold_byte(T, c, *p++);
    --n;
  }
  const uint4* q = reinterpret_cast<const uint4*>(p);
  const long long nv = n >> 4;
  long long i = 0;
  for (; i + 4 <= nv; i += 4) {
    const uint4 v0 = __ldg(q + i), v1 = __ldg(q + i + 1);
    const uint4 v2 = __ldg(q + i + 2), v3 = __ldg(q + i + 3);
    c = fold16(T, c, v0);
    c = fold16(T, c, v1);
    c = fold16(T, c, v2);
    c = fold16(T, c, v3);
  }
  for (; i < nv; ++i) c = fold16(T, c, __ldg(q + i));
  p += nv << 4;
  for (n &= 15; n > 0; --n) c = fold_byte(T, c, *p++);
  return c;
}

// The stream holding a chunk (the last starting at or before it).
__device__ __forceinline__ int stream_of(const long long* streams,
                                         int n_streams, long long chunk) {
  int si = 0, sh = n_streams - 1;
  while (si < sh) {
    const int mid = (si + sh + 1) >> 1;
    if (streams[5 * mid + 3] <= chunk) si = mid;
    else sh = mid - 1;
  }
  return si;
}

// The first range of [r0, r1) that ends after stream byte s.
__device__ __forceinline__ int range_of(const long long* ranges, int r0,
                                        int r1, long long s) {
  int lo = r0, hi = r1 - 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (ranges[3 * mid + 2] + ranges[3 * mid + 1] > s) hi = mid;
    else lo = mid + 1;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
crc_chunks_kernel(const long long* __restrict__ streams, int n_streams,
                  long long nchunks, const uint32_t* __restrict__ ops,
                  uint32_t* __restrict__ leaves) {
  __shared__ Tables T;
  __shared__ uint32_t lane_ops[5][32];
  const long long* __restrict__ ranges = streams + 5LL * n_streams;
  const int t = threadIdx.x;
  uint32_t c = (uint32_t)t;
#pragma unroll
  for (int k = 0; k < 8; ++k) c = (c & 1u) ? (c >> 1) ^ kPoly : c >> 1;
  T[0][t] = c;
  if (t < 5 * 32) lane_ops[t / 32][t % 32] = ops[t];
  __syncthreads();
  for (int k = 1; k < 16; ++k) {
    const uint32_t prev = T[k - 1][t];
    T[k][t] = (prev >> 8) ^ T[0][prev & 0xFFu];
    __syncthreads();
  }
  const int lane = t & 31, warp = t >> 5;
  for (long long chunk = (long long)blockIdx.x * kWarps + warp;
       chunk < nchunks; chunk += (long long)gridDim.x * kWarps) {
    const long long* st = streams + 5 * stream_of(streams, n_streams, chunk);
    const int r0 = (int)st[0], r1 = (int)(st[0] + st[1]);
    const long long pad = st[4] * kChunkBytes - st[2];
    // this lane's slice, in stream bytes (negative: the front padding)
    long long s = (chunk - st[3]) * kChunkBytes - pad +
                  (long long)lane * kLaneBytes;
    const long long e = s + kLaneBytes;
    if (s < 0) s = 0;
    uint32_t crc = 0;
    if (s < e) {
      for (int r = range_of(ranges, r0, r1, s); s < e && r < r1; ++r) {
        const long long off = ranges[3 * r + 2], len = ranges[3 * r + 1];
        const long long end = off + len < e ? off + len : e;
        if (end <= s) continue;
        const uint8_t* base =
            reinterpret_cast<const uint8_t*>((uintptr_t)ranges[3 * r]);
        crc = fold_piece(T, crc, base + (s - off), end - s);
        s = end;
      }
    }
#pragma unroll
    for (int j = 0; j < 5; ++j) {
      const uint32_t right = __shfl_down_sync(0xFFFFFFFFu, crc, 1 << j);
      if ((lane & ((2 << j) - 1)) == 0)
        crc = apply_op(lane_ops[j], crc) ^ right;
    }
    if (lane == 0) leaves[chunk] = crc;
  }
}

// ---------------------------------------------------------------------------
// "banked"
// ---------------------------------------------------------------------------

// tl: lane l's copies (the tables from word l, 32 words an entry)
__device__ __forceinline__ uint32_t fold4_banked(const uint32_t* tl,
                                                 uint32_t x) {
  return tl[(3 * 256 + (x & 0xFFu)) * 32] ^
         tl[(2 * 256 + ((x >> 8) & 0xFFu)) * 32] ^
         tl[(256 + ((x >> 16) & 0xFFu)) * 32] ^ tl[(x >> 24) * 32];
}

// 16 bytes, one little-endian word at a time (slicing-by-4)
__device__ __forceinline__ uint32_t fold16_banked(const uint32_t* tl,
                                                  uint32_t c, uint4 v) {
  c = fold4_banked(tl, c ^ v.x);
  c = fold4_banked(tl, c ^ v.y);
  c = fold4_banked(tl, c ^ v.z);
  return fold4_banked(tl, c ^ v.w);
}

__device__ __forceinline__ uint32_t fold_byte_banked(const uint32_t* tl,
                                                     uint32_t c, uint8_t b) {
  return tl[((c ^ b) & 0xFFu) * 32] ^ (c >> 8);
}

// the pure CRC c continued over n bytes at p
__device__ uint32_t fold_piece_banked(const uint32_t* tl, uint32_t c,
                                      const uint8_t* p, long long n) {
  while (n > 0 && (reinterpret_cast<uintptr_t>(p) & 15u)) {
    c = fold_byte_banked(tl, c, *p++);
    --n;
  }
  const uint4* q = reinterpret_cast<const uint4*>(p);
  const long long nv = n >> 4;
  for (long long i = 0; i < nv; ++i) c = fold16_banked(tl, c, __ldg(q + i));
  p += nv << 4;
  for (n &= 15; n > 0; --n) c = fold_byte_banked(tl, c, *p++);
  return c;
}

__global__ void __launch_bounds__(kBankedThreads, 1)
crc_banked_kernel(const long long* __restrict__ streams, int n_streams,
                  long long nchunks, const uint32_t* __restrict__ ops,
                  uint32_t* __restrict__ leaves) {
  // [kBankedTables][256][32 banks] words, then each warp's staging tile
  extern __shared__ __align__(16) uint32_t tab[];
  __shared__ uint32_t lane_ops[5][32];
  const long long* __restrict__ ranges = streams + 5LL * n_streams;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  // T_k[e], the pure CRC of byte e and k zero bytes, is 8 (k + 1) steps of
  // e: every lane of a warp steps the same entry and writes its bank's copy
  for (int e = warp; e < 256; e += kBankedWarps) {
    uint32_t c = (uint32_t)e;
    for (int k = 0; k < kBankedTables; ++k) {
#pragma unroll
      for (int i = 0; i < 8; ++i) c = (c & 1u) ? (c >> 1) ^ kPoly : c >> 1;
      tab[(k * 256 + e) * 32 + lane] = c;
    }
  }
  if (t < 5 * 32) lane_ops[t / 32][t % 32] = ops[t];
  __syncthreads();
  const uint32_t* tl = tab + lane;
  unsigned char* stage = reinterpret_cast<unsigned char*>(tab) + kTableBytes +
                         warp * kStageBytes;
  // a lane's part of each load instruction: row (lane slice) 4 i + row,
  // bytes col .. col + 15 of the step's 128
  const int row = lane >> 3, col = (lane & 7) * 16;
  for (long long chunk = (long long)blockIdx.x * kBankedWarps + warp;
       chunk < nchunks; chunk += (long long)gridDim.x * kBankedWarps) {
    const long long* st = streams + 5 * stream_of(streams, n_streams, chunk);
    const int r0 = (int)st[0], r1 = (int)(st[0] + st[1]);
    const long long pad = st[4] * kChunkBytes - st[2];
    // the chunk's first stream byte (negative: the front padding); the
    // warp stages the chunk when it lies in one range, 16-byte aligned
    const long long c0 = (chunk - st[3]) * kChunkBytes - pad;
    const uint8_t* cb = nullptr;
    if (c0 >= 0) {
      const int r = range_of(ranges, r0, r1, c0);
      const long long off = ranges[3 * r + 2], len = ranges[3 * r + 1];
      const uint8_t* p =
          reinterpret_cast<const uint8_t*>((uintptr_t)ranges[3 * r]) +
          (c0 - off);
      if (c0 + kChunkBytes <= off + len &&
          (reinterpret_cast<uintptr_t>(p) & 15u) == 0)
        cb = p;
    }
    uint32_t crc = 0;
    if (cb != nullptr) {  // the same for every lane of the warp
      const uint8_t* src = cb + (long long)row * kLaneBytes + col;
      uint4 next[kLoads];
#pragma unroll
      for (int i = 0; i < kLoads; ++i)
        next[i] = __ldg(reinterpret_cast<const uint4*>(
            src + (long long)(4 * i) * kLaneBytes));
      for (int b = 0; b < kSteps; ++b) {
#pragma unroll
        for (int i = 0; i < kLoads; ++i)
          *reinterpret_cast<uint4*>(stage + (4 * i + row) * kRowPitch +
                                    col) = next[i];
        __syncwarp();
        uint4 mine[kLoads];
#pragma unroll
        for (int j = 0; j < kLoads; ++j)
          mine[j] = *reinterpret_cast<const uint4*>(stage + lane * kRowPitch +
                                                    16 * j);
        __syncwarp();
        if (b + 1 < kSteps) {
#pragma unroll
          for (int i = 0; i < kLoads; ++i)
            next[i] = __ldg(reinterpret_cast<const uint4*>(
                src + (long long)(4 * i) * kLaneBytes +
                (b + 1) * kRowBlock));
        }
#pragma unroll
        for (int j = 0; j < kLoads; ++j)
          crc = fold16_banked(tl, crc, mine[j]);
      }
    } else {  // a ragged chunk: each lane its slice, over its pieces
      long long s = c0 + (long long)lane * kLaneBytes;
      const long long e = s + kLaneBytes;
      if (s < 0) s = 0;
      if (s < e) {
        for (int r = range_of(ranges, r0, r1, s); s < e && r < r1; ++r) {
          const long long off = ranges[3 * r + 2], len = ranges[3 * r + 1];
          const long long end = off + len < e ? off + len : e;
          if (end <= s) continue;
          const uint8_t* base =
              reinterpret_cast<const uint8_t*>((uintptr_t)ranges[3 * r]);
          crc = fold_piece_banked(tl, crc, base + (s - off), end - s);
          s = end;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 5; ++j) {
      const uint32_t right = __shfl_down_sync(0xFFFFFFFFu, crc, 1 << j);
      if ((lane & ((2 << j) - 1)) == 0)
        crc = apply_op(lane_ops[j], crc) ^ right;
    }
    if (lane == 0) leaves[chunk] = crc;
  }
}

// ---------------------------------------------------------------------------
// the combine passes (both designs)
// ---------------------------------------------------------------------------

// Block (b, s): nodes [b * per, (b + 1) * per) of stream s's n_in nodes.
// The first pass (streams != nullptr) reads stream s's leaves at its first
// chunk, its N - chunks leading nodes as 0; later passes read n_in nodes
// a stream, back to back.
__global__ void crc_combine_kernel(const uint32_t* __restrict__ in,
                                   uint32_t* __restrict__ out,
                                   const long long* __restrict__ streams,
                                   long long n_in, int per, int levels,
                                   int level0,
                                   const uint32_t* __restrict__ ops) {
  __shared__ uint32_t node[kCombine];
  __shared__ uint32_t op[kCombineLevels][32];
  const int t = threadIdx.x, s = blockIdx.y;
  long long base = (long long)s * n_in, lead = 0;
  if (streams != nullptr) {
    base = streams[5 * s + 3];
    lead = n_in - streams[5 * s + 4];
  }
  const long long i = (long long)blockIdx.x * per + t;
  node[t] = i < lead ? 0u : in[base + i - lead];
  for (int k = t; k < levels * 32; k += per)
    op[k / 32][k % 32] = ops[(level0 + k / 32) * 32 + k % 32];
  __syncthreads();
  for (int k = 0; k < levels; ++k) {
    const int w = per >> (k + 1);
    uint32_t v = 0;
    if (t < w) v = apply_op(op[k], node[2 * t]) ^ node[2 * t + 1];
    __syncthreads();
    if (t < w) node[t] = v;
    __syncthreads();
  }
  if (t == 0) out[(long long)s * gridDim.x + blockIdx.x] = node[0];
}

int launch_chunks(const long long* streams, int n_streams, long long nchunks,
                  const uint32_t* ops, uint32_t* leaves, int variant,
                  cudaStream_t st) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (variant == 0) {
    static bool smem_allowed = false;  // per process
    if (!smem_allowed) {
      err = cudaFuncSetAttribute(crc_banked_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kBankedSmem);
      if (err != cudaSuccess) return (int)err;
      smem_allowed = true;
    }
    long long blocks = (nchunks + kBankedWarps - 1) / kBankedWarps;
    if (blocks > sms) blocks = sms;
    crc_banked_kernel<<<(unsigned)blocks, kBankedThreads, kBankedSmem, st>>>(
        streams, n_streams, nchunks, ops, leaves);
    return (int)cudaGetLastError();
  }
  if (variant == 1) {
    long long blocks = (nchunks + kWarps - 1) / kWarps;
    if (blocks > (long long)sms * kBlocksPerSm)
      blocks = (long long)sms * kBlocksPerSm;
    crc_chunks_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(
        streams, n_streams, nchunks, ops, leaves);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The pure CRCs of n_streams streams into out[0 .. n_streams).  table: the
// stream and range rows (see the top of this file) on the card; nchunks:
// the streams' chunks together; levels: log2(N); leaves: nchunks words;
// scratch: 2 * n_streams * (N / kCombine + 1) words; ops: the operator
// table [kLevels, 32] (kernels/ref.py crc_operators); variant: the chunk
// pass, 0 = "banked", 1 = "kept".  *launches: the device launches made
// (the chunk pass and the combine passes).
extern "C" int pcilt_crc32(const void* table, int n_streams,
                           long long nchunks, int levels, void* leaves,
                           void* scratch, const void* ops, void* out,
                           int variant, int* launches, void* stream) {
  *launches = 0;
  // the combine's grid holds a stream a row (gridDim.y): no caller nears
  // 65535 streams (a layer's record has 7)
  if (n_streams < 1 || n_streams > 65535 || nchunks < 1 || levels < 0 ||
      5 + levels > kLevels || (1LL << levels) * n_streams < nchunks)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long* streams = (const long long*)table;
  int err = launch_chunks(streams, n_streams, nchunks, (const uint32_t*)ops,
                          (uint32_t*)leaves, variant, st);
  if (err != 0) return err;
  ++*launches;
  // combine passes: n nodes a stream (a power of two) -> n / per, until
  // one is left
  const uint32_t* in = (const uint32_t*)leaves;
  const long long half = (long long)n_streams *
                         ((1LL << levels) / kCombine + 1);
  uint32_t* buf[2] = {(uint32_t*)scratch, (uint32_t*)scratch + half};
  long long n = 1LL << levels;
  int level0 = 5, pass = 0;
  do {
    const int lv = levels < kCombineLevels ? levels : kCombineLevels;
    const int per = 1 << lv;
    const long long blocks_c = n / per;
    uint32_t* dst = blocks_c == 1 ? (uint32_t*)out : buf[pass & 1];
    crc_combine_kernel<<<dim3((unsigned)blocks_c, (unsigned)n_streams), per,
                         0, st>>>(in, dst, pass == 0 ? streams : nullptr, n,
                                  per, lv, level0, (const uint32_t*)ops);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    ++*launches;
    in = dst;
    n = blocks_c;
    level0 += lv;
    levels -= lv;
    ++pass;
  } while (n > 1);
  return 0;
}

// The constants, for kernels.ops to check its mirror against: {bytes a
// lane slice, bytes a chunk, operator levels, nodes a combine block}.
extern "C" int pcilt_crc32_config(int* cfg) {
  cfg[0] = kLaneBytes;
  cfg[1] = kChunkBytes;
  cfg[2] = kLevels;
  cfg[3] = kCombine;
  return 0;
}
