// Host-packed PCILT GEMV:
//   out[m, o] = sum_g tables[g, offsets[m, g], o]
// offsets [M, G] int32 packed by the caller, tables [G, V, O]; an offset
// outside [0, V) adds nothing (the reference's one-hot fetch matches no
// row for it).  Accumulated in float32 in ascending g, cast once to the
// table dtype.  The host-packed conv2d (offsets [B, Ho, Wo, G]) is this
// kernel over the flattened pixels.
//
// Replaces: src/repro/kernels/pcilt_gemv.py pcilt_gemv_pallas and
// src/repro/kernels/pcilt_conv2d.py pcilt_conv2d_pallas.
//
// Three designs; kernels.ops chooses between them by shape
// (gemv_host_variant):
//
// "split" (the decode-size GEMVs of serve_pcilt's path="kernel" layers,
// the plans and the learnable tables, and a few row tiles of a narrow O;
// any V; gemv_host_variant weighs its row bytes against the staged grid's
// waves, a model of the crossover scripts/host_gemv_sweep.py measures).
// Bound: bytes, in practice the bytes in flight.  At M = 4 (serve_pcilt's
// gate, G 512, V 256, O 3072) a call reads one O-wide table row per (m, g),
// ~6.3 MB of rows no cache holds, which the card streams only with ~2 MB
// in flight; the direct design below ran 24 blocks there, each thread
// walking all 512 segments one 4-byte load at a time, and the staged one
// tiles 1024 rows a block, of which 4 exist.  This is kernel 9's split
// (pcilt_split.cuh: split_for, the 16-byte lane loads, the cluster's
// fixed-order reduction, the slab kernel and the grid planes) with a stage
// of its own: a block reads the kRows x (its segments) offsets it fetches
// from the caller's [M, G] array, along G (coalesced, once), into its
// staged offsets, where kernel 9 quantizes and packs x.  So kernels 6 and
// 9 split a shape alike.  An offset outside [0, V) is staged as -1: no
// load is made for it and its row's sum is kept (a select, not an add of
// 0.0).  The segment stride V*O is 64-bit, so any V is served; M up to
// 2**31 - 4 rows.  Measured on an H100 (PERF.md): 17.2 us at the gate, M
// = 4, against 710 us for the direct design and 533 us for the staged one.
//
// "staged" (V <= 256 and many rows).  Bound: the on-chip fetch.
// Each row adds G table rows of O cells, M*G*O fetch-adds (1.38e12 for the
// paper CNN's conv4 on a 1024x768 image: M 786432, G 5000, O 350), each a
// 4-byte read from on-chip memory: at 128 B a clock per SM that is ~165 ms
// on an H100, above both the operations bound (~21 ms at the float32
// rate) and the bytes: the M*G int32 offsets read once (3.93e9 of them at
// conv4, 15.7 GB, ~4.7 ms at 3.35 TB/s) and the 1.79 GB table.  The kept
// design ("direct" below) fetched every cell from L2 and ran at L2's rate,
// ~5x above that floor.  This one is kernel 4's staged fetch
// (pcilt_common.cuh, namespace staged) with the offsets read from the
// caller's array instead of packed from a code image:
//  1. A block owns kPixTile = 1024 rows and kColTile = 32 columns; for each
//     segment g it stages, through the 4-slot cp.async ring, only the rows
//     of T_g[:, o0:o0+32] that its rows name, and every row's fetch-add is
//     a byte_perm, a shared-memory load and an add.
//  2. The offsets are [M, G] row-major: one segment's offsets for 1024
//     rows are 1024 loads G*4 bytes apart.  So a row's offsets are read
//     kChunk = 8 segments at a time (32 contiguous bytes, one sector), by
//     cp.async of the widest vector that G and the array's address allow
//     (16 bytes for conv2-conv4, G*4 a multiple of 16; 8 for conv1, G 1250;
//     4 for conv0, G 25) into a raw chunk in shared memory, in the same
//     commit groups as the slices, three segments' steps before they are
//     needed; then each thread turns its two rows' raw offsets into the
//     bytes the fetch reads, marking their rows in the segments' row masks.
//     The raw chunk holds no registers across the fetch (a version that
//     loaded the offsets into registers spilled, and ran ~1.3x slower at
//     conv4).  Nothing is copied or transposed per call.
//  3. At V = 256 every byte is a valid row, so a byte cannot also say
//     "adds nothing".  An offset outside [0, V) stores byte 0 (row 0 not
//     marked), sets its row's bit in the segment's bad-row mask and the
//     segment's flag; a flagged segment takes a fetch that keeps the sum of
//     a bad row as it is (a select, not an add of 0.0).  The flag is
//     uniform across the block, so a segment without one pays nothing.
//  4. The G loop stays in the block, in ascending g: no atomics, one
//     summation order, bit-identical results launch to launch.
//  5. Block order: block b runs row tile b % n_rtiles of column tile b /
//     n_rtiles, so the blocks resident together share a column tile and
//     its slices are L2 hits; each column tile reads the whole offsets
//     array once (11 passes at conv4).  The other order (the blocks of one
//     row tile resident together: the offsets read about once, the table
//     once per wave) measured within 0.5% of it on an H100
//     (scripts/host_gemv_sweep.py, variant h:rowmajor; PERF.md).
//  6. 64-bit indexing of m * G + g (M*G is 3.93e9 at conv4).
//
// "direct" (the first design, kept for comparison and forceable; any V
// and M).  The row-tiled fetch of pcilt_common.cuh with
// offset rows as rows: a block copies a chunk of its rows' offsets into
// shared memory (reads along G, coalesced), then each thread adds its 8
// rows' cells of its column straight from the table.  No atomics.
#include "pcilt_common.cuh"
#include "pcilt_split.cuh"

namespace {

using pcilt::kRowsPerThread;
using pcilt::kSegChunk;

template <typename T>
__global__ void gemv_host_kernel(const int* __restrict__ offsets,
                                 const T* __restrict__ tab,
                                 T* __restrict__ out, long long M, int G,
                                 int V, int O) {
  extern __shared__ long long smem[];
  const int R = blockDim.y * kRowsPerThread;
  long long* s_base = smem;                          // [kSegChunk]
  int* s_off = reinterpret_cast<int*>(s_base + kSegChunk + R);  // [R][chunk]
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  const long long VO = (long long)V * O;
  const long long m0 = (long long)blockIdx.x * R;
  const int col = blockIdx.y * blockDim.x + threadIdx.x;
  const int row0 = threadIdx.y * kRowsPerThread;
  float acc[kRowsPerThread];
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) acc[k] = 0.f;

  for (int g0 = 0; g0 < G; g0 += kSegChunk) {
    const int gc = min(kSegChunk, G - g0);
    __syncthreads();
    for (int gg = tid; gg < gc; gg += nthreads)
      s_base[gg] = (long long)(g0 + gg) * VO;
    for (int i = tid; i < R * gc; i += nthreads) {
      const int r = i / gc;
      const int gg = i - r * gc;
      const long long m = m0 + r;
      int off = -1;
      if (m < M) {
        off = offsets[m * G + g0 + gg];
        if (off < 0 || off >= V) off = -1;
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
    const long long m = m0 + row0 + k;
    if (m < M) out[m * O + col] = pcilt::from_f32<T>(acc[k]);
  }
}

template <typename T>
int launch_direct(const int* offsets, const T* tab, T* out, long long M,
                  int G, int V, int O, cudaStream_t stream) {
  const dim3 block = pcilt::fetch_block(O);
  const int R = block.y * kRowsPerThread;
  const dim3 grid((unsigned)((M + R - 1) / R), (O + block.x - 1) / block.x);
  const size_t smem = pcilt::fetch_smem_bytes(R);
  cudaError_t err = pcilt::allow_smem(gemv_host_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  gemv_host_kernel<T><<<grid, block, smem, stream>>>(offsets, tab, out, M, G,
                                                     V, O);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// "staged"
// ---------------------------------------------------------------------------

namespace hstaged {

using namespace pcilt::staged;
constexpr int kChunk = 8;     // segments a row's offsets are read in
constexpr int kOffRing = 16;  // offset-byte slots (segments)
constexpr int kBadWords = kPixTile / 32;  // bad-row mask words a segment
constexpr int kPackRows = kPixTile / kThreads;  // rows a thread packs
static_assert(kChunk % 4 == 0 && kChunk >= 4, "whole 16-byte raw vectors");
static_assert(kOffRing >= kChunk + kStages + 2 && kOffRing % kChunk == 0,
              "the ring holds the fetched segment to the chunk cleared");

// Dynamic shared memory of a block: the slice blocks, then kOffRing slots
// of kPixTile offset bytes, kOffRing row masks of kMaxV bytes, kOffRing
// bad-row masks of kBadWords words, kOffRing segment flags and the raw
// int32 offsets of one chunk [kPixTile][kChunk].
__host__ __device__ constexpr size_t smem_bytes(int item) {
  return slice_bytes(item) +
         (size_t)kOffRing * (kPixTile + kMaxV + 4 * kBadWords + 4) +
         (size_t)kPixTile * kChunk * 4;
}

// acc[k] += cell (off[k], lane) of a staged slot, except for the rows whose
// bit is set in bad (kPixPerThread bits, two words): those keep their sum.
template <typename T>
__device__ __forceinline__ void fetch_slot_masked(
    float (&acc)[kPixPerThread], const unsigned char* s_tab,
    const uint8_t* off, unsigned at, const unsigned* bad) {
  const uint4* oc = reinterpret_cast<const uint4*>(off);
#pragma unroll
  for (int i = 0; i < kPixPerThread / 16; ++i) {
    const uint4 w = oc[i];
    const unsigned ws[4] = {w.x, w.y, w.z, w.w};
    const unsigned bw = bad[i / 2] >> ((i % 2) * 16);
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int k = 16 * i + 4 * q + b;
        const float v = pcilt::to_f32(*reinterpret_cast<const T*>(
            s_tab + __byte_perm(ws[q], at, 0x7604u | (b << 4))));
        acc[k] = (bw >> (4 * q + b)) & 1u ? acc[k] : acc[k] + v;
      }
  }
}

}  // namespace hstaged

// E: int32 offsets a cp.async copies (4, 2 or 1; G % E == 0 and the
// array's address aligned to E * 4 bytes).
template <typename T, int E>
__global__ void __launch_bounds__(hstaged::kThreads, 1)
    gemv_host_staged_kernel(const int* __restrict__ offsets,
                            const T* __restrict__ tab, T* __restrict__ out,
                            long long M, int G, int V, int O,
                            long long n_rtiles, int vb) {
  using namespace hstaged;
  constexpr int kAhead = kStages - 1;
  constexpr int kVecsPerRow = kChunk / E;           // copies a row a chunk
  constexpr int kLoads = kPixTile * kVecsPerRow / kThreads;  // a thread's
  extern __shared__ __align__(16) unsigned char smem_u8[];
  unsigned char* s_tab = smem_u8;
  uint8_t* s_off = smem_u8 + slice_bytes(sizeof(T));  // [kOffRing][kPixTile]
  uint8_t* s_used = s_off + kOffRing * kPixTile;      // [kOffRing][kMaxV]
  unsigned* s_bad = reinterpret_cast<unsigned*>(s_used + kOffRing * kMaxV);
  unsigned* s_flag = s_bad + kOffRing * kBadWords;     // [kOffRing]
  int* s_raw = reinterpret_cast<int*>(s_flag + kOffRing);  // [kPixTile][kChunk]
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const long long rt = blockIdx.x % n_rtiles;  // row tile
  const int ct = (int)(blockIdx.x / n_rtiles);  // column tile
  const long long m0 = rt * kPixTile;
  const int o0 = ct * kColTile;
  const int ncols = min(kColTile, O - o0);
  const long long VO = (long long)V * O;

  // -- the offsets of chunk c (segments [c*kChunk, (c+1)*kChunk)) into
  //    s_raw: copy u = i * kThreads + tid moves row u / kVecsPerRow's E
  //    offsets from segment c*kChunk + (u % kVecsPerRow) * E (a warp reads
  //    whole 32-byte runs of rows); past M or G it copies nothing
  constexpr int kRowStep = kThreads / kVecsPerRow;  // rows between copies
  const int r0 = tid / kVecsPerRow, q0 = (tid % kVecsPerRow) * E;
  const int* src0 = offsets + (m0 + r0) * G + q0;  // one pointer, stepped
  auto load = [&](int c) {
    const int g = c * kChunk + q0;
    if (g >= G) return;
    const int* src = src0 + c * kChunk;
    const long long step = (long long)kRowStep * G;
#pragma unroll
    for (int i = 0; i < kLoads; ++i, src += step) {
      const int r = r0 + i * kRowStep;
      if (m0 + r < M) cp_async<4 * E>(s_raw + r * kChunk + q0, src);
    }
  };
  // ... then, landed, turned by the thread of each row into the bytes the
  //    fetch reads: a valid offset is its byte and marks its row; an
  //    invalid one is byte 0 and sets the row's bad bit and the segment's
  //    flag; a row past M, or a segment past G, is byte 0 and marks nothing
  auto store = [&](int c) {
#pragma unroll
    for (int k = 0; k < kPackRows; ++k) {
      const int r = tid + k * kThreads;
      const bool live = m0 + r < M;
#pragma unroll
      for (int j4 = 0; j4 < kChunk; j4 += 4) {
        const int4 w = *reinterpret_cast<const int4*>(s_raw + r * kChunk + j4);
        const int raw[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int g = c * kChunk + j4 + e;
          const int s = g % kOffRing;
          uint8_t byte = 0;
          if (live && g < G) {
            if ((unsigned)raw[e] < (unsigned)V) {
              byte = (uint8_t)raw[e];
              s_used[s * kMaxV + raw[e]] = 1;
            } else {
              atomicOr(&s_bad[s * kBadWords + r / 32], 1u << (r % 32));
              s_flag[s] = 1u;
            }
          }
          s_off[s * kPixTile + r] = byte;
        }
      }
    }
  };
  // ... whose row masks, bad-row masks and flags are cleared first
  auto clear = [&](int c) {
    const int s0 = (c * kChunk) % kOffRing;
    for (int i = tid; i < kChunk * kMaxV / 4; i += kThreads)
      reinterpret_cast<unsigned*>(s_used + s0 * kMaxV)[i] = 0u;
    for (int i = tid; i < kChunk * kBadWords; i += kThreads)
      s_bad[s0 * kBadWords + i] = 0u;
    if (tid < kChunk) s_flag[s0 + tid] = 0u;
  };
  // the used rows of segment g's slice into its ring slot; one commit group
  auto issue = [&](int g) {
    if (g < G)
      copy_slice_vb<T>(s_tab + slot_offset(g % kStages, (int)sizeof(T)),
                       tab + g * VO + o0, s_used + (g % kOffRing) * kMaxV, O,
                       ncols, vb);
    cp_async_commit();
  };

  // Pipeline, at segment g: the used rows of segment g + kAhead's slice are
  // copied; segment g is fetched; and with h = g + kAhead + 1, chunk h /
  // kChunk's offsets are stored (h % kChunk == 0), cleared a step before
  // (h + 1) and copied in kAhead steps before (h + kAhead), in that step's
  // commit group, which the wait of the storing step has seen land.  Chunk
  // 0 (and chunk 1, when its copy falls before step 0) before the loop.
  clear(0);
  clear(1);
  load(0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  store(0);
  __syncthreads();
  if (kChunk < 2 * kAhead + 1) load(1);  // lands with slice 0's group
#pragma unroll 1
  for (int g = 0; g < kAhead; ++g) issue(g);

  float acc[kPixPerThread];
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) acc[k] = 0.f;
  const unsigned lane_byte = lane * (unsigned)sizeof(T);

#pragma unroll 1
  for (int g = 0; g < G; ++g) {
    cp_async_wait<kAhead - 1>();  // this thread's copies of slice g landed
    __syncthreads();  // everyone's; slot (g - 1) % kStages is free again
    const int h = g + kAhead + 1;
    if ((h + kAhead) % kChunk == 0 && h + kAhead < G)
      load((h + kAhead) / kChunk);
    issue(g + kAhead);
    if ((h + 1) % kChunk == 0 && h + 1 < G) clear((h + 1) / kChunk);
    const int s = g % kOffRing;
    const uint8_t* off = s_off + s * kPixTile + warp * kPixPerThread;
    const unsigned at = slot_offset(g % kStages, (int)sizeof(T)) + lane_byte;
    if (s_flag[s])
      fetch_slot_masked<T>(acc, s_tab, off, at,
                           s_bad + s * kBadWords + warp * 2);
    else
      fetch_slot<T>(acc, s_tab, off, at);
    if (h % kChunk == 0 && h < G) store(h / kChunk);
  }

  if (lane >= ncols) return;
  const long long mrow = m0 + warp * kPixPerThread;
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) {
    const long long m = mrow + k;
    if (m < M) out[m * O + o0 + lane] = pcilt::from_f32<T>(acc[k]);
  }
}

template <typename T, int E>
int launch_staged_e(const int* offsets, const T* tab, T* out, long long M,
                    int G, int V, int O, long long n_rtiles, int n_ctiles,
                    cudaStream_t stream) {
  const size_t smem = hstaged::smem_bytes((int)sizeof(T));
  cudaError_t err = pcilt::allow_smem(gemv_host_staged_kernel<T, E>, smem);
  if (err != cudaSuccess) return (int)err;
  gemv_host_staged_kernel<T, E>
      <<<(unsigned)(n_rtiles * n_ctiles), hstaged::kThreads, smem, stream>>>(
          offsets, tab, out, M, G, V, O, n_rtiles,
          pcilt::staged::copy_width(tab, O, sizeof(T)));
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// "split"
// ---------------------------------------------------------------------------

namespace split = pcilt::split;

// The most rows a split launch takes (its row chunks are int).
constexpr long long kSplitMaxRows = 0x7ffffffcLL;

// The split's stage: rows b0 .. b0 + kRows - 1 (nb of them real) of the
// caller's [M, G] offsets at segments t0 .. t0 + ns - 1 into s_off[g -
// t0][row], read along G (coalesced); an offset outside [0, V), or a row
// past M, is staged as -1, which adds nothing.
__device__ __forceinline__ void read_offsets(const int* __restrict__ offsets,
                                             int* s_off, int b0, int nb,
                                             int t0, int ns, int G, int V) {
  for (int i = threadIdx.x; i < split::kRows * ns; i += blockDim.x) {
    const int r = i / ns;
    const int gl = i - r * ns;
    int o = -1;
    if (r < nb) {
      const int v = offsets[(long long)(b0 + r) * G + t0 + gl];
      o = (unsigned)v < (unsigned)V ? v : -1;
    }
    s_off[gl * split::kRows + r] = o;
  }
}

// segments a load batch: 2 in the bfloat16 instances, as in kernel 9's
template <typename T>
constexpr int kHostBatch = sizeof(T) == 2 ? 2 : split::kSegBatch;

// The one-pass kernel and the slab kernel (pcilt_split.cuh one_pass,
// slab_pass) over the caller's offsets; launch bounds (128, 1), as kernel
// 9's.
template <typename T, int VB>
__global__ void __launch_bounds__(32 * split::kWarps, 1)
    gemv_host_split_kernel(const int* __restrict__ offsets,
                           const T* __restrict__ tab, T* __restrict__ out,
                           int M, int G, int V, int O, long long seg_stride,
                           split::Split sp) {
  split::one_pass<T, VB, kHostBatch<T>, true>(
      [=](int* s_off, int b0, int nb, int t0, int ns, bool) {
        read_offsets(offsets, s_off, b0, nb, t0, ns, G, V);
      },
      tab, out, M, G, O, seg_stride, sp);
}

template <typename T, int VB>
__global__ void __launch_bounds__(32 * split::kWarps, 1)
    gemv_host_split_slabs_kernel(const int* __restrict__ offsets,
                                 const T* __restrict__ tab,
                                 T* __restrict__ out, int M, int G, int V,
                                 int O, long long seg_stride,
                                 split::Split sp) {
  split::slab_pass<T, VB, kHostBatch<T>, true>(
      [=](int* s_off, int b0, int nb, int t0, int ns, bool) {
        read_offsets(offsets, s_off, b0, nb, t0, ns, G, V);
      },
      tab, out, M, G, O, seg_stride, sp);
}

template <typename T, int VB, bool SLABS>
int launch_split_kernel(const int* offsets, const T* tab, T* out, int M,
                        int G, int V, int O, const split::Split& sp,
                        cudaStream_t stream) {
  static split::KernelState state;  // this instance's, per process
  auto kernel = SLABS ? gemv_host_split_slabs_kernel<T, VB>
                      : gemv_host_split_kernel<T, VB>;
  return split::launch_cluster(kernel, sp, state, stream, offsets, tab, out,
                               M, G, V, O, (long long)V * O, sp);
}

// The split of kernel 9 at (M, G, O, itemsize), the slab kernel only where
// a block's segments overflow a slab, the widest load the table allows.
template <typename T>
int launch_split(const int* offsets, const T* tab, T* out, long long M,
                 int G, int V, int O, cudaStream_t stream) {
  if (M < 1 || M > kSplitMaxRows || G < 1 || V < 1 || O < 1)
    return (int)cudaErrorInvalidValue;
  const split::Split sp = split::split_for((int)M, G, O, (int)sizeof(T));
  const bool slabs = split::split_slabs(sp, G);
  return split::with_load_width(tab, O, (long long)V * O, [&](auto vb) {
    constexpr int VB = decltype(vb)::value;
    if (slabs)
      return launch_split_kernel<T, VB, true>(offsets, tab, out, (int)M, G,
                                              V, O, sp, stream);
    return launch_split_kernel<T, VB, false>(offsets, tab, out, (int)M, G, V,
                                             O, sp, stream);
  });
}

// variant: 0 = "staged", 1 = "direct", 2 = "split".
template <typename T>
int launch(const int* offsets, const T* tab, T* out, long long M, int G,
           int V, int O, int variant, cudaStream_t stream) {
  if (variant == 1) return launch_direct(offsets, tab, out, M, G, V, O, stream);
  if (variant == 2) return launch_split(offsets, tab, out, M, G, V, O, stream);
  if (variant != 0 || V < 1 || V > hstaged::kMaxV || M < 1 || G < 1 || O < 1)
    return (int)cudaErrorInvalidValue;
  const long long n_rtiles = (M + hstaged::kPixTile - 1) / hstaged::kPixTile;
  const int n_ctiles = (O + hstaged::kColTile - 1) / hstaged::kColTile;
  if (n_rtiles * n_ctiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const unsigned long long a = (unsigned long long)offsets;
  if (G % 4 == 0 && a % 16 == 0)
    return launch_staged_e<T, 4>(offsets, tab, out, M, G, V, O, n_rtiles,
                                 n_ctiles, stream);
  if (G % 2 == 0 && a % 8 == 0)
    return launch_staged_e<T, 2>(offsets, tab, out, M, G, V, O, n_rtiles,
                                 n_ctiles, stream);
  return launch_staged_e<T, 1>(offsets, tab, out, M, G, V, O, n_rtiles,
                               n_ctiles, stream);
}

}  // namespace

extern "C" int pcilt_gemv_host_f32(const void* offsets, const void* tab,
                                   void* out, long long M, int G, int V,
                                   int O, int variant, void* stream) {
  return launch<float>((const int*)offsets, (const float*)tab, (float*)out,
                       M, G, V, O, variant, (cudaStream_t)stream);
}

extern "C" int pcilt_gemv_host_bf16(const void* offsets, const void* tab,
                                    void* out, long long M, int G, int V,
                                    int O, int variant, void* stream) {
  return launch<__nv_bfloat16>((const int*)offsets,
                               (const __nv_bfloat16*)tab,
                               (__nv_bfloat16*)out, M, G, V, O, variant,
                               (cudaStream_t)stream);
}

// The staged design's tiling, for kernels.ops to check its mirror against:
// {rows a block, columns a block, slice slots, segments a chunk, offset
// slots, largest V}.
extern "C" int pcilt_gemv_host_staged_config(int* cfg) {
  cfg[0] = hstaged::kPixTile;
  cfg[1] = hstaged::kColTile;
  cfg[2] = hstaged::kStages;
  cfg[3] = hstaged::kChunk;
  cfg[4] = hstaged::kOffRing;
  cfg[5] = hstaged::kMaxV;
  return 0;
}

// The split design's constants and its split of one call, kernel 9's
// (pcilt_split.cuh write_config, write_plan), for kernels.ops to check its
// mirror against.
extern "C" int pcilt_gemv_split_config(int* cfg) {
  return pcilt::split::write_config(cfg);
}

extern "C" int pcilt_gemv_split_plan(int B, int G, int O, int itemsize,
                                     int* out) {
  return pcilt::split::write_plan(B, G, O, itemsize, out);
}
