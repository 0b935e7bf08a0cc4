// Fused PCILT conv2d, dense tables or a shared pool (paper extension 3):
//   out[b, y, x, o] = sum_g T_g[pack(quant(patch[g*group : (g+1)*group])), o]
// over the [kh, kw, C]-flattened patch of the spatially padded float image
// at (y*stride, x*stride); T_g = tables[g] (dense) or pool[seg_idx[g]]
// (shared; a pointer outside [0, X) adds nothing).  Patch slots at and
// past n = kh*kw*C (group alignment, tables built from zero weights) take
// code 0.  Accumulated in float32, cast once to the table dtype.
//
// Sharded tables (a mesh's segment shards): a launch's tables are one
// shard's G segments, global segments seg_offset .. seg_offset + G - 1 of
// a patch whose padded length is n_total (>= kh*kw*C; the alignment slots
// past kh*kw*C take code 0).  Segment g of the launch reads patch
// positions (seg_offset + g) * group + j.  Unsharded: seg_offset 0,
// n_total G * group.  The staged design's pre-pass quantizes only the
// channels the shard's positions touch (all of them once its positions
// span a tap's C channels).
//
// Replaces: src/repro/kernels/pcilt_fused.py pcilt_fused_conv2d_pallas
// (body _conv_kernel, _strip_offsets) and src/repro/kernels/pcilt_shared.py
// pcilt_shared_conv2d_pallas (without its per-call [V, X, O] transpose).
//
// Two designs; kernels.ops chooses between them by shape (conv_variant):
//
// "staged" (V <= 256: every offset fits a byte).  Bound: the on-chip fetch.
// Each output pixel adds G rows of O cells, P*G*O fetch-adds (1.4e12 for
// the paper CNN's conv4 on a 1024x768 image), each a 4-byte load from
// on-chip memory: at 128 B a clock per SM that is ~164 ms at conv4, far
// above the 1.8 GB table's HBM time.  The earlier design ("direct" below)
// fetched every cell from L2 and ran at the card's L2 rate, ~6x above that
// floor.  This one:
//  1. A pre-pass (conv2d_codes_kernel) quantizes the padded image once per
//     element into a channel-planar uint8 code image [B, C, Hp, Wp]: a
//     quarter of the float image's bytes, so neither the im2col patch nor
//     the [P, G] offsets reach device memory, and no element is quantized
//     again per (pixel, segment, O tile).  Planar, so that the codes of
//     neighbouring pixels for one patch position are neighbouring bytes.
//     (The alternative, quantizing each block's input halo into shared
//     memory, would need the halo of all C channels for segments that
//     straddle channels at group > 1, and the smem is the slices'.)
//  2. A block owns kPixTile = 1024 consecutive output pixels and one O
//     tile of kColTile = 32 columns; lane l of every warp owns column l,
//     each of 16 warps 64 pixels (64 float32 accumulators a thread).  For
//     each segment g the block stages T_g[:, o0:o0+32] in shared memory
//     once and all 1024 pixels fetch from there.  A warp reads one pixel's
//     row across 32 neighbouring columns: one conflict-free wavefront.
//  3. Only the rows that some pixel of the block names are staged: the
//     offsets of a segment are packed one segment before its slice is
//     copied, marking their rows in a byte mask.  On the paper CNN's real
//     activations a block meets ~60 of the 256 codes per segment, so L2
//     serves a quarter of the slice bytes it would otherwise.
//  4. The slices move by cp.async through a ring of kStages = 4 slots, 3
//     segments ahead.  cp.async, not TMA: a tensor map needs 16-byte
//     global strides, and the table's row stride O*4 is 1400 B at conv4
//     (O 350) and 200 B at conv0 (O 50).  The copy width is the widest of
//     16, 8 and 4 bytes that the row stride and the table's address allow
//     (element by element for a bf16 table of odd O).
//  5. Slice rows are 256 bytes apart and a slot's 32 columns sit side by
//     side with the other slots' in those rows (64 KB blocks), so one
//     byte_perm of a pixel's offset byte and a per-lane word is the whole
//     shared-memory address: a fetch-add is byte_perm, load, add.  The
//     fetch reads 16 pixels' offsets in one 16-byte broadcast.
//  6. Each thread packs the offsets of 2 pixels per segment from the code
//     image; its loads are issued a whole segment before they are packed
//     (two register sets), so no pack waits on a load of its own segment.
//  7. The G loop stays in the block, in ascending g: no atomics, one
//     summation order, bit-identical results run to run.
//  8. Block b runs pixel tile b % n_ptiles of O tile b / n_ptiles: the
//     blocks resident together share an O tile and walk G at the same
//     pace, so their slices are L2 hits and the table streams from HBM a
//     few times per O tile, not once per block.
// Measured at conv4 on an H100 (the fetch loop alone 214 ms): the copy
// issue and the code loads add ~180 ms that the fetch does not hide; see
// PERF.md.
//
// "direct" (any V; kept for tables whose slice cannot be staged, e.g.
// V = 65536 at 8 bits x group 2).  The row-tiled fetch of
// pcilt_common.cuh with pixels as rows: a block stages, per chunk of
// segments, every pixel's packed offset in shared memory, quantizing the
// patch element in place, then each thread adds its 8 pixels' cells of its
// column straight from the table, 8 independent loads per segment.  Bound
// in practice by L2's rate, since the 16 pixels of a block share no row.
#include <algorithm>

#include "pcilt_common.cuh"

namespace {

using pcilt::kRowsPerThread;
using pcilt::kSegChunk;

template <typename T, bool kShared>
__global__ void conv2d_kernel(const float* __restrict__ x,
                              const T* __restrict__ tab,
                              const int* __restrict__ seg_idx,
                              T* __restrict__ out, long long P, int Hp,
                              int Wp, int C, int Ho, int Wo, int kh, int kw,
                              int stride, int G, int X, int V, int O,
                              int group, int bits, int zp, float scale,
                              int seg_offset) {
  extern __shared__ long long smem[];
  const int R = blockDim.y * kRowsPerThread;
  long long* s_base = smem;                              // [kSegChunk]
  long long* s_pix = s_base + kSegChunk;                 // [R]
  int* s_off = reinterpret_cast<int*>(s_pix + R);        // [R][kSegChunk]
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  const int kmax = (1 << bits) - 1;
  const int n = kh * kw * C;
  const long long VO = (long long)V * O;
  const long long pix0 = (long long)blockIdx.x * R;

  // element index of x[b, y*stride, x*stride, 0] for each row; -1 past P
  for (int r = tid; r < R; r += nthreads) {
    const long long p = pix0 + r;
    long long base = -1;
    if (p < P) {
      const long long b = p / ((long long)Ho * Wo);
      const int rem = (int)(p - b * Ho * Wo);
      const int oy = rem / Wo, ox = rem - (rem / Wo) * Wo;
      base = ((b * Hp + (long long)oy * stride) * Wp +
              (long long)ox * stride) * C;
    }
    s_pix[r] = base;
  }

  const int col = blockIdx.y * blockDim.x + threadIdx.x;
  const int row0 = threadIdx.y * kRowsPerThread;
  float acc[kRowsPerThread];
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) acc[k] = 0.f;

  for (int g0 = 0; g0 < G; g0 += kSegChunk) {
    const int gc = min(kSegChunk, G - g0);
    __syncthreads();  // the previous chunk's readers are done; s_pix is set
    for (int gg = tid; gg < gc; gg += nthreads) {
      const int g = g0 + gg;
      long long base = (long long)g * VO;
      if (kShared) {
        const int s = seg_idx[g];
        base = (s >= 0 && s < X) ? (long long)s * VO : -1;
      }
      s_base[gg] = base;
    }
    for (int i = tid; i < R * gc; i += nthreads) {
      const int r = i / gc;
      const int gg = i - r * gc;
      const long long pb = s_pix[r];
      int off = -1;
      if (pb >= 0) {
        off = 0;
        for (int j = 0; j < group; ++j) {
          const int p = (seg_offset + g0 + gg) * group + j;
          if (p >= n) break;  // alignment slots: code 0
          const int tap = p / C;
          const int c = p - tap * C;
          const int ti = tap / kw;
          const int tj = tap - ti * kw;
          bool sat;
          const int code = pcilt::quantize_code(
              x[pb + ((long long)ti * Wp + tj) * C + c], scale, zp, kmax,
              &sat);
          off |= code << (j * bits);
        }
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
    const long long p = pix0 + row0 + k;
    if (p < P) out[p * O + col] = pcilt::from_f32<T>(acc[k]);
  }
}

// The shard's segments lie inside the padded patch, which covers the patch.
bool shard_fits(int kh, int kw, int C, int G, int group, int seg_offset,
                int n_total) {
  return seg_offset >= 0 && (long long)kh * kw * C <= n_total &&
         ((long long)seg_offset + G) * group <= n_total;
}

template <typename T, bool kShared>
int launch(const float* x, const T* tab, const int* seg_idx, T* out, int B,
           int Hp, int Wp, int C, int Ho, int Wo, int kh, int kw, int stride,
           int G, int X, int V, int O, int group, int bits, int zp,
           float scale, int seg_offset, int n_total, cudaStream_t stream) {
  if (!shard_fits(kh, kw, C, G, group, seg_offset, n_total))
    return (int)cudaErrorInvalidValue;
  const dim3 block = pcilt::fetch_block(O);
  const int R = block.y * kRowsPerThread;
  const long long P = (long long)B * Ho * Wo;
  const dim3 grid((unsigned)((P + R - 1) / R), (O + block.x - 1) / block.x);
  const size_t smem = pcilt::fetch_smem_bytes(R);
  cudaError_t err = pcilt::allow_smem(conv2d_kernel<T, kShared>, smem);
  if (err != cudaSuccess) return (int)err;
  conv2d_kernel<T, kShared><<<grid, block, smem, stream>>>(
      x, tab, seg_idx, out, P, Hp, Wp, C, Ho, Wo, kh, kw, stride, G, X, V, O,
      group, bits, zp, scale, seg_offset);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// "staged": the code pre-pass, then the slice-staged fetch
// ---------------------------------------------------------------------------

namespace staged {

using namespace pcilt::staged;
constexpr int kOffRing = 8;     // offset and row-mask slots (5 live)
constexpr int kStagePix = kPixTile / kThreads;        // offsets a thread packs
constexpr int kCodeTile = 32;                         // pre-pass transpose tile

// Dynamic shared memory of a block: the slice blocks, then kOffRing slots
// of kPixTile offset bytes, then kOffRing row masks of kMaxV bytes.
__host__ __device__ constexpr size_t smem_bytes(int item) {
  return slice_bytes(item) + (size_t)kOffRing * (kPixTile + kMaxV);
}

// The patch position the walk's next segment reads its codes from: pos,
// its channel c, tap column tj and code-image element offset delta of (c,
// ti, tj), stepped one position at a time in [kh, kw, C] order.
struct PatchWalk {
  int pos, c, tj;
  long long delta;
  __device__ __forceinline__ void step(int C, int kw, long long HWp, int Wp) {
    ++pos;
    if (++c < C) {
      delta += HWp;
      return;
    }
    c = 0;
    delta -= (long long)(C - 1) * HWp;
    if (++tj < kw) {
      delta += 1;
      return;
    }
    tj = 0;
    delta += Wp - (kw - 1);
  }
};

}  // namespace staged

// x [B, S = Hp*Wp, C] float32 -> codes [B, Cs, S] uint8 of channels
// c0 .. c0 + Cs - 1, each element quantized once; a 32 x 32 tile through
// shared memory keeps both the read and the write coalesced.
__global__ void conv2d_codes_kernel(const float* __restrict__ x,
                                    uint8_t* __restrict__ codes, long long S,
                                    int C, int c0, int Cs, int kmax, int zp,
                                    float scale) {
  using staged::kCodeTile;
  __shared__ uint8_t tile[kCodeTile][kCodeTile + 1];
  const long long s0 = (long long)blockIdx.x * kCodeTile;
  const long long b = blockIdx.z;
  const int t0 = blockIdx.y * kCodeTile;  // the tile's first plane
  for (int r = threadIdx.y; r < kCodeTile; r += blockDim.y) {
    const long long s = s0 + r;
    const int t = t0 + threadIdx.x;
    if (s < S && t < Cs) {
      bool sat;
      tile[r][threadIdx.x] = (uint8_t)pcilt::quantize_code(
          x[(b * S + s) * C + c0 + t], scale, zp, kmax, &sat);
    }
  }
  __syncthreads();
  for (int r = threadIdx.y; r < kCodeTile; r += blockDim.y) {
    const int t = t0 + r;
    const long long s = s0 + threadIdx.x;
    if (s < S && t < Cs) codes[(b * Cs + t) * S + s] = tile[threadIdx.x][r];
  }
}

// The raw codes of the next segment's (up to kG) patch positions for this
// thread's kStagePix pixels, and a mask per position (0: past group or n,
// the end of the shard's live positions: code 0); advances the walk to the
// segment after.  Every load is in bounds: a position that adds nothing
// reads the pixel's own code of the first plane.
template <int kG>
__device__ __forceinline__ void load_codes(
    const uint8_t* __restrict__ codes,
    const long long (&pbase)[staged::kStagePix], staged::PatchWalk& walk,
    int group, int n, int C, int kw, long long HWp, int Wp,
    unsigned (&raw)[staged::kStagePix][kG], unsigned (&mask)[kG]) {
#pragma unroll
  for (int j = 0; j < kG; ++j) {
    const bool live = j < group && walk.pos < n;
    const long long delta = live ? walk.delta : 0;
    mask[j] = live ? 0xffu : 0u;
    if (j < group) walk.step(C, kw, HWp, Wp);
#pragma unroll
    for (int k = 0; k < staged::kStagePix; ++k)
      raw[k][j] = codes[pbase[k] + delta];
  }
}

// Pack the offsets into dst (a byte a pixel) and mark their rows in used.
template <int kG>
__device__ __forceinline__ void store_offsets(
    uint8_t* dst, uint8_t* used, const unsigned (&raw)[staged::kStagePix][kG],
    const unsigned (&mask)[kG], int bits) {
#pragma unroll
  for (int k = 0; k < staged::kStagePix; ++k) {
    unsigned off = 0;
#pragma unroll
    for (int j = 0; j < kG; ++j) off |= (raw[k][j] & mask[j]) << (j * bits);
    dst[threadIdx.x + k * staged::kThreads] = (uint8_t)off;
    used[off] = 1;
  }
}

template <typename T, bool kShared, int kG>
__global__ void __launch_bounds__(staged::kThreads, 1)
    conv2d_staged_kernel(const uint8_t* __restrict__ codes,
                         const T* __restrict__ tab,
                         const int* __restrict__ seg_idx,
                         T* __restrict__ out, long long P, int C, int Hp,
                         int Wp, int Ho, int Wo, int kw, int stride, int G,
                         int X, int V, int O, int n, int group, int bits,
                         long long n_ptiles, int vb, int p0, int c0,
                         int Cs) {
  using namespace staged;
  constexpr int kAhead = kStages - 1;
  extern __shared__ __align__(16) unsigned char smem_u8[];
  unsigned char* s_tab = smem_u8;
  uint8_t* s_off = smem_u8 + (smem_bytes(sizeof(T)) -
                              (size_t)kOffRing * (kPixTile + kMaxV));
  uint8_t* s_used = s_off + kOffRing * kPixTile;  // [kOffRing][kMaxV]
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const long long pix0 = (long long)(blockIdx.x % n_ptiles) * kPixTile;
  const int o0 = (int)(blockIdx.x / n_ptiles) * kColTile;
  const int ncols = min(kColTile, O - o0);
  const long long HWp = (long long)Hp * Wp;
  const long long VO = (long long)V * O;

  // code-image element of codes[b, 0, oy*stride, ox*stride] (plane 0 is
  // channel c0) for each pixel this thread packs (past P: 0, a valid code;
  // the pixel is never stored)
  long long pbase[kStagePix];
#pragma unroll
  for (int k = 0; k < kStagePix; ++k) {
    const long long p = pix0 + tid + k * kThreads;
    pbase[k] = 0;
    if (p < P) {
      const long long b = p / ((long long)Ho * Wo);
      const int rem = (int)(p - b * Ho * Wo);
      const int oy = rem / Wo, ox = rem - (rem / Wo) * Wo;
      pbase[k] = b * Cs * HWp + (long long)oy * stride * Wp +
                 (long long)ox * stride;
    }
  }

  // element index of segment g's [V, O] table; -1: the segment adds nothing
  auto table_of = [&](int g) -> long long {
    if (!kShared) return (long long)g * VO;
    const int s = seg_idx[g];
    return (s >= 0 && s < X) ? (long long)s * VO : -1;
  };
  // the used rows of segment g's slice into its ring slot; one commit group
  auto issue = [&](int g) {
    const long long base = g < G ? table_of(g) : -1;
    if (base >= 0) {
      unsigned char* dst = s_tab + slot_offset(g % kStages, (int)sizeof(T));
      const uint8_t* used = s_used + (g % kOffRing) * kMaxV;
      copy_slice_vb<T>(dst, tab + base + o0, used, O, ncols, vb);
    }
    cp_async_commit();
  };

  // Pipeline, at segment g: the used rows of segment g + kAhead's slice are
  // copied; segment g + kAhead + 2's codes are loaded; segment g is
  // fetched; segment g + kAhead + 1's codes (loaded a segment earlier, into
  // the other register set) are packed and their rows marked.  A row mask
  // is cleared a segment before it is marked.
  for (int i = tid; i < kOffRing * kMaxV / 4; i += kThreads)
    reinterpret_cast<unsigned*>(s_used)[i] = 0u;
  __syncthreads();
  // the walk starts at the shard's first position p0 = seg_offset * group
  PatchWalk walk;
  {
    const int tap = p0 / C;
    walk.pos = p0;
    walk.c = p0 - tap * C;
    walk.tj = tap % kw;
    walk.delta = (long long)(walk.c - c0) * HWp + (long long)(tap / kw) * Wp +
                 walk.tj;
  }
  unsigned raw0[kStagePix][kG], mask0[kG], raw1[kStagePix][kG], mask1[kG];
#pragma unroll 1
  for (int g = 0; g <= kAhead; ++g) {
    load_codes<kG>(codes, pbase, walk, group, n, C, kw, HWp, Wp, raw0, mask0);
    store_offsets<kG>(s_off + (g % kOffRing) * kPixTile,
                      s_used + (g % kOffRing) * kMaxV, raw0, mask0, bits);
  }
  load_codes<kG>(codes, pbase, walk, group, n, C, kw, HWp, Wp, raw1, mask1);
  __syncthreads();
#pragma unroll 1
  for (int g = 0; g < kAhead; ++g) issue(g);

  float acc[kPixPerThread];
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) acc[k] = 0.f;
  const unsigned lane_byte = lane * (unsigned)sizeof(T);

  // cell (v, lane) of a slot: byte v << 8 | at of s_tab, one byte_perm of
  // the offset byte v into byte 1 of at
  auto fetch = [&](int g) {
    fetch_slot<T>(acc, s_tab,
                  s_off + (g % kOffRing) * kPixTile + warp * kPixPerThread,
                  slot_offset(g % kStages, (int)sizeof(T)) + lane_byte);
  };
  auto segment = [&](int g, unsigned (&raw_in)[kStagePix][kG],
                     unsigned (&mask_in)[kG], unsigned (&raw_out)[kStagePix][kG],
                     unsigned (&mask_out)[kG]) {
    cp_async_wait<kAhead - 1>();  // this thread's copies of slice g landed
    __syncthreads();  // everyone's; slot (g - 1) % kStages is free again
    issue(g + kAhead);
    load_codes<kG>(codes, pbase, walk, group, n, C, kw, HWp, Wp, raw_in,
                   mask_in);
    if (tid < kMaxV / 4)
      reinterpret_cast<unsigned*>(
          s_used + ((g + kAhead + 2) % kOffRing) * kMaxV)[tid] = 0u;
    if (table_of(g) >= 0) fetch(g);
    const int gs = g + kAhead + 1;
    store_offsets<kG>(s_off + (gs % kOffRing) * kPixTile,
                      s_used + (gs % kOffRing) * kMaxV, raw_out, mask_out,
                      bits);
  };
#pragma unroll 1
  for (int g = 0; g < G; g += 2) {
    segment(g, raw0, mask0, raw1, mask1);
    if (g + 1 < G) segment(g + 1, raw1, mask1, raw0, mask0);
  }

  if (lane >= ncols) return;
  const long long prow = pix0 + warp * kPixPerThread;
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) {
    const long long p = prow + k;
    if (p < P) out[p * O + o0 + lane] = pcilt::from_f32<T>(acc[k]);
  }
}

template <typename T, bool kShared, int kG>
int launch_staged_g(const uint8_t* codes, const T* tab, const int* seg_idx,
                    T* out, long long P, int C, int Hp, int Wp, int Ho,
                    int Wo, int kw, int stride, int G, int X, int V, int O,
                    int n, int group, int bits, long long n_ptiles,
                    long long blocks, int p0, int c0, int Cs,
                    cudaStream_t stream) {
  const size_t smem = staged::smem_bytes((int)sizeof(T));
  cudaError_t err =
      pcilt::allow_smem(conv2d_staged_kernel<T, kShared, kG>, smem);
  if (err != cudaSuccess) return (int)err;
  conv2d_staged_kernel<T, kShared, kG>
      <<<(unsigned)blocks, staged::kThreads, smem, stream>>>(
          codes, tab, seg_idx, out, P, C, Hp, Wp, Ho, Wo, kw, stride, G, X,
          V, O, n, group, bits, n_ptiles,
          staged::copy_width(tab, O, sizeof(T)), p0, c0, Cs);
  return (int)cudaGetLastError();
}

// codes holds planes c0 .. c0 + Cs - 1: every channel that the shard's
// live positions seg_offset * group .. min(kh*kw*C, (seg_offset + G) *
// group) - 1 touch.
template <typename T, bool kShared>
int launch_staged(const uint8_t* codes, const T* tab, const int* seg_idx,
                  T* out, int B, int C, int Hp, int Wp, int Ho, int Wo,
                  int kh, int kw, int stride, int G, int X, int V, int O,
                  int group, int bits, int seg_offset, int n_total, int c0,
                  int Cs, cudaStream_t stream) {
  using namespace staged;
  if (group < 1 || group > 8 || bits < 1 || bits * group > 8 ||
      V != (1 << (bits * group)) || V > kMaxV ||
      !shard_fits(kh, kw, C, G, group, seg_offset, n_total) || c0 < 0 ||
      Cs < 1 || c0 + Cs > C)
    return (int)cudaErrorInvalidValue;
  const long long P = (long long)B * Ho * Wo;
  const long long n_ptiles = (P + kPixTile - 1) / kPixTile;
  const long long blocks = n_ptiles * ((O + kColTile - 1) / kColTile);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int p0 = seg_offset * group;
  const int n = (int)std::min<long long>((long long)kh * kw * C,
                                         ((long long)seg_offset + G) * group);
  if (n > p0) {  // the live positions' channels lie in the planes
    const int c_first = p0 % C, c_last = (n - 1) % C;
    const bool one_tap = p0 / C == (n - 1) / C;
    if (one_tap ? (c_first < c0 || c_last >= c0 + Cs) : (c0 != 0 || Cs != C))
      return (int)cudaErrorInvalidValue;
  }
#define PCILT_STAGED_G(KG)                                                   \
  return launch_staged_g<T, kShared, KG>(codes, tab, seg_idx, out, P, C, Hp, \
                                         Wp, Ho, Wo, kw, stride, G, X, V, O, \
                                         n, group, bits, n_ptiles, blocks,   \
                                         p0, c0, Cs, stream)
  if (group == 1) PCILT_STAGED_G(1);
  if (group == 2) PCILT_STAGED_G(2);
  if (group <= 4) PCILT_STAGED_G(4);
  PCILT_STAGED_G(8);
#undef PCILT_STAGED_G
}

int launch_codes(const float* x, uint8_t* codes, int B, int Hp, int Wp,
                 int C, int c0, int Cs, int bits, int zp, float scale,
                 cudaStream_t stream) {
  using staged::kCodeTile;
  if (bits < 1 || bits > 8 || B > 65535 || c0 < 0 || Cs < 1 ||
      c0 + Cs > C || Cs > 65535 * kCodeTile)
    return (int)cudaErrorInvalidValue;
  const long long S = (long long)Hp * Wp;
  const dim3 grid((unsigned)((S + kCodeTile - 1) / kCodeTile),
                  (Cs + kCodeTile - 1) / kCodeTile, B);
  conv2d_codes_kernel<<<grid, dim3(kCodeTile, 8), 0, stream>>>(
      x, codes, S, C, c0, Cs, (1 << bits) - 1, zp, scale);
  return (int)cudaGetLastError();
}

}  // namespace

#define PCILT_CONV2D_ENTRY(NAME, TYPE, SHARED)                               \
  extern "C" int NAME(const void* x, const void* tab, const void* seg_idx,  \
                      void* out, int B, int Hp, int Wp, int C, int Ho,      \
                      int Wo, int kh, int kw, int stride, int G, int X,     \
                      int V, int O, int group, int bits, int zp,            \
                      float scale, int seg_offset, int n_total,             \
                      void* stream) {                                       \
    return launch<TYPE, SHARED>((const float*)x, (const TYPE*)tab,          \
                                (const int*)seg_idx, (TYPE*)out, B, Hp, Wp, \
                                C, Ho, Wo, kh, kw, stride, G, X, V, O,      \
                                group, bits, zp, scale, seg_offset,         \
                                n_total, (cudaStream_t)stream);             \
  }

PCILT_CONV2D_ENTRY(pcilt_fused_conv2d_f32, float, false)
PCILT_CONV2D_ENTRY(pcilt_fused_conv2d_bf16, __nv_bfloat16, false)
PCILT_CONV2D_ENTRY(pcilt_shared_conv2d_f32, float, true)
PCILT_CONV2D_ENTRY(pcilt_shared_conv2d_bf16, __nv_bfloat16, true)

#define PCILT_CONV2D_STAGED_ENTRY(NAME, TYPE, SHARED)                        \
  extern "C" int NAME(const void* codes, const void* tab,                   \
                      const void* seg_idx, void* out, int B, int C, int Hp, \
                      int Wp, int Ho, int Wo, int kh, int kw, int stride,   \
                      int G, int X, int V, int O, int group, int bits,      \
                      int seg_offset, int n_total, int c0, int Cs,          \
                      void* stream) {                                       \
    return launch_staged<TYPE, SHARED>(                                     \
        (const uint8_t*)codes, (const TYPE*)tab, (const int*)seg_idx,       \
        (TYPE*)out, B, C, Hp, Wp, Ho, Wo, kh, kw, stride, G, X, V, O,       \
        group, bits, seg_offset, n_total, c0, Cs, (cudaStream_t)stream);    \
  }

PCILT_CONV2D_STAGED_ENTRY(pcilt_fused_conv2d_staged_f32, float, false)
PCILT_CONV2D_STAGED_ENTRY(pcilt_fused_conv2d_staged_bf16, __nv_bfloat16,
                          false)
PCILT_CONV2D_STAGED_ENTRY(pcilt_shared_conv2d_staged_f32, float, true)
PCILT_CONV2D_STAGED_ENTRY(pcilt_shared_conv2d_staged_bf16, __nv_bfloat16,
                          true)

// The code pre-pass: xp [B, Hp, Wp, C] float32 -> codes [B, Cs, Hp, Wp]
// of channels c0 .. c0 + Cs - 1.
extern "C" int pcilt_conv2d_codes_f32(const void* x, void* codes, int B,
                                      int Hp, int Wp, int C, int c0, int Cs,
                                      int bits, int zp, float scale,
                                      void* stream) {
  return launch_codes((const float*)x, (uint8_t*)codes, B, Hp, Wp, C, c0, Cs,
                      bits, zp, scale, (cudaStream_t)stream);
}

// The staged design's tiling, for kernels.ops to check its mirror against:
// {pixels a block, columns a block, slice slots, offset slots, slice row
// pitch in bytes, largest V}.
extern "C" int pcilt_conv2d_staged_config(int* cfg) {
  cfg[0] = staged::kPixTile;
  cfg[1] = staged::kColTile;
  cfg[2] = staged::kStages;
  cfg[3] = staged::kOffRing;
  cfg[4] = staged::kRowPitch;
  cfg[5] = staged::kMaxV;
  return 0;
}
