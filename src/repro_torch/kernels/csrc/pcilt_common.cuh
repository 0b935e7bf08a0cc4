// Shared device helpers of the PCILT kernels: the quantizer, dtype
// conversions and the saturation-counter reduction.
//
// The quantizer repeats repro.core.quantization.quantize bit for bit:
// a true division (__fdiv_rn, never a reciprocal multiply), round half to
// even (rintf), + zero_point, clip to [0, 2**bits - 1].  An element is
// saturated iff its pre-clip code leaves that range.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace pcilt {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// One activation -> its code; *sat is set iff the pre-clip code is outside
// [0, kmax].
__device__ __forceinline__ int quantize_code(float x, float scale, int zp,
                                             int kmax, bool* sat) {
  float q = rintf(__fdiv_rn(x, scale)) + (float)zp;
  *sat = (q < 0.f) || (q > (float)kmax);
  q = fminf(fmaxf(q, 0.f), (float)kmax);
  return (int)q;
}

// threadIdx.x and blockIdx.x read anew (an asm volatile, which the compiler
// neither merges with an earlier read nor hoists): a value derived from them
// for a kernel's epilogue is then recomputed there, not kept live from the
// prologue across the kernel's main loop, where ptxas spilled such values to
// local memory (a store at the start, a load at the end).
__device__ __forceinline__ unsigned fresh_tid_x() {
  unsigned v;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(v));
  return v;
}
__device__ __forceinline__ unsigned fresh_ctaid_x() {
  unsigned v;
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(v));
  return v;
}

// Saturation counters of one thread -> the call's global counters:
// stats[0] += count (int32), stats[1] = max(stats[1], ratio) on the int bits
// of the non-negative float ratio (ordered like the floats themselves).
// Every thread of the block must call this (warp shuffles).
__device__ __forceinline__ void commit_stats(int cnt, float ratio,
                                             int* stats) {
  for (int o = 16; o > 0; o >>= 1) {
    cnt += __shfl_down_sync(0xffffffffu, cnt, o);
    ratio = fmaxf(ratio, __shfl_down_sync(0xffffffffu, ratio, o));
  }
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  if ((tid & 31) == 0) {
    if (cnt) atomicAdd(&stats[0], cnt);
    atomicMax(&stats[1], __float_as_int(ratio));
  }
}

// ---------------------------------------------------------------------------
// Row-tiled fetch-and-add of the conv2d and host-packed GEMV kernels.
//
// A block owns R = blockDim.y * kRowsPerThread output rows (pixels) and one
// O tile of blockDim.x columns; thread (tx, ty) owns column col of rows
// ty * kRowsPerThread + k.  Segments run in chunks of kSegChunk: the block
// stages, in shared memory, each segment's table base (element index of
// row 0 of its [V, O] table, -1 = the segment adds nothing) and each row's
// offset (-1 = no fetch), then every thread adds its rows' table cells.  A
// warp shares one (row, segment), so the offset is a shared-memory
// broadcast and the 32 loads of a table row are neighbouring columns.
constexpr int kRowsPerThread = 8;
constexpr int kSegChunk = 128;
constexpr int kBlockThreads = 256;

// Bytes of dynamic shared memory for R rows: bases, offsets, row bases.
__host__ __device__ __forceinline__ size_t fetch_smem_bytes(int rows) {
  return kSegChunk * sizeof(long long) +
         (size_t)rows * kSegChunk * sizeof(int) +
         (size_t)rows * sizeof(long long);
}

template <typename T>
__device__ __forceinline__ void fetch_chunk(const T* __restrict__ tab,
                                            const long long* s_base,
                                            const int* s_off, int gc,
                                            long long O, int col, int row0,
                                            float* acc) {
#pragma unroll 2
  for (int gg = 0; gg < gc; ++gg) {
    const long long base = s_base[gg];
    if (base < 0) continue;
    const T* seg = tab + base + col;
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
      const int off = s_off[(row0 + k) * kSegChunk + gg];
      if (off >= 0) acc[k] += to_f32(seg[(long long)off * O]);
    }
  }
}

// Launch geometry of the row-tiled kernels: O tile = min(128, O rounded up
// to a warp), 256 threads a block.
__host__ __forceinline__ dim3 fetch_block(int O) {
  int to = ((O + 31) / 32) * 32;
  if (to > 128) to = 128;
  int ty = kBlockThreads / to;
  return dim3(to, ty < 1 ? 1 : ty);
}

// ---------------------------------------------------------------------------
// Wide loads of table cells: a lane loads VB raw bytes (the widest that the
// table's alignment allows) and adds the cells they hold to float32 sums.
template <int VB> struct RawOf;
template <> struct RawOf<16> { using type = uint4; };
template <> struct RawOf<8> { using type = uint2; };
template <> struct RawOf<4> { using type = unsigned int; };
template <> struct RawOf<2> { using type = unsigned short; };

__device__ __forceinline__ unsigned word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}
__device__ __forceinline__ unsigned word(const uint2& v, int i) {
  return i == 0 ? v.x : v.y;
}
__device__ __forceinline__ unsigned word(unsigned v, int) { return v; }

// acc[0 .. VB/itemsize) += the table cells in the VB raw bytes v (bf16 is
// the upper half of a float32, so its conversion is a shift).
template <typename T, int VB>
__device__ __forceinline__ void add_raw(float* acc,
                                        const typename RawOf<VB>::type& v) {
  if constexpr (VB == 2) {
    acc[0] += __uint_as_float((unsigned)v << 16);
  } else {
#pragma unroll
    for (int i = 0; i < VB / 4; ++i) {
      const unsigned w = word(v, i);
      if constexpr (sizeof(T) == 4) {
        acc[i] += __uint_as_float(w);
      } else {
        acc[2 * i] += __uint_as_float(w << 16);
        acc[2 * i + 1] += __uint_as_float(w & 0xffff0000u);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The staged fetch of the conv and host-packed GEMV kernels (V <= 256: an
// offset fits a byte).  A block owns kPixTile rows (pixels) and kColTile
// columns: lane l of each of kWarps warps owns column l of kPixPerThread
// rows.  Per segment the block stages, in shared memory, the rows of the
// table slice T_g[:, o0:o0+kColTile] that its rows name, through a ring of
// kStages slots filled by cp.async, and each row's offset byte indexes the
// staged slice: a fetch-add is a byte_perm, a shared-memory load and an add.
// The offsets' source is each kernel's own (pcilt_conv2d.cu packs them from
// a code image, pcilt_gemv.cu reads them from the caller's [M, G] array).
namespace staged {

constexpr int kWarps = 16;
constexpr int kPixPerThread = 64;                     // accumulators a thread
constexpr int kPixTile = kWarps * kPixPerThread;      // rows a block
constexpr int kColTile = 32;                          // columns a block
constexpr int kStages = 4;      // slices in flight: the fetched one + 3 ahead
constexpr int kRowPitch = 256;  // bytes from one slice row to the next
constexpr int kThreads = kWarps * 32;
constexpr int kMaxV = 256;                            // offsets are bytes

// Slices share 256-byte rows: a row holds 256 / (kColTile * item) slots'
// columns side by side, and kMaxV rows make a 64 KB block.  So cell (v, l)
// of slot s lies at byte (s / per) << 16 | v << 8 | (s % per) * 32 * item
// + l * item: one byte_perm of a row's offset byte and a per-lane,
// per-slot word builds the whole address.
__host__ __device__ constexpr int slots_per_row(int item) {
  return kRowPitch / (kColTile * item);
}
constexpr int kBlockBytes = kMaxV * kRowPitch;

// Shared memory of the kStages slices.
__host__ __device__ constexpr size_t slice_bytes(int item) {
  return (size_t)((kStages + slots_per_row(item) - 1) / slots_per_row(item)) *
         kBlockBytes;
}

// Byte offset of ring slot s's row 0, column 0 in the slice area.
__device__ __forceinline__ unsigned slot_offset(int s, int item) {
  const int per = slots_per_row(item);
  return (unsigned)(s / per) << 16 | (unsigned)((s % per) * kColTile * item);
}

template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
                 "l"(src), "n"(N));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The rows of T[:, o0:o0+ncols] (src = its row 0, column o0) that some
// row's offset names (used[v] != 0; used has kMaxV bytes, 0 past V) -> dst
// rows of kRowPitch bytes, VB bytes a copy.  The mask bytes are read
// first, all together, then the copies issued.
template <typename T, int VB>
__device__ __forceinline__ void copy_slice(unsigned char* dst, const T* src,
                                           const uint8_t* used, long long O,
                                           int ncols) {
  constexpr int E = VB / (int)sizeof(T);
  constexpr int kVecs = kColTile / E;      // copies a row
  constexpr int kPass = kThreads / kVecs;  // rows a pass
  constexpr int kRows = kMaxV / kPass;     // passes
  const int c = (threadIdx.x % kVecs) * E;
  if (c >= ncols) return;
  const int r0 = threadIdx.x / kVecs;
  bool use[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) use[i] = used[r0 + i * kPass] != 0;
  dst += c * sizeof(T) + r0 * kRowPitch;
  src += c + r0 * O;
  const long long step = kPass * O;
#pragma unroll
  for (int i = 0; i < kRows; ++i, src += step)
    if (use[i]) cp_async<VB>(dst + i * kPass * kRowPitch, src);
}

// The same, element by element through registers (a bf16 table of odd O:
// no row is 4-byte aligned).
template <typename T>
__device__ __forceinline__ void copy_slice_plain(unsigned char* dst,
                                                 const T* src,
                                                 const uint8_t* used,
                                                 long long O, int ncols) {
  constexpr int V = kMaxV;
  for (int i = threadIdx.x; i < V * kColTile; i += kThreads) {
    const int r = i / kColTile;
    const int c = i - r * kColTile;
    if (c < ncols && used[r])
      reinterpret_cast<T*>(dst + r * kRowPitch)[c] = src[r * O + c];
  }
}

// The used rows of one slice into dst by the widest copy vb (16, 8 or 4
// bytes; 0: element by element) that copy_width allowed.
template <typename T>
__device__ __forceinline__ void copy_slice_vb(unsigned char* dst, const T* src,
                                              const uint8_t* used, long long O,
                                              int ncols, int vb) {
  switch (vb) {
    case 16: copy_slice<T, 16>(dst, src, used, O, ncols); break;
    case 8: copy_slice<T, 8>(dst, src, used, O, ncols); break;
    case 4: copy_slice<T, 4>(dst, src, used, O, ncols); break;
    default: copy_slice_plain<T>(dst, src, used, O, ncols);
  }
}

// Widest copy (16, 8 or 4 bytes; 0: element by element) that every slice
// row allows: the row stride O*item, the table's address and the tile.
__host__ inline int copy_width(const void* tab, int O, int item) {
  const unsigned long long a = (unsigned long long)tab;
  for (int w = 16; w >= 4; w /= 2)
    if ((long long)O * item % w == 0 && a % w == 0 && kColTile * item % w == 0)
      return w;
  return 0;
}

// acc[k] += cell (off[k], lane) of a staged slot, for the warp's
// kPixPerThread rows: off holds their offset bytes (16-byte aligned, read
// as 16-byte broadcasts), at = the slot's offset | the lane's byte (byte 1
// of at is 0 and takes the offset byte).
template <typename T>
__device__ __forceinline__ void fetch_slot(float (&acc)[kPixPerThread],
                                           const unsigned char* s_tab,
                                           const uint8_t* off, unsigned at) {
  const uint4* oc = reinterpret_cast<const uint4*>(off);
#pragma unroll
  for (int i = 0; i < kPixPerThread / 16; ++i) {
    const uint4 w = oc[i];  // 16 rows' offsets, one broadcast
    const unsigned ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        acc[16 * i + 4 * q + b] += to_f32(*reinterpret_cast<const T*>(
            s_tab + __byte_perm(ws[q], at, 0x7604u | (b << 4))));
  }
}

}  // namespace staged

// Dynamic shared memory above the default 48 KB needs an opt-in per kernel.
template <typename Kernel>
__host__ cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace pcilt
