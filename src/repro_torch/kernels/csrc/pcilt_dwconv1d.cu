// PCILT depthwise conv1d, fused and host-packed.
//
// Fused:
//   out[b, t, c] = T[c, sum_j code(x[b, t + j, c]) << (j * bits)]
// over a time-padded signal x [B, Tp, C] (To = Tp - k + 1 outputs), one
// table fetch per output, so the result is the table entry bit for bit.
//
// Replaces: src/repro/kernels/pcilt_dwconv1d.py pcilt_fused_dwconv1d_pallas
// (and its counter body _fused_sat_kernel).
//
// Bound: bytes.  Each output is one scattered fetch from a [C, V] table of
// V = 2**(bits*k) entries per channel (65536 at 4 bits x 4 taps), so the
// least traffic is one 32-byte sector per fetch plus the signal read once
// and the output written once; there is no arithmetic to speak of.
//
// Design: one thread per output (b, t, c); neighbouring threads take
// neighbouring channels, so the k tap loads are coalesced.  The thread
// quantizes its k taps, packs them little-endian and makes its one fetch.
// Counter variant: each padded row is counted once — tap j of output t is
// row t + j, counted by the thread with j == 0, and the last k - 1 rows by
// the thread of the last output (t == To - 1).  Pads are zeros, which
// quantize in range, so the count equals the count over the raw signal.
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
#include "pcilt_common.cuh"

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
int launch(const float* x, const T* tab, T* out, int* stats, int B, int Tp,
           int C, int V, int k, int bits, int zp, float scale, int counters,
           cudaStream_t stream) {
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

extern "C" int pcilt_dwconv1d_f32(const void* x, const void* tables,
                                  void* out, void* stats, int B, int Tp,
                                  int C, int V, int k, int bits, int zp,
                                  float scale, int counters, void* stream) {
  return launch<float>((const float*)x, (const float*)tables, (float*)out,
                       (int*)stats, B, Tp, C, V, k, bits, zp, scale, counters,
                       (cudaStream_t)stream);
}

extern "C" int pcilt_dwconv1d_bf16(const void* x, const void* tables,
                                   void* out, void* stats, int B, int Tp,
                                   int C, int V, int k, int bits, int zp,
                                   float scale, int counters, void* stream) {
  return launch<__nv_bfloat16>((const float*)x, (const __nv_bfloat16*)tables,
                               (__nv_bfloat16*)out, (int*)stats, B, Tp, C, V,
                               k, bits, zp, scale, counters,
                               (cudaStream_t)stream);
}
