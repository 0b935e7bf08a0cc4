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
// Host-packed: out[b, t, c] = T[c, offsets[b, t, c]] over offsets [B, T, C]
// int32 that the caller quantized and packed; an offset outside [0, V) adds
// nothing (the reference's masked sum over the V entries matches none), so
// its output is 0.  Replaces src/repro/kernels/pcilt_dwconv1d.py
// pcilt_dwconv1d_pallas.  Bound: bytes (the offsets read once, one fetch
// and one write per output).  Design: one thread per output, neighbouring
// threads on neighbouring channels, so the offset load and the output
// store are coalesced; the fetch is read as float32 and cast back once
// (exact for either table dtype).
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

template <typename T>
int launch_host(const int* offsets, const T* tab, T* out, long long total,
                int C, int V, cudaStream_t stream) {
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  dwconv1d_host_kernel<T><<<blocks, threads, 0, stream>>>(offsets, tab, out,
                                                          total, C, V);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int pcilt_dwconv1d_host_f32(const void* offsets, const void* tab,
                                       void* out, long long total, int C,
                                       int V, void* stream) {
  return launch_host<float>((const int*)offsets, (const float*)tab,
                            (float*)out, total, C, V, (cudaStream_t)stream);
}

extern "C" int pcilt_dwconv1d_host_bf16(const void* offsets, const void* tab,
                                        void* out, long long total, int C,
                                        int V, void* stream) {
  return launch_host<__nv_bfloat16>((const int*)offsets,
                                    (const __nv_bfloat16*)tab,
                                    (__nv_bfloat16*)out, total, C, V,
                                    (cudaStream_t)stream);
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
