// Fused PCILT depthwise conv1d:
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

}  // namespace

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
