// Mamba-1 selective scan, for Hopper (sm_90a).
//
// Replaces repro/kernels/ssm_scan.py::ssm_scan (the Pallas kernel _kernel,
// pallas_call in ssm_scan):
//   h_t = exp(dt_t * A) * h_{t-1} + dt_t * x_t * B_t,   y_t = C_t . h_t
// per batch row b and channel d, with h (N,) starting at zero.  dt, x:
// (B, S, D); bt, ct: (B, S, N); a: (D, N); y: (B, S, D); all float32.  It
// also writes the final state h_S as h_last (B, D, N): the serving prefill
// seeds the decode cache with it, where the TPU kernel leaves its carry in
// VMEM scratch.
//
// Work split: the TPU walks the sequence as a sequential grid axis of
// 64-step chunks with the carry in VMEM; here a loop over the whole
// sequence inside the thread takes its place, and the carry lives in a
// register.  One thread per (b, d, n): a group of G = 16 (N <= 16) or 32
// (N <= 32) lanes holds one channel's state, and y_t is a G-lane shuffle
// sum.  At falcon-mamba's prefill (B * D = 8192 channels, N = 16) that is
// 1,024 blocks of 128 threads, against 64 blocks had one thread carried a
// whole channel.  Any S and D are taken; the reference's divisibility
// asserts have no counterpart.
//
// What bounds it: bytes.  dt, x and y are read or written once (12 bytes per
// (b, t, d)); bt and ct are shared by all channels of a row and come from
// cache.  The per-step work is one exp and a few multiply-adds per state
// lane.  The loads do not depend on the carry, so the unrolled loop keeps
// several steps' loads in flight ahead of the dependent chain.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

template <int G>
__global__ void __launch_bounds__(kThreads)
ssm_scan_kernel(const float* __restrict__ dt, const float* __restrict__ bt,
                const float* __restrict__ ct, const float* __restrict__ x,
                const float* __restrict__ a, float* __restrict__ y,
                float* __restrict__ h_last, int B, int S, int D, int N) {
  const int chan = blockIdx.x * (kThreads / G) + threadIdx.x / G;
  const int n = threadIdx.x % G;
  // whole groups fall off the end together, and every lane stays for the
  // shuffles
  const bool live = chan < B * D;
  const bool on = live && n < N;
  const int b = live ? chan / D : 0, d = live ? chan % D : 0;
  const float av = on ? a[(size_t)d * N + n] : 0.f;
  const float* dtp = dt + (size_t)b * S * D + d;
  const float* xp = x + (size_t)b * S * D + d;
  const float* bp = bt + (size_t)b * S * N + n;
  const float* cp = ct + (size_t)b * S * N + n;
  float* yp = y + (size_t)b * S * D + d;
  float h = 0.f;
#pragma unroll 8
  for (int t = 0; t < S; ++t) {
    const float dtv = live ? dtp[(size_t)t * D] : 0.f;
    const float xv = live ? xp[(size_t)t * D] : 0.f;
    const float bv = on ? bp[(size_t)t * N] : 0.f;
    const float cv = on ? cp[(size_t)t * N] : 0.f;
    h = fmaf(h, expf(dtv * av), (dtv * xv) * bv);
    float part = h * cv;
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    if (live && n == 0) yp[(size_t)t * D] = part;
  }
  if (on) h_last[((size_t)b * D + d) * N + n] = h;
}

}  // namespace

// Returns a cudaError_t.
extern "C" int ssm_scan(const void* dt, const void* bt, const void* ct,
                        const void* x, const void* a, void* y, void* h_last,
                        int B, int S, int D, int N, void* stream) {
  if (B == 0 || D == 0 || N == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const long long chans = (long long)B * D;
  if (N <= 16) {
    const int blocks = (int)((chans + kThreads / 16 - 1) / (kThreads / 16));
    ssm_scan_kernel<16><<<blocks, kThreads, 0, st>>>(
        (const float*)dt, (const float*)bt, (const float*)ct, (const float*)x,
        (const float*)a, (float*)y, (float*)h_last, B, S, D, N);
  } else if (N <= 32) {
    const int blocks = (int)((chans + kThreads / 32 - 1) / (kThreads / 32));
    ssm_scan_kernel<32><<<blocks, kThreads, 0, st>>>(
        (const float*)dt, (const float*)bt, (const float*)ct, (const float*)x,
        (const float*)a, (float*)y, (float*)h_last, B, S, D, N);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
