// Per-probe weighted match counts against a sorted build side, for Hopper
// (sm_90a).
//
// Replaces repro/kernels/join_count.py::join_count (the Pallas kernel
// _kernel, pallas_call in join_count): out[i] = the int32 sum of build_w[j]
// over all j with build[j] == probe[i].  The TPU kernel tests every
// (256 x 256) tile of (probe, build) pairs for equality, O(NP * NB).
//
// Work split: one thread per probe binary-searches the lower bound of
// probe[i] in the sorted build and walks forward while the key is equal,
// summing build_w[j].  That equals the all-pairs sum for any sorted build,
// duplicate keys included.  The sum is unsigned 32-bit, so it wraps as the
// reference's int32 sum does.
//
// What bounds it: bytes.  The probe is read once and the output written once
// (8 bytes a probe); each search makes about log2(NB) reads of a build that
// stays in the 50 MB L2 at Algorithm 1's list lengths.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void join_count_kernel(const int32_t* __restrict__ probe,
                                  const int32_t* __restrict__ build,
                                  const int32_t* __restrict__ build_w,
                                  int32_t* __restrict__ out, int np, int nb) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= np) return;
  const int32_t v = probe[i];
  int lo = 0, hi = nb;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (build[mid] < v) lo = mid + 1; else hi = mid;
  }
  unsigned int w = 0;
  for (int j = lo; j < nb && build[j] == v; ++j) w += (unsigned int)build_w[j];
  out[i] = (int32_t)w;
}

}  // namespace

extern "C" int join_count(const void* probe, const void* build,
                          const void* build_w, void* out, int np, int nb,
                          void* stream) {
  if (np == 0) return 0;
  const int blocks = (np + kThreads - 1) / kThreads;
  join_count_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)probe, (const int32_t*)build, (const int32_t*)build_w,
      (int32_t*)out, np, nb);
  return (int)cudaGetLastError();
}
