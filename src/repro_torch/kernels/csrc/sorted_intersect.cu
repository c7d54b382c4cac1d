// Weighted intersection count of two id lists, for Hopper (sm_90a).
//
// Replaces repro/kernels/sorted_intersect.py::sorted_intersect_weighted (the
// Pallas kernel _kernel, pallas_call in sorted_intersect_weighted): the int32
// sum over all pairs (i, j) with a[i] == b[j] of aw[i] * bw[j], Algorithm 1's
// inner intersection.  The TPU kernel tests every (256 x 256) tile of pairs
// for equality and carries the sum through its sequential grid, O(NA * NB).
//
// Work split: one thread per a[i] binary-searches the lower bound of a[i] in
// the sorted b and walks forward while b[j] == a[i], summing bw[j]; times
// aw[i] that is row i's share of the all-pairs sum, duplicates in b included
// (a need not be sorted).  A warp-shuffle block sum is followed by one
// integer atomicAdd per block into a scalar the wrapper zeroes.  Sums are
// taken in unsigned 32-bit arithmetic, so they wrap exactly as the
// reference's int32 sum does, in any order.
//
// What bounds it: bytes.  a and aw are read once (8 bytes an entry); each
// search makes about log2(NB) reads of b, which stays in the 50 MB L2 at
// Algorithm 1's list lengths.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int lower_bound(const int32_t* __restrict__ b,
                                           int nb, int32_t v) {
  int lo = 0, hi = nb;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (b[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void sorted_intersect_kernel(const int32_t* __restrict__ a,
                                        const int32_t* __restrict__ aw,
                                        const int32_t* __restrict__ b,
                                        const int32_t* __restrict__ bw,
                                        unsigned int* __restrict__ out,
                                        int na, int nb) {
  __shared__ unsigned int warp_sum[kThreads / 32];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  unsigned int acc = 0;
  if (i < na) {
    const int32_t v = a[i];
    unsigned int w = 0;
    for (int j = lower_bound(b, nb, v); j < nb && b[j] == v; ++j)
      w += (unsigned int)bw[j];
    acc = w * (unsigned int)aw[i];
  }
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sum[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = lane < kThreads / 32 ? warp_sum[lane] : 0u;
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (lane == 0 && acc != 0u) atomicAdd(out, acc);
  }
}

}  // namespace

extern "C" int sorted_intersect(const void* a, const void* aw, const void* b,
                                const void* bw, void* out, int na, int nb,
                                void* stream) {
  if (na == 0 || nb == 0) return 0;
  const int blocks = (na + kThreads - 1) / kThreads;
  sorted_intersect_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)a, (const int32_t*)aw, (const int32_t*)b,
      (const int32_t*)bw, (unsigned int*)out, na, nb);
  return (int)cudaGetLastError();
}
