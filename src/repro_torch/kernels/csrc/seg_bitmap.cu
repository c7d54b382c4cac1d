// (segment, predicate bucket) counts, for Hopper (sm_90a).
//
// Replaces repro/kernels/seg_bitmap.py::seg_bitmap (the Pallas kernel
// _kernel, pallas_call in seg_bitmap): out[s, k] = the number of rows with
// seg == s and bucket == k, a (n_seg, 128) float32 plane whose > 0 entries
// are the per-subject predicate bitmaps of CS computation.  The TPU kernel
// is a one-hot matmul on the MXU (segment one-hots transposed times bucket
// one-hots), tile by tile.
//
// Work split: a scatter count.  One thread per row adds 1.0f to
// out[seg * 128 + bucket] with atomicAdd, into an output the wrapper zeroes.
// Rows with seg < 0 are padding, and rows whose segment or bucket lies
// outside the plane match no one-hot column; both count nothing.  Adds of
// 1.0f are exact and independent of order while every count stays below
// 2^24.
//
// What bounds it: bytes.  Each row's (seg, bucket) is read once (8 bytes)
// and the plane written once (512 bytes a segment); rows of one subject are
// contiguous, so atomics of neighbouring threads mostly hit one 512-byte row.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBuckets = 128;

__global__ void seg_bitmap_kernel(const int32_t* __restrict__ seg,
                                  const int32_t* __restrict__ bucket,
                                  float* __restrict__ out, int n, int n_seg) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int s = seg[i], k = bucket[i];
  if (s < 0 || s >= n_seg || k < 0 || k >= kBuckets) return;
  atomicAdd(&out[(long long)s * kBuckets + k], 1.0f);
}

}  // namespace

extern "C" int seg_bitmap(const void* seg, const void* bucket, void* out,
                          int n, int n_seg, void* stream) {
  if (n == 0 || n_seg == 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  seg_bitmap_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)seg, (const int32_t*)bucket, (float*)out, n, n_seg);
  return (int)cudaGetLastError();
}
