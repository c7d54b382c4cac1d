// Per-probe weighted match counts of K (probe, sorted build) list pairs in
// one launch, for Hopper (sm_90a).
//
// Replaces repro/kernels/join_count.py::join_count (the Pallas kernel
// _kernel, pallas_call in join_count): out[i] = the int32 sum of build_w[j]
// over all j with build[j] == probe[i], here for every segment of a launch
// at once, the segments' outputs concatenated (segment k's first probe at
// out_off[k]).  The TPU kernel tests every (256 x 256) tile of (probe, build)
// pairs of one list pair for equality, O(NP * NB), one call per list pair.
//
// Work split (segments.cuh): one block per tile of 512 probes of one
// segment; each probe binary-searches its segment's build window, staged in
// shared memory when it fits, and walks its run of equal keys, summing
// build_w[j] (duplicate build keys included).  The sum is unsigned 32-bit,
// so it wraps as the reference's int32 sum does.
//
// What bounds it: the probes.  Each is read and its count written once
// per segment it lies in (8 bytes a probe), a build weight read only where
// its key is probed.  One launch per source pair instead of one per list
// pair removes Algorithm 1's per-launch floors.

#include "segments.cuh"

namespace {

using namespace segments;

__global__ void __launch_bounds__(kThreads)
join_count_kernel(const int32_t* __restrict__ probe,
                  const int32_t* __restrict__ build,
                  const int32_t* __restrict__ build_w,
                  const int64_t* __restrict__ table, int64_t K, int64_t T,
                  int64_t na, int64_t nb, int32_t* __restrict__ out) {
  const Tile tl = load_tile(table, K, T, 5, na, nb);
  unsigned w[kPerThread];
  match_weights(probe + tl.a_off, tl.n, build + tl.b_off, build_w + tl.b_off,
                tl.nb, w);
  int32_t* o = out + (table ? table[4 * K + tl.seg] : 0) + tl.start;
#pragma unroll
  for (int e = 0; e < kPerThread; ++e) {
    const int i = threadIdx.x + e * kThreads;
    if (i < tl.n) o[i] = (int32_t)w[e];
  }
}

}  // namespace

// table: int64 rows a_off, a_len, b_off, b_len, out_off (K each), then the
// tiles' segment and start (T each); or null for the one list pair
// probe[0, na) against build[0, nb) (K = 1; T follows).  Returns a
// cudaError_t.
extern "C" int join_count(const void* probe, const void* build,
                          const void* build_w, const void* table, int64_t K,
                          int64_t T, int64_t na, int64_t nb, void* out,
                          void* stream) {
  return segments::launch(join_count_kernel, table, K, T, na, nb, stream,
                          (const int32_t*)probe, (const int32_t*)build,
                          (const int32_t*)build_w, (const int64_t*)table, K, T,
                          na, nb, (int32_t*)out);
}
