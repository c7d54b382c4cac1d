// Weighted intersection counts of K id-list pairs in one launch, for Hopper
// (sm_90a).
//
// Replaces repro/kernels/sorted_intersect.py::sorted_intersect_weighted (the
// Pallas kernel _kernel, pallas_call in sorted_intersect_weighted): the int32
// sum over all pairs (i, j) with a[i] == b[j] of aw[i] * bw[j], Algorithm 1's
// inner intersection, here for every segment k of a launch at once
// (out[k]).  The TPU kernel tests every (256 x 256) tile of pairs of one list
// pair for equality and carries the sum through its sequential grid,
// O(NA * NB), one call per list pair.
//
// Work split (segments.cuh): one block per tile of 512 probes of one
// segment; each probe's weighted match count comes from a binary search of
// its segment's build window, staged in shared memory when it fits; times
// aw[i] that is probe i's share of the all-pairs sum, duplicates on either
// side included (a need not be sorted).  A warp-shuffle block sum is followed
// by one integer atomicAdd per tile into its segment's slot, which the
// wrapper zeroes.  Sums are unsigned 32-bit: they wrap as the reference's
// int32 sum does, in any order.
//
// What bounds it: the probes, not the distinct bytes.  Each probe key is
// read once per segment it lies in, a weight only where its key matches.
// The checks of one source pair share their lists (an objects row against
// many subject CSs), so a launch searches far more probes than the batch
// holds distinct keys.  One launch per source pair instead of one per list
// pair removes the per-launch floor and the host round trip that dominated.

#include "segments.cuh"

namespace {

using namespace segments;

__global__ void __launch_bounds__(kThreads)
sorted_intersect_kernel(const int32_t* __restrict__ a,
                        const int32_t* __restrict__ aw,
                        const int32_t* __restrict__ b,
                        const int32_t* __restrict__ bw,
                        const int64_t* __restrict__ table, int64_t K,
                        int64_t T, int64_t na, int64_t nb,
                        unsigned* __restrict__ out) {
  __shared__ unsigned warp_sum[kWarps];
  const Tile tl = load_tile(table, K, T, 4, na, nb);
  unsigned w[kPerThread];
  match_weights(a + tl.a_off, tl.n, b + tl.b_off, bw + tl.b_off, tl.nb, w);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  unsigned acc = 0;
#pragma unroll
  for (int e = 0; e < kPerThread; ++e)
    if (w[e] != 0u) acc += w[e] * (unsigned)aw[tl.a_off + tid + e * kThreads];
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (lane == 0) warp_sum[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = lane < kWarps ? warp_sum[lane] : 0u;
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (lane == 0 && acc != 0u) atomicAdd(out + tl.seg, acc);
  }
}

}  // namespace

// table: int64 rows a_off, a_len, b_off, b_len (K each), then the tiles'
// segment and start (T each); or null for the one list pair a[0, na)
// against b[0, nb) (K = 1; T follows).  Returns a cudaError_t.
extern "C" int sorted_intersect(const void* a, const void* aw, const void* b,
                                const void* bw, const void* table, int64_t K,
                                int64_t T, int64_t na, int64_t nb, void* out,
                                void* stream) {
  return segments::launch(sorted_intersect_kernel, table, K, T, na, nb,
                          stream, (const int32_t*)a, (const int32_t*)aw,
                          (const int32_t*)b, (const int32_t*)bw,
                          (const int64_t*)table, K, T, na, nb,
                          (unsigned*)out);
}
