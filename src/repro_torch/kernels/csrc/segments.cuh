// Segmented id-list matching, shared by sorted_intersect.cu and
// join_count.cu: K (probe a, sorted build b) list pairs in one launch.
//
// The lists are segments of base arrays already on the card, given by an
// int64 table the wrapper uploads once per launch:
//
//   rows of K entries:  a_off, a_len, b_off, b_len [, out_off]
//   rows of T entries:  tile segment, tile start
//
// A null table is one list pair, a[0, na) against b[0, nb): the tiles then
// follow from the block index and nothing is uploaded.
//
// Work is split into tiles of kTile consecutive probe entries inside one
// segment (the wrapper lists them), one block per tile, so a 158,241-id
// list and a 300-id list share the grid and no block idles behind a long
// list.  A tile's probes need not be sorted.
//
// Each block reduces its tile's smallest and largest key and finds the
// build window [lower_bound(min), upper_bound(max)) of its segment, two
// warps searching at once, each 32 positions a step (about 5 dependent
// loads for a million keys, not 20).  When the window holds at most
// kSmemKeys keys it is staged in shared memory with cp.async and the
// threads binary-search there.  A larger window (unsorted probes spanning
// a long build) is searched in global memory, through L2.  Both branches
// sum the same weights: every build key equal to a key in [min, max] lies
// inside the window.  Weights are read only where a key matches, and sums
// are unsigned 32-bit, so they wrap exactly as the reference's int32 sums
// do, in any order.
#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace segments {

constexpr int kThreads = 256;
constexpr int kPerThread = 2;
constexpr int kTile = kThreads * kPerThread;   // probe entries per tile
constexpr int kWarps = kThreads / 32;
constexpr int kSmemKeys = 8192;                // staged build keys (32 KB)

// The tile a block works on: its segment, its probes (n of them, n >= 1)
// and its segment's build side.
struct Tile {
  int64_t seg;
  int64_t a_off;        // offset of the tile's first probe in the base
  int n;
  int64_t b_off;
  int nb;
  int64_t start;        // the tile's first probe within its segment
};

__device__ __forceinline__ Tile load_tile(const int64_t* __restrict__ table,
                                          int64_t K, int64_t T, int rows,
                                          int64_t na, int64_t nb) {
  const int64_t t = blockIdx.x;
  Tile tl;
  if (table == nullptr) {             // one list pair
    tl.seg = 0;
    tl.start = t * kTile;
    tl.a_off = tl.start;
    tl.b_off = 0;
    tl.nb = (int)nb;
  } else {
    tl.seg = table[rows * K + t];
    tl.start = table[rows * K + T + t];
    tl.a_off = table[tl.seg] + tl.start;
    na = table[K + tl.seg];
    tl.b_off = table[2 * K + tl.seg];
    tl.nb = (int)table[3 * K + tl.seg];
  }
  const int64_t left = na - tl.start;
  tl.n = (int)(left < kTile ? left : kTile);
  return tl;
}

// First j in [0, n) with keys[j] >= v (kUpper: keys[j] > v), n if none.
template <bool kUpper>
__device__ __forceinline__ int search(const int32_t* keys, int n, int32_t v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (kUpper ? keys[mid] <= v : keys[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// search<kUpper>, by all 32 lanes of a warp: each step probes 32 evenly
// spaced keys and keeps the one interval where the answer lies.
template <bool kUpper>
__device__ __forceinline__ int warp_search(const int32_t* __restrict__ keys,
                                           int n, int32_t v) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = n;                 // the answer lies in [lo, hi]
  while (lo < hi) {
    const int64_t step = ((int64_t)(hi - lo) + 31) >> 5;
    const int64_t p = lo + (lane + 1) * step - 1;
    const bool before = p < hi && (kUpper ? keys[p] <= v : keys[p] < v);
    const int c = __popc(__ballot_sync(0xffffffffu, before));
    hi = (int)min((int64_t)hi, lo + (c + 1) * step - 1);
    lo += (int)(c * step);
  }
  return lo;
}

// Sum of w[j] over keys[j] == v, keys sorted ascending.
__device__ __forceinline__ unsigned run_weight(const int32_t* keys, int n,
                                               const int32_t* __restrict__ w,
                                               int32_t v) {
  unsigned s = 0;
  for (int j = search<false>(keys, n, v); j < n && keys[j] == v; ++j)
    s += (unsigned)w[j];
  return s;
}

__device__ __forceinline__ void cp_async4(int32_t* dst, const int32_t* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

// Block-wide: the weighted match count w[e] of each of the thread's probes
// a[threadIdx.x + e * kThreads] (0 past n) against the sorted build b (nb
// keys, weights bw).
__device__ __forceinline__ void match_weights(
    const int32_t* __restrict__ a, int n, const int32_t* __restrict__ b,
    const int32_t* __restrict__ bw, int nb, unsigned (&w)[kPerThread]) {
  __shared__ int32_t s_b[kSmemKeys];
  __shared__ int32_t s_mn[kWarps], s_mx[kWarps];
  __shared__ int s_win[2];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int32_t v[kPerThread];
  int32_t mn = INT_MAX, mx = INT_MIN;
#pragma unroll
  for (int e = 0; e < kPerThread; ++e) {
    const int i = tid + e * kThreads;
    v[e] = i < n ? a[i] : 0;
    if (i < n) {
      mn = min(mn, v[e]);
      mx = max(mx, v[e]);
    }
  }
  mn = __reduce_min_sync(0xffffffffu, mn);
  mx = __reduce_max_sync(0xffffffffu, mx);
  if (lane == 0) {
    s_mn[warp] = mn;
    s_mx[warp] = mx;
  }
  __syncthreads();
  // the two window searches run in two warps at once
  if (warp == 0) {
    const int32_t m = __reduce_min_sync(
        0xffffffffu, lane < kWarps ? s_mn[lane] : INT_MAX);
    const int j = warp_search<false>(b, nb, m);
    if (lane == 0) s_win[0] = j;
  } else if (warp == 1) {
    const int32_t m = __reduce_max_sync(
        0xffffffffu, lane < kWarps ? s_mx[lane] : INT_MIN);
    const int j = warp_search<true>(b, nb, m);
    if (lane == 0) s_win[1] = j;
  }
  __syncthreads();
  const int lo = s_win[0];
  const int wn = s_win[1] - lo;
  const int32_t* wb = b + lo;
  const int32_t* ww = bw + lo;
  if (wn <= kSmemKeys) {            // block-uniform: staged in shared memory
    for (int j = tid; j < wn; j += kThreads) cp_async4(s_b + j, wb + j);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
#pragma unroll
    for (int e = 0; e < kPerThread; ++e)
      w[e] = tid + e * kThreads < n ? run_weight(s_b, wn, ww, v[e]) : 0u;
  } else {                          // searched in global memory
#pragma unroll
    for (int e = 0; e < kPerThread; ++e)
      w[e] = tid + e * kThreads < n ? run_weight(wb, wn, ww, v[e]) : 0u;
  }
}

// The launch of a segmented kernel: a grid of T tiles, or of ceil(na /
// kTile) tiles of one list pair when the table is null.  Returns a
// cudaError_t.
template <typename Kernel, typename... Args>
int launch(Kernel kern, const void* table, int64_t K, int64_t T, int64_t na,
           int64_t nb, void* stream, Args... args) {
  if (table == nullptr) {
    if (K != 1 || na < 0 || nb < 0 || na > INT_MAX || nb > INT_MAX)
      return (int)cudaErrorInvalidValue;
    T = (na + kTile - 1) / kTile;
  }
  if (K < 0 || T < 0 || T > INT_MAX) return (int)cudaErrorInvalidValue;
  if (T == 0) return 0;
  kern<<<(unsigned)T, kThreads, 0, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace segments
