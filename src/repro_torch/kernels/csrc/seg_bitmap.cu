// (segment, predicate bucket) counts, for Hopper (sm_90a).
//
// Replaces repro/kernels/seg_bitmap.py::seg_bitmap (the Pallas kernel
// _kernel, pallas_call in seg_bitmap): out[s, k] = the number of rows with
// seg == s and bucket == k, a (n_seg, 128) float32 plane whose > 0 entries
// are the per-subject predicate bitmaps of CS computation.  The TPU kernel
// is a one-hot matmul on the MXU (segment one-hots transposed times bucket
// one-hots), tile by tile.
//
// Contract: total.  Rows with seg < 0 are padding, and rows whose segment
// or bucket lies outside the plane match no one-hot column; both count
// nothing and may sit anywhere.  Any row order gives the same counts.  The
// rows are *ordered* when seg does not decrease over the rows with
// 0 <= seg < n_seg; the statistics path's rows are (a table sorted by
// (s, p, o), its repeated (s, p) rows padding in between).
//
// Work split: one persistent cooperative launch, grid = SMs x resident
// blocks per SM (at most kMaxBlocksPerSm); a block walks tiles of kTile
// rows (4 a thread, 16-byte loads where the arrays are aligned), the next
// tile's rows loaded while it works on the current one.
//   Walk 1 counts every tile as if the rows were ordered, and checks that
//     they are: a tile's in-plane segments must not decrease, starting
//     from prev, the last in-plane segment before the tile (from the 32
//     rows before it, or a scan further back where those are all
//     padding).  A tile out of order marks its block's word and stops the
//     block's walk.  A tile owns the segments above prev and writes the
//     output rows from the first of them up to the next present segment
//     after its last (from row 0 when prev is none): the present ones with
//     their counts, the missing ids between as zero rows.  It counts its
//     rows into a window of kWindow output rows of integer counts in
//     shared memory with shared atomics, while warp 0 reads on past the
//     tile for the rest of its last segment (kAhead rows already fetched,
//     then memory); then the block writes the window's rows once, 16 bytes
//     a thread, as one contiguous stream of streaming stores, zeroing the
//     window behind it.  A tile whose rows span more than kWideRows ids is
//     left to walk 2, so that rows out of order cost at most kWideRows
//     rows of writes a tile.
//   Grid barrier; every block reads every block's word.  Ordered rows with
//     some in the plane: walk 2 writes the wide tiles, and the plane holds
//     each row written once, with no memset and no global atomics (the
//     wrapper allocates it with torch.empty).
//   Otherwise (rows out of order, or none in the plane): the kernel zeroes
//     the plane with grid-stride stores over what walk 1 wrote, passes a
//     grid barrier, and adds 1.0f per row with a global atomicAdd.  Adds of
//     1.0f are exact and independent of order while every count stays
//     below 2^24; the ordered path converts exact integer counts.
//   The verdict word in `scratch` says which path ran.
//
// What bounds it: bytes.  The ordered path reads each row's (seg, bucket)
// once and writes the plane once: at 3.6 M rows and 400,000 segments the
// 204.8 MB plane is nearly all of it, beside the launch and one grid
// barrier.  The unordered path adds the plane's zeroing, a
// read-modify-write of each touched 32-byte sector, and walk 1 up to each
// block's first tile out of order.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = kThreads * 4;         // rows of a block's tile, 4 a thread
constexpr int kAhead = 32;                  // rows fetched past a tile's end
constexpr int kWindow = 128;                // output rows counted at once
constexpr int kBuckets = 128;
constexpr int kMaxBlocksPerSm = 4;          // kernels/seg_bitmap.py

// a block's word: its tiles met rows out of order / rows in the plane / a
// tile whose output rows span more than kWideRows ids
constexpr int kBad = 1, kRows = 2, kWide = 4;
constexpr int kWideRows = 4 * kTile;
constexpr int kEmpty = -1;                  // no in-plane row before a tile

struct Smem {                    // dynamic: above the 48 KB of a static array
  int count[kWindow * kBuckets]; // the window's counts, zero between uses
  int tail[kBuckets];            // the tile's last segment past the tile
  int first[kWarps], hi[kWarps], lo[kWarps], last[kWarps], bad[kWarps];
  int following;                 // the first segment id the tile does not own
  int prev;
};

__device__ __forceinline__ bool in_plane(int s, int n_seg) {
  return s >= 0 && s < n_seg;
}

__device__ __forceinline__ bool in_bucket(int b) {
  return b >= 0 && b < kBuckets;
}

__device__ __forceinline__ int row(const int32_t* __restrict__ p, long long i,
                                   long long n) {
  return i >= 0 && i < n ? __ldg(p + i) : -1;
}

// Rows i .. i + 3 (-1 outside [0, n)): one 16-byte load when aligned.
__device__ __forceinline__ int4 load4(const int32_t* __restrict__ p,
                                      long long i, long long n, bool vec) {
  if (vec && i >= 0 && i + 3 < n)
    return __ldg(reinterpret_cast<const int4*>(p + i));
  return make_int4(row(p, i, n), row(p, i + 1, n), row(p, i + 2, n),
                   row(p, i + 3, n));
}

__device__ __forceinline__ int warp_excl_max(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v = max(v, o);
  }
  const int ex = __shfl_up_sync(0xffffffffu, v, 1);
  return lane == 0 ? INT_MIN : ex;
}

// The last in-plane segment among rows [0, end), kEmpty if none: warp 0
// reads back 128 rows a step (only where the 32 rows before a tile hold
// none).  Called by the whole block.
__device__ int scan_back(Smem& sm, const int32_t* __restrict__ seg,
                         long long end, long long n, int n_seg, bool vec,
                         int warp, int lane) {
  if (warp == 0) {
    int found = kEmpty;
    for (long long e = end; e > 0; e -= 128) {
      const int4 x = load4(seg, e - 128 + 4 * lane, n, vec);
      const int v = in_plane(x.w, n_seg)   ? x.w
                    : in_plane(x.z, n_seg) ? x.z
                    : in_plane(x.y, n_seg) ? x.y
                    : in_plane(x.x, n_seg) ? x.x
                                           : kEmpty;
      const unsigned m = __ballot_sync(0xffffffffu, v != kEmpty);
      if (m) {
        found = __shfl_sync(0xffffffffu, v, 31 - __clz(m));
        break;
      }
    }
    if (lane == 0) sm.prev = found;
  }
  __syncthreads();
  return sm.prev;
}

// Walk the block's tiles, counting each as if the rows were ordered.
// Returns the block's word: kBad when a tile's rows are out of order (the
// walk stops there), kRows when a tile holds an in-plane row, kWide when a
// tile's output rows span more than kWideRows ids.  The first walk
// (`deferred` false) writes the tiles that are not wide; the second
// (`deferred` true, after the verdict) writes only the wide ones.
__device__ int walk_tiles(Smem& sm, const int32_t* __restrict__ seg,
                          const int32_t* __restrict__ bucket,
                          float* __restrict__ out, long long n, int n_seg,
                          bool vec, bool deferred) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tiles = (int)((n + kTile - 1) / kTile);
  int word = 0;
  int4 ns = make_int4(-1, -1, -1, -1), nb = ns;   // the next tile's rows,
  int nbehind = -1, nas = -1, nab = -1;           // the 32 before, 32 after
  auto fetch = [&](int t) {
    const long long i = (long long)t * kTile;
    ns = load4(seg, i + 4 * tid, n, vec);
    nb = load4(bucket, i + 4 * tid, n, vec);
    nbehind = row(seg, i - 32 + lane, n);
    nas = warp == 0 ? row(seg, i + kTile + lane, n) : -1;
    nab = warp == 0 ? row(bucket, i + kTile + lane, n) : -1;
  };
  if (blockIdx.x < tiles) fetch(blockIdx.x);
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int v[4] = {ns.x, ns.y, ns.z, ns.w}, b[4] = {nb.x, nb.y, nb.z, nb.w};
    const int behind = nbehind;
    int as = nas, ab = nab;
    if (t + (int)gridDim.x < tiles) fetch(t + gridDim.x);
    const long long t0 = (long long)t * kTile;
    // the last in-plane segment before the tile: every warp reads the same
    // 32 rows, so the rare scan further back is a block-wide branch
    const unsigned seen = __ballot_sync(0xffffffffu, in_plane(behind, n_seg));
    int prev = seen ? __shfl_sync(0xffffffffu, behind, 31 - __clz(seen)) : kEmpty;
    if (!seen && t0 > 32)
      prev = scan_back(sm, seg, t0 - 32, n, n_seg, vec, warp, lane);
    // order inside the thread, the warp and (below) the tile; the segments
    // the tile owns are those above prev
    int first = INT_MAX, run = INT_MIN, lo = INT_MAX, last = INT_MIN;
    bool ok = true;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (!in_plane(v[k], n_seg)) continue;
      ok &= v[k] >= run;
      run = max(run, v[k]);
      first = min(first, v[k]);
      if (v[k] > prev) {
        lo = min(lo, v[k]);
        last = max(last, v[k]);
      }
    }
    const int before = warp_excl_max(run, lane);   // every lane shuffles
    ok &= first == INT_MAX || first >= before;
    const bool bad_w = __any_sync(0xffffffffu, !ok);
    first = __reduce_min_sync(0xffffffffu, first);
    run = __reduce_max_sync(0xffffffffu, run);
    lo = __reduce_min_sync(0xffffffffu, lo);
    last = __reduce_max_sync(0xffffffffu, last);
    if (lane == 0) {
      sm.first[warp] = first;
      sm.hi[warp] = run;
      sm.lo[warp] = lo;
      sm.last[warp] = last;
      sm.bad[warp] = bad_w;
    }
    __syncthreads();
    bool bad = false;
    int top = prev;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      bad |= sm.bad[w] || (sm.first[w] != INT_MAX && sm.first[w] < top);
      top = max(top, sm.hi[w]);
      lo = min(lo, sm.lo[w]);
      last = max(last, sm.last[w]);
    }
    __syncthreads();                   // sm.first .. sm.bad read by all
    if (bad) {                         // the input is out of order: stop
      word |= kBad;
      break;
    }
    if (top >= 0) word |= kRows;
    if (lo == INT_MAX) continue;       // the tile opens no segment
    if (warp == 0) {
      // the last segment's rows past the tile, until another segment
      int following = n_seg;
      for (long long g0 = t0 + kTile + kAhead;; g0 += 32) {
        const unsigned stop =
            __ballot_sync(0xffffffffu, in_plane(as, n_seg) && as != last);
        const int lim = stop ? __ffs(stop) - 1 : 32;
        if (lane < lim && as == last && in_bucket(ab))
          atomicAdd(&sm.tail[ab], 1);
        if (stop) {
          following = __shfl_sync(0xffffffffu, as, lim);
          break;
        }
        if (g0 >= n) break;
        as = row(seg, g0 + lane, n);
        ab = row(bucket, g0 + lane, n);
      }
      if (lane == 0) sm.following = following;
    }
    __syncthreads();
    // the output rows from the first owned segment up to the next present
    // one after the last; from 0 when the tile holds the first present row
    const int from = prev == kEmpty ? 0 : lo;
    const int following = sm.following;
    const bool wide = (long long)following - from > kWideRows;
    if (wide) word |= kWide;
    if (wide != deferred) {            // not this walk's: drop the tail
      if (warp == 0) reinterpret_cast<int4*>(sm.tail)[lane] = make_int4(0, 0, 0, 0);
      __syncthreads();
      continue;
    }
    for (int p = from; p < following; p += kWindow) {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (in_plane(v[k], n_seg) && v[k] > prev && v[k] >= p &&
            v[k] < p + kWindow && in_bucket(b[k]))
          atomicAdd(&sm.count[(v[k] - p) * kBuckets + b[k]], 1);
      __syncthreads();
      const int rows = min(following, p + kWindow) - p;
      for (int i = tid; i < rows * (kBuckets / 4); i += kThreads) {
        const int r = i / (kBuckets / 4), q = i % (kBuckets / 4);
        int4 c = reinterpret_cast<int4*>(sm.count)[i];
        reinterpret_cast<int4*>(sm.count)[i] = make_int4(0, 0, 0, 0);
        if (p + r == last) {
          const int4 e = reinterpret_cast<int4*>(sm.tail)[q];
          reinterpret_cast<int4*>(sm.tail)[q] = make_int4(0, 0, 0, 0);
          c = make_int4(c.x + e.x, c.y + e.y, c.z + e.z, c.w + e.w);
        }
        // streaming store: the plane is written once and not read back
        __stcs(reinterpret_cast<float4*>(out + (size_t)(p + r) * kBuckets) + q,
               make_float4((float)c.x, (float)c.y, (float)c.z, (float)c.w));
      }
      __syncthreads();
    }
  }
  return word;
}

__global__ void __launch_bounds__(kThreads)
seg_bitmap_kernel(const int32_t* __restrict__ seg,
                  const int32_t* __restrict__ bucket, float* __restrict__ out,
                  int* __restrict__ scratch, int n_rows, int n_seg) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ int4 dyn[];
  Smem& sm = *reinterpret_cast<Smem*>(dyn);
  const long long n = n_rows;
  const int tid = threadIdx.x;
  const bool vec = (((uintptr_t)seg | (uintptr_t)bucket) & 15) == 0;
  int* verdict = scratch;              // 1: the ordered walk's plane stands
  int* words = scratch + 1;            // one word a block

  for (int i = tid; i < kWindow * kBuckets / 4; i += kThreads)
    reinterpret_cast<int4*>(sm.count)[i] = make_int4(0, 0, 0, 0);
  if (tid < kBuckets) sm.tail[tid] = 0;
  __syncthreads();
  // ---- walk 1: every tile counted as if the rows were ordered
  const int word = walk_tiles(sm, seg, bucket, out, n, n_seg, vec, false);
  if (tid == 0) words[blockIdx.x] = word;
  grid.sync();
  // ---- the verdict, from every block's word
  int any = 0;
  for (int k = tid; k < gridDim.x; k += kThreads) any |= __ldcg(words + k);
  const bool bad = __syncthreads_or(any & kBad);
  const bool rows = __syncthreads_or(any & kRows);
  if (blockIdx.x == 0 && tid == 0) *verdict = !bad && rows;
  if (!bad && rows) {
    // ---- walk 2: the wide tiles, now that the rows are known ordered
    if (word & kWide) walk_tiles(sm, seg, bucket, out, n, n_seg, vec, true);
    return;
  }

  // ---- rows out of order (or none in the plane): zero the plane, then
  // one atomicAdd of 1.0f per row
  const long long me = (long long)blockIdx.x * kThreads + tid;
  const long long stride = (long long)gridDim.x * kThreads;
  float4* o4 = reinterpret_cast<float4*>(out);
  for (long long i = me; i < (long long)n_seg * (kBuckets / 4); i += stride)
    __stcs(o4 + i, make_float4(0.f, 0.f, 0.f, 0.f));
  grid.sync();
  for (long long i = 4 * me; i < n; i += 4 * stride) {
    const int4 s4 = load4(seg, i, n, vec), b4 = load4(bucket, i, n, vec);
    const int s[4] = {s4.x, s4.y, s4.z, s4.w}, b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (in_plane(s[k], n_seg) && in_bucket(b[k]))
        atomicAdd(&out[(size_t)s[k] * kBuckets + b[k]], 1.0f);
  }
}

}  // namespace

// One cooperative launch on `stream`: `sms` (the device's
// cudaDevAttrMultiProcessorCount) times the kernel's resident blocks per
// SM, at most kMaxBlocksPerSm.  `scratch` holds 1 + kMaxBlocksPerSm * sms
// int32 (the verdict, then a word per block); the kernel writes all it
// reads.  Returns the launch's cudaError_t.
extern "C" int seg_bitmap(const void* seg, const void* bucket, void* out,
                          void* scratch, int n, int n_seg, int sms,
                          void* stream) {
  if (n == 0 || n_seg == 0) return 0;
  static int per_sm = 0;
  if (per_sm == 0) {
    cudaError_t e = cudaFuncSetAttribute(
        seg_bitmap_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)sizeof(Smem));
    if (e != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, seg_bitmap_kernel, kThreads, sizeof(Smem));
    if (e != cudaSuccess) return (int)e;
    if (per_sm == 0) return (int)cudaErrorInvalidConfiguration;
  }
  const int blocks = sms * (per_sm < kMaxBlocksPerSm ? per_sm : kMaxBlocksPerSm);
  void* args[] = {&seg, &bucket, &out, &scratch, &n, &n_seg};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)seg_bitmap_kernel, dim3((unsigned)blocks), dim3(kThreads),
      args, sizeof(Smem), (cudaStream_t)stream);
  const cudaError_t last = cudaGetLastError();  // clears a refused launch
  return (int)(e != cudaSuccess ? e : last);
}
