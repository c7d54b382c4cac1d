// One dense layer tile of the join-order DP, for Hopper (sm_90a).
//
// Replaces repro/kernels/dp_layer.py::dp_layer (the Pallas kernel _kernel,
// pallas_call in _build_layer_program), the tiled fallback for topologies
// whose resident schedule exceeds the memory budget.  The TPU kernel walks a
// (member, column tile, row tile) grid and carries a running minimum across
// the sequential row-tile axis.  Here blocks run in parallel and in no
// order, so the row axis is split across threads and across blocks, and the
// carry becomes a reduction.
//
// Work split: a 2-D grid of (member x column group, row chunk); the wrapper
// picks the chunk length so that the tile runs at least two waves of blocks
// over the card's 132 SMs whatever its aspect.  A block of 256 threads covers
// CW columns (the least power of two >= min(C, 32)) and 256 / CW row lanes;
// thread (lane_r, lane_c) walks rows lane_r, lane_r + 256 / CW, ... of its
// chunk.  Neighbouring threads of a warp read neighbouring addresses in both
// regimes: across rows when C = 1 (the tile is contiguous in r), across
// columns when C is wide.  Loads go through the read-only path (__ldg) and
// are issued for every row whatever its validity, so a warp does not
// diverge on the mask and the unrolled loop keeps several rows in flight.
//
// The reduction: a row is a candidate only if it is valid and its priced
// cost v satisfies v < +inf (the serial loop starts from best = INFINITY,
// so an inf row never wins and an all-inf column returns inf / 2^31-1 / 0).
// Candidates merge by smaller cost, then smaller row: within a thread (rows
// in increasing order, strict <), across the lanes of a warp that share a
// column (shuffles), across the warps of the block (shared memory), and
// across the row chunks (a second small kernel, one warp per (member,
// column), over the (B * C, n_chunks) partials the wrapper allocates).
// The order "(cost, row) lexicographically smaller" is a total order on the
// candidates, so the merge is associative and commutative: any merge order
// returns the serial loop's first strict minimum, and is_bind is the flag
// of that winning row.
//
// What bounds it: the bytes of the dense tile, 41 per (member, row, column)
// (five float64 planes and one int8 flag) plus the (R, C) validity mask; the
// float64 arithmetic is a few operations per element.
//
// Bit-identity: the pricing keeps the operation association of
// CostModel.join_candidates_v exactly, and the library is built with
// --fmad=false so nvcc contracts no multiply-add into an FMA.

#include <cuda_runtime.h>
#include <stdint.h>
#include <climits>
#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCols = 32;      // columns a block covers at most

struct Cand {
  double v;
  int r;
  int bind;
};

// (cost, row) lexicographic minimum; the empty candidate is (inf, INT_MAX)
__device__ __forceinline__ void merge(Cand& a, const Cand& b) {
  if (b.v < a.v || (b.v == a.v && b.r < a.r)) a = b;
}

__device__ __forceinline__ Cand shfl_xor(const Cand& c, int off) {
  Cand o;
  o.v = __shfl_xor_sync(0xffffffffu, c.v, off);
  o.r = __shfl_xor_sync(0xffffffffu, c.r, off);
  o.bind = __shfl_xor_sync(0xffffffffu, c.bind, off);
  return o;
}

__global__ void __launch_bounds__(kThreads) dp_layer_kernel(
    const double* __restrict__ cost_a, const double* __restrict__ cost_b,
    const double* __restrict__ card_a, const double* __restrict__ n_src_b,
    const double* __restrict__ src_w_b, const int8_t* __restrict__ bindable,
    const int8_t* __restrict__ valid, const double* __restrict__ card_s,
    double* __restrict__ best_out, int32_t* __restrict__ row_out,
    uint8_t* __restrict__ bind_out, int B, int R, int C, int cw, int groups,
    int chunk_rows, int n_chunks, double iw, double tw, double rc,
    double bb) {
  __shared__ Cand part[kWarps][kMaxCols];
  const int b = blockIdx.x / groups;
  const int c = (blockIdx.x % groups) * cw + (threadIdx.x & (cw - 1));
  const int lanes_r = kThreads / cw;
  const int lane_r = threadIdx.x / cw;
  const int chunk = blockIdx.y;
  const int r_hi = min(R, (chunk + 1) * chunk_rows);
  const bool active = c < C;

  Cand best = {INFINITY, INT_MAX, 0};
  if (active) {
    const double cs = card_s[(long long)b * C + c];
    const double hash = iw * cs;      // hash_join_cost_v(card_s)
    const double tw_card = tw * cs;   // (tw * card_s) * src_w_b
    const long long base = (long long)b * R * C + c;
#pragma unroll 4
    for (int r = chunk * chunk_rows + lane_r; r < r_hi; r += lanes_r) {
      const long long o = base + (long long)r * C;
      const bool ok = __ldg(&valid[(long long)r * C + c]) != 0;
      const double ca = __ldg(&cost_a[o]);
      const double hc = (ca + __ldg(&cost_b[o])) + hash;
      const double q = __ldg(&card_a[o]) / bb;
      const double n_req = (q < 1.0 ? 1.0 : q) * __ldg(&n_src_b[o]);
      const double bcost =
          ca + ((rc * n_req + tw_card * __ldg(&src_w_b[o])) + hash);
      const bool is_bind = (__ldg(&bindable[o]) != 0) && (bcost < hc);
      const double v = is_bind ? bcost : hc;
      if (ok && v < best.v) {  // strict: an equal later row never displaces
        best.v = v;
        best.r = r;
        best.bind = is_bind ? 1 : 0;
      }
    }
  }
  // lanes of a warp that share a column differ by multiples of cw
  for (int off = cw; off < 32; off <<= 1) merge(best, shfl_xor(best, off));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane < cw) part[warp][lane] = best;
  __syncthreads();
  if (threadIdx.x >= cw || !active) return;
  Cand m = part[0][threadIdx.x];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) merge(m, part[w][threadIdx.x]);
  const long long bc = (long long)b * C + c;
  if (n_chunks == 1) {
    best_out[bc] = m.v;
    row_out[bc] = m.r;
    bind_out[bc] = (uint8_t)m.bind;
  } else {
    const long long p = bc * n_chunks + chunk;
    best_out[p] = m.v;      // the partials, (B * C, n_chunks)
    row_out[p] = m.r;
    bind_out[p] = (uint8_t)m.bind;
  }
}

// one warp per (member, column) over its n_chunks partials
__global__ void __launch_bounds__(kThreads) dp_layer_merge_kernel(
    const double* __restrict__ part_v, const int32_t* __restrict__ part_r,
    const uint8_t* __restrict__ part_b, double* __restrict__ best_out,
    int32_t* __restrict__ row_out, uint8_t* __restrict__ bind_out,
    long long n_cols, int n_chunks) {
  const long long bc =
      ((long long)blockIdx.x * kThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (bc >= n_cols) return;  // whole warps leave together
  Cand m = {INFINITY, INT_MAX, 0};
  const long long p0 = bc * n_chunks;
  for (int j = lane; j < n_chunks; j += 32)
    merge(m, Cand{part_v[p0 + j], part_r[p0 + j], part_b[p0 + j]});
  for (int off = 16; off > 0; off >>= 1) merge(m, shfl_xor(m, off));
  if (lane == 0) {
    best_out[bc] = m.v;
    row_out[bc] = m.r;
    bind_out[bc] = (uint8_t)m.bind;
  }
}

}  // namespace

// chunk_rows: rows a block walks (the wrapper's choice); when R needs more
// than one chunk, part_v / part_r / part_b hold (B * C, ceil(R / chunk_rows))
// float64 / int32 / uint8 partials, else they are not read.
extern "C" int dp_layer_tile(const void* cost_a, const void* cost_b,
                             const void* card_a, const void* n_src_b,
                             const void* src_w_b, const void* bindable,
                             const void* valid, const void* card_s,
                             void* best_out, void* row_out, void* bind_out,
                             void* part_v, void* part_r, void* part_b,
                             int B, int R, int C, int chunk_rows, double iw,
                             double tw, double rc, double bb, void* stream) {
  if ((long long)B * C == 0) return 0;
  if (chunk_rows <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  int cw = 1;
  while (cw < C && cw < kMaxCols) cw <<= 1;
  const int groups = (C + cw - 1) / cw;
  const int n_chunks = R > 0 ? (R + chunk_rows - 1) / chunk_rows : 1;
  const bool split = n_chunks > 1;
  if (n_chunks > 65535) return (int)cudaErrorInvalidValue;
  if (split && (!part_v || !part_r || !part_b))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((long long)B * groups), (unsigned)n_chunks);
  dp_layer_kernel<<<grid, kThreads, 0, st>>>(
      (const double*)cost_a, (const double*)cost_b, (const double*)card_a,
      (const double*)n_src_b, (const double*)src_w_b, (const int8_t*)bindable,
      (const int8_t*)valid, (const double*)card_s,
      (double*)(split ? part_v : best_out),
      (int32_t*)(split ? part_r : row_out),
      (uint8_t*)(split ? part_b : bind_out), B, R, C, cw, groups, chunk_rows,
      n_chunks, iw, tw, rc, bb);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !split) return (int)err;
  const long long n_cols = (long long)B * C;
  const long long blocks = (n_cols * 32 + kThreads - 1) / kThreads;
  dp_layer_merge_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(
      (const double*)part_v, (const int32_t*)part_r, (const uint8_t*)part_b,
      (double*)best_out, (int32_t*)row_out, (uint8_t*)bind_out, n_cols,
      n_chunks);
  return (int)cudaGetLastError();
}
