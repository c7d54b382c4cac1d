// The resident join-order DP sweep, for Hopper (sm_90a): one persistent
// cooperative launch runs every popcount layer.
//
// Replaces repro/kernels/dp_layer.py::dp_sweep_resident (the lax.scan
// program built by _build_sweep_program).  The grid is as many blocks as
// the card holds at once (SMs x resident blocks per SM); it loops over the
// layers and a grid barrier separates them.  Layer s reads the DP state only
// at masks of lower popcount and writes each of its columns (connected
// subsets S) exactly once, so the barrier is the whole dependence; it also
// orders layer s's state writes before layer s + 1's reads.  Before the
// first barrier the grid builds the working state from the seeds, clears
// strat/split and zeroes the arrival counters, so every call starts fresh.
//
// Work split: the host cuts each column's pair run [col_ptr[l][c],
// col_ptr[l][c+1]) of the layer's flat schedule (reference enumeration
// order) into work items of at most ITEM_PAIRS pairs
// (repro_torch/kernels/dp_layer.py::work_items), rows (column, lo, hi, first)
// grouped by layer (item_ptr).  Warps walk the layer's (item, member) units
// grid-stride.  A warp prices its item's pairs p = lo + lane, lo + lane + 32,
// ... in that order, two at a time so that their gathers are in flight
// together (each lane keeps its first strict minimum (cost, position,
// is_bind)), and takes the lexicographic (cost, position) minimum across
// the warp, which is the run's first strict minimum because positions
// ascend in enumeration order.
//  - A column of one item (first == -1): lane 0 writes the state at S.
//  - A split column (first = index of its first item): lane 0 stores the
//    item's partial minimum in its slot and adds the item's pair count to
//    the (member, column) arrival counter with one acq_rel atomic (release:
//    the partial is visible before the count; acquire: the last arrival
//    sees every partial counted before it; a __syncwarp then orders that
//    acquire before the other lanes' reads).  The item that brings the
//    counter to the column's length is the last: its warp reads the
//    column's partials (items first, first + 1, ... of the same column),
//    takes their lexicographic minimum and writes the state.  A merge only
//    compares values, so splitting a column cannot change which pair wins.
// Writing the state applies the exclusive-group leaf seed (a pair must beat
// it strictly) and writes the state at S, exactly as dp_layer.py:332-361
// does, including "strat 0 = never written".
//
// What bounds it: the random gathers of the DP state, per pair and member
// cost[A], card[A], cost[B], n_src[B], src_w[B], each in another cache
// sector, so the sectors moved through L1 and L2 in the wide middle
// layers, not the float64 arithmetic (a few operations per pair); and in
// the narrow top layers, latency: a grid barrier, then per unit a chain of
// dependent loads (the item, the walk of ITEM_PAIRS / 64 steps, the merge).
// The working state is therefore one 32-byte record per (member, mask),
// (cost, card, n_src, src_w): a pair reads two sectors (A's record, B's
// record) in three loads, not five.  Blocks of 16 warps (one block an SM
// at this kernel's registers) and two pairs a lane at once were the
// fastest of the forms timed on the card (PERF.md).
//
// The records are written inside the kernel and read by later layers, so
// they are read through plain pointers (L1, made coherent by the barrier's
// fence), never through the read-only path (__ldg / const __restrict__),
// which may return a line that is stale after the barrier.  The partials
// are read with __ldcg (L2) after the arrival counter's acquire.
//
// Bit-identity: the pricing keeps the operation association of
// CostModel.join_candidates_v exactly, and the library is built with
// --fmad=false so nvcc contracts no multiply-add into an FMA.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <climits>
#include <cmath>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarpsPerBlock = 16;
constexpr int kThreads = 32 * kWarpsPerBlock;
constexpr int kUnroll = 2;   // pairs a lane prices at once
constexpr unsigned kFull = 0xffffffffu;
constexpr int kStratExcl = 2;
constexpr int kStratHash = 3;
constexpr int kStratBind = 4;

struct Best {       // a run's first strict minimum; also a partial's layout
  double cost;
  int pos;
  int bind;
};

struct __align__(32) State {   // one (member, mask) of the working state
  double cost;
  double card;
  double n_src;
  double src_w;
};

__device__ __forceinline__ bool better(double c, int p, const Best& b) {
  return c < b.cost || (c == b.cost && p < b.pos);
}

// lexicographic (cost, position) minimum across the warp, in lane 0
__device__ __forceinline__ Best warp_min(Best x) {
  for (int off = 16; off > 0; off >>= 1) {
    const double ob = __shfl_down_sync(kFull, x.cost, off);
    const int op = __shfl_down_sync(kFull, x.pos, off);
    const int obind = __shfl_down_sync(kFull, x.bind, off);
    if (better(ob, op, x)) x = Best{ob, op, obind};
  }
  return x;
}

// Pair (A, B)'s candidate cost and whether the bind join wins, from A's
// and B's records: CostModel.join_candidates_v's association exactly.
__device__ __forceinline__ void price(const double2& sa, const double2& sb,
                                      const double2& wb, double hash,
                                      double tw_card, double rc, double bb,
                                      double& v, bool& is_bind) {
  const double ca = sa.x;                        // cost[A]
  const double hc = (ca + sb.x) + hash;          // + cost[B]
  const double ns = wb.x;                        // n_src[B]
  const double q = sa.y / bb;                    // card[A] / bind_batch
  const double n_req = (q < 1.0 ? 1.0 : q) * ns;  // max(1, q), NaN kept
  const double bcost = ca + ((rc * n_req + tw_card * wb.y) + hash);
  is_bind = (ns > 0.0) && (bcost < hc);
  v = is_bind ? bcost : hc;
}

// The lane's first strict minimum over pairs lo + lane, lo + lane + 32, ...
// of [lo, hi), taken in that order, kUnroll pairs at once so that their
// gathers are in flight together; (inf, INT_MAX, 0) when no pair has a
// finite cost (v < best is strict, so neither inf nor NaN ever wins).
__device__ __forceinline__ Best price_run(
    const int32_t* __restrict__ pa, const int32_t* __restrict__ pb, int lo,
    int hi, int lane, const State* st_r, double hash, double tw_card,
    double rc, double bb) {
  Best best{INFINITY, INT_MAX, 0};
  int p = lo + lane;
  for (; p + 32 * (kUnroll - 1) < hi; p += 32 * kUnroll) {
    double2 sa[kUnroll], sb[kUnroll], wb[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const State* ra = st_r + pa[p + 32 * j];
      const State* rb = st_r + pb[p + 32 * j];
      sa[j] = *reinterpret_cast<const double2*>(&ra->cost);
      sb[j] = *reinterpret_cast<const double2*>(&rb->cost);
      wb[j] = *reinterpret_cast<const double2*>(&rb->n_src);
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      double v;
      bool is_bind;
      price(sa[j], sb[j], wb[j], hash, tw_card, rc, bb, v, is_bind);
      if (v < best.cost) {  // strict: the lane's earliest minimum stays
        best.cost = v;
        best.pos = p + 32 * j;
        best.bind = is_bind;
      }
    }
  }
  for (; p < hi; p += 32) {
    const State* ra = st_r + pa[p];
    const State* rb = st_r + pb[p];
    double v;
    bool is_bind;
    price(*reinterpret_cast<const double2*>(&ra->cost),
          *reinterpret_cast<const double2*>(&rb->cost),
          *reinterpret_cast<const double2*>(&rb->n_src), hash, tw_card, rc,
          bb, v, is_bind);
    if (v < best.cost) {
      best.cost = v;
      best.pos = p;
      best.bind = is_bind;
    }
  }
  return best;
}

// The winner of column S (flat index `at` = row + S) against the
// exclusive-group leaf seed (candidate 0 in the reference order; its cost
// ec and weight ew), written to the working record and the cost, strat and
// split planes.
__device__ __forceinline__ void write_state(
    const Best& best, long long at, double ec, double ew,
    const int32_t* __restrict__ pa, State* st, double* cost, int32_t* strat,
    int32_t* split) {
  const bool pair_win = best.cost < ec;
  const bool has_excl = isfinite(ec);
  const bool is_excl = has_excl && !pair_win;
  const double c = pair_win ? best.cost : ec;
  cost[at] = c;
  st[at].cost = c;
  st[at].n_src = is_excl ? 1.0 : 0.0;
  st[at].src_w = is_excl ? ew : 1.0;
  strat[at] = pair_win ? (best.bind ? kStratBind : kStratHash)
                       : (has_excl ? kStratExcl : 0);
  int a = 0;
  if (pair_win) a = pa[best.pos];  // a finite cost won: pos is a real pair
  split[at] = a;
}

__global__ void __launch_bounds__(kThreads) dp_sweep_kernel(
    const int32_t* __restrict__ pair_a, const int32_t* __restrict__ pair_b,
    const int32_t* __restrict__ col_ptr,
    const int32_t* __restrict__ layer_cols, const int4* __restrict__ items,
    const int32_t* __restrict__ item_ptr, const double* __restrict__ card,
    const double* __restrict__ excl_cost, const double* __restrict__ excl_w,
    const double* __restrict__ cost0, const double* __restrict__ n_src0,
    const double* __restrict__ src_w0, State* st, double* cost,
    int32_t* strat, int32_t* split, Best* part, int32_t* arrived, int L,
    int B, int size, int P, int C, int N, double iw, double tw, double rc,
    double bb) {
  cg::grid_group grid = cg::this_grid();
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long n_threads = (long long)gridDim.x * kThreads;

  // first phase: the working records and the cost plane from the seeds,
  // the winner planes cleared ("never written"), the arrival counters zeroed
  for (long long i = tid; i < (long long)B * size; i += n_threads) {
    st[i] = State{cost0[i], card[i], n_src0[i], src_w0[i]};
    cost[i] = cost0[i];
    strat[i] = 0;
    split[i] = 0;
  }
  for (long long i = tid; i < (long long)B * N; i += n_threads) arrived[i] = 0;
  grid.sync();

  const int lane = threadIdx.x & 31;
  const long long warp = tid >> 5;
  const long long n_warps = n_threads >> 5;
  for (int l = 0; l < L; ++l) {
    const int32_t* pa = pair_a + (long long)l * P;
    const int32_t* pb = pair_b + (long long)l * P;
    const int32_t* cp = col_ptr + (long long)l * (C + 1);
    const int32_t* cols = layer_cols + (long long)l * C;
    const int i0 = item_ptr[l];
    const int i1 = item_ptr[l + 1];
    const int units = (i1 - i0) * B;
    for (int u = (int)warp; u < units; u += (int)n_warps) {
      const int it = i0 + u / B;
      const int b = u % B;
      const int4 w = items[it];  // (column, lo, hi, first)
      const int S = cols[w.x];
      const long long row = (long long)b * size;
      const double card_out = card[row + S];
      const double hash = iw * card_out;      // hash_join_cost_v(card_out)
      const double tw_card = tw * card_out;   // (tw * card_out) * src_w_b
      const double ec = excl_cost[row + S];  // loaded ahead of the walk
      const double ew = excl_w[row + S];
      Best best = warp_min(price_run(pa, pb, w.y, w.z, lane, st + row, hash,
                                     tw_card, rc, bb));
      if (w.w < 0) {  // the column is this one item
        if (lane == 0)
          write_state(best, row + S, ec, ew, pa, st, cost, strat, split);
        continue;
      }
      int last = 0;
      if (lane == 0) {
        part[(long long)b * N + it] = best;
        // release: the partial is visible before the count; acquire: the
        // last arrival sees every partial counted before it
        const int n = w.z - w.y;
        int seen;
        asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], %2;"
                     : "=r"(seen)
                     : "l"(arrived + (long long)b * N + w.w), "r"(n)
                     : "memory");
        last = seen + n == cp[w.x + 1] - cp[w.x];
      }
      last = __shfl_sync(kFull, last, 0);
      __syncwarp();  // lane 0's acquire happens before every lane's reads
      if (!last) continue;
      Best m{INFINITY, INT_MAX, 0};
      for (int j = w.w + lane; j < i1 && items[j].w == w.w; j += 32) {
        const Best* q = part + (long long)b * N + j;
        const double qc = __ldcg(&q->cost);
        const int qp = __ldcg(&q->pos);
        if (better(qc, qp, m)) m = Best{qc, qp, __ldcg(&q->bind)};
      }
      m = warp_min(m);
      if (lane == 0)
        write_state(m, row + S, ec, ew, pa, st, cost, strat, split);
    }
    if (l + 1 < L) grid.sync();
  }
}

}  // namespace

// One cooperative launch of the whole sweep on `stream`: `sms` (the
// device's cudaDevAttrMultiProcessorCount) times the kernel's resident
// blocks per SM.  Returns the launch's cudaError_t; a grid the card cannot
// hold at once is refused, never cut into more launches.
extern "C" int dp_sweep_run(
    const void* pair_a, const void* pair_b, const void* col_ptr,
    const void* layer_cols, const void* items, const void* item_ptr,
    const void* card, const void* excl_cost, const void* excl_w,
    const void* cost0, const void* n_src0, const void* src_w0, void* st,
    void* cost, void* strat, void* split, void* part, void* arrived, int L,
    int B, int size, int P, int C, int N, int sms,
    double iw, double tw, double rc, double bb, void* stream) {
  static int per_sm = 0;
  if (per_sm == 0) {
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, dp_sweep_kernel, kThreads, 0);
    if (e != cudaSuccess) return (int)e;
    if (per_sm == 0) return (int)cudaErrorInvalidConfiguration;
  }
  void* args[] = {&pair_a, &pair_b, &col_ptr, &layer_cols, &items,
                  &item_ptr, &card, &excl_cost, &excl_w, &cost0, &n_src0,
                  &src_w0, &st, &cost, &strat, &split, &part, &arrived,
                  &L, &B, &size, &P, &C, &N, &iw, &tw, &rc, &bb};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)dp_sweep_kernel, dim3((unsigned)(sms * per_sm)),
      dim3(kThreads), args, 0, (cudaStream_t)stream);
  const cudaError_t last = cudaGetLastError();  // clears a refused launch
  return (int)(e != cudaSuccess ? e : last);
}
