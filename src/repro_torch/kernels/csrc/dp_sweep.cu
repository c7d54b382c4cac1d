// One popcount layer of the resident join-order DP sweep, for Hopper (sm_90a).
//
// Replaces repro/kernels/dp_layer.py::dp_sweep_resident (the lax.scan
// program built by _build_sweep_program).  The host launches this kernel
// once per layer, L = n - 1 launches on one stream; the stream order carries
// the dependence between layers: layer s reads the DP state only at masks of
// lower popcount, which earlier launches wrote, and writes each of its
// columns (connected subsets S) exactly once.
//
// Work split: one warp per (member b, column c).  The column's candidate
// pairs are the contiguous run [col_ptr[l][c], col_ptr[l][c+1]) of the
// layer's flat schedule, in the reference enumeration order.  Each lane
// prices the pairs p = lo + lane, lo + lane + 32, ... and keeps its first
// strict minimum (cost, position, is_bind); a shuffle reduction then takes
// the lexicographic minimum on (cost, position), which is the first strict
// minimum of the whole column because positions ascend in enumeration order.
// Lane 0 applies the exclusive-group leaf seed (a pair must beat it strictly)
// and writes the five state planes at S, exactly as dp_layer.py:332-361 does,
// including "strat 0 = never written".
//
// What bounds it: the random float64 gathers of the DP state — per pair and
// member cost[A], cost[B], card[A], n_src[B], src_w[B] (40 bytes) plus the
// two int32 schedule entries, about 52 bytes.  The float64 arithmetic is a
// few operations per pair, so the kernel is memory-bound; the state planes
// (6 x 8 bytes x 2^n per member) mostly stay in the 50 MB L2 for n <= 16.
//
// Bit-identity: the pricing keeps the operation association of
// CostModel.join_candidates_v exactly, and the library is built with
// --fmad=false so nvcc contracts no multiply-add into an FMA.

#include <cuda_runtime.h>
#include <stdint.h>
#include <climits>
#include <cmath>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kStratExcl = 2;
constexpr int kStratHash = 3;
constexpr int kStratBind = 4;

__global__ void dp_sweep_layer_kernel(
    const int32_t* __restrict__ pair_a, const int32_t* __restrict__ pair_b,
    const int32_t* __restrict__ col_ptr,
    const int32_t* __restrict__ layer_cols,
    const double* __restrict__ card, const double* __restrict__ excl_cost,
    const double* __restrict__ excl_w, double* cost, double* n_src,
    double* src_w, int32_t* __restrict__ strat, int32_t* __restrict__ split,
    int layer, int B, int size, int P, int C, double iw, double tw, double rc,
    double bb) {
  const int lane = threadIdx.x & 31;
  const long long w =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (w >= (long long)B * C) return;  // warp-uniform exit
  const int b = (int)(w / C);
  const int c = (int)(w % C);
  const int S = layer_cols[(long long)layer * C + c];
  if (S >= size) return;  // padded column (sentinel 2^n), warp-uniform

  const int32_t* pa = pair_a + (long long)layer * P;
  const int32_t* pb = pair_b + (long long)layer * P;
  const int32_t* cp = col_ptr + (long long)layer * (C + 1);
  const long long row = (long long)b * size;
  const double* cost_r = cost + row;
  const double* card_r = card + row;
  const double* nsrc_r = n_src + row;
  const double* srcw_r = src_w + row;

  const double card_out = card_r[S];
  const double hash = iw * card_out;      // hash_join_cost_v(card_out)
  const double tw_card = tw * card_out;   // (tw * card_out) * src_w_b

  double best = INFINITY;
  int best_pos = INT_MAX;
  int best_bind = 0;
  const int lo = cp[c];
  const int hi = cp[c + 1];
  for (int p = lo + lane; p < hi; p += 32) {
    const int a = pa[p];
    const int bm = pb[p];
    const double ca = cost_r[a];
    const double hc = (ca + cost_r[bm]) + hash;
    const double ns = nsrc_r[bm];
    const double q = card_r[a] / bb;
    const double n_req = (q < 1.0 ? 1.0 : q) * ns;  // max(1, q), NaN kept
    const double bcost = ca + ((rc * n_req + tw_card * srcw_r[bm]) + hash);
    const bool is_bind = (ns > 0.0) && (bcost < hc);
    const double v = is_bind ? bcost : hc;
    if (v < best) {  // strict: the lane's earliest minimum stays
      best = v;
      best_pos = p;
      best_bind = is_bind;
    }
  }
  // lexicographic (cost, position) minimum across the warp
  for (int off = 16; off > 0; off >>= 1) {
    const double ob = __shfl_down_sync(0xffffffffu, best, off);
    const int op = __shfl_down_sync(0xffffffffu, best_pos, off);
    const int obind = __shfl_down_sync(0xffffffffu, best_bind, off);
    if (ob < best || (ob == best && op < best_pos)) {
      best = ob;
      best_pos = op;
      best_bind = obind;
    }
  }
  if (lane != 0) return;

  // exclusive-group leaf seed: candidate 0 in the reference order
  const long long at = row + S;
  const double ec = excl_cost[at];
  const bool pair_win = best < ec;
  const bool has_excl = isfinite(ec);
  const bool is_excl = has_excl && !pair_win;
  cost[at] = pair_win ? best : ec;
  n_src[at] = is_excl ? 1.0 : 0.0;
  src_w[at] = is_excl ? excl_w[at] : 1.0;
  strat[at] = pair_win ? (best_bind ? kStratBind : kStratHash)
                       : (has_excl ? kStratExcl : 0);
  split[at] = pair_win ? pa[best_pos] : 0;
}

}  // namespace

extern "C" int dp_sweep_layer(const void* pair_a, const void* pair_b,
                              const void* col_ptr, const void* layer_cols,
                              const void* card, const void* excl_cost,
                              const void* excl_w, void* cost, void* n_src,
                              void* src_w, void* strat, void* split, int layer,
                              int B, int size, int P, int C, double iw,
                              double tw, double rc, double bb, void* stream) {
  const long long warps = (long long)B * C;
  if (warps == 0) return 0;
  const long long blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  dp_sweep_layer_kernel<<<(unsigned)blocks, 32 * kWarpsPerBlock, 0,
                          (cudaStream_t)stream>>>(
      (const int32_t*)pair_a, (const int32_t*)pair_b, (const int32_t*)col_ptr,
      (const int32_t*)layer_cols, (const double*)card,
      (const double*)excl_cost, (const double*)excl_w, (double*)cost,
      (double*)n_src, (double*)src_w, (int32_t*)strat, (int32_t*)split, layer,
      B, size, P, C, iw, tw, rc, bb);
  return (int)cudaGetLastError();
}
