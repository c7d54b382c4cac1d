// One dense layer tile of the join-order DP, for Hopper (sm_90a).
//
// Replaces repro/kernels/dp_layer.py::dp_layer (the Pallas kernel _kernel,
// pallas_call in _build_layer_program), the tiled fallback for topologies
// whose resident schedule exceeds the memory budget.  The TPU kernel walks a
// (member, column tile, row tile) grid and carries a running minimum across
// the sequential row-tile axis; here blocks run in no order, so the row axis
// becomes a loop inside one thread.
//
// Work split: one thread per (member b, column c) walks rows r = 0 .. R-1 in
// order and keeps the first strict minimum (cost, first row, is_bind) of the
// valid pairs.  Column c is the innermost dimension of every (B, R, C) input,
// so the 32 threads of a warp read 32 neighbouring doubles per row.
//
// What bounds it: the bytes of the dense tile, 41 per (member, row, column)
// (five float64 planes and one int8 flag) plus the (R, C) validity mask; the
// float64 arithmetic is a few operations per element, so the kernel is
// memory-bound.  Tall, narrow tiles (few columns, many rows) leave most of
// the card idle, since only B * C threads exist.
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

__global__ void dp_layer_kernel(
    const double* __restrict__ cost_a, const double* __restrict__ cost_b,
    const double* __restrict__ card_a, const double* __restrict__ n_src_b,
    const double* __restrict__ src_w_b, const int8_t* __restrict__ bindable,
    const int8_t* __restrict__ valid, const double* __restrict__ card_s,
    double* __restrict__ best_out, int32_t* __restrict__ row_out,
    uint8_t* __restrict__ bind_out, int B, int R, int C, double iw, double tw,
    double rc, double bb) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)B * C) return;
  const int b = (int)(idx / C);
  const int c = (int)(idx % C);

  const double cs = card_s[idx];
  const double hash = iw * cs;      // hash_join_cost_v(card_s)
  const double tw_card = tw * cs;   // (tw * card_s) * src_w_b

  double best = INFINITY;
  int first = INT_MAX;
  uint8_t bind = 0;
  const long long base = (long long)b * R * C + c;
  for (int r = 0; r < R; ++r) {
    if (!valid[(long long)r * C + c]) continue;
    const long long o = base + (long long)r * C;
    const double ca = cost_a[o];
    const double hc = (ca + cost_b[o]) + hash;
    const double q = card_a[o] / bb;
    const double n_req = (q < 1.0 ? 1.0 : q) * n_src_b[o];  // max(1, q)
    const double bcost = ca + ((rc * n_req + tw_card * src_w_b[o]) + hash);
    const bool is_bind = (bindable[o] != 0) && (bcost < hc);
    const double v = is_bind ? bcost : hc;
    if (v < best) {  // strict: an equal later row never displaces
      best = v;
      first = r;
      bind = is_bind ? 1 : 0;
    }
  }
  best_out[idx] = best;
  row_out[idx] = first;
  bind_out[idx] = bind;
}

}  // namespace

extern "C" int dp_layer_tile(const void* cost_a, const void* cost_b,
                             const void* card_a, const void* n_src_b,
                             const void* src_w_b, const void* bindable,
                             const void* valid, const void* card_s,
                             void* best_out, void* row_out, void* bind_out,
                             int B, int R, int C, double iw, double tw,
                             double rc, double bb, void* stream) {
  const long long n = (long long)B * C;
  if (n == 0) return 0;
  const long long blocks = (n + kThreads - 1) / kThreads;
  dp_layer_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const double*)cost_a, (const double*)cost_b, (const double*)card_a,
      (const double*)n_src_b, (const double*)src_w_b, (const int8_t*)bindable,
      (const int8_t*)valid, (const double*)card_s, (double*)best_out,
      (int32_t*)row_out, (uint8_t*)bind_out, B, R, C, iw, tw, rc, bb);
  return (int)cudaGetLastError();
}
