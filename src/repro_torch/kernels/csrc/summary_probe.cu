// Pairwise popcount of the AND of signature words, for Hopper (sm_90a).
//
// Replaces repro/kernels/summary_probe.py::summary_probe (the Pallas kernel
// _kernel, pallas_call in summary_probe): out[i, j] = the sum over words k
// of popcount(a[i, k] & b[j, k]), the entity-summary probe of paper §3.3
// (zero means the two signatures share no bit: no candidate federated CP).
// The TPU kernel walks (128 x 128) output tiles with the word axis as its
// sequential grid dimension and a SWAR popcount on the VPU.
//
// Contract: any na, nb and word count w, including 0, any parity of w, and
// rows at any 4-byte boundary.  Both forms write every output once, so the
// wrapper allocates the output with torch.empty.
//
// Two forms, picked by shape in the C entry (kernels/summary_probe.py
// `form` mirrors the rule): the warp form when the 32 x 32 tile grid has
// fewer tiles than the card has SMs (every call of the statistics path,
// whose blocks are at most 8 x 40 rows of 512 words), else the tiled form.
//
// Warp form: one warp per output.  Its lanes stride over the two rows'
// words with 16-byte loads, kVec of them a lane a row issued before the
// first popcount, then __popc of the AND, a warp-wide sum and one store.
// The 8 x 40 block is 320 warps on 80 blocks, one round of loads.  A row
// pair whose starts lie at the same offset from a 16-byte boundary takes
// a scalar head up to the boundary and a scalar tail of w % 4 words; a
// pair at different offsets reads every word with 4-byte loads.
// What bounds it: the latency of one round of loads, then the launch; the
// bytes (each row read once, 4 bytes an output) are far below either.
//
// Tiled form: a block of 32 x 8 threads owns a 32 x 32 output tile and
// loops over the words in chunks of 32: each chunk of A's 32 rows and B's
// 32 rows is staged in shared memory with coalesced loads (rows padded to
// 33 words against bank conflicts), then each thread adds __popc of the
// AND for its four outputs.  Out-of-range rows and words load as 0 and
// count nothing.  What bounds it: the integer pipe's popcounts (two
// operations per (i, j, word)), fed from the shared-memory tiles.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;
constexpr int kRows = 8;             // thread rows; each owns kTile/kRows outputs
constexpr int kWarpsPerBlock = 4;    // warp form
constexpr int kVec = 4;              // 16-byte loads a lane a row per round
constexpr int kScalar = 8;           // 4-byte loads a lane a row per round

__global__ void summary_probe_tiled(const uint32_t* __restrict__ a,
                                    const uint32_t* __restrict__ b,
                                    int32_t* __restrict__ out, int na, int nb,
                                    int w) {
  __shared__ uint32_t as[kTile][kTile + 1];
  __shared__ uint32_t bs[kTile][kTile + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int i0 = blockIdx.y * kTile, j0 = blockIdx.x * kTile;
  int acc[kTile / kRows] = {0, 0, 0, 0};
  for (int k0 = 0; k0 < w; k0 += kTile) {
    const int k = k0 + tx;
#pragma unroll
    for (int r = 0; r < kTile / kRows; ++r) {
      const int row = ty + r * kRows;
      const int ia = i0 + row, jb = j0 + row;
      as[row][tx] = (ia < na && k < w) ? a[(long long)ia * w + k] : 0u;
      bs[row][tx] = (jb < nb && k < w) ? b[(long long)jb * w + k] : 0u;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kTile; ++kk) {
      const uint32_t bv = bs[tx][kk];
#pragma unroll
      for (int r = 0; r < kTile / kRows; ++r)
        acc[r] += __popc(as[ty + r * kRows][kk] & bv);
    }
    __syncthreads();
  }
  const int j = j0 + tx;
  if (j >= nb) return;
#pragma unroll
  for (int r = 0; r < kTile / kRows; ++r) {
    const int i = i0 + ty + r * kRows;
    if (i < na) out[(long long)i * nb + j] = acc[r];
  }
}

__device__ __forceinline__ int popc4(uint4 x, uint4 y) {
  return __popc(x.x & y.x) + __popc(x.y & y.y) + __popc(x.z & y.z) +
         __popc(x.w & y.w);
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
summary_probe_warp(const uint32_t* __restrict__ a,
                   const uint32_t* __restrict__ b, int32_t* __restrict__ out,
                   int na, int nb, int w) {
  const int lane = threadIdx.x & 31;
  const long long o = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (o >= (long long)na * nb) return;           // the whole warp
  const uint32_t* ar = a + (o / nb) * w;
  const uint32_t* br = b + (o % nb) * w;
  // words from each row's start to its next 16-byte boundary
  const int ha = (4 - (int)(((uintptr_t)ar >> 2) & 3)) & 3;
  const int hb = (4 - (int)(((uintptr_t)br >> 2) & 3)) & 3;
  int acc = 0;
  if (ha == hb) {
    const int head = ha < w ? ha : w;
    if (lane < head) acc += __popc(__ldg(ar + lane) & __ldg(br + lane));
    const int nv = (w - head) >> 2;                // 16-byte words
    const uint4* av = reinterpret_cast<const uint4*>(ar + head);
    const uint4* bv = reinterpret_cast<const uint4*>(br + head);
    for (int v0 = 0; v0 < nv; v0 += 32 * kVec) {
      uint4 x[kVec], y[kVec];
#pragma unroll
      for (int r = 0; r < kVec; ++r) {
        const int v = v0 + r * 32 + lane;
        x[r] = v < nv ? __ldg(av + v) : make_uint4(0, 0, 0, 0);
        y[r] = v < nv ? __ldg(bv + v) : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int r = 0; r < kVec; ++r) acc += popc4(x[r], y[r]);
    }
    const int tail = head + 4 * nv + lane;         // at most 3 words
    if (tail < w) acc += __popc(__ldg(ar + tail) & __ldg(br + tail));
  } else {
    for (int k0 = 0; k0 < w; k0 += 32 * kScalar) {
      uint32_t x[kScalar], y[kScalar];
#pragma unroll
      for (int r = 0; r < kScalar; ++r) {
        const int k = k0 + r * 32 + lane;
        x[r] = k < w ? __ldg(ar + k) : 0u;
        y[r] = k < w ? __ldg(br + k) : 0u;
      }
#pragma unroll
      for (int r = 0; r < kScalar; ++r) acc += __popc(x[r] & y[r]);
    }
  }
  acc = __reduce_add_sync(0xffffffffu, acc);
  if (lane == 0) out[o] = acc;
}

}  // namespace

// `sms` is the device's cudaDevAttrMultiProcessorCount: below that many
// 32 x 32 tiles the warp form runs, else the tiled form.
extern "C" int summary_probe(const void* a, const void* b, void* out, int na,
                             int nb, int w, int sms, void* stream) {
  if (na == 0 || nb == 0) return 0;
  const long long tiles =
      (long long)((na + kTile - 1) / kTile) * ((nb + kTile - 1) / kTile);
  if (tiles < sms) {
    const long long blocks =
        ((long long)na * nb + kWarpsPerBlock - 1) / kWarpsPerBlock;
    summary_probe_warp<<<(unsigned)blocks, kWarpsPerBlock * 32, 0,
                         (cudaStream_t)stream>>>(
        (const uint32_t*)a, (const uint32_t*)b, (int32_t*)out, na, nb, w);
  } else {
    const dim3 grid((nb + kTile - 1) / kTile, (na + kTile - 1) / kTile);
    const dim3 block(kTile, kRows);
    summary_probe_tiled<<<grid, block, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)a, (const uint32_t*)b, (int32_t*)out, na, nb, w);
  }
  return (int)cudaGetLastError();
}
