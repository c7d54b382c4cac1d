// Pairwise popcount of the AND of signature words, for Hopper (sm_90a).
//
// Replaces repro/kernels/summary_probe.py::summary_probe (the Pallas kernel
// _kernel, pallas_call in summary_probe): out[i, j] = the sum over words k
// of popcount(a[i, k] & b[j, k]), the entity-summary probe of paper §3.3
// (zero means the two signatures share no bit: no candidate federated CP).
// The TPU kernel walks (128 x 128) output tiles with the word axis as its
// sequential grid dimension and a SWAR popcount on the VPU.
//
// Work split: a block of 32 x 8 threads owns a 32 x 32 output tile and loops
// over the words in chunks of 32: each chunk of A's 32 rows and B's 32 rows
// is staged in shared memory with coalesced loads (rows padded to 33 words
// against bank conflicts), then each thread adds __popc of the AND for its
// four outputs.  Out-of-range rows and words load as 0 and count nothing.
//
// What bounds it: bytes at the real sizes (the signature rows, 4 bytes a
// word, read once, and the int32 output written once); the AND and popcount
// are two integer operations per (i, j, word), all of which a shared-memory
// tile feeds from on-chip copies.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;
constexpr int kRows = 8;             // thread rows; each owns kTile/kRows outputs

__global__ void summary_probe_kernel(const uint32_t* __restrict__ a,
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

}  // namespace

extern "C" int summary_probe(const void* a, const void* b, void* out, int na,
                             int nb, int w, void* stream) {
  if (na == 0 || nb == 0) return 0;
  const dim3 grid((nb + kTile - 1) / kTile, (na + kTile - 1) / kTile);
  const dim3 block(kTile, kRows);
  summary_probe_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (int32_t*)out, na, nb, w);
  return (int)cudaGetLastError();
}
