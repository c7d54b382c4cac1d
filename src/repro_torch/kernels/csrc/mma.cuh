// Tensor-core and asynchronous-copy helpers shared by the flash attention
// kernels (flash_attention.cu and its backward, flash_attention_bwd.cu), for
// Hopper (sm_90a): 16-byte cp.async tile copies, TF32 rounding and the
// 3xTF32 split, mma.sync products in TF32 and bf16, quad reductions over the
// four threads that share an accumulator row, ldmatrix.trans, and the key
// tiles a query tile sees.  Blocks are kThreads threads (4 warps).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;          // warps per block
constexpr int kThreads = 32 * kWarps;

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows row0 .. row0 + rows - 1 of a (S, gstride) tensor into shared memory
// rows of sstride elements; rows at or past S are zero-filled
template <typename T, int HD>
__device__ __forceinline__ void load_tile(T* dst, int sstride, const T* src,
                                          size_t gstride, int row0, int rows,
                                          int S) {
  constexpr int kPer = 16 / sizeof(T);   // elements per 16-byte copy
  constexpr int kCpr = HD / kPer;        // copies per row
  for (int i = threadIdx.x; i < rows * kCpr; i += kThreads) {
    const int r = i / kCpr, c = (i % kCpr) * kPer, gr = row0 + r;
    const bool in = gr < S;
    cp_async16(dst + r * sstride + c, src + (size_t)(in ? gr : 0) * gstride + c,
               in ? 16 : 0);
  }
}

// x rounded to TF32, to nearest with ties away from zero: the bits that
// cvt.rna.tf32.f32 gives (sm_90 lowers that instruction to a sequence of
// integer and compare instructions), in two integer operations; exact for
// every non-NaN x (half a TF32 unit added to the magnitude, the 13 low bits
// cleared)
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo with both parts TF32; x - hi is exact in float32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d[mt][n0 + n] += a[mt] * b[n] in float32 accuracy for every m16 tile mt
// and each of NB n8 tiles: lo*hi + hi*lo, then hi*hi, each pass over all
// (mt, n) so that consecutive products never wait on one another's
// accumulator
template <int MT, int N, int NB>
__device__ __forceinline__ void mma_3xtf32_rows(
    float (&d)[MT][N][4], int n0, const uint32_t (&ah)[MT][4],
    const uint32_t (&al)[MT][4], const uint32_t (&bh)[NB][2],
    const uint32_t (&bl)[NB][2]) {
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) mma_tf32(d[mt][n0 + n], al[mt], bh[n]);
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) mma_tf32(d[mt][n0 + n], ah[mt], bl[n]);
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) mma_tf32(d[mt][n0 + n], ah[mt], bh[n]);
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// four 8 x 8 bf16 matrices from shared memory, transposed: lane l gives the
// address of row l % 8 of matrix l / 8; r[i] is this lane's fragment of
// matrix i
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* smem) {
  const unsigned addr = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
      "{%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// the key tiles [lo, hi) that hold a visible key for some row of the query
// tile at q0
struct KeyRange {
  int lo, hi;
  __device__ KeyRange(int q0, int BQ, int S, int BK, int causal,
                      int window) {
    const int q_last = min(q0 + BQ, S) - 1;
    hi = causal ? q_last / BK + 1 : (S + BK - 1) / BK;
    lo = window > 0 ? max(0, q0 - window + 1) / BK : 0;
  }
};

// whether the key tile at k0 crosses a mask edge for some row of the tile
__device__ __forceinline__ bool tile_edge(int k0, int BK, int q0, int BQ,
                                          int S, int causal, int window) {
  return k0 + BK > S || (causal && k0 + BK - 1 > q0) ||
         (window > 0 && q0 + BQ - 1 - k0 >= window);
}

}  // namespace
