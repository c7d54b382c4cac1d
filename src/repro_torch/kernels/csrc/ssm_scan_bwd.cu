// Backward of the Mamba-1 selective scan, for Hopper (sm_90a).
//
// Differentiates repro/kernels/ssm_scan.py::ssm_scan (the forward this port
// runs as csrc/ssm_scan.cu).  The reference has no backward kernel: its
// training differentiates the associative scan (models/mamba.py::
// _scan_chunk) with jax.grad.  Per batch row b, channel d and state n, with
// e_t = exp(dt_t a), h_t = e_t h_{t-1} + dt_t x_t B_t and y_t = C_t . h_t,
// the reverse scan carries g_t = dL/dh_t from g = dh_last (zero when the
// final state has no gradient):
//   g_t   = dy_t C_t + e_{t+1} g_{t+1}
//   dx_t  = sum_n g_t dt_t B_t           ddt_t = sum_n g_t (a e_t h_{t-1}
//                                                           + x_t B_t)
//   dB_t  = sum_d g_t dt_t x_t           dC_t  = sum_d dy_t h_t
//   da    = sum_{b,t} g_t dt_t e_t h_{t-1}
// dt, x, dy, ddt, dx: (B, S, D); bt, ct, dbt, dct: (B, S, N); a, da: (D, N);
// h_chunks: (B, ceil(S / 32), D, N), the forward's state after each 32-step
// chunk; dh_last: (B, D, N) or null; all float32.
//
// The backward needs h_{t-1} at every step, and storing every state would
// cost (B, S, D, N) floats (0.54 GB a layer at B 2, S 512, D 8192, N 16).
// So the forward keeps one state per chunk and this kernel walks the chunks
// in reverse, recomputing a chunk's 32 states from the state before it into
// shared memory (with the forward's very instructions, so they are its
// states bit for bit) and then stepping back through them.  The block shape
// is the forward's: 32 channels of one batch row, lanes along d, four warps
// splitting the states, SPT a thread (4 up to 16 states, 8 up to 32).
// dx and ddt are summed over the thread's states and then over the four
// warps in shared memory, in a fixed order.  dB and dC sum over all D
// channels and da over B and S, across blocks: each block writes its own
// partial sums (lanes reduced by a fixed butterfly of shuffles) and a second
// kernel adds the partials in block order.  No float atomics, so two calls on
// the same inputs give bit-identical results.
//
// What bounds it: bytes and the exponentials, as the forward; it reads dt,
// x, dy and the chunk states, writes dx and ddt, and takes two exponentials
// per (b, t, d, n) (recompute and reverse step), plus five shuffles per
// (b, t, warp, state) for each of dB and dC.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 32;         // steps per chunk: the forward's
constexpr int kCh = 32;            // channels per block
constexpr int kWarps = 4;          // state groups per block
constexpr int kThreads = 32 * kWarps;
constexpr float kLog2e = 1.4426950408889634f;

struct Bwd {
  const float* dt;
  const float* bt;
  const float* ct;
  const float* x;
  const float* a;
  const float* hc;       // (B, nch, D, N)
  const float* dy;
  const float* dh_last;  // (B, D, N) or null
  float* ddt;
  float* dx;
  float* db_part;        // (n_dblocks, B, S, N)
  float* dc_part;
  float* da_part;        // (B, D, N)
  int B, S, D, N, nch;
};

__device__ __forceinline__ float ex2(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int SPT>
struct Tile {
  static constexpr int kNP = kWarps * SPT;
  // floats: states [kChunk][kNP][kCh]; dt, x, dy [kChunk][kCh]; bt, ct
  // [kChunk][kNP]; the warps' dx and ddt partials [kWarps][kChunk][kCh]
  static constexpr int kStates = kChunk * kNP * kCh;
  static constexpr int kStage = 3 * kChunk * kCh + 2 * kChunk * kNP;
  static constexpr int kPart = 2 * kWarps * kChunk * kCh;
  static constexpr size_t bytes = sizeof(float) * (kStates + kStage + kPart);
};

template <int SPT>
__global__ void __launch_bounds__(kThreads)
scan_bwd(const Bwd p) {
  using T = Tile<SPT>;
  constexpr int NP = T::kNP;
  extern __shared__ __align__(16) float smem[];
  float* hs = smem;                            // [r][n][c]
  float* dts = hs + T::kStates;                // [r][c]
  float* xs = dts + kChunk * kCh;
  float* dys = xs + kChunk * kCh;
  float* bs = dys + kChunk * kCh;              // [r][n]
  float* cs = bs + kChunk * NP;
  float* pdx = cs + kChunk * NP;               // [g][r][c]
  float* pddt = pdx + kWarps * kChunk * kCh;

  const int c = threadIdx.x & 31, g = threadIdx.x >> 5;
  const int d0 = blockIdx.x * kCh, d = d0 + c;
  const int b = blockIdx.y;
  const bool live = d < p.D;
  const int n0 = g * SPT;

  float a2[SPT], av[SPT], gh[SPT], da[SPT], h0[SPT];
#pragma unroll
  for (int j = 0; j < SPT; ++j) {
    const int n = n0 + j;
    const bool in = live && n < p.N;
    av[j] = in ? p.a[(size_t)d * p.N + n] : 0.f;
    a2[j] = av[j] * kLog2e;
    gh[j] = in && p.dh_last != nullptr
                ? p.dh_last[((size_t)b * p.D + d) * p.N + n] : 0.f;
    da[j] = 0.f;
  }

  for (int i = p.nch - 1; i >= 0; --i) {
    const int t0 = i * kChunk;
    __syncthreads();                 // the last chunk's readers are done
    for (int k = threadIdx.x; k < kChunk * kCh; k += kThreads) {
      const int r = k / kCh, cc = k % kCh, t = t0 + r;
      const bool in = t < p.S && d0 + cc < p.D;
      const size_t off = ((size_t)b * p.S + t) * p.D + d0 + cc;
      dts[k] = in ? p.dt[off] : 0.f;
      xs[k] = in ? p.x[off] : 0.f;
      dys[k] = in ? p.dy[off] : 0.f;
    }
    for (int k = threadIdx.x; k < kChunk * NP; k += kThreads) {
      const int r = k / NP, n = k % NP, t = t0 + r;
      const bool in = t < p.S && n < p.N;
      const size_t off = ((size_t)b * p.S + t) * p.N + n;
      bs[k] = in ? p.bt[off] : 0.f;
      cs[k] = in ? p.ct[off] : 0.f;
    }
    __syncthreads();

    // the chunk's states, recomputed from the one before it; a thread
    // writes and reads only its own (n, c) entries
    float h[SPT];
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      const int n = n0 + j;
      h0[j] = i > 0 && live && n < p.N
                  ? p.hc[(((size_t)b * p.nch + i - 1) * p.D + d) * p.N + n]
                  : 0.f;
      h[j] = h0[j];
    }
    for (int r = 0; r < kChunk; ++r) {
      const float dtv = dts[r * kCh + c];
      const float u = dtv * xs[r * kCh + c];
#pragma unroll
      for (int j = 0; j < SPT; ++j) {
        h[j] = fmaf(h[j], ex2(dtv * a2[j]), u * bs[r * NP + n0 + j]);
        hs[(r * NP + n0 + j) * kCh + c] = h[j];
      }
    }

    // back through the chunk
    for (int r = kChunk - 1; r >= 0; --r) {
      const int t = t0 + r;
      const float dtv = dts[r * kCh + c];
      const float xv = xs[r * kCh + c];
      const float dyv = dys[r * kCh + c];
      float gdx = 0.f, gdt = 0.f, dbv[SPT], dcv[SPT];
#pragma unroll
      for (int j = 0; j < SPT; ++j) {
        const float bv = bs[r * NP + n0 + j], cv = cs[r * NP + n0 + j];
        const float ht = hs[(r * NP + n0 + j) * kCh + c];
        const float hp = r > 0 ? hs[((r - 1) * NP + n0 + j) * kCh + c] : h0[j];
        const float e = ex2(dtv * a2[j]);
        gh[j] = fmaf(dyv, cv, gh[j]);                // dL/dh_t
        const float gdtv = gh[j] * dtv;
        const float ge = gh[j] * e * hp;             // dL/d(dt a) before a
        gdx = fmaf(gdtv, bv, gdx);
        gdt = fmaf(ge, av[j], gdt);
        gdt = fmaf(gh[j] * xv, bv, gdt);
        da[j] = fmaf(ge, dtv, da[j]);
        dbv[j] = gdtv * xv;
        dcv[j] = dyv * ht;
        gh[j] *= e;                                  // on to h_{t-1}
      }
      pdx[(g * kChunk + r) * kCh + c] = gdx;
      pddt[(g * kChunk + r) * kCh + c] = gdt;
#pragma unroll
      for (int j = 0; j < SPT; ++j) {
        dbv[j] = warp_sum(dbv[j]);
        dcv[j] = warp_sum(dcv[j]);
      }
      if (c == 0 && t < p.S) {
        const size_t off =
            (((size_t)blockIdx.x * p.B + b) * p.S + t) * p.N + n0;
#pragma unroll
        for (int j = 0; j < SPT; ++j)
          if (n0 + j < p.N) {
            p.db_part[off + j] = dbv[j];
            p.dc_part[off + j] = dcv[j];
          }
      }
    }
    __syncthreads();
    // dx and ddt of the chunk: the four warps' partials in warp order
    for (int k = threadIdx.x; k < kChunk * kCh; k += kThreads) {
      const int r = k / kCh, cc = k % kCh, t = t0 + r;
      if (t >= p.S || d0 + cc >= p.D) continue;
      float sx = pdx[k], st = pddt[k];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) {
        sx += pdx[w * kChunk * kCh + k];
        st += pddt[w * kChunk * kCh + k];
      }
      const size_t off = ((size_t)b * p.S + t) * p.D + d0 + cc;
      p.dx[off] = sx;
      p.ddt[off] = st;
    }
  }
  if (!live) return;
#pragma unroll
  for (int j = 0; j < SPT; ++j)
    if (n0 + j < p.N)
      p.da_part[((size_t)b * p.D + d) * p.N + n0 + j] = da[j];
}

// out[i] = sum over k < K of part[k * M + i], k ascending
__global__ void __launch_bounds__(256)
sum_parts(const float* __restrict__ part, float* __restrict__ out, int K,
          size_t M) {
  const size_t i = (size_t)blockIdx.x * 256 + threadIdx.x;
  if (i >= M) return;
  float s = 0.f;
  for (int k = 0; k < K; ++k) s += part[(size_t)k * M + i];
  out[i] = s;
}

cudaError_t sum(const float* part, float* out, int K, size_t M,
                cudaStream_t st) {
  if (M == 0) return cudaSuccess;
  sum_parts<<<(unsigned)((M + 255) / 256), 256, 0, st>>>(part, out, K, M);
  return cudaGetLastError();
}

template <int SPT>
cudaError_t run(const Bwd& p, cudaStream_t st) {
  using T = Tile<SPT>;
  auto kern = scan_bwd<SPT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.D + kCh - 1) / kCh, p.B);
  kern<<<grid, kThreads, T::bytes, st>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dbt, dct, da are written from the partials db_part, dc_part
// ((ceil(D / 32), B, S, N)) and da_part ((B, D, N)), scratch the caller
// allocates.  dh_last may be null.  Returns a cudaError_t.
extern "C" int ssm_scan_bwd(const void* dt, const void* bt, const void* ct,
                            const void* x, const void* a, const void* hc,
                            const void* dy, const void* dh_last, void* ddt,
                            void* dbt, void* dct, void* dx, void* da,
                            void* db_part, void* dc_part, void* da_part,
                            int B, int S, int D, int N, void* stream) {
  if (B == 0 || D == 0 || N == 0 || S == 0) return 0;
  if (N > 32 || B > 65535) return (int)cudaErrorInvalidValue;
  Bwd p;
  p.dt = (const float*)dt;
  p.bt = (const float*)bt;
  p.ct = (const float*)ct;
  p.x = (const float*)x;
  p.a = (const float*)a;
  p.hc = (const float*)hc;
  p.dy = (const float*)dy;
  p.dh_last = (const float*)dh_last;
  p.ddt = (float*)ddt;
  p.dx = (float*)dx;
  p.db_part = (float*)db_part;
  p.dc_part = (float*)dc_part;
  p.da_part = (float*)da_part;
  p.B = B; p.S = S; p.D = D; p.N = N;
  p.nch = (S + kChunk - 1) / kChunk;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = N <= 16 ? run<4>(p, st) : run<8>(p, st);
  if (err != cudaSuccess) return (int)err;
  const int nbd = (D + kCh - 1) / kCh;
  const size_t bsn = (size_t)B * S * N;
  if ((err = sum(p.db_part, (float*)dbt, nbd, bsn, st)) != cudaSuccess)
    return (int)err;
  if ((err = sum(p.dc_part, (float*)dct, nbd, bsn, st)) != cudaSuccess)
    return (int)err;
  return (int)sum(p.da_part, (float*)da, B, (size_t)D * N, st);
}
