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
// h_chunks: (B, ceil(S / 16), D, N), the forward's state after every 16
// steps; dh_last: (B, D, N) or null; all float32.
//
// The backward needs h_{t-1} at every step, and storing every state would
// cost (B, S, D, N) floats (0.54 GB a layer at B 2, S 512, D 8192, N 16).
// So the forward keeps one state per 16 steps (a chunk) and this kernel
// walks the chunks in reverse, recomputing a chunk's 16 states from the
// state before it (with the forward's very instructions, so they are its
// states bit for bit) into registers, then stepping back through them.
// The block covers the forward's 32 channels of one batch row, lanes along
// d, its eight warps splitting the states, SPT a thread (2 up to 16 states,
// 4 up to 32): 256 blocks of 8 warps at falcon-mamba's 8,192 channels, two
// an SM, 16 warps.
//
// What bounds it: the exponentials and the FP32 pipe on paper (two
// exponentials and about 14 FP32 instructions per (b, t, d, n)), the bytes
// close behind; on the card, shared memory, through which every sum over
// the channels passes: about 21 wavefronts of 128 bytes per warp and step
// at SPT 2.  The design keeps the shuffle unit, the barriers and the
// shared memory as light as it can:
//   - dB and dC sum over the 32 channels of a block once a chunk, not once
//     a step.  The recompute writes each state's dC product dy_t h_t, and
//     the walk, once those are summed, each step's dB product g_t dt_t x_t,
//     into [r][n][c] slots; after each pass the block sums each (step,
//     state) over the channels in a fixed order, from rows padded to 33 so
//     the reads are free of bank conflicts.  No warp shuffle in the walk.
//   - dx_t = dt_t sum_n g_t B_t and the B term of ddt_t come from one sum
//     per step; each warp's partial dx and ddt go to shared memory during
//     the walk and the warps' partials are added in warp order beside the
//     dB sums.  Four barriers a chunk.
//   - The next chunk's dt, x, dy, B_t, C_t and start state come through a
//     2-slot cp.async ring while the current one is walked.
//   - 83 KB of shared memory and at most 128 registers a thread at SPT 2,
//     so two blocks fit an SM.
// dB and dC of a block are partial sums over its 32 channels, and da's over
// its batch row; a second launch adds each output's partials, a block to 32
// outputs: its eight warps stride over the partials (each load a 128-byte
// row), then their sums meet in warp order.  No float atomics, so two calls
// on the same inputs give bit-identical results.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 16;         // steps between the forward's kept states
constexpr int kCh = 32;            // channels per block
constexpr int kWarps = 8;          // state groups per block
constexpr int kThreads = 32 * kWarps;
constexpr int kPS = kCh + 1;       // channel stride of a product row
constexpr float kLog2e = 1.4426950408889634f;

struct Bwd {
  const float* dt;
  const float* bt;
  const float* ct;
  const float* x;
  const float* a;
  const float* hc;       // (B, nch, D, N), nch = ceil(S / kChunk)
  const float* dy;
  const float* dh_last;  // (B, D, N) or null
  float* ddt;
  float* dx;
  float* db_part;        // (n_dblocks, B, S, N)
  float* dc_part;
  float* da_part;        // (B, D, N)
  int B, S, D, N, nch;
  int vec;               // dt, x and dy rows move as 16-byte copies
  int bc_vec;            // so do bt and ct rows
};

__device__ __forceinline__ float ex2(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The block's shared memory, in floats: the chunk's dC products [r][n][c]
// (then its dB products), two ring slots, each dt, x, dy [r][c], bt, ct
// [r][n] and the chunk's start state [n][c], and the warps' dx and ddt
// partials [g][r][c].  A product row is padded to 33 channels, so a warp
// summing 32 (r, n) rows over the channels reads 32 banks.
template <int SPT>
struct Tile {
  static constexpr int kNP = kWarps * SPT;
  static constexpr int kProds = kChunk * kNP * kPS;
  static constexpr int kSlot = 3 * kChunk * kCh + 2 * kChunk * kNP +
                               kCh * kNP;
  static constexpr int kPart = kWarps * kChunk * kCh;
  static constexpr size_t bytes =
      sizeof(float) * (kProds + 2 * kSlot + 2 * kPart);
  // two blocks an SM where their shared memory fits (it does at SPT 2)
  static constexpr int kMinBlocks = bytes <= 113 * 1024 ? 2 : 1;
};

// body(i) for i in [0, n) spread over the block's threads, unrolled
template <int n, typename F>
__device__ __forceinline__ void spread(F body) {
#pragma unroll
  for (int k = 0; k < (n + kThreads - 1) / kThreads; ++k) {
    const int i = threadIdx.x + k * kThreads;
    if (n % kThreads == 0 || i < n) body(i);
  }
}

// chunk i's inputs into a ring slot: steps [t0, t0 + 16) of dt, x and dy
// for channels [d0, d0 + 32), of bt and ct, and the state before the chunk
// (zero for chunk 0); steps at or past S, channels past D and states past N
// are zero-filled
template <int SPT>
__device__ __forceinline__ void load_chunk(const Bwd& p, float* slot, int b,
                                           int d0, int i) {
  using T = Tile<SPT>;
  constexpr int NP = T::kNP;
  float* dts = slot;
  float* xs = dts + kChunk * kCh;
  float* dys = xs + kChunk * kCh;
  float* bs = dys + kChunk * kCh;
  float* cs = bs + kChunk * NP;
  float* h0s = cs + kChunk * NP;
  const int t0 = i * kChunk;
  const size_t row0 = (size_t)b * p.S;
  if (p.vec) {
    spread<kChunk * kCh / 4>([&](int k) {
      const int r = k / (kCh / 4), c = k % (kCh / 4) * 4, t = t0 + r;
      const bool in = t < p.S && d0 + c < p.D;
      const size_t off = in ? (row0 + t) * p.D + d0 + c : 0;
      cp_async16(dts + r * kCh + c, p.dt + off, in ? 16 : 0);
      cp_async16(xs + r * kCh + c, p.x + off, in ? 16 : 0);
      cp_async16(dys + r * kCh + c, p.dy + off, in ? 16 : 0);
    });
  } else {
    spread<kChunk * kCh>([&](int k) {
      const int r = k / kCh, c = k % kCh, t = t0 + r;
      const bool in = t < p.S && d0 + c < p.D;
      const size_t off = in ? (row0 + t) * p.D + d0 + c : 0;
      cp_async4(dts + r * kCh + c, p.dt + off, in ? 4 : 0);
      cp_async4(xs + r * kCh + c, p.x + off, in ? 4 : 0);
      cp_async4(dys + r * kCh + c, p.dy + off, in ? 4 : 0);
    });
  }
  if (p.bc_vec) {
    spread<kChunk * NP / 4>([&](int k) {
      const int r = k / (NP / 4), n = k % (NP / 4) * 4, t = t0 + r;
      const bool in = t < p.S && n < p.N;
      const size_t off = in ? (row0 + t) * p.N + n : 0;
      cp_async16(bs + r * NP + n, p.bt + off, in ? 16 : 0);
      cp_async16(cs + r * NP + n, p.ct + off, in ? 16 : 0);
    });
  } else {
    spread<kChunk * NP>([&](int k) {
      const int r = k / NP, n = k % NP, t = t0 + r;
      const bool in = t < p.S && n < p.N;
      const size_t off = in ? (row0 + t) * p.N + n : 0;
      cp_async4(bs + k, p.bt + off, in ? 4 : 0);
      cp_async4(cs + k, p.ct + off, in ? 4 : 0);
    });
  }
  spread<kCh * NP>([&](int k) {
    const int n = k / kCh, c = k % kCh;
    const bool in = i > 0 && d0 + c < p.D && n < p.N;
    const size_t off =
        in ? (((size_t)b * p.nch + i - 1) * p.D + d0 + c) * p.N + n : 0;
    cp_async4(h0s + k, p.hc + off, in ? 4 : 0);
  });
}

// for every (step r, state n) of the chunk, the sum over the 32 channels of
// v[r][n][c], in a fixed order (four partial sums over c mod 4, then
// paired); written to part (B, S, N) of this block where t < S and n < N
template <int SPT>
__device__ __forceinline__ void channel_sums(const Bwd& p, const float* v,
                                             float* part, int b, int t0) {
  constexpr int NP = Tile<SPT>::kNP;
  spread<kChunk * NP>([&](int k) {
    const int r = k / NP, n = k % NP;
    const float* vr = v + k * kPS;
    float q[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int c = 0; c < kCh; ++c) q[c & 3] += vr[c];
    const float s = (q[0] + q[1]) + (q[2] + q[3]);
    const int t = t0 + r;
    if (t < p.S && n < p.N)
      part[(((size_t)blockIdx.x * p.B + b) * p.S + t) * p.N + n] = s;
  });
}

template <int SPT>
__global__ void __launch_bounds__(kThreads, Tile<SPT>::kMinBlocks)
scan_bwd(const Bwd p) {
  using T = Tile<SPT>;
  constexpr int NP = T::kNP;
  extern __shared__ __align__(16) float smem[];
  float* ps = smem;                            // products [r][n][c]
  float* ring = ps + T::kProds;                // 2 slots
  float* pdx = ring + 2 * T::kSlot;            // [g][r][c]
  float* pddt = pdx + T::kPart;

  const int c = threadIdx.x & 31, g = threadIdx.x >> 5;
  const int d0 = blockIdx.x * kCh, d = d0 + c;
  const int b = blockIdx.y;
  const bool live = d < p.D;
  const int n0 = g * SPT;

  float a2[SPT], av[SPT], gh[SPT], da[SPT];
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

  load_chunk<SPT>(p, ring + ((p.nch - 1) & 1) * T::kSlot, b, d0, p.nch - 1);
  cp_async_commit();
  for (int i = p.nch - 1; i >= 0; --i) {
    // chunk i - 1 into the other slot, whose last readers finished before
    // the previous chunk's last barrier
    if (i > 0) {
      load_chunk<SPT>(p, ring + ((i - 1) & 1) * T::kSlot, b, d0, i - 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int t0 = i * kChunk;
    const float* dts = ring + (i & 1) * T::kSlot;
    const float* xs = dts + kChunk * kCh;
    const float* dys = xs + kChunk * kCh;
    const float* bs = dys + kChunk * kCh;
    const float* cs = bs + kChunk * NP;
    const float* h0s = cs + kChunk * NP;

    // the chunk's states, recomputed from the one before it and kept in
    // registers for the walk; their dC products dy_t h_t go to the slots
    float h0[SPT], hr[kChunk][SPT];
#pragma unroll
    for (int j = 0; j < SPT; ++j) h0[j] = h0s[(n0 + j) * kCh + c];
#pragma unroll
    for (int r = 0; r < kChunk; ++r) {
      const float dtv = dts[r * kCh + c];
      const float u = dtv * xs[r * kCh + c];
      const float dyv = dys[r * kCh + c];
#pragma unroll
      for (int j = 0; j < SPT; ++j) {
        const float hp = r > 0 ? hr[r - 1][j] : h0[j];
        hr[r][j] = fmaf(hp, ex2(dtv * a2[j]), u * bs[r * NP + n0 + j]);
        ps[(r * NP + n0 + j) * kPS + c] = dyv * hr[r][j];
      }
    }
    __syncthreads();
    // dC_t = sum_d dy_t h_t, before the walk reuses the slots
    channel_sums<SPT>(p, ps, p.dc_part, b, t0);
    __syncthreads();

    // back through the chunk; step r's dB product g_t dt_t x_t goes into
    // slot r
#pragma unroll
    for (int r = kChunk - 1; r >= 0; --r) {
      const float dtv = dts[r * kCh + c];
      const float xv = xs[r * kCh + c];
      const float dyv = dys[r * kCh + c];
      const float u = dtv * xv;
      float sgb = 0.f, gdt = 0.f;              // sum_n g B, sum_n g e h a
#pragma unroll
      for (int j = 0; j < SPT; ++j) {
        const float bv = bs[r * NP + n0 + j], cv = cs[r * NP + n0 + j];
        const float hp = r > 0 ? hr[r - 1][j] : h0[j];
        const float e = ex2(dtv * a2[j]);
        gh[j] = fmaf(dyv, cv, gh[j]);                // dL/dh_t
        sgb = fmaf(gh[j], bv, sgb);
        ps[(r * NP + n0 + j) * kPS + c] = gh[j] * u;
        const float ghe = gh[j] * e;                 // on to dL/dh_{t-1}
        const float ge = ghe * hp;                   // dL/d(dt a) before a
        gdt = fmaf(ge, av[j], gdt);
        da[j] = fmaf(ge, dtv, da[j]);
        gh[j] = ghe;
      }
      pdx[(g * kChunk + r) * kCh + c] = dtv * sgb;
      pddt[(g * kChunk + r) * kCh + c] = fmaf(xv, sgb, gdt);
    }
    __syncthreads();
    // dB of the chunk, and its dx and ddt: the warps' partials in warp
    // order; the next chunk's copies may start meanwhile (the slot is read)
    channel_sums<SPT>(p, ps, p.db_part, b, t0);
    spread<kChunk * kCh>([&](int k) {
      const int r = k / kCh, cc = k % kCh, t = t0 + r;
      if (t >= p.S || d0 + cc >= p.D) return;
      float sx = pdx[k], st = pddt[k];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) {
        sx += pdx[w * kChunk * kCh + k];
        st += pddt[w * kChunk * kCh + k];
      }
      const size_t off = ((size_t)b * p.S + t) * p.D + d0 + cc;
      p.dx[off] = sx;
      p.ddt[off] = st;
    });
  }
  if (!live) return;
#pragma unroll
  for (int j = 0; j < SPT; ++j)
    if (n0 + j < p.N)
      p.da_part[((size_t)b * p.D + d) * p.N + n0 + j] = da[j];
}

// dbt, dct and da from their partials, in one launch: each of the three
// outputs is (K, M) partials summed over k into M values.  A block takes 32
// consecutive outputs of one of them: lane l of warp w adds partials
// k = w, w + 8, ... of output l in order (eight loads in flight, each warp
// reading 128-byte rows), then thread l adds the eight warps' sums in warp
// order.
__global__ void __launch_bounds__(256)
sum_parts(const float* __restrict__ db_part, const float* __restrict__ dc_part,
          const float* __restrict__ da_part, float* __restrict__ dbt,
          float* __restrict__ dct, float* __restrict__ da, int nbd, int B,
          size_t bsn, size_t dn) {
  __shared__ float part_sums[8][32];
  const size_t nb = (bsn + 31) / 32;
  const size_t blk = blockIdx.x;
  const int which = blk < nb ? 0 : blk < 2 * nb ? 1 : 2;
  const float* part = which == 0 ? db_part : which == 1 ? dc_part : da_part;
  float* out = which == 0 ? dbt : which == 1 ? dct : da;
  const size_t M = which < 2 ? bsn : dn;
  const int K = which < 2 ? nbd : B;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const size_t i = 32 * (blk - which * nb) + lane;
  float s = 0.f;
  if (i < M) {
    int k = w;
    for (; k + 56 < K; k += 64) {
      float x[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) x[u] = part[(size_t)(k + 8 * u) * M + i];
#pragma unroll
      for (int u = 0; u < 8; ++u) s += x[u];
    }
    for (; k < K; k += 8) s += part[(size_t)k * M + i];
  }
  part_sums[w][lane] = s;
  __syncthreads();
  if (w == 0 && i < M) {
    float t = part_sums[0][lane];
#pragma unroll
    for (int u = 1; u < 8; ++u) t += part_sums[u][lane];
    out[i] = t;
  }
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
  p.vec = D % 4 == 0 &&
          ((uintptr_t)dt | (uintptr_t)x | (uintptr_t)dy) % 16 == 0;
  p.bc_vec = N % 4 == 0 && ((uintptr_t)bt | (uintptr_t)ct) % 16 == 0;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = N <= 16 ? run<2>(p, st) : run<4>(p, st);
  if (err != cudaSuccess) return (int)err;
  const int nbd = (D + kCh - 1) / kCh;
  const size_t bsn = (size_t)B * S * N, dn = (size_t)D * N;
  const size_t blocks = 2 * ((bsn + 31) / 32) + (dn + 31) / 32;
  sum_parts<<<(unsigned)blocks, 256, 0, st>>>(
      p.db_part, p.dc_part, p.da_part, (float*)dbt, (float*)dct, (float*)da,
      nbd, B, bsn, dn);
  return (int)cudaGetLastError();
}
