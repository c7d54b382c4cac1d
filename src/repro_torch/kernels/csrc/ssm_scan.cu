// Mamba-1 selective scan, for Hopper (sm_90a).
//
// Replaces repro/kernels/ssm_scan.py::ssm_scan (the Pallas kernel _kernel,
// pallas_call in ssm_scan):
//   h_t = exp(dt_t * A) * h_{t-1} + dt_t * x_t * B_t,   y_t = C_t . h_t
// per batch row b and channel d, with h (N,) starting at zero.  dt, x:
// (B, S, D); bt, ct: (B, S, N); a: (D, N); y: (B, S, D); all float32.  It
// also writes the final state h_S as h_last (B, D, N): the serving prefill
// seeds the decode cache with it, where the TPU kernel leaves its carry in
// VMEM scratch.  Given a non-null h_chunks (B, ceil(S / 16), D, N), it also
// writes the state after every 16 steps, from which the backward kernel
// (ssm_scan_bwd.cu) recomputes those steps' states; serving passes null.
//
// What bounds it: moving dt, x and y (12 bytes per (b, t, d)) at 3.35
// TB/s, and nearly as much the exponentials, one per (b, t, d, n): the
// special-function units run 16 per SM per clock, which alone would take
// a little longer than the bytes when N = 16.  Each exp here is one
// MUFU.EX2 and the instructions around it are kept few, so the FP32 pipe
// is left about half idle.
//
// Work split: a block covers 32 channels of one batch row over the whole
// sequence, lanes along d, so dt, x and y move in 128-byte rows, once each.
// Its four warps split the states: a thread holds SPT of its channel's
// states in registers (SPT = 4 for N <= 16, 8 for N <= 32).  A chunk of 32
// steps of dt and x for the block's channels, and of B_t and C_t, is staged
// in shared memory through a 3-slot cp.async ring, so two chunks are in
// flight while one is scanned.  y_t is an in-thread sum over the thread's
// states, held in registers through the chunk (so the compiler can hoist
// the next steps' loads); the four warps' partial sums meet in a double-buffered
// shared-memory tile, one barrier per chunk, and leave as 16-byte rows.
// The block's shape is fixed at compile time, so the staging and reduction
// loops unroll with no index division.
//
// exp(dt * a) is ex2.approx(dt * (a * log2 e)), with a prescaled once per
// thread.  The build's --fmad=false is global (the DP kernels' bit-identity
// rests on it), so the multiply-adds of the update and of y are explicit
// fmaf calls.  Steps past the sequence's end are staged as zeros, which
// makes them identity steps (exp(0) = 1, no input).  Any B (<= 65535), S
// and D; N <= 32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 32;         // steps staged per ring slot
constexpr int kKeep = 16;          // steps between the states kept in h_chunks
static_assert(kChunk % kKeep == 0, "a kept state falls inside a chunk");
constexpr int kStages = 3;         // ring slots
constexpr int kCh = 32;            // channels per block: one warp's lanes
constexpr int kWarps = 4;          // state groups per block
constexpr float kLog2e = 1.4426950408889634f;

struct Scan {
  const float* dt;
  const float* bt;
  const float* ct;
  const float* x;
  const float* a;
  float* y;
  float* h_last;
  float* h_chunks;  // (B, ceil(S / kKeep), D, N) kept states, or null
  int B, S, D, N;
  int vec;          // dt, x and y rows move as 16-byte copies
  int bc_vec;       // so do bt and ct rows
  int hc_vec;       // kept states leave as 16-byte rows
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

// The block's shape: kWarps warps (state groups) of SPT states over the
// same 32 channels; a staged B_t / C_t row holds NP = kWarps * SPT states
// (16 or 32).
template <int SPT>
struct Tile {
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kNP = kWarps * SPT;
  static constexpr int kSlot = 2 * kChunk * (kCh + kNP);  // floats a slot
  static constexpr int kPart = kChunk * kCh;              // one group's y
};

// body(i) for i in [0, n) spread over the block's threads, unrolled
template <int kThreads, int n, typename F>
__device__ __forceinline__ void spread(F body) {
#pragma unroll
  for (int k = 0; k < (n + kThreads - 1) / kThreads; ++k) {
    const int i = threadIdx.x + k * kThreads;
    if (n % kThreads == 0 || i < n) body(i);
  }
}

// steps [t0, t0 + kChunk) of dt and x for channels [d0, d0 + 32), and of
// bt and ct, into one ring slot; steps at or past S, channels past D and
// states past N are zero-filled
template <int SPT>
__device__ __forceinline__ void load_chunk(const Scan& p, float* slot, int b,
                                           int d0, int t0) {
  using T = Tile<SPT>;
  float* dts = slot;
  float* xs = dts + kChunk * kCh;
  float* bs = xs + kChunk * kCh;
  float* cs = bs + kChunk * T::kNP;
  const size_t row0 = (size_t)b * p.S;
  if (p.vec) {
    spread<T::kThreads, kChunk * kCh / 4>([&](int i) {
      const int r = i / (kCh / 4), c = i % (kCh / 4) * 4, t = t0 + r;
      const bool in = t < p.S && d0 + c < p.D;
      const size_t off = in ? (row0 + t) * p.D + d0 + c : 0;
      cp_async16(dts + r * kCh + c, p.dt + off, in ? 16 : 0);
      cp_async16(xs + r * kCh + c, p.x + off, in ? 16 : 0);
    });
  } else {
    spread<T::kThreads, kChunk * kCh>([&](int i) {
      const int r = i / kCh, c = i % kCh, t = t0 + r;
      const bool in = t < p.S && d0 + c < p.D;
      const size_t off = in ? (row0 + t) * p.D + d0 + c : 0;
      cp_async4(dts + i, p.dt + off, in ? 4 : 0);
      cp_async4(xs + i, p.x + off, in ? 4 : 0);
    });
  }
  if (p.bc_vec) {
    spread<T::kThreads, kChunk * T::kNP / 4>([&](int i) {
      const int r = i / (T::kNP / 4), k = i % (T::kNP / 4) * 4, t = t0 + r;
      const bool in = t < p.S && k < p.N;
      const size_t off = in ? (row0 + t) * p.N + k : 0;
      cp_async16(bs + r * T::kNP + k, p.bt + off, in ? 16 : 0);
      cp_async16(cs + r * T::kNP + k, p.ct + off, in ? 16 : 0);
    });
  } else {
    spread<T::kThreads, kChunk * T::kNP>([&](int i) {
      const int r = i / T::kNP, k = i % T::kNP, t = t0 + r;
      const bool in = t < p.S && k < p.N;
      const size_t off = in ? (row0 + t) * p.N + k : 0;
      cp_async4(bs + i, p.bt + off, in ? 4 : 0);
      cp_async4(cs + i, p.ct + off, in ? 4 : 0);
    });
  }
}

// y rows [t0, t0 + kChunk) of the block's channels: the kWarps groups'
// partial sums added in group order, four channels at a time, stored as rows
template <int SPT>
__device__ __forceinline__ void store_y(const Scan& p, const float* part,
                                        int b, int d0, int t0) {
  using T = Tile<SPT>;
  spread<T::kThreads, kChunk * kCh / 4>([&](int i) {
    const int r = i / (kCh / 4), c = i % (kCh / 4) * 4, t = t0 + r;
    const int d = d0 + c;
    if (t >= p.S || d >= p.D) return;
    float4 s = *reinterpret_cast<const float4*>(part + r * kCh + c);
#pragma unroll
    for (int g = 1; g < kWarps; ++g) {
      const float4 q = *reinterpret_cast<const float4*>(
          part + g * T::kPart + r * kCh + c);
      s.x += q.x; s.y += q.y; s.z += q.z; s.w += q.w;
    }
    float* dst = p.y + ((size_t)b * p.S + t) * p.D + d;
    if (p.vec) {
      *reinterpret_cast<float4*>(dst) = s;
    } else {
      dst[0] = s.x;
      if (d + 1 < p.D) dst[1] = s.y;
      if (d + 2 < p.D) dst[2] = s.z;
      if (d + 3 < p.D) dst[3] = s.w;
    }
  });
}

template <int SPT>
__device__ __forceinline__ void load_row(float (&v)[SPT], const float* src) {
  static_assert(SPT % 4 == 0, "a thread's states load as 16-byte rows");
#pragma unroll
  for (int j = 0; j < SPT; j += 4) {
    const float4 q = *reinterpret_cast<const float4*>(src + j);
    v[j] = q.x; v[j + 1] = q.y; v[j + 2] = q.z; v[j + 3] = q.w;
  }
}

// Warp g holds states [g * SPT, (g + 1) * SPT) of the block's 32 channels
// and walks the whole sequence from a zero state.
template <int SPT>
__global__ void __launch_bounds__(32 * kWarps)
scan_kernel(const Scan p) {
  using T = Tile<SPT>;
  extern __shared__ __align__(16) float smem[];
  const int c = threadIdx.x & 31, g = threadIdx.x >> 5;
  const int d0 = blockIdx.x * kCh, d = d0 + c;
  const int b = blockIdx.y;
  const bool live = d < p.D;
  const int n0 = g * SPT;
  float* ys = smem + kStages * T::kSlot;

  float a2[SPT], h[SPT];
#pragma unroll
  for (int j = 0; j < SPT; ++j) {
    const int n = n0 + j;
    a2[j] = live && n < p.N ? p.a[(size_t)d * p.N + n] * kLog2e : 0.f;
    h[j] = 0.f;
  }

  const int nch = (p.S + kChunk - 1) / kChunk;
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < nch) load_chunk<SPT>(p, smem + i * T::kSlot, b, d0, i * kChunk);
    cp_async_commit();
  }
  for (int i = 0; i < nch; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int nx = i + kStages - 1;
    if (nx < nch)
      load_chunk<SPT>(p, smem + (nx % kStages) * T::kSlot, b, d0,
                      nx * kChunk);
    cp_async_commit();
    if (i > 0)
      store_y<SPT>(p, ys + ((i - 1) & 1) * kWarps * T::kPart, b, d0,
                   (i - 1) * kChunk);
    const float* dts = smem + (i % kStages) * T::kSlot + c;
    const float* xs = dts + kChunk * kCh;
    const float* bs = smem + (i % kStages) * T::kSlot + 2 * kChunk * kCh + n0;
    const float* cs = bs + kChunk * T::kNP;
    // y_t stays in registers until the chunk ends: a shared-memory store
    // between the steps would keep the compiler from hoisting the next
    // steps' loads above it
    float yv[kChunk];
    float hk[kChunk / kKeep - 1][SPT];   // the chunk's inner kept states
#pragma unroll
    for (int r = 0; r < kChunk; ++r) {
      const float dtv = dts[r * kCh];
      const float u = dtv * xs[r * kCh];
      float bv[SPT], cv[SPT];
      load_row<SPT>(bv, bs + r * T::kNP);
      load_row<SPT>(cv, cs + r * T::kNP);
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < SPT; ++j) {
        h[j] = fmaf(h[j], ex2(dtv * a2[j]), u * bv[j]);
        acc = fmaf(h[j], cv[j], acc);
      }
      yv[r] = acc;
      if (r % kKeep == kKeep - 1 && r < kChunk - 1) {
#pragma unroll
        for (int j = 0; j < SPT; ++j) hk[r / kKeep][j] = h[j];
      }
    }
    float* yo = ys + (i & 1) * kWarps * T::kPart + g * T::kPart + c;
#pragma unroll
    for (int r = 0; r < kChunk; ++r) yo[r * kCh] = yv[r];
    if (p.h_chunks != nullptr && live) {
      const int nkeep = (p.S + kKeep - 1) / kKeep;
#pragma unroll
      for (int m = 0; m < kChunk / kKeep; ++m) {
        const int k = i * (kChunk / kKeep) + m;
        if (k >= nkeep) break;
        float* hc = p.h_chunks + (((size_t)b * nkeep + k) * p.D + d) * p.N;
        auto v = [&](int j) {
          return m < kChunk / kKeep - 1 ? hk[m][j] : h[j];
        };
        if (p.hc_vec) {
#pragma unroll
          for (int j = 0; j < SPT; j += 4)
            if (n0 + j < p.N)
              *reinterpret_cast<float4*>(hc + n0 + j) =
                  make_float4(v(j), v(j + 1), v(j + 2), v(j + 3));
        } else {
#pragma unroll
          for (int j = 0; j < SPT; ++j)
            if (n0 + j < p.N) hc[n0 + j] = v(j);
        }
      }
    }
  }
  if (nch > 0) {
    __syncthreads();
    store_y<SPT>(p, ys + ((nch - 1) & 1) * kWarps * T::kPart, b, d0,
                 (nch - 1) * kChunk);
  }
  if (!live) return;
  float* out = p.h_last + ((size_t)b * p.D + d) * p.N;
#pragma unroll
  for (int j = 0; j < SPT; ++j)
    if (n0 + j < p.N) out[n0 + j] = h[j];
}

template <int SPT>
cudaError_t run(const Scan& p, cudaStream_t st) {
  using T = Tile<SPT>;
  const size_t smem =
      sizeof(float) * (kStages * T::kSlot + 2 * kWarps * T::kPart);
  auto kern = scan_kernel<SPT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.D + kCh - 1) / kCh, p.B);
  kern<<<grid, T::kThreads, smem, st>>>(p);
  return cudaGetLastError();
}

}  // namespace

// h_chunks may be null.  Returns a cudaError_t.
extern "C" int ssm_scan(const void* dt, const void* bt, const void* ct,
                        const void* x, const void* a, void* y, void* h_last,
                        void* h_chunks, int B, int S, int D, int N,
                        void* stream) {
  if (B == 0 || D == 0 || N == 0) return 0;
  if (N > 32 || B > 65535) return (int)cudaErrorInvalidValue;
  Scan p;
  p.dt = (const float*)dt;
  p.bt = (const float*)bt;
  p.ct = (const float*)ct;
  p.x = (const float*)x;
  p.a = (const float*)a;
  p.y = (float*)y;
  p.h_last = (float*)h_last;
  p.h_chunks = (float*)h_chunks;
  p.B = B; p.S = S; p.D = D; p.N = N;
  p.vec = D % 4 == 0 &&
          ((uintptr_t)dt | (uintptr_t)x | (uintptr_t)y) % 16 == 0;
  p.bc_vec = N % 4 == 0 && ((uintptr_t)bt | (uintptr_t)ct) % 16 == 0;
  p.hc_vec = N % 4 == 0 && (uintptr_t)h_chunks % 16 == 0;
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(N <= 16 ? run<4>(p, st) : run<8>(p, st));
}
