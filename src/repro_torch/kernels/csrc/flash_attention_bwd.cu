// Backward of flash attention with grouped KV heads, for Hopper (sm_90a),
// on the CUDA cores in float32.
//
// Differentiates repro/kernels/flash_attention.py::flash_attention (the
// forward this port runs as csrc/flash_attention.cu).  The reference has no
// backward kernel: its training differentiates plain jnp attention
// (models/layers.py::attention) with jax.grad.  For every query row i and
// key j with s_ij = scale * q_i . k_j, P = softmax(s + mask) and the
// forward's row log-sum-exp lse_i:
//   P_ij  = exp(s_ij - lse_i)                       (0 where masked)
//   D_i   = dO_i . O_i
//   dS_ij = P_ij * (dO_i . v_j - D_i)
//   dq_i  = scale * sum_j dS_ij k_j
//   dk_j  = scale * sum_i dS_ij q_i,   dv_j = sum_i P_ij dO_i
// with the forward's causal (key > query) and window (query - key >= window)
// masks, scale and GQA grouping: query head h reads KV head h / (H / KV), and
// dk, dv of a KV head sum over its H / KV query heads inside the kernel.
// q, dq: (B, S, H, hd); k, v, dk, dv: (B, S, KV, hd); o, dO in q's type
// (float32 or bfloat16); lse: (B, H, S) float32; all sums in float32.
//
// Three launches on the caller's stream, none with atomics, so two calls on
// the same inputs give bit-identical results:
//   row_dot   D_i, one warp per row, a fixed butterfly over the lanes;
//   dq_kernel one block per (batch * head, 32-query tile) walks the key
//             tiles its rows see, recomputing P and dS from lse and D;
//   dkv_kernel one block per (batch * KV head, 32-key tile) walks the query
//             heads of the group and the query tiles that see its keys.
// A block of 256 threads holds its tiles in shared memory as float32 (rows
// padded to hd + 4 floats, so the 16-byte reads of a quarter warp fall in
// distinct banks).  Thread (r, c) of a 32 x 32 score tile computes entries
// (r, c + 8 m), m < 4, of s and dO V^T as 16-byte dot-product steps; P and
// dS go through shared memory to the accumulation, where a thread owns one
// output row and hd / 8 columns (four adjacent per 32), accumulated in
// registers over the whole walk.  The build's --fmad=false is global, so
// the multiply-adds are explicit fmaf calls.
//
// What bounds it: operations.  Causal, the backward does 2.5 times the
// forward's products (s, dO V^T, dq, dk, dv) and this design recomputes s and
// dO V^T once more in the dq pass: 7 * 2 * hd flops per visible (query, key)
// pair per head.  On the CUDA cores its least time is that over the float32
// rate; it is held further back by shared-memory reads (one 16-byte read
// per four multiply-adds in the score step).  Tensor-core products (3xTF32
// and bf16 mma, as the forward) are the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 32;            // query rows of a tile
constexpr int kBK = 32;            // keys of a tile
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Shared-memory layout of one block: four (32, hd) float tiles with rows of
// RS floats, then the P and dS tiles (32 x 33) and two per-row vectors.
template <int HD>
struct Smem {
  static constexpr int RS = HD + 4;
  static constexpr int PS = kBK + 1;
  static constexpr size_t floats =
      4 * (size_t)kBQ * RS + 2 * (size_t)kBQ * PS + 2 * kBQ;
  static constexpr size_t bytes = sizeof(float) * floats;
};

// rows row0 .. row0 + 31 of a (S, gstride) tensor as float into a (32, RS)
// tile; rows at or past S are zero
template <typename T, int HD>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          size_t gstride, int row0, int S) {
  constexpr int RS = Smem<HD>::RS;
  for (int i = threadIdx.x; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, c = i % HD, gr = row0 + r;
    dst[r * RS + c] = gr < S ? to_f(src[(size_t)gr * gstride + c]) : 0.f;
  }
}

// s[m] = a_r . b_{c + 8m} and t[m] = a2_r . b2_{c + 8m} over hd, in 16-byte
// steps (rows r of tiles a and a2, rows c + 8m of tiles b and b2)
template <int HD>
__device__ __forceinline__ void two_dots(float (&s)[4], float (&t)[4],
                                         const float* a, const float* a2,
                                         const float* b, const float* b2,
                                         int r, int c) {
  constexpr int RS = Smem<HD>::RS;
#pragma unroll
  for (int m = 0; m < 4; ++m) s[m] = t[m] = 0.f;
  const float* ar = a + r * RS;
  const float* a2r = a2 + r * RS;
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    const float4 x = *reinterpret_cast<const float4*>(ar + d);
    const float4 y = *reinterpret_cast<const float4*>(a2r + d);
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const float4 u = *reinterpret_cast<const float4*>(b + (c + 8 * m) * RS + d);
      const float4 w = *reinterpret_cast<const float4*>(b2 + (c + 8 * m) * RS + d);
      s[m] = fmaf(x.x, u.x, s[m]);
      s[m] = fmaf(x.y, u.y, s[m]);
      s[m] = fmaf(x.z, u.z, s[m]);
      s[m] = fmaf(x.w, u.w, s[m]);
      t[m] = fmaf(y.x, w.x, t[m]);
      t[m] = fmaf(y.y, w.y, t[m]);
      t[m] = fmaf(y.z, w.z, t[m]);
      t[m] = fmaf(y.w, w.w, t[m]);
    }
  }
}

__device__ __forceinline__ bool masked(int qp, int kp, int S, int causal,
                                       int window) {
  return qp >= S || kp >= S || (causal && kp > qp) ||
         (window > 0 && qp - kp >= window);
}

// P and dS of one 32 x 32 tile (query rows q0.., keys k0..) into shared
// memory, from the score tile's dot products, lse (log2 units) and D
template <int HD>
__device__ __forceinline__ void p_ds_tile(float* ps, float* dss,
                                          const float (&s)[4],
                                          const float (&dp)[4],
                                          const float* lse2s,
                                          const float* dls, int r, int c,
                                          int q0, int k0, int S, int causal,
                                          int window, float scale_log2) {
  constexpr int PS = Smem<HD>::PS;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int kc = c + 8 * m;
    float p = 0.f;
    if (!masked(q0 + r, k0 + kc, S, causal, window))
      p = exp2f(s[m] * scale_log2 - lse2s[r]);
    ps[r * PS + kc] = p;
    dss[r * PS + kc] = p * (dp[m] - dls[r]);
  }
}

// D_i = dO_i . O_i for every (b, s, h) row, one warp per row
template <typename T>
__global__ void __launch_bounds__(kThreads)
row_dot(const T* __restrict__ o, const T* __restrict__ dout,
        float* __restrict__ dl, int rows, int S, int H, int hd) {
  const int w = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (w >= rows) return;
  // row w is (b, s, h) of the (B, S, H, hd) layout
  const size_t off = (size_t)w * hd;
  float acc = 0.f;
  for (int c = lane; c < hd; c += 32)
    acc = fmaf(to_f(o[off + c]), to_f(dout[off + c]), acc);
#pragma unroll
  for (int x = 16; x > 0; x >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, x);
  if (lane == 0) {
    const int h = w % H, s = (w / H) % S, b = w / (H * S);
    dl[((size_t)b * H + h) * S + s] = acc;
  }
}

// dq of one (batch * head, query tile)
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ dl,
          T* __restrict__ dq, int S, int H, int KV, int causal, int window,
          float scale, float scale_log2) {
  using L = Smem<HD>;
  constexpr int RS = L::RS, PS = L::PS, NC = HD / 32;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                   // [32][RS]
  float* dos = qs + kBQ * RS;
  float* ks = dos + kBQ * RS;
  float* vs = ks + kBK * RS;
  float* ps = vs + kBK * RS;          // [32][PS]
  float* dss = ps + kBQ * PS;
  float* lse2s = dss + kBQ * PS;      // [32]
  float* dls = lse2s + kBQ;

  const int bh = blockIdx.y, b = bh / H, h = bh % H, kvh = h / (H / KV);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;    // heaviest first
  const int r = threadIdx.x >> 3, c = threadIdx.x & 7;
  const size_t q_row = (size_t)H * HD, kv_row = (size_t)KV * HD;
  const T* kb = k + ((size_t)b * S * KV + kvh) * HD;
  const T* vb = v + ((size_t)b * S * KV + kvh) * HD;

  load_rows<T, HD>(qs, q + ((size_t)b * S * H + h) * HD, q_row, q0, S);
  load_rows<T, HD>(dos, dout + ((size_t)b * S * H + h) * HD, q_row, q0, S);
  if (threadIdx.x < kBQ) {
    const int qp = q0 + threadIdx.x;
    const bool in = qp < S;
    lse2s[threadIdx.x] = in ? lse[(size_t)bh * S + qp] * kLog2e : 0.f;
    dls[threadIdx.x] = in ? dl[(size_t)bh * S + qp] : 0.f;
  }

  float acc[NC][4];
#pragma unroll
  for (int n = 0; n < NC; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  // the key tiles that hold a key some row of the tile sees
  const int q_last = min(q0 + kBQ, S) - 1;
  const int hi = causal ? q_last / kBK + 1 : (S + kBK - 1) / kBK;
  const int lo = window > 0 ? max(0, q0 - window + 1) / kBK : 0;
  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();                  // the last tile's readers are done
    load_rows<T, HD>(ks, kb, kv_row, k0, S);
    load_rows<T, HD>(vs, vb, kv_row, k0, S);
    __syncthreads();
    float s[4], dp[4];
    two_dots<HD>(s, dp, qs, dos, ks, vs, r, c);
    p_ds_tile<HD>(ps, dss, s, dp, lse2s, dls, r, c, q0, k0, S, causal,
                  window, scale_log2);
    __syncthreads();
    // dq[r][cols] += sum_j dS[r][j] k_j[cols]; cols 32 n + 4 c + e
    for (int j = 0; j < kBK; ++j) {
      const float ds = dss[r * PS + j];
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        const float4 kk =
            *reinterpret_cast<const float4*>(ks + j * RS + 32 * n + 4 * c);
        acc[n][0] = fmaf(ds, kk.x, acc[n][0]);
        acc[n][1] = fmaf(ds, kk.y, acc[n][1]);
        acc[n][2] = fmaf(ds, kk.z, acc[n][2]);
        acc[n][3] = fmaf(ds, kk.w, acc[n][3]);
      }
    }
  }
  const int qp = q0 + r;
  if (qp >= S) return;
  T* out = dq + ((size_t)b * S + qp) * q_row + (size_t)h * HD;
#pragma unroll
  for (int n = 0; n < NC; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) from_f(out + 32 * n + 4 * c + e,
                                       acc[n][e] * scale);
}

// dk and dv of one (batch * KV head, key tile), summed over the group's
// query heads
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const T* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ dl,
           T* __restrict__ dk, T* __restrict__ dv, int S, int H, int KV,
           int causal, int window, float scale, float scale_log2) {
  using L = Smem<HD>;
  constexpr int RS = L::RS, PS = L::PS, NC = HD / 32;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* dos = qs + kBQ * RS;
  float* ks = dos + kBQ * RS;
  float* vs = ks + kBK * RS;
  float* ps = vs + kBK * RS;
  float* dss = ps + kBQ * PS;
  float* lse2s = dss + kBQ * PS;
  float* dls = lse2s + kBQ;

  const int bk = blockIdx.y, b = bk / KV, kvh = bk % KV, G = H / KV;
  const int k0 = blockIdx.x * kBK;
  const int r = threadIdx.x >> 3, c = threadIdx.x & 7;
  const size_t q_row = (size_t)H * HD, kv_row = (size_t)KV * HD;
  load_rows<T, HD>(ks, k + ((size_t)b * S * KV + kvh) * HD, kv_row, k0, S);
  load_rows<T, HD>(vs, v + ((size_t)b * S * KV + kvh) * HD, kv_row, k0, S);

  float adk[NC][4], adv[NC][4];
#pragma unroll
  for (int n = 0; n < NC; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[n][e] = adv[n][e] = 0.f;

  // the query tiles with a row that sees a key of the tile
  const int k_last = min(k0 + kBK, S) - 1;
  const int lo = causal ? k0 / kBQ : 0;
  const int hi = window > 0 ? min(S - 1, k_last + window - 1) / kBQ + 1
                            : (S + kBQ - 1) / kBQ;
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g, bh = b * H + h;
    const T* qb = q + ((size_t)b * S * H + h) * HD;
    const T* db = dout + ((size_t)b * S * H + h) * HD;
    for (int qt = lo; qt < hi; ++qt) {
      const int q0 = qt * kBQ;
      __syncthreads();
      load_rows<T, HD>(qs, qb, q_row, q0, S);
      load_rows<T, HD>(dos, db, q_row, q0, S);
      if (threadIdx.x < kBQ) {
        const int qp = q0 + threadIdx.x;
        const bool in = qp < S;
        lse2s[threadIdx.x] = in ? lse[(size_t)bh * S + qp] * kLog2e : 0.f;
        dls[threadIdx.x] = in ? dl[(size_t)bh * S + qp] : 0.f;
      }
      __syncthreads();
      float s[4], dp[4];
      two_dots<HD>(s, dp, qs, dos, ks, vs, r, c);
      p_ds_tile<HD>(ps, dss, s, dp, lse2s, dls, r, c, q0, k0, S, causal,
                    window, scale_log2);
      __syncthreads();
      // key row r: dv += sum_i P[i][r] dO_i, dk += sum_i dS[i][r] q_i
      for (int i = 0; i < kBQ; ++i) {
        const float p = ps[i * PS + r], ds = dss[i * PS + r];
#pragma unroll
        for (int n = 0; n < NC; ++n) {
          const int col = 32 * n + 4 * c;
          const float4 od = *reinterpret_cast<const float4*>(dos + i * RS + col);
          const float4 qq = *reinterpret_cast<const float4*>(qs + i * RS + col);
          adv[n][0] = fmaf(p, od.x, adv[n][0]);
          adv[n][1] = fmaf(p, od.y, adv[n][1]);
          adv[n][2] = fmaf(p, od.z, adv[n][2]);
          adv[n][3] = fmaf(p, od.w, adv[n][3]);
          adk[n][0] = fmaf(ds, qq.x, adk[n][0]);
          adk[n][1] = fmaf(ds, qq.y, adk[n][1]);
          adk[n][2] = fmaf(ds, qq.z, adk[n][2]);
          adk[n][3] = fmaf(ds, qq.w, adk[n][3]);
        }
      }
    }
  }
  const int kp = k0 + r;
  if (kp >= S) return;
  const size_t off = ((size_t)b * S + kp) * kv_row + (size_t)kvh * HD;
#pragma unroll
  for (int n = 0; n < NC; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      from_f(dk + off + 32 * n + 4 * c + e, adk[n][e] * scale);
      from_f(dv + off + 32 * n + 4 * c + e, adv[n][e]);
    }
}

template <typename T, int HD>
int run(const void* q, const void* k, const void* v, const void* o,
        const void* dout, const float* lse, float* dl, void* dq, void* dk,
        void* dv, int B, int S, int H, int KV, int causal, int window,
        float scale, cudaStream_t st) {
  using L = Smem<HD>;
  const int rows = B * S * H;
  row_dot<T><<<(rows + kThreads / 32 - 1) / (kThreads / 32), kThreads, 0,
               st>>>((const T*)o, (const T*)dout, dl, rows, S, H, HD);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const float sl2 = scale * kLog2e;
  auto kq = dq_kernel<T, HD>;
  err = cudaFuncSetAttribute(kq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)L::bytes);
  if (err != cudaSuccess) return (int)err;
  const int nt = (S + kBQ - 1) / kBQ;
  kq<<<dim3(nt, B * H), kThreads, L::bytes, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, dl, (T*)dq,
      S, H, KV, causal, window, scale, sl2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  auto kkv = dkv_kernel<T, HD>;
  err = cudaFuncSetAttribute(kkv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)L::bytes);
  if (err != cudaSuccess) return (int)err;
  kkv<<<dim3((S + kBK - 1) / kBK, B * KV), kThreads, L::bytes, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, dl, (T*)dk,
      (T*)dv, S, H, KV, causal, window, scale, sl2);
  return (int)cudaGetLastError();
}

template <typename T>
int run_hd(int hd, const void* q, const void* k, const void* v,
           const void* o, const void* dout, const float* lse, float* dl,
           void* dq, void* dk, void* dv, int B, int S, int H, int KV,
           int causal, int window, float scale, cudaStream_t st) {
  switch (hd) {
    case 64:
      return run<T, 64>(q, k, v, o, dout, lse, dl, dq, dk, dv, B, S, H, KV,
                        causal, window, scale, st);
    case 128:
      return run<T, 128>(q, k, v, o, dout, lse, dl, dq, dk, dv, B, S, H, KV,
                         causal, window, scale, st);
    case 256:
      return run<T, 256>(q, k, v, o, dout, lse, dl, dq, dk, dv, B, S, H, KV,
                         causal, window, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  dl is (B, H, S) float32 scratch.  Returns
// a cudaError_t.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const void* lse,
                                   void* dl, void* dq, void* dk, void* dv,
                                   int B, int S, int H, int KV, int hd,
                                   int dtype, int causal, int window,
                                   double scale, void* stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  if (KV <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const float sc = (float)scale;
  if (dtype == 0)
    return run_hd<float>(hd, q, k, v, o, dout, (const float*)lse,
                         (float*)dl, dq, dk, dv, B, S, H, KV, causal, window,
                         sc, st);
  if (dtype == 1)
    return run_hd<__nv_bfloat16>(hd, q, k, v, o, dout, (const float*)lse,
                                 (float*)dl, dq, dk, dv, B, S, H, KV, causal,
                                 window, sc, st);
  return (int)cudaErrorInvalidValue;
}
