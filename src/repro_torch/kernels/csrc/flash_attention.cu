// Flash attention (online softmax) with grouped KV heads, for Hopper (sm_90a).
//
// Replaces repro/kernels/flash_attention.py::flash_attention (the Pallas
// kernel _kernel, pallas_call in flash_attention) together with the
// reference wrapper kernels/ops.py::flash_attention_gqa.  For every query row
//   o = softmax(scale * q k^T + mask) v
// with the causal mask (key > query) and/or the sliding window (query - key
// >= window) set to -1e30, a running max, denominator and accumulator in
// float32, and the denominator clamped at 1e-20, as the TPU kernel does.
// q: (B, S, H, hd); k, v: (B, S, KV, hd); o: (B, S, H, hd) in q's type
// (float32 or bfloat16).  Query head h reads KV head h / (H / KV), so the
// reference wrapper's jnp.repeat of the KV heads is never materialised.
//
// Work split: one block of 256 threads per (batch * head, 64-query tile).
// A loop over 64-key tiles takes the place of the TPU's sequential KV grid
// axis: the block stages the tile's K and V in shared memory (as float32,
// rows padded by one float so that column reads hit distinct banks),
// computes the 64 x 64 scores (each thread 4 rows x 4 columns, rows
// ty + 16 i, columns tx + 16 j), reduces each row's max and sum across the
// 16 threads that hold it with shuffles, stores P in shared memory and adds
// P V into its registers (4 rows x hd / 16 columns).  Key tiles wholly above
// the diagonal (causal) or wholly outside the window are skipped: they
// contribute exactly zero after the online-softmax correction.  Any S is
// taken: keys past S are masked and zero-filled, rows past S are not
// written.  hd is a template parameter (64, 128 or 256).
//
// What bounds it: operations.  Causal prefill does 4 * S^2 * hd / 2 flops
// per head against 4 * S * hd * 4 bytes of q, k, v and o, hundreds of flops
// per byte, far above the card's ridge.  This first version runs them on the
// CUDA cores in float32 with explicit fused multiply-adds (the shared build
// flag --fmad=false forbids only the compiler's own contraction), reading
// both operands from shared memory; wgmma and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;           // query rows per block
constexpr int kBK = 64;           // keys per tile
constexpr int kThreads = 256;     // 16 x 16 threads
constexpr float kMaskValue = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float half_warp_max(float v) {
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)(kBQ + 2 * kBK) * (HD + 1) +
                          (size_t)kBQ * (kBK + 1));
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int S, int H, int KV,
             int causal, int window, float scale) {
  constexpr int HP = HD + 1;      // padded row of q, k, v in shared memory
  constexpr int PP = kBK + 1;     // padded row of P
  constexpr int ND = HD / 16;     // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;               // [kBQ][HP]
  float* ks = qs + kBQ * HP;      // [kBK][HP]
  float* vs = ks + kBK * HP;      // [kBK][HP]
  float* ps = vs + kBK * HP;      // [kBQ][PP]

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const size_t q_row = (size_t)H * HD, kv_row = (size_t)KV * HD;
  const T* qb = q + ((size_t)b * S * H + h) * HD;
  const T* kb = k + ((size_t)b * S * KV + kvh) * HD;
  const T* vb = v + ((size_t)b * S * KV + kvh) * HD;

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD, qp = q0 + r;
    qs[r * HP + d] = qp < S ? to_f32(qb[qp * q_row + d]) : 0.f;
  }

  float m[4], l[4], acc[4][ND];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMaskValue;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < ND; ++j) acc[i][j] = 0.f;
  }

  // key tiles that hold a visible key for some row of this query tile
  const int q_last = min(q0 + kBQ, S) - 1;
  const int kt_hi = causal ? q_last / kBK + 1 : (S + kBK - 1) / kBK;
  const int kt_lo = window > 0 ? max(0, q0 - window + 1) / kBK : 0;

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();              // the last tile's ks, vs and ps are done
    for (int i = tid; i < kBK * HD; i += kThreads) {
      const int c = i / HD, d = i % HD, kp = k0 + c;
      const bool in = kp < S;
      ks[c * HP + d] = in ? to_f32(kb[kp * kv_row + d]) : 0.f;
      vs[c * HP + d] = in ? to_f32(vb[kp * kv_row + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * HP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * HP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, qp = q0 + r;
      float mx = kMaskValue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        const bool masked = kp >= S || (causal && kp > qp) ||
                            (window > 0 && qp - kp >= window);
        // the reference adds -1e30, which absorbs any finite score
        s[i][j] = masked ? kMaskValue : s[i][j] * scale;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[r * PP + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = fmaf(l[i], corr, half_warp_sum(sum));
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < ND; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 2
    for (int c = 0; c < kBK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 16 * i) * PP + c];
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        const float vv = vs[c * HP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

  T* ob = o + ((size_t)b * S * H + h) * HD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= S) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-20f);
#pragma unroll
    for (int j = 0; j < ND; ++j)
      ob[qp * q_row + tx + 16 * j] = from_f32<T>(acc[i][j] * inv);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int H, int KV, int causal, int window, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kBQ - 1) / kBQ, B * H);
  flash_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, S, H, KV, causal, window,
      scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(const void* q, const void* k, const void* v, void* o, int B,
                int S, int H, int KV, int hd, int causal, int window,
                float scale, cudaStream_t stream) {
  switch (hd) {
    case 64:
      return launch<T, 64>(q, k, v, o, B, S, H, KV, causal, window, scale,
                           stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, S, H, KV, causal, window, scale,
                            stream);
    case 256:
      return launch<T, 256>(q, k, v, o, B, S, H, KV, causal, window, scale,
                            stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  Returns a cudaError_t.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int B, int S, int H, int KV, int hd,
                               int dtype, int causal, int window, double scale,
                               void* stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  if (KV <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch_hd<float>(q, k, v, o, B, S, H, KV, hd, causal, window,
                              (float)scale, st);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(q, k, v, o, B, S, H, KV, hd, causal,
                                      window, (float)scale, st);
  return (int)cudaErrorInvalidValue;
}
