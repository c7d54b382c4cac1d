// Flash attention (online softmax) with grouped KV heads, for Hopper (sm_90a),
// on the tensor cores through mma.sync.
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
// Given a non-null lse (B, H, S) float32, it also writes each row's
// log-sum-exp of the scaled, masked scores (natural log), which the
// backward kernel (flash_attention_bwd.cu) needs; serving passes null.
//
// Work split: one block of 4 warps per (batch * head, query tile), the
// heaviest causal tiles launched first.  A warp owns MT m16 tiles of query
// rows, so that each K and V fragment it reads feeds MT products: MT = 2
// (128-row query tiles) for float32 at hd 64 and 128 and for bf16 at hd 64,
// MT = 1 (64 rows) elsewhere, where the registers would not hold two.  A
// loop over key tiles (64 keys; 32 for float32 at hd 128 and 256, to fit
// shared memory and registers) takes the place of the TPU's sequential KV
// grid axis.  The next tile's K and V are brought into a 2-stage
// shared-memory ring with 16-byte cp.async.cg copies, issued before the
// current tile's math so that the loads overlap it; keys past S are
// zero-filled by the copy.  S = Q K^T and O += P V are mma.sync products
// with float32 accumulators in registers, issued in passes over all of a
// warp's accumulators so that consecutive products do not wait on one
// another.  The online softmax runs on the accumulator fragments (row max
// reduced across the 4 threads of a quad with shuffles, one exp2f per score
// on scores prescaled by scale * log2 e, row sums reduced once at the end),
// so the scores never leave registers.  Key tiles wholly above the diagonal
// (causal) or wholly outside the window are skipped; the mask is evaluated
// only on tiles that cross an edge.  Any S; hd 64, 128 or 256, each (type,
// hd) one template instance fixed at compile time.
//
// float32: 3xTF32.  Each operand splits into a TF32 high part and a TF32
// residual (rounded as cvt.rna.tf32.f32 rounds, on the integer bits; x - hi
// is exact), and each product is three m16n8k8 TF32 issues, lo*hi + hi*lo +
// hi*hi, the error-compensated scheme of CUTLASS's OpMultiplyAddFastF32,
// which keeps float32 accuracy (one TF32 product would not).  P's
// accumulator layout holds columns (2t, 2t + 1) of a row where TF32's A
// fragment wants (t, t + 4).  Neither shuffles nor a shared-memory slab move
// it: the sum over k does not depend on the order of k, so the kernel
// permutes k inside each 8-wide step (A's slot t takes column 2t, slot t + 4
// column 2t + 1) and reads V's rows 2t and 2t + 1 into the B fragment to
// match.  The same permutation lets Q and K fragments be read as float2.
// Row strides are padded (Q, K: hd + 8 floats; V: hd + 4) so that every
// fragment read is free of bank conflicts.
//
// bfloat16: one m16n8k16 bf16 product per step.  The accumulators of two n8
// score tiles are the A fragment of one k16 step, so P is converted to bf16
// in registers; V's B fragments come from ldmatrix.trans.  Tiles stay bf16
// in shared memory (rows padded to hd + 8).
//
// What bounds it: operations.  Causal prefill does 4 * hd flops per visible
// (query, key) pair against 4 * S * hd * 4 bytes of q, k, v and o, hundreds
// of flops per byte.  In float32 the 3xTF32 route does three TF32 products
// per float32 one, so its least time is 3 * flops / 495 TFLOP/s.  This
// design is held back from it by mma.sync, which reaches only part of
// Hopper's tensor rate, and by the operand splits, which each warp repeats
// for the whole K and V tile; wgmma with operands split once per tile in
// shared memory is the next step.  The build's --fmad=false does not touch
// mma.sync.

#include "mma.cuh"

namespace {

constexpr float kMaskValue = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;

// Where the scores of one key tile leave the tensor cores: s[j][e] holds
// (row r0 for e < 2, else r0 + 8; key k0 + 8 j + 2 t + (e & 1)).  Scales
// them into the log2 domain, masks them, updates the running max m and the
// thread's partial row sums l, rescales the accumulator and leaves P in s.
template <int NT, int DT>
__device__ __forceinline__ void online_softmax(
    float (&s)[NT][4], float (&acc)[DT][4], float (&m)[2], float (&l)[2],
    int r0, int k0, int t, bool edge, int S, int causal, int window,
    float scale_log2) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[j][e] * scale_log2;
      if (edge) {
        const int qp = r0 + (e >> 1) * 8, kp = k0 + 8 * j + 2 * t + (e & 1);
        // the reference adds -1e30, which absorbs any finite score
        if (kp >= S || (causal && kp > qp) ||
            (window > 0 && qp - kp >= window))
          x = kMaskValue;
      }
      s[j][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  float corr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = quad_max(mx[i]);
    corr[i] = exp2f(m[i] - mx[i]);
    m[i] = mx[i];
    l[i] *= corr[i];
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2f(s[j][e] - m[e >> 1]);
      s[j][e] = p;
      l[e >> 1] += p;
    }
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e >> 1];
}

// ---------------------------------------------------------------- float32

// A block owns BQ = 16 * MT * kWarps query rows: each warp MT m16 tiles,
// so that every K and V fragment it reads (and splits) feeds MT products.
template <int HD, int BK, int MT>
struct F32Tile {
  static constexpr int BQ = 16 * MT * kWarps;
  static constexpr int QS = HD + 8;   // Q and K row strides (floats)
  static constexpr int VS = HD + 4;   // V row stride
  static constexpr size_t smem =
      sizeof(float) * ((size_t)BQ * QS + 2 * (size_t)BK * (QS + VS));
};

template <int HD, int BK, int MT>
__global__ void __launch_bounds__(kThreads)
flash_f32(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ o,
          float* __restrict__ lse, int S, int H, int KV, int causal,
          int window, float scale_log2) {
  using L = F32Tile<HD, BK, MT>;
  constexpr int BQ = L::BQ, QS = L::QS, VS = L::VS;
  constexpr int NT = BK / 8;          // score n8 tiles
  constexpr int DT = HD / 8;          // output n8 tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);    // [BQ][QS]
  float* ks = qs + BQ * QS;                          // [2][BK][QS]
  float* vs = ks + 2 * BK * QS;                      // [2][BK][VS]

  const int bh = blockIdx.y, b = bh / H, h = bh % H, kvh = h / (H / KV);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // heaviest first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t q_row = (size_t)H * HD, kv_row = (size_t)KV * HD;
  const float* kb = k + ((size_t)b * S * KV + kvh) * HD;
  const float* vb = v + ((size_t)b * S * KV + kvh) * HD;
  const KeyRange kr(q0, BQ, S, BK, causal, window);

  load_tile<float, HD>(qs, QS, q + ((size_t)b * S * H + h) * HD, q_row,
                       q0, BQ, S);
  load_tile<float, HD>(ks, QS, kb, kv_row, kr.lo * BK, BK, S);
  load_tile<float, HD>(vs, VS, vb, kv_row, kr.lo * BK, BK, S);
  cp_async_commit();

  float m[MT][2], l[MT][2], acc[MT][DT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m[mt][0] = m[mt][1] = kMaskValue;
    l[mt][0] = l[mt][1] = 0.f;
#pragma unroll
    for (int n = 0; n < DT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;
  }
  const int r0 = q0 + warp * 16 * MT + g;   // row of m-tile mt: r0 + 16 mt
  const float* qw = qs + warp * 16 * MT * QS;

  for (int kt = kr.lo, st = 0; kt < kr.hi; ++kt, st ^= 1) {
    if (kt + 1 < kr.hi) {           // the next tile into the other stage
      load_tile<float, HD>(ks + (st ^ 1) * BK * QS, QS, kb, kv_row,
                           (kt + 1) * BK, BK, S);
      load_tile<float, HD>(vs + (st ^ 1) * BK * VS, VS, vb, kv_row,
                           (kt + 1) * BK, BK, S);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* kst = ks + st * BK * QS;
    const float* vst = vs + st * BK * VS;

    // S = Q K^T; k permuted inside each 8-wide step: slot t <- 2t, t+4 <- 2t+1
    float s[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD; kk += 8) {
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const float* qr = qw + (16 * mt + g) * QS + kk + 2 * t;
        const float2 x0 = *reinterpret_cast<const float2*>(qr);
        const float2 x1 = *reinterpret_cast<const float2*>(qr + 8 * QS);
        split_tf32(x0.x, ah[mt][0], al[mt][0]);
        split_tf32(x1.x, ah[mt][1], al[mt][1]);
        split_tf32(x0.y, ah[mt][2], al[mt][2]);
        split_tf32(x1.y, ah[mt][3], al[mt][3]);
      }
      uint32_t bh_[NT][2], bl[NT][2];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float2 y = *reinterpret_cast<const float2*>(
            kst + (8 * j + g) * QS + kk + 2 * t);
        split_tf32(y.x, bh_[j][0], bl[j][0]);
        split_tf32(y.y, bh_[j][1], bl[j][1]);
      }
      mma_3xtf32_rows<MT, NT, NT>(s, 0, ah, al, bh_, bl);
    }

    const int k0 = kt * BK;
    const bool edge = tile_edge(k0, BK, q0, BQ, S, causal, window);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      online_softmax<NT, DT>(s[mt], acc[mt], m[mt], l[mt], r0 + 16 * mt, k0,
                             t, edge, S, causal, window, scale_log2);

    // O += P V; score tile j is the k8 step over keys 8j .. 8j + 7, with the
    // same permutation: A's slots (t, t + 4) hold keys (2t, 2t + 1)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        split_tf32(s[mt][j][0], ah[mt][0], al[mt][0]);
        split_tf32(s[mt][j][2], ah[mt][1], al[mt][1]);
        split_tf32(s[mt][j][1], ah[mt][2], al[mt][2]);
        split_tf32(s[mt][j][3], ah[mt][3], al[mt][3]);
      }
      const float* v0 = vst + (8 * j + 2 * t) * VS + g;
      constexpr int NB = 8;         // B fragments held at once (registers)
#pragma unroll
      for (int n0 = 0; n0 < DT; n0 += NB) {
        uint32_t bh_[NB][2], bl[NB][2];
#pragma unroll
        for (int n = 0; n < NB; ++n) {
          split_tf32(v0[8 * (n0 + n)], bh_[n][0], bl[n][0]);
          split_tf32(v0[VS + 8 * (n0 + n)], bh_[n][1], bl[n][1]);
        }
        mma_3xtf32_rows<MT, DT, NB>(acc, n0, ah, al, bh_, bl);
      }
    }
    __syncthreads();                // this stage is free for the next copy
  }

  float* ob = o + ((size_t)b * S * H + h) * HD;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qp = r0 + 16 * mt + 8 * i;
      const float den = fmaxf(quad_sum(l[mt][i]), 1e-20f);
      const float inv = 1.f / den;
      if (qp >= S) continue;
      if (lse != nullptr && t == 0)
        lse[(size_t)bh * S + qp] = (m[mt][i] + log2f(den)) * kLn2;
#pragma unroll
      for (int n = 0; n < DT; ++n)
        *reinterpret_cast<float2*>(ob + qp * q_row + 8 * n + 2 * t) =
            make_float2(acc[mt][n][2 * i] * inv, acc[mt][n][2 * i + 1] * inv);
    }
}

// ---------------------------------------------------------------- bfloat16

template <int HD, int MT>
struct Bf16Tile {
  static constexpr int BQ = 16 * MT * kWarps;
  static constexpr int RS = HD + 8;   // row stride of Q, K and V (bf16)
  static constexpr int BK = 64;
  static constexpr size_t smem =
      sizeof(__nv_bfloat16) * (size_t)RS * (BQ + 4 * BK);
};

template <int HD, int MT>
__global__ void __launch_bounds__(kThreads)
flash_bf16(const __nv_bfloat16* __restrict__ q,
           const __nv_bfloat16* __restrict__ k,
           const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
           float* __restrict__ lse, int S, int H, int KV, int causal,
           int window, float scale_log2) {
  using L = Bf16Tile<HD, MT>;
  using bf16 = __nv_bfloat16;
  constexpr int BQ = L::BQ, RS = L::RS, BK = L::BK;
  constexpr int NT = BK / 8, DT = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);      // [BQ][RS]
  bf16* ks = qs + BQ * RS;                           // [2][BK][RS]
  bf16* vs = ks + 2 * BK * RS;                       // [2][BK][RS]

  const int bh = blockIdx.y, b = bh / H, h = bh % H, kvh = h / (H / KV);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t q_row = (size_t)H * HD, kv_row = (size_t)KV * HD;
  const bf16* kb = k + ((size_t)b * S * KV + kvh) * HD;
  const bf16* vb = v + ((size_t)b * S * KV + kvh) * HD;
  const KeyRange kr(q0, BQ, S, BK, causal, window);

  load_tile<bf16, HD>(qs, RS, q + ((size_t)b * S * H + h) * HD, q_row,
                      q0, BQ, S);
  load_tile<bf16, HD>(ks, RS, kb, kv_row, kr.lo * BK, BK, S);
  load_tile<bf16, HD>(vs, RS, vb, kv_row, kr.lo * BK, BK, S);
  cp_async_commit();

  float m[MT][2], l[MT][2], acc[MT][DT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m[mt][0] = m[mt][1] = kMaskValue;
    l[mt][0] = l[mt][1] = 0.f;
#pragma unroll
    for (int n = 0; n < DT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;
  }
  const int r0 = q0 + warp * 16 * MT + g;
  const bf16* qw = qs + warp * 16 * MT * RS;
  // ldmatrix row address of this lane inside a 16-key x 16-column block
  const int ld_row = ((lane >> 3) & 1) * 8 + (lane & 7);
  const int ld_col = (lane >> 4) * 8;

  for (int kt = kr.lo, st = 0; kt < kr.hi; ++kt, st ^= 1) {
    if (kt + 1 < kr.hi) {
      load_tile<bf16, HD>(ks + (st ^ 1) * BK * RS, RS, kb, kv_row,
                          (kt + 1) * BK, BK, S);
      load_tile<bf16, HD>(vs + (st ^ 1) * BK * RS, RS, vb, kv_row,
                          (kt + 1) * BK, BK, S);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* kst = ks + st * BK * RS;
    const bf16* vst = vs + st * BK * RS;

    float s[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD; kk += 16) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const bf16* qr = qw + (16 * mt + g) * RS + kk + 2 * t;
        a[mt][0] = *reinterpret_cast<const uint32_t*>(qr);
        a[mt][1] = *reinterpret_cast<const uint32_t*>(qr + 8 * RS);
        a[mt][2] = *reinterpret_cast<const uint32_t*>(qr + 8);
        a[mt][3] = *reinterpret_cast<const uint32_t*>(qr + 8 * RS + 8);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const bf16* kr_ = kst + (8 * j + g) * RS + kk + 2 * t;
        const uint32_t bb[2] = {*reinterpret_cast<const uint32_t*>(kr_),
                                *reinterpret_cast<const uint32_t*>(kr_ + 8)};
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_bf16(s[mt][j], a[mt], bb);
      }
    }

    const int k0 = kt * BK;
    const bool edge = tile_edge(k0, BK, q0, BQ, S, causal, window);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      online_softmax<NT, DT>(s[mt], acc[mt], m[mt], l[mt], r0 + 16 * mt, k0,
                             t, edge, S, causal, window, scale_log2);

    // O += P V: score tiles 2jj, 2jj + 1 are the A fragment of k16 step jj
#pragma unroll
    for (int jj = 0; jj < NT / 2; ++jj) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        a[mt][0] = pack_bf16(s[mt][2 * jj][0], s[mt][2 * jj][1]);
        a[mt][1] = pack_bf16(s[mt][2 * jj][2], s[mt][2 * jj][3]);
        a[mt][2] = pack_bf16(s[mt][2 * jj + 1][0], s[mt][2 * jj + 1][1]);
        a[mt][3] = pack_bf16(s[mt][2 * jj + 1][2], s[mt][2 * jj + 1][3]);
      }
#pragma unroll
      for (int n = 0; n < DT; n += 2) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, vst + (16 * jj + ld_row) * RS + 8 * n + ld_col);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(acc[mt][n], a[mt], r);
          mma_bf16(acc[mt][n + 1], a[mt], r + 2);
        }
      }
    }
    __syncthreads();
  }

  bf16* ob = o + ((size_t)b * S * H + h) * HD;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qp = r0 + 16 * mt + 8 * i;
      const float den = fmaxf(quad_sum(l[mt][i]), 1e-20f);
      const float inv = 1.f / den;
      if (qp >= S) continue;
      if (lse != nullptr && t == 0)
        lse[(size_t)bh * S + qp] = (m[mt][i] + log2f(den)) * kLn2;
#pragma unroll
      for (int n = 0; n < DT; ++n)
        *reinterpret_cast<uint32_t*>(ob + qp * q_row + 8 * n + 2 * t) =
            pack_bf16(acc[mt][n][2 * i] * inv, acc[mt][n][2 * i + 1] * inv);
    }
}

// ---------------------------------------------------------------- launch

template <typename T, int BQ, typename Kern>
int launch(Kern kern, size_t smem, const void* q, const void* k,
           const void* v, void* o, float* lse, int B, int S, int H, int KV,
           int causal, int window, float scale_log2, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  kern<<<grid, kThreads, smem, stream>>>((const T*)q, (const T*)k,
                                         (const T*)v, (T*)o, lse, S, H, KV,
                                         causal, window, scale_log2);
  return (int)cudaGetLastError();
}

template <int HD, int BK, int MT>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int S, int H, int KV, int causal,
               int window, float sl2, cudaStream_t st) {
  using L = F32Tile<HD, BK, MT>;
  return launch<float, L::BQ>(flash_f32<HD, BK, MT>, L::smem, q, k, v, o,
                              lse, B, S, H, KV, causal, window, sl2, st);
}

template <int HD, int MT>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                float* lse, int B, int S, int H, int KV, int causal,
                int window, float sl2, cudaStream_t st) {
  using L = Bf16Tile<HD, MT>;
  return launch<__nv_bfloat16, L::BQ>(flash_bf16<HD, MT>, L::smem, q, k, v,
                                      o, lse, B, S, H, KV, causal, window,
                                      sl2, st);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16; lse_out may be null.  Returns a cudaError_t.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, void* lse_out, int B, int S, int H,
                               int KV, int hd,
                               int dtype, int causal, int window, double scale,
                               void* stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  if (KV <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const float sl2 = (float)(scale * 1.4426950408889634);   // scale * log2 e
  float* lse = (float*)lse_out;
  // (hd, key tile, m16 tiles a warp) of each instance; at hd 256 the
  // registers allow one m16 tile a warp
  if (dtype == 0) {
    switch (hd) {
      case 64:
        return launch_f32<64, 64, 2>(q, k, v, o, lse, B, S, H, KV, causal,
                                     window, sl2, st);
      case 128:
        return launch_f32<128, 32, 2>(q, k, v, o, lse, B, S, H, KV, causal,
                                      window, sl2, st);
      case 256:
        return launch_f32<256, 32, 1>(q, k, v, o, lse, B, S, H, KV, causal,
                                      window, sl2, st);
    }
  } else if (dtype == 1) {
    switch (hd) {
      case 64:
        return launch_bf16<64, 2>(q, k, v, o, lse, B, S, H, KV, causal,
                                  window, sl2, st);
      case 128:
        return launch_bf16<128, 1>(q, k, v, o, lse, B, S, H, KV, causal,
                                   window, sl2, st);
      case 256:
        return launch_bf16<256, 1>(q, k, v, o, lse, B, S, H, KV, causal,
                                   window, sl2, st);
    }
  }
  return (int)cudaErrorInvalidValue;
}
