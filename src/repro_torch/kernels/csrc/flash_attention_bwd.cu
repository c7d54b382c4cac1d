// Backward of flash attention with grouped KV heads, for Hopper (sm_90a),
// on the tensor cores through mma.sync.
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
// dk, dv of a KV head sum over its G = H / KV query heads.  q, dq: (B, S, H,
// hd); k, v, dk, dv: (B, S, KV, hd); o, dO in q's type (float32 or
// bfloat16); lse: (B, H, S) float32; all sums in float32.
//
// Three launches on the caller's stream, none with atomics, so two calls on
// the same inputs give bit-identical results:
//   dq_kernel  one block of 4 warps per (batch * head, column chunk, query
//              tile), heaviest tiles first.  Its prologue takes D_i of its
//              rows (a lane a row, in column order) and writes D for the
//              next pass.  It walks the key tiles its rows see through a
//              2-stage cp.async ring of K and V and forms S = Q K^T and
//              dP = dO V^T (the forward's Q K^T shape), P and dS in
//              registers, and dQ += dS K (the forward's P V shape).
//   dkv_kernel one block per (batch * query head, column chunk, 64-key
//              tile), heaviest key tiles first, keys as the M dimension:
//              each warp holds 16 keys, and the query tiles that see them
//              come through a 2-stage ring of Q, dO, lse and D.  S^T = K Q^T
//              and dP^T = V dO^T leave P^T and dS^T in accumulator layout,
//              so dV += P^T dO and dK += dS^T Q are the forward's P V shape,
//              with no transpose through shared memory.  With G > 1 each
//              query head writes its dk, dv in float32 to scratch (B, S, H,
//              hd); with G = 1 it writes dk, dv directly.
//   group_sum  dk, dv of a KV head: its G heads' scratch rows added in head
//              order, in the inputs' type (only when G > 1).
// A block per query head, not per KV head, fills the card: at qwen2's step
// (4, 512, 14, 2, 64) the dk/dv pass has 448 blocks where a KV-head grid
// would have 64.  The products are the forward's: 3xTF32 m16n8k8 in
// float32 (each operand split into a TF32 high part and a TF32 residual,
// three issues per product), m16n8k16 bf16 with P and dS packed in
// registers and the B operand of the second product from ldmatrix.trans.
// The second product's A operand is the first's accumulator: P's layout
// holds columns (2t, 2t + 1) of a row where TF32's A fragment wants
// (t, t + 4), so k is permuted inside each 8-wide step and the B operand's
// rows 2t and 2t + 1 are read to match.  Rows are padded (float32: hd + 4;
// bf16: hd + 8) so every fragment read and ldmatrix is free of bank
// conflicts.  Where the accumulators would not fit the registers (dk and dv
// at hd 128 and 256, dq at hd 256), a block owns a chunk of the output
// columns and recomputes S and dP for it.  The build's --fmad=false does
// not touch mma.sync; the scalar multiply-adds are explicit fmaf.
//
// What bounds it: operations.  Causal, the dq pass forms three products per
// visible (query, key) pair and head and the dk/dv pass four, 2 * hd flops
// each; in float32 each is three TF32 products.  Against that, it is held
// back by mma.sync, which reaches only part of Hopper's tensor rate, and by
// the operand splits and fragment reads each warp repeats for the tiles it
// streams; wgmma with operands split once per tile is the next step.

#include "mma.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBKV = 16 * kWarps;   // keys of a dk/dv block: 16 a warp

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

// elements n0 .. n0 + n - 1 of a float vector into shared memory; those at
// or past S are zero-filled
__device__ __forceinline__ void load_vec(float* dst, const float* src,
                                         int n0, int n, int S) {
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const bool in = n0 + i < S;
    cp_async4(dst + i, src + (in ? n0 + i : 0), in ? 4 : 0);
  }
}

__device__ __forceinline__ bool masked(int qp, int kp, int S, int causal,
                                       int window) {
  return qp >= S || kp >= S || (causal && kp > qp) ||
         (window > 0 && qp - kp >= window);
}

// row stride of a shared-memory tile in elements: float32 rows read as
// scalars (hd + 4: rows 4 banks apart), bf16 rows read as 32-bit pairs and
// by ldmatrix (hd + 8: rows 16 bytes apart)
template <typename T, int HD>
constexpr int row_stride() {
  return sizeof(T) == 4 ? HD + 4 : HD + 8;
}

// sum over n of a[n] * b[n], in order, from 16-byte loads of rows a and b
template <int N>
__device__ __forceinline__ float dot_row(const float* a, const float* b) {
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < N; c += 4) {
    const float4 x = *reinterpret_cast<const float4*>(a + c);
    const float4 y = *reinterpret_cast<const float4*>(b + c);
    acc = fmaf(x.x, y.x, acc);
    acc = fmaf(x.y, y.y, acc);
    acc = fmaf(x.z, y.z, acc);
    acc = fmaf(x.w, y.w, acc);
  }
  return acc;
}

template <int N>
__device__ __forceinline__ float dot_row(const __nv_bfloat16* a,
                                         const __nv_bfloat16* b) {
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < N; c += 8) {
    const uint4 x = *reinterpret_cast<const uint4*>(a + c);
    const uint4 y = *reinterpret_cast<const uint4*>(b + c);
    const uint32_t xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 u = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&xs[e]));
      const float2 w = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&ys[e]));
      acc = fmaf(u.x, w.x, acc);
      acc = fmaf(u.y, w.y, acc);
    }
  }
  return acc;
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// acc[mt][j] += A_mt . B_j^T over HD, where A's m16 tile mt is rows
// 16 mt .. 16 mt + 15 of a (row stride AS) and B's n8 tile j is rows
// 8 j .. 8 j + 7 of b (row stride BS).  float32: 3xTF32.
template <int MT, int NT, int HD, int AS, int BS>
__device__ __forceinline__ void nt_prod(float (&acc)[MT][NT][4],
                                        const float* a, const float* b,
                                        int g, int t) {
#pragma unroll
  for (int kk = 0; kk < HD; kk += 8) {
    uint32_t ah[MT][4], al[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const float* ar = a + (16 * mt + g) * AS + kk + t;
      split_tf32(ar[0], ah[mt][0], al[mt][0]);
      split_tf32(ar[8 * AS], ah[mt][1], al[mt][1]);
      split_tf32(ar[4], ah[mt][2], al[mt][2]);
      split_tf32(ar[8 * AS + 4], ah[mt][3], al[mt][3]);
    }
    uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float* br = b + (8 * j + g) * BS + kk + t;
      split_tf32(br[0], bh[j][0], bl[j][0]);
      split_tf32(br[4], bh[j][1], bl[j][1]);
    }
    mma_3xtf32_rows<MT, NT, NT>(acc, 0, ah, al, bh, bl);
  }
}

// bf16: one m16n8k16 product per 16-wide step
template <int MT, int NT, int HD, int AS, int BS>
__device__ __forceinline__ void nt_prod(float (&acc)[MT][NT][4],
                                        const __nv_bfloat16* a,
                                        const __nv_bfloat16* b, int g,
                                        int t) {
#pragma unroll
  for (int kk = 0; kk < HD; kk += 16) {
    uint32_t af[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const __nv_bfloat16* ar = a + (16 * mt + g) * AS + kk + 2 * t;
      af[mt][0] = ld32(ar);
      af[mt][1] = ld32(ar + 8 * AS);
      af[mt][2] = ld32(ar + 8);
      af[mt][3] = ld32(ar + 8 * AS + 8);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const __nv_bfloat16* br = b + (8 * j + g) * BS + kk + 2 * t;
      const uint32_t bb[2] = {ld32(br), ld32(br + 8)};
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[mt][j], af[mt], bb);
    }
  }
}

// out[mt][n] += P_mt . D[:, 8 n .. 8 n + 7] over the 8 * NT items, where P
// is a first product's accumulator (items as its columns) and item r of D
// is row r of d (row stride DS, the output's column chunk at column 0).
// float32: 3xTF32, k permuted inside each 8-wide step: A's slots (t, t + 4)
// hold items (2t, 2t + 1), which are the accumulator's own columns.
template <int MT, int NT, int DT, int DS>
__device__ __forceinline__ void pv_prod(float (&out)[MT][DT][4],
                                        const float (&p)[MT][NT][4],
                                        const float* d, int g, int t,
                                        int lane) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    uint32_t ah[MT][4], al[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      split_tf32(p[mt][j][0], ah[mt][0], al[mt][0]);
      split_tf32(p[mt][j][2], ah[mt][1], al[mt][1]);
      split_tf32(p[mt][j][1], ah[mt][2], al[mt][2]);
      split_tf32(p[mt][j][3], ah[mt][3], al[mt][3]);
    }
    const float* d0 = d + (8 * j + 2 * t) * DS + g;
    constexpr int NB = DT < 8 ? DT : 8;   // B fragments held at once
#pragma unroll
    for (int n0 = 0; n0 < DT; n0 += NB) {
      uint32_t bh[NB][2], bl[NB][2];
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        split_tf32(d0[8 * (n0 + n)], bh[n][0], bl[n][0]);
        split_tf32(d0[DS + 8 * (n0 + n)], bh[n][1], bl[n][1]);
      }
      mma_3xtf32_rows<MT, DT, NB>(out, n0, ah, al, bh, bl);
    }
  }
}

// bf16: the accumulators of n8 tiles 2 jj and 2 jj + 1 are the A fragment
// of k16 step jj, packed in registers; D's B fragments from ldmatrix.trans
template <int MT, int NT, int DT, int DS>
__device__ __forceinline__ void pv_prod(float (&out)[MT][DT][4],
                                        const float (&p)[MT][NT][4],
                                        const __nv_bfloat16* d, int g, int t,
                                        int lane) {
  const int ld_row = ((lane >> 3) & 1) * 8 + (lane & 7);
  const int ld_col = (lane >> 4) * 8;
#pragma unroll
  for (int jj = 0; jj < NT / 2; ++jj) {
    uint32_t a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      a[mt][0] = pack_bf16(p[mt][2 * jj][0], p[mt][2 * jj][1]);
      a[mt][1] = pack_bf16(p[mt][2 * jj][2], p[mt][2 * jj][3]);
      a[mt][2] = pack_bf16(p[mt][2 * jj + 1][0], p[mt][2 * jj + 1][1]);
      a[mt][3] = pack_bf16(p[mt][2 * jj + 1][2], p[mt][2 * jj + 1][3]);
    }
#pragma unroll
    for (int n = 0; n < DT; n += 2) {
      uint32_t r[4];
      ldmatrix_x4_trans(r, d + (16 * jj + ld_row) * DS + 8 * n + ld_col);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(out[mt][n], a[mt], r);
        mma_bf16(out[mt][n + 1], a[mt], r + 2);
      }
    }
  }
}

template <int A, int B, int C>
__device__ __forceinline__ void zero(float (&x)[A][B][C]) {
#pragma unroll
  for (int i = 0; i < A; ++i)
#pragma unroll
    for (int j = 0; j < B; ++j)
#pragma unroll
      for (int e = 0; e < C; ++e) x[i][j][e] = 0.f;
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(x, y);
}

// ---------------------------------------------------------------- dq pass

// A block owns BQ = 16 * MT * kWarps query rows and DC of the hd columns
// of dq; key tiles of BK keys
template <typename T, int HD, int BK, int MT>
struct DqTile {
  static constexpr int BQ = 16 * MT * kWarps;
  static constexpr int RS = row_stride<T, HD>();
  static constexpr size_t smem =
      sizeof(T) * (size_t)RS * (2 * BQ + 4 * BK);
};

template <typename T, int HD, int BK, int MT, int DC>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ o,
          const T* __restrict__ dout, const float* __restrict__ lse,
          float* __restrict__ dl, T* __restrict__ dq, int S, int H, int KV,
          int causal, int window, float scale, float scale_log2) {
  using L = DqTile<T, HD, BK, MT>;
  constexpr int BQ = L::BQ, RS = L::RS, NT = BK / 8, DT = DC / 8;
  constexpr int NCH = HD / DC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);   // [BQ][RS]
  T* dos = qs + BQ * RS;                    // [BQ][RS]
  T* ks = dos + BQ * RS;                    // [2][BK][RS]
  T* vs = ks + 2 * BK * RS;                 // [2][BK][RS]

  const int bh = blockIdx.x / NCH, c0 = (blockIdx.x % NCH) * DC;
  const int b = bh / H, h = bh % H, kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // heaviest first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t q_row = (size_t)H * HD, kv_row = (size_t)KV * HD;
  const size_t qoff = ((size_t)b * S * H + h) * HD;
  const T* kb = k + ((size_t)b * S * KV + kvh) * HD;
  const T* vb = v + ((size_t)b * S * KV + kvh) * HD;
  const KeyRange kr(q0, BQ, S, BK, causal, window);

  load_tile<T, HD>(qs, RS, q + qoff, q_row, q0, BQ, S);
  load_tile<T, HD>(dos, RS, dout + qoff, q_row, q0, BQ, S);
  load_tile<T, HD>(ks, RS, kb, kv_row, kr.lo * BK, BK, S);
  load_tile<T, HD>(vs, RS, vb, kv_row, kr.lo * BK, BK, S);
  cp_async_commit();

  // D and lse (log2 units) of this thread's rows r0 + 8 i (i = 2 mt + e),
  // while the copies fly.  Lane l takes row l % RPW of the warp's RPW rows
  // and part l / RPW of its columns, in order; the parts meet in a fixed
  // butterfly.  The first column chunk writes D for dkv_kernel.
  constexpr int RPW = 16 * MT, SPL = 32 / RPW;
  const int w0 = q0 + warp * RPW;         // the warp's first row
  const int r0 = w0 + g;
  float dval[2 * MT], lse2[2 * MT];
  {
    const int qp = w0 + lane % RPW;
    float acc = 0.f;
    if (qp < S) {
      const size_t off = qoff + (size_t)qp * q_row + lane / RPW * (HD / SPL);
      acc = dot_row<HD / SPL>(o + off, dout + off);
    }
#pragma unroll
    for (int x = RPW; x < 32; x <<= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, x);
    if (lane < RPW && c0 == 0 && qp < S) dl[(size_t)bh * S + qp] = acc;
#pragma unroll
    for (int i = 0; i < 2 * MT; ++i)
      dval[i] = __shfl_sync(0xffffffffu, acc, g + 8 * i);
  }
#pragma unroll
  for (int i = 0; i < 2 * MT; ++i) {
    const int qp = r0 + 8 * i;
    lse2[i] = qp < S ? lse[(size_t)bh * S + qp] * kLog2e : 0.f;
  }

  float acc[MT][DT][4];
  zero(acc);
  const T* qw = qs + warp * 16 * MT * RS;
  const T* dow = dos + warp * 16 * MT * RS;

  for (int kt = kr.lo, st = 0; kt < kr.hi; ++kt, st ^= 1) {
    if (kt + 1 < kr.hi) {           // the next tile into the other stage
      load_tile<T, HD>(ks + (st ^ 1) * BK * RS, RS, kb, kv_row,
                       (kt + 1) * BK, BK, S);
      load_tile<T, HD>(vs + (st ^ 1) * BK * RS, RS, vb, kv_row,
                       (kt + 1) * BK, BK, S);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* kst = ks + st * BK * RS;
    const T* vst = vs + st * BK * RS;

    float s[MT][NT][4], dp[MT][NT][4];
    zero(s);
    zero(dp);
    nt_prod<MT, NT, HD, RS, RS>(s, qw, kst, g, t);
    nt_prod<MT, NT, HD, RS, RS>(dp, dow, vst, g, t);

    // P and dS in registers; dS replaces S.  s[mt][j][e] is (row
    // r0 + 16 mt + 8 (e >> 1), key k0 + 8 j + 2 t + (e & 1))
    const int k0 = kt * BK;
    const bool edge = tile_edge(k0, BK, q0, BQ, S, causal, window);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 2 * mt + (e >> 1);
          float p = exp2f(s[mt][j][e] * scale_log2 - lse2[i]);
          if (edge && masked(r0 + 8 * i, k0 + 8 * j + 2 * t + (e & 1), S,
                             causal, window))
            p = 0.f;
          s[mt][j][e] = p * (dp[mt][j][e] - dval[i]);
        }
    pv_prod<MT, NT, DT, RS>(acc, s, kst + c0, g, t, lane);
    __syncthreads();                // this stage is free for the next copy
  }

  T* out = dq + qoff + c0;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qp = r0 + 16 * mt + 8 * i;
      if (qp >= S) continue;
#pragma unroll
      for (int n = 0; n < DT; ++n)
        store2(out + qp * q_row + 8 * n + 2 * t,
               acc[mt][n][2 * i] * scale, acc[mt][n][2 * i + 1] * scale);
    }
}

// ---------------------------------------------------------------- dk/dv pass

// A block owns kBKV keys of one query head and DC of the hd columns of dk
// and dv; query tiles of BQ rows
template <typename T, int HD, int BQ>
struct DkvTile {
  static constexpr int RS = row_stride<T, HD>();
  static constexpr size_t smem =
      sizeof(T) * (size_t)RS * (2 * kBKV + 4 * BQ) +
      sizeof(float) * 4 * (size_t)BQ;
};

template <typename T, int HD, int BQ, int DC>
__global__ void __launch_bounds__(kThreads)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const T* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ dl,
           T* __restrict__ dk, T* __restrict__ dv,
           float* __restrict__ scratch, size_t half, int S, int H, int KV,
           int causal, int window, float scale, float scale_log2) {
  using L = DkvTile<T, HD, BQ>;
  constexpr int RS = L::RS, NT = BQ / 8, DT = DC / 8;
  constexpr int NCH = HD / DC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);   // [kBKV][RS]
  T* vs = ks + kBKV * RS;                   // [kBKV][RS]
  T* qs = vs + kBKV * RS;                   // [2][BQ][RS]
  T* dos = qs + 2 * BQ * RS;                // [2][BQ][RS]
  float* lses = reinterpret_cast<float*>(dos + 2 * BQ * RS);   // [2][BQ]
  float* dls = lses + 2 * BQ;                                  // [2][BQ]

  const int bh = blockIdx.x / NCH, c0 = (blockIdx.x % NCH) * DC;
  const int b = bh / H, h = bh % H, G = H / KV, kvh = h / G;
  const int k0 = blockIdx.y * kBKV;   // causal: tile 0 sees the most queries
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t q_row = (size_t)H * HD, kv_row = (size_t)KV * HD;
  const size_t qoff = ((size_t)b * S * H + h) * HD;
  const size_t kvoff = ((size_t)b * S * KV + kvh) * HD;
  const float* lseb = lse + (size_t)bh * S;
  const float* dlb = dl + (size_t)bh * S;

  // the query tiles with a row that sees a key of the tile
  const int k_last = min(k0 + kBKV, S) - 1;
  const int lo = causal ? k0 / BQ : 0;
  const int hi = window > 0 ? min(S - 1, k_last + window - 1) / BQ + 1
                            : (S + BQ - 1) / BQ;

  load_tile<T, HD>(ks, RS, k + kvoff, kv_row, k0, kBKV, S);
  load_tile<T, HD>(vs, RS, v + kvoff, kv_row, k0, kBKV, S);
  load_tile<T, HD>(qs, RS, q + qoff, q_row, lo * BQ, BQ, S);
  load_tile<T, HD>(dos, RS, dout + qoff, q_row, lo * BQ, BQ, S);
  load_vec(lses, lseb, lo * BQ, BQ, S);
  load_vec(dls, dlb, lo * BQ, BQ, S);
  cp_async_commit();

  float adk[1][DT][4], adv[1][DT][4];
  zero(adk);
  zero(adv);
  const T* kw = ks + warp * 16 * RS;
  const T* vw = vs + warp * 16 * RS;
  const int kr0 = k0 + warp * 16 + g;   // keys kr0 and kr0 + 8

  for (int qt = lo, st = 0; qt < hi; ++qt, st ^= 1) {
    if (qt + 1 < hi) {
      const int n0 = (qt + 1) * BQ;
      load_tile<T, HD>(qs + (st ^ 1) * BQ * RS, RS, q + qoff, q_row, n0, BQ,
                       S);
      load_tile<T, HD>(dos + (st ^ 1) * BQ * RS, RS, dout + qoff, q_row, n0,
                       BQ, S);
      load_vec(lses + (st ^ 1) * BQ, lseb, n0, BQ, S);
      load_vec(dls + (st ^ 1) * BQ, dlb, n0, BQ, S);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* qst = qs + st * BQ * RS;
    const T* dost = dos + st * BQ * RS;
    const float* lst = lses + st * BQ;
    const float* dst = dls + st * BQ;

    // S^T and dP^T: s[0][j][e] is (key kr0 + 8 (e >> 1), query
    // q0 + 8 j + 2 t + (e & 1))
    float s[1][NT][4], dp[1][NT][4];
    zero(s);
    zero(dp);
    nt_prod<1, NT, HD, RS, RS>(s, kw, qst, g, t);
    nt_prod<1, NT, HD, RS, RS>(dp, vw, dost, g, t);

    const int q0 = qt * BQ;
    const bool edge = q0 + BQ > S ||
                      tile_edge(k0, kBKV, q0, BQ, S, causal, window);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = 8 * j + 2 * t + (e & 1);
        float p = exp2f(s[0][j][e] * scale_log2 - lst[qc] * kLog2e);
        if (edge && masked(q0 + qc, kr0 + 8 * (e >> 1), S, causal, window))
          p = 0.f;
        s[0][j][e] = p;
        dp[0][j][e] = p * (dp[0][j][e] - dst[qc]);
      }
    pv_prod<1, NT, DT, RS>(adv, s, dost + c0, g, t, lane);
    pv_prod<1, NT, DT, RS>(adk, dp, qst + c0, g, t, lane);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kp = kr0 + 8 * i;
    if (kp >= S) continue;
    if (G == 1) {
      T* ok = dk + kvoff + (size_t)kp * kv_row + c0;
      T* ov = dv + kvoff + (size_t)kp * kv_row + c0;
#pragma unroll
      for (int n = 0; n < DT; ++n) {
        store2(ok + 8 * n + 2 * t, adk[0][n][2 * i] * scale,
               adk[0][n][2 * i + 1] * scale);
        store2(ov + 8 * n + 2 * t, adv[0][n][2 * i], adv[0][n][2 * i + 1]);
      }
    } else {
      float* ok = scratch + qoff + (size_t)kp * q_row + c0;
      float* ov = ok + half;        // dv's scratch follows dk's
#pragma unroll
      for (int n = 0; n < DT; ++n) {
        store2(ok + 8 * n + 2 * t, adk[0][n][2 * i] * scale,
               adk[0][n][2 * i + 1] * scale);
        store2(ov + 8 * n + 2 * t, adv[0][n][2 * i], adv[0][n][2 * i + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------- group sum

// dk and dv of every (b, s, KV head): the scratch rows of its G query heads
// added in head order, four columns a thread; threads [0, n4) take dk,
// [n4, 2 n4) dv.  Row r of the (B * S * KV, hd) output is rows r G ..
// r G + G - 1 of the (B * S * H, hd) scratch.
template <typename T>
__global__ void __launch_bounds__(256)
group_sum(const float* __restrict__ scratch, T* __restrict__ dk,
          T* __restrict__ dv, size_t n4, size_t half, int G, int hd) {
  const size_t i = (size_t)blockIdx.x * 256 + threadIdx.x;
  if (i >= 2 * n4) return;
  const bool is_v = i >= n4;
  const size_t e = 4 * (is_v ? i - n4 : i);   // element of the output
  const size_t row = e / hd, col = e % hd;
  const float* src = scratch + (is_v ? half : 0) + row * G * hd + col;
  float4 acc = *reinterpret_cast<const float4*>(src);
  for (int gg = 1; gg < G; ++gg) {
    const float4 x = *reinterpret_cast<const float4*>(src + (size_t)gg * hd);
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  T* out = (is_v ? dv : dk) + e;
  store2(out, acc.x, acc.y);
  store2(out + 2, acc.z, acc.w);
}

// ---------------------------------------------------------------- launch

template <typename Kern>
cudaError_t allow_smem(Kern kern, size_t bytes) {
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// dq pass (key tile BK, MT m16 tiles a warp, DQC dq columns a block) and
// dk/dv pass (query tile BQ, DKC dk/dv columns a block) of one (type, hd)
template <typename T, int HD, int BK, int MT, int DQC, int BQ, int DKC>
int run(const void* q, const void* k, const void* v, const void* o,
        const void* dout, const float* lse, float* dl, float* scratch,
        void* dq, void* dk, void* dv, int B, int S, int H, int KV,
        int causal, int window, float scale, cudaStream_t st) {
  using LQ = DqTile<T, HD, BK, MT>;
  using LK = DkvTile<T, HD, BQ>;
  const float sl2 = scale * kLog2e;
  auto kq = dq_kernel<T, HD, BK, MT, DQC>;
  cudaError_t err = allow_smem(kq, LQ::smem);
  if (err != cudaSuccess) return (int)err;
  kq<<<dim3(B * H * (HD / DQC), (S + LQ::BQ - 1) / LQ::BQ), kThreads,
       LQ::smem, st>>>((const T*)q, (const T*)k, (const T*)v, (const T*)o,
                       (const T*)dout, lse, dl, (T*)dq, S, H, KV, causal,
                       window, scale, sl2);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  auto kkv = dkv_kernel<T, HD, BQ, DKC>;
  if ((err = allow_smem(kkv, LK::smem)) != cudaSuccess) return (int)err;
  const size_t half = (size_t)B * S * H * HD;
  kkv<<<dim3(B * H * (HD / DKC), (S + kBKV - 1) / kBKV), kThreads, LK::smem,
        st>>>((const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, dl,
              (T*)dk, (T*)dv, scratch, half, S, H, KV, causal, window, scale,
              sl2);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (H == KV) return 0;
  const size_t n4 = (size_t)B * S * KV * HD / 4;
  group_sum<T><<<(unsigned)((2 * n4 + 255) / 256), 256, 0, st>>>(
      scratch, (T*)dk, (T*)dv, n4, half, H / KV, HD);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  dl is (B, H, S) float32 scratch; scratch
// is 2 * B * S * H * hd float32 (dk's per query head, then dv's), read only
// when H > KV (may be null otherwise).  Returns a cudaError_t.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const void* lse,
                                   void* dl, void* scratch, void* dq,
                                   void* dk, void* dv, int B, int S, int H,
                                   int KV, int hd, int dtype, int causal,
                                   int window, double scale, void* stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  if (KV <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
  if (H != KV && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const float sc = (float)scale;
  const float* ls = (const float*)lse;
  float* d = (float*)dl;
  float* scr = (float*)scratch;
  using bf16 = __nv_bfloat16;
  // (type, hd, dq key tile, dq m16 tiles a warp, dq columns a block, dk/dv
  // query tile, dk/dv columns a block): the accumulators and the score
  // tiles of a warp fit its registers, the tiles a block's shared memory
  if (dtype == 0) {
    switch (hd) {
      case 64:
        return run<float, 64, 32, 2, 64, 64, 64>(
            q, k, v, o, dout, ls, d, scr, dq, dk, dv, B, S, H, KV, causal,
            window, sc, st);
      case 128:
        return run<float, 128, 32, 1, 128, 32, 64>(
            q, k, v, o, dout, ls, d, scr, dq, dk, dv, B, S, H, KV, causal,
            window, sc, st);
      case 256:
        return run<float, 256, 16, 1, 128, 16, 64>(
            q, k, v, o, dout, ls, d, scr, dq, dk, dv, B, S, H, KV, causal,
            window, sc, st);
    }
  } else if (dtype == 1) {
    switch (hd) {
      case 64:
        return run<bf16, 64, 32, 2, 64, 64, 64>(
            q, k, v, o, dout, ls, d, scr, dq, dk, dv, B, S, H, KV, causal,
            window, sc, st);
      case 128:
        return run<bf16, 128, 32, 1, 128, 64, 64>(
            q, k, v, o, dout, ls, d, scr, dq, dk, dv, B, S, H, KV, causal,
            window, sc, st);
      case 256:
        return run<bf16, 256, 32, 1, 128, 32, 64>(
            q, k, v, o, dout, ls, d, scr, dq, dk, dv, B, S, H, KV, causal,
            window, sc, st);
    }
  }
  return (int)cudaErrorInvalidValue;
}
