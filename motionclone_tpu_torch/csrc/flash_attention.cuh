// Device code of the exact multi-head attention kernels (see
// flash_attention.cu for the design note): shared-memory tile helpers, the
// mma.sync m16n8k16 bf16 product, and the forward and backward kernels.
// Included by flash_attention.cu (the C entry points of kernels 1 and 2) and
// by fused_block.cu, whose spatial transformer runs the same forward kernel
// for its self- and cross-attention.  Everything has internal linkage.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 16 * kWarps;  // rows of the block's own side
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// c += a @ b for one m16n8k16 tile (a row-major 16x16, b "col" 16x8).
__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Shared-memory tile geometry for head dim D: rows padded to DP (a multiple
// of 16) and strided by LD = DP + 8 elements, which keeps rows 16-byte
// aligned and staggers them across banks.
template <int D>
struct Geo {
  static constexpr int DP = (D + 15) / 16 * 16;
  static constexpr int LD = DP + 8;
  static constexpr int NT = DP / 8;   // n-tiles over d
  static constexpr int KS = DP / 16;  // k-steps over d
};

// Copy `rows` rows of D bf16 from global (row stride gstride elements) into
// a shared tile; rows >= nvalid and the pad columns D..DP are zero.
template <int D>
__device__ __forceinline__ void load_rows(bf16* sm, const bf16* g, long gstride,
                                          int rows, int nvalid) {
  constexpr int CH = D / 8;
  for (int i = threadIdx.x; i < rows * CH; i += kThreads) {
    int r = i / CH, c = i - r * CH;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < nvalid) v = *reinterpret_cast<const uint4*>(g + (long)r * gstride + c * 8);
    *reinterpret_cast<uint4*>(sm + r * Geo<D>::LD + c * 8) = v;
  }
  constexpr int PC = (Geo<D>::DP - D) / 8;
  if constexpr (PC > 0) {
    for (int i = threadIdx.x; i < rows * PC; i += kThreads) {
      int r = i / PC, c = i - r * PC;
      *reinterpret_cast<uint4*>(sm + r * Geo<D>::LD + D + c * 8) =
          make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// A fragment (16x16, row-major) of a shared tile at (row0, col0).
template <int LD>
__device__ __forceinline__ void frag_a(uint32_t a[4], const bf16* sm, int row0,
                                       int col0, int lane) {
  const bf16* p = sm + (row0 + (lane >> 2)) * LD + col0 + (lane & 3) * 2;
  a[0] = *reinterpret_cast<const uint32_t*>(p);
  a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * LD);
  a[2] = *reinterpret_cast<const uint32_t*>(p + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * LD + 8);
}

// B fragment with B[k][n] = M[n0 + n][k0 + k] (M's rows are B's columns):
// the "x @ M^T" operand, two contiguous bf16 per register.
template <int LD>
__device__ __forceinline__ void frag_b_t(uint32_t b[2], const bf16* sm, int n0,
                                         int k0, int lane) {
  const bf16* p = sm + (n0 + (lane >> 2)) * LD + k0 + (lane & 3) * 2;
  b[0] = *reinterpret_cast<const uint32_t*>(p);
  b[1] = *reinterpret_cast<const uint32_t*>(p + 8);
}

// B fragment with B[k][n] = M[k0 + k][n0 + n]: the "x @ M" operand.
template <int LD>
__device__ __forceinline__ void frag_b(uint32_t b[2], const bf16* sm, int k0,
                                       int n0, int lane) {
  const bf16* p = sm + (k0 + (lane & 3) * 2) * LD + n0 + (lane >> 2);
  b[0] = pack_raw(p[0], p[LD]);
  b[1] = pack_raw(p[8 * LD], p[9 * LD]);
}

// A fragments of a 16 x (2*8) slab of f32 accumulators (two adjacent n-tiles
// of an m16n8 result) repacked as bf16: the C layout of a product is the A
// layout of the next one.
__device__ __forceinline__ void acc_to_a(uint32_t a[4], const float c0[4],
                                         const float c1[4]) {
  a[0] = pack_f32(c0[0], c0[1]);
  a[1] = pack_f32(c0[2], c0[3]);
  a[2] = pack_f32(c1[0], c1[1]);
  a[3] = pack_f32(c1[2], c1[3]);
}

// Write a warp's 16 x DP accumulator block (rows row0.., only d < D) as bf16.
template <int D>
__device__ __forceinline__ void store_acc(bf16* g, long gstride, int row0,
                                          int nrows, float acc[][4],
                                          const float scale[2], int lane) {
  const int gi = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < Geo<D>::NT; ++nt) {
    const int col = nt * 8 + t * 2;
    if (col >= D) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + gi + half * 8;
      if (row < nrows)
        *reinterpret_cast<__nv_bfloat162*>(g + (long)row * gstride + col) =
            __floats2bfloat162_rn(acc[nt][2 * half] * scale[half],
                                  acc[nt][2 * half + 1] * scale[half]);
    }
  }
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse, int H, int Sq, int Sk,
                     float scale, int kv_div) {
  using G = Geo<D>;
  constexpr int LD = G::LD;
  constexpr int BN = 64;  // keys per tile
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + kRows * LD;
  bf16* sV = sK + BN * LD;

  const int b = blockIdx.z, h = blockIdx.y, m0 = blockIdx.x * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const long HD = (long)H * D;
  const float sl2 = scale * kLog2e;

  load_rows<D>(sQ, q + ((long)b * Sq + m0) * HD + h * D, HD, kRows,
               min(kRows, Sq - m0));
  // k/v batch b / kv_div: the fused transformer's cross-attention shares
  // one video's text keys among its frames (kv_div = frames; else 1)
  const bf16* kb = k + (long)(b / kv_div) * Sk * HD + h * D;
  const bf16* vb = v + (long)(b / kv_div) * Sk * HD + h * D;

  float acc[G::NT][4];
#pragma unroll
  for (int i = 0; i < G::NT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // per-thread partial row sums
  const int r0 = warp * 16;

  for (int n0 = 0; n0 < Sk; n0 += BN) {
    __syncthreads();
    const int nvalid = min(BN, Sk - n0);
    load_rows<D>(sK, kb + (long)n0 * HD, HD, BN, nvalid);
    load_rows<D>(sV, vb + (long)n0 * HD, HD, BN, nvalid);
    __syncthreads();

    float s[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < G::KS; ++kk) {
      uint32_t a[4];
      frag_a<LD>(a, sQ, r0, kk * 16, lane);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        uint32_t bb[2];
        frag_b_t<LD>(bb, sK, j * 8, kk * 16, lane);
        mma16816(s[j], a, bb);
      }
    }

    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + t * 2 + (e & 1);
        const float x = col < nvalid ? s[j][e] * sl2 : -INFINITY;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = exp2f(m_run[r] - mx[r]);
      m_run[r] = mx[r];
      l_run[r] *= corr[r];
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[j][e] - m_run[e >> 1]);
        s[j][e] = p;
        l_run[e >> 1] += p;
      }
#pragma unroll
    for (int nt = 0; nt < G::NT; ++nt) {
      acc[nt][0] *= corr[0];
      acc[nt][1] *= corr[0];
      acc[nt][2] *= corr[1];
      acc[nt][3] *= corr[1];
    }
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t a[4];
      acc_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int nt = 0; nt < G::NT; ++nt) {
        uint32_t bb[2];
        frag_b<LD>(bb, sV, kk * 16, nt * 8, lane);
        mma16816(acc[nt], a, bb);
      }
    }
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    inv[r] = 1.f / l_run[r];
  }
  store_acc<D>(o + (long)b * Sq * HD + h * D, HD, m0 + r0, Sq, acc, inv, lane);
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = m0 + r0 + (lane >> 2) + r * 8;
      if (row < Sq)
        lse[((long)b * H + h) * Sq + row] = (m_run[r] + log2f(l_run[r])) * kLn2;
    }
  }
}

// ---------------------------------------------------------------------------
// backward: delta = rowsum(dO * O), then dq and dk/dv, both recomputing P
// ---------------------------------------------------------------------------

template <int D>
__global__ void flash_delta_kernel(const bf16* __restrict__ o,
                                   const bf16* __restrict__ dout,
                                   float* __restrict__ delta, int B, int H,
                                   int Sq) {
  // one thread per (b, s, h) row; the row's D values are contiguous
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const long total = (long)B * Sq * H;
  if (idx >= total) return;
  const int h = (int)(idx % H);
  const long bs = idx / H;
  const int s = (int)(bs % Sq);
  const int b = (int)(bs / Sq);
  const __nv_bfloat162* op = reinterpret_cast<const __nv_bfloat162*>(o + idx * D);
  const __nv_bfloat162* dp = reinterpret_cast<const __nv_bfloat162*>(dout + idx * D);
  float acc = 0.f;
#pragma unroll 4
  for (int i = 0; i < D / 2; ++i) {
    const float2 a = __bfloat1622float2(op[i]);
    const float2 c = __bfloat1622float2(dp[i]);
    acc += a.x * c.x + a.y * c.y;
  }
  delta[((long)b * H + h) * Sq + s] = acc;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, bf16* __restrict__ dq,
                        int H, int Sq, int Sk, float scale) {
  using G = Geo<D>;
  constexpr int LD = G::LD;
  constexpr int BN = 64;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sO = sQ + kRows * LD;  // dO
  bf16* sK = sO + kRows * LD;
  bf16* sV = sK + BN * LD;

  const int b = blockIdx.z, h = blockIdx.y, m0 = blockIdx.x * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const long HD = (long)H * D;
  const float sl2 = scale * kLog2e;
  const int nrows = min(kRows, Sq - m0);

  load_rows<D>(sQ, q + ((long)b * Sq + m0) * HD + h * D, HD, kRows, nrows);
  load_rows<D>(sO, dout + ((long)b * Sq + m0) * HD + h * D, HD, kRows, nrows);
  const bf16* kb = k + (long)b * Sk * HD + h * D;
  const bf16* vb = v + (long)b * Sk * HD + h * D;
  const int r0 = warp * 16;

  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = m0 + r0 + (lane >> 2) + r * 8;
    const long i = ((long)b * H + h) * Sq + row;
    lse2[r] = row < Sq ? lse[i] * kLog2e : 0.f;
    dl[r] = row < Sq ? delta[i] : 0.f;
  }

  float acc[G::NT][4];
#pragma unroll
  for (int i = 0; i < G::NT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int n0 = 0; n0 < Sk; n0 += BN) {
    __syncthreads();
    const int nvalid = min(BN, Sk - n0);
    load_rows<D>(sK, kb + (long)n0 * HD, HD, BN, nvalid);
    load_rows<D>(sV, vb + (long)n0 * HD, HD, BN, nvalid);
    __syncthreads();

    float s[BN / 8][4], dp[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < G::KS; ++kk) {
      uint32_t aq[4], ao[4];
      frag_a<LD>(aq, sQ, r0, kk * 16, lane);
      frag_a<LD>(ao, sO, r0, kk * 16, lane);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        uint32_t bk[2], bv[2];
        frag_b_t<LD>(bk, sK, j * 8, kk * 16, lane);
        frag_b_t<LD>(bv, sV, j * 8, kk * 16, lane);
        mma16816(s[j], aq, bk);
        mma16816(dp[j], ao, bv);
      }
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + t * 2 + (e & 1);
        const float p = col < nvalid ? exp2f(s[j][e] * sl2 - lse2[e >> 1]) : 0.f;
        s[j][e] = p * (dp[j][e] - dl[e >> 1]) * scale;  // dS
      }
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t a[4];
      acc_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int nt = 0; nt < G::NT; ++nt) {
        uint32_t bb[2];
        frag_b<LD>(bb, sK, kk * 16, nt * 8, lane);
        mma16816(acc[nt], a, bb);
      }
    }
  }
  const float one[2] = {1.f, 1.f};
  store_acc<D>(dq + (long)b * Sq * HD + h * D, HD, m0 + r0, Sq, acc, one, lane);
}

// dk/dv: the block owns 64 keys and streams query tiles of BQ rows.  BQ is
// smaller at D=160 so that the two f32 accumulator blocks plus the two
// transposed score tiles stay in registers.
template <int D, int BQ>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, bf16* __restrict__ dk,
                         bf16* __restrict__ dv, int H, int Sq, int Sk,
                         float scale) {
  using G = Geo<D>;
  constexpr int LD = G::LD;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + kRows * LD;
  bf16* sQ = sV + kRows * LD;
  bf16* sO = sQ + BQ * LD;  // dO
  float* sL = reinterpret_cast<float*>(sO + BQ * LD);
  float* sD = sL + BQ;

  const int b = blockIdx.z, h = blockIdx.y, n0 = blockIdx.x * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const long HD = (long)H * D;
  const float sl2 = scale * kLog2e;
  const int nkeys = min(kRows, Sk - n0);

  load_rows<D>(sK, k + ((long)b * Sk + n0) * HD + h * D, HD, kRows, nkeys);
  load_rows<D>(sV, v + ((long)b * Sk + n0) * HD + h * D, HD, kRows, nkeys);
  const bf16* qb = q + (long)b * Sq * HD + h * D;
  const bf16* ob = dout + (long)b * Sq * HD + h * D;
  const float* lb = lse + ((long)b * H + h) * Sq;
  const float* db = delta + ((long)b * H + h) * Sq;
  const int r0 = warp * 16;

  float accK[G::NT][4], accV[G::NT][4];
#pragma unroll
  for (int i = 0; i < G::NT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) accK[i][e] = accV[i][e] = 0.f;

  for (int m0 = 0; m0 < Sq; m0 += BQ) {
    __syncthreads();
    const int mvalid = min(BQ, Sq - m0);
    load_rows<D>(sQ, qb + (long)m0 * HD, HD, BQ, mvalid);
    load_rows<D>(sO, ob + (long)m0 * HD, HD, BQ, mvalid);
    for (int i = threadIdx.x; i < BQ; i += kThreads) {
      // an absent query row gets lse = +inf, so its probabilities are 0
      sL[i] = i < mvalid ? lb[m0 + i] * kLog2e : INFINITY;
      sD[i] = i < mvalid ? db[m0 + i] : 0.f;
    }
    __syncthreads();

    // transposed scores: rows are this warp's 16 keys, columns are queries
    float st[BQ / 8][4], dpt[BQ / 8][4];
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < G::KS; ++kk) {
      uint32_t ak[4], av[4];
      frag_a<LD>(ak, sK, r0, kk * 16, lane);
      frag_a<LD>(av, sV, r0, kk * 16, lane);
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        uint32_t bq[2], bo[2];
        frag_b_t<LD>(bq, sQ, j * 8, kk * 16, lane);
        frag_b_t<LD>(bo, sO, j * 8, kk * 16, lane);
        mma16816(st[j], ak, bq);
        mma16816(dpt[j], av, bo);
      }
    }
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + t * 2 + (e & 1);
        const float p = exp2f(st[j][e] * sl2 - sL[col]);
        st[j][e] = p;
        dpt[j][e] = p * (dpt[j][e] - sD[col]) * scale;  // dS^T
      }
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t ap[4], as[4];
      acc_to_a(ap, st[2 * kk], st[2 * kk + 1]);
      acc_to_a(as, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
      for (int nt = 0; nt < G::NT; ++nt) {
        uint32_t bo[2], bq[2];
        frag_b<LD>(bo, sO, kk * 16, nt * 8, lane);
        frag_b<LD>(bq, sQ, kk * 16, nt * 8, lane);
        mma16816(accV[nt], ap, bo);
        mma16816(accK[nt], as, bq);
      }
    }
  }
  const float one[2] = {1.f, 1.f};
  store_acc<D>(dk + (long)b * Sk * HD + h * D, HD, n0 + r0, Sk, accK, one, lane);
  store_acc<D>(dv + (long)b * Sk * HD + h * D, HD, n0 + r0, Sk, accV, one, lane);
}

// Launch the forward for head dim D (40, 80 or 160; else -1): out and the
// LSE of q (B, Sq, H*D) against k/v batch b / kv_div (B / kv_div, Sk, H*D).
template <int D>
int flash_fwd(const bf16* q, const bf16* k, const bf16* v, bf16* o, float* lse,
              int B, int H, int Sq, int Sk, float scale, int kv_div,
              cudaStream_t st) {
  constexpr int LD = Geo<D>::LD;
  const size_t smem = (size_t)(kRows + 2 * 64) * LD * sizeof(bf16);
  cudaFuncSetAttribute(flash_fwd_kernel<D>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  dim3 grid((Sq + kRows - 1) / kRows, H, B);
  flash_fwd_kernel<D><<<grid, kThreads, smem, st>>>(q, k, v, o, lse, H, Sq, Sk,
                                                      scale, kv_div);
  return (int)cudaGetLastError();
}

inline int flash_fwd(int D, const bf16* q, const bf16* k, const bf16* v, bf16* o,
                     float* lse, int B, int H, int Sq, int Sk, float scale,
                     int kv_div, cudaStream_t st) {
  switch (D) {
    case 40: return flash_fwd<40>(q, k, v, o, lse, B, H, Sq, Sk, scale, kv_div, st);
    case 80: return flash_fwd<80>(q, k, v, o, lse, B, H, Sq, Sk, scale, kv_div, st);
    case 160: return flash_fwd<160>(q, k, v, o, lse, B, H, Sq, Sk, scale, kv_div, st);
    default: return -1;
  }
}

}  // namespace
