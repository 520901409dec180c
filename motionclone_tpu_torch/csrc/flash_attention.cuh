// Device code of the exact multi-head attention kernels (see
// flash_attention.cu for the design note): the forward, the backward's dq
// kernel (which also forms delta = rowsum(dO * O)) and its dk/dv kernel, all
// on wgmma with cp.async rings (wgmma.cuh).  Included by flash_attention.cu
// (the C entry points of kernels 1 and 2) and by fused_block.cu, whose
// spatial transformer runs the same forward for its self- and
// cross-attention through flash_fwd(D, ...).  Everything has internal
// linkage.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

namespace fa {

constexpr int kWG = 2;              // warpgroups per block of the backward
constexpr int kThreads = 128 * kWG;
constexpr int kRows = 64 * kWG;     // the block's own rows: queries (dq), keys (dk/dv)
constexpr int kStages = 3;          // ring of the streamed side's tiles (backward)
constexpr int kFwdStages = 4;       // the forward's: tiles j-1 (V), j (K), j+1, j+2

// Head dim D padded to the product's depth of 16 in shared memory (40 ->
// 48; the pad columns are zero).  An output of D columns is a valid wgmma
// width (a multiple of 8), so only the reduction over d is padded.
template <int D>
struct Geo {
  static constexpr int DP = (D + 15) / 16 * 16;
  static constexpr int KS = DP / 16;           // k-steps over d
  static constexpr int KSTEP = 2 * DP * 16 / 16;  // descriptor units per 16 tile rows
  static constexpr int TILE = DP * 2;           // bytes per tile row
};

// Keys per step of the forward and of dq, queries per step of dk/dv, and
// the forward's warpgroups per block (four share each K/V tile at D <= 80,
// which halves the tiles' traffic from L2; at D = 160 a thread's
// accumulators leave room for two).  The widths keep each kernel's
// accumulators in registers at D = 160.
template <int D>
struct Tiles {
  static constexpr int FWD_BN = 64;
  static constexpr int FWD_WG = D > 80 ? 2 : 4;  // warpgroups of the forward's block
  static constexpr int DQ_BN = 64;
  static constexpr int DKV_BQ = D > 80 ? 32 : 64;
};

// 2^x on the special-function unit (ex2.approx: 2 ulp; 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int R>
__device__ __forceinline__ void keep_u32(uint32_t (&a)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e])::"memory");
}

// The accumulator of an m64nN product, columns 16kk..16kk+15 of each
// warp's 16 rows, rounded to bf16 as the A fragment of the next product:
// the C layout of one product is the A layout of the next.
template <int R>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[R / 8][4], const float (&c)[R]) {
#pragma unroll
  for (int kk = 0; kk < R / 8; ++kk) {
    a[kk][0] = pack_f32(c[8 * kk + 0], c[8 * kk + 1]);
    a[kk][1] = pack_f32(c[8 * kk + 2], c[8 * kk + 3]);
    a[kk][2] = pack_f32(c[8 * kk + 4], c[8 * kk + 5]);
    a[kk][3] = pack_f32(c[8 * kk + 6], c[8 * kk + 7]);
  }
}

// Write a thread's share of an m64nD accumulator as bf16: rows row0 and
// row0 + 8 (global), columns 8j + 2t, 8j + 2t + 1; rows >= nrows skipped.
template <int D>
__device__ __forceinline__ void store_rows(bf16* g, long gstride, int row0, int nrows,
                                           const float (&acc)[D / 2], const float scale[2],
                                           int t) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + half * 8;
    if (row >= nrows) continue;
    bf16* p = g + (long)row * gstride + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(p + 8 * j) = __floats2bfloat162_rn(
          acc[4 * j + 2 * half] * scale[half], acc[4 * j + 2 * half + 1] * scale[half]);
  }
}

template <int D>
constexpr size_t fwd_smem() {  // Q, the ring, its full and empty mbarriers
  return (size_t)(64 * Tiles<D>::FWD_WG + kFwdStages * 2 * Tiles<D>::FWD_BN) * Geo<D>::TILE +
         2 * kFwdStages * 8;
}
template <int D>
constexpr size_t dq_smem() {
  return (size_t)(2 * kRows + kStages * 2 * Tiles<D>::DQ_BN) * Geo<D>::TILE + kRows * 4;
}
template <int D>
constexpr size_t dkv_smem() {
  return (size_t)(2 * kRows + kStages * 2 * Tiles<D>::DKV_BQ) * Geo<D>::TILE +
         kStages * 2 * Tiles<D>::DKV_BQ * 4;
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

// One block: 64 * NWG query rows of one (batch, head), 64 per warpgroup,
// sharing K/V tiles of BN keys that stream through a ring of kFwdStages
// stages, two tiles ahead of the products.  Every thread copies its share
// of a tile with cp.async; a stage's "full" mbarrier completes when all of
// them have landed, its "empty" one when every thread is done with the
// tile.  So the warpgroups wait for each other only through the ring, and
// run out of step: one's softmax overlaps another's products.  Within a
// warpgroup, step j issues S_j = Q K_j^T and O += P_{j-1} V_{j-1} together,
// then runs the softmax of S_j while the tensor cores work on both.
template <int D, int BN, int NWG>
__global__ void __launch_bounds__(128 * NWG, 1)
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse, int H, int Sq, int Sk, float scale,
                     int kv_div) {
  using G = Geo<D>;
  constexpr int NT = 128 * NWG, ROWS = 64 * NWG;
  constexpr int DP = G::DP, TB = BN * G::TILE, ST = kFwdStages;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* sQ = smem;
  unsigned char* sKV = smem + ROWS * G::TILE;  // stage s: K at s * 2TB, V at + TB
  uint64_t* full = reinterpret_cast<uint64_t*>(sKV + ST * 2 * TB);
  uint64_t* empty = full + ST;

  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31, t = lane & 3;
  const int row0 = wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);  // and row0 + 8
  const int b = blockIdx.z, h = blockIdx.y, m0 = blockIdx.x * ROWS;
  const long HD = (long)H * D;
  const float sl2 = scale * kLog2e;
  // k/v batch b / kv_div: the fused transformer's cross-attention shares
  // one video's text keys among its frames (kv_div = frames; else 1)
  const bf16* kb = k + (long)(b / kv_div) * Sk * HD + h * D;
  const bf16* vb = v + (long)(b / kv_div) * Sk * HD + h * D;
  const int ntiles = (Sk + BN - 1) / BN;

  if (tid == 0) {
    for (int i = 0; i < ST; ++i) {
      mbar_init(full + i, NT);
      mbar_init(empty + i, NT);
    }
    mbar_init_fence();
  }
  zero_pad<D, DP, ROWS, NT>(sQ, tid);
  zero_pad<D, DP, 2 * ST * BN, NT>(sKV, tid);
  __syncthreads();

  const TileCopy<D, DP, BN, NT> copy_kv(tid, H * D);
  auto issue = [&](int j) {  // this thread's share of tile j
    if (j >= ntiles) return;
    const int st = j % ST;
    if (j >= ST) mbar_wait(empty + st, (j / ST - 1) & 1);  // tile j - ST released
    unsigned char* s = sKV + st * 2 * TB;
    copy_kv(s, kb + (long)j * BN * HD, Sk - j * BN);
    copy_kv(s + TB, vb + (long)j * BN * HD, Sk - j * BN);
    cp_arrive(full + st);
  };
  auto ready = [&](int j) {
    mbar_wait(full + j % ST, (j / ST) & 1);
    fence_async_smem();
  };
  TileCopy<D, DP, ROWS, NT>(tid, H * D)(sQ, q + ((long)b * Sq + m0) * HD + h * D, Sq - m0);
  issue(0);
  issue(1);
  issue(2);
  cp_commit();
  cp_wait<0>();  // Q
  fence_async_smem();
  __syncthreads();

  const uint64_t dQ = desc_kmajor<DP>(sQ + wg * 64 * G::TILE);
  auto qk = [&](float(&d)[BN / 2], int j) {
    const uint64_t dK = desc_kmajor<DP>(sKV + (j % ST) * 2 * TB);
#pragma unroll
    for (int kk = 0; kk < G::KS; ++kk) wgmma_ss<BN>(d, dQ + kk * 16, dK + kk * 16, kk);
  };
  float s[BN / 2], acc[D / 2];
  uint32_t pa[BN / 16][4];  // P of the previous tile, the A operand of P V
  auto pv = [&](int j) {
    const uint64_t dV = desc_mnmajor<DP>(sKV + (j % ST) * 2 * TB + TB);
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) wgmma_rs<D>(acc, pa[kk], dV + kk * G::KSTEP, 1);
  };
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // per-thread partial row sums

  // Online softmax of tile j in s, in base 2 on raw scores: s becomes P,
  // m_run the new row maximum; corr rescales the older sums.
  auto softmax = [&](int j, float corr[2], float ps[2]) {
    const int kval = Sk - j * BN;
    if (kval < BN) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i)
        if ((i >> 2) * 8 + 2 * t + (i & 1) >= kval) s[i] = -INFINITY;
    }
    float mx[2] = {m_run[0], m_run[1]}, mb[2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = ex2((m_run[r] - mx[r]) * sl2);
      m_run[r] = mx[r];
      mb[r] = mx[r] * sl2;
      ps[r] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      s[i] = ex2(fmaf(s[i], sl2, -mb[(i >> 1) & 1]));
      ps[(i >> 1) & 1] += s[i];
    }
  };

  ready(0);
  wg_fence();
  qk(s, 0);
  wg_commit();
  wg_wait<0>();
  wg_keep(s);
  {
    float corr[2], ps[2];
    softmax(0, corr, ps);
    l_run[0] = ps[0];
    l_run[1] = ps[1];
    acc_to_a<BN / 2>(pa, s);
  }
  for (int j = 1; j < ntiles; ++j) {
    issue(j + 2);  // into the stage of tile j - 2
    ready(j);
    wg_fence();
    qk(s, j);
    wg_commit();
    pv(j - 1);
    wg_commit();
    wg_wait<1>();  // S_j; P_{j-1} V_{j-1} may still run
    wg_keep(s);
    float corr[2], ps[2];
    softmax(j, corr, ps);
    wg_wait<0>();
    wg_keep(acc);
    keep_u32(pa);
    mbar_arrive(empty + (j - 1) % ST);  // this thread is done with tile j - 1
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * corr[r] + ps[r];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
    acc_to_a<BN / 2>(pa, s);
  }
  wg_fence();
  pv(ntiles - 1);
  wg_commit();
  wg_wait<0>();
  wg_keep(acc);
  keep_u32(pa);

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    inv[r] = 1.f / l_run[r];
  }
  store_rows<D>(o + (long)b * Sq * HD + h * D, HD, m0 + row0, Sq, acc, inv, t);
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = m0 + row0 + r * 8;
      if (row < Sq)
        lse[((long)b * H + h) * Sq + row] = (m_run[r] * sl2 + log2f(l_run[r])) * kLn2;
    }
  }
}

// ---------------------------------------------------------------------------
// backward: dq (with delta) over key tiles, then dk/dv over query tiles
// ---------------------------------------------------------------------------

// One block: 128 query rows, 64 per warpgroup.  First delta = rowsum(dO *
// O) of its rows (two threads a row, written for the dk/dv kernel); then
// per K/V tile S = Q K^T and dP = dO V^T, dS = P (dP - delta) * scale,
// dQ += dS K with K read MN-major.
template <int D, int BN>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ o,
                        const bf16* __restrict__ dout, const float* __restrict__ lse,
                        float* __restrict__ delta, bf16* __restrict__ dq, int H, int Sq,
                        int Sk, float scale) {
  using G = Geo<D>;
  constexpr int DP = G::DP, QB = kRows * G::TILE, TB = BN * G::TILE;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* sQ = smem;
  unsigned char* sO = smem + QB;  // dO
  unsigned char* sKV = smem + 2 * QB;
  float* sDl = reinterpret_cast<float*>(sKV + kStages * 2 * TB);

  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31, t = lane & 3;
  const int row0 = wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
  const int b = blockIdx.z, h = blockIdx.y, m0 = blockIdx.x * kRows;
  const long HD = (long)H * D;
  const float sl2 = scale * kLog2e;
  const bf16* kb = k + (long)b * Sk * HD + h * D;
  const bf16* vb = v + (long)b * Sk * HD + h * D;
  const int ntiles = (Sk + BN - 1) / BN;

  zero_pad<D, DP, 2 * kRows, kThreads>(sQ, tid);
  zero_pad<D, DP, 2 * kStages * BN, kThreads>(sKV, tid);
  const TileCopy<D, DP, BN, kThreads> copy_kv(tid, H * D);
  auto load_kv = [&](int j) {
    unsigned char* s = sKV + (j % kStages) * 2 * TB;
    copy_kv(s, kb + (long)j * BN * HD, Sk - j * BN);
    copy_kv(s + TB, vb + (long)j * BN * HD, Sk - j * BN);
  };
  const long qoff = ((long)b * Sq + m0) * HD + h * D;
  {
    const TileCopy<D, DP, kRows, kThreads> copy_q(tid, H * D);
    copy_q(sQ, q + qoff, Sq - m0);
    copy_q(sO, dout + qoff, Sq - m0);
  }
  load_kv(0);
  cp_commit();
  if (ntiles > 1) load_kv(1);
  cp_commit();

  {  // delta, while the copies fly
    const int r = tid >> 1, half = tid & 1, row = m0 + r;
    float a = 0.f;
    if (row < Sq) {
      const long off = qoff + (long)r * HD + half * (D / 2);
      const __nv_bfloat162* op = reinterpret_cast<const __nv_bfloat162*>(o + off);
      const __nv_bfloat162* dp = reinterpret_cast<const __nv_bfloat162*>(dout + off);
#pragma unroll
      for (int i = 0; i < D / 4; ++i) {
        const float2 x = __bfloat1622float2(op[i]);
        const float2 y = __bfloat1622float2(dp[i]);
        a = fmaf(x.x, y.x, fmaf(x.y, y.y, a));
      }
    }
    a += __shfl_xor_sync(0xffffffffu, a, 1);
    if (half == 0) {
      sDl[r] = a;
      if (row < Sq) delta[((long)b * H + h) * Sq + row] = a;
    }
  }
  float lse2[2], dl[2];
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = m0 + row0 + r * 8;
    lse2[r] = row < Sq ? lse[((long)b * H + h) * Sq + row] * kLog2e : 0.f;
    dl[r] = sDl[row0 + r * 8];
  }

  const uint64_t dQ = desc_kmajor<DP>(sQ + wg * 64 * G::TILE);
  const uint64_t dO = desc_kmajor<DP>(sO + wg * 64 * G::TILE);
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  for (int j = 0; j < ntiles; ++j) {
    cp_wait<1>();
    fence_async_smem();
    __syncthreads();
    if (j + 2 < ntiles) load_kv(j + 2);
    cp_commit();
    unsigned char* sK = sKV + (j % kStages) * 2 * TB;
    const uint64_t dK = desc_kmajor<DP>(sK), dV = desc_kmajor<DP>(sK + TB);
    float s[BN / 2], dp[BN / 2];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < G::KS; ++kk) wgmma_ss<BN>(s, dQ + kk * 16, dK + kk * 16, kk);
#pragma unroll
    for (int kk = 0; kk < G::KS; ++kk) wgmma_ss<BN>(dp, dO + kk * 16, dV + kk * 16, kk);
    wg_commit();
    wg_wait<0>();
    wg_keep(s);
    wg_keep(dp);

    const int kval = Sk - j * BN;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int r = (i >> 1) & 1;
      const float p = (i >> 2) * 8 + 2 * t + (i & 1) < kval
                          ? ex2(fmaf(s[i], sl2, -lse2[r])) : 0.f;
      s[i] = p * (dp[i] - dl[r]) * scale;  // dS
    }
    uint32_t pa[BN / 16][4];
    acc_to_a<BN / 2>(pa, s);
    const uint64_t dKt = desc_mnmajor<DP>(sK);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) wgmma_rs<D>(acc, pa[kk], dKt + kk * G::KSTEP, 1);
    wg_commit();
    wg_wait<0>();
    wg_keep(acc);
    keep_u32(pa);
  }
  const float one[2] = {1.f, 1.f};
  store_rows<D>(dq + (long)b * Sq * HD + h * D, HD, m0 + row0, Sq, acc, one, t);
}

// One block: 128 keys, 64 per warpgroup; tiles of BQ queries (Q, dO, LSE,
// delta) stream through the ring.  Per tile, transposed: S^T = K Q^T,
// dP^T = V dO^T, P^T, dS^T = P^T (dP^T - delta) * scale; dV += P^T dO and
// dK += dS^T Q with dO and Q read MN-major.
template <int D, int BQ>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int Sq,
                         int Sk, float scale) {
  using G = Geo<D>;
  constexpr int DP = G::DP, KB = kRows * G::TILE, TB = BQ * G::TILE;
  constexpr int SB = 2 * TB + 2 * BQ * 4;  // stage: Q, dO, LSE, delta
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* sK = smem;
  unsigned char* sV = smem + KB;
  unsigned char* sQO = smem + 2 * KB;

  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31, t = lane & 3;
  const int row0 = wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
  const int b = blockIdx.z, h = blockIdx.y, n0 = blockIdx.x * kRows;
  const long HD = (long)H * D;
  const float sl2 = scale * kLog2e;
  const bf16* qb = q + (long)b * Sq * HD + h * D;
  const bf16* ob = dout + (long)b * Sq * HD + h * D;
  const float* lb = lse + ((long)b * H + h) * Sq;
  const float* db = delta + ((long)b * H + h) * Sq;
  const int ntiles = (Sq + BQ - 1) / BQ;

  zero_pad<D, DP, 2 * kRows, kThreads>(sK, tid);
  for (int st = 0; st < kStages; ++st) zero_pad<D, DP, 2 * BQ, kThreads>(sQO + st * SB, tid);
  // absent query rows load as zeros (Q, dO, LSE and delta), which makes
  // their dS^T and their dO rows zero: they add nothing
  const TileCopy<D, DP, BQ, kThreads> copy_q(tid, H * D);
  auto load_q = [&](int i) {
    unsigned char* s = sQO + (i % kStages) * SB;
    const int m0 = i * BQ;
    copy_q(s, qb + (long)m0 * HD, Sq - m0);
    copy_q(s + TB, ob + (long)m0 * HD, Sq - m0);
    if (tid < BQ) {
      const bool ok = m0 + tid < Sq;
      float* sl = reinterpret_cast<float*>(s + 2 * TB);
      cp4(sl + tid, ok ? lb + m0 + tid : lb, ok);
      cp4(sl + BQ + tid, ok ? db + m0 + tid : db, ok);
    }
  };
  const long koff = ((long)b * Sk + n0) * HD + h * D;
  {
    const TileCopy<D, DP, kRows, kThreads> copy_k(tid, H * D);
    copy_k(sK, k + koff, Sk - n0);
    copy_k(sV, v + koff, Sk - n0);
  }
  load_q(0);
  cp_commit();
  if (ntiles > 1) load_q(1);
  cp_commit();

  const uint64_t dK = desc_kmajor<DP>(sK + wg * 64 * G::TILE);
  const uint64_t dV = desc_kmajor<DP>(sV + wg * 64 * G::TILE);
  float accK[D / 2], accV[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) accK[i] = accV[i] = 0.f;

  for (int i = 0; i < ntiles; ++i) {
    cp_wait<1>();
    fence_async_smem();
    __syncthreads();
    if (i + 2 < ntiles) load_q(i + 2);
    cp_commit();
    unsigned char* s = sQO + (i % kStages) * SB;
    const float* sL = reinterpret_cast<const float*>(s + 2 * TB);
    const float* sD = sL + BQ;
    float st[BQ / 2], dpt[BQ / 2];
    const uint64_t dQ = desc_kmajor<DP>(s), dO = desc_kmajor<DP>(s + TB);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < G::KS; ++kk) wgmma_ss<BQ>(st, dK + kk * 16, dQ + kk * 16, kk);
#pragma unroll
    for (int kk = 0; kk < G::KS; ++kk) wgmma_ss<BQ>(dpt, dV + kk * 16, dO + kk * 16, kk);
    wg_commit();
    wg_wait<0>();
    wg_keep(st);
    wg_keep(dpt);

#pragma unroll
    for (int e = 0; e < BQ / 2; ++e) {
      const int col = (e >> 2) * 8 + 2 * t + (e & 1);
      const float p = ex2(fmaf(st[e], sl2, -sL[col] * kLog2e));
      st[e] = p;
      dpt[e] = p * (dpt[e] - sD[col]) * scale;  // dS^T
    }
    uint32_t pp[BQ / 16][4], ps[BQ / 16][4];
    acc_to_a<BQ / 2>(pp, st);
    acc_to_a<BQ / 2>(ps, dpt);
    const uint64_t dQt = desc_mnmajor<DP>(s), dOt = desc_mnmajor<DP>(s + TB);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      wgmma_rs<D>(accV, pp[kk], dOt + kk * G::KSTEP, 1);
      wgmma_rs<D>(accK, ps[kk], dQt + kk * G::KSTEP, 1);
    }
    wg_commit();
    wg_wait<0>();
    wg_keep(accV);
    wg_keep(accK);
    keep_u32(pp);
    keep_u32(ps);
  }
  const float one[2] = {1.f, 1.f};
  store_rows<D>(dk + (long)b * Sk * HD + h * D, HD, n0 + row0, Sk, accK, one, t);
  store_rows<D>(dv + (long)b * Sk * HD + h * D, HD, n0 + row0, Sk, accV, one, t);
}

}  // namespace fa

// Launch the forward for head dim D (40, 64, 80 or 160; else -1): out and the
// LSE of q (B, Sq, H*D) against k/v batch b / kv_div (B / kv_div, Sk, H*D).
template <int D>
int flash_fwd(const bf16* q, const bf16* k, const bf16* v, bf16* o, float* lse,
              int B, int H, int Sq, int Sk, float scale, int kv_div,
              cudaStream_t st) {
  constexpr int BN = fa::Tiles<D>::FWD_BN, NWG = fa::Tiles<D>::FWD_WG;
  constexpr size_t smem = fa::fwd_smem<D>();
  cudaFuncSetAttribute(fa::flash_fwd_kernel<D, BN, NWG>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  dim3 grid((Sq + 64 * NWG - 1) / (64 * NWG), H, B);
  fa::flash_fwd_kernel<D, BN, NWG><<<grid, 128 * NWG, smem, st>>>(q, k, v, o, lse, H, Sq,
                                                                   Sk, scale, kv_div);
  return (int)cudaGetLastError();
}

inline int flash_fwd(int D, const bf16* q, const bf16* k, const bf16* v, bf16* o,
                     float* lse, int B, int H, int Sq, int Sk, float scale,
                     int kv_div, cudaStream_t st) {
  switch (D) {
    case 40: return flash_fwd<40>(q, k, v, o, lse, B, H, Sq, Sk, scale, kv_div, st);
    case 64: return flash_fwd<64>(q, k, v, o, lse, B, H, Sq, Sk, scale, kv_div, st);
    case 80: return flash_fwd<80>(q, k, v, o, lse, B, H, Sq, Sk, scale, kv_div, st);
    case 160: return flash_fwd<160>(q, k, v, o, lse, B, H, Sq, Sk, scale, kv_div, st);
    default: return -1;
  }
}

}  // namespace
