// Device code of the per-pixel temporal attention kernels (see
// temporal_attention.cu for the design note).  Included by
// temporal_attention.cu (the C entry points of kernels 3, 4, 3r and 4r) and
// by fused_temporal.cu, whose motion module runs the same square forward
// kernel.  Everything has internal linkage.
//
// The kernels are templated on the query frames FQ and the key/value frames
// FK.  The square form (FQ = FK = 16) is kernels 3 and 4; the rectangular
// form (FQ in {1, 2, 4, 8}, FK = 16) is kernels 3r and 4r, where a frame
// shard's local queries attend to the keys and values gathered over all
// shards.  A block holds the same TP pixels in every form, sized from the
// K/V tiles, and has FK * TP threads: one per (pixel, key frame), of which
// the first FQ * TP also take one (pixel, query frame) row each.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kF = 16;  // frames: the motion module's video length (K/V of every form)

// Shared tile layout [frame][pixel][D]; the frame stride is padded by 8
// elements to stagger frames across banks while keeping rows 16-byte aligned.
template <int D, int TP>
struct Tile {
  static constexpr int FS = TP * D + 8;
  static constexpr int CH = D / 8;  // 16-byte chunks per pixel row
};

// Copy the block's (NF frames x TP pixels x D) slice between global and
// shared memory; pixels >= npix are zero on load and skipped on store.
template <int D, int TP, int NF, bool kLoad>
__device__ __forceinline__ void tile_io(bf16* sm, bf16* g, int S, int C,
                                        int npix, int nthreads) {
  using T = Tile<D, TP>;
  for (int i = threadIdx.x; i < NF * TP * T::CH; i += nthreads) {
    const int f = i / (TP * T::CH);
    const int r = i - f * (TP * T::CH);
    const int p = r / T::CH, c = r - p * T::CH;
    uint4* s = reinterpret_cast<uint4*>(sm + f * T::FS + p * D + c * 8);
    uint4* gp = reinterpret_cast<uint4*>(g + ((long)f * S + p) * C + c * 8);
    if (kLoad) {
      *s = p < npix ? *gp : make_uint4(0u, 0u, 0u, 0u);
    } else if (p < npix) {
      *gp = *s;
    }
  }
}

// out[j] = a_row . B_j for the N frames j of the thread's pixel, f32
template <int D, int TP, int N>
__device__ __forceinline__ void row_dots(float out[N], const bf16* a_row,
                                         const bf16* sB, int p) {
  using T = Tile<D, TP>;
#pragma unroll
  for (int j = 0; j < N; ++j) out[j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; d += 2) {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(a_row + d));
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float2 bb = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(sB + j * T::FS + p * D + d));
      out[j] += a.x * bb.x + a.y * bb.y;
    }
  }
}

// out_row[d] = sum_j w[j] * M_j[d] over the N frames j of the thread's
// pixel, written as bf16
template <int D, int TP, int N>
__device__ __forceinline__ void row_combine(bf16* out_row, const float w[N],
                                            const bf16* sM, int p) {
  using T = Tile<D, TP>;
#pragma unroll 2
  for (int d = 0; d < D; d += 2) {
    float x = 0.f, y = 0.f;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float2 m = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(sM + j * T::FS + p * D + d));
      x += w[j] * m.x;
      y += w[j] * m.y;
    }
    *reinterpret_cast<__nv_bfloat162*>(out_row + d) = __floats2bfloat162_rn(x, y);
  }
}

// q, o: (B, FQ, S, H*D); k, v: (B, FK, S, H*D); lse: (B, S, H, FQ) f32.
template <int D, int TP, int FQ, int FK>
__global__ void __launch_bounds__(FK * TP)
    temporal_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, bf16* __restrict__ o,
                        float* __restrict__ lse, int S, int H, float scale) {
  using T = Tile<D, TP>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + FQ * T::FS;
  bf16* sV = sK + FK * T::FS;

  const int b = blockIdx.z, h = blockIdx.y, s0 = blockIdx.x * TP;
  const int C = H * D;
  const int npix = min(TP, S - s0);
  const long qbase = ((long)b * FQ * S + s0) * C + h * D;
  const long kbase = ((long)b * FK * S + s0) * C + h * D;
  constexpr int nt = FK * TP;
  tile_io<D, TP, FQ, true>(sQ, const_cast<bf16*>(q) + qbase, S, C, npix, nt);
  tile_io<D, TP, FK, true>(sK, const_cast<bf16*>(k) + kbase, S, C, npix, nt);
  tile_io<D, TP, FK, true>(sV, const_cast<bf16*>(v) + kbase, S, C, npix, nt);
  __syncthreads();

  if (threadIdx.x < FQ * TP) {
    const int i = threadIdx.x % FQ, p = threadIdx.x / FQ;
    bf16* q_row = sQ + i * T::FS + p * D;
    float w[FK];
    row_dots<D, TP, FK>(w, q_row, sK, p);
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < FK; ++j) {
      w[j] *= scale;
      m = fmaxf(m, w[j]);
    }
    float l = 0.f;
#pragma unroll
    for (int j = 0; j < FK; ++j) {
      w[j] = __expf(w[j] - m);
      l += w[j];
    }
    const float inv = 1.f / l;
#pragma unroll
    for (int j = 0; j < FK; ++j) w[j] *= inv;
    if (p < npix) lse[(((long)b * S + s0 + p) * H + h) * FQ + i] = m + __logf(l);
    // the thread's own q row is no longer read by anyone: write out over it
    row_combine<D, TP, FK>(q_row, w, sV, p);
  }
  __syncthreads();
  tile_io<D, TP, FQ, false>(sQ, o + qbase, S, C, npix, nt);
}

// Backward: phase 1, thread (pixel, query frame i) forms row i of P and dS;
// phase 2, thread (pixel, query frame r) forms dq_r = sum_j dS[r,j] k_j, then
// thread (pixel, key frame r) forms dk_r = sum_i dS[i,r] q_i and
// dv_r = sum_i P[i,r] dO_i, each staged through one shared output tile so the
// stores stay 16-byte and contiguous.
template <int D, int TP, int FQ, int FK>
__global__ void __launch_bounds__(FK * TP)
    temporal_bwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const float* __restrict__ lse,
                        const bf16* __restrict__ dout, bf16* __restrict__ dq,
                        bf16* __restrict__ dk, bf16* __restrict__ dv, int S,
                        int H, float scale) {
  using T = Tile<D, TP>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + FQ * T::FS;
  bf16* sV = sK + FK * T::FS;
  bf16* sO = sV + FK * T::FS;  // dO
  bf16* sX = sO + FQ * T::FS;  // output staging, FK frames
  float* sP = reinterpret_cast<float*>(sX + FK * T::FS);  // [TP][FQ][FK]
  float* sS = sP + TP * FQ * FK;                          // dS, same layout

  const int b = blockIdx.z, h = blockIdx.y, s0 = blockIdx.x * TP;
  const int C = H * D;
  const int npix = min(TP, S - s0);
  const long qbase = ((long)b * FQ * S + s0) * C + h * D;
  const long kbase = ((long)b * FK * S + s0) * C + h * D;
  constexpr int nt = FK * TP;
  tile_io<D, TP, FQ, true>(sQ, const_cast<bf16*>(q) + qbase, S, C, npix, nt);
  tile_io<D, TP, FK, true>(sK, const_cast<bf16*>(k) + kbase, S, C, npix, nt);
  tile_io<D, TP, FK, true>(sV, const_cast<bf16*>(v) + kbase, S, C, npix, nt);
  tile_io<D, TP, FQ, true>(sO, const_cast<bf16*>(dout) + qbase, S, C, npix, nt);
  __syncthreads();

  const bool q_thread = threadIdx.x < FQ * TP;
  const int i = threadIdx.x % FQ, pq = threadIdx.x / FQ;
  if (q_thread) {
    float s[FK], dp[FK];
    row_dots<D, TP, FK>(s, sQ + i * T::FS + pq * D, sK, pq);
    row_dots<D, TP, FK>(dp, sO + i * T::FS + pq * D, sV, pq);
    const float l = pq < npix ? lse[(((long)b * S + s0 + pq) * H + h) * FQ + i] : 0.f;
    float delta = 0.f;
#pragma unroll
    for (int j = 0; j < FK; ++j) {
      s[j] = __expf(s[j] * scale - l);
      delta += s[j] * dp[j];  // rowsum(dO * O) = sum_j P_ij dP_ij
    }
    float* rowP = sP + (pq * FQ + i) * FK;
    float* rowS = sS + (pq * FQ + i) * FK;
#pragma unroll
    for (int j = 0; j < FK; ++j) {
      rowP[j] = s[j];
      rowS[j] = s[j] * (dp[j] - delta) * scale;
    }
  }
  __syncthreads();

  // dq_r = sum_j dS[r, j] k_j, r over the FQ query frames
  if (q_thread) {
    float w[FK];
#pragma unroll
    for (int j = 0; j < FK; ++j) w[j] = sS[(pq * FQ + i) * FK + j];
    row_combine<D, TP, FK>(sX + i * T::FS + pq * D, w, sK, pq);
  }
  __syncthreads();
  tile_io<D, TP, FQ, false>(sX, dq + qbase, S, C, npix, nt);
  __syncthreads();
  // thread (pixel, key frame r) for dk and dv
  const int r = threadIdx.x % FK, p = threadIdx.x / FK;
  bf16* x_row = sX + r * T::FS + p * D;
  float w[FQ];
  // dk_r = sum_i dS[i, r] q_i
#pragma unroll
  for (int j = 0; j < FQ; ++j) w[j] = sS[(p * FQ + j) * FK + r];
  row_combine<D, TP, FQ>(x_row, w, sQ, p);
  __syncthreads();
  tile_io<D, TP, FK, false>(sX, dk + kbase, S, C, npix, nt);
  __syncthreads();
  // dv_r = sum_i P[i, r] dO_i
#pragma unroll
  for (int j = 0; j < FQ; ++j) w[j] = sP[(p * FQ + j) * FK + r];
  row_combine<D, TP, FQ>(x_row, w, sO, p);
  __syncthreads();
  tile_io<D, TP, FK, false>(sX, dv + kbase, S, C, npix, nt);
}

// pixels per block of the forward (the backward takes half): a tile of 16
// frames of k or v is ~20 KB at every head dim
template <int D>
constexpr int pixels_per_block() {
  return D <= 40 ? 16 : (D <= 80 ? 8 : 4);
}

// Launch the forward for head dim D over q (B, FQ, S, H*D) and k, v
// (B, FK, S, H*D).
template <int D, int FQ, int FK>
int temporal_fwd(const bf16* q, const bf16* k, const bf16* v, bf16* o, float* lse,
                 int B, int S, int H, float scale, cudaStream_t st) {
  constexpr int TP = pixels_per_block<D>();
  const size_t smem = (FQ + 2 * FK) * Tile<D, TP>::FS * sizeof(bf16);
  cudaFuncSetAttribute(temporal_fwd_kernel<D, TP, FQ, FK>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  dim3 grid((S + TP - 1) / TP, H, B);
  temporal_fwd_kernel<D, TP, FQ, FK><<<grid, FK * TP, smem, st>>>(q, k, v, o, lse, S, H,
                                                                   scale);
  return (int)cudaGetLastError();
}

template <int FQ>
int temporal_fwd_fq(int D, const bf16* q, const bf16* k, const bf16* v, bf16* o,
                    float* lse, int B, int S, int H, float scale, cudaStream_t st) {
  switch (D) {
    case 40: return temporal_fwd<40, FQ, kF>(q, k, v, o, lse, B, S, H, scale, st);
    case 80: return temporal_fwd<80, FQ, kF>(q, k, v, o, lse, B, S, H, scale, st);
    case 160: return temporal_fwd<160, FQ, kF>(q, k, v, o, lse, B, S, H, scale, st);
    default: return -1;
  }
}

// The forward for head dim D (40, 80 or 160) and FQ query frames (16, the
// square form, or 8, 4, 2, 1) against kF key/value frames; -1 for a shape
// with no kernel.
inline int temporal_fwd(int D, int FQ, const bf16* q, const bf16* k, const bf16* v,
                        bf16* o, float* lse, int B, int S, int H, float scale,
                        cudaStream_t st) {
  switch (FQ) {
    case kF: return temporal_fwd_fq<kF>(D, q, k, v, o, lse, B, S, H, scale, st);
    case 8: return temporal_fwd_fq<8>(D, q, k, v, o, lse, B, S, H, scale, st);
    case 4: return temporal_fwd_fq<4>(D, q, k, v, o, lse, B, S, H, scale, st);
    case 2: return temporal_fwd_fq<2>(D, q, k, v, o, lse, B, S, H, scale, st);
    case 1: return temporal_fwd_fq<1>(D, q, k, v, o, lse, B, S, H, scale, st);
    default: return -1;
  }
}

}  // namespace
