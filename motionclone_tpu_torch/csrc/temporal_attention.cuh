// Device code of the per-pixel temporal attention kernels (see
// temporal_attention.cu for the design note).  Included by
// temporal_attention.cu (the C entry points of kernels 3 and 4) and by
// fused_temporal.cu, whose motion module runs the same forward kernel.
// Everything has internal linkage.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kF = 16;  // frames: the motion module's video length

// Shared tile layout [frame][pixel][D]; the frame stride is padded by 8
// elements to stagger frames across banks while keeping rows 16-byte aligned.
template <int D, int TP>
struct Tile {
  static constexpr int FS = TP * D + 8;
  static constexpr int ELEMS = kF * FS;
  static constexpr int CH = D / 8;  // 16-byte chunks per pixel row
};

// Copy the block's (frames x TP pixels x D) slice between global and shared
// memory; pixels >= npix are zero on load and skipped on store.
template <int D, int TP, bool kLoad>
__device__ __forceinline__ void tile_io(bf16* sm, bf16* g, int S, int C,
                                        int npix, int nthreads) {
  using T = Tile<D, TP>;
  for (int i = threadIdx.x; i < kF * TP * T::CH; i += nthreads) {
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

// logits[j] = q_row . k_j for the thread's pixel, f32
template <int D, int TP>
__device__ __forceinline__ void row_dots(float out[kF], const bf16* a_row,
                                         const bf16* sB, int p) {
  using T = Tile<D, TP>;
#pragma unroll
  for (int j = 0; j < kF; ++j) out[j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; d += 2) {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(a_row + d));
#pragma unroll
    for (int j = 0; j < kF; ++j) {
      const float2 bb = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(sB + j * T::FS + p * D + d));
      out[j] += a.x * bb.x + a.y * bb.y;
    }
  }
}

// out_row[d] = sum_j w[j] * M_j[d] for the thread's pixel, written as bf16
template <int D, int TP>
__device__ __forceinline__ void row_combine(bf16* out_row, const float w[kF],
                                            const bf16* sM, int p) {
  using T = Tile<D, TP>;
#pragma unroll 2
  for (int d = 0; d < D; d += 2) {
    float x = 0.f, y = 0.f;
#pragma unroll
    for (int j = 0; j < kF; ++j) {
      const float2 m = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(sM + j * T::FS + p * D + d));
      x += w[j] * m.x;
      y += w[j] * m.y;
    }
    *reinterpret_cast<__nv_bfloat162*>(out_row + d) = __floats2bfloat162_rn(x, y);
  }
}

template <int D, int TP>
__global__ void __launch_bounds__(kF * TP)
    temporal_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, bf16* __restrict__ o,
                        float* __restrict__ lse, int S, int H, float scale) {
  using T = Tile<D, TP>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + T::ELEMS;
  bf16* sV = sK + T::ELEMS;

  const int b = blockIdx.z, h = blockIdx.y, s0 = blockIdx.x * TP;
  const int C = H * D;
  const int npix = min(TP, S - s0);
  const long base = ((long)b * kF * S + s0) * C + h * D;
  constexpr int nt = kF * TP;
  tile_io<D, TP, true>(sQ, const_cast<bf16*>(q) + base, S, C, npix, nt);
  tile_io<D, TP, true>(sK, const_cast<bf16*>(k) + base, S, C, npix, nt);
  tile_io<D, TP, true>(sV, const_cast<bf16*>(v) + base, S, C, npix, nt);
  __syncthreads();

  const int i = threadIdx.x % kF, p = threadIdx.x / kF;
  bf16* q_row = sQ + i * T::FS + p * D;
  float w[kF];
  row_dots<D, TP>(w, q_row, sK, p);
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < kF; ++j) {
    w[j] *= scale;
    m = fmaxf(m, w[j]);
  }
  float l = 0.f;
#pragma unroll
  for (int j = 0; j < kF; ++j) {
    w[j] = __expf(w[j] - m);
    l += w[j];
  }
  const float inv = 1.f / l;
#pragma unroll
  for (int j = 0; j < kF; ++j) w[j] *= inv;
  if (p < npix) lse[(((long)b * S + s0 + p) * H + h) * kF + i] = m + __logf(l);
  // the thread's own q row is no longer read by anyone: write out over it
  row_combine<D, TP>(q_row, w, sV, p);
  __syncthreads();
  tile_io<D, TP, false>(sQ, o + base, S, C, npix, nt);
}

// Backward: phase 1, thread (pixel, query frame i) forms row i of P and dS;
// phase 2, thread (pixel, frame r) forms dq_r = sum_j dS[r,j] k_j,
// dk_r = sum_i dS[i,r] q_i and dv_r = sum_i P[i,r] dO_i, each staged through
// one shared output tile so the stores stay 16-byte and contiguous.
template <int D, int TP>
__global__ void __launch_bounds__(kF * TP)
    temporal_bwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const float* __restrict__ lse,
                        const bf16* __restrict__ dout, bf16* __restrict__ dq,
                        bf16* __restrict__ dk, bf16* __restrict__ dv, int S,
                        int H, float scale) {
  using T = Tile<D, TP>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + T::ELEMS;
  bf16* sV = sK + T::ELEMS;
  bf16* sO = sV + T::ELEMS;  // dO
  bf16* sX = sO + T::ELEMS;  // output staging
  float* sP = reinterpret_cast<float*>(sX + T::ELEMS);  // [TP][F][F]
  float* sS = sP + TP * kF * kF;                        // dS, same layout

  const int b = blockIdx.z, h = blockIdx.y, s0 = blockIdx.x * TP;
  const int C = H * D;
  const int npix = min(TP, S - s0);
  const long base = ((long)b * kF * S + s0) * C + h * D;
  constexpr int nt = kF * TP;
  tile_io<D, TP, true>(sQ, const_cast<bf16*>(q) + base, S, C, npix, nt);
  tile_io<D, TP, true>(sK, const_cast<bf16*>(k) + base, S, C, npix, nt);
  tile_io<D, TP, true>(sV, const_cast<bf16*>(v) + base, S, C, npix, nt);
  tile_io<D, TP, true>(sO, const_cast<bf16*>(dout) + base, S, C, npix, nt);
  __syncthreads();

  const int i = threadIdx.x % kF, p = threadIdx.x / kF;
  {
    float s[kF], dp[kF];
    row_dots<D, TP>(s, sQ + i * T::FS + p * D, sK, p);
    row_dots<D, TP>(dp, sO + i * T::FS + p * D, sV, p);
    const float l = p < npix ? lse[(((long)b * S + s0 + p) * H + h) * kF + i] : 0.f;
    float delta = 0.f;
#pragma unroll
    for (int j = 0; j < kF; ++j) {
      s[j] = __expf(s[j] * scale - l);
      delta += s[j] * dp[j];  // rowsum(dO * O) = sum_j P_ij dP_ij
    }
    float* rowP = sP + (p * kF + i) * kF;
    float* rowS = sS + (p * kF + i) * kF;
#pragma unroll
    for (int j = 0; j < kF; ++j) {
      rowP[j] = s[j];
      rowS[j] = s[j] * (dp[j] - delta) * scale;
    }
  }
  __syncthreads();

  const int r = i;
  bf16* x_row = sX + r * T::FS + p * D;
  float w[kF];
  // dq_r = sum_j dS[r, j] k_j
#pragma unroll
  for (int j = 0; j < kF; ++j) w[j] = sS[(p * kF + r) * kF + j];
  row_combine<D, TP>(x_row, w, sK, p);
  __syncthreads();
  tile_io<D, TP, false>(sX, dq + base, S, C, npix, nt);
  __syncthreads();
  // dk_r = sum_i dS[i, r] q_i
#pragma unroll
  for (int j = 0; j < kF; ++j) w[j] = sS[(p * kF + j) * kF + r];
  row_combine<D, TP>(x_row, w, sQ, p);
  __syncthreads();
  tile_io<D, TP, false>(sX, dk + base, S, C, npix, nt);
  __syncthreads();
  // dv_r = sum_i P[i, r] dO_i
#pragma unroll
  for (int j = 0; j < kF; ++j) w[j] = sP[(p * kF + j) * kF + r];
  row_combine<D, TP>(x_row, w, sO, p);
  __syncthreads();
  tile_io<D, TP, false>(sX, dv + base, S, C, npix, nt);
}

// pixels per block of the forward (the backward takes half): a tile of q, k
// or v is ~20 KB at every head dim
template <int D>
constexpr int pixels_per_block() {
  return D <= 40 ? 16 : (D <= 80 ? 8 : 4);
}

// Launch the forward for head dim D (40, 80 or 160; else -1) over
// (B, kF, S, H*D) tensors.
template <int D>
int temporal_fwd(const bf16* q, const bf16* k, const bf16* v, bf16* o, float* lse,
                 int B, int S, int H, float scale, cudaStream_t st) {
  constexpr int TP = pixels_per_block<D>();
  const size_t smem = 3 * Tile<D, TP>::ELEMS * sizeof(bf16);
  cudaFuncSetAttribute(temporal_fwd_kernel<D, TP>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  dim3 grid((S + TP - 1) / TP, H, B);
  temporal_fwd_kernel<D, TP><<<grid, kF * TP, smem, st>>>(q, k, v, o, lse, S, H, scale);
  return (int)cudaGetLastError();
}

inline int temporal_fwd(int D, const bf16* q, const bf16* k, const bf16* v, bf16* o,
                        float* lse, int B, int S, int H, float scale, cudaStream_t st) {
  switch (D) {
    case 40: return temporal_fwd<40>(q, k, v, o, lse, B, S, H, scale, st);
    case 80: return temporal_fwd<80>(q, k, v, o, lse, B, S, H, scale, st);
    case 160: return temporal_fwd<160>(q, k, v, o, lse, B, S, H, scale, st);
    default: return -1;
  }
}

}  // namespace
