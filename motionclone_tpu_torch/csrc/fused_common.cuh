// Device code shared by the fused forward modules (fused_resnet.cu,
// fused_temporal.cu, fused_block.cu): the normalisation passes and the
// arguments of their TMA + wgmma product (GemmArgs, fused_product.cuh).
//
// Normalisation.  Every product of the TPU kernels reads a normalised
// activation rounded to bf16: LN(h) (+ the positional encoding), the
// per-(batch·frame) GroupNorm affine (then SiLU), or the f32 residual
// stream cast to bf16.  Here one pass writes that bf16 operand and the
// product reads it, with the same rounding point:
//   ln_rows_kernel   one warp per row: (mean, rstd) in f32 from the row held
//                    in registers, then (x - mean) * rstd * g + b (+ pe);
//   gn_apply_kernel  x * w[bf, c] + b[bf, c] (then SiLU), or a plain cast.
// GroupNorm statistics span a whole frame (S pixels x C/G channels), so no
// tile can form them: gn_partial_kernel sums x and x^2 per (frame, pixel
// chunk, channel) and gn_finalize_kernel reduces the chunks per group in a
// fixed order (no atomics, so every run gives the same bits) and folds mean
// and rstd with the norm's scale and bias.  Variances are E[x^2] - E[x]^2
// clamped at 0, as the TPU kernels form them.  A first version applied the
// normalisation as each product loaded A: every block of the product's N
// columns redid it (15-45 times per element at the main path's shapes,
// 9 more for the conv's taps), and the products were bound by that
// arithmetic at 60-75 TFLOP/s; the extra bf16 write and read of a pass
// costs ~25 us per (16, 4096, 320) activation.
//
// The product's arguments.  C[m, n] = sum_k A[m, k] * B[n, k], A bf16 (M, K)
// row-major and B stored as nn.Linear stores its weight, (N, K) row-major;
// for the convolution, A is the (BF, H, W, Cin) video and k = tap * Cin +
// ci.  The epilogue adds a bias, the temb row of the video that row m
// belongs to (the convolution's), and a residual (f32 or bf16), then
// stores f32 or bf16, rounding once; or, with GEGLU, it pairs the
// interleaved columns (2j, 2j + 1) as (value, gate) and stores value *
// gelu_erf(gate) at column j.  A split store writes column n to chunk n /
// ldo of the output, which lays q, k and v (or k and v) out as separate
// contiguous tensors.

#pragma once

#include "flash_attention.cuh"  // bf16, pack_f32

namespace {
namespace fz {

constexpr int kThreads = 256;  // threads per block of the norm passes

struct GemmArgs {
  const bf16* a;  // (M, K) row-major, or the (BF·H·W, Cin) video for the conv
  const bf16* b;  // (N, K) row-major
  int M, N, K;
  int H, W, Cin;  // conv geometry
  // epilogue
  const float* bias;   // (N) or null
  const bf16* temb;    // (videos, N) or null: row m's video is m / temb_rows
  long temb_rows;      // rows per video (frames · pixels)
  const void* res;     // (M, N) or null
  int res_f32;
  void* out;
  int out_f32;
  int ldo;             // output row length (N, N/2 with GEGLU, or the split width)
  long chunk_stride;   // elements between split chunks
};

__device__ __forceinline__ void load8(const bf16* p, float v[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float v[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ uint4 pack8(const float v[8]) {
  uint4 u;
  u.x = pack_f32(v[0], v[1]);
  u.y = pack_f32(v[2], v[3]);
  u.z = pack_f32(v[4], v[5]);
  u.w = pack_f32(v[6], v[7]);
  return u;
}

__device__ __forceinline__ float silu(float x) { return x / (1.f + __expf(-x)); }

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
}

// ---------------------------------------------------------------------------
// normalisation
// ---------------------------------------------------------------------------

constexpr int kRowChunks = 4;  // ln_rows_kernel holds K <= 32 * 8 * 4 = 1024

// One warp per row of x (M, K): out = (x - mean) * rstd * g + b (+ pe[f])
// in bf16, f = (row / rows_per_frame) % frames.  K % 8 == 0, K <= 1024.
template <typename TA>
__global__ void __launch_bounds__(kThreads)
    ln_rows_kernel(const TA* __restrict__ x, const float* __restrict__ gamma,
                   const float* __restrict__ beta, const bf16* __restrict__ pe,
                   bf16* __restrict__ out, int M, int K, int rows_per_frame,
                   int frames, float eps) {
  const int row = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  float v[kRowChunks][8];
  float s = 0.f, q = 0.f;
#pragma unroll
  for (int c = 0; c < kRowChunks; ++c) {
    const int k = (c * 32 + lane) * 8;
    if (k < K) {
      load8(x + (long)row * K + k, v[c]);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        s += v[c][i];
        q += v[c][i] * v[c][i];
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    q += __shfl_xor_sync(0xffffffffu, q, o);
  }
  const float mean = s / K;
  const float rstd = rsqrtf(fmaxf(q / K - mean * mean, 0.f) + eps);
  const int f = (row / rows_per_frame) % frames;
#pragma unroll
  for (int c = 0; c < kRowChunks; ++c) {
    const int k = (c * 32 + lane) * 8;
    if (k < K) {
      float w[8], b[8], y[8];
      load8(gamma + k, w);
      load8(beta + k, b);
#pragma unroll
      for (int i = 0; i < 8; ++i) y[i] = (v[c][i] - mean) * rstd * w[i] + b[i];
      if (pe != nullptr) {
        float p[8];
        load8(pe + (long)f * K + k, p);
#pragma unroll
        for (int i = 0; i < 8; ++i) y[i] += p[i];
      }
      *reinterpret_cast<uint4*>(out + (long)row * K + k) = pack8(y);
    }
  }
}

// out = x * w[bf, c] + b[bf, c] (then SiLU) in bf16 over (BF·S, C), one
// 8-wide chunk per thread; with w == null, a plain cast.
template <typename TA>
__global__ void __launch_bounds__(kThreads)
    gn_apply_kernel(const TA* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ b, bf16* __restrict__ out,
                    long chunks, int S, int C, int silu_on) {
  const long i = (long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= chunks) return;
  const long e = i * 8;
  float v[8];
  load8(x + e, v);
  if (w != nullptr) {
    const long row = e / C;
    const long p = (row / S) * C + (e - row * C);
    float ww[8], bb[8];
    load8(w + p, ww);
    load8(b + p, bb);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      v[j] = v[j] * ww[j] + bb[j];
      if (silu_on) v[j] = silu(v[j]);
    }
  }
  *reinterpret_cast<uint4*>(out + e) = pack8(v);
}

constexpr int kStatThreads = 512;

// Per (frame bf, pixel chunk): sums of x and x^2 per channel, into
// part[((bf * nch + chunk) * 2 + {0, 1}) * C + c].  Thread (pixel lane,
// 8-channel group) strides over the chunk's pixels; the pixel lanes are
// then added in a fixed order through shared memory.  C % 8 == 0,
// C <= 8 * kStatThreads.
template <typename TA>
__global__ void __launch_bounds__(kStatThreads)
    gn_partial_kernel(const TA* __restrict__ x, float* __restrict__ part, int S,
                      int C, int nch) {
  __shared__ float red[2][kStatThreads * 8];
  const int chunk = blockIdx.x, bf = blockIdx.y;
  const int cc = C / 8, lanes = kStatThreads / cc;
  const int pl = threadIdx.x / cc, c8 = threadIdx.x - pl * cc;
  const int per = (S + nch - 1) / nch;
  const int p0 = chunk * per, p1 = min(S, p0 + per);
  float s[8], q[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i] = q[i] = 0.f;
  if (pl < lanes) {
    for (int p = p0 + pl; p < p1; p += lanes) {
      float v[8];
      load8(x + ((long)bf * S + p) * C + c8 * 8, v);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        s[i] += v[i];
        q[i] += v[i] * v[i];
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      red[0][pl * C + c8 * 8 + i] = s[i];
      red[1][pl * C + c8 * 8 + i] = q[i];
    }
  }
  __syncthreads();
  float* out = part + ((long)bf * nch + chunk) * 2 * C;
  for (int c = threadIdx.x; c < C; c += kStatThreads) {
    float ts = 0.f, tq = 0.f;
    for (int l = 0; l < lanes; ++l) {
      ts += red[0][l * C + c];
      tq += red[1][l * C + c];
    }
    out[c] = ts;
    out[C + c] = tq;
  }
}

// Per frame bf: one warp per group reduces the chunks' sums in a fixed
// order and writes the folded affine w = rstd * gamma, b = beta - mean * w.
__global__ void __launch_bounds__(kThreads)
    gn_finalize_kernel(const float* __restrict__ part, const float* __restrict__ gamma,
                       const float* __restrict__ beta, float* __restrict__ gw,
                       float* __restrict__ gb, int S, int C, int G, int nch,
                       float eps) {
  const int bf = blockIdx.x, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cg = C / G;
  const float* pb = part + (long)bf * nch * 2 * C;
  for (int grp = warp; grp < G; grp += kThreads / 32) {
    float s = 0.f, q = 0.f;
    for (int i = lane; i < nch * cg; i += 32) {
      const int ch = i / cg, c = grp * cg + i % cg;
      s += pb[(long)ch * 2 * C + c];
      q += pb[(long)ch * 2 * C + C + c];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      q += __shfl_xor_sync(0xffffffffu, q, o);
    }
    const float n = (float)S * cg;
    const float mean = s / n;
    const float rstd = rsqrtf(fmaxf(q / n - mean * mean, 0.f) + eps);
    for (int c = grp * cg + lane; c < (grp + 1) * cg; c += 32) {
      const float w = rstd * gamma[c];
      gw[(long)bf * C + c] = w;
      gb[(long)bf * C + c] = beta[c] - mean * w;
    }
  }
}

// ---------------------------------------------------------------------------
// host launchers: each returns cudaGetLastError() after its launches, or -1
// for a shape they do not take
// ---------------------------------------------------------------------------

#define MC_CHECK(expr)            \
  do {                            \
    const int mc_err_ = (expr);   \
    if (mc_err_) return mc_err_;  \
  } while (0)

// GroupNorm of the (BF, S, C) tensor x folded to the affine (gw, gb), both
// (BF, C) f32.  part holds BF * nch * 2 * C floats.
template <typename TA>
int group_norm_affine(const TA* x, const float* gamma, const float* beta,
                      float* part, float* gw, float* gb, int BF, int S, int C,
                      int G, int nch, float eps, cudaStream_t st) {
  if (C % 8 || C % G || C > 8 * kStatThreads) return -1;
  gn_partial_kernel<TA><<<dim3(nch, BF), kStatThreads, 0, st>>>(x, part, S, C, nch);
  MC_CHECK((int)cudaGetLastError());
  gn_finalize_kernel<<<BF, kThreads, 0, st>>>(part, gamma, beta, gw, gb, S, C,
                                              G, nch, eps);
  return (int)cudaGetLastError();
}

// The GroupNorm affine (w, b: (BF, C)) of the (BF, S, C) tensor x, then
// SiLU if asked, written as bf16; with w == null, x cast to bf16.
template <typename TA>
int group_norm_apply(const TA* x, const float* w, const float* b, bf16* out,
                     int BF, int S, int C, bool silu_on, cudaStream_t st) {
  if (C % 8) return -1;
  const long chunks = (long)BF * S * C / 8;
  gn_apply_kernel<TA><<<(unsigned)((chunks + kThreads - 1) / kThreads), kThreads, 0, st>>>(
      x, w, b, out, chunks, S, C, silu_on ? 1 : 0);
  return (int)cudaGetLastError();
}

// LayerNorm of the rows of x (M, K) (+ pe (frames, K)), written as bf16.
template <typename TA>
int layer_norm_rows(const TA* x, const float* gamma, const float* beta,
                    const bf16* pe, bf16* out, int M, int K, int rows_per_frame,
                    int frames, float eps, cudaStream_t st) {
  if (K % 8 || K > 256 * kRowChunks) return -1;
  const int rows = kThreads / 32;
  ln_rows_kernel<TA><<<(M + rows - 1) / rows, kThreads, 0, st>>>(
      x, gamma, beta, pe, out, M, K, rows_per_frame, frames, eps);
  return (int)cudaGetLastError();
}

// A GemmArgs for the product out = a @ b^T (+ bias), one output chunk.
inline GemmArgs gemm_args(const void* a, const void* b, const void* bias,
                          void* out, int out_f32, int M, int N, int K) {
  GemmArgs g = {};
  g.a = (const bf16*)a;
  g.b = (const bf16*)b;
  g.M = M;
  g.N = N;
  g.K = K;
  g.bias = (const float*)bias;
  g.temb_rows = 1;
  g.out = out;
  g.out_f32 = out_f32;
  g.ldo = N;
  g.chunk_stride = 0;
  return g;
}

// Split the product's N columns into chunks of `width` columns, stored as
// separate contiguous (M, width) tensors.
inline void split_output(GemmArgs& g, int width) {
  g.ldo = width;
  g.chunk_stride = (long)g.M * width;
}

}  // namespace fz
}  // namespace
