// Device code shared by the fused forward modules (fused_resnet.cu,
// fused_temporal.cu, fused_block.cu): the normalisation passes, the
// product's arguments (GemmArgs) and a bf16 mma.sync matrix product with a
// fusing epilogue.  That product now serves the fused resnet (kernel 8)
// alone; the spatial transformer and the motion module (kernels 5-7) run
// the TMA + wgmma product of fused_product.cuh on the same GemmArgs.
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
// The product.  C[m, n] = sum_k A[m, k] * B[n, k], A bf16 (M, K) row-major
// and B stored as nn.Linear stores its weight, (N, K) row-major; for the
// convolution (CONV), A is the (BF, H, W, Cin) video and k = tap * Cin + ci:
// the implicit-GEMM 3x3 convolution (padding 1), whose loader gathers tap
// (dy, dx) of pixel m and zero-fills outside the frame.  The epilogue adds
// a bias, the temb row of the video that row m belongs to, and a residual
// (f32 or bf16), then stores f32 or bf16; or, with GEGLU, it pairs the
// interleaved columns (2j, 2j + 1) that one thread holds as (value, gate)
// and stores value * gelu_erf(gate) at column j.  A split store writes
// column n to chunk n / ldo of the output, which lays q, k and v (or k and
// v) out as separate contiguous tensors.
//
// What bounds it on the H100: at the main path's shapes (M = B·F·S up to
// 131072 rows, K and N 320-5120) a product does 2·K flops per output
// element against ~2 bytes per input, far above the card's ~295 flops per
// byte: it is bound by the tensor cores.  The design: a 128 x BN x 64 block
// tile (8 warps, each 32 x BN/2, mma.sync m16n8k16 bf16 with f32
// accumulation, fragments read with ldmatrix) and a ring of three cp.async
// stages, so two tiles are in flight while one is multiplied.  Each thread
// copies the same rows and the same k column of every tile, so its rows'
// geometry is worked out once per block and the conv's (tap, channel)
// advances with k.  It reaches 126-190 TFLOP/s on the H100; the conv's
// gather loader (taps, zero fill at frame edges) is what keeps it off
// fused_product.cuh's TMA loads for now.

#pragma once

#include "flash_attention.cuh"  // bf16, pack_f32

namespace {
namespace fz {

// c += a @ b for one m16n8k16 tile (a row-major 16x16, b "col" 16x8).
__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

constexpr int kThreads = 256;  // 8 warps: 4 along M x 2 along N
constexpr int BM = 128;
constexpr int BK = 64;
constexpr int LDS = BK + 8;  // shared row stride: 144 bytes, staggers banks
constexpr int STAGES = 3;

struct GemmArgs {
  const bf16* a;  // (M, K) row-major, or the (BF*H*W, Cin) video for the conv
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

// ldmatrix: four 8x8 b16 matrices from shared memory, one row address per
// lane (lanes 8i..8i+7 give the rows of matrix i).
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const bf16* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  // src-size 0 writes zeros and reads nothing
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(a), "l"(gmem),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// What a thread knows of one of the A rows it copies, fixed for the block:
// the row's (for the conv: the frame's) pointer and the conv's pixel.
struct ARow {
  const bf16* base;
  int ok, y, x;
};

template <bool CONV>
__device__ __forceinline__ void init_row(const GemmArgs& g, int m, ARow& r) {
  r.ok = m < g.M;
  const int mm = r.ok ? m : 0;
  if constexpr (CONV) {
    const int hw = g.H * g.W;
    const int bf = mm / hw, p = mm - bf * hw;
    r.y = p / g.W;
    r.x = p - r.y * g.W;
    r.base = g.a + (long)bf * hw * g.Cin;
  } else {
    r.base = g.a + (long)mm * g.K;
  }
}

// Start the copy of one 8-wide A chunk (column k; the conv's tap and input
// channel) into shared memory; zeros past the matrix's or the frame's edge.
template <bool CONV>
__device__ __forceinline__ void copy_a(const GemmArgs& g, const ARow& r, int k,
                                        int tap, int ci, bf16* dst) {
  const bf16* src = r.base;
  bool ok = r.ok && k < g.K;
  if constexpr (CONV) {
    const int y = r.y + tap / 3 - 1, x = r.x + tap % 3 - 1;
    ok = ok && y >= 0 && y < g.H && x >= 0 && x < g.W;
    if (ok) src += ((long)y * g.W + x) * g.Cin + ci;
  } else if (ok) {
    src += k;
  }
  cp_async16(dst, src, ok);
}

__device__ __forceinline__ void copy_b(const GemmArgs& g, int n, int k, bf16* dst) {
  const bool ok = n < g.N && k < g.K;
  cp_async16(dst, ok ? g.b + (long)n * g.K + k : g.b, ok);
}

template <bool GEGLU>
__device__ __forceinline__ void epilogue(const GemmArgs& g, int m, int n,
                                         float v0, float v1) {
  if (m >= g.M || n >= g.N) return;
  if (g.bias != nullptr) {
    v0 += g.bias[n];
    v1 += g.bias[n + 1];
  }
  if (g.temb != nullptr) {
    const long vid = m / g.temb_rows;
    const float2 t = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(g.temb + vid * g.N + n));
    v0 += t.x;
    v1 += t.y;
  }
  if constexpr (GEGLU) {
    // columns (2j, 2j + 1) are (value j, gate j) of the interleaved weight
    const float y = v0 * gelu_erf(v1);
    const long idx = (long)m * g.ldo + n / 2;
    if (g.out_f32)
      reinterpret_cast<float*>(g.out)[idx] = y;
    else
      reinterpret_cast<bf16*>(g.out)[idx] = __float2bfloat16(y);
    return;
  }
  if (g.res != nullptr) {
    const long r = (long)m * g.N + n;
    if (g.res_f32) {
      const float2 x = *reinterpret_cast<const float2*>(
          reinterpret_cast<const float*>(g.res) + r);
      v0 += x.x;
      v1 += x.y;
    } else {
      const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
          reinterpret_cast<const bf16*>(g.res) + r));
      v0 += x.x;
      v1 += x.y;
    }
  }
  const int chunk = n / g.ldo;
  const long idx = chunk * g.chunk_stride + (long)m * g.ldo + (n - chunk * g.ldo);
  if (g.out_f32)
    *reinterpret_cast<float2*>(reinterpret_cast<float*>(g.out) + idx) =
        make_float2(v0, v1);
  else
    *reinterpret_cast<__nv_bfloat162*>(reinterpret_cast<bf16*>(g.out) + idx) =
        __floats2bfloat162_rn(v0, v1);
}

template <int BN>
constexpr int gemm_smem_bytes() {
  return STAGES * (BM + BN) * LDS * 2;
}

template <bool CONV, int BN, bool GEGLU>
__global__ void __launch_bounds__(kThreads) gemm_kernel(const GemmArgs g) {
  constexpr int CPR = BK / 8;                   // 16-byte chunks per tile row
  constexpr int AC = BM * CPR / kThreads;       // A chunks per thread: 4
  constexpr int BC = BN * CPR / kThreads;       // B chunks per thread: 2 or 4
  constexpr int WN = BN / 2;                    // warp tile: 32 x WN
  constexpr int NT = WN / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sA = reinterpret_cast<bf16*>(smem);  // [STAGES][BM][LDS]
  bf16* sB = sA + STAGES * BM * LDS;         // [STAGES][BN][LDS]

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = (warp & 3) * 32, wn = (warp >> 2) * WN;
  const int kc = (tid % CPR) * 8;  // the thread's column within a k-tile

  ARow rows[AC];
#pragma unroll
  for (int j = 0; j < AC; ++j) init_row<CONV>(g, m0 + (tid + j * kThreads) / CPR, rows[j]);
  int tap = 0, ci = kc;  // the conv's (tap, input channel) of the next tile
  if constexpr (CONV) {
    tap = kc / g.Cin;
    ci = kc - tap * g.Cin;
  }
  auto fetch = [&](int t) {
    const int slot = t % STAGES, k = t * BK + kc;
#pragma unroll
    for (int j = 0; j < AC; ++j) {
      const int r = (tid + j * kThreads) / CPR;
      copy_a<CONV>(g, rows[j], k, tap, ci, sA + (slot * BM + r) * LDS + kc);
    }
#pragma unroll
    for (int j = 0; j < BC; ++j) {
      const int n = (tid + j * kThreads) / CPR;
      copy_b(g, n0 + n, k, sB + (slot * BN + n) * LDS + kc);
    }
    if constexpr (CONV) {
      ci += BK;
      while (ci >= g.Cin) {
        ci -= g.Cin;
        ++tap;
      }
    }
  };

  float acc[2][NT][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < NT; ++b) acc[a][b][0] = acc[a][b][1] = acc[a][b][2] = acc[a][b][3] = 0.f;

  // ldmatrix row addresses: A rows wm + a*16 + (lane & 15), column half
  // lane >> 4; B rows (two n-tiles) wn + (lane & 7) + ((lane >> 4) << 3),
  // column half (lane >> 3) & 1
  const int a_off = (wm + (lane & 15)) * LDS + (lane >> 4) * 8;
  const int b_off = (wn + (lane & 7) + ((lane >> 4) << 3)) * LDS + ((lane >> 3) & 1) * 8;
  const int nk = (g.K + BK - 1) / BK;

#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < nk) fetch(t);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of tile kt have landed
    __syncthreads();              // everyone's have; slot (kt - 1) is free
    if (kt + STAGES - 1 < nk) fetch(kt + STAGES - 1);
    cp_async_commit();
    const bf16* a_t = sA + (kt % STAGES) * BM * LDS;
    const bf16* b_t = sB + (kt % STAGES) * BN * LDS;
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      uint32_t af[2][4];
#pragma unroll
      for (int a = 0; a < 2; ++a) ldsm_x4(af[a], a_t + a_off + a * 16 * LDS + ks * 16);
#pragma unroll
      for (int bp = 0; bp < NT / 2; ++bp) {
        uint32_t bfr[4];
        ldsm_x4(bfr, b_t + b_off + bp * 16 * LDS + ks * 16);
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          mma16816(acc[a][2 * bp], af[a], bfr);
          mma16816(acc[a][2 * bp + 1], af[a], bfr + 2);
        }
      }
    }
  }

  const int gi = lane >> 2, t2 = (lane & 3) * 2;
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < NT; ++b) {
      const int m = m0 + wm + a * 16 + gi, n = n0 + wn + b * 8 + t2;
      epilogue<GEGLU>(g, m, n, acc[a][b][0], acc[a][b][1]);
      epilogue<GEGLU>(g, m + 8, n, acc[a][b][2], acc[a][b][3]);
    }
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

template <bool CONV, int BN, bool GEGLU>
int launch_gemm(const GemmArgs& g, cudaStream_t st) {
  const int bytes = gemm_smem_bytes<BN>();
  cudaFuncSetAttribute(gemm_kernel<CONV, BN, GEGLU>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  const dim3 grid((g.N + BN - 1) / BN, (g.M + BM - 1) / BM);
  gemm_kernel<CONV, BN, GEGLU><<<grid, kThreads, bytes, st>>>(g);
  return (int)cudaGetLastError();
}

// Launch the product; BN = 128 where N is a multiple of 128 or above 256
// (the wider tile's better ratio of products to fragment loads outweighs
// the padded columns), else 64.
template <bool CONV = false, bool GEGLU = false>
int gemm(const GemmArgs& g, cudaStream_t st) {
  if (g.K % 8 || g.N % 8 || (CONV && g.Cin % 8)) return -1;
  if (g.N % 128 == 0 || g.N > 256) return launch_gemm<CONV, 128, GEGLU>(g, st);
  return launch_gemm<CONV, 64, GEGLU>(g, st);
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
