// GroupNorm (then SiLU, optionally), forward and backward, for sm_90a.
//
// Replaces no Pallas kernel: the JAX package leaves GroupNorm
// (motionclone_tpu/models/layers.py `group_norm`) to XLA, which fuses its
// reductions and its elementwise chain.  On the card the port ran the same
// chain eagerly (models/layers.py `group_norm_nhwc`, then F.silu): a cast to
// f32, two means, a square, a subtract, an rsqrt multiply, the affine and a
// cast back, about 64 bytes of traffic an element, and autograd's backward
// over it about 90-100 bytes an element, keeping three f32 copies of the
// input alive for it.  The guided step's conditional pass differentiates
// every GroupNorm before its cut, so that chain ran there.
//
// What bounds it on the H100: bytes.  x is (N, S, C), channels last, bf16 or
// f32; statistics per (sample n, group) over S pixels x C/G channels, in f32.
// Such a group spans a whole sample, so no block can form them: each
// direction is a reduction pass over (sample, pixel chunk) blocks, a
// fixed-order reduction of the chunks per group, and an elementwise pass.
//   forward   x read twice, y written once (in x's dtype);
//   backward  x and dy read twice, dx written once, with x̂ and the SiLU's
//             derivative recomputed from x and the saved (mean, rstd).
// So the state kept for the backward is x and (mean, rstd) per (sample,
// group): nothing of x's size in f32.  Arithmetic as the plain version's:
// variance E[x^2] - E[x]^2 clamped at 0, eps inside the rsqrt, then (x -
// mean) * (rstd * gamma) + beta (rstd * gamma rounded once: within an f32
// ulp of the plain order), then SiLU, one rounding to the output dtype.
// The affine parameters are constants here: the backward gives dx alone,
// dx = rstd * (g·gamma - mean(g·gamma) - x̂ · mean(g·gamma·x̂)) per group,
// g = dy (times SiLU'(z), z = x̂·gamma + beta).
//
// Layout of the per-channel passes: a block is C / 8 channel lanes of 8
// channels x `lanes` pixel lanes (256 threads, or C / 8 where C > 2048); a
// thread keeps its 8 channels' parameters in registers and strides over its
// chunk's pixels two at a time, both 16-byte loads in flight before either
// is used (a memory-bound pass needs ~25 KB in flight an SM: a first version
// with one load a thread and 512-thread blocks, 86-88 registers, held one
// block an SM and moved 1.4-1.8 TB/s).  The forward's statistics are the
// fused modules' pass (fz::gn_partial_kernel), whose layout the backward's
// reduction shares: per-lane sums added in a fixed order through shared
// memory, no atomics, so two launches give the same bits.  SiLU is a
// template parameter, so the plain norm carries none of its registers.

#include "fused_common.cuh"

namespace {
namespace gnk {

using fz::load8;

constexpr int kLaneThreads = 256;   // a block's threads, where C / 8 allows
constexpr int kMaxThreads = 512;    // C <= 8 * 512: a block holds a pixel's lanes
constexpr int kFinalThreads = 256;  // 8 warps, one (sample, group) each

// Pixel lanes of a block: C / 8 channel lanes x pixel_lanes(C) <= 512
// threads (256 where C <= 2048).
__host__ __device__ __forceinline__ int pixel_lanes(int C) {
  const int cc = C / 8;
  return cc >= kLaneThreads ? 1 : kLaneThreads / cc;
}

__device__ __forceinline__ void store8(bf16* p, const float v[8]) {
  *reinterpret_cast<uint4*>(p) = fz::pack8(v);
}

__device__ __forceinline__ void store8(float* p, const float v[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

// The thread's place: channels c0 .. c0 + 7 of sample bf, pixels p0 + pl,
// p0 + pl + lanes, ... below p1 (the chunk blockIdx.x of sample blockIdx.y).
struct Place {
  int bf, c0, pl, lanes, p0, p1;
};

__device__ __forceinline__ Place place(int S, int C, int nch) {
  Place t;
  const int cc = C / 8;
  t.lanes = pixel_lanes(C);
  t.pl = threadIdx.x / cc;
  t.c0 = (threadIdx.x - t.pl * cc) * 8;
  t.bf = blockIdx.y;
  const int per = (S + nch - 1) / nch;
  t.p0 = blockIdx.x * per;
  t.p1 = min(S, t.p0 + per);
  return t;
}

__device__ __forceinline__ long offset(const Place& t, int S, int C, int p) {
  return ((long)t.bf * S + p) * C + t.c0;
}

// Per channel j of the thread's 8: the group's mean m, A = rstd * gamma and
// beta, so that x̂ * gamma + beta = (x - m) * A + beta; with coef ((BF, G,
// 2) of the backward, or null) P = rstd * coef0 and Q = rstd^2 * coef1, so
// that dx = A * g - P - Q * (x - m).
struct Chan {
  float m[8], a[8], b[8], p[8], q[8];
};

__device__ __forceinline__ void load_chan(Chan& k, const float* __restrict__ stats,
                                          const float* __restrict__ gamma,
                                          const float* __restrict__ beta,
                                          const float* __restrict__ coef, int bf, int BF,
                                          int G, int cg, int c0) {
  int g = c0 / cg, i = c0 - g * cg;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (i == cg) {
      ++g;
      i = 0;
    }
    const long sg = (long)bf * G + g;
    const float r = stats[(long)BF * G + sg];
    k.m[j] = stats[sg];
    k.a[j] = r * gamma[c0 + j];
    k.b[j] = beta[c0 + j];
    k.p[j] = coef == nullptr ? 0.f : r * coef[2 * sg];
    k.q[j] = coef == nullptr ? 0.f : r * r * coef[2 * sg + 1];
    ++i;
  }
}

// The logistic sigmoid with the fast reciprocal: an IEEE division here made
// the SiLU passes bound by arithmetic, not bytes.
__device__ __forceinline__ float sigmoid(float z) { return __fdividef(1.f, 1.f + __expf(-z)); }

// g = dy, or dy * SiLU'(z).
template <bool SILU>
__device__ __forceinline__ float grad_in(float dy, float z) {
  if (!SILU) return dy;
  const float s = sigmoid(z);
  return dy * s * (1.f + z * (1.f - s));
}

// Two pixels of the thread's 8 channels at a time (the second may be past
// p1): both loads in flight before either is used.
template <typename T>
__device__ __forceinline__ bool load_pair(const T* __restrict__ x, const Place& t, int S, int C,
                                          int p, float v0[8], float v1[8]) {
  load8(x + offset(t, S, C, p), v0);
  const bool second = p + t.lanes < t.p1;
  if (second) {
    load8(x + offset(t, S, C, p + t.lanes), v1);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) v1[j] = 0.f;
  }
  return second;
}

// Per (sample, group): mean and rstd from the chunks' sums of x and x^2
// (fz::gn_partial_kernel's, the fused modules' statistics pass), reduced in
// a fixed order; one warp per (sample, group).
__global__ void __launch_bounds__(kFinalThreads)
    gn_stats_kernel(const float* __restrict__ part, float* __restrict__ stats, int BF,
                    int S, int C, int G, int nch, float eps) {
  const int sg = blockIdx.x * (kFinalThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (sg >= BF * G) return;
  const int bf = sg / G, grp = sg - bf * G, cg = C / G;
  const float* pb = part + (long)bf * nch * 2 * C;
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
  if (lane == 0) {
    const float n = (float)S * cg;
    const float mean = s / n;
    stats[sg] = mean;
    stats[(long)BF * G + sg] = rsqrtf(fmaxf(q / n - mean * mean, 0.f) + eps);
  }
}

// y = (x - mean) * (rstd * gamma) + beta, then SiLU.
template <typename T, bool SILU>
__global__ void __launch_bounds__(kMaxThreads)
    gn_fwd_apply_kernel(const T* __restrict__ x, const float* __restrict__ stats,
                        const float* __restrict__ gamma, const float* __restrict__ beta,
                        T* __restrict__ y, int BF, int S, int C, int G, int nch) {
  const Place t = place(S, C, nch);
  Chan k;
  load_chan(k, stats, gamma, beta, nullptr, t.bf, BF, G, C / G, t.c0);
  for (int p = t.p0 + t.pl; p < t.p1; p += 2 * t.lanes) {
    float v0[8], v1[8];
    const bool second = load_pair(x, t, S, C, p, v0, v1);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      v0[j] = (v0[j] - k.m[j]) * k.a[j] + k.b[j];
      v1[j] = (v1[j] - k.m[j]) * k.a[j] + k.b[j];
      if (SILU) {
        v0[j] *= sigmoid(v0[j]);
        v1[j] *= sigmoid(v1[j]);
      }
    }
    store8(y + offset(t, S, C, p), v0);
    if (second) store8(y + offset(t, S, C, p + t.lanes), v1);
  }
}

// Per (sample, pixel chunk): the sums of g and g * (x - mean) per channel,
// each pixel lane's in shared memory red[2][lanes][C] (dynamic), then added
// over the lanes in a fixed order into part[((bf * nch + chunk) * 2 + {0,
// 1}) * C + c] (fz::gn_partial_kernel's layout).
template <typename T, bool SILU>
__global__ void __launch_bounds__(kMaxThreads)
    gn_bwd_partial_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                          const float* __restrict__ stats, const float* __restrict__ gamma,
                          const float* __restrict__ beta, float* __restrict__ part, int BF,
                          int S, int C, int G, int nch) {
  extern __shared__ float red[];
  const Place t = place(S, C, nch);
  Chan k;
  load_chan(k, stats, gamma, beta, nullptr, t.bf, BF, G, C / G, t.c0);
  float s1[8], s2[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) s1[j] = s2[j] = 0.f;
  for (int p = t.p0 + t.pl; p < t.p1; p += 2 * t.lanes) {
    float v0[8], v1[8], d0[8], d1[8];
    const bool second = load_pair(x, t, S, C, p, v0, v1);
    load_pair(dy, t, S, C, p, d0, d1);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float e0 = v0[j] - k.m[j], e1 = second ? v1[j] - k.m[j] : 0.f;
      const float g0 = grad_in<SILU>(d0[j], e0 * k.a[j] + k.b[j]);
      const float g1 = grad_in<SILU>(d1[j], e1 * k.a[j] + k.b[j]);
      s1[j] += g0 + g1;
      s2[j] += g0 * e0 + g1 * e1;
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    red[t.pl * C + t.c0 + j] = s1[j];
    red[(t.lanes + t.pl) * C + t.c0 + j] = s2[j];
  }
  __syncthreads();
  float* out = part + ((long)t.bf * nch + blockIdx.x) * 2 * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float a = 0.f, b = 0.f;
    for (int l = 0; l < t.lanes; ++l) {
      a += red[l * C + c];
      b += red[(t.lanes + l) * C + c];
    }
    out[c] = a;
    out[C + c] = b;
  }
}

// Per (sample, group): coef = (mean(g·gamma), mean(g·gamma·x̂)) over the
// group from the chunks' per-channel sums of g and g·(x - mean), in a
// fixed order; one warp each.
__global__ void __launch_bounds__(kFinalThreads)
    gn_bwd_coef_kernel(const float* __restrict__ part, const float* __restrict__ stats,
                       const float* __restrict__ gamma, float* __restrict__ coef, int BF,
                       int S, int C, int G, int nch) {
  const int sg = blockIdx.x * (kFinalThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (sg >= BF * G) return;
  const int bf = sg / G, grp = sg - bf * G, cg = C / G;
  const float* pb = part + (long)bf * nch * 2 * C;
  float a = 0.f, b = 0.f;
  for (int i = lane; i < nch * cg; i += 32) {
    const int ch = i / cg, c = grp * cg + i % cg;
    a += gamma[c] * pb[(long)ch * 2 * C + c];
    b += gamma[c] * pb[(long)ch * 2 * C + C + c];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  if (lane == 0) {
    const float n = (float)S * cg;
    coef[2 * sg] = a / n;
    coef[2 * sg + 1] = b * stats[(long)BF * G + sg] / n;
  }
}

// dx = A * g - P - Q * (x - mean) (= rstd * (g·gamma - coef0 - x̂ * coef1)),
// in x's dtype.
template <typename T, bool SILU>
__global__ void __launch_bounds__(kMaxThreads)
    gn_bwd_dx_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                     const float* __restrict__ stats, const float* __restrict__ gamma,
                     const float* __restrict__ beta, const float* __restrict__ coef,
                     T* __restrict__ dx, int BF, int S, int C, int G, int nch) {
  const Place t = place(S, C, nch);
  Chan k;
  load_chan(k, stats, gamma, beta, coef, t.bf, BF, G, C / G, t.c0);
  for (int p = t.p0 + t.pl; p < t.p1; p += 2 * t.lanes) {
    float v0[8], v1[8], d0[8], d1[8];
    const bool second = load_pair(x, t, S, C, p, v0, v1);
    load_pair(dy, t, S, C, p, d0, d1);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float e0 = v0[j] - k.m[j], e1 = v1[j] - k.m[j];
      const float g0 = grad_in<SILU>(d0[j], e0 * k.a[j] + k.b[j]);
      const float g1 = grad_in<SILU>(d1[j], e1 * k.a[j] + k.b[j]);
      v0[j] = k.a[j] * g0 - k.p[j] - k.q[j] * e0;
      v1[j] = k.a[j] * g1 - k.p[j] - k.q[j] * e1;
    }
    store8(dx + offset(t, S, C, p), v0);
    if (second) store8(dx + offset(t, S, C, p + t.lanes), v1);
  }
}

// The shapes every pass takes: C % 8 == 0 (16-byte loads never straddle a
// pixel), G dividing C, C <= 8 * 512 (one block holds a pixel's channels),
// at least one pixel and one chunk, and BF within a grid's y extent.
inline bool takes(int BF, int S, int C, int G, int nch) {
  return BF >= 1 && BF <= 65535 && S >= 1 && nch >= 1 && G >= 1 && C % 8 == 0 &&
         C % G == 0 && C <= 8 * kMaxThreads;
}

inline unsigned final_blocks(int BF, int G) {
  return (unsigned)((BF * G + kFinalThreads / 32 - 1) / (kFinalThreads / 32));
}

// The partial sums' shared memory: two sums a lane and channel.
inline size_t red_bytes(int C) { return (size_t)2 * pixel_lanes(C) * C * sizeof(float); }

template <typename T, bool SILU>
int forward(void* const* p, const int* d, float eps, cudaStream_t st) {
  const int BF = d[0], S = d[1], C = d[2], G = d[3], nch = d[4];
  const T* x = (const T*)p[0];
  float* stats = (float*)p[4];
  float* part = (float*)p[5];
  const dim3 grid(nch, BF);
  const int threads = (C / 8) * pixel_lanes(C);
  fz::gn_partial_kernel<T><<<grid, fz::kStatThreads, 0, st>>>(x, part, S, C, nch);
  MC_CHECK((int)cudaGetLastError());
  gn_stats_kernel<<<final_blocks(BF, G), kFinalThreads, 0, st>>>(part, stats, BF, S, C, G,
                                                                 nch, eps);
  MC_CHECK((int)cudaGetLastError());
  gn_fwd_apply_kernel<T, SILU><<<grid, threads, 0, st>>>(
      x, stats, (const float*)p[1], (const float*)p[2], (T*)p[3], BF, S, C, G, nch);
  return (int)cudaGetLastError();
}

template <typename T, bool SILU>
int backward(void* const* p, const int* d, cudaStream_t st) {
  const int BF = d[0], S = d[1], C = d[2], G = d[3], nch = d[4];
  const T* x = (const T*)p[0];
  const T* dy = (const T*)p[1];
  const float* gamma = (const float*)p[2];
  const float* beta = (const float*)p[3];
  const float* stats = (const float*)p[4];
  float* part = (float*)p[6];
  float* coef = (float*)p[7];
  const dim3 grid(nch, BF);
  const int threads = (C / 8) * pixel_lanes(C);
  gn_bwd_partial_kernel<T, SILU><<<grid, threads, red_bytes(C), st>>>(
      x, dy, stats, gamma, beta, part, BF, S, C, G, nch);
  MC_CHECK((int)cudaGetLastError());
  gn_bwd_coef_kernel<<<final_blocks(BF, G), kFinalThreads, 0, st>>>(part, stats, gamma, coef,
                                                                    BF, S, C, G, nch);
  MC_CHECK((int)cudaGetLastError());
  gn_bwd_dx_kernel<T, SILU><<<grid, threads, 0, st>>>(x, dy, stats, gamma, beta, coef,
                                                      (T*)p[5], BF, S, C, G, nch);
  return (int)cudaGetLastError();
}

template <typename T>
int forward(void* const* p, const int* d, float eps, cudaStream_t st) {
  if (!takes(d[0], d[1], d[2], d[3], d[4])) return -1;
  return d[6] ? forward<T, true>(p, d, eps, st) : forward<T, false>(p, d, eps, st);
}

template <typename T>
int backward(void* const* p, const int* d, cudaStream_t st) {
  if (!takes(d[0], d[1], d[2], d[3], d[4])) return -1;
  return d[6] ? backward<T, true>(p, d, st) : backward<T, false>(p, d, st);
}

}  // namespace gnk
}  // namespace

// The forward.
// ptrs:  0 x (BF, S, C), 1 gamma (C) f32, 2 beta (C) f32, 3 y (x's shape and
//        dtype), 4 stats (2, BF, G) f32 (mean, then rstd), 5 part
//        (BF · nch · 2 · C) f32 scratch
// dims:  0 BF, 1 S, 2 C, 3 G, 4 nch (pixel chunks a sample), 5 x is f32
//        (else bf16), 6 SiLU
extern "C" int mc_group_norm_fwd(void* const* p, const int* d, float eps, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  return d[5] ? gnk::forward<float>(p, d, eps, st) : gnk::forward<bf16>(p, d, eps, st);
}

// The backward: dx of the forward above for the cotangent dy.
// ptrs:  0 x, 1 dy (x's shape and dtype), 2 gamma, 3 beta, 4 stats (the
//        forward's), 5 dx (x's shape and dtype), 6 part (BF · nch · 2 · C)
//        f32 scratch, 7 coef (BF, G, 2) f32 scratch
// dims:  as the forward's
extern "C" int mc_group_norm_bwd(void* const* p, const int* d, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  return d[5] ? gnk::backward<float>(p, d, st) : gnk::backward<bf16>(p, d, st);
}
