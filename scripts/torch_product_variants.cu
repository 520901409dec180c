// Design variants of the TMA + wgmma product of kernels 5-8
// (csrc/fused_product.cuh), timed by scripts/torch_product_variants.py.
// Built on the header's own device code (descriptors, TMA, wgmma, the
// epilogue).  One kernel template:
//
//   WGR    rows per consumer warpgroup: 64 (one m64n160 product per k16
//          step; the 128-row tile of the shipped kernel) or 128 (two; a
//          256-row tile, half the B tiles' traffic from L2 per row)
//   ST     stages of the TMA ring
//   MODE   0 the whole product; 1 no epilogue (the accumulators are kept
//          but not stored); 2 no wgmma (the ring is consumed and released,
//          zeros are stored); 3 neither: the TMA loads alone
//   EPI    0 the first version's epilogue, from registers straight to
//          global memory (store_regs); 1 the same with the bias and
//          residual of a whole row of the thread's share loaded before any
//          of it is stored (since the residual may be the output, the
//          compiler cannot move a load above an earlier store); 2 the
//          second version's, staged through shared memory in f32 and
//          stored in 16-byte chunks by the warpgroup (store_staged).  The
//          shipped epilogue (residual prefetched into registers, rows
//          staged in the output's type and stored by bulk asynchronous
//          copies) is timed as fused_common.fused_product.
//   CONV   the 3x3 convolution of kernel 8: A through the 4-D tensor map
//          of the video (fused_product.cuh), the box 2·WGR rows of whole
//          image rows; the shipped convolution is timed as
//          fused_resnet.conv3x3.
//
// mc_var(v, ...) launches variant v of the list in variant(); arguments as
// mc_fused_product (csrc/fused_product.cu).  mc_var_conv(v, ...) launches
// convolution variant v of conv_variant(); arguments as mc_conv3x3
// (csrc/fused_resnet.cu), without the temb row.

#include "../motionclone_tpu_torch/csrc/fused_product.cuh"

namespace {
namespace fz {
namespace tp {

// The first version's epilogue, from registers straight to global memory:
// one consumer thread's share of a tile, rows r and r + 8
// (r = m0 + its warpgroup's 64 + its warp's 16 + lane / 4), columns
// n0 + 8j + 2·(lane % 4) + {0, 1} for j < 20 in acc[4j + {0, 1}] (row r)
// and acc[4j + {2, 3}] (row r + 8), wgmma's accumulator layout per 8
// columns.  The arithmetic and the rounding are the plain version's
// (ops/fused_common.py `product_plain`); the
// split chunk and the output column are worked out once per tile, since a
// tile never straddles a chunk.
template <bool GEGLU>
__device__ __forceinline__ void store_regs(const GemmArgs& g, float (&acc)[ACC], int r,
                                           int n0, int lane) {
  const int c2 = (lane & 3) * 2;
  const int chunk = GEGLU ? 0 : n0 / g.ldo;
  // output column of the tile's first column, and the chunk's base
  const int o0 = GEGLU ? n0 / 2 : n0 - chunk * g.ldo;
  const long cb = GEGLU ? 0 : chunk * g.chunk_stride;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = r + 8 * h;
    if (m >= g.M) continue;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = n0 + 8 * j + c2;
      float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (g.bias != nullptr) {
        const float2 b = *reinterpret_cast<const float2*>(g.bias + n);
        v0 += b.x;
        v1 += b.y;
      }
      if constexpr (GEGLU) {
        const float y = v0 * gelu_erf(v1);
        const long idx = (long)m * g.ldo + o0 + 4 * j + (lane & 3);
        if (g.out_f32)
          reinterpret_cast<float*>(g.out)[idx] = y;
        else
          reinterpret_cast<bf16*>(g.out)[idx] = __float2bfloat16(y);
      } else {
        if (g.res != nullptr) {
          const long ri = (long)m * g.N + n;
          if (g.res_f32) {
            const float2 x = *reinterpret_cast<const float2*>(
                reinterpret_cast<const float*>(g.res) + ri);
            v0 += x.x;
            v1 += x.y;
          } else {
            const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                reinterpret_cast<const bf16*>(g.res) + ri));
            v0 += x.x;
            v1 += x.y;
          }
        }
        const long idx = cb + (long)m * g.ldo + o0 + 8 * j + c2;
        if (g.out_f32)
          *reinterpret_cast<float2*>(reinterpret_cast<float*>(g.out) + idx) =
              make_float2(v0, v1);
        else
          *reinterpret_cast<__nv_bfloat162*>(reinterpret_cast<bf16*>(g.out) + idx) =
              __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

// store_regs with the row's bias and residual loaded first
template <bool GEGLU>
__device__ __forceinline__ void store_tile_batched(const GemmArgs& g, float (&acc)[ACC],
                                                   int r, int n0, int lane) {
  const int c2 = (lane & 3) * 2;
  const int chunk = GEGLU ? 0 : n0 / g.ldo;
  const int o0 = GEGLU ? n0 / 2 : n0 - chunk * g.ldo;
  const long cb = GEGLU ? 0 : chunk * g.chunk_stride;
  float2 add[BN / 8];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = r + 8 * h;
    if (m >= g.M) continue;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = n0 + 8 * j + c2;
      add[j] = g.bias != nullptr ? *reinterpret_cast<const float2*>(g.bias + n)
                                 : make_float2(0.f, 0.f);
      if (!GEGLU && g.res != nullptr) {
        const long ri = (long)m * g.N + n;
        const float2 x = g.res_f32 ? *reinterpret_cast<const float2*>(
                                         reinterpret_cast<const float*>(g.res) + ri)
                                   : __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                                         reinterpret_cast<const bf16*>(g.res) + ri));
        add[j].x += x.x;
        add[j].y += x.y;
      }
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const float v0 = acc[4 * j + 2 * h] + add[j].x, v1 = acc[4 * j + 2 * h + 1] + add[j].y;
      if constexpr (GEGLU) {
        const float y = v0 * gelu_erf(v1);
        const long idx = (long)m * g.ldo + o0 + 4 * j + (lane & 3);
        if (g.out_f32)
          reinterpret_cast<float*>(g.out)[idx] = y;
        else
          reinterpret_cast<bf16*>(g.out)[idx] = __float2bfloat16(y);
      } else {
        const long idx = cb + (long)m * g.ldo + o0 + 8 * j + c2;
        if (g.out_f32)
          *reinterpret_cast<float2*>(reinterpret_cast<float*>(g.out) + idx) =
              make_float2(v0, v1);
        else
          *reinterpret_cast<__nv_bfloat162*>(reinterpret_cast<bf16*>(g.out) + idx) =
              __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

// the second version's staging: f32, passes of PASS columns, rows SLD
// floats apart
constexpr int PASS = BN / 2;
constexpr int SLD = PASS + 8;
constexpr int OLD_STAGING = 64 * SLD * 4;

// Load E (4 or 8) consecutive f32 or bf16 values of a residual into f32.
template <int E>
__device__ __forceinline__ void load_vec(const void* base, bool f32, long idx, float (&v)[E]) {
  if (f32) {
    const float4* p = reinterpret_cast<const float4*>(reinterpret_cast<const float*>(base) + idx);
#pragma unroll
    for (int i = 0; i < E / 4; ++i) {
      const float4 x = p[i];
      v[4 * i] = x.x; v[4 * i + 1] = x.y; v[4 * i + 2] = x.z; v[4 * i + 3] = x.w;
    }
  } else if constexpr (E == 8) {
    load8(reinterpret_cast<const bf16*>(base) + idx, v);
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(reinterpret_cast<const bf16*>(base) + idx);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  }
}

// Copy one pass of a warpgroup's staged rows to global memory: rows
// `row0`.. of the (64, PASS) f32 block `sf` (row stride SLD), + the
// residual, rounded to the output's type, at output column `col0` of the
// output row (chunk base `cb`, row length g.ldo) and residual column `rc0`.
// Each thread takes 16-byte output chunks, neighbouring threads
// neighbouring chunks of a row: whole sectors, coalesced.  It loads the
// residual of all its chunks before it stores any (the residual may be the
// output: the in-place f32 stream), then adds and stores them.
template <int E>
__device__ __forceinline__ void copy_out(const GemmArgs& g, const float* sf, int row0,
                                         long cb, int col0, int rc0, int tid) {
  constexpr int CPR = PASS / E;                 // chunks per staged row
  constexpr int NCH = (64 * CPR + 127) / 128;   // chunks per thread
  float res[NCH][E];
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    const int i = tid + 128 * c, r = i / CPR, k = (i - r * CPR) * E;
    const int m = row0 + r;
#pragma unroll
    for (int e = 0; e < E; ++e) res[c][e] = 0.f;
    if (g.res != nullptr && i < 64 * CPR && m < g.M)
      load_vec<E>(g.res, g.res_f32, (long)m * g.N + rc0 + k, res[c]);
  }
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    const int i = tid + 128 * c, r = i / CPR, k = (i - r * CPR) * E;
    const int m = row0 + r;
    if (i >= 64 * CPR || m >= g.M) continue;
    float v[E];
#pragma unroll
    for (int e = 0; e < E; e += 4) {
      const float4 x = *reinterpret_cast<const float4*>(sf + r * SLD + k + e);
      v[e] = x.x + res[c][e]; v[e + 1] = x.y + res[c][e + 1];
      v[e + 2] = x.z + res[c][e + 2]; v[e + 3] = x.w + res[c][e + 3];
    }
    const long idx = cb + (long)m * g.ldo + col0 + k;
    if constexpr (E == 4) {
      *reinterpret_cast<float4*>(reinterpret_cast<float*>(g.out) + idx) =
          make_float4(v[0], v[1], v[2], v[3]);
    } else {
      *reinterpret_cast<uint4*>(reinterpret_cast<bf16*>(g.out) + idx) = pack8(v);
    }
  }
}


// The second version's epilogue: one consumer warpgroup's 64 x 160 share of
// a tile, in passes of PASS output columns through an f32 staging block:
//   1. each thread writes its accumulators + bias to the block at their
//      (row, column): rows wr = warp·16 + lane/4 and wr + 8, columns
//      8j + 2·(lane % 4) + {0, 1} of acc[4j + {0, 1}] and acc[4j + {2, 3}]
//      (wgmma's accumulator layout per 8 columns); GEGLU writes value ·
//      gelu_erf(gate) of each pair at column 4j + lane % 4;
//   2. after a barrier of the warpgroup, copy_out adds the residual and
//      stores rows of 16-byte chunks; a second barrier frees the block.
// The arithmetic and its order are the plain version's (acc + bias, GEGLU
// or + residual, one rounding); a tile never straddles a split
// chunk, so the chunk and the output column are worked out once per tile.
template <bool GEGLU>
__device__ __forceinline__ void store_staged(const GemmArgs& g, float (&acc)[ACC], float* sf,
                                             int m0, int n0, int wg, int warp, int lane) {
  const int tid = threadIdx.x & 127, q = lane & 3, wr = warp * 16 + (lane >> 2);
  const int chunk = GEGLU ? 0 : n0 / g.ldo;
  const long cb = GEGLU ? 0 : chunk * g.chunk_stride;
  const int o0 = GEGLU ? n0 / 2 : n0 - chunk * g.ldo;  // output column of the tile's first
  const int row0 = m0 + wg * 64;
  constexpr int PASSES = GEGLU ? 1 : BN / PASS;
  constexpr int JP = BN / 8 / PASSES;  // 8-column groups per pass
#pragma unroll
  for (int pass = 0; pass < PASSES; ++pass) {
#pragma unroll
    for (int jj = 0; jj < JP; ++jj) {
      const int j = pass * JP + jj, n = n0 + 8 * j + 2 * q;
      float2 b = make_float2(0.f, 0.f);
      if (g.bias != nullptr) b = *reinterpret_cast<const float2*>(g.bias + n);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float v0 = acc[4 * j + 2 * h] + b.x, v1 = acc[4 * j + 2 * h + 1] + b.y;
        float* row = sf + (wr + 8 * h) * SLD;
        if constexpr (GEGLU)
          row[4 * j + q] = v0 * gelu_erf(v1);
        else
          *reinterpret_cast<float2*>(row + 8 * jj + 2 * q) = make_float2(v0, v1);
      }
    }
    wg_bar(wg);
    if (g.out_f32)
      copy_out<4>(g, sf, row0, cb, o0 + pass * PASS, n0 + pass * PASS, tid);
    else
      copy_out<8>(g, sf, row0, cb, o0 + pass * PASS, n0 + pass * PASS, tid);
    wg_bar(wg);
  }
}

template <int WGR, int ST, int EPI>
constexpr int var_smem() {
  return ST * (2 * WGR * BK * 2 + B_BYTES) + (EPI == 2 ? 2 * OLD_STAGING : 0) + 2 * ST * 8 +
         1024;
}

template <int WGR, int ST, int MODE, bool GEGLU, int EPI, bool CONV>
__global__ void __launch_bounds__(kThreads, 1)
    var_kernel(const __grid_constant__ CUtensorMap map_a,
               const __grid_constant__ CUtensorMap map_b, const GemmArgs g) {
  constexpr int VBM = 2 * WGR, VA = VBM * BK * 2, VSTAGE = VA + B_BYTES, SUB = WGR / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      ((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
  float* staging = reinterpret_cast<float*>(smem + ST * VSTAGE);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem + ST * VSTAGE + (EPI == 2 ? 2 * OLD_STAGING : 0));
  uint64_t* empty = full + ST;
  const int n_tiles_n = g.N / BN;
  const int tiles = (g.M + VBM - 1) / VBM * n_tiles_n;
  const int nk = g.K / BK;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (wg == 2) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      int stage = 0, phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = t / n_tiles_n * VBM, n0 = t % n_tiles_n * BN;
        int frame = 0, x0 = 0, y0 = 0, tap = 0, c0 = 0;
        if constexpr (CONV) {
          const int hw = g.H * g.W;
          frame = m0 / hw;
          y0 = (m0 - frame * hw) / g.W;
          x0 = m0 - frame * hw - y0 * g.W;
        }
        for (int kt = 0; kt < nk; ++kt) {
          mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* slot = smem + stage * VSTAGE;
          mbar_expect_tx(&full[stage], VSTAGE);
          if constexpr (CONV) {
            tma_load_4d(slot, &map_a, c0, x0 + tap % 3 - 1, y0 + tap / 3 - 1, frame,
                        &full[stage]);
            if ((c0 += BK) == g.Cin) {
              c0 = 0;
              ++tap;
            }
          } else {
            tma_load_2d(slot, &map_a, kt * BK, m0, &full[stage]);
          }
          tma_load_2d(slot + VA, &map_b, kt * BK, n0, &full[stage]);
          if (++stage == ST) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    int stage = 0, phase = 0;
    float acc[SUB][ACC];
#pragma unroll
    for (int s = 0; s < SUB; ++s)
#pragma unroll
      for (int i = 0; i < ACC; ++i) acc[s][i] = 0.f;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = t / n_tiles_n * VBM, n0 = t % n_tiles_n * BN;
      int prev = -1;
      for (int kt = 0; kt < nk; ++kt) {
        mbar_wait(&full[stage], phase);
        const unsigned char* slot = smem + stage * VSTAGE;
        if constexpr (MODE == 0 || MODE == 1) {
          const uint64_t db = desc_sw128(slot + VA);
          wg_fence();
#pragma unroll
          for (int ks = 0; ks < BK / 16; ++ks)
#pragma unroll
            for (int s = 0; s < SUB; ++s)
              wgmma_160(acc[s], desc_sw128(slot + (wg * WGR + 64 * s) * 128) + 2 * ks,
                        db + 2 * ks, kt > 0 || ks > 0);
          wg_commit();
          wg_wait<1>();
        }
        if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
        prev = stage;
        if (++stage == ST) {
          stage = 0;
          phase ^= 1;
        }
      }
      wg_wait<0>();
#pragma unroll
      for (int s = 0; s < SUB; ++s) wg_keep(acc[s]);
      if (lane == 0) mbar_arrive(&empty[prev]);
#pragma unroll
      for (int s = 0; s < SUB; ++s) {
        const int r = m0 + wg * WGR + 64 * s + warp * 16 + (lane >> 2);
        if (MODE == 0 || MODE == 2 || g.M < 0) {
          if constexpr (EPI == 0)
            store_regs<GEGLU>(g, acc[s], r, n0, lane);
          else if constexpr (EPI == 1)
            store_tile_batched<GEGLU>(g, acc[s], r, n0, lane);
          else
            store_staged<GEGLU>(g, acc[s], staging + wg * (OLD_STAGING / 4),
                                m0 + wg * (WGR - 64) + 64 * s, n0, wg, warp, lane);
        }
      }
    }
  }
}

template <int WGR, int ST, int MODE, int EPI, bool CONV = false>
int launch_var(const GemmArgs& g, bool geglu, cudaStream_t st) {
  constexpr int smem = var_smem<WGR, ST, EPI>();
  CUtensorMap ma, mb;
  const bool a_ok = CONV ? encode_conv(&ma, g.a, g.M / (g.H * g.W), g.H, g.W, g.Cin, 2 * WGR)
                         : encode(&ma, g.a, g.M, g.K, 2 * WGR);
  if (!a_ok || !encode(&mb, g.b, g.N, g.K, BN)) return kTensorMapError;
  const int sms = sm_count();
  const int tiles = (g.M + 2 * WGR - 1) / (2 * WGR) * (g.N / BN);
  const int grid = tiles < sms ? tiles : sms;
  if (geglu) {
    MC_CHECK((int)cudaFuncSetAttribute(var_kernel<WGR, ST, MODE, true, EPI, CONV>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
    var_kernel<WGR, ST, MODE, true, EPI, CONV><<<grid, kThreads, smem, st>>>(ma, mb, g);
  } else {
    MC_CHECK((int)cudaFuncSetAttribute(var_kernel<WGR, ST, MODE, false, EPI, CONV>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
    var_kernel<WGR, ST, MODE, false, EPI, CONV><<<grid, kThreads, smem, st>>>(ma, mb, g);
  }
  return (int)cudaGetLastError();
}

}  // namespace tp
}  // namespace fz

int variant(int v, const fz::GemmArgs& g, bool geglu, cudaStream_t st) {
  using namespace fz::tp;
  switch (v) {
    case 0: return launch_var<64, 6, 0, 0>(g, geglu, st);   // the first version
    case 1: return launch_var<64, 6, 1, 0>(g, geglu, st);   // no epilogue
    case 2: return launch_var<64, 6, 2, 0>(g, geglu, st);   // no wgmma
    case 3: return launch_var<64, 6, 3, 0>(g, geglu, st);   // loads alone
    case 4: return launch_var<64, 6, 0, 1>(g, geglu, st);   // batched epilogue
    case 5: return launch_var<128, 4, 0, 0>(g, geglu, st);  // 256-row tiles
    case 6: return launch_var<128, 4, 1, 0>(g, geglu, st);
    case 7: return launch_var<128, 4, 3, 0>(g, geglu, st);
    case 8: return launch_var<128, 4, 0, 1>(g, geglu, st);
    case 9: return launch_var<64, 5, 0, 2>(g, geglu, st);   // staged epilogue
    case 10: return launch_var<64, 5, 2, 2>(g, geglu, st);  // staged, no wgmma
    case 11: return launch_var<128, 3, 0, 2>(g, geglu, st); // staged, 256-row tiles
    default: return -1;
  }
}

// The convolution on 128-row tiles (the shipped kernel's) and on 256-row
// tiles (two m64n160 products per consumer per k16 step: half the B tiles'
// L2 traffic per row, 160 accumulators a thread), each as its mainloop
// alone, its loads alone, and whole with the register epilogue (EPI 0).
// Without GEGLU; 4 ring slots each (the shipped f32-out kernel's).
int conv_variant(int v, const fz::GemmArgs& g, cudaStream_t st) {
  using namespace fz::tp;
  if (g.temb != nullptr || (g.H * g.W) % 256 || g.Cin % BK) return -1;
  switch (v) {
    case 0: return launch_var<64, 4, 1, 0, true>(g, false, st);   // 128 rows, no epilogue
    case 1: return launch_var<64, 4, 3, 0, true>(g, false, st);   //   loads alone
    case 2: return launch_var<64, 4, 0, 0, true>(g, false, st);   //   register epilogue
    case 3: return launch_var<128, 4, 1, 0, true>(g, false, st);  // 256 rows, no epilogue
    case 4: return launch_var<128, 4, 3, 0, true>(g, false, st);  //   loads alone
    case 5: return launch_var<128, 4, 0, 0, true>(g, false, st);  //   register epilogue
    default: return -1;
  }
}

}  // namespace

// ptrs and dims as mc_fused_product
extern "C" int mc_var(int v, void* const* p, const int* d, void* stream) {
  fz::GemmArgs g = fz::gemm_args(p[0], p[1], p[2], p[4], d[4], d[0], d[1], d[2]);
  g.res = p[3];
  g.res_f32 = d[3];
  if (d[5]) g.ldo = d[1] / 2;
  if (d[6]) fz::split_output(g, d[6]);
  return variant(v, g, d[5] != 0, (cudaStream_t)stream);
}

// ptrs and dims as mc_conv3x3, with no temb row
extern "C" int mc_var_conv(int v, void* const* p, const int* d, void* stream) {
  fz::GemmArgs g = fz::gemm_args(p[0], p[1], p[2], p[5], d[7], d[0] * d[2] * d[3], d[5],
                                 9 * d[4]);
  g.H = d[2];
  g.W = d[3];
  g.Cin = d[4];
  g.temb = (const bf16*)p[3];
  g.res = p[4];
  g.res_f32 = d[6];
  return conv_variant(v, g, (cudaStream_t)stream);
}
