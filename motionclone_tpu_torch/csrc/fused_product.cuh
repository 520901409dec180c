// The matrix product of the fused modules (fused_block.cu, fused_temporal.cu,
// fused_resnet.cu) on Hopper's TMA and wgmma.
//
// Serves the TPU kernels motionclone_tpu/ops/fused_block.py
// `fused_spatial_transformer` (:306) and `fused_transformer_block` (:387),
// motionclone_tpu/ops/fused_temporal.py `fused_temporal_module` (:171) and
// motionclone_tpu/ops/fused_resnet.py `fused_resnet_block` (:200): every
// linear layer of those modules, and each 3x3 convolution and 1x1 shortcut
// of the resnet, is one launch of it.
//
// C[m, n] = sum_k A[m, k] * B[n, k] with A bf16 (M, K) row-major and B an
// nn.Linear weight (N, K) row-major: both operands are K-major, so wgmma
// reads both from shared memory without a transpose.  f32 accumulation,
// one rounding at the store; the epilogue is fused_common.cuh's (GemmArgs):
// bias, an f32 or bf16 residual, f32 or bf16 out, the split store that lays
// q|k|v (or k|v) out as separate contiguous tensors, and the GEGLU pairing
// of interleaved columns (2j, 2j + 1) -> value * gelu_erf(gate) at column
// j.  The residual may be the output itself (the motion module's f32
// stream h): every element of a tile is read before the barrier after
// which its row is stored, and tiles are disjoint.  No split-K and no
// atomics: two launches give the same bits.
//
// The convolution (CONV).  A is then the (BF, H, W, Cin) video and the
// product the implicit GEMM of a 3x3 convolution with padding 1: K = 9·Cin,
// k = (dy·3 + dx)·Cin + ci, the weight (Cout, 9·Cin) K-major as any other.
// The producer reads A through a 4-D tensor map over (Cin, W, H, BF) whose
// box, (64, min(W, 128), 128 / min(W, 128), 1), is one 128-row x 64-channel
// A tile of whole image rows of one frame (H·W % 128 == 0, so a tile never
// straddles two frames).  For tap (dy, dx) and channel tile c0 it loads the
// box at (c0, x0 + dx - 1, y0 + dy - 1, frame): TMA zero-fills every
// coordinate outside the tensor, negative ones included, which is the
// convolution's padding, and the box's frame extent of 1 keeps a tap from
// reading the neighbouring frame.  The box lands in the same swizzled 128 x
// 64 layout as a 2-D A tile, so the consumers do not change.  Cin % 64 ==
// 0, so a k-tile never straddles two taps.  Its epilogue adds the temb row
// of the tile's video (conv1, which has no residual) or a residual (conv2).
// ops/fused_resnet.py `conv_a_tile` emulates the addressing on the CPU.
//
// What bounds it on the H100.  The linear layers (C = 320 or 640): M =
// B·F·S rows (16384-131072; videos x 77 for the text's k|v), N in {C, 2C,
// 3C, 8C}, K in {C, 4C, 768}.  At K = C a product does 2·C flops per output
// element against ~4-12 bytes of operand, residual and output per element,
// under the card's ~295 flops per byte: the C x C products and the FF's
// second product are bound by memory, GEGLU's 8C-wide one (and the q|k|v
// one nearly) by the tensor cores.  K is short (5 k-tiles at K = 320), so
// the epilogue (a residual read, an f32 write) weighs as much as the
// products: the design keeps HBM streaming through it.  The convolutions
// have K = 9·Cin (45-270 k-tiles) and are bound by the tensor cores (242
// GFLOP at 16 frames of 64x64, 320 -> 320); each tap reads its A tile again
// from L2, so there the mainloop sets the pace.
//
// The design.  Tiles of 128 x 160 x 64: every K is a multiple of 64, and a
// 64-wide bf16 k-tile row is 128 bytes, the width of TMA's and wgmma's
// 128-byte swizzle; every N is a multiple of 160 (a legal wgmma width), so
// a tile wastes no column at N = 320, never straddles a q|k|v chunk (160
// divides C), and GEGLU's (value, gate) pairs stay in one thread.  A block
// of three warpgroups stays on its SM (one block per SM, a persistent grid)
// and walks the output tiles with a stride of the grid, N-tiles innermost,
// so neighbouring blocks read the same A rows from L2:
//   - warpgroup 2, the producer, keeps one thread issuing TMA loads of the
//     A and B k-tiles (CU_TENSOR_MAP_SWIZZLE_128B, zero fill past M) into a
//     ring of 5 slots (4 for an f32 output) tracked by full/empty
//     mbarriers; its registers go to the consumers (setmaxnreg 40 / 232);
//   - warpgroups 0 and 1, the consumers, take 64 rows each and issue
//     wgmma.m64n160k16 on the slot (descriptors with the 128-byte swizzle:
//     8-row groups 1024 B apart, +32 B of start address per k16 step) and
//     release each slot as soon as the product that read it is done;
//   - the epilogue never waits on global memory: each consumer loads its
//     residual into registers when the tile starts (under the products),
//     writes the finished rows (GEGLU: value · gelu_erf(gate)) into a
//     staging block in shared memory, and hands each row to a bulk
//     asynchronous copy (cp.async.bulk), then goes on to the next tile
//     while the ring already holds its first k-tiles.
// scripts/torch_product_variants.{py,cu} time the earlier epilogues this
// replaced (from registers straight to global memory: 3-5x the memory
// bound), the mainloop and the loads alone, and the convolution on
// 256-row tiles.  At GEGLU's 8C-wide
// product the epilogue is bound by erff; handing it to the producer
// warpgroup's three spare warps was slower (three warps cannot hide its
// dependent latency, eight consumer warps can), and so was interleaving it
// with the next tile's k-tiles on a second set of accumulators.
//
// The tensor maps are encoded on the host at every launch, through
// cuTensorMapEncodeTiled looked up once with cudaGetDriverEntryPoint (no
// link against libcuda), and passed as __grid_constant__
// kernel parameters.

#pragma once

#include <cuda.h>

#include <type_traits>

#include "fused_common.cuh"

namespace {
namespace fz {
namespace tp {

constexpr int BM = 128;           // rows per tile: 64 per consumer warpgroup
constexpr int BN = 160;           // columns per tile
constexpr int BK = 64;            // one 128-byte swizzle row of bf16
constexpr int kThreads = 384;     // consumer warpgroups 0 and 1, producer 2
constexpr int A_BYTES = BM * BK * 2;
constexpr int B_BYTES = BN * BK * 2;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;  // 36864, a multiple of 1024
constexpr int ACC = BN / 2;       // f32 accumulators per consumer thread

// Shared memory: the ring, a staging block per consumer warpgroup (64 rows
// of its output share + 16 bytes of padding a row), the full and empty
// barriers.  A bf16 output's staging is half an f32 one's, which leaves
// room for a fifth slot: the whole next tile at K = 320 (5 k-tiles) is
// loaded while this one is stored.  With an f32 output, 4 slots, 231,488
// bytes: the dynamic shared memory must start at a 1024-byte boundary (the
// kernel traps otherwise), leaving none to align it.
template <bool OUTF32>
struct Smem {
  static constexpr int STAGES = OUTF32 ? 4 : 5;
  static constexpr int STAGING = 64 * (BN * (OUTF32 ? 4 : 2) + 16);
  static constexpr int BYTES = STAGES * STAGE_BYTES + 2 * STAGING + 2 * STAGES * 8;
};

// A shared-memory matrix descriptor for a K-major tile written by TMA with
// the 128-byte swizzle: rows of 128 bytes, 8-row groups 1024 bytes apart
// (stride), leading offset unused (1), layout type 1 (128B swizzle).
__device__ __forceinline__ uint64_t desc_sw128(const void* smem) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(smem);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(bar)), "r"(bytes) : "memory");
}

// TMA: the box at (column c0, row c1) of the tensor map into shared memory,
// completing `bytes` on the barrier
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0,
                                            int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"((uint32_t)__cvta_generic_to_shared(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"((uint32_t)__cvta_generic_to_shared(bar)),
      "r"(c0), "r"(c1)
      : "memory");
}

// TMA: the box at (c0, c1, c2, c3) of a 4-D tensor map; coordinates
// outside the tensor, negative ones included, load as zeros
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, int c0,
                                            int c1, int c2, int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"((uint32_t)__cvta_generic_to_shared(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"((uint32_t)__cvta_generic_to_shared(bar)),
      "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map))
               : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// m64n160k16 bf16 -> f32, both operands K-major in shared memory; acc = 0
// overwrites d, else adds to it
__device__ __forceinline__ void wgmma_160(float (&d)[80], uint64_t da, uint64_t db,
                                          int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79},"
      " %80, %81, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wg_bar(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// bulk asynchronous copy of `bytes` (a multiple of 16, both addresses
// 16-byte aligned) from global to shared memory, completing on the barrier
// (the temporal attention kernels' row runs, temporal_attention.cuh)
__device__ __forceinline__ void bulk_load(void* smem, const void* gmem, int bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"((uint32_t)__cvta_generic_to_shared(smem)),
      "l"(gmem), "r"(bytes), "r"((uint32_t)__cvta_generic_to_shared(bar))
      : "memory");
}

// bulk asynchronous copy of `bytes` (a multiple of 16) from shared to
// global memory, in this thread's bulk group
__device__ __forceinline__ void bulk_store(void* gmem, const void* smem, int bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(gmem),
               "r"((uint32_t)__cvta_generic_to_shared(smem)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// this thread's bulk copies have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// ... and written their global memory
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// The residual a consumer thread adds, held as loaded (RES 1: bf16 pairs,
// RES 2: f32 pairs): element (row wr + 8h, column 8j + 2·(lane % 4) + {0,
// 1}) of its warpgroup's 64 x 160 share, as its accumulators.  Loaded when
// the tile starts, so the loads run under the tile's products.
template <int RES>
struct Residual {
  static constexpr int N = RES == 2 ? ACC : RES == 1 ? ACC / 2 : 1;
  uint32_t v[N];

  __device__ __forceinline__ void load(const GemmArgs& g, int m, int n) {
    if constexpr (RES != 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const bool ok = m + 8 * h < g.M;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const long idx = (long)(ok ? m + 8 * h : 0) * g.N + n + 8 * j;
          if constexpr (RES == 2) {
            const uint2 x = ok ? *reinterpret_cast<const uint2*>(
                                     reinterpret_cast<const float*>(g.res) + idx)
                               : make_uint2(0u, 0u);
            v[4 * j + 2 * h] = x.x;
            v[4 * j + 2 * h + 1] = x.y;
          } else {
            v[2 * j + h] = ok ? *reinterpret_cast<const uint32_t*>(
                                    reinterpret_cast<const bf16*>(g.res) + idx)
                              : 0u;
          }
        }
      }
    }
  }
  // the residual of accumulators 4j + 2h and 4j + 2h + 1
  __device__ __forceinline__ float2 get(int j, int h) const {
    if constexpr (RES == 2)
      return make_float2(__uint_as_float(v[4 * j + 2 * h]), __uint_as_float(v[4 * j + 2 * h + 1]));
    else if constexpr (RES == 1)
      return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v[2 * j + h]));
    else
      return make_float2(0.f, 0.f);
  }
};

// The epilogue of one consumer warpgroup's 64 x 160 share of a tile.  Each
// thread adds the bias and its residual to its accumulators (rows wr =
// warp·16 + lane/4 and wr + 8, columns 8j + 2·(lane % 4) + {0, 1} of
// acc[4j + {0, 1}] and acc[4j + {2, 3}], wgmma's accumulator layout per 8
// columns), with TEMB the temb row of the tile's video after the bias, or,
// with GEGLU, forms value · gelu_erf(gate) of each pair at
// column 4j + lane % 4, rounds once to the output's type and writes the row
// into the warpgroup's staging block (rows ROW bytes apart: 16 bytes of
// padding spread the 8 rows a warp writes over the banks).  After a fence and a
// barrier of the warpgroup, threads 0-63 each hand one row to a bulk
// asynchronous copy into the output (the split chunk's, at the tile's
// output column; rows past M are not copied) and go on to the next tile:
// only the next tile's epilogue waits for the copies to have read the
// block.  The arithmetic and its order are the plain versions'
// (ops/fused_common.py `product_plain`, ops/fused_resnet.py `conv3x3_plain`).
template <int RES, bool OUTF32, bool GEGLU, bool TEMB>
__device__ __forceinline__ void store_tile(const GemmArgs& g, const float (&acc)[ACC],
                                           const Residual<RES>& res, unsigned char* sb,
                                           int m0, int n0, int wg, int warp, int lane) {
  using Out = typename std::conditional<OUTF32, float, bf16>::type;
  constexpr int COLS = GEGLU ? BN / 2 : BN;          // output columns of the share
  constexpr int ROW = COLS * (int)sizeof(Out) + 16;  // staging row stride, bytes
  const int tid = threadIdx.x & 127, q = lane & 3, wr = warp * 16 + (lane >> 2);
  // the previous tile's copies out of this block have read it
  if (tid < 64) bulk_wait_read();
  wg_bar(wg);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float2 b[BN / 16];  // the bias of this half's columns, loaded first
#pragma unroll
    for (int jj = 0; jj < BN / 16; ++jj)
      b[jj] = g.bias != nullptr
                  ? *reinterpret_cast<const float2*>(g.bias + n0 + 8 * (half * BN / 16 + jj) + 2 * q)
                  : make_float2(0.f, 0.f);
    float2 tb[TEMB ? BN / 16 : 1];  // the temb row's columns (a tile lies in one video)
    if constexpr (TEMB) {
      const bf16* tr = g.temb == nullptr ? nullptr : g.temb + (m0 / g.temb_rows) * g.N + n0;
#pragma unroll
      for (int jj = 0; jj < BN / 16; ++jj)
        tb[jj] = tr != nullptr ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                                     tr + 8 * (half * BN / 16 + jj) + 2 * q))
                               : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int jj = 0; jj < BN / 16; ++jj) {
      const int j = half * BN / 16 + jj;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v0 = acc[4 * j + 2 * h] + b[jj].x, v1 = acc[4 * j + 2 * h + 1] + b[jj].y;
        if constexpr (TEMB) {
          v0 += tb[jj].x;
          v1 += tb[jj].y;
        }
        unsigned char* row = sb + (wr + 8 * h) * ROW;
        if constexpr (GEGLU) {
          const float y = v0 * gelu_erf(v1);
          if constexpr (OUTF32)
            reinterpret_cast<float*>(row)[4 * j + q] = y;
          else
            reinterpret_cast<bf16*>(row)[4 * j + q] = __float2bfloat16(y);
        } else {
          const float2 r = res.get(j, h);
          v0 += r.x;
          v1 += r.y;
          if constexpr (OUTF32)
            *reinterpret_cast<float2*>(row + (8 * j + 2 * q) * 4) = make_float2(v0, v1);
          else
            *reinterpret_cast<__nv_bfloat162*>(row + (8 * j + 2 * q) * 2) =
                __floats2bfloat162_rn(v0, v1);
        }
      }
    }
  }
  fence_async_smem();  // the block's generic writes become visible to the bulk copies
  wg_bar(wg);
  const int m = m0 + wg * 64 + tid;
  if (tid < 64 && m < g.M) {
    const int chunk = GEGLU ? 0 : n0 / g.ldo;
    const long col = GEGLU ? n0 / 2 : chunk * g.chunk_stride + (n0 - chunk * g.ldo);
    bulk_store(reinterpret_cast<Out*>(g.out) + col + (long)m * g.ldo, sb + tid * ROW,
               COLS * (int)sizeof(Out));
    bulk_commit();
  }
}

// CONV: A is the (BF, H, W, Cin) video behind a 4-D tensor map and the
// product the 3x3 convolution's implicit GEMM (head note); its epilogue
// adds the temb row where it has no residual.
template <int RES, bool OUTF32, bool GEGLU, bool CONV>
__global__ void __launch_bounds__(kThreads, 1)
    product_kernel(const __grid_constant__ CUtensorMap map_a,
                   const __grid_constant__ CUtensorMap map_b, const GemmArgs g) {
  using L = Smem<OUTF32>;
  constexpr int STAGES = L::STAGES;
  // the ring's slots at a 1024-byte boundary (the swizzle's period), the
  // staging blocks, the barriers
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* staging = smem + STAGES * STAGE_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + 2 * L::STAGING);
  uint64_t* empty = full + STAGES;

  const int n_tiles_n = g.N / BN;
  const int tiles = (g.M + BM - 1) / BM * n_tiles_n;
  const int nk = g.K / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    if ((uint32_t)__cvta_generic_to_shared(smem) & 1023) __trap();
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);   // the producer's expect_tx arrival
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // producer: one thread keeps the ring full
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      prefetch_map(&map_a);
      prefetch_map(&map_b);
      int stage = 0, phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = t / n_tiles_n * BM, n0 = t % n_tiles_n * BN;
        // the conv: the tile's frame and its first pixel (x0, y0); then
        // the (tap, channel tile) of each k-tile, taps outermost
        int frame = 0, x0 = 0, y0 = 0, tap = 0, c0 = 0;
        if constexpr (CONV) {
          const int hw = g.H * g.W;
          frame = m0 / hw;
          y0 = (m0 - frame * hw) / g.W;
          x0 = m0 - frame * hw - y0 * g.W;
        }
        for (int kt = 0; kt < nk; ++kt) {
          mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* slot = smem + stage * STAGE_BYTES;
          mbar_expect_tx(&full[stage], STAGE_BYTES);
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
          tma_load_2d(slot + A_BYTES, &map_b, kt * BK, n0, &full[stage]);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // consumers: warpgroup wg multiplies rows 64·wg..64·wg + 63 of each tile
    setmaxnreg_inc<232>();
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    unsigned char* sb = staging + wg * L::STAGING;
    int stage = 0, phase = 0;
    float acc[ACC];
#pragma unroll
    for (int i = 0; i < ACC; ++i) acc[i] = 0.f;
    Residual<RES> res;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = t / n_tiles_n * BM, n0 = t % n_tiles_n * BN;
      res.load(g, m0 + wg * 64 + warp * 16 + (lane >> 2), n0 + 2 * (lane & 3));
      int prev = -1;
      for (int kt = 0; kt < nk; ++kt) {
        mbar_wait(&full[stage], phase);
        const unsigned char* slot = smem + stage * STAGE_BYTES;
        const uint64_t da = desc_sw128(slot + wg * (64 * 128));
        const uint64_t db = desc_sw128(slot + A_BYTES);
        wg_fence();
#pragma unroll
        for (int ks = 0; ks < BK / 16; ++ks)  // +32 bytes of start address per k16
          wgmma_160(acc, da + 2 * ks, db + 2 * ks, kt > 0 || ks > 0);
        wg_commit();
        // the previous k-tile's product is done: release its slot
        wg_wait<1>();
        if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
        prev = stage;
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      wg_wait<0>();
      wg_keep(acc);
      if (lane == 0) mbar_arrive(&empty[prev]);
      store_tile<RES, OUTF32, GEGLU, CONV && RES == 0>(g, acc, res, sb, m0, n0, wg, warp,
                                                       lane);
    }
    if ((threadIdx.x & 127) < 64) bulk_wait();
  }
}

// cuTensorMapEncodeTiled, looked up once through the runtime
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
#endif
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The tensor map of a bf16 (rows, K) row-major matrix in boxes of
// box_rows x 64 with the 128-byte swizzle; rows past the end load as zeros.
inline bool encode(CUtensorMap* map, const void* base, int rows, int K, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K * 2};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The tensor map of the (BF, H, W, Cin) bf16 video as the convolution's A:
// 4-D over (Cin, W, H, BF) with the 128-byte swizzle, in boxes of (64,
// min(W, box_rows), box_rows / min(W, box_rows), 1), one box_rows x 64 A
// tile each.
inline bool encode_conv(CUtensorMap* map, const void* base, int BF, int H, int W, int Cin,
                        int box_rows = BM) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const int wb = W < box_rows ? W : box_rows;
  const cuuint64_t dims[4] = {(cuuint64_t)Cin, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)BF};
  const cuuint64_t strides[3] = {(cuuint64_t)Cin * 2, (cuuint64_t)W * Cin * 2,
                                 (cuuint64_t)H * W * Cin * 2};
  const cuuint32_t box[4] = {(cuuint32_t)BK, (cuuint32_t)wb, (cuuint32_t)(box_rows / wb), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

inline int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 132;
}

}  // namespace tp

// Status of a launch the product refuses before any CUDA call: the tensor
// map could not be encoded (no driver entry point, or an operand the
// hardware does not take).
constexpr int kTensorMapError = -2;

namespace tp {

template <int RES, bool OUTF32, bool GEGLU, bool CONV = false>
int launch(const GemmArgs& g, cudaStream_t st) {
  CUtensorMap ma, mb;
  const bool a_ok = CONV ? encode_conv(&ma, g.a, g.M / (g.H * g.W), g.H, g.W, g.Cin)
                         : encode(&ma, g.a, g.M, g.K, BM);
  if (!a_ok || !encode(&mb, g.b, g.N, g.K, BN)) return kTensorMapError;
  constexpr int smem = Smem<OUTF32>::BYTES;
  MC_CHECK((int)cudaFuncSetAttribute(product_kernel<RES, OUTF32, GEGLU, CONV>,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  const int sms = sm_count();
  const int tiles = (g.M + BM - 1) / BM * (g.N / BN);
  product_kernel<RES, OUTF32, GEGLU, CONV><<<tiles < sms ? tiles : sms, kThreads, smem, st>>>(
      ma, mb, g);
  return (int)cudaGetLastError();
}

}  // namespace tp

// The shapes the product takes: K % 64 == 0, N % 160 == 0 and, for a split
// store, the chunk width % 160 == 0; no temb row (only the convolution,
// fused_resnet.cu, adds one) and, with GEGLU, no residual.
// ops/fused_common.py mirrors the rule.
inline bool product_takes(const GemmArgs& g) {
  return g.M >= 1 && g.K % tp::BK == 0 && g.N % tp::BN == 0 && g.temb == nullptr;
}

// Launch the TMA + wgmma product on the shapes it takes (product_takes).
// The residual's and the output's types select the kernel.  Returns -1 for
// another shape, kTensorMapError if a tensor map cannot be encoded, else
// cudaGetLastError() after the launch.
template <bool GEGLU = false>
int product(const GemmArgs& g, cudaStream_t st) {
  if (!product_takes(g)) return -1;
  if constexpr (GEGLU) {
    if (g.ldo != g.N / 2 || g.res != nullptr) return -1;
    return g.out_f32 ? tp::launch<0, true, true>(g, st) : tp::launch<0, false, true>(g, st);
  } else {
    if (g.ldo % tp::BN) return -1;
    const int res = g.res == nullptr ? 0 : g.res_f32 ? 2 : 1;
    switch (2 * res + (g.out_f32 ? 1 : 0)) {
      case 0: return tp::launch<0, false, false>(g, st);
      case 1: return tp::launch<0, true, false>(g, st);
      case 2: return tp::launch<1, false, false>(g, st);
      case 3: return tp::launch<1, true, false>(g, st);
      case 4: return tp::launch<2, false, false>(g, st);
      default: return tp::launch<2, true, false>(g, st);
    }
  }
}

}  // namespace fz
}  // namespace
