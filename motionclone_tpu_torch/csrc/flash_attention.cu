// Exact multi-head softmax attention, forward and backward, for sm_90a.
//
// Replaces the Pallas TPU kernels of motionclone_tpu/ops/flash_attention.py
// (`_flash_fwd` / `_fwd_kernel`, `_flash_fwd_whole` / `_fwd_whole_kernel`,
// and the VJP `_flash_bwd` / `_bwd_dq_kernel` / `_bwd_dkv_kernel`,
// `_flash_bwd_whole` / `_bwd_whole_kernel`).
//
// Layout: q (B, Sq, H*D), k/v (B, Sk, H*D), bf16, row-major and contiguous --
// the natural output of the to_q/to_k/to_v projections, so no head transpose
// is ever materialised.  Heads are split inside the kernel by offsetting the
// row pointer by h*D.  The forward writes bf16 out and the f32 row
// log-sum-exp (B, H, Sq) in natural-log units; the backward recomputes the
// probabilities from it.  The softmax keeps an exact running row maximum:
// no +-75 logit clamp as on the TPU.  Keys past Sk are masked by index (the
// fused transformer's 77 text tokens: the rows after them belong to the
// next video).
//
// What bounds it on the H100.  A (batch, head) does 4*Sq*Sk*D flops of
// products against ~8*S*D bytes, ~2000 flops per byte at S = 4096, so
// memory never bounds it.  Two units do: the tensor cores (989 TFLOP/s)
// and the special-function unit's exponentials (one per score, ~3.9e12/s).
// At D = 40 the exponentials are the floor: (16, 4096, 8, 40) needs 2.15e9
// of them, ~0.55 ms, against 0.35 ms of products; at D = 80 the two are
// level, at D = 160 the products dominate.  D = 64 is SDXL's head (640 and
// 1280 channels over 10 and 20 heads): its tiles are 128-byte rows with no
// pad, and it runs the D <= 80 tiling.
//
// The design (after FlashAttention-3, hand-written in PTX; wgmma.cuh):
// - Both products on wgmma.  S = Q K^T from shared memory (Q and K tiles
//   K-major); O += P V with P converted in registers from S's accumulator
//   (the C layout is the A layout) and V read MN-major through the
//   transpose bit, so V is never transposed.  f32 accumulation.
// - Tiles are 8x8 core matrices without swizzle, filled by cp.async, so
//   D = 40 needs no 128-byte rows: the reduction over d is padded to 48
//   with zero columns written once, and P V has width N = D (a valid wgmma
//   width).
// - A forward block has four warpgroups of 64 query rows (two at D = 160),
//   which share each 64-key K/V tile: four halve the tiles' traffic from L2
//   against two.  The tiles stream through a ring of four stages, two tiles
//   ahead; each stage's full/empty mbarriers let the warpgroups run out of
//   step, so one's softmax overlaps another's products.  Within a
//   warpgroup, step j issues S_j and P_{j-1} V_{j-1} together and runs the
//   softmax of S_j under both.  A thread stays under 128 registers.
// - The exponentials are not what holds the forward back on this card: a
//   variant without them runs as fast (scripts/torch_flash_variants.py);
//   the warpgroups' waits are, and more of them per SM is what helped.
// - Backward: two kernels, so that no floating-point atomic makes the
//   result depend on the order blocks run in (two launches give the same
//   bits).  The dq kernel (a block of queries, looping over K/V tiles)
//   first forms delta = rowsum(dO * O) of its rows for the dk/dv kernel,
//   then S, dP = dO V^T and dQ += dS K.  The dk/dv kernel (a block of keys,
//   Q, dO, LSE and delta streamed through the ring) forms S^T = K Q^T and
//   dP^T = V dO^T and accumulates dV += P^T dO and dK += dS^T Q.  That is 7
//   products and 2 exponentials per score where one kernel with dq summed
//   across key blocks would do 5 and 1; the ordered sum that keeps such a
//   kernel deterministic serialises its key blocks per query block.  At
//   D = 40 the backward's floor is its 2 * 2.15e9 exponentials (~1.1 ms).
//   Both kernels stream through a ring of three stages, two tiles ahead.
// - Tile widths (Tiles<D>) keep the accumulators in registers at D = 160:
//   two warpgroups in the forward there, 32-query tiles in dk/dv.

#include "flash_attention.cuh"

namespace {

template <int D>
int bwd(const void* q, const void* k, const void* v, const void* o,
        const void* lse, const void* dout, void* dq, void* dk, void* dv,
        void* delta, int B, int H, int Sq, int Sk, float scale,
        cudaStream_t st) {
  constexpr int BN = fa::Tiles<D>::DQ_BN, BQ = fa::Tiles<D>::DKV_BQ;
  constexpr size_t smem_dq = fa::dq_smem<D>(), smem_kv = fa::dkv_smem<D>();
  cudaFuncSetAttribute(fa::flash_bwd_dq_kernel<D, BN>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dq);
  dim3 gq((Sq + fa::kRows - 1) / fa::kRows, H, B);
  fa::flash_bwd_dq_kernel<D, BN><<<gq, fa::kThreads, smem_dq, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)o, (const bf16*)dout,
      (const float*)lse, (float*)delta, (bf16*)dq, H, Sq, Sk, scale);
  int err = (int)cudaGetLastError();
  if (err) return err;

  cudaFuncSetAttribute(fa::flash_bwd_dkv_kernel<D, BQ>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_kv);
  dim3 gk((Sk + fa::kRows - 1) / fa::kRows, H, B);
  fa::flash_bwd_dkv_kernel<D, BQ><<<gk, fa::kThreads, smem_kv, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (bf16*)dk, (bf16*)dv, H, Sq, Sk, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface, bound with ctypes.  Every launching function returns
// cudaGetLastError() after its launches (0 on success), or -1 for a head dim
// with no kernel.

// Dynamic shared memory in bytes of the forward (kernel 0), the dq kernel
// (1) or the dk/dv kernel (2) at head dim D; -1 for none.
extern "C" int mc_flash_smem(int D, int kernel) {
  switch (D * 4 + kernel) {
    case 160: return (int)fa::fwd_smem<40>();
    case 161: return (int)fa::dq_smem<40>();
    case 162: return (int)fa::dkv_smem<40>();
    case 256: return (int)fa::fwd_smem<64>();
    case 257: return (int)fa::dq_smem<64>();
    case 258: return (int)fa::dkv_smem<64>();
    case 320: return (int)fa::fwd_smem<80>();
    case 321: return (int)fa::dq_smem<80>();
    case 322: return (int)fa::dkv_smem<80>();
    case 640: return (int)fa::fwd_smem<160>();
    case 641: return (int)fa::dq_smem<160>();
    case 642: return (int)fa::dkv_smem<160>();
    default: return -1;
  }
}

extern "C" int mc_flash_fwd(const void* q, const void* k, const void* v,
                            void* o, void* lse, int B, int H, int Sq, int Sk,
                            int D, float scale, void* stream) {
  return flash_fwd(D, (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o,
                   (float*)lse, B, H, Sq, Sk, scale, 1, (cudaStream_t)stream);
}

extern "C" int mc_flash_bwd(const void* q, const void* k, const void* v,
                            const void* o, const void* lse, const void* dout,
                            void* dq, void* dk, void* dv, void* delta, int B,
                            int H, int Sq, int Sk, int D, float scale,
                            void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 40: return bwd<40>(q, k, v, o, lse, dout, dq, dk, dv, delta, B, H, Sq, Sk, scale, st);
    case 64: return bwd<64>(q, k, v, o, lse, dout, dq, dk, dv, delta, B, H, Sq, Sk, scale, st);
    case 80: return bwd<80>(q, k, v, o, lse, dout, dq, dk, dv, delta, B, H, Sq, Sk, scale, st);
    case 160: return bwd<160>(q, k, v, o, lse, dout, dq, dk, dv, delta, B, H, Sq, Sk, scale, st);
    default: return -1;
  }
}
