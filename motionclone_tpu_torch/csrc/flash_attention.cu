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
// probabilities from it.
//
// What bounds it on the H100: the spatial self-attention of SD1.5 at 64x64
// latents (S=4096, D=40) does 4*S*S*D flops per (batch, head) against
// 4*S*D*2 bytes of q/k/v/out, ~2000 flops per byte, so it is bound by the
// tensor cores, not by memory.  The design keeps every S x S tile on chip
// (the online softmax of the flash scheme) and runs both products on the
// tensor cores with mma.sync m16n8k16 (bf16 in, f32 accumulate).  Head dims
// 40/80/160 are not powers of two; the tile is zero-padded to a multiple of
// 16 in shared memory (40 -> 48), which costs 20% of the tensor work at
// D=40 and nothing at 80/160.  Unlike the TPU kernel there is no +-75 logit
// clamp: the softmax keeps an exact running row maximum.
//
// Block shape: 4 warps, 16 rows each, 64 rows per block; the other side of
// the product streams through shared memory in tiles.  No wgmma, no TMA,
// no cp.async pipelining yet: this is the simple, correct first version.

#include "flash_attention.cuh"

namespace {

template <int D>
int bwd(const void* q, const void* k, const void* v, const void* o,
        const void* lse, const void* dout, void* dq, void* dk, void* dv,
        void* delta, int B, int H, int Sq, int Sk, float scale,
        cudaStream_t st) {
  constexpr int LD = Geo<D>::LD;
  constexpr int BQ = D > 80 ? 32 : 64;
  const long rows = (long)B * Sq * H;
  flash_delta_kernel<D><<<(unsigned)((rows + 255) / 256), 256, 0, st>>>(
      (const bf16*)o, (const bf16*)dout, (float*)delta, B, H, Sq);
  int err = (int)cudaGetLastError();
  if (err) return err;

  const size_t smem_dq = (size_t)(2 * kRows + 2 * 64) * LD * sizeof(bf16);
  cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dq);
  dim3 gq((Sq + kRows - 1) / kRows, H, B);
  flash_bwd_dq_kernel<D><<<gq, kThreads, smem_dq, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (bf16*)dq, H, Sq, Sk, scale);
  err = (int)cudaGetLastError();
  if (err) return err;

  const size_t smem_kv =
      (size_t)(2 * kRows + 2 * BQ) * LD * sizeof(bf16) + 2 * BQ * sizeof(float);
  cudaFuncSetAttribute(flash_bwd_dkv_kernel<D, BQ>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_kv);
  dim3 gk((Sk + kRows - 1) / kRows, H, B);
  flash_bwd_dkv_kernel<D, BQ><<<gk, kThreads, smem_kv, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (bf16*)dk, (bf16*)dv, H, Sq, Sk,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface, bound with ctypes.  Every function returns cudaGetLastError()
// after its launches (0 on success), or -1 for a head dim with no kernel.

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
    case 80: return bwd<80>(q, k, v, o, lse, dout, dq, dk, dv, delta, B, H, Sq, Sk, scale, st);
    case 160: return bwd<160>(q, k, v, o, lse, dout, dq, dk, dv, delta, B, H, Sq, Sk, scale, st);
    default: return -1;
  }
}
