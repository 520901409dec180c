// Per-pixel temporal self-attention, forward and backward, for sm_90a, in
// its square form (kernels 3 and 4) and its rectangular form (kernels 3r
// and 4r).
//
// Replaces the Pallas TPU kernels of motionclone_tpu/ops/temporal_attention.py
// (`_temporal_fwd` / `_fwd_kernel` and the VJP `_temporal_bwd` /
// `_bwd_kernel`), whose K/V may carry more frames (`fk`) than Q (`f`): the
// rectangular form, which frame-sharded sampling runs on each shard's local
// queries against the keys and values gathered over the shards.
//
// The motion module attends over the frames independently at every pixel
// and head: out[b, i, s, h] = sum_j softmax_j(q[b,i,s,h] . k[b,j,s,h] * scale)
// v[b, j, s, h], i over the FQ query frames, j over the FK key frames.
// Tensors stay in their natural (B, F, S, H*D) layout, bf16.  The forward
// saves the log-sum-exp as f32 (B, S, H, FQ) -- the port's layout, one
// contiguous FQ-vector per (pixel, head) -- and the backward recomputes the
// probabilities from it.
//
// What bounds it on the H100: 4*FQ*FK*D flops per (pixel, head) against
// 2*(FQ+FK)*D*2 bytes of q/k/v/out, i.e. FQ*FK/(FQ+FK) flops per byte: 8 at
// FQ = FK = 16, 5.3 at FQ = 8, far below the ~295 the tensor cores need.
// The kernels are bound by memory.  The design therefore reads each element
// once and writes each once, through shared memory with 16-byte loads along
// the contiguous head slice, and does the small FQ x FK products on the CUDA
// cores in f32.  The TPU kernel's block-diagonal packing of pixels into one
// masked product (it exists only to fill a 128-wide MXU; `pick_tile` widens
// the tile for small FQ for the same reason) is not carried over.
//
// Block shape: one block per (b, tile of TP pixels, head), FK * TP threads.
// TP scales inversely with D so that a tile of 16 frames of k or v is
// ~20 KB at every head dim, and is the same in both forms: the K/V tiles
// size the block, not FQ.  In the forward the first FQ * TP threads take one
// (pixel, query frame) row each; in the backward the dk/dv rows are one per
// thread.

#include "temporal_attention.cuh"

namespace {

template <int D, int FQ>
int bwd(const void* q, const void* k, const void* v, const void* lse,
        const void* dout, void* dq, void* dk, void* dv, int B, int S, int H,
        float scale, cudaStream_t st) {
  // half the forward's pixel tile: the backward holds five tiles
  constexpr int TP = pixels_per_block<D>() / 2;
  const size_t smem = (2 * FQ + 3 * kF) * Tile<D, TP>::FS * sizeof(bf16) +
                      2 * TP * FQ * kF * sizeof(float);
  cudaFuncSetAttribute(temporal_bwd_kernel<D, TP, FQ, kF>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  dim3 grid((S + TP - 1) / TP, H, B);
  temporal_bwd_kernel<D, TP, FQ, kF><<<grid, kF * TP, smem, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const float*)lse,
      (const bf16*)dout, (bf16*)dq, (bf16*)dk, (bf16*)dv, S, H, scale);
  return (int)cudaGetLastError();
}

template <int FQ>
int bwd_fq(int D, const void* q, const void* k, const void* v, const void* lse,
           const void* dout, void* dq, void* dk, void* dv, int B, int S, int H,
           float scale, cudaStream_t st) {
  switch (D) {
    case 40: return bwd<40, FQ>(q, k, v, lse, dout, dq, dk, dv, B, S, H, scale, st);
    case 80: return bwd<80, FQ>(q, k, v, lse, dout, dq, dk, dv, B, S, H, scale, st);
    case 160: return bwd<160, FQ>(q, k, v, lse, dout, dq, dk, dv, B, S, H, scale, st);
    default: return -1;
  }
}

}  // namespace

// C interface, bound with ctypes.  FQ is q's frame count, FK that of k and
// v: FK = 16 with FQ = 16 (kernels 3, 4) or FQ in {8, 4, 2, 1} (3r, 4r).
// Every function returns cudaGetLastError() after its launch (0 on
// success), or -1 for a shape with no kernel.

extern "C" int mc_temporal_fwd(const void* q, const void* k, const void* v,
                               void* o, void* lse, int B, int FQ, int FK, int S,
                               int H, int D, float scale, void* stream) {
  if (FK != kF) return -1;
  return temporal_fwd(D, FQ, (const bf16*)q, (const bf16*)k, (const bf16*)v,
                      (bf16*)o, (float*)lse, B, S, H, scale, (cudaStream_t)stream);
}

extern "C" int mc_temporal_bwd(const void* q, const void* k, const void* v,
                               const void* lse, const void* dout, void* dq,
                               void* dk, void* dv, int B, int FQ, int FK, int S,
                               int H, int D, float scale, void* stream) {
  if (FK != kF) return -1;
  cudaStream_t st = (cudaStream_t)stream;
  switch (FQ) {
    case kF: return bwd_fq<kF>(D, q, k, v, lse, dout, dq, dk, dv, B, S, H, scale, st);
    case 8: return bwd_fq<8>(D, q, k, v, lse, dout, dq, dk, dv, B, S, H, scale, st);
    case 4: return bwd_fq<4>(D, q, k, v, lse, dout, dq, dk, dv, B, S, H, scale, st);
    case 2: return bwd_fq<2>(D, q, k, v, lse, dout, dq, dk, dv, B, S, H, scale, st);
    case 1: return bwd_fq<1>(D, q, k, v, lse, dout, dq, dk, dv, B, S, H, scale, st);
    default: return -1;
  }
}
