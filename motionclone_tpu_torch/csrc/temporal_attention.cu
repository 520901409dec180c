// Per-pixel temporal self-attention, forward and backward, for sm_90a.
//
// Replaces the Pallas TPU kernels of motionclone_tpu/ops/temporal_attention.py
// (`_temporal_fwd` / `_fwd_kernel` and the VJP `_temporal_bwd` /
// `_bwd_kernel`).
//
// The motion module attends over the F frames independently at every pixel
// and head: out[b, i, s, h] = sum_j softmax_j(q[b,i,s,h] . k[b,j,s,h] * scale)
// v[b, j, s, h].  Tensors stay in their natural (B, F, S, H*D) layout, bf16.
// The forward saves the log-sum-exp as f32 (B, S, H, F) -- the port's
// layout, one contiguous F-vector per (pixel, head) -- and the backward
// recomputes the probabilities from it.
//
// What bounds it on the H100: 4*F*F*D flops per (pixel, head) against
// 4*F*D*2 bytes of q/k/v/out, i.e. F/2 = 8 flops per byte at F=16, far below
// the ~295 the tensor cores need: the kernel is bound by memory.  The design
// therefore reads each element once and writes each once, through shared
// memory with 16-byte loads along the contiguous head slice, and does the
// small 16x16 products on the CUDA cores in f32.  The TPU kernel's
// block-diagonal packing of 16 pixels into one masked 256x256 product (it
// exists only to fill a 128-wide MXU) is not carried over.
//
// Block shape: one block per (b, tile of TP pixels, head); one thread per
// (pixel, query frame).  TP scales inversely with D so that a tile of q, k
// or v is ~20 KB at every head dim.

#include "temporal_attention.cuh"

namespace {

template <int D>
int bwd(const void* q, const void* k, const void* v, const void* lse,
        const void* dout, void* dq, void* dk, void* dv, int B, int S, int H,
        float scale, cudaStream_t st) {
  // half the forward's pixel tile: the backward holds five tiles
  constexpr int TP = pixels_per_block<D>() / 2;
  const size_t smem = 5 * Tile<D, TP>::ELEMS * sizeof(bf16) +
                      2 * TP * kF * kF * sizeof(float);
  cudaFuncSetAttribute(temporal_bwd_kernel<D, TP>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  dim3 grid((S + TP - 1) / TP, H, B);
  temporal_bwd_kernel<D, TP><<<grid, kF * TP, smem, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const float*)lse,
      (const bf16*)dout, (bf16*)dq, (bf16*)dk, (bf16*)dv, S, H, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface, bound with ctypes.  Every function returns cudaGetLastError()
// after its launch (0 on success), or -1 for a shape with no kernel.

extern "C" int mc_temporal_fwd(const void* q, const void* k, const void* v,
                               void* o, void* lse, int B, int F, int S, int H,
                               int D, float scale, void* stream) {
  if (F != kF) return -1;
  return temporal_fwd(D, (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o,
                      (float*)lse, B, S, H, scale, (cudaStream_t)stream);
}

extern "C" int mc_temporal_bwd(const void* q, const void* k, const void* v,
                               const void* lse, const void* dout, void* dq,
                               void* dk, void* dv, int B, int F, int S, int H,
                               int D, float scale, void* stream) {
  if (F != kF) return -1;
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 40: return bwd<40>(q, k, v, lse, dout, dq, dk, dv, B, S, H, scale, st);
    case 80: return bwd<80>(q, k, v, lse, dout, dq, dk, dv, B, S, H, scale, st);
    case 160: return bwd<160>(q, k, v, lse, dout, dq, dk, dv, B, S, H, scale, st);
    default: return -1;
  }
}
