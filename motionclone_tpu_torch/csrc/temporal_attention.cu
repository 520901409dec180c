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
// v[b, j, s, h], i over the FQ query frames, j over the 16 key frames.
// Tensors stay in their natural (B, F, S, H*D) layout, bf16.  The forward
// saves the log-sum-exp as f32 (B, S, H, FQ) -- one contiguous FQ-vector
// per (pixel, head) -- and the backward recomputes P from it and forms
// delta = rowsum(P∘dP) without reading the forward's output.
//
// What bounds it on the H100: 4·FQ·16·D flops per (pixel, head) against
// 2·(FQ + 16)·D·2 bytes of q, k, v and out: 8 flops per byte at FQ = 16,
// far below the ~295 of the tensor cores.  The kernels are bound by
// memory, so the design is about keeping HBM streaming; the small products
// go to the tensor cores only so that their instructions hide under the
// loads (on the CUDA cores they cost as much issue time as the byte bound).
//
// The design (device code in temporal_attention.cuh):
//   - A tile is (b, one pixel, a 160-channel slice of whole heads: 4 at
//     D = 40, 2 at 80, 1 at 160).  Each (frame, pixel) row of it is one
//     contiguous 320-byte run in q, k, v, dO and every output, whatever D.
//   - A warp owns its tiles from load to store, with a ring of 2 stages
//     of its own tracked by mbarriers: it issues the next tile's bulk
//     loads (cp.async.bulk, one per row run, spread over its lanes) before
//     it waits for the current one, so the loads overlap the products and
//     the stores; a stage is refilled once the bulk stores out of it have
//     read it.  A block holds as many such warps as shared memory allows
//     (7 for the square forward, 5 for its backward) and the grid one
//     block per SM; the warps never synchronise with each other, so one
//     SM keeps 5-7 tiles (80-110 KB) in flight, and the copies are issued
//     by every warp.  A block-wide ring fed by one producer warp, the
//     usual Hopper shape, was 1.2-2.0x slower: one warp cannot issue the
//     48-64 copies of every tile fast enough (scripts/torch_temporal_
//     variants.py times it, 2 pixels a tile and 3 stages a warp too).
//   - Rows land at a pitch of 336 bytes: 21 16-byte units, odd, so the 8
//     frame rows an ldmatrix reads fall on 8 different groups of banks
//     (a 320-byte pitch gives 4-way conflicts; scripts/torch_temporal_
//     variants.py times both).  TMA's swizzles would need boxes of at most
//     128 bytes, and 160 channels are not a multiple of 64.
//   - Per (pixel, head) the warp runs the 16 x 16 products on
//     mma.sync.m16n8k16 (bf16 in, f32 accumulate), 16 query rows being the
//     product's M; FQ < 16 pads the rows (they read row FQ - 1 and are
//     discarded, or zeroed where the backward sums over them).  D = 40 is
//     two k16 steps and a k8 tail (the fragments' other half zeroed in
//     registers).  Forward: S = Q Kᵀ, an exact softmax in f32 from the
//     accumulators, lse, P rounded to bf16 as the A operand straight from
//     the accumulator layout (the TPU kernel's rounding point, `p = (exp /
//     l).astype(v.dtype)`), O = P V with V by ldmatrix.trans.  Backward,
//     one pass: S and dP = dO Vᵀ, P = exp(S·scale - lse), delta, dS in
//     f32, then dQ = dS K, dK = dSᵀ Q and dV = Pᵀ dO, 16 channels at a
//     time, the transposes of dS and P by movmatrix.
//   - Each output row is written over the input row it replaces (out and
//     dq over q, dk over k, dv over v) once every lane has read it, and
//     the tile's rows go out by bulk copies (cp.async.bulk) from shared
//     memory.  Each output element is written by one warp, with no atomics
//     and no split reduction: two launches give the same bits.
// ops/temporal_attention.py `tile_plan` mirrors the tiles and their row
// runs on the CPU.

#include "temporal_attention.cuh"

namespace {

// The backward: dq like q, dk and dv like k, from the forward's lse.
inline int temporal_bwd(int D, int FQ, const bf16* q, const bf16* k, const bf16* v,
                        const float* lse, const bf16* dout, bf16* dq, bf16* dk, bf16* dv,
                        int B, int S, int H, float scale, cudaStream_t st) {
  ta::Args a{};
  a.q = q, a.k = k, a.v = v, a.dout = dout, a.o = dq, a.dk = dk, a.dv = dv;
  a.lse = const_cast<float*>(lse);
  a.B = B, a.S = S, a.H = H, a.scale = scale;
  return ta::launch_fq<true>(D, FQ, a, st);
}

template <int FQ, bool BWD>
int smem_d(int D) {
  switch (D) {
    case 40: return ta::Plan<40, FQ, BWD>::SMEM;
    case 80: return ta::Plan<80, FQ, BWD>::SMEM;
    case 160: return ta::Plan<160, FQ, BWD>::SMEM;
    default: return -1;
  }
}

template <bool BWD>
int smem_fq(int D, int FQ) {
  switch (FQ) {
    case kF: return smem_d<kF, BWD>(D);
    case 8: return smem_d<8, BWD>(D);
    case 4: return smem_d<4, BWD>(D);
    case 2: return smem_d<2, BWD>(D);
    case 1: return smem_d<1, BWD>(D);
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
  return temporal_bwd(D, FQ, (const bf16*)q, (const bf16*)k, (const bf16*)v,
                      (const float*)lse, (const bf16*)dout, (bf16*)dq, (bf16*)dk,
                      (bf16*)dv, B, S, H, scale, (cudaStream_t)stream);
}

// Dynamic shared memory per block of the forward (bwd = 0) or the backward
// (bwd = 1) for head dim D and FQ query frames; -1 for a shape with no
// kernel.  Warps per block: this over 2·(stage bytes + 8).
extern "C" int mc_temporal_smem(int D, int FQ, int bwd) {
  return bwd ? smem_fq<true>(D, FQ) : smem_fq<false>(D, FQ);
}
