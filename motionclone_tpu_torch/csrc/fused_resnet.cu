// Fused ResnetBlock3D forward for sm_90a.
//
// Replaces the Pallas TPU kernel of motionclone_tpu/ops/fused_resnet.py
// (`fused_resnet_block` / `_kernel`):
//
//   x -> GN1 -> SiLU -> conv3x3 + b1 + temb row -> GN2 -> SiLU -> conv3x3
//     + b2 + shortcut(x)     (shortcut: a 1x1 product, or x itself)
//
// with per-(batch·frame) GroupNorm statistics (AnimateDiff's inflated
// GroupNorm).  x is the (B·F, H, W, Cin) video, channels last, bf16.
//
// What bounds it on the H100: the two 3x3 convolutions, 2·9·(Cin + Cout)·Cout
// flops per pixel, e.g. 242 GFLOP at 64x64, 320 -> 320, B·F = 16, against
// ~2·(Cin + Cout) bytes per pixel: bound by the tensor cores.  The TPU
// kernel keeps one frame in VMEM and forms each tap as a row-shifted slice
// with an iota mask; here a frame (up to 5 MB) does not fit a block, so each
// convolution is an implicit GEMM over K = 9·Cin (fused_common.cuh) whose
// loader gathers the tap's pixel and zero-fills outside the frame.  Its
// input is GN + SiLU of the block's input, written once as bf16 by a
// normalisation pass (the TPU kernel rounds it to bf16 before its dots
// too), after a two-pass GroupNorm reduction (per-chunk partial sums, then
// a fixed-order reduction per group).
//
// Launches: GN1 statistics and GN1 + SiLU, conv1 (epilogue + b1 + temb row,
// stored f32 as the TPU kernel keeps conv1's output: GN2's statistics see
// f32 values), GN2 statistics and GN2 + SiLU, the shortcut product (f32,
// when Cin != Cout), conv2 (epilogue + b2 + shortcut, stored bf16).
// time_emb_proj(silu(temb)) is computed by the caller, as in the JAX
// package.

#include "fused_common.cuh"

// ptrs:  0 x, 1 temb (B, Cout) or null, 2 gn1 gamma, 3 gn1 beta, 4 w1
//        (Cout, 9·Cin), 5 b1, 6 gn2 gamma, 7 gn2 beta, 8 w2 (Cout, 9·Cout),
//        9 b2, 10 wsc (Cout, Cin) or null, 11 bsc or null, 12 out;
//        scratch: 13 partial sums, 14 gn w, 15 gn b (BF·max(Cin, Cout) f32
//        each), 16 conv1 output (BF·H·W, Cout) f32, 17 shortcut (same) or
//        null, 18 normalised activation (BF·H·W, max(Cin, Cout)) bf16
// dims:  0 BF, 1 frames, 2 H, 3 W, 4 Cin, 5 Cout, 6 groups, 7 pixel chunks
extern "C" int mc_fused_resnet_block(void* const* p, const int* d, float eps,
                                     void* stream) {
  using namespace fz;
  cudaStream_t st = (cudaStream_t)stream;
  const int BF = d[0], F = d[1], H = d[2], W = d[3], Cin = d[4], Cout = d[5];
  const int G = d[6], nch = d[7];
  const int HW = H * W, M = BF * HW;
  const bf16* x = (const bf16*)p[0];
  float* part = (float*)p[13];
  float* gw = (float*)p[14];
  float* gb = (float*)p[15];
  float* h = (float*)p[16];
  bf16* act = (bf16*)p[18];

  // GN1 + SiLU of x -> act
  MC_CHECK(group_norm_affine<bf16>(x, (const float*)p[2], (const float*)p[3],
                                   part, gw, gb, BF, HW, Cin, G, nch, eps, st));
  MC_CHECK(group_norm_apply<bf16>(x, gw, gb, act, BF, HW, Cin, true, st));
  // conv1 + b1 + temb row -> h (f32)
  GemmArgs g = gemm_args(act, p[4], p[5], h, 1, M, Cout, 9 * Cin);
  g.H = H;
  g.W = W;
  g.Cin = Cin;
  g.temb = (const bf16*)p[1];
  g.temb_rows = (long)F * HW;
  MC_CHECK((gemm<true>(g, st)));
  // GN2 (statistics on conv1's f32 output) + SiLU -> act
  MC_CHECK(group_norm_affine<float>(h, (const float*)p[6], (const float*)p[7],
                                    part, gw, gb, BF, HW, Cout, G, nch, eps, st));
  MC_CHECK(group_norm_apply<float>(h, gw, gb, act, BF, HW, Cout, true, st));
  // shortcut: x @ wsc^T + bsc in f32, or x itself
  const void* res = x;
  int res_f32 = 0;
  if (p[10] != nullptr) {
    GemmArgs s = gemm_args(x, p[10], p[11], p[17], 1, M, Cout, Cin);
    MC_CHECK(gemm(s, st));
    res = p[17];
    res_f32 = 1;
  }
  // conv2 + b2 + shortcut -> out
  GemmArgs c = gemm_args(act, p[8], p[9], p[12], 0, M, Cout, 9 * Cout);
  c.H = H;
  c.W = W;
  c.Cin = Cout;
  c.res = res;
  c.res_f32 = res_f32;
  return gemm<true>(c, st);
}
