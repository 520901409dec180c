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
// convolution is an implicit GEMM over K = 9·Cin on the TMA + wgmma product
// of fused_product.cuh (`conv3x3` below): its producer loads each tap's A tile
// through a 4-D tensor map, whose zero fill outside the frame is the
// padding.  Its input is GN + SiLU of the block's input, written once as
// bf16 by a normalisation pass (the TPU kernel rounds it to bf16 before its
// dots too), after a two-pass GroupNorm reduction (per-chunk partial sums,
// then a fixed-order reduction per group).
//
// Launches: GN1 statistics and GN1 + SiLU, conv1 (epilogue + b1 + temb row,
// stored f32 as the TPU kernel keeps conv1's output: GN2's statistics see
// f32 values), GN2 statistics and GN2 + SiLU, the shortcut product (f32,
// when Cin != Cout), conv2 (epilogue + b2 + shortcut, stored bf16).
// time_emb_proj(silu(temb)) is computed by the caller, as in the JAX
// package.

#include "fused_product.cuh"

namespace {
namespace fz {

// The shapes the convolution takes (ops/fused_resnet.py mirrors the rule):
// those of the product, Cin % 64 == 0 (a k-tile never straddles two taps),
// H·W % 128 == 0 (a tile never straddles two frames) and min(W, 128)
// dividing both 128 and W (a box is whole image rows); a temb row only
// without a residual, whose video holds a whole number of tiles.
inline bool conv_takes(const GemmArgs& g) {
  const int hw = g.H * g.W, wb = g.W < tp::BM ? g.W : tp::BM;
  return g.M >= 1 && g.H >= 1 && g.W >= 1 && g.Cin % tp::BK == 0 && g.K == 9 * g.Cin &&
         g.N % tp::BN == 0 && g.ldo == g.N && hw % tp::BM == 0 && g.M % hw == 0 &&
         tp::BM % wb == 0 && g.W % wb == 0 &&
         (g.temb == nullptr || (g.res == nullptr && g.temb_rows % tp::BM == 0));
}

// Launch the 3x3 convolution (padding 1) of the (M / (H·W), H, W, Cin)
// video g.a by the (N, 9·Cin) weight g.b on the shapes it takes
// (conv_takes), in the resnet's two flavours: f32 out with no residual
// (conv1: + bias + temb row) and bf16 out with a bf16 or f32 residual
// (conv2).  Returns as `product`.
inline int conv3x3(const GemmArgs& g, cudaStream_t st) {
  if (!conv_takes(g)) return -1;
  if (g.res == nullptr) return g.out_f32 ? tp::launch<0, true, false, true>(g, st) : -1;
  if (g.out_f32) return -1;
  return g.res_f32 ? tp::launch<2, false, false, true>(g, st)
                   : tp::launch<1, false, false, true>(g, st);
}

}  // namespace fz

// The convolution's GemmArgs: the (BF, H, W, Cin) video act by the (Cout,
// 9·Cin) weight w.
fz::GemmArgs conv_args(const void* act, const void* w, const void* bias, void* out,
                       int out_f32, int BF, int H, int W, int Cin, int Cout) {
  fz::GemmArgs g = fz::gemm_args(act, w, bias, out, out_f32, BF * H * W, Cout, 9 * Cin);
  g.H = H;
  g.W = W;
  g.Cin = Cin;
  return g;
}

}  // namespace

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

  // every product's shape first: nothing launches for a shape one refuses
  GemmArgs c1 = conv_args(act, p[4], p[5], h, 1, BF, H, W, Cin, Cout);
  c1.temb = (const bf16*)p[1];
  c1.temb_rows = (long)F * HW;
  GemmArgs c2 = conv_args(act, p[8], p[9], p[12], 0, BF, H, W, Cout, Cout);
  c2.res = x;
  GemmArgs sc = gemm_args(x, p[10], p[11], p[17], 1, M, Cout, Cin);
  if (p[10] != nullptr) {  // conv2 adds the f32 shortcut instead of x
    c2.res = p[17];
    c2.res_f32 = 1;
    if (!product_takes(sc)) return -1;
  }
  if (!conv_takes(c1) || !conv_takes(c2)) return -1;

  // GN1 + SiLU of x -> act
  MC_CHECK(group_norm_affine<bf16>(x, (const float*)p[2], (const float*)p[3],
                                   part, gw, gb, BF, HW, Cin, G, nch, eps, st));
  MC_CHECK(group_norm_apply<bf16>(x, gw, gb, act, BF, HW, Cin, true, st));
  // conv1 + b1 + temb row -> h (f32)
  MC_CHECK(conv3x3(c1, st));
  // GN2 (statistics on conv1's f32 output) + SiLU -> act
  MC_CHECK(group_norm_affine<float>(h, (const float*)p[6], (const float*)p[7],
                                    part, gw, gb, BF, HW, Cout, G, nch, eps, st));
  MC_CHECK(group_norm_apply<float>(h, gw, gb, act, BF, HW, Cout, true, st));
  // shortcut: x @ wsc^T + bsc in f32
  if (p[10] != nullptr) MC_CHECK((tp::launch<0, true, false>(sc, st)));
  // conv2 + b2 + shortcut (or x) -> out
  return conv3x3(c2, st);
}

// The convolution alone (`conv3x3`), for checking and timing it apart from
// the module.
// ptrs:  0 act (BF·H·W, Cin) bf16, 1 w (Cout, 9·Cin) bf16, 2 bias (Cout)
//        f32 or null, 3 temb (videos, Cout) bf16 or null, 4 residual
//        (BF·H·W, Cout) or null, 5 out
// dims:  0 BF, 1 frames per video, 2 H, 3 W, 4 Cin, 5 Cout, 6 residual is
//        f32, 7 out is f32
extern "C" int mc_conv3x3(void* const* p, const int* d, void* stream) {
  fz::GemmArgs g = conv_args(p[0], p[1], p[2], p[5], d[7], d[0], d[2], d[3], d[4], d[5]);
  g.temb = (const bf16*)p[3];
  g.temb_rows = (long)d[1] * d[2] * d[3];
  g.res = p[4];
  g.res_f32 = d[6];
  return fz::conv3x3(g, (cudaStream_t)stream);
}
