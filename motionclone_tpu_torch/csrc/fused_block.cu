// Fused spatial transformer forward for sm_90a: the whole single-layer
// Transformer3DModel, and its BasicTransformerBlock alone.
//
// Replaces the Pallas TPU kernels of motionclone_tpu/ops/fused_block.py:
// `fused_spatial_transformer` (`_transformer_kernel`)
//
//   x -> per-frame GN (statistics included) -> proj_in -> h
//     -> h + attn1(LN1 h) -> + attn2(LN2 ., text) -> + GEGLU FF(LN3 .)
//     -> proj_out -> + x
//
// and `fused_transformer_block` (`_kernel`), the same without the GN /
// proj_in entry and the proj_out exit.  x is (B·F, S, C) bf16.
//
// What bounds it on the H100: ~618 GFLOP at (16, 4096, 320), of which the
// per-frame S x S self-attention is 344 and the products 268; both run on
// the tensor cores, far above the card's ~295 flops per byte, so it is
// bound by operations.  The TPU kernel keeps a frame's K and V^T in VMEM
// scratch across its query tiles; a frame's K and V (4096 x 320 bf16,
// 2.6 MB each) do not fit a Hopper block's shared memory, so here one
// launch of the TMA + wgmma product (fused_product.cuh) writes the frame's
// q, k and v once, and the attention streams K/V tile by tile through the
// exact online-softmax forward of flash_attention.cuh (no +-75 logit
// clamp).  The cross-attention's K2/V2 are projected once per video from its 77
// text tokens and shared by its frames (the attention kernel reads k/v
// batch b / frames).  Each LayerNorm, and the GroupNorm (statistics from
// the two-pass reduction), is one normalisation pass writing the bf16
// operand of the next product; biases, the GEGLU gate and every residual
// add run in the products' epilogues.  Every product of both entry points
// is one launch of that product (128 x 160 tiles: N and the q|k|v chunk
// width are multiples of 160, K of 64).  Activations between launches are
// bf16, where the TPU kernel rounds them too.

#include "fused_product.cuh"

namespace {

// ptrs:  0 x (BF·S, C), 1 ctx (B·T, Dc), 2 gn gamma, 3 gn beta, 4 win (C, C),
//        5 bin (2-5 null without the entry), 6 ln1 gamma, 7 ln1 beta,
//        8 wqkv1 (3C, C), 9 wo1, 10 bo1, 11 ln2 gamma, 12 ln2 beta, 13 wq2,
//        14 wkv2 (2C, Dc), 15 wo2, 16 bo2, 17 ln3 gamma, 18 ln3 beta,
//        19 wff1 (8C, C) with value/gate rows interleaved, 20 bff1,
//        21 wff2 (C, 4C), 22 bff2, 23 wout, 24 bout (null without the exit),
//        25 out;
//        scratch: 26 partial sums, 27 gn w, 28 gn b, 29 h (M, C), 30
//        normalised operand (M, C), 31 q|k|v (3, M, C), 32 attention (M, C),
//        33 x1 (M, C), 34 k2|v2 (2, B·T, C), 35 GEGLU activation (M, 4C),
//        36 lse (BF·heads·S) f32; activations bf16
// dims:  0 BF, 1 frames, 2 S, 3 C, 4 heads, 5 T, 6 Dc, 7 groups, 8 chunks
int transformer(void* const* p, const int* d, float eps, bool whole,
                cudaStream_t st) {
  using namespace fz;
  const int BF = d[0], F = d[1], S = d[2], C = d[3], H = d[4], T = d[5];
  const int Dc = d[6], G = d[7], nch = d[8];
  const int M = BF * S, D = C / H, videos = BF / F;
  if (C % H || (D != 40 && D != 64 && D != 80 && D != 160)) return -1;
  const bf16* x = (const bf16*)p[0];
  bf16* h = (bf16*)p[29];
  bf16* xn = (bf16*)p[30];
  bf16* qkv = (bf16*)p[31];
  bf16* attn = (bf16*)p[32];
  bf16* x1 = (bf16*)p[33];
  bf16* kv2 = (bf16*)p[34];
  bf16* act = (bf16*)p[35];
  float* lse = (float*)p[36];
  const float ln_eps = 1e-5f, scale = 1.f / sqrtf((float)D);
  const long mc = (long)M * C;

  if (whole) {
    // per-frame GroupNorm (statistics here) -> proj_in -> h
    float* gw = (float*)p[27];
    float* gb = (float*)p[28];
    MC_CHECK(group_norm_affine<bf16>(x, (const float*)p[2], (const float*)p[3],
                                     (float*)p[26], gw, gb, BF, S, C, G, nch,
                                     eps, st));
    MC_CHECK(group_norm_apply<bf16>(x, gw, gb, xn, BF, S, C, false, st));
    MC_CHECK(product(gemm_args(xn, p[4], p[5], h, 0, M, C, C), st));
  } else {
    h = const_cast<bf16*>(x);
  }

  // attn1: LN1 -> q, k, v -> self-attention per frame -> + bo1 + h
  MC_CHECK(layer_norm_rows<bf16>(h, (const float*)p[6], (const float*)p[7], nullptr,
                                 xn, M, C, 1, 1, ln_eps, st));
  GemmArgs q = gemm_args(xn, p[8], nullptr, qkv, 0, M, 3 * C, C);
  split_output(q, C);
  MC_CHECK(product(q, st));
  MC_CHECK(flash_fwd(D, qkv, qkv + mc, qkv + 2 * mc, attn, lse, BF, H, S, S, scale, 1, st));
  GemmArgs o1 = gemm_args(attn, p[9], p[10], x1, 0, M, C, C);
  o1.res = h;
  MC_CHECK(product(o1, st));

  // attn2: LN2 -> q2; k2, v2 once per video from the text; cross-attention
  MC_CHECK(layer_norm_rows<bf16>(x1, (const float*)p[11], (const float*)p[12], nullptr,
                                 xn, M, C, 1, 1, ln_eps, st));
  MC_CHECK(product(gemm_args(xn, p[13], nullptr, qkv, 0, M, C, C), st));
  GemmArgs kv = gemm_args(p[1], p[14], nullptr, kv2, 0, videos * T, 2 * C, Dc);
  split_output(kv, C);
  MC_CHECK(product(kv, st));
  MC_CHECK(flash_fwd(D, qkv, kv2, kv2 + (long)videos * T * C, attn, lse, BF, H,
                     S, T, scale, F, st));
  // x2 = x1 + attn2 @ wo2^T + bo2, into h's buffer (h is read no more; for
  // the block alone h is the input, so x2 goes to the q|k|v scratch)
  bf16* x2 = whole ? h : qkv + mc;
  GemmArgs o2 = gemm_args(attn, p[15], p[16], x2, 0, M, C, C);
  o2.res = x1;
  MC_CHECK(product(o2, st));

  // ff: LN3 -> GEGLU -> + bff2 + x2
  MC_CHECK(layer_norm_rows<bf16>(x2, (const float*)p[17], (const float*)p[18], nullptr,
                                 xn, M, C, 1, 1, ln_eps, st));
  GemmArgs f1 = gemm_args(xn, p[19], p[20], act, 0, M, 8 * C, C);
  f1.ldo = 4 * C;
  MC_CHECK((product<true>(f1, st)));
  GemmArgs f2 = gemm_args(act, p[21], p[22], whole ? (void*)x1 : p[25], 0, M,
                          C, 4 * C);
  f2.res = x2;
  MC_CHECK(product(f2, st));
  if (!whole) return 0;

  // proj_out + bout + x
  GemmArgs y = gemm_args(x1, p[23], p[24], p[25], 0, M, C, C);
  y.res = x;
  return product(y, st);
}

}  // namespace

extern "C" int mc_fused_spatial_transformer(void* const* p, const int* d,
                                            float eps, void* stream) {
  return transformer(p, d, eps, true, (cudaStream_t)stream);
}

extern "C" int mc_fused_transformer_block(void* const* p, const int* d,
                                          float eps, void* stream) {
  return transformer(p, d, eps, false, (cudaStream_t)stream);
}
