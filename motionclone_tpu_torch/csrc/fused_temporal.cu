// Fused AnimateDiff motion module (TemporalTransformer3D) forward for sm_90a.
//
// Replaces the Pallas TPU kernel of motionclone_tpu/ops/fused_temporal.py
// (`fused_temporal_module` / `_kernel`), with the folded GroupNorm affine of
// `folded_groupnorm_affine` computed here too:
//
//   x -> GN affine -> proj_in -> [LN -> +PE -> q, k, v -> per-pixel
//     attention over the F frames -> out-proj -> +res] x n_attn -> LN ->
//     GEGLU FF -> +res -> proj_out -> + x
//
// x is (B, F, S, C) bf16, S = H·W pixels.  As on the TPU, the residual
// stream h between the sublayers stays f32; every product reads bf16.
//
// What bounds it on the H100: the ten C x C products per row (proj_in,
// q/k/v and out-proj twice, GEGLU's 8C and 4C, proj_out: 2·18·C^2 flops)
// are bound by the tensor cores, ~298 GFLOP at (1, 16, 4096, 320); the
// attention itself is 16 x 16 per (pixel, head) and bound by memory.  The
// TPU kernel holds a (F, 16 pixels, C) tile in VMEM through the whole
// module; a Hopper block cannot hold the FF's 4C-wide hidden layer for
// enough rows, so here every product is one launch of the TMA + wgmma
// product of fused_product.cuh (bias, GEGLU gate and residual add in its
// epilogue; the out-projections and the FF's second product update the f32
// stream h in place), each reading a bf16 operand that one normalisation
// pass writes (GN affine, LN + PE, or the f32 stream's cast: the TPU
// kernel's own rounding points), and the attention is the temporal forward kernel of
// temporal_attention.cuh on the q, k, v the product lays out as three
// contiguous (B, F, S, C) tensors.  The per-pixel attention is exact (the
// TPU's +-75 logit clamp and its block-diagonal packing are not carried
// over).

#include "fused_product.cuh"
#include "temporal_attention.cuh"

// ptrs:  0 x, 1 gn gamma, 2 gn beta, 3 pe (F, C) bf16 or null, 4 win, 5 bin,
//        6 ff LN gamma, 7 ff LN beta, 8 wff1 (8C, C) with value/gate rows
//        interleaved, 9 bff1 (interleaved), 10 wff2 (C, 4C), 11 bff2,
//        12 wout, 13 bout, 14 out;
//        scratch: 15 partial sums, 16 gn w, 17 gn b, 18 h (M, C) f32,
//        19 normalised operand (M, C) bf16, 20 q|k|v (3, M, C) bf16,
//        21 attention (M, C) bf16, 22 GEGLU activation (M, 4C) bf16, 23 lse
//        (M·heads) f32; then per attention block i, at 24 + 5i: LN gamma,
//        LN beta, wqkv (3C, C), wo (C, C), bo
// dims:  0 B, 1 F, 2 S, 3 C, 4 heads, 5 groups, 6 attention blocks, 7 chunks
extern "C" int mc_fused_temporal_module(void* const* p, const int* d, float eps,
                                        void* stream) {
  using namespace fz;
  cudaStream_t st = (cudaStream_t)stream;
  const int B = d[0], F = d[1], S = d[2], C = d[3], H = d[4], G = d[5];
  const int n_attn = d[6], nch = d[7];
  const int M = B * F * S, D = C / H;
  if (F != kF || C % H || (D != 40 && D != 80 && D != 160)) return -1;
  const bf16* x = (const bf16*)p[0];
  float* gw = (float*)p[16];
  float* gb = (float*)p[17];
  float* h = (float*)p[18];
  bf16* xn = (bf16*)p[19];
  bf16* qkv = (bf16*)p[20];
  bf16* attn = (bf16*)p[21];
  bf16* act = (bf16*)p[22];
  const bf16* pe = (const bf16*)p[3];
  const float ln_eps = 1e-5f;
  const long mc = (long)M * C;

  // GroupNorm (eps from the caller) -> proj_in -> h (f32)
  MC_CHECK(group_norm_affine<bf16>(x, (const float*)p[1], (const float*)p[2],
                                   (float*)p[15], gw, gb, B * F, S, C, G, nch,
                                   eps, st));
  MC_CHECK(group_norm_apply<bf16>(x, gw, gb, xn, B * F, S, C, false, st));
  MC_CHECK(product(gemm_args(xn, p[4], p[5], h, 1, M, C, C), st));

  for (int i = 0; i < n_attn; ++i) {
    void* const* a = p + 24 + 5 * i;
    // LN -> +PE -> q, k, v as three (B, F, S, C) tensors
    MC_CHECK(layer_norm_rows<float>(h, (const float*)a[0], (const float*)a[1], pe,
                                    xn, M, C, S, F, ln_eps, st));
    GemmArgs q = gemm_args(xn, a[2], nullptr, qkv, 0, M, 3 * C, C);
    split_output(q, C);
    MC_CHECK(product(q, st));
    MC_CHECK(temporal_fwd(D, kF, qkv, qkv + mc, qkv + 2 * mc, attn, (float*)p[23], B,
                          S, H, 1.f / sqrtf((float)D), st));
    // out-proj + bo + h -> h (in place: each element is read, then written,
    // by the same thread)
    GemmArgs o = gemm_args(attn, a[3], a[4], h, 1, M, C, C);
    o.res = h;
    o.res_f32 = 1;
    MC_CHECK(product(o, st));
  }

  // LN -> GEGLU projection -> activation (M, 4C) bf16 -> FF out + bff2 + h
  MC_CHECK(layer_norm_rows<float>(h, (const float*)p[6], (const float*)p[7], nullptr,
                                  xn, M, C, S, F, ln_eps, st));
  GemmArgs f1 = gemm_args(xn, p[8], p[9], act, 0, M, 8 * C, C);
  f1.ldo = 4 * C;
  MC_CHECK((product<true>(f1, st)));
  GemmArgs f2 = gemm_args(act, p[10], p[11], h, 1, M, C, 4 * C);
  f2.res = h;
  f2.res_f32 = 1;
  MC_CHECK(product(f2, st));
  // proj_out(bf16(h)) + bout + x -> out
  MC_CHECK(group_norm_apply<float>(h, nullptr, nullptr, xn, B * F, S, C, false, st));
  GemmArgs y = gemm_args(xn, p[12], p[13], p[14], 0, M, C, C);
  y.res = x;
  return product(y, st);
}
