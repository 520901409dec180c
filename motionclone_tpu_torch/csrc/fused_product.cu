// The product of the fused spatial transformer and motion module alone
// (fused_product.cuh), for checking and timing it apart from the modules.
//
// mc_fused_product launches the TMA + wgmma product that kernels 5-7 run.
//
// ptrs:  0 a (M, K) bf16, 1 b (N, K) bf16, 2 bias (N) f32 or null, 3
//        residual (M, N) or null (may be the output), 4 out
// dims:  0 M, 1 N, 2 K, 3 residual is f32, 4 out is f32, 5 GEGLU (out
//        (M, N / 2)), 6 split width (0: one (M, N) output; else N / width
//        contiguous (M, width) chunks)

#include "fused_product.cuh"

extern "C" int mc_fused_product(void* const* p, const int* d, void* stream) {
  fz::GemmArgs g = fz::gemm_args(p[0], p[1], p[2], p[4], d[4], d[0], d[1], d[2]);
  g.res = p[3];
  g.res_f32 = d[3];
  if (d[5]) g.ldo = d[1] / 2;
  if (d[6]) fz::split_output(g, d[6]);
  cudaStream_t st = (cudaStream_t)stream;
  return d[5] ? fz::product<true>(g, st) : fz::product<false>(g, st);
}

// dynamic shared memory per block of the product, for a bf16 or f32 output
extern "C" int mc_fused_product_smem(int out_f32) {
  return out_f32 ? fz::tp::Smem<true>::BYTES : fz::tp::Smem<false>::BYTES;
}
