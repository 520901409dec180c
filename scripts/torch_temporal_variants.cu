// Design variants of the temporal attention kernels 3/3r and 4/4r
// (csrc/temporal_attention.cuh), timed by scripts/torch_temporal_variants.py.
// Built on the header's own kernel template, whose parameters are the
// variants:
//
//   TP     pixels per tile (1 shipped; 2 halves the tiles and doubles a
//          stage)
//   ST     stages of a warp's ring (2 shipped; 3 keeps two tiles in flight
//          per warp, with fewer warps per block)
//   PAD    bytes of padding per 320-byte row in shared memory (16 shipped:
//          conflict-free ldmatrix; 0: 4-way bank conflicts)
//   MODE   0 the kernel; 1 the ring's loads alone (no products, no
//          stores); 2 loads and stores without the products
//
// and a block-wide ring fed by a producer warp (BlockRing), with as many
// stages as shared memory holds and NC consumer warps.
//
// mc_tvar(v, bwd, FQ, ...) launches variant v of variant() at head dim 40
// (the 64x64 level) for the forward (bwd = 0, arguments as
// mc_temporal_fwd) or the backward (bwd = 1, as mc_temporal_bwd); -1 for
// another variant or shape.

#include "../motionclone_tpu_torch/csrc/temporal_attention.cuh"

namespace {

// A block-wide ring instead of one per warp: one producer warp keeps NS
// stages of the block's tiles (tile blockIdx.x + i·gridDim.x in stage i %
// NS) loading, and NC consumer warps take every NC-th of them; a consumer
// releases its stage once its stores have read it.  The stages in flight
// follow how long the consumers hold theirs, not a fixed one per warp.
template <int D, int FQ, bool BWD, int NC>
struct BlockRing {
  using P = ta::Plan<D, FQ, BWD>;
  static constexpr int NS = (ta::kMaxSmem - 64) / (P::STAGE + 16);
  static constexpr int SMEM = NS * (P::STAGE + 16);
};

template <int D, int FQ, bool BWD, int NC>
__global__ void __launch_bounds__((NC + 1) * 32, 1) block_ring_kernel(const ta::Args a) {
  using R = BlockRing<D, FQ, BWD, NC>;
  using P = typename R::P;
  constexpr int NS = R::NS;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + NS * P::STAGE);
  uint64_t* empty = full + NS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int n = (int)blockIdx.x < a.tiles ? (a.tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  if (warp == NC) {
    for (int i = 0; i < n; ++i) {
      const int s = i % NS;
      if (i >= NS) mbar_wait(&empty[s], (i / NS - 1) & 1);
      ta::load_tile<P, FQ>(a, ta::tile_of<D, 1>(a, blockIdx.x + i * gridDim.x),
                           smem + s * P::STAGE, &full[s], lane);
    }
    return;
  }
  for (int i = warp; i < n; i += NC) {
    const int s = i % NS;
    const ta::Tile t = ta::tile_of<D, 1>(a, blockIdx.x + i * gridDim.x);
    float l0[1][P::HS], l1[1][P::HS];
    if constexpr (BWD) ta::load_lse<P, 1, FQ>(a, t, l0, l1, lane >> 2);
    mbar_wait(&full[s], (i / NS) & 1);
    unsigned char* px = smem + s * P::STAGE;
    if constexpr (BWD) {
      ta::bwd_pixel<P, D, FQ>(px, a.scale, l0[0], l1[0], lane);
    } else {
      float* lse = a.lse + ((long)(t.b * a.S + t.s0) * a.H + t.h0) * FQ;
      ta::fwd_pixel<P, D, FQ>(px, t.nh, a.scale, lse, lane);
    }
    fence_async_smem();
    __syncwarp();
    ta::store_tile<P, FQ>(a, t, px, BWD ? FQ + 2 * kF : FQ, lane);
    ta::bulk_wait_read();
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }
  ta::bulk_wait();
}

template <int D, int FQ, bool BWD, int NC>
int launch_block_ring(ta::Args a, cudaStream_t st) {
  using R = BlockRing<D, FQ, BWD, NC>;
  a.C = a.H * D;
  a.ns = (a.H + R::P::HS - 1) / R::P::HS;
  a.sg = a.S;
  a.tiles = a.B * a.sg * a.ns;
  auto kernel = block_ring_kernel<D, FQ, BWD, NC>;
  const int r = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          R::SMEM);
  if (r) return r;
  const int sms = fz::tp::sm_count();
  kernel<<<a.tiles < sms ? a.tiles : sms, (NC + 1) * 32, R::SMEM, st>>>(a);
  return (int)cudaGetLastError();
}

template <int FQ, bool BWD>
int variant(int v, const ta::Args& a, cudaStream_t st) {
  switch (v) {
    case 0: return ta::launch<40, FQ, BWD, 1, 2, 16, 0>(a, st);  // shipped
    case 1: return ta::launch<40, FQ, BWD, 1, 2, 0, 0>(a, st);   // 320-byte pitch
    case 2: return ta::launch<40, FQ, BWD, 1, 3, 16, 0>(a, st);  // 3 stages
    case 3: return ta::launch<40, FQ, BWD, 2, 2, 16, 0>(a, st);  // 2 pixels a tile
    case 4: return ta::launch<40, FQ, BWD, 1, 2, 16, 1>(a, st);  // loads alone
    case 5: return ta::launch<40, FQ, BWD, 1, 2, 16, 2>(a, st);  // loads and stores
    case 6: return ta::launch<40, FQ, BWD, 1, 3, 16, 1>(a, st);  // loads alone, 3 stages
    case 7: return launch_block_ring<40, FQ, BWD, BWD ? 5 : 7>(a, st);  // block ring
    case 8: return launch_block_ring<40, FQ, BWD, BWD ? 8 : 11>(a, st);  // more consumers
    default: return -1;
  }
}

template <bool BWD>
int variant_fq(int v, int FQ, const ta::Args& a, cudaStream_t st) {
  switch (FQ) {
    case 16: return variant<16, BWD>(v, a, st);
    case 8: return variant<8, BWD>(v, a, st);
    default: return -1;
  }
}

}  // namespace

// p: q, k, v, dout (or null), o (out or dq), dk, dv (or null), lse
extern "C" int mc_tvar(int v, int bwd, int FQ, void* const* p, int B, int S, int H,
                       float scale, void* stream) {
  ta::Args a{};
  a.q = (const bf16*)p[0], a.k = (const bf16*)p[1], a.v = (const bf16*)p[2];
  a.dout = (const bf16*)p[3], a.o = (bf16*)p[4], a.dk = (bf16*)p[5], a.dv = (bf16*)p[6];
  a.lse = (float*)p[7];
  a.B = B, a.S = S, a.H = H, a.scale = scale;
  cudaStream_t st = (cudaStream_t)stream;
  return bwd ? variant_fq<true>(v, FQ, a, st) : variant_fq<false>(v, FQ, a, st);
}
