// Device code of the per-pixel temporal attention kernels, forward (3, 3r)
// and backward (4, 4r), for sm_90a; the design note is in
// temporal_attention.cu.  Included by temporal_attention.cu (the C entry
// points) and by fused_temporal.cu, whose motion module runs the same
// square forward.  Everything has internal linkage.
//
// The kernels are templated on the head dim D and the query frames FQ
// against kF = 16 key/value frames: FQ = 16 is the square form (kernels 3
// and 4), FQ in {8, 4, 2, 1} the rectangular one (3r and 4r), whose query
// rows are padded to the 16 rows of the tensor-core product.

#pragma once

#include "fused_product.cuh"  // bf16, pack_f32, mbarriers (wgmma.cuh), bulk copies

namespace {

constexpr int kF = 16;  // frames: the motion module's video length (K/V of every form)

namespace ta {

using fz::tp::bulk_commit;
using fz::tp::bulk_load;
using fz::tp::bulk_store;
using fz::tp::bulk_wait;
using fz::tp::bulk_wait_read;
using fz::tp::mbar_expect_tx;

constexpr int kW = 160;        // channels of a tile: 4 heads at D = 40, 2 at 80, 1 at 160
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may use

// One warp's ring: ST stages, each TP pixels of R rows (q, k, v and, in
// the backward, dO: FQ, 16, 16, FQ frames), a row being one (frame,
// pixel) run of the tile's kW channels at a pitch of PITCH bytes.  PAD =
// 16 makes the pitch 21 16-byte units, an odd number, so the 8 frame rows
// an ldmatrix reads fall on 8 different groups of 4 banks; PAD = 0 (a
// variant) leaves a pitch of 20 units and 4-way conflicts.  Blocks hold NW
// such warps, as many as shared memory allows up to 16, one block per SM.
template <int D, int FQ, bool BWD, int TP = 1, int ST = 2, int PAD = 16>
struct Plan {
  static constexpr int HS = kW / D;                       // heads per tile
  static constexpr int R = (BWD ? 2 * FQ : FQ) + 2 * kF;  // rows per pixel
  static constexpr int RUN = kW * 2;                      // bytes of a full row run
  static constexpr int PITCH = RUN + PAD;
  static constexpr int STAGE = TP * R * PITCH;
  static constexpr int WARP_BYTES = ST * (STAGE + 8);     // + one mbarrier per stage
  static constexpr int NW = kMaxSmem / WARP_BYTES > 16 ? 16 : kMaxSmem / WARP_BYTES;
  static constexpr int SMEM = NW * WARP_BYTES;
  static_assert(kW % D == 0 && PITCH % 16 == 0 && NW >= 1, "bad plan");
};

// The kernels' operands.  Forward: o = out, lse written; backward: o =
// dq, dk, dv written, lse read.  q and dout (and o, dq) are (B, FQ, S, C),
// k, v (and dk, dv) (B, 16, S, C) with C = H·D, lse (B, S, H, FQ) f32.
struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  bf16* o;
  bf16* dk;
  bf16* dv;
  float* lse;
  int B, S, H, C;
  int ns;     // tiles along the channels: ceil(H / heads per tile)
  int sg;     // pixel groups: ceil(S / TP)
  int tiles;  // B · sg · ns
  float scale;
};

// Tile t: batch b, pixels s0 .. s0 + npix - 1, heads h0 .. h0 + nh - 1 of
// the tile's channel slice (channels c0 = h0·D onwards).  Consecutive
// tiles take the consecutive slices of one pixel group.
struct Tile {
  int b, s0, npix, h0, nh, c0;
};

template <int D, int TP>
__device__ __forceinline__ Tile tile_of(const Args& a, int t) {
  constexpr int HS = kW / D;
  Tile x;
  const int slice = t % a.ns, u = t / a.ns;
  x.b = u / a.sg;
  x.s0 = (u - x.b * a.sg) * TP;
  x.npix = min(TP, a.S - x.s0);
  x.h0 = slice * HS;
  x.nh = min(HS, a.H - x.h0);
  x.c0 = x.h0 * D;
  return x;
}

// The global row run behind row r of a pixel's rows (q, k, v, dO) ...
template <int FQ>
__device__ __forceinline__ const bf16* src_row(const Args& a, const Tile& t, int r,
                                               int s) {
  const bf16* base;
  int f, nf;
  if (r < FQ) {
    base = a.q, f = r, nf = FQ;
  } else if (r < FQ + kF) {
    base = a.k, f = r - FQ, nf = kF;
  } else if (r < FQ + 2 * kF) {
    base = a.v, f = r - FQ - kF, nf = kF;
  } else {
    base = a.dout, f = r - FQ - 2 * kF, nf = FQ;
  }
  return base + ((long)(t.b * nf + f) * a.S + s) * a.C + t.c0;
}

// ... and the output's run that row r holds when the pixel is done
// (forward: rows 0..FQ-1 hold out; backward: rows 0..FQ-1 dq, then 16 of
// dk, 16 of dv)
template <int FQ>
__device__ __forceinline__ bf16* dst_row(const Args& a, const Tile& t, int r, int s) {
  bf16* base;
  int f, nf;
  if (r < FQ) {
    base = a.o, f = r, nf = FQ;
  } else if (r < FQ + kF) {
    base = a.dk, f = r - FQ, nf = kF;
  } else {
    base = a.dv, f = r - FQ - kF, nf = kF;
  }
  return base + ((long)(t.b * nf + f) * a.S + s) * a.C + t.c0;
}

// The warp's bulk loads of tile t into a stage: every row run of every
// pixel, the byte count announced on the stage's barrier first
template <class P, int FQ>
__device__ __forceinline__ void load_tile(const Args& a, const Tile& t,
                                          unsigned char* stage, uint64_t* bar,
                                          int lane) {
  const int run = t.nh * (kW / P::HS) * 2;  // nh heads of D channels
  if (lane == 0) mbar_expect_tx(bar, (uint32_t)(t.npix * P::R * run));
  __syncwarp();
  for (int i = lane; i < t.npix * P::R; i += 32) {
    const int p = i / P::R, r = i - p * P::R;
    bulk_load(stage + (p * P::R + r) * P::PITCH, src_row<FQ>(a, t, r, t.s0 + p), run, bar);
  }
}

// The warp's bulk stores of tile t's nrows output rows per pixel from its
// stage; each lane commits its own bulk group
template <class P, int FQ>
__device__ __forceinline__ void store_tile(const Args& a, const Tile& t,
                                           unsigned char* stage, int nrows, int lane) {
  const int run = t.nh * (kW / P::HS) * 2;
  for (int i = lane; i < t.npix * nrows; i += 32) {
    const int p = i / nrows, r = i - p * nrows;
    bulk_store(dst_row<FQ>(a, t, r, t.s0 + p), stage + (p * P::R + r) * P::PITCH, run);
  }
  bulk_commit();
}

// ---------------------------------------------------------------------------
// the 16 x 16 products on the tensor cores (mma.sync.m16n8k16, bf16 in,
// f32 accumulate), one (pixel, head) per warp at a time
// ---------------------------------------------------------------------------

// four 8 x 8 bf16 matrices from shared memory, as stored or transposed
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// d += a · b, a 16 x 16 (row-major fragments), b 16 x 8
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the transpose of an 8 x 8 bf16 matrix held one row pair per thread
__device__ __forceinline__ uint32_t movt(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// the A fragment of a 16 x 16 matrix held as two m16n8 accumulators
__device__ __forceinline__ void acc_to_frag(uint32_t (&a)[4], const float (&c)[2][4]) {
  a[0] = pack_f32(c[0][0], c[0][1]);
  a[1] = pack_f32(c[0][2], c[0][3]);
  a[2] = pack_f32(c[1][0], c[1][1]);
  a[3] = pack_f32(c[1][2], c[1][3]);
}

// the A fragment of the transpose of that matrix (movmatrix per 8 x 8 block)
__device__ __forceinline__ void frag_t(uint32_t (&t)[4], const uint32_t (&a)[4]) {
  t[0] = movt(a[0]);
  t[1] = movt(a[2]);
  t[2] = movt(a[1]);
  t[3] = movt(a[3]);
}

// rows g and g + 8 of an m16n8 accumulator, as bf16 pairs, into rows
// row0 + g and row0 + g + 8 (those below nrows) at column col
__device__ __forceinline__ void put_rows(unsigned char* px, int pitch, int row0, int nrows,
                                         int col, const float (&c)[4], int g) {
  if (g < nrows)
    *reinterpret_cast<uint32_t*>(px + (row0 + g) * pitch + col * 2) = pack_f32(c[0], c[1]);
  if (g + 8 < nrows)
    *reinterpret_cast<uint32_t*>(px + (row0 + g + 8) * pitch + col * 2) = pack_f32(c[2], c[3]);
}

// Shared addresses of a lane's ldmatrix rows in a pixel's rows.  Pattern
// A (also a transposed B): matrices (rows 0-7, cols 0-7), (8-15, 0-7),
// (0-7, 8-15), (8-15, 8-15); pattern B (an untransposed B, rows being
// the product's n): (0-7, 0-7), (0-7, 8-15), (8-15, 0-7), (8-15, 8-15).
// Query-side rows past FQ read row FQ - 1: finite values whose products
// are discarded or multiplied by zeros.
template <int FQ, int PITCH>
struct Lanes {
  uint32_t q, k_b, v_b, k_t, v_t, o;  // q: A and transposed B; o: dO, the same
  __device__ __forceinline__ Lanes(const unsigned char* px, int lane) {
    const uint32_t base = (uint32_t)__cvta_generic_to_shared(px);
    const int ra = (lane & 7) + ((lane >> 3) & 1) * 8, ca = (lane >> 4) * 8;
    const int rb = (lane & 7) + (lane >> 4) * 8, cb = ((lane >> 3) & 1) * 8;
    const int rq = ra < FQ ? ra : FQ - 1;
    q = base + rq * PITCH + ca * 2;
    o = base + (FQ + 2 * kF + rq) * PITCH + ca * 2;
    k_b = base + (FQ + rb) * PITCH + cb * 2;
    v_b = base + (FQ + kF + rb) * PITCH + cb * 2;
    k_t = base + (FQ + ra) * PITCH + ca * 2;
    v_t = base + (FQ + kF + ra) * PITCH + ca * 2;
  }
};

// s = A · Bᵀ over the D channels from c0 (16-row A from pattern-A lanes at
// a, 16-row B from pattern-B lanes at b); D = 40's last step takes 8
// channels, the other half of its fragments zeroed in registers
template <int D>
__device__ __forceinline__ void scores(float (&s)[2][4], uint32_t a, uint32_t b, int c0) {
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
  constexpr int KS = (D + 15) / 16;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    uint32_t fa[4], fb[4];
    ldsm4(fa, a + (c0 + 16 * ks) * 2);
    ldsm4(fb, b + (c0 + 16 * ks) * 2);
    if (D % 16 != 0 && ks == KS - 1) fa[2] = fa[3] = fb[1] = fb[3] = 0u;
    mma16816(s[0], fa, fb[0], fb[1]);
    mma16816(s[1], fa, fb[2], fb[3]);
  }
}

// The forward of one pixel: for each head of the tile, S = Q Kᵀ, an exact
// softmax in f32, lse written (for the nh heads the tile holds), P rounded
// to bf16; then, once every lane has read its q columns, O = P V written
// over them.  All heads' scores come first, so that their dependent chains
// overlap; a last slice's missing heads compute on whatever their columns
// hold and are neither written to lse nor stored.
template <class P, int D, int FQ>
__device__ __forceinline__ void fwd_pixel(unsigned char* px, int nh, float scale,
                                          float* lse, int lane) {
  constexpr int NT = D / 8;  // n8 tiles of the output
  const Lanes<FQ, P::PITCH> L(px, lane);
  const int g = lane >> 2, qd = lane & 3;
  uint32_t pa[P::HS][4];
#pragma unroll
  for (int h = 0; h < P::HS; ++h) {
    float s[2][4];
    scores<D>(s, L.q, L.k_b, h * D);
    float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] *= scale;
      m0 = fmaxf(m0, fmaxf(s[n][0], s[n][1]));
      m1 = fmaxf(m1, fmaxf(s[n][2], s[n][3]));
    }
    m0 = quad_max(m0);
    m1 = quad_max(m1);
    float l0 = 0.f, l1 = 0.f;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      s[n][0] = __expf(s[n][0] - m0);
      s[n][1] = __expf(s[n][1] - m0);
      s[n][2] = __expf(s[n][2] - m1);
      s[n][3] = __expf(s[n][3] - m1);
      l0 += s[n][0] + s[n][1];
      l1 += s[n][2] + s[n][3];
    }
    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
    const float i0 = 1.f / l0, i1 = 1.f / l1;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      s[n][0] *= i0;
      s[n][1] *= i0;
      s[n][2] *= i1;
      s[n][3] *= i1;
    }
    if (qd == 0 && h < nh) {
      if (g < FQ) lse[h * FQ + g] = m0 + __logf(l0);
      if (g + 8 < FQ) lse[h * FQ + g + 8] = m1 + __logf(l1);
    }
    acc_to_frag(pa[h], s);
  }
  __syncwarp();  // every lane has read the tile's q columns
#pragma unroll
  for (int h = 0; h < P::HS; ++h) {
#pragma unroll
    for (int c = 0; c < (NT + 1) / 2; ++c) {
      const int col = h * D + 16 * c;
      uint32_t fv[4];
      ldsm4t(fv, L.v_t + col * 2);
      float o[2][4] = {};
      mma16816(o[0], pa[h], fv[0], fv[1]);
      put_rows(px, P::PITCH, 0, FQ, col + 2 * qd, o[0], g);
      if (2 * c + 1 < NT) {
        mma16816(o[1], pa[h], fv[2], fv[3]);
        put_rows(px, P::PITCH, 0, FQ, col + 8 + 2 * qd, o[1], g);
      }
    }
  }
}

// The backward of one pixel: for each head, S and dP = dO Vᵀ, P =
// exp(S·scale - lse), delta = rowsum(P∘dP), dS = P∘(dP - delta)·scale in
// f32 (query rows past FQ zero), then per 16 channels dQ = dS K, dK =
// dSᵀ Q, dV = Pᵀ dO (dS and P rounded to bf16; the transposes by
// movmatrix), each written over the head's columns of q, k and v once
// every lane has read them.  lse0/lse1: the lse of rows g and g + 8.  As
// in the forward, a last slice's missing heads compute on whatever their
// columns hold, and their outputs are not stored.
template <class P, int D, int FQ>
__device__ __forceinline__ void bwd_pixel(unsigned char* px, float scale,
                                          const float (&lse0)[P::HS],
                                          const float (&lse1)[P::HS], int lane) {
  constexpr int NT = D / 8;
  const Lanes<FQ, P::PITCH> L(px, lane);
  const int g = lane >> 2, qd = lane & 3;
  const bool r0 = g < FQ, r1 = g + 8 < FQ;
#pragma unroll
  for (int h = 0; h < P::HS; ++h) {
    const int c0 = h * D;
    float s[2][4], dp[2][4];
    scores<D>(s, L.q, L.k_b, c0);
    scores<D>(dp, L.o, L.v_b, c0);
    float d0 = 0.f, d1 = 0.f;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      s[n][0] = r0 ? __expf(s[n][0] * scale - lse0[h]) : 0.f;
      s[n][1] = r0 ? __expf(s[n][1] * scale - lse0[h]) : 0.f;
      s[n][2] = r1 ? __expf(s[n][2] * scale - lse1[h]) : 0.f;
      s[n][3] = r1 ? __expf(s[n][3] * scale - lse1[h]) : 0.f;
      d0 += s[n][0] * dp[n][0] + s[n][1] * dp[n][1];
      d1 += s[n][2] * dp[n][2] + s[n][3] * dp[n][3];
    }
    d0 = quad_sum(d0);
    d1 = quad_sum(d1);
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      dp[n][0] = s[n][0] * (dp[n][0] - d0) * scale;
      dp[n][1] = s[n][1] * (dp[n][1] - d0) * scale;
      dp[n][2] = s[n][2] * (dp[n][2] - d1) * scale;
      dp[n][3] = s[n][3] * (dp[n][3] - d1) * scale;
    }
    uint32_t pa[4], pt[4], da[4], dt[4];
    acc_to_frag(pa, s);
    acc_to_frag(da, dp);
    frag_t(pt, pa);
    frag_t(dt, da);
#pragma unroll
    for (int c = 0; c < (NT + 1) / 2; ++c) {
      const int col = c0 + 16 * c;
      uint32_t fk[4], fq[4], fo[4];
      ldsm4t(fk, L.k_t + col * 2);
      ldsm4t(fq, L.q + col * 2);
      ldsm4t(fo, L.o + col * 2);
      float dq[2][4] = {}, dk[2][4] = {}, dv[2][4] = {};
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        if (2 * c + n < NT) {
          mma16816(dq[n], da, fk[2 * n], fk[2 * n + 1]);
          mma16816(dk[n], dt, fq[2 * n], fq[2 * n + 1]);
          mma16816(dv[n], pt, fo[2 * n], fo[2 * n + 1]);
        }
      }
      __syncwarp();  // every lane has read these columns of q, k and dO
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        if (2 * c + n < NT) {
          const int cc = col + 8 * n + 2 * qd;
          put_rows(px, P::PITCH, 0, FQ, cc, dq[n], g);
          put_rows(px, P::PITCH, FQ, kF, cc, dk[n], g);
          put_rows(px, P::PITCH, FQ + kF, kF, cc, dv[n], g);
        }
      }
    }
  }
}

// The lse a lane needs for a tile (rows g and g + 8 of each head of each
// pixel); zeros past the tile
template <class P, int TP, int FQ>
__device__ __forceinline__ void load_lse(const Args& a, const Tile& t, float (&l0)[TP][P::HS],
                                         float (&l1)[TP][P::HS], int g) {
#pragma unroll
  for (int p = 0; p < TP; ++p)
#pragma unroll
    for (int h = 0; h < P::HS; ++h) {
      const bool ok = p < t.npix && h < t.nh;
      const float* row = a.lse + ((long)(t.b * a.S + t.s0 + p) * a.H + t.h0 + h) * FQ;
      l0[p][h] = ok && g < FQ ? row[g] : 0.f;
      l1[p][h] = ok && g + 8 < FQ ? row[g + 8] : 0.f;
    }
}

// One kernel for both directions.  Each warp walks its own tiles (tile
// blockIdx.x·NW + warp, then every gridDim.x·NW-th) through its own ring
// of ST stages: the loads of tile i + ST - 1 go out before the warp waits
// for tile i, so they overlap tile i's products and its stores, and a
// stage is refilled once the bulk stores out of it have read it.  No
// block-wide barrier: the warps share only the SM.  MODE (the variants
// script's): 0 the kernel; 1 the loads alone (the ring is waited on, no
// products, no stores); 2 loads and stores without the products.
template <int D, int FQ, bool BWD, int TP, int ST, int PAD, int MODE>
__global__ void __launch_bounds__(Plan<D, FQ, BWD, TP, ST, PAD>::NW * 32, 1)
    temporal_kernel(const Args a) {
  using P = Plan<D, FQ, BWD, TP, ST, PAD>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned char* ring = smem + warp * ST * P::STAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + P::NW * ST * P::STAGE) + warp * ST;
  if (lane == 0) {
    for (int s = 0; s < ST; ++s) mbar_init(&full[s], 1);
    mbar_init_fence();
  }
  __syncwarp();

  const int stride = gridDim.x * P::NW, first = blockIdx.x * P::NW + warp;
  const int n_it = first < a.tiles ? (a.tiles - 1 - first) / stride + 1 : 0;
  for (int j = 0; j < ST - 1 && j < n_it; ++j)
    load_tile<P, FQ>(a, tile_of<D, TP>(a, first + j * stride), ring + j * P::STAGE, &full[j],
                     lane);
  float l0[TP][P::HS], l1[TP][P::HS], n0[TP][P::HS], n1[TP][P::HS];
  if constexpr (BWD && MODE == 0) {
    if (n_it > 0) load_lse<P, TP, FQ>(a, tile_of<D, TP>(a, first), l0, l1, lane >> 2);
  }
  for (int it = 0; it < n_it; ++it) {
    const int ahead = it + ST - 1;
    if (ahead < n_it) {
      // the stage's previous tile has been read out by its bulk stores
      bulk_wait_read();
      __syncwarp();
      load_tile<P, FQ>(a, tile_of<D, TP>(a, first + ahead * stride),
                       ring + (ahead % ST) * P::STAGE, &full[ahead % ST], lane);
    }
    const Tile t = tile_of<D, TP>(a, first + it * stride);
    if constexpr (BWD && MODE == 0) {
      if (it + 1 < n_it)
        load_lse<P, TP, FQ>(a, tile_of<D, TP>(a, first + (it + 1) * stride), n0, n1,
                            lane >> 2);
    }
    unsigned char* stage = ring + (it % ST) * P::STAGE;
    mbar_wait(&full[it % ST], (it / ST) & 1);
    if constexpr (MODE == 0) {
#pragma unroll
      for (int p = 0; p < TP; ++p) {
        if (p >= t.npix) break;
        unsigned char* px = stage + p * P::R * P::PITCH;
        if constexpr (BWD) {
          bwd_pixel<P, D, FQ>(px, a.scale, l0[p], l1[p], lane);
        } else {
          float* lse = a.lse + ((long)(t.b * a.S + t.s0 + p) * a.H + t.h0) * FQ;
          fwd_pixel<P, D, FQ>(px, t.nh, a.scale, lse, lane);
        }
      }
    }
    if constexpr (MODE != 1) {
      // the outputs' generic writes become visible to the bulk copies
      fence_async_smem();
      __syncwarp();
      store_tile<P, FQ>(a, t, stage, BWD ? FQ + 2 * kF : FQ, lane);
    }
    if constexpr (BWD && MODE == 0) {
#pragma unroll
      for (int p = 0; p < TP; ++p)
#pragma unroll
        for (int h = 0; h < P::HS; ++h) {
          l0[p][h] = n0[p][h];
          l1[p][h] = n1[p][h];
        }
    }
  }
  bulk_wait();
}

// Launch direction BWD for head dim D and FQ query frames over a's tensors.
template <int D, int FQ, bool BWD, int TP = 1, int ST = 2, int PAD = 16, int MODE = 0>
int launch(Args a, cudaStream_t st) {
  using P = Plan<D, FQ, BWD, TP, ST, PAD>;
  a.C = a.H * D;
  a.ns = (a.H + P::HS - 1) / P::HS;
  a.sg = (a.S + TP - 1) / TP;
  a.tiles = a.B * a.sg * a.ns;
  if (a.tiles == 0) return 0;
  auto kernel = temporal_kernel<D, FQ, BWD, TP, ST, PAD, MODE>;
  const int r = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          P::SMEM);
  if (r) return r;
  const int want = (a.tiles + P::NW - 1) / P::NW, sms = fz::tp::sm_count();
  kernel<<<want < sms ? want : sms, P::NW * 32, P::SMEM, st>>>(a);
  return (int)cudaGetLastError();
}

template <int FQ, bool BWD>
int launch_d(int D, const Args& a, cudaStream_t st) {
  switch (D) {
    case 40: return launch<40, FQ, BWD>(a, st);
    case 80: return launch<80, FQ, BWD>(a, st);
    case 160: return launch<160, FQ, BWD>(a, st);
    default: return -1;
  }
}

// Direction BWD for head dim D (40, 80 or 160) and FQ query frames (16,
// the square form, or 8, 4, 2, 1); -1 for a shape with no kernel.
template <bool BWD>
int launch_fq(int D, int FQ, const Args& a, cudaStream_t st) {
  switch (FQ) {
    case kF: return launch_d<kF, BWD>(D, a, st);
    case 8: return launch_d<8, BWD>(D, a, st);
    case 4: return launch_d<4, BWD>(D, a, st);
    case 2: return launch_d<2, BWD>(D, a, st);
    case 1: return launch_d<1, BWD>(D, a, st);
    default: return -1;
  }
}

}  // namespace ta

// The forward for head dim D (40, 80 or 160) and FQ query frames (16, the
// square form, or 8, 4, 2, 1) against kF key/value frames over q (B, FQ,
// S, H*D), k, v (B, kF, S, H*D); o like q, lse (B, S, H, FQ) f32.  -1 for
// a shape with no kernel.
inline int temporal_fwd(int D, int FQ, const bf16* q, const bf16* k, const bf16* v,
                        bf16* o, float* lse, int B, int S, int H, float scale,
                        cudaStream_t st) {
  ta::Args a{};
  a.q = q, a.k = k, a.v = v, a.o = o, a.lse = lse;
  a.B = B, a.S = S, a.H = H, a.scale = scale;
  return ta::launch_fq<false>(D, FQ, a, st);
}

}  // namespace
