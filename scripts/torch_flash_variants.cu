// Design experiments for the flash forward (kernel 1) on the H100: the
// variants that the shipped kernel was chosen from, and a check of wgmma's
// shared-memory descriptor layout.  Built and timed by
// scripts/torch_flash_variants.py; nothing of the port calls this file.
//
// xfwd<D, BN, PIPE, MODE, SKIPPV, MINB, NWG>: NWG warpgroups of 64 query
// rows share K/V tiles of BN keys; MINB blocks per SM.
//   PIPE 0  S_{j+1} issued before the softmax of tile j; P V waited at once;
//           a ring of three stages, one block barrier per tile.
//   PIPE 1  S_j and P_{j-1} V_{j-1} issued together, the softmax of S_j
//           under both; four stages, one block barrier per tile.
//   PIPE 2  as 1, but the ring is tracked by full/empty mbarriers, so the
//           warpgroups run out of step (the shipped design); without MODE
//           bit 32 the warpgroups also take turns issuing their products
//           (named barriers, FlashAttention-3's ping-pong).
// MODE bits: 1 no exponentials (x * 0.01 in place of 2^x: the time without
// the special-function unit), 2 copy offsets computed once per thread,
// 4 no proxy fence, 8 tree row maximum, 16 Q held in registers (QK^T as a
// register-A wgmma), 32 no ping-pong.  SKIPPV drops P V.

#include "../motionclone_tpu_torch/csrc/flash_attention.cuh"

// The descriptor layout (wgmma.cuh): one product with both operands K-major
// in shared memory, and one with A in registers and B MN-major, against the
// same products on the card (a wrong leading/stride pair gives wrong sums
// or an illegal address).
//
// A (64 x 16) row-major, B (64 x 16) row-major (n, k): C = A B^T (64 x 64)
__global__ void ss_kernel(const bf16* A, const bf16* B, float* C, int lbo, int sbo) {
  __shared__ __align__(128) unsigned char sa[64 * 32];
  __shared__ __align__(128) unsigned char sb[64 * 32];
  int tid = threadIdx.x;
  for (int i = tid; i < 64 * 16; i += 128) {
    int r = i / 16, c = i % 16;
    *reinterpret_cast<bf16*>(sa + tile_off<16>(r, c)) = A[i];
    *reinterpret_cast<bf16*>(sb + tile_off<16>(r, c)) = B[i];
  }
  fence_async_smem();
  __syncthreads();
  float d[32];
  wg_fence();
  wgmma_ss<64>(d, wg_desc(sa, lbo, sbo), wg_desc(sb, lbo, sbo), 0);
  wg_commit();
  wg_wait<0>();
  wg_keep(d);
  int lane = tid & 31, row = (tid >> 5) * 16 + (lane >> 2), t = lane & 3;
  for (int i = 0; i < 32; ++i) {
    int r = row + ((i >> 1) & 1) * 8, c = (i >> 2) * 8 + 2 * t + (i & 1);
    C[r * 64 + c] = d[i];
  }
}

// A (64 x 16) row-major in registers, V (16 x 40) row-major (k, n) in a
// DP = 48 tile: C = A V (64 x 40)
__global__ void rs_kernel(const bf16* A, const bf16* V, float* C, int lbo, int sbo) {
  __shared__ __align__(128) unsigned char sv[16 * 96];
  int tid = threadIdx.x;
  for (int i = tid; i < 16 * 40; i += 128) {
    int r = i / 40, c = i % 40;
    *reinterpret_cast<bf16*>(sv + tile_off<48>(r, c)) = V[i];
  }
  fence_async_smem();
  __syncthreads();
  int lane = tid & 31, row = (tid >> 5) * 16 + (lane >> 2), t = lane & 3;
  float f[8];
  for (int i = 0; i < 8; ++i) {
    int r = row + ((i >> 1) & 1) * 8, c = (i >> 2) * 8 + 2 * t + (i & 1);
    f[i] = __bfloat162float(A[r * 16 + c]);
  }
  uint32_t a[1][4];
  fa::acc_to_a<8>(a, f);
  float d[20];
  for (int i = 0; i < 20; ++i) d[i] = 0.f;
  wg_fence();
  wgmma_rs<40>(d, a[0], wg_desc(sv, lbo, sbo), 1);
  wg_commit();
  wg_wait<0>();
  wg_keep(d);
  for (int i = 0; i < 20; ++i) {
    int r = row + ((i >> 1) & 1) * 8, c = (i >> 2) * 8 + 2 * t + (i & 1);
    C[r * 40 + c] = d[i];
  }
}

extern "C" int probe_ss(const void* A, const void* B, void* C, int lbo, int sbo) {
  ss_kernel<<<1, 128>>>((const bf16*)A, (const bf16*)B, (float*)C, lbo, sbo);
  return (int)cudaDeviceSynchronize();
}
extern "C" int probe_rs(const void* A, const void* V, void* C, int lbo, int sbo) {
  rs_kernel<<<1, 128>>>((const bf16*)A, (const bf16*)V, (float*)C, lbo, sbo);
  return (int)cudaDeviceSynchronize();
}

namespace {
// the copy of the first experiments: offsets worked out for every tile
template <int D, int DP, int ROWS, int NT>
__device__ __forceinline__ void load_tile(unsigned char* sm, const __nv_bfloat16* g,
                                          long gstride, int nvalid, int tid) {
  TileCopy<D, DP, ROWS, NT>(tid, (int)gstride)(sm, g, nvalid);
}
// m64nNk16 with A in registers and B K-major (Q K^T with Q held in registers)
template <int N>
__device__ void wgmma_rk(float (&d)[N / 2], const uint32_t a[4], uint64_t db, int acc);

template <>
__device__ __forceinline__ void wgmma_rk<64>(float (&d)[32], const uint32_t a[4],
                                            uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rk<96>(float (&d)[48], const uint32_t a[4],
                                            uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, {%48, %49, %50, %51}, %52, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rk<128>(float (&d)[64], const uint32_t a[4],
                                            uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_ss<96>(float (&d)[48], uint64_t da, uint64_t db,
                                            int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, %48, %49, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(acc));
}

namespace fa {

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}
template <int MODE>
__device__ __forceinline__ float ex2m(float x) { return (MODE & 1) ? x * 0.01f : ex2(x); }

// The experimental forward (see the head of this file).
template <int D, int BN, int PIPE, int MODE, int SKIPPV, int MINB, int NWG>
__global__ void __launch_bounds__(128 * NWG, MINB)
    xfwd(const bf16* __restrict__ q, const bf16* __restrict__ k,
         const bf16* __restrict__ v, bf16* __restrict__ o,
         float* __restrict__ lse, int H, int Sq, int Sk, float scale, int kv_div) {
  using G = Geo<D>;
  constexpr int kThreads = 128 * NWG, kRows = 64 * NWG;
  constexpr int ST = PIPE ? 4 : 3;
  constexpr int DP = G::DP, TB = BN * G::TILE;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* sQ = smem;
  unsigned char* sKV = smem + kRows * G::TILE;
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31, t = lane & 3;
  const int row0 = wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
  const int b = blockIdx.z, h = blockIdx.y, m0 = blockIdx.x * kRows;
  const long HD = (long)H * D;
  const float sl2 = scale * kLog2e;
  const bf16* kb = k + (long)(b / kv_div) * Sk * HD + h * D;
  const bf16* vb = v + (long)(b / kv_div) * Sk * HD + h * D;
  const int ntiles = (Sk + BN - 1) / BN;
  zero_pad<D, DP, kRows, kThreads>(sQ, tid);
  zero_pad<D, DP, 2 * ST * BN, kThreads>(sKV, tid);
  constexpr int CH = D / 8, NC = (BN * CH + kThreads - 1) / kThreads;
  int so[NC], go[NC], ro[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int i = tid + c * kThreads;
    const int rg = i / (8 * CH), rem = i - rg * 8 * CH;
    const int cc = rem >> 3, r = rg * 8 + (rem & 7);
    so[c] = rg * (DP * 16) + cc * 128 + (r & 7) * 16;
    go[c] = r * (int)HD + cc * 8;
    ro[c] = i < BN * CH ? r : 1 << 30;
  }
  auto load_kv = [&](int j) {
    unsigned char* s = sKV + (j % ST) * 2 * TB;
    if (MODE & 2) {
      const bf16* kj = kb + (long)j * BN * HD;
      const bf16* vj = vb + (long)j * BN * HD;
      const int kval = Sk - j * BN;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        if (ro[c] >= BN) continue;
        const bool ok = ro[c] < kval;
        cp16(s + so[c], ok ? kj + go[c] : kb, ok);
        cp16(s + TB + so[c], ok ? vj + go[c] : vb, ok);
      }
    } else {
      load_tile<D, DP, BN, kThreads>(s, kb + (long)j * BN * HD, HD, Sk - j * BN, tid);
      load_tile<D, DP, BN, kThreads>(s + TB, vb + (long)j * BN * HD, HD, Sk - j * BN, tid);
    }
  };
  load_tile<D, DP, kRows, kThreads>(sQ, q + ((long)b * Sq + m0) * HD + h * D, HD, Sq - m0, tid);
  const uint64_t dQ = desc_kmajor<DP>(sQ + wg * 64 * G::TILE);
  uint32_t qa[G::KS][4];
  auto load_qa = [&]() {
#pragma unroll
    for (int kk = 0; kk < G::KS; ++kk) {
      qa[kk][0] = *reinterpret_cast<const uint32_t*>(sQ + tile_off<DP>(row0, 16 * kk + 2 * t));
      qa[kk][1] = *reinterpret_cast<const uint32_t*>(sQ + tile_off<DP>(row0 + 8, 16 * kk + 2 * t));
      qa[kk][2] = *reinterpret_cast<const uint32_t*>(sQ + tile_off<DP>(row0, 16 * kk + 8 + 2 * t));
      qa[kk][3] = *reinterpret_cast<const uint32_t*>(sQ + tile_off<DP>(row0 + 8, 16 * kk + 8 + 2 * t));
    }
  };
  auto qk = [&](float(&d)[BN / 2], int j) {
    const uint64_t dK = desc_kmajor<DP>(sKV + (j % ST) * 2 * TB);
    if (MODE & 16) {
#pragma unroll
      for (int kk = 0; kk < G::KS; ++kk) wgmma_rk<BN>(d, qa[kk], dK + kk * 16, kk);
    } else {
#pragma unroll
      for (int kk = 0; kk < G::KS; ++kk) wgmma_ss<BN>(d, dQ + kk * 16, dK + kk * 16, kk);
    }
  };
  float s[BN / 2], acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};
  uint32_t pa[BN / 16][4];
  auto pv = [&](int j) {
    if (SKIPPV) return;
    const uint64_t dV = desc_mnmajor<DP>(sKV + (j % ST) * 2 * TB + TB);
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) wgmma_rs<D>(acc, pa[kk], dV + kk * G::KSTEP, 1);
  };
  // softmax of tile j in s; returns corr
  auto softmax = [&](int j, float corr[2], float ps[2]) {
    const int kval = Sk - j * BN;
    if (kval < BN) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i)
        if ((i >> 2) * 8 + 2 * t + (i & 1) >= kval) s[i] = -INFINITY;
    }
    float mx[2] = {m_run[0], m_run[1]};
    if (MODE & 8) {
      float m4[2][4];
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) m4[r][c] = s[(c << 2) + 2 * r];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) if (i >= 16 || (i & 1)) {
        const int r = (i >> 1) & 1, c = (i >> 2) & 3;
        m4[r][c] = fmaxf(m4[r][c], s[i]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) mx[r] = fmaxf(fmaxf(mx[r], fmaxf(m4[r][0], m4[r][1])), fmaxf(m4[r][2], m4[r][3]));
    } else {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    }
    float mb[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = ex2((m_run[r] - mx[r]) * sl2);
      m_run[r] = mx[r];
      mb[r] = mx[r] * sl2;
      ps[r] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      s[i] = ex2m<MODE>(fmaf(s[i], sl2, -mb[(i >> 1) & 1]));
      ps[(i >> 1) & 1] += s[i];
    }
  };
  if (PIPE == 0) {
    load_kv(0); cp_commit();
    if (ntiles > 1) load_kv(1);
    cp_commit();
    cp_wait<1>(); fence_async_smem(); __syncthreads();
    wg_fence(); qk(s, 0); wg_commit(); wg_wait<0>(); wg_keep(s);
    for (int j = 0; j < ntiles; ++j) {
      cp_wait<0>(); fence_async_smem(); __syncthreads();
      if (j + 2 < ntiles) load_kv(j + 2);
      cp_commit();
      const bool more = j + 1 < ntiles;
      float sn[BN / 2];
      if (more) { wg_fence(); qk(sn, j + 1); wg_commit(); }
      float corr[2], ps[2];
      softmax(j, corr, ps);
#pragma unroll
      for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * corr[r] + ps[r];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
      acc_to_a<BN / 2>(pa, s);
      wg_fence(); pv(j); wg_commit(); wg_wait<0>(); wg_keep(acc); keep_u32(pa);
      if (more) {
        wg_keep(sn);
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) s[i] = sn[i];
      }
    }
  } else if (PIPE == 1) {
    load_kv(0); cp_commit();
    if (ntiles > 1) load_kv(1);
    cp_commit();
    if (ntiles > 2) load_kv(2);
    cp_commit();
    cp_wait<2>(); fence_async_smem(); __syncthreads();
    if (MODE & 16) load_qa();
    wg_fence(); qk(s, 0); wg_commit(); wg_wait<0>(); wg_keep(s);
    {
      float corr[2], ps[2];
      softmax(0, corr, ps);
      l_run[0] = ps[0]; l_run[1] = ps[1];
      acc_to_a<BN / 2>(pa, s);
    }
    for (int j = 1; j < ntiles; ++j) {
      cp_wait<1>(); if (!(MODE & 4)) fence_async_smem(); __syncthreads();
      if (j + 2 < ntiles) load_kv(j + 2);
      cp_commit();
      wg_fence();
      qk(s, j); wg_commit();
      pv(j - 1); wg_commit();
      wg_wait<1>(); wg_keep(s);
      float corr[2], ps[2];
      softmax(j, corr, ps);
      wg_wait<0>(); wg_keep(acc); keep_u32(pa);
#pragma unroll
      for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * corr[r] + ps[r];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
      acc_to_a<BN / 2>(pa, s);
    }
    wg_fence(); pv(ntiles - 1); wg_commit(); wg_wait<0>(); wg_keep(acc); keep_u32(pa);
  }
  if (PIPE == 2) {
    // warpgroups decoupled: full/empty mbarriers per stage, GEMM issue in turns
    uint64_t* full = reinterpret_cast<uint64_t*>(sKV + ST * 2 * TB);
    uint64_t* empty = full + ST;
    if (tid == 0) {
      for (int i = 0; i < ST; ++i) { mbar_init(full + i, kThreads); mbar_init(empty + i, kThreads); }
      mbar_init_fence();
    }
    __syncthreads();
    auto issue = [&](int j) {  // this thread's share of tile j
      if (j >= ntiles) return;
      const int st = j % ST;
      if (j >= ST) mbar_wait(empty + st, ((j / ST) - 1) & 1);
      load_kv(j);
      cp_arrive(full + st);
    };
    auto ready = [&](int j) {
      mbar_wait(full + (j % ST), (j / ST) & 1);
      fence_async_smem();
    };
    auto release = [&](int j) { mbar_arrive(empty + (j % ST)); };
    issue(0); issue(1); issue(2);
    cp_commit();
    cp_wait<0>();   // Q (plain cp.async group)
    fence_async_smem();
    __syncthreads();
    if (wg == 1 && !(MODE & 32)) bar_arrive(1);
    ready(0);
    if (!(MODE & 32)) bar_sync(1 + wg);
    wg_fence(); qk(s, 0); wg_commit();
    if (!(MODE & 32)) bar_arrive(2 - wg);
    wg_wait<0>(); wg_keep(s);
    {
      float corr[2], ps[2];
      softmax(0, corr, ps);
      l_run[0] = ps[0]; l_run[1] = ps[1];
      acc_to_a<BN / 2>(pa, s);
    }
    for (int j = 1; j < ntiles; ++j) {
      issue(j + 2);
      ready(j);
      if (!(MODE & 32)) bar_sync(1 + wg);
      wg_fence();
      qk(s, j); wg_commit();
      pv(j - 1); wg_commit();
      if (!(MODE & 32)) bar_arrive(2 - wg);
      wg_wait<1>(); wg_keep(s);
      float corr[2], ps[2];
      softmax(j, corr, ps);
      wg_wait<0>(); wg_keep(acc); keep_u32(pa);
      release(j - 1);
#pragma unroll
      for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * corr[r] + ps[r];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
      acc_to_a<BN / 2>(pa, s);
    }
    if (!(MODE & 32)) bar_sync(1 + wg);
    wg_fence(); pv(ntiles - 1); wg_commit();
    if (wg == 0 && !(MODE & 32)) bar_arrive(2);  // warpgroup 1's last turn is passed to no one
    wg_wait<0>(); wg_keep(acc); keep_u32(pa);
  }
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    inv[r] = 1.f / l_run[r];
  }
  store_rows<D>(o + (long)b * Sq * HD + h * D, HD, m0 + row0, Sq, acc, inv, t);
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = m0 + row0 + r * 8;
      if (row < Sq) lse[((long)b * H + h) * Sq + row] = (m_run[r] * sl2 + log2f(l_run[r])) * kLn2;
    }
  }
}
}  // namespace fa
}  // namespace

template <int D, int BN, int PIPE, int MODE, int SKIPPV, int MINB, int NWG = 2>
int xlaunch(const void* q, const void* k, const void* v, void* o, void* lse, int B, int H,
            int Sq, int Sk, float scale) {
  constexpr int ST = PIPE ? 4 : 3;
  const size_t smem = (size_t)(64 * NWG + ST * 2 * BN) * fa::Geo<D>::TILE + 2 * ST * 8;
  auto kern = fa::xfwd<D, BN, PIPE, MODE, SKIPPV, MINB, NWG>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  dim3 grid((Sq + 64 * NWG - 1) / (64 * NWG), H, B);
  kern<<<grid, 128 * NWG, smem>>>((const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o,
                                    (float*)lse, H, Sq, Sk, scale, 1);
  return (int)cudaGetLastError();
}

#define X(name, ...)                                                                      \
  extern "C" int name(const void* q, const void* k, const void* v, void* o, void* lse,    \
                      int B, int H, int Sq, int Sk, float scale) {                         \
    return xlaunch<__VA_ARGS__>(q, k, v, o, lse, B, H, Sq, Sk, scale);                     \
  }
X(x_base128, 40, 128, 0, 0, 0, 1)
X(x_noexp128, 40, 128, 0, 1, 0, 1)
X(x_noexp_nopv128, 40, 128, 0, 1, 1, 1)
X(x_pipe128, 40, 128, 1, 0, 0, 1)
X(x_pipe64_2, 40, 64, 1, 0, 0, 2)
X(x_fast64_2, 40, 64, 1, 2, 0, 2)
X(x_fastnoexp64_2, 40, 64, 1, 3, 0, 2)
X(x_fastnofence64_2, 40, 64, 1, 6, 0, 2)
X(x_fast64_3, 40, 64, 1, 2, 0, 3)
X(x_qreg64_2, 40, 64, 1, 18, 0, 2)
X(x_pingpong64_2, 40, 64, 2, 2, 0, 2)
X(x_dec64_2, 40, 64, 2, 34, 0, 2)
X(x_1wg64_3, 40, 64, 1, 2, 0, 3, 1)
X(x_4wg64, 40, 64, 1, 2, 0, 1, 4)
X(x_4wgdec64, 40, 64, 2, 34, 0, 1, 4)
X(x_2wgdec80, 80, 64, 2, 34, 0, 2)
X(x_4wgdec80, 80, 64, 2, 34, 0, 1, 4)
