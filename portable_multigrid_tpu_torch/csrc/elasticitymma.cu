// B.5 on the tensor cores: the elasticity operator's mxu grade as bf16 mma
// tiles.
//
// Replaces, with elasticity.cu, the TPU kernel
// portable_multigrid_tpu/ops/pallas_elasticity.py
// PallasElasticityOperator._run at core "mxu" (pallas_elasticity.py:374-457,
// the smoother grade of the float32 elasticity solve), on the cube, in
// every trimmed-state mode (apply, residual1t, residual3t, cheb, chebl,
// chebd, chebdl) and at every degree p = 1..7.  The exact core, float64
// and the slab keep the CUDA-core kernel of elasticity.cu: a bf16 or TF32
// product would lower their precision.  The two share the launch checks,
// the entry point's arguments (elasticity.cuh) and laplace_epilogue
// (common.cuh), and no arithmetic.
//
// The operator is that of elasticity.cu: out_c = sum of the 21 Kronecker
// chains of K, M, G and H = G^T on the trimmed [3, N, N, N] field, summed
// as there into 12 groups (output c, x matrix) a plane.  At the mxu grade
// the bands are bf16, u is rounded to bf16, each z product and each group
// sum is rounded to bf16, and every sum is float: each contraction of the z
// and y stages has bf16 inputs and float sums, which is what
// mma.sync.m16n8k16 (bf16 in, float32 accumulators) computes:
//   z stage  Z[z][y'] = sum_z' Wz[z][z'] u[y'][z'] for W = K, M, G, H, on
//            an 8-row group's taps: A = the column's band of Wz, 16 lanes
//            against the 32 window columns outside of which it is zero
//            (2p <= 16), in shared memory; B = the bf16 window rows
//            (ldmatrix); 16 (p <= 4) or 32 tap rows, two or four n-tiles;
//   y stage  P[z][y] = sum_y' Z[z][y'] Wy[y][y'] for the seven y-z products
//            of each component (mm, km, mk and four of gm, hm, mg, mh, gh,
//            hg, as elasticity.cu's stage_y lists them): A = the z
//            products, whose float accumulators are packed to bf16 straight
//            into A fragments (the two n-tiles of 8 tap rows are the two k
//            halves of a 16-row tile), so that they never pass through
//            shared memory; B = the 8-row group's y band (8 + 2p taps
//            padded to 16 or 32), in registers for the whole march.
// The products are weighted with mu, lam and alpha = 2 mu + lam in float
// into the 12 groups, which are rounded to bf16 once the three components
// are in: elasticity_grouped's order.
//
// K, G and H are summed directly, without the difference form of
// elasticity.cu.  The product of a bf16 band entry and a bf16 input is
// exact in float, so the direct sum's error is the float sum's, about
// 2^-24 of sum |W| |u|, for K as for G and H, whose interior rows sum to
// zero as K's do.  The grade's own rounding of u, the z products and the
// groups is 2^-9 of the same terms, so the difference form buys nothing
// here, and the row sums are not read.
//
// The x stage stays on the CUDA cores, in float.  It is a contraction with
// one output column a point: an mma over x would waste 7 of its 8 columns
// (B.2's measured slower, cheb2mma.cu).  It pushes instead of pulling:
// once plane x_in's groups are in, each thread adds their products with
// column x_in of K, M, G, H to the three outputs of the 2p + 1 planes
// x_in - p .. x_in + p, in a ring of 2p planes of float accumulators
// private to the thread (three outputs of 4 points, 48 bytes a plane),
// and runs the epilogue of plane x_in - p straight from registers.  Pulling
// would keep 12 groups of 2p + 1 planes a point, twice the bytes.
//
// Warps: a block owns a (TY, 32) column of the y-z plane for all three
// components and marches a chunk of LX output planes along x.  Each warp
// owns an 8-row group of the column and an m-tile (16 z lanes), and does
// its z stage, y stage, x stage and epilogue alone; a thread owns the 4
// points of its accumulator fragment (lanes g, g + 8 of the m-tile, rows
// 2t, 2t + 1 of the group).  The window of the three components (halo p
// in y and z) comes by plain loads a plane ahead into registers and is
// rounded to bf16 on its way into shared memory, double-buffered; the x
// columns by cp.async, three buffers.  A plane costs one block barrier.
// Every global load is issued unconditionally (at offset 0 where its
// element is off the grid or unread) and masked where it is used, and the
// epilogue's inputs are issued before the z stage: a load consumed by a
// select at once, or issued just before the epilogue, left its latency
// exposed (0.60 and 0.55 against 0.50 ms for cheb at 3 x 192^3).  A group
// is packed to bf16 once its last component is in, and the push runs one
// output component at a time, so that fewer registers are live.
//
// What bounds it on the H100 (p = 3, TY = 24, 6 warps a block, two blocks
// an SM, 91 KB of shared memory and 168 registers a thread each, about
// 160 bytes of them spilled): issue and latency.  cheb takes 0.361 ms of
// device time back to back against the CUDA-core instance's ~1.0 (3 x
// 192^3, H100 80GB HBM3, 700 W), 0.424 ms with the whole shared-memory
// carveout, which leaves the spills 28 KB of L1 for 384 threads' 60 KB.
// Without its z and y stages a variant took 0.42 ms, with them and no x
// stage 0.67 ms (whole carveout, one call each, CUDA events around a
// launch), so that no one stage decides it.  The tensor cores do 69
// m16n8k16 products a plane for a warp's 128 points (p <= 4), far below
// their rate; HBM sees 0.051 ms (apply) to 0.152 ms (cheb); the x stage's
// FMAs (12 (2p+1) a point) are 0.02 ms of FP32 work.  More warps an SM
// would need less shared memory a warp: the x ring is 9 KB of a warp's 15.
#include "elasticity.cuh"
#include "mma.cuh"

using namespace pmg;

namespace {

constexpr int kTZ = 32;  // z lanes of a block's column: two m-tiles
constexpr int kWS = 56;  // bf16 row stride of the windows and the z band
constexpr int kSmemSM = 228 * 1024;  // an SM's shared memory
constexpr int kSmemReserved = 1024;  // of it the runtime's share a block
constexpr int kSmemLimit = 227 * 1024;  // one block's most
// threads an SM may hold, so that a thread keeps 168 registers: the 12
// groups of its 4 points, the epilogue's inputs and the window in flight
constexpr int kThreadsSM = 384;

// The tile of degree p at TY rows: NG = TY / 8 groups of 8 rows, two warps
// each (NW); the y stage's depth of 8 + 2p taps padded to KY = 16 or 32;
// the window's rows WYP = 8 (NG - 1) + KY from y0 - p (its real rows WY =
// TY + 2p, the rest zero); the x ring of 2p planes.
struct MmaTile {
  int ty = 0, ng = 0, nw = 0, nt = 0, wy = 0, ky = 0, wyp = 0, slots = 0;

  __host__ __device__ constexpr MmaTile(int p, int t) {
    ty = t;
    ng = t / 8;
    nw = 2 * ng;
    nt = 32 * nw;
    wy = t + 2 * p;
    ky = 8 + 2 * p <= 16 ? 16 : 32;
    wyp = 8 * (ng - 1) + ky;
    slots = 2 * p;
  }

  // shared-memory bytes; must match elasticity_mma_smem_bytes() in
  // ops/cuda_elasticity.py: the ring [2p][3][NT] of float4 (a thread's
  // three outputs at its 4 points), three x columns [3][2p+1] of float4 (K,
  // M, G, H); in bf16 two windows [2][3][WYP][56] and the z band of K, M,
  // G, H [4][32][56]
  __host__ __device__ constexpr int64_t smem_bytes(int p) const {
    return 16 * ((int64_t)slots * 3 * nt + 3 * (2 * p + 1)) +
           2 * ((int64_t)2 * 3 * wyp * kWS + 4 * 32 * kWS);
  }

  // blocks an SM holds: by shared memory and by kThreadsSM
  __host__ __device__ constexpr int blocks(int p) const {
    const int by_smem = (int)(kSmemSM / (smem_bytes(p) + kSmemReserved));
    const int by_threads = kThreadsSM / nt;
    return by_smem < by_threads ? by_smem : by_threads;
  }
};

// TY: of 32, 24, 16 and 8 rows, the one whose blocks put the most warps on
// an SM, ties to the taller column (fewer halo rows a point); 0 where none
// fits
__host__ __device__ constexpr int mma_ty(int p) {
  int best = 0, warps = 0;
  for (int ty = 32; ty >= 8; ty -= 8) {
    const MmaTile t(p, ty);
    if (t.smem_bytes(p) > kSmemLimit || t.blocks(p) < 1) continue;
    if (t.blocks(p) * t.nw > warps) {
      best = ty;
      warps = t.blocks(p) * t.nw;
    }
  }
  return best;
}

__host__ __device__ constexpr int mma_blocks(int p) {
  return MmaTile(p, mma_ty(p)).blocks(p);
}

template <int P>
constexpr int kMmaThreads = MmaTile(P, mma_ty(P)).nt;

// y stage: c = sum over the k-tiles of A (z products, bf16 fragments) times
// B (the group's y band)
template <int KT>
__device__ __forceinline__ void y_product(float (&c)[4],
                                          const uint32_t (&a)[KT][4],
                                          const uint32_t (&b)[KT][2]) {
  c[0] = c[1] = c[2] = c[3] = 0.f;
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) mma_bf16(c, a[kt], b[kt][0], b[kt][1]);
}

// g[q] (+)= w c[q] over the thread's 4 points; SET for a group's first term
template <bool SET>
__device__ __forceinline__ void fold(float (&g)[4], float w,
                                     const float (&c)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) g[q] = SET ? w * c[q] : fmaf(w, c[q], g[q]);
}

// Groups g[4 c + X] (X: K, M, G, H along x) at the thread's 4 points.
enum XMat { kXK = 0, kXM = 1, kXG = 2, kXH = 3 };

// a group at the grade: rounded to bf16, points 0, 1 and 2, 3 packed
__device__ __forceinline__ void round_group(const float (&g)[4],
                                            uint32_t (&b)[2]) {
  b[0] = pack_bf16(g[0], g[1]);
  b[1] = pack_bf16(g[2], g[3]);
}

// z and y stage of component A on the warp's group: z products of the
// window rows at win (16 KT tap rows from the group's first, stride kWS)
// for the m-tile mt, then the seven y-z products summed into the groups
// (elasticity.cu's stage_y):
//   A = 0: 0K al mm, 0M mu (km + mk), 1G mu hm, 1H lam gm, 2G mu mh, 2H lam mg
//   A = 1: 1K mu mm, 1M al km + mu mk, 0H mu gm, 0G lam hm, 2M mu gh + lam hg
//   A = 2: 2K mu mm, 2M mu km + al mk, 0H mu mg, 0G lam mh, 1M mu hg + lam gh
// yb[Y] the y band of matrix Y (K, M, G, H); zband [4][32][kWS].
template <int P, int KT, int A>
__device__ __forceinline__ void stage_zy(const uint16_t* win,
                                         const uint16_t* zband, int mt,
                                         int lane,
                                         const uint32_t (&yb)[4][KT][2],
                                         float mu, float lam,
                                         float (&g)[12][4]) {
  constexpr int NNT = 2 * KT;  // n-tiles of 8 tap rows
  const float al = 2.f * mu + lam;
  // B of the z stage: the window's tap rows against the m-tile's 32
  // columns, two k-tiles each
  uint32_t wb[NNT][4];
#pragma unroll
  for (int nt = 0; nt < NNT; ++nt)
    ldsm_x4(wb[nt],
            win + (8 * nt + (lane & 7)) * kWS + 16 * mt + 8 * (lane >> 3));
  // the z products K, M, G, H as the y stage's A fragments
  uint32_t za[4][KT][4];
  const uint16_t* ap = zband +
                       (16 * mt + 8 * ((lane >> 3) & 1) + (lane & 7)) * kWS +
                       8 * (lane >> 4) + 16 * mt;
#pragma unroll
  for (int X = 0; X < 4; ++X) {
    uint32_t a[2][4];
#pragma unroll
    for (int kt = 0; kt < 2; ++kt) ldsm_x4(a[kt], ap + X * 32 * kWS + 16 * kt);
#pragma unroll
    for (int nt = 0; nt < NNT; ++nt) {
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      mma_bf16(c, a[0], wb[nt][0], wb[nt][1]);
      mma_bf16(c, a[1], wb[nt][2], wb[nt][3]);
      // c: lanes g (c0, c1) and g + 8 (c2, c3), tap rows 8 nt + 2t, + 1:
      // the k half nt % 2 of k-tile nt / 2
      za[X][nt / 2][2 * (nt % 2)] = pack_bf16(c[0], c[1]);
      za[X][nt / 2][2 * (nt % 2) + 1] = pack_bf16(c[2], c[3]);
    }
  }
  float c[4];
  // y matrix Y of z product Z
#define PMG_YZ(Y, Z) y_product<KT>(c, za[kX##Z], yb[kX##Y])
  if constexpr (A == 0) {
    PMG_YZ(M, M);
    fold<true>(g[0 + kXK], al, c);
    PMG_YZ(K, M);
    fold<true>(g[0 + kXM], mu, c);
    PMG_YZ(M, K);
    fold<false>(g[0 + kXM], mu, c);
    PMG_YZ(H, M);
    fold<true>(g[4 + kXG], mu, c);
    PMG_YZ(G, M);
    fold<true>(g[4 + kXH], lam, c);
    PMG_YZ(M, H);
    fold<true>(g[8 + kXG], mu, c);
    PMG_YZ(M, G);
    fold<true>(g[8 + kXH], lam, c);
  } else if constexpr (A == 1) {
    PMG_YZ(M, M);
    fold<true>(g[4 + kXK], mu, c);
    PMG_YZ(K, M);
    fold<true>(g[4 + kXM], al, c);
    PMG_YZ(M, K);
    fold<false>(g[4 + kXM], mu, c);
    PMG_YZ(G, M);
    fold<true>(g[0 + kXH], mu, c);
    PMG_YZ(H, M);
    fold<true>(g[0 + kXG], lam, c);
    PMG_YZ(G, H);
    fold<true>(g[8 + kXM], mu, c);
    PMG_YZ(H, G);
    fold<false>(g[8 + kXM], lam, c);
  } else {
    PMG_YZ(M, M);
    fold<true>(g[8 + kXK], mu, c);
    PMG_YZ(K, M);
    fold<false>(g[8 + kXM], mu, c);
    PMG_YZ(M, K);
    fold<false>(g[8 + kXM], al, c);
    PMG_YZ(M, G);
    fold<false>(g[0 + kXH], mu, c);
    PMG_YZ(M, H);
    fold<false>(g[0 + kXG], lam, c);
    PMG_YZ(H, G);
    fold<false>(g[4 + kXM], mu, c);
    PMG_YZ(G, H);
    fold<false>(g[4 + kXM], lam, c);
  }
#undef PMG_YZ
}

template <int P>
__global__ void __launch_bounds__(kMmaThreads<P>, mma_blocks(P))
elasticitymma_kernel(const float* __restrict__ u, const float* __restrict__ in1,
                     const float* __restrict__ in2, float* __restrict__ out0,
                     float* __restrict__ out1, float* __restrict__ out2,
                     Bands<float> b, const float* __restrict__ dk,
                     const float* __restrict__ dm, Bands<float> xb,
                     const float* __restrict__ xdk,
                     const float* __restrict__ xdm, float mu, float lam,
                     float c0, float c1, int N_, int NX_, int mode, int LX) {
  constexpr MmaTile kT(P, mma_ty(P));
  constexpr int R = 2 * P + 1, S = kT.slots, TY = kT.ty, NT = kT.nt;
  constexpr int WY = kT.wy, WYP = kT.wyp, KT = kT.ky / 16;
  constexpr int WZ = kTZ + 2 * P;
  // the window goes by columns: thread tid loads column tid % WZ of rows
  // tid / WZ + k WSTEP, k < KW, of each component
  constexpr int WSTEP = NT / WZ, KW = (WY + WSTEP - 1) / WSTEP;
  static_assert(TY > 0 && WZ <= 48 && KW <= 16 && WYP >= WY, "tile");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // ring [S][3][NT], xcol [3][R]; bf16: win [2][3][WYP][kWS], zband
  // [4][32][kWS]
  float4* ring = reinterpret_cast<float4*>(smem_raw);
  float4* xcol = ring + S * 3 * NT;
  uint16_t* win = reinterpret_cast<uint16_t*>(xcol + 3 * R);
  uint16_t* zband = win + 2 * 3 * WYP * kWS;

  const int64_t N = N_, NX = NX_, SI = NX * N * N;
  const int tid = threadIdx.x, lane = tid % 32, w = tid / 32;
  const int grp = w / 2, mt = w % 2, g = lane >> 2, t = lane & 3;
  const int z0 = blockIdx.x * kTZ, y0 = blockIdx.y * TY;
  const int x0 = blockIdx.z * LX;
  const int xend = x0 + LX < NX_ ? x0 + LX : NX_;
  const int xs = x0 - P, xe = xend + P;
  const float al = 2.f * mu + lam;

  // the thread's points q = 2 zi + a: lane 16 mt + g + 8 zi, row 8 grp +
  // 2t + a of the column; bit q where it is on the grid; its offset in a
  // plane; its y-z diagonal factors (dM dM, dK dM, dM dK)
  int poff[4];
  unsigned own = 0;
  float dmm[4], dkm[4], dmk[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int gz = z0 + 16 * mt + g + 8 * (q >> 1);
    const int gy = y0 + 8 * grp + 2 * t + (q & 1);
    const bool ok = gz < N_ && gy < N_;
    own |= ok ? 1u << q : 0u;
    poff[q] = gy * N_ + gz;
    dmm[q] = ok ? dm[gy] * dm[gz] : 0.f;
    dkm[q] = ok ? dk[gy] * dm[gz] : 0.f;
    dmk[q] = ok ? dm[gy] * dk[gz] : 0.f;
  }
  // the y bands of the warp's group
  uint32_t yb[4][KT][2];
  {
    const float* bands[4] = {b.kb, b.mb, b.gb, b.hb};
#pragma unroll
    for (int Y = 0; Y < 4; ++Y)
      band_fragments<P, KT>(bands[Y], N_, y0 + 8 * grp, 8, lane, yb[Y]);
  }
  // the thread's window elements: column wc of rows wr0 + k WSTEP; bit k
  // where the row and the column are on the grid, bit k + 16 where the row
  // lies in the window
  const int wc = tid % WZ, wr0 = tid / WZ;
  const int64_t woff = (int64_t)(y0 - P + wr0) * N + z0 - P + wc;
  unsigned wmask = 0;
#pragma unroll
  for (int k = 0; k < KW; ++k) {
    const int rw = wr0 + k * WSTEP, yy = y0 - P + rw, zz = z0 - P + wc;
    if (wr0 < WSTEP && rw < WY) {
      wmask |= 1u << (k + 16);
      if (yy >= 0 && yy < N_ && zz >= 0 && zz < N_) wmask |= 1u << k;
    }
  }
  // zeros where no plane writes: the windows' columns and rows past the
  // data, which the mma tiles read against zero bands
  for (int e = tid; e < (int)(kT.smem_bytes(P) / 4); e += NT)
    reinterpret_cast<uint32_t*>(smem_raw)[e] = 0u;
  __syncthreads();
  // the z band: K, M, G, H of the column's 32 lanes (rows) against the 48
  // window columns, in bf16
  {
    const float* bands[4] = {b.kb, b.mb, b.gb, b.hb};
    for (int e = tid; e < 4 * 32 * 48; e += NT) {
      const int X = e / (32 * 48), m = e / 48 % 32, c = e % 48, o = c - m;
      const int zz = z0 + m;
      const bool ok = zz < N_ && o >= 0 && o <= 2 * P;
      zband[(X * 32 + m) * kWS + c] =
          (uint16_t)bf16_bits(ok ? bands[X][o * N + zz] : 0.f);
    }
  }

  // the window of the next plane in flight, and whether its plane is on
  // the grid: every load is issued, at offset 0 where its element is off
  // the grid, and masked where it is stored, so that nothing waits for a
  // load before then
  float sw[3][KW];
  bool swok = false;
  // the window of plane xn into registers, its x column by cp.async
  auto load_plane = [&](int xn) {
    swok = xn >= 0 && xn < NX_;
    const int64_t pl = (int64_t)xn * N * N + woff;
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int k = 0; k < KW; ++k)
        sw[a][k] = __ldg(u + (swok && (wmask >> k & 1)
                                  ? pl + a * SI + (int64_t)k * WSTEP * N
                                  : 0));
    if (w == kT.nw - 1) {
      // column xn of K, M, G, H on the output planes xn - P + o
      float* xc = reinterpret_cast<float*>(xcol + (xn - xs) % 3 * R);
      const float* bands[4] = {xb.kb, xb.mb, xb.gb, xb.hb};
      for (int e = lane; e < 4 * R; e += 32) {
        const int o = e / 4, x = xn - P + o;
        const bool ok = x >= 0 && x < NX_;
        cp_async_elem(xc + e,
                      bands[e % 4] + (ok ? (int64_t)(2 * P - o) * NX + x : 0),
                      ok);
      }
    }
    cp_async_commit();
  };
  // the registers of the window into buffer bf, rounded to bf16
  auto put_window = [&](int bf) {
    uint16_t* dst = win + bf * 3 * WYP * kWS + wr0 * kWS + wc;
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int k = 0; k < KW; ++k)
        if (wmask >> (k + 16) & 1)
          dst[(a * WYP + k * WSTEP) * kWS] = (uint16_t)bf16_bits(
              swok && (wmask >> k & 1) ? sw[a][k] : 0.f);
  };

  // The march.  Iteration i (input plane xin = xs + i): the window of xin
  // into buffer i % 2 and the loads of plane xin + 1, one barrier, the z
  // and y stages of xin, its push along x and the epilogue of plane
  // xin - P.  The output plane x's accumulators lie in ring slot
  // (x - x0) % S: written by plane x - P, added to by the planes between,
  // read by plane x + P, whose slot x + P = x + S it is.
  load_plane(xs);
  for (int xin = xs; xin < xe; ++xin) {
    const int i = xin - xs;
    put_window(i & 1);
    if (xin + 1 < xe) {
      load_plane(xin + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // the epilogue's inputs of plane x (u, in1, in2 at the thread's
    // points), issued before the z and y stages: as the window's, at
    // offset 0 of u where the mode reads no such input or the point is no
    // output
    const int x = xin - P;
    const bool out = x >= x0;  // plane x ends here
    float in[3][3][4];
    if (out) {
      const float* src[3] = {u, mode == kApply ? u : in1,
                             mode == kCheb || mode == kChebL ? in2 : u};
      const int64_t pl = (int64_t)x * N * N;
#pragma unroll
      for (int c = 0; c < 3; ++c)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int64_t gi = own >> q & 1 ? c * SI + pl + poff[q] : 0;
#pragma unroll
          for (int k = 0; k < 3; ++k) in[k][c][q] = __ldg(src[k] + gi);
        }
    }

    // the z and y stages of plane xin: each group rounded to bf16 once its
    // last component is in, the two rows of a lane packed in a word
    uint32_t gb[12][2];
    {
      float gr[12][4];
      const uint16_t* wg = win + (i & 1) * 3 * WYP * kWS + 8 * grp * kWS;
      stage_zy<P, KT, 0>(wg, zband, mt, lane, yb, mu, lam, gr);
      round_group(gr[0 + kXK], gb[0 + kXK]);
      round_group(gr[0 + kXM], gb[0 + kXM]);
      round_group(gr[4 + kXG], gb[4 + kXG]);
      round_group(gr[4 + kXH], gb[4 + kXH]);
      round_group(gr[8 + kXG], gb[8 + kXG]);
      round_group(gr[8 + kXH], gb[8 + kXH]);
      stage_zy<P, KT, 1>(wg + WYP * kWS, zband, mt, lane, yb, mu, lam, gr);
      round_group(gr[4 + kXK], gb[4 + kXK]);
      stage_zy<P, KT, 2>(wg + 2 * WYP * kWS, zband, mt, lane, yb, mu, lam,
                         gr);
      round_group(gr[8 + kXK], gb[8 + kXK]);
      round_group(gr[8 + kXM], gb[8 + kXM]);
      round_group(gr[0 + kXH], gb[0 + kXH]);
      round_group(gr[0 + kXG], gb[0 + kXG]);
      round_group(gr[4 + kXM], gb[4 + kXM]);
    }

    // the push, one output component at a time: planes x + o of the chunk
    const float4* xc = xcol + i % 3 * R;
    const int base = (x - x0 + 2 * S) % S;  // slot of plane x
    float fin[3][4];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float gv[4][4];  // the groups of output c (K, M, G, H) at the points
#pragma unroll
      for (int X = 0; X < 4; ++X) {
        gv[X][0] = lo_bf16(gb[4 * c + X][0]);
        gv[X][1] = hi_bf16(gb[4 * c + X][0]);
        gv[X][2] = lo_bf16(gb[4 * c + X][1]);
        gv[X][3] = hi_bf16(gb[4 * c + X][1]);
      }
#pragma unroll
      for (int o = 0; o < R; ++o) {
        const int xo = x + o;
        if (xo < x0 || xo >= xend) continue;
        const float4 cf = xc[o];
        int s = base + o;
        if (s >= S) s -= S;
        float4* slot = ring + (s * 3 + c) * NT + tid;
        // plane x + 2P = x + S starts in the slot plane x leaves
        const float4 a = o == R - 1 ? make_float4(0.f, 0.f, 0.f, 0.f) : *slot;
        float v[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int q = 0; q < 4; ++q)
          v[q] = fmaf(cf.w, gv[kXH][q],
                      fmaf(cf.z, gv[kXG][q],
                           fmaf(cf.y, gv[kXM][q],
                                fmaf(cf.x, gv[kXK][q], v[q]))));
        if (o == 0) {  // plane x is complete
#pragma unroll
          for (int q = 0; q < 4; ++q) fin[c][q] = v[q];
        } else {
          *slot = make_float4(v[0], v[1], v[2], v[3]);
        }
      }
    }
    if (!out) continue;
    const int64_t pl = (int64_t)x * N * N;
    const float xk = __ldg(xdk + x), xm = __ldg(xdm + x);
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (!(own >> q & 1)) continue;
        laplace_epilogue(
            mode, c * SI + pl + poff[q], fin[c][q],
            [&](int k) { return in[k][c][q]; }, out0, out1, out2, c0, c1,
            [&] {
              return (c == 0 ? al : mu) * xk * dmm[q] +
                     (c == 1 ? al : mu) * xm * dkm[q] +
                     (c == 2 ? al : mu) * xm * dmk[q];
            });
      }
  }
}

template <int P>
int launch_p(const float* u, const float* in1, const float* in2, float* out0,
             float* out1, float* out2, const Operator<float>& op, double mu,
             double lam, double c0, double c1, int mode, int LX, int TY,
             int NW, void* stream) {
  constexpr MmaTile kT(P, mma_ty(P));
  static_assert(kT.ty > 0, "no tensor-core elasticity tile fits");
  // the host's tile must be the one this instance was compiled for
  if (TY != kT.ty || NW != kT.nw || LX < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)kT.smem_bytes(P);
  const void* kernel = (const void*)elasticitymma_kernel<P>;
  cudaError_t err = allow_smem(kernel, smem);
  // the carveout the tile's blocks need, no more: L1 keeps the rest for
  // the spills and the loads (at p = 3 two blocks take 196 of 228 KB and
  // leave 60 KB; cheb 0.361 against 0.424 ms with the whole carveout,
  // 3 x 192^3, H100 80GB HBM3, 700 W, device time back to back)
  const int carveout = (int)ceil_div(
      100 * (int64_t)mma_blocks(P) * (kT.smem_bytes(P) + kSmemReserved),
      kSmemSM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout, carveout);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)ceil_div(op.N, kTZ), (unsigned)ceil_div(op.N, TY),
                  (unsigned)ceil_div(op.NX, LX));
  elasticitymma_kernel<P><<<grid, kT.nt, smem, (cudaStream_t)stream>>>(
      u, in1, in2, out0, out1, out2, op.b, op.dk, op.dm, op.xb, op.xdk,
      op.xdm, (float)mu, (float)lam, (float)c0, (float)c1, op.N, op.NX, mode,
      LX);
  return (int)cudaGetLastError();
}

// the cube at the mxu grade: flags kRoundBF16, the input as many planes as
// the output (no slab); (LX, TY, NW) the tile of elasticity_mma_tile in
// ops/cuda_elasticity.py
int launch(const float* u, const float* in1, const float* in2, float* out0,
           float* out1, float* out2, const Operator<float>& op, double mu,
           double lam, double c0, double c1, int p, int mode, int LX, int TY,
           int NW, int flags, void* stream) {
  if (flags != kRoundBF16 || op.NXI != op.NX)
    return (int)cudaErrorInvalidValue;
  switch (p) {
#define PMG_CASE(PP)                                                         \
  case PP:                                                                   \
    return launch_p<PP>(u, in1, in2, out0, out1, out2, op, mu, lam, c0, c1,  \
                        mode, LX, TY, NW, stream);
    PMG_CASE(1) PMG_CASE(2) PMG_CASE(3) PMG_CASE(4) PMG_CASE(5) PMG_CASE(6)
    PMG_CASE(7)
#undef PMG_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// B.5 at the mxu grade on the tensor cores, with the arguments of
// pmg_elasticity_f32 (elasticity.cu); the row sums ks, gs, hs and their x
// counterparts are not read (K, G and H are summed directly).
PMG_ELASTICITY_ENTRY(pmg_elasticitymma, float, launch)
