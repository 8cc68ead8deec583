// B.2 on the tensor cores: the pair's production grade as bf16 mma tiles.
//
// Replaces, with cheb2.cu, the TPU kernel
// portable_multigrid_tpu/ops/pallas_cheb2.py Cheb2Kernel.steps2 (modes
// cheb2, cheb2l, chebd2, chebd2l, cheb2f0, cheb2f0l), here at its
// production grade (make_cheb2(..., exact=False): the "mxu" operator's
// bands rounded to bf16, every contraction's input rounded to bf16, float
// accumulation), in float with the recurrence state in float or bf16, on
// the cube, a shard (xext) and a pencil (xext and yext).  The exact grade,
// float64 and cheb2lr keep the CUDA-core kernel of cheb2.cuh: a bf16 or
// TF32 product would lower their precision.  The two share the launch
// prologue (pair_prologue) and no arithmetic.
//
// The pair is the one of cheb2.cuh,
//     r1 = r  - A d      d1 = c0a d  + (c1a / diag) r1
//     r2 = r1 - A d1     d2 = c0b d1 + (c1b / diag) r2
//     x2 = x + d1 + d2,
// A = Kx My Mz + Mx Ky Mz + Mx My Kz, on the same march: a block owns a
// y-z column (TZ = 32 - 2p output lanes, TY output rows) and marches a
// chunk of LX output planes along x; step one runs on the column grown by
// p (EY = TY + 2p rows of 32 lanes), step two on the interior; ring 1 and
// ring 2 hold 2p+1 planes of the y products, a lag ring the (r1, d1)
// planes of step two's epilogue; the d window comes a plane ahead; the
// stages are skewed by a plane, so that a plane costs one block barrier;
// the epilogues run in float.
//
// What changed is the arithmetic of the z and y stages.  At this grade
// both inputs of each contraction are bf16 and its sums float, which is
// what mma.sync.m16n8k16 (bf16 in, float32 accumulators) computes:
//   z stage  Z[z][y'] = sum_z' Kz[z][z'] W[y'][z'] (and Mz) for 8 rows y':
//            A = the column's band of Kz (Mz), 16 lanes against the 32
//            window columns outside of which it is zero (2p <= 16), kept
//            in shared memory; B = the 8 bf16 window rows (ldmatrix);
//   y stage  MB[z][y] = sum_y' MzD[z][y'] My[y][y'],
//            S[z][y] = sum_y' MzD[z][y'] Ky[y][y'] + KzD[z][y'] My[y][y']
//            for an 8-row group: A = the z products, stored [lane][row]
//            (ldmatrix), B = the group's band (8 + 2p taps padded to 16 or
//            32), in registers for the whole march.
// K is summed directly, without the difference form: the products of
// bf16 bands and bf16 inputs are exact in float, so the direct sum's
// error, about 2^-24 of |K||u|, lies far below the grade's own input
// rounding (2^-8).  The z and y products are rounded to bf16 where they
// are stored, as the grade rounds them.  Step two's z stage runs on the d1
// plane, stored at the window's column offset, with the same band.
//
// The x stage stays on the CUDA cores.  It combines the 2p+1 ring planes
// of one output plane with that plane's own coefficients, a product with
// one output column: an mma over the ring's slots wastes 7 of its 8
// columns and reads the ring 1.8 times over in 16-slot tiles, and measured
// slower (0.96 against 0.85 ms a pair at 256^3, p = 4, H100 80GB HBM3).
// Each thread keeps the x stage and the epilogue of the points its y-stage
// accumulators hold (rows 2t, 2t+1 of its 8-row group, lanes g and g+8 of
// its warp's 16), so the rings are private to a thread; they hold the y
// products as bf16 pairs (the two rows of a lane) in 16-byte entries.  A
// tap's ring entry and coefficients are read a tap ahead, and no further.
//
// Warps: each 8-row group of step one (EY / 8) and of step two
// (ceil(TY / 8), the last padded) has two warps, one for each m-tile of
// 16 lanes; a group's pair of warps meets at a named barrier before step
// two's z stage of its d1 rows.  The window's z stages (an 8-row group and
// an m-tile each) go round step two's warps, which have no d1 plane.
// The epilogues' r, d and x come by plain loads into registers, issued
// once the last plane's are used; the window by plain loads a plane ahead,
// rounded to bf16 on the way into shared memory.
//
// What bounds it on the H100 (p = 4, TY = 16, 10 warps a block, two
// blocks an SM, 105 KB of shared memory and 96 registers a thread each):
// issue and latency, not the tensor cores (about 90 m16n8k16 products a
// plane of a block) or HBM (24 B a point, 0.06 ms at 256^3).  At 0.70 ms a
// pair at 256^3 the epilogues' loads, the z and y stages, the window and
// the x stage each take 0.1-0.3 ms of it.
#include "cheb2.cuh"
#include "mma.cuh"

namespace {

using namespace pmg;

// ---- the tile

constexpr int kWS = 56;  // bf16 row stride of the window and the d1 plane
constexpr int kLS = 36;  // float row stride of the lag ring
constexpr int kMmaSmemTwo = 113 * 1024;  // a block's share when two fit

__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

// bf16 row stride of z products stored [lane][row] for rows rows: 16-byte
// rows whose stride in words is an odd multiple of 4, so that the 8 rows
// of an ldmatrix tile and the packed stores of a z stage fall in distinct
// banks
__host__ __device__ constexpr int zt_stride(int rows) {
  return (rows + 7) / 8 * 8 + ((rows + 7) / 8 % 2 == 0 ? 8 : 0);
}

// The tile of degree p at interior rows ty: EY = ty + 2p grown rows (a
// multiple of 8) in n1 = EY / 8 step-one groups and n2 = ceil(ty / 8)
// step-two groups of 8 rows, two warps a group; the window's WY = EY + 2p
// rows padded to wyp (nz groups); the y stage's depth (8 + 2p taps)
// padded to ky; the z products of step one and step two stored [lane][row]
// with the strides zs1, zs2 over the rows their tiles read.
struct MmaTile {
  int ty = 0, ey = 0, n1 = 0, n2 = 0, groups = 0, nw = 0, wy = 0, wyp = 0,
      nz = 0, ky = 0, zs1 = 0, zs2 = 0, lags = 0;

  __host__ __device__ constexpr MmaTile(int p, int t) {
    ty = t;
    ey = t + 2 * p;
    n1 = ey / 8;
    n2 = (t + 7) / 8;
    groups = n1 + n2;
    nw = 2 * groups;
    wy = ey + 2 * p;
    wyp = (wy + 7) / 8 * 8;
    nz = wyp / 8;
    ky = 8 + 2 * p <= 16 ? 16 : 32;
    zs1 = zt_stride(imax(wyp, 8 * (n1 - 1) + ky));
    zs2 = zt_stride(imax(ey, 8 * (n2 - 1) + ky));
    lags = p + 2;
  }

  // shared-memory bytes; must match cheb2_mma_smem_bytes() in
  // ops/cuda_cheb2.py.  Words (4 bytes): ring 1 [R][N1][2][32][4] and
  // ring 2 [R][N2][2][32][4] (the y products as bf16 pairs), the lag ring
  // [P+2][2][8 N2][36] (r1, d1 in float), the x rows [3][2][XH].  bf16:
  // two windows [2][WYP][56], two sets of step one's z products
  // [2][2][32][ZS1], the d1 plane [EY][56], two sets of step two's z
  // products [2][2][32][ZS2], the z band of Kz and Mz [2][32][56].
  __host__ __device__ constexpr int64_t smem_bytes(int p) const {
    return 4 * ((int64_t)(2 * p + 1) * groups * 256 +
                (int64_t)lags * 2 * 8 * n2 * kLS + 3 * 2 * xrow_elems(p)) +
           2 * ((int64_t)2 * wyp * kWS + 4 * 32 * zs1 + ey * kWS +
                4 * 32 * zs2 + 2 * 32 * kWS);
  }
};

// TY: of the interior rows whose grown column is 32, 24 or 16 rows, the
// largest of at least 8 whose block fits twice an SM with at most 6
// groups; else the largest that fits once
__host__ __device__ constexpr int mma_ty(int p) {
  const int ey[3] = {32, 24, 16};
  for (int k = 0; k < 3; ++k) {
    const int ty = ey[k] - 2 * p;
    const MmaTile t(p, ty);
    if (ty >= 8 && t.groups <= 6 && t.smem_bytes(p) <= kMmaSmemTwo) return ty;
  }
  for (int k = 0; k < 3; ++k) {
    const int ty = ey[k] - 2 * p;
    if (ty >= 1 && MmaTile(p, ty).smem_bytes(p) <= kSmemLimit) return ty;
  }
  return 0;
}

__host__ __device__ constexpr int mma_blocks(int p) {
  return MmaTile(p, mma_ty(p)).smem_bytes(p) <= kMmaSmemTwo ? 2 : 1;
}

template <int P>
constexpr int kMmaThreads = MmaTile(P, mma_ty(P)).nw * 32;

// ---- the stages (a warp's m-tile mt: lanes 16 mt .. 16 mt + 15)

// z stage of one 8-row group: B from 8 bf16 rows at src (stride kWS, 48
// columns), A the m-tile's rows of the block's z band zband[mat][32][kWS];
// Kz and Mz products, rounded to bf16, into zk and zm, stored [lane][row]
// (stride zs) from the group's first row
__device__ __forceinline__ void z_stage(const uint16_t* src,
                                        const uint16_t* zband, int mt,
                                        uint16_t* zk, uint16_t* zm, int zs,
                                        int lane) {
  // the m-tile's band is zero outside window columns 16 mt .. 16 mt + 31
  // (2P <= 16): k-tiles mt and mt + 1 of the 48 columns
  uint32_t b[4];
  ldsm_x4(b, src + (lane & 7) * kWS + 16 * mt + 8 * (lane >> 3));
  const int g = lane >> 2, t = lane & 3;
  // A's 8 x 8 matrices: lanes (+0, +8) x columns (+0, +8) of the tile
  const uint16_t* ap =
      zband + (16 * mt + 8 * ((lane >> 3) & 1) + (lane & 7)) * kWS +
      8 * (lane >> 4) + 16 * mt;
#pragma unroll
  for (int mat = 0; mat < 2; ++mat) {
    float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kt = 0; kt < 2; ++kt) {
      uint32_t a[4];
      ldsm_x4(a, ap + mat * 32 * kWS + 16 * kt);
      mma_bf16(c, a, b[2 * kt], b[2 * kt + 1]);
    }
    // c: lanes 16 mt + g (c0, c1) and + 8 (c2, c3), rows 2t and 2t + 1
    uint16_t* out = (mat ? zm : zk) + (16 * mt + g) * zs + 2 * t;
    *reinterpret_cast<uint32_t*>(out) = pack_bf16(c[0], c[1]);
    *reinterpret_cast<uint32_t*>(out + 8 * zs) = pack_bf16(c[2], c[3]);
  }
}

// y stage of one 8-row group on the m-tile: A the z products (zk, zm,
// stored [lane][row] with stride zs, from the group's first tap row; KT
// tiles of 16 rows), B the group's band fragments yb[mat][kt]; MB and S
// rounded to bf16, the thread's two rows packed, as the ring entry (MB of
// lanes g and g + 8, then S)
template <int KT>
__device__ __forceinline__ uint4 y_stage(const uint16_t* zk,
                                         const uint16_t* zm, int zs,
                                         const uint32_t (&yb)[2][KT][2],
                                         int mt, int lane) {
  float mbc[4] = {0.f, 0.f, 0.f, 0.f}, sc[4] = {0.f, 0.f, 0.f, 0.f};
  const int off = (16 * mt + 8 * ((lane >> 3) & 1) + (lane & 7)) * zs +
                  8 * (lane >> 4);
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
    uint32_t am[4], ak[4];
    ldsm_x4(am, zm + off + 16 * kt);
    ldsm_x4(ak, zk + off + 16 * kt);
    mma_bf16(mbc, am, yb[1][kt][0], yb[1][kt][1]);
    mma_bf16(sc, am, yb[0][kt][0], yb[0][kt][1]);
    mma_bf16(sc, ak, yb[1][kt][0], yb[1][kt][1]);
  }
  // c: lanes 16 mt + g (c0, c1) and + 8 (c2, c3), rows 2t and 2t + 1
  return make_uint4(pack_bf16(mbc[0], mbc[1]), pack_bf16(mbc[2], mbc[3]),
                    pack_bf16(sc[0], sc[1]), pack_bf16(sc[2], sc[3]));
}

// x stage of the thread's points: raw = Kx MB + Mx S over the 2P+1 ring
// planes x - P + o in slots (base + o) % R, slot_words entries apart, with
// the plane's x row xr as (K, M) pairs; raw[zi][a] at lane 16 mt + g +
// 8 zi, row 2t + a.  A tap's loads are issued a tap ahead, and no
// further, so that the loads in flight hold few registers.
template <int P>
__device__ __forceinline__ void x_stage(const float* xr, const uint4* ring,
                                        int slot_words, int base,
                                        float (&raw)[2][2]) {
  constexpr int R = 2 * P + 1;
  raw[0][0] = raw[0][1] = raw[1][0] = raw[1][1] = 0.f;
  const float2* km2 = reinterpret_cast<const float2*>(xr);
  uint4 v = ring[base * slot_words];
  float2 km = km2[0];
#pragma unroll
  for (int o = 0; o < R; ++o) {
    uint4 vn = v;
    float2 kmn = km;
    if (o + 1 < R) {
      int s = base + o + 1;
      if (s >= R) s -= R;
      vn = ring[s * slot_words];
      kmn = km2[o + 1];
    }
    asm volatile("" ::: "memory");
    const uint32_t mbv[2] = {v.x, v.y}, sv[2] = {v.z, v.w};
#pragma unroll
    for (int zi = 0; zi < 2; ++zi) {
      raw[zi][0] = fmaf(km.x, lo_bf16(mbv[zi]), raw[zi][0]);
      raw[zi][0] = fmaf(km.y, lo_bf16(sv[zi]), raw[zi][0]);
      raw[zi][1] = fmaf(km.x, hi_bf16(mbv[zi]), raw[zi][1]);
      raw[zi][1] = fmaf(km.y, hi_bf16(sv[zi]), raw[zi][1]);
    }
    v = vn;
    km = kmn;
  }
}

// One element of a state stream as raw bits (bf16 in the low half, or a
// float) at plane[off]: where !ok the offset falls back to 0, so that the
// load needs no branch, and the value is masked where it is used
// (bits_value), so that nothing waits for the load until then.
template <bool BF>
__device__ __forceinline__ uint32_t load_bits(const void* plane, int off,
                                              bool ok) {
  if constexpr (BF)
    return __ldg(static_cast<const unsigned short*>(plane) + (ok ? off : 0));
  else
    return __float_as_uint(
        __ldg(static_cast<const float*>(plane) + (ok ? off : 0)));
}

// the value of load_bits' bits, zero where !ok
template <bool BF>
__device__ __forceinline__ float bits_value(uint32_t v, bool ok) {
  return ok ? __uint_as_float(BF ? v << 16 : v) : 0.f;
}

// plane xl (halo h, rows a plane, row length N) of a stream of floats or
// bf16
__device__ __forceinline__ const void* plane_of(const void* base, bool bf,
                                                int xl, int h, int rows,
                                                int N) {
  const int64_t e = (int64_t)(xl + h) * rows * N;
  return bf ? static_cast<const void*>(
                  static_cast<const unsigned short*>(base) + e)
            : static_cast<const void*>(static_cast<const float*>(base) + e);
}

// the band fragments of K and M (band_fragments in mma.cuh) of an 8-row
// group whose row n lies on global row gy0 + n (valid below nvalid)
template <int P, int KT>
__device__ __forceinline__ void y_bands(const float* __restrict__ kb,
                                        const float* __restrict__ mb, int N,
                                        int gy0, int nvalid, int lane,
                                        uint32_t (&yb)[2][KT][2]) {
  band_fragments<P, KT>(kb, N, gy0, nvalid, lane, yb[0]);
  band_fragments<P, KT>(mb, N, gy0, nvalid, lane, yb[1]);
}

// IBF: d and r stored in bf16 (StateFlags kInBF16).  The bands kb, mb are
// summed directly, so K's row sums are not read.
template <int P, bool IBF>
__global__ void __launch_bounds__(kMmaThreads<P>, mma_blocks(P))
cheb2mma_kernel(const void* __restrict__ d, const void* __restrict__ r,
                const float* __restrict__ x, void* __restrict__ out0,
                void* __restrict__ out1, float* __restrict__ out2,
                const float* __restrict__ kb, const float* __restrict__ mb,
                const float* __restrict__ dk, const float* __restrict__ dm,
                float c0a, float c1a, float c0b, float c1b, int N, int NX,
                int XOFF, int HD, int HR, int NY, int YOFF, int HDY, int HRY,
                int mode, int LX, int flags) {
  constexpr int R = 2 * P + 1, G = P;
  constexpr MmaTile kT(P, mma_ty(P));
  constexpr int TY = kT.ty, EY = kT.ey, N1 = kT.n1, N2 = kT.n2, NW = kT.nw;
  constexpr int WY = kT.wy, WYP = kT.wyp, NZ = kT.nz, KT = kT.ky / 16;
  constexpr int ZS1 = kT.zs1, ZS2 = kT.zs2, L = kT.lags;
  constexpr int WZ = kEZ + 2 * P, TZ = kEZ - 2 * G, NT = NW * 32;
  constexpr int XH = xrow_elems(P);
  // the window goes by columns: thread tid loads column tid % WZ of rows
  // tid / WZ + k WSTEP, k < KW
  constexpr int WSTEP = NT / WZ, KW = (WY + WSTEP - 1) / WSTEP;
  constexpr int RING = 2 * 32;  // 16-byte entries of a group's plane
  static_assert(TY > 0 && EY % 8 == 0 && WZ <= 48 && KW <= 16, "tile");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint4* ring1 = reinterpret_cast<uint4*>(smem_raw);  // [R][N1][2][32]
  uint4* ring2 = ring1 + R * N1 * RING;               // [R][N2][2][32]
  float* lag = reinterpret_cast<float*>(ring2 + R * N2 * RING);
  // lag: [L][2][8 N2][kLS]
  // the x rows of x1 and x2: (K, M) pairs of the 2P+1 taps, dK, dM
  float* xrow = lag + L * 2 * 8 * N2 * kLS;  // [3][2][XH]
  uint16_t* win = reinterpret_cast<uint16_t*>(xrow + 3 * 2 * XH);
  uint16_t* zb1 = win + 2 * WYP * kWS;   // [2][2][32][ZS1]
  uint16_t* d1p = zb1 + 4 * 32 * ZS1;    // [EY][kWS]
  uint16_t* zb2 = d1p + EY * kWS;        // [2][2][32][ZS2]
  uint16_t* zband = zb2 + 4 * 32 * ZS2;  // [2][32][kWS]
  static_assert((R * (N1 + N2) * RING * 16 + L * 2 * 8 * N2 * kLS * 4 +
                 3 * 2 * XH * 4) % 16 == 0,
                "bf16 buffers 16-byte aligned");

  const int DY = NY + 2 * HDY, RY = NY + 2 * HRY;
  const int tid = threadIdx.x, lane = tid % 32, w = tid / 32;
  const int g = lane >> 2, t = lane & 3;
  // a pencil's blocks (yext) start where the cube's do, TY-aligned global
  // rows, so that a point's y stage takes its taps in the same places of
  // the same mma tiles and its output is the cube's bit for bit
  const int z0 = blockIdx.x * TZ, y0 = blockIdx.y * TY - YOFF % TY;
  const int x0 = blockIdx.z * LX;
  const int xend = x0 + LX < NX ? x0 + LX : NX;
  auto on_grid = [&](int xl) { return XOFF + xl >= 0 && XOFF + xl < N; };
  auto on_grid_y = [&](int yl) { return YOFF + yl >= 0 && YOFF + yl < N; };
  auto d_row = [&](int yl) {
    return on_grid_y(yl) && yl >= -HDY && yl < NY + HDY;
  };
  auto r_row = [&](int yl) {
    return on_grid_y(yl) && yl >= -HRY && yl < NY + HRY;
  };
  const int xs = x0 - G - P, xe = xend + G + P;
  const bool last = mode == kCheb2L || mode == kChebD2L;
  const bool obf = flags & kOutBF16;
  const bool x_is_x = mode == kCheb2 || mode == kCheb2L;
  const bool xbf = !x_is_x && IBF;
  // the role: step one's group (w < 2 N1) or step two's, and the m-tile
  const bool one = w < 2 * N1;
  const int grp = (one ? w : w - 2 * N1) / 2, mt = w % 2;
  const int e0 = one ? 8 * grp : P + 8 * grp;  // grown row of group row 0
  // the ring entries of the warp's group and m-tile
  const int rofs = grp * RING + 32 * mt + lane;
  // the thread's points (a, zi): row e0 + 2t + a of the grown column (step
  // one) or interior row q = 8 grp + 2t + a, e = P + q (step two); lane
  // 16 mt + g + 8 zi.  Their in-plane offsets into d (step one; r's lie
  // (HRY - HDY) N further) or into the outputs (step two; x's lie HDY N
  // further for chebd2*), and bits 2a + zi: step one's point on the grid
  // in y and z, with d (bit + 4) and r (bit + 8) there; step two's point
  // an output of the block
  int poff[2][2];
  unsigned pmask = 0;
  float ay[2][2], by[2][2];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int yl = y0 - G + e0 + 2 * t + a, gy = YOFF + yl;
    const int q = 8 * grp + 2 * t + a;
#pragma unroll
    for (int zi = 0; zi < 2; ++zi) {
      const int m = 16 * mt + g + 8 * zi, bit = 2 * a + zi;
      const int gz = z0 - G + m;
      const bool zok = gz >= 0 && gz < N;
      const bool ok = zok && gy >= 0 && gy < N;
      ay[a][zi] = ok ? dm[gy] * dm[gz] : 0.f;
      by[a][zi] = ok ? dk[gy] * dm[gz] + dm[gy] * dk[gz] : 0.f;
      if (one) {
        poff[a][zi] = (yl + HDY) * N + gz;
        pmask |= (ok ? 1u << bit : 0u) |
                 (zok && d_row(yl) ? 1u << (bit + 4) : 0u) |
                 (zok && r_row(yl) ? 1u << (bit + 8) : 0u);
      } else {
        poff[a][zi] = (y0 + q) * N + gz;
        if (zok && m >= G && m < kEZ - G && q < TY && y0 + q >= 0 &&
            y0 + q < NY)
          pmask |= 1u << bit;
      }
    }
  }
  const int roff = (HRY - HDY) * N;       // r's offset beside d's
  const int xoff = x_is_x ? 0 : HDY * N;  // x's beside the output's
  // the y band of the group: step one's rows e0 .. from the window's
  // (zb1's) row e0, step two's from zb2's row e0 - P
  uint32_t yb[2][KT][2];
  y_bands<P, KT>(kb, mb, N, YOFF + y0 - G + e0, one ? 8 : TY - 8 * grp,
                 lane, yb);
  // the thread's window elements: the in-plane offset into d and the place
  // in the window of the first, bit k where the k-th is on the grid and in
  // d's halo, bit k + 16 where it lies in the window
  const int wc = tid % WZ, wr0 = tid / WZ;
  const int woff = (y0 - G - P + wr0 + HDY) * N + z0 - G - P + wc;
  const int wdst = wr0 * kWS + wc;
  unsigned wmask = 0;
#pragma unroll
  for (int k = 0; k < KW; ++k) {
    const int rw = wr0 + k * WSTEP, zz = z0 - G - P + wc;
    if (wr0 < WSTEP && rw < WY) {
      wmask |= 1u << (k + 16);
      if (d_row(y0 - G - P + rw) && zz >= 0 && zz < N) wmask |= 1u << k;
    }
  }
  // zeros where no plane writes: the windows' and the d1 plane's columns
  // past the data, the rows past the data the mma tiles read
  for (int e = tid; e < (int)(kT.smem_bytes(P) / 4); e += NT)
    reinterpret_cast<uint32_t*>(smem_raw)[e] = 0u;
  __syncthreads();
  // the z band: Kz and Mz of the column's 32 lanes (rows) against the 48
  // window columns, in bf16
  for (int e = tid; e < 2 * 32 * 48; e += NT) {
    const int mat = e / (32 * 48), m = e / 48 % 32, c = e % 48, o = c - m;
    const int zz = z0 - G + m;
    const bool ok = zz >= 0 && zz < N && o >= 0 && o <= 2 * P;
    zband[(mat * 32 + m) * kWS + c] =
        (uint16_t)bf16_bits(ok ? (mat ? mb : kb)[o * N + zz] : 0.f);
  }

  // registers in flight from one plane to the next: the window (bits, bf16
  // or float) and its plane's flag, the epilogues' r, d (step one) or x
  // (step two) of the thread's points
  uint32_t sw[KW], en[2][2][2] = {};
  bool swok = false;
  // the window of plane xn, and by cp.async the x rows of its iteration
  auto load_plane = [&](int xn) {
    if (xn < xe) {
      swok = on_grid(xn);
      const void* pl = swok ? plane_of(d, IBF, xn, HD, DY, N) : d;
#pragma unroll
      for (int k = 0; k < KW; ++k)
        sw[k] = load_bits<IBF>(pl, woff + k * WSTEP * N,
                               swok && (wmask >> k & 1));
    }
    if (w == NW - 1) {
      // the x rows of x1 and x2: elements lane + 32 u
      float* xr = xrow + (xn - xs) % 3 * 2 * XH;
#pragma unroll
      for (int u = 0; u < (2 * XH + kEZ - 1) / kEZ; ++u) {
        const int e = lane + u * kEZ, k = e % XH;
        if (e >= 2 * XH || k >= 2 * R + 2) continue;
        const int row = e < XH ? xn - 1 - P : xn - 2 - 2 * P;
        const float* src = k >= 2 * R ? (k == 2 * R ? dk : dm)
                                      : (k % 2 ? mb : kb) + k / 2 * N;
        const bool ok = on_grid(row);
        cp_async_elem(xr + e, src + (ok ? XOFF + row : 0), ok);
      }
    }
    cp_async_commit();
  };
  // the epilogue's inputs of the iteration of plane xn into registers, r
  // and d at its x1 (step one) or x at its x2 (step two), issued once the
  // last iteration's are used
  auto load_epi = [&](int xn) {
    if (one) {
      const int x1 = xn - 1 - P;
      if (xn <= xe && x1 >= x0 - G && on_grid(x1)) {
        const void* pd = plane_of(d, IBF, x1, HD, DY, N);
        const void* pr = plane_of(r, IBF, x1, HR, RY, N);
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int zi = 0; zi < 2; ++zi) {
            const int bit = 2 * a + zi;
            en[0][a][zi] = load_bits<IBF>(pr, poff[a][zi] + roff,
                                          pmask >> (bit + 8) & 1);
            en[1][a][zi] =
                load_bits<IBF>(pd, poff[a][zi], pmask >> (bit + 4) & 1);
          }
      }
    } else {
      const int x2 = xn - 2 - 2 * P;
      if (x2 >= x0 && x2 < xend) {
        const void* px = x_is_x ? plane_of(x, false, x2, 0, NY, N)
                                : plane_of(d, IBF, x2, HD, DY, N);
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int zi = 0; zi < 2; ++zi) {
            const bool ok = pmask >> (2 * a + zi) & 1;
            en[0][a][zi] = xbf ? load_bits<true>(px, poff[a][zi] + xoff, ok)
                               : load_bits<false>(px, poff[a][zi] + xoff, ok);
          }
      }
    }
  };
  // the window's registers of plane xn into its buffer, rounded to bf16
  auto put_window = [&](int xn, int b) {
    if (xn >= xe) return;
    uint16_t* dst = win + b * WYP * kWS + wdst;
#pragma unroll
    for (int k = 0; k < KW; ++k)
      if (wmask >> (k + 16) & 1)
        dst[k * WSTEP * kWS] = (uint16_t)bf16_bits(
            bits_value<IBF>(sw[k], swok && (wmask >> k & 1)));
  };

  // The march.  Iteration i (input plane xin = xs + i): step two of d1
  // plane xin - 2 - P (output plane x2 = xin - 2 - 2P), step one's z stage
  // of plane xin, step one's y stage of plane xin - 1 and its x stage at
  // x1 = xin - 1 - P, step two's z stage of d1 plane x1.  Both rings write
  // slot s = (i - 1) % R and read from the oldest, s + 1; the lag ring
  // writes plane x1 at slot (i - 1 - P) % L and reads plane x2 at the next
  // slot; windows and step one's z products go by i % 2, step two's by
  // the parity of their d1 plane, the x rows by i % 3.
  int s = R - 1, lw = 1, xb = 0;
  load_plane(xs);
  load_epi(xs);
  for (int xin = xs; xin <= xe + 1; ++xin) {
    const int i = xin - xs, b = i & 1, sr = s + 1 == R ? 0 : s + 1;
    const int lr = lw + 1 == L ? 0 : lw + 1;
    put_window(xin, b);
    const float* xr1 = xrow + xb * 2 * XH;  // rows of x1 and x2
    if (xin < xe + 1) {
      load_plane(xin + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    if (!one) {
      // ---- step two of d1 plane x1 = xin - 2 - P: r2, d2 at x2
      const int x1 = xin - 2 - P, x2 = x1 - P;
      if (x1 >= x0 - P && x1 < xend + P) {
        const uint16_t* zk = zb2 + ((i + P) & 1) * 2 * 32 * ZS2 + 8 * grp;
        ring2[s * N2 * RING + rofs] =
            y_stage<KT>(zk, zk + 32 * ZS2, ZS2, yb, mt, lane);
        if (x2 >= x0 && x2 < xend) {
          const float* xr = xr1 + XH;  // the x row of x2
          const float dkx = xr[2 * R], dmx = xr[2 * R + 1];
          float raw[2][2];
          x_stage<P>(xr, ring2 + rofs, N2 * RING, sr, raw);
          const float* lg = lag + lr * 2 * 8 * N2 * kLS;
          const int64_t bo = (int64_t)x2 * NY * N;
#pragma unroll
          for (int a = 0; a < 2; ++a) {
            const int q = 8 * grp + 2 * t + a;
#pragma unroll
            for (int zi = 0; zi < 2; ++zi) {
              if (!(pmask >> (2 * a + zi) & 1)) continue;
              const int m = 16 * mt + g + 8 * zi;
              const float r1 = lg[q * kLS + m];
              const float d1 = lg[(8 * N2 + q) * kLS + m];
              const float diag = dkx * ay[a][zi] + dmx * by[a][zi];
              const float r2 = r1 - raw[zi][a];
              const float d2 = c0b * d1 + __fdividef(c1b, diag) * r2;
              const float x2v = (xbf ? bits_value<true>(en[0][a][zi], true)
                                     : bits_value<false>(en[0][a][zi], true)) +
                                d1 + d2;
              const int64_t go = bo + poff[a][zi];
              if (last) {
                static_cast<float*>(out0)[go] = x2v;
              } else {
                store_state(out0, go, r2, obf);
                store_state(out1, go, d2, obf);
                out2[go] = x2v;
              }
            }
          }
        }
      }
      if (xin < xe + 1) load_epi(xin + 1);
    }

    // ---- step one's z stage of input plane xin: the window's 8-row
    // groups, an m-tile at a time, go round step two's warps (step one's
    // have the z stage of the d1 plane)
    if (!one && xin < xe) {
      const uint16_t* src = win + b * WYP * kWS;
      uint16_t* zo = zb1 + b * 2 * 32 * ZS1;
      for (int u = w - 2 * N1; u < 2 * NZ; u += 2 * N2)
        z_stage(src + 8 * (u / 2) * kWS, zband, u % 2, zo + 8 * (u / 2),
                zo + 32 * ZS1 + 8 * (u / 2), ZS1, lane);
    }

    if (one && xin - 1 >= xs && xin - 1 < xe) {
      // ---- step one's y stage of plane xin - 1, its x stage at x1 and
      // step two's z stage of the d1 plane x1
      const uint16_t* zk = zb1 + (b ^ 1) * 2 * 32 * ZS1 + 8 * grp;
      ring1[s * N1 * RING + rofs] =
          y_stage<KT>(zk, zk + 32 * ZS1, ZS1, yb, mt, lane);
      const int x1 = xin - 1 - P;
      if (x1 >= x0 - G) {
        const bool xok = on_grid(x1);
        float raw[2][2];
        const float dkx = xr1[2 * R], dmx = xr1[2 * R + 1];
        x_stage<P>(xr1, ring1 + rofs, N1 * RING, sr, raw);
        float* lg = lag + lw * 2 * 8 * N2 * kLS;
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          const int e = e0 + 2 * t + a;
#pragma unroll
          for (int zi = 0; zi < 2; ++zi) {
            const int m = 16 * mt + g + 8 * zi, bit = 2 * a + zi;
            float r1 = 0.f, d1 = 0.f;
            if (xok && (pmask >> bit & 1)) {
              const float diag = dkx * ay[a][zi] + dmx * by[a][zi];
              r1 = bits_value<IBF>(en[0][a][zi], pmask >> (bit + 8) & 1) -
                   raw[zi][a];
              d1 = c0a * bits_value<IBF>(en[1][a][zi],
                                         pmask >> (bit + 4) & 1) +
                   __fdividef(c1a, diag) * r1;
            }
            // step two's stencil input, rounded; the lag ring keeps r1, d1
            d1p[e * kWS + P + m] = (uint16_t)bf16_bits(d1);
            if (e >= P && e < P + TY) {
              lg[(e - P) * kLS + m] = r1;
              lg[(8 * N2 + e - P) * kLS + m] = d1;
            }
          }
        }
        // the group's two warps have written its d1 rows
        asm volatile("bar.sync %0, 64;\n" ::"r"(1 + grp) : "memory");
        uint16_t* zo = zb2 + ((i + P + 1) & 1) * 2 * 32 * ZS2 + 8 * grp;
        z_stage(d1p + 8 * grp * kWS, zband, mt, zo, zo + 32 * ZS2, ZS2,
                lane);
      }
    }
    if (one && xin < xe + 1) load_epi(xin + 1);
    s = sr;
    lw = lw + 1 == L ? 0 : lw + 1;
    xb = xb == 2 ? 0 : xb + 1;
  }
}

template <int P, bool IBF>
int launch_ibf(const void* d, const void* r, const float* x, void* out0,
               void* out1, float* out2, const float* kb, const float* mb,
               const float* dk, const float* dm, double c0a, double c1a,
               double c0b, double c1b, const March& g, int mode, int LX,
               int flags, void* stream) {
  constexpr MmaTile kT(P, mma_ty(P));
  const size_t smem = (size_t)kT.smem_bytes(P);
  const void* kernel = (const void*)cheb2mma_kernel<P, IBF>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const int TZ = kEZ - 2 * P;
  const dim3 grid((unsigned)ceil_div(g.N, TZ),
                  (unsigned)ceil_div(g.NY + g.YOFF % kT.ty, kT.ty),
                  (unsigned)ceil_div(g.NX, LX));
  cheb2mma_kernel<P, IBF><<<grid, kMmaThreads<P>, smem, (cudaStream_t)stream>>>(
      d, r, x, out0, out1, out2, kb, mb, dk, dm, (float)c0a, (float)c1a,
      (float)c0b, (float)c1b, g.N, g.NX, g.XOFF, g.HD, g.HR, g.NY, g.YOFF,
      g.HDY, g.HRY, mode, LX, flags);
  return (int)cudaGetLastError();
}

template <int P>
int launch_p(const void* d, const void* r, const float* x, void* out0,
             void* out1, float* out2, const float* kb, const float* mb,
             const float* dk, const float* dm, double c0a, double c1a,
             double c0b, double c1b, const March& g, int mode, int LX, int TY,
             int NW, int flags, void* stream) {
  constexpr MmaTile kT(P, mma_ty(P));
  static_assert(kT.ty > 0, "no tensor-core pair tile fits shared memory");
  // the host's tile must be the one this instance was compiled for
  if (TY != kT.ty || NW != kT.nw || LX < 1 || g.NX < 1 || g.NY < 1)
    return (int)cudaErrorInvalidValue;
  return flags & kInBF16
             ? launch_ibf<P, true>(d, r, x, out0, out1, out2, kb, mb, dk, dm,
                                   c0a, c1a, c0b, c1b, g, mode, LX, flags,
                                   stream)
             : launch_ibf<P, false>(d, r, x, out0, out1, out2, kb, mb, dk, dm,
                                    c0a, c1a, c0b, c1b, g, mode, LX, flags,
                                    stream);
}

}  // namespace

// The pair at the production grade (flags must hold kRoundBF16) on the
// tensor cores, with the arguments of pmg_cheb2_f32 (cheb2.cu); (LX, TY,
// NW) the tile of cheb2_mma_tile in ops/cuda_cheb2.py, and ks, K's row
// sums, unread (K is summed directly).
extern "C" int pmg_cheb2mma(const void* d, const void* r, const float* x,
                            void* out0, void* out1, float* out2,
                            const float* kb, const float* mb, const float* ks,
                            const float* dk, const float* dm, float* scratch,
                            double c0a, double c1a, double c0b, double c1b,
                            double theta, int N, int NX, int XOFF, int xext,
                            int NY, int YOFF, int yext, int p, int mode,
                            int LX, int TY, int NW, int flags, void* stream) {
  (void)ks;
  if (!(flags & kRoundBF16)) return (int)cudaErrorInvalidValue;
  March g;
  const int err =
      pair_prologue<float>(d, r, x, dk, dm, scratch, theta, N, NX, XOFF, xext,
                           NY, YOFF, yext, p, mode, flags, g, stream);
  if (err) return err;
  switch (p) {
#define PMG_CASE(PP)                                                      \
  case PP:                                                                \
    return launch_p<PP>(d, r, x, out0, out1, out2, kb, mb, dk, dm, c0a,   \
                        c1a, c0b, c1b, g, mode, LX, TY, NW, flags, stream);
    PMG_CASE(1) PMG_CASE(2) PMG_CASE(3) PMG_CASE(4) PMG_CASE(5) PMG_CASE(6)
    PMG_CASE(7)
#undef PMG_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
