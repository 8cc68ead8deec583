// B.2 — two Chebyshev recurrence steps per pass (temporal blocking).
//
// The kernel template, shared by cheb2.cu (the pair's modes) and
// cheb2lr.cu (cheb2lr), which instantiate it apart so that nvcc builds
// the two sets of instances at once.  Since the wrapper sends the pair at
// the production grade (the mxu core, float only) to the tensor cores
// (cheb2mma.cu), this kernel runs the exact grade, float64 and cheb2lr;
// the pair's production-grade instance stays reachable from pmg_cheb2_f32.
//
// Replaces the TPU kernel portable_multigrid_tpu/ops/pallas_cheb2.py
// Cheb2Kernel.steps2 (modes cheb2, cheb2l, chebd2, chebd2l, cheb2f0,
// cheb2f0l and, on a rout=True kernel, cheb2lr, at its exact=True grade and
// at its production grade, with the recurrence state in float or bf16;
// the pair's modes also on a shard of the slab-sharded solve, xext=True,
// and on a pencil of the 2D-pencil sharded solve, xext=True and
// yext=True: March below).
// On trimmed state it computes
//     r1 = r  - A d      d1 = c0a d  + (c1a / diag) r1
//     r2 = r1 - A d1     d2 = c0b d1 + (c1b / diag) r2
//     x2 = x + d1 + d2
// with A the mask-folded banded operator of laplace.cu.  "l" modes write x2
// only; chebd2* take x == d; cheb2f0* start from the rhs b (passed in the d
// slot): d0 = b / (theta diag), r0 = b, x0 = d0 — chebd2* on (d0, b), d0
// written by a pre-pass (rhs_kernel) into the wrapper's scratch field.
// Every K contraction runs in difference form,
//     (K u)_i = sum_o K[i, i+o] (u_{i+o} - u_i) + s_i u_i,
// s_i the row sum of the trimmed mask-folded K (ksum, taken on the host);
// M stays direct.
//
// The production grade (float only; StateFlags in common.cuh), as
// make_cheb2(..., exact=False): bands rounded to bf16 on the host (the
// "mxu" operator's, K's row sums from the rounded bands) and every
// contraction's input rounded to bf16 — the d window (or d0 of cheb2f0*),
// step two's d1 plane, the z and the y products — with float
// accumulation; the epilogues take r, d and d1 unrounded.  At bf16 state
// d and r are read from bf16 streams and r2, d2 written to them (b and
// the pre-pass's d0 stay float); x and x2 stay float.  A bf16 or rounded
// element comes by a plain load into a register a plane ahead and goes to
// shared memory, converted (and rounded), at the top of the next plane
// (stage_bits and unstage in common.cuh), in a second instance of the
// kernel (BF).
//
// What bounds it on the H100: HBM traffic is 24 B/DoF in f32 for two steps
// (d, r, x in; r2, d2, x2 out), 0.080-0.120 ms at 256^3; but the 14 banded
// products of 2p+1 FMAs per point, the shared-memory operand loads that
// feed them and the latency of the stage chains come first (1.4 ms at
// 256^3, p = 4, on an H100 80GB HBM3 at 700 W), and the overgrowth below
// multiplies them.
//
// Design: an x-marching engine with two rings.  A block owns a y-z column of
// TY x TZ output points (TZ = 32 - 2p, so that the column grown by p in z is
// one warp wide) and marches a chunk of LX output planes along x.  Step two
// needs d1 within p of every output point, so step one runs on the column
// grown by p in y and z (EY = TY + 2p rows of 32), and the chunk's input
// planes run from x0 - 2p to x0 + LX + 2p.  For each input plane x_in:
//   1. the d window (2p halo in y and z, zeros off the grid) arrives by
//      cp.async a plane ahead, with the epilogues' inputs (r and d at the
//      x1 below, x at the x2, the x rows of K, M and the diagonal);
//   2. step one's z stage (K, M along z) and y stage give the two y-z
//      products the x stage needs (My Mz d and Ky Mz d + My Kz d, the split
//      of march.cuh) on the grown column, into ring 1 (2p+1 planes);
//   3. once x_in is in ring 1, the x contraction gives r1 and d1 at plane
//      x1 = x_in - p on the grown column; d1 goes to a plane buffer, and the
//      interior r1, d1 into a lag ring of p+1 planes;
//   4. step two's z stage of that d1 plane, then its y stage on the
//      interior, into ring 2 (2p+1 planes); once d1 plane x2 + p is in, the
//      x contraction gives r2, d2 and x2 at plane x2 = x1 - p, and the
//      epilogue writes them to HBM.
// Every input plane goes through step one once; only the chunk's 4p
// lead-in planes are recomputed, and the y-z overgrowth is 2p (1.9x the
// FMAs of two plain steps at p = 4, TY = 16, against 6x for a 3D halo).
// A thread keeps its z row (its lane of the grown column) and its two y
// rows (round robin over the warps, interior rows first) for the whole
// march, so their bands and row sums stay in registers; every ring entry,
// the d1 plane row of its own warp and the lag ring are private to the
// thread or warp that reads them.  The stages are skewed by a plane (step
// one's y and x stages run an iteration after its z stage, step two's y
// and x stages an iteration after its z stage), with three windows and two
// sets of z products in flight, so a plane costs one block barrier.  The
// tile (TY, warps) is a compile-time function of p and the type that
// ops/cuda_cheb2.py mirrors (cheb2_tile); every p = 1..7 fits one block of
// shared memory in both types.  One block per SM: in f32 at p = 4 a block
// of 12 warps over TY = 16 beat two blocks of 8 warps over TY = 8 (less
// overgrowth, the same warps).
//
// cheb2lr (pallas_cheb2.py:120-129, 409-418) ends the recurrence with a
// pair and also gives the next V-cycle residual, r_out = r2 - A d2, at the
// pair's grade from r2 as the pair holds it (never rounded); it writes x2
// and r_out in T.  It runs the same march with a third stage (template
// ROUT, so that the pair instances keep their tiles and registers): step
// one on the column grown by 2p (TZ = 32 - 4p interior lanes; the d window
// has a 3p halo and the chunk 3p lead-in planes a side), step two on the
// column grown by p, where it gives x2 on the interior and the d2 plane
// with its z products (lanes p .. 31 - p, rounded at the bf16 grade), and
// step three's y stage into ring 3 on the interior, whose x stage at
// x3 = x2 - p subtracts A d2 from r2 kept in a lag ring of p+1 planes.  A
// plane still costs one block barrier.  Its shared memory (three rings)
// admits p <= 5 in float and p <= 3 in double; the host refuses the
// others (cheb2_tile).
#pragma once

#include "march.cuh"

namespace {

using namespace pmg;

enum Mode { kCheb2 = 0, kCheb2L = 1, kChebD2 = 2, kChebD2L = 3, kF0 = 4,
            kF0L = 5, kCheb2LR = 6 };

// stencil applications a pass: the pair's two, and r_out's with ROUT
template <bool ROUT>
constexpr int kStages = ROUT ? 3 : 2;

// shared-memory elements of a block with TY interior rows and S stencil
// applications; must match cheb2_smem_elems() in ops/cuda_cheb2.py.  Step
// one runs on the column grown by G = (S - 1) p (EY rows), step two on the
// column grown by G - p (E2 rows).  Layout: three d windows [3][WY][WZ],
// two sets of step one's z products [2][2][WY][32], ring 1 [R][2][EY][32],
// the d1 plane [EY][32], two sets of step two's z products [2][2][EY][32],
// ring 2 [R][2][E2][32], the lag ring [p+1][2][E2][32]; the epilogues'
// inputs r and d [2][2][EY][32] and x [2][TY][32], three sets of the x
// rows of the S stages [3][S][xrow_elems]; with S = 3 the d2 plane
// [E2][32], two sets of step three's z products [2][2][E2][32], ring 3
// [R][2][TY][32] and the lag ring of r2 [p+1][TY][32].
__host__ __device__ constexpr int64_t smem_elems(int p, int ty, int S) {
  const int64_t R = 2 * p + 1, G = (S - 1) * p, WY = ty + 2 * G + 2 * p,
                WZ = kEZ + 2 * p, EY = ty + 2 * G, E2 = EY - 2 * p;
  return 3 * WY * WZ + 4 * WY * kEZ + R * 2 * EY * kEZ + EY * kEZ +
         4 * EY * kEZ + R * 2 * E2 * kEZ + (p + 1) * 2 * E2 * kEZ +
         4 * EY * kEZ + 2 * ty * kEZ + 3 * S * xrow_elems(p) +
         (S == 3 ? E2 * kEZ + 4 * E2 * kEZ + R * 2 * ty * kEZ +
                       (p + 1) * ty * kEZ
                 : 0);
}

// TY: the largest candidate whose TY + 2G grown rows the warps can own,
// two each, and whose buffers fit the block (one block per SM); 0 where
// none fits (the ROUT instance at p >= 6 in float, p >= 4 in double)
template <typename T, int P, bool ROUT>
__host__ __device__ constexpr int tile_ty() {
  constexpr int S = kStages<ROUT>;
  const int cand[6] = {16, 8, 6, 4, 2, 1};
  for (int k = 0; k < 6; ++k) {
    const int ty = cand[k];
    if (ty + 2 * (S - 1) * P <= 2 * march_warps<T>() &&
        smem_elems(P, ty, S) * (int64_t)sizeof(T) <= kSmemLimit)
      return ty;
  }
  return 0;
}

// warps: two grown rows each
template <typename T, int P, bool ROUT>
__host__ __device__ constexpr int tile_warps() {
  return (tile_ty<T, P, ROUT>() + 2 * (kStages<ROUT> - 1) * P + 1) / 2;
}

template <typename T, int P, bool ROUT>
constexpr int kPairThreads = tile_warps<T, P, ROUT>() * 32;

// BF: the instance of the bf16 grade (float only): the window (bf16 or
// rounded) and the bf16 r, d and x (= d) of the epilogues travel through
// registers (stage_bits); the other instance moves every stream by
// cp.async and at most stores r2 and d2 in bf16.  ROUT: the cheb2lr
// instance (S = 3): step one on the column grown by 2p, step two on the
// column grown by p, which gives x2 on the interior and the d2 plane of
// step three, the residual r_out = r2 - A d2 on the interior.
template <typename T, int P, bool BF, bool ROUT>
__global__ void __launch_bounds__(kPairThreads<T, P, ROUT>, 1)
cheb2_kernel(const void* __restrict__ d, const void* __restrict__ r,
             const T* __restrict__ x, void* __restrict__ out0,
             void* __restrict__ out1, T* __restrict__ out2,
             const T* __restrict__ kb, const T* __restrict__ mb,
             const T* __restrict__ ks, const T* __restrict__ dk,
             const T* __restrict__ dm, T c0a, T c1a, T c0b, T c1b, int N_,
             int NX_, int XOFF_, int HD, int HR, int NY_, int YOFF_, int HDY,
             int HRY, int mode, int LX, int flags) {
  constexpr int S = kStages<ROUT>, R = 2 * P + 1;
  constexpr int TY = tile_ty<T, P, ROUT>(), NW = tile_warps<T, P, ROUT>();
  constexpr int G = (S - 1) * P;  // step one's growth of the column
  constexpr int WY = TY + 2 * G + 2 * P, WZ = kEZ + 2 * P, EY = TY + 2 * G;
  constexpr int E2 = EY - 2 * P;  // step two's rows
  constexpr int TZ = kEZ - 2 * G;
  constexpr int R1 = (EY + NW - 1) / NW;  // grown rows a warp owns
  constexpr int XH = xrow_elems(P);  // an x row: K, M, K's row sum, dK, dM
  static_assert(3 * WY * WZ * sizeof(T) % 16 == 0, "x rows 16-byte aligned");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* win = reinterpret_cast<T*>(smem_raw);  // [3][WY][WZ]
  T* zb1 = win + 3 * WY * WZ;               // [2][2][WY][32]  Kz d, Mz d
  T* ring1 = zb1 + 4 * WY * kEZ;            // [R][2][EY][32]
  T* d1p = ring1 + R * 2 * EY * kEZ;        // [EY][32]
  T* zb2 = d1p + EY * kEZ;                  // [2][2][EY][32]  Kz d1, Mz d1
  T* ring2 = zb2 + 4 * EY * kEZ;            // [R][2][E2][32]
  T* lag = ring2 + R * 2 * E2 * kEZ;        // [P+1][2][E2][32]  r1, d1
  T* rbuf = lag + (P + 1) * 2 * E2 * kEZ;   // [2][EY][32]  r (b) at x1
  T* dbuf = rbuf + 2 * EY * kEZ;            // [2][EY][32]  d at x1
  T* xbuf = dbuf + 2 * EY * kEZ;            // [2][TY][32]  x (d, b) at x2
  T* xrow = xbuf + 2 * TY * kEZ;            // [3][S][XH]   rows x1, x2, x3
  T* d2p = xrow + 3 * S * XH;               // ROUT: [E2][32]
  T* zb3 = d2p + E2 * kEZ;                  // ROUT: [2][2][E2][32]
  T* ring3 = zb3 + 4 * E2 * kEZ;            // ROUT: [R][2][TY][32]
  T* lag2 = ring3 + R * 2 * TY * kEZ;       // ROUT: [P+1][TY][32]  r2
  // the grid is N^3; the block marches local x planes, NX of them from
  // global plane XOFF, over the NY local y rows from global row YOFF, and
  // d (r) carries HD (HR) planes and HDY (HRY) rows of halo a side
  const int64_t N = N_, NX = NX_, XOFF = XOFF_, NY = NY_, YOFF = YOFF_;
  const int64_t DY = NY + 2 * HDY, RY = NY + 2 * HRY;  // d's and r's rows
  const int lane = threadIdx.x % kEZ, w = threadIdx.x / kEZ;
  const int64_t z0 = (int64_t)blockIdx.x * TZ, y0 = (int64_t)blockIdx.y * TY;
  const int64_t x0 = (int64_t)blockIdx.z * LX;
  const int64_t xend = x0 + LX < NX ? x0 + LX : NX;
  // local plane x lies on the grid
  auto on_grid = [&](int64_t xl) { return XOFF + xl >= 0 && XOFF + xl < N; };
  // local row y lies on the grid
  auto on_grid_y = [&](int64_t yl) {
    return YOFF + yl >= 0 && YOFF + yl < N;
  };
  const int64_t xs = x0 - G - P, xe = xend + G + P;
  const int64_t gz = z0 - G + lane;  // the thread's z row, all march long
  const bool zok = gz >= 0 && gz < N;
  const bool last = mode == kCheb2L || mode == kChebD2L;
  // d and r stored in bf16; r2 and d2 stored in bf16; the bf16 operator
  // grade: every contraction's input rounded to bf16 (StateFlags)
  const bool ibf = BF && (flags & kInBF16), obf = flags & kOutBF16,
             rnd = BF && (flags & kRoundBF16);
  // x on entry: x itself (cheb2*), else d, in d's storage
  const bool x_is_x = ROUT || mode == kCheb2 || mode == kCheb2L;
  const void* xsrc = x_is_x ? static_cast<const void*>(x) : d;
  const bool xbf = !x_is_x && ibf;
  // the registers of the window (KR rows x KC columns a thread) and of the
  // epilogues' bf16 r, d (grown rows) and x (interior rows), in flight from
  // one plane to the next
  constexpr int KR = (WY + NW - 1) / NW, KC = (WZ + kEZ - 1) / kEZ;
  uint32_t sw[BF ? KR : 1][BF ? KC : 1], se[BF ? 3 : 1][BF ? R1 : 1];
  // the lanes of step two (P .. 31 - P) and of the interior (G .. 31 - G)
  const bool lane2 = lane >= P && lane < kEZ - P;
  const bool lane_in = lane >= G && lane < kEZ - G;

  // grown rows of this warp: q = w + j NW in the order interior rows
  // (q < TY: row G + q), then the 2P rows of each halo band k = 0 .. S - 2
  // around them, inner first; -1 past the column.  Row e lies y0 - G + e
  // on the grid; the rows q < E2 are step two's, q < TY the interior.
  // The local row y0 - G + e lies YOFF rows further on the grid.  The
  // diagonal at (x, y, z) is dK_x ay + dM_x by with the y-z factors below.
  int ey[R1];
  Row<T, P> yr[R1];
  T ay[R1], by[R1];
#pragma unroll
  for (int j = 0; j < R1; ++j) {
    const int q = w + j * NW, h = q - TY;
    if constexpr (ROUT) {
      // band k of the halo, row hk of its 2P
      const int k = h / (2 * P), hk = h % (2 * P);
      ey[j] = q >= EY  ? -1
              : q < TY ? G + q
              : hk < P ? G - (k + 1) * P + hk
                       : TY + G + (k - 1) * P + hk;
    } else {
      ey[j] = q >= EY ? -1 : q < TY ? P + q : h < P ? h : h + TY;
    }
    const int64_t gy = ey[j] < 0 ? -1 : YOFF + y0 - G + ey[j];
    yr[j].load(kb, mb, ks, N, gy);
    const bool ok = zok && gy >= 0 && gy < N;
    ay[j] = ok ? dm[gy] * dm[gz] : T(0);
    by[j] = ok ? dk[gy] * dm[gz] + dm[gy] * dk[gz] : T(0);
  }
  Row<T, P> zr;
  zr.load(kb, mb, ks, N, gz);
  // everything the iteration of input plane xn reads from global memory,
  // by cp.async (zeros off the grid): the d window of xn; r (b) and d at
  // step one's x1 = xn - 1 - P on the thread's grown points and x (d, b)
  // at step two's x2 = xn - 2 - 2P on its interior points, into buffer b;
  // the K, M rows, K row sums and diagonal factors of x1, x2 (and of step
  // three's x3 = xn - 3 - 3P)
  const T* dT = static_cast<const T*>(d);
  const T* rT = static_cast<const T*>(r);
  // local row y of d (of r) on the grid and within its halo; rows past
  // the halo feed only rows past the march's last, never written
  auto d_row = [&](int64_t yl) {
    return on_grid_y(yl) && yl >= -HDY && yl < NY + HDY;
  };
  auto r_row = [&](int64_t yl) {
    return on_grid_y(yl) && yl >= -HRY && yl < NY + HRY;
  };
  auto load_plane = [&](int64_t xn, int b) {
    if (xn < xe) {
      const bool xok = on_grid(xn);
      if constexpr (BF) {
#pragma unroll
        for (int k = 0; k < KR; ++k) {
          const int rw = w + k * NW;
          const int64_t yy = y0 - G - P + rw;
          const bool yok = xok && rw < WY && d_row(yy);
#pragma unroll
          for (int kc = 0; kc < KC; ++kc) {
            const int64_t zz = z0 - G - P + lane + kc * kEZ;
            sw[k][kc] = stage_bits(d, ((xn + HD) * DY + yy + HDY) * N + zz,
                                   yok && zz >= 0 && zz < N, ibf);
          }
        }
      } else {
        T* dst = win + (int)((xn - xs) % 3) * WY * WZ;
        for (int rw = w; rw < WY; rw += NW) {
          const int64_t yy = y0 - G - P + rw;
          const bool yok = xok && d_row(yy);
          for (int c = lane; c < WZ; c += kEZ) {
            const int64_t zz = z0 - G - P + c;
            const bool ok = yok && zz >= 0 && zz < N;
            cp_async_elem(
                dst + rw * WZ + c,
                ok ? dT + ((xn + HD) * DY + yy + HDY) * N + zz : dT, ok);
          }
        }
      }
    }
    const int64_t x1 = xn - 1 - P, x2 = xn - 2 - 2 * P;
    if (xn <= xe && x1 >= x0 - G && on_grid(x1)) {
#pragma unroll
      for (int j = 0; j < R1; ++j) {
        if (ey[j] < 0) continue;
        const int64_t yl = y0 - G + ey[j];
        const bool okr = zok && r_row(yl), okd = zok && d_row(yl);
        const int64_t gr = ((x1 + HR) * RY + yl + HRY) * N + gz;
        const int64_t gd = ((x1 + HD) * DY + yl + HDY) * N + gz;
        const int e = (b * EY + ey[j]) * kEZ + lane;
        // the epilogues' r and d as stored, never rounded
        if (ibf) {
          if constexpr (BF) {
            se[0][j] = stage_bits(r, gr, okr, true);
            se[1][j] = stage_bits(d, gd, okd, true);
          }
        } else {
          cp_async_elem(rbuf + e, okr ? rT + gr : rT, okr);
          cp_async_elem(dbuf + e, okd ? dT + gd : dT, okd);
        }
      }
    }
    if (lane_in && zok && x2 >= x0 && x2 < xend) {
#pragma unroll
      for (int j = 0; j < R1; ++j) {
        const int q = w + j * NW;
        if (q < TY && y0 + q < NY) {
          const int64_t g =
              x_is_x ? (x2 * NY + y0 + q) * N + gz
                     : ((x2 + HD) * DY + y0 + q + HDY) * N + gz;
          if (xbf) {
            if constexpr (BF) se[2][j] = stage_bits(xsrc, g, true, true);
          } else {
            cp_async_elem(xbuf + (b * TY + q) * kEZ + lane,
                          static_cast<const T*>(xsrc) + g, true);
          }
        }
      }
    }
    if (w == NW - 1) {
      // the rows of x1, x2 (and x3)
      T* xr = xrow + (int)((xn - xs) % 3) * S * XH;
      for (int e = lane; e < S * XH; e += kEZ) {
        const int k = e % XH;
        const int64_t row =
            e < XH ? x1 : !ROUT || e < 2 * XH ? x2 : xn - 3 - 3 * P;
        const T* src;
        if (k < R) {
          src = kb + k * N;
        } else if (k < 2 * R) {
          src = mb + (k - R) * N;
        } else if (k <= 2 * R + 2) {
          src = k == 2 * R ? ks : k == 2 * R + 1 ? dk : dm;
        } else {
          continue;
        }
        const bool ok = on_grid(row);
        cp_async_elem(xr + e, ok ? src + XOFF + row : src, ok);
      }
    }
    cp_async_commit();
  };
  // the staging registers of plane xn into its window and buffer b (the
  // guards of load_plane)
  auto put_plane = [&](int64_t xn, int b) {
    if constexpr (BF) {
      if (xn < xe) {
        T* dst = win + (int)((xn - xs) % 3) * WY * WZ;
#pragma unroll
        for (int k = 0; k < KR; ++k) {
          const int rw = w + k * NW;
#pragma unroll
          for (int kc = 0; kc < KC; ++kc) {
            const int c = lane + kc * kEZ;
            if (rw < WY && c < WZ)
              dst[rw * WZ + c] = unstage(sw[k][kc], ibf, rnd);
          }
        }
      }
      const int64_t x1 = xn - 1 - P, x2 = xn - 2 - 2 * P;
      if (ibf && xn <= xe && x1 >= x0 - G && on_grid(x1)) {
#pragma unroll
        for (int j = 0; j < R1; ++j) {
          if (ey[j] < 0) continue;
          const int e = (b * EY + ey[j]) * kEZ + lane;
          rbuf[e] = unstage(se[0][j], true, false);
          dbuf[e] = unstage(se[1][j], true, false);
        }
      }
      if (xbf && lane_in && zok && x2 >= x0 && x2 < xend) {
#pragma unroll
        for (int j = 0; j < R1; ++j) {
          const int q = w + j * NW;
          if (q < TY && y0 + q < NY)
            xbuf[(b * TY + q) * kEZ + lane] = unstage(se[2][j], true, false);
        }
      }
    }
  };
  // The march, one block barrier a plane.  Iteration xin runs, on data
  // the last iteration left behind the barrier: with ROUT step three of d2
  // plane xin - 3 - 2P (y stage into ring 3, then r_out at
  // x3 = xin - 3 - 3P); step two of d1 plane xin - 2 - P (y stage into
  // ring 2, then r2, d2 and x2 at x2 = xin - 2 - 2P, and with ROUT step
  // three's z stage of that d2 plane); step one's z stage of input plane
  // xin; step one's y stage of plane xin - 1 into ring 1, its x stage and
  // epilogue at x1 = xin - 1 - P and step two's z stage of d1 plane x1.
  // The windows cycle through three buffers and the z products through
  // two, so that no stage overwrites what a slower warp may still read.
  // Stage s gives planes x0 - (S - s) P .. xend + (S - s) P, the lead-in
  // of the next.  The registers staged for plane xin + 1 land in shared
  // memory at the top of the next iteration, before its barrier.  Each
  // ring and lag slot is a fixed function of its plane, modulo the ring's
  // length.
  load_plane(xs, 0);
  put_plane(xs, 0);
  for (int64_t xin = xs; xin <= xe + S - 1; ++xin) {
    const int i = (int)(xin - xs), b = i & 1;
    if (xin > xs) put_plane(xin, b);
    const T* xr1 = xrow + (i % 3) * S * XH;  // rows of x1, x2 and x3
    if (xin < xe + S - 1) {
      load_plane(xin + 1, b ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // ---- step three of d2 plane x2 = xin - 3 - 2P: r_out at x3
    if constexpr (ROUT) {
      const int64_t x2 = xin - 3 - 2 * P, x3 = x2 - P;
      if (lane_in && x2 >= x0 - P && x2 < xend + P) {
        const T* zk = zb3 + (int)(x2 & 1) * 2 * E2 * kEZ;
        const bool out_x = x3 >= x0 && x3 < xend && zok;
        Row<T, P> xr;
        T dkx, dmx;
        xr.load_smem(xr1 + 2 * XH, dkx, dmx);
        const int s3 = (int)((x2 - xs) % R);
        const int base = (int)((x3 - P - xs + R) % R);
        const int ls = (int)((x3 - x0 + G + P + 1) % (P + 1));
#pragma unroll
        for (int j = 0; j < R1; ++j) {
          const int q = w + j * NW;
          if (q >= TY) continue;
          T mbv, sv;
          contract_y<T, P>(&yr[j], zk + q * kEZ + lane,
                           zk + (E2 + q) * kEZ + lane, &mbv, &sv);
          T* slot = ring3 + s3 * 2 * TY * kEZ + q * kEZ + lane;
          slot[0] = rnd ? round_bf16(mbv) : mbv;
          slot[TY * kEZ] = rnd ? round_bf16(sv) : sv;
          if (!out_x || y0 + q >= NY) continue;
          const T raw = contract_x<T, P>(xr, ring3 + q * kEZ + lane,
                                         2 * TY * kEZ, TY * kEZ, base);
          const int64_t g = (x3 * NY + y0 + q) * N + gz;
          static_cast<T*>(out1)[g] =
              lag2[(ls * TY + q) * kEZ + lane] - raw;
        }
      }
    }

    // ---- step two of d1 plane x1 = xin - 2 - P: r2, d2 at x2
    {
      const int64_t x1 = xin - 2 - P, x2 = x1 - P;
      if constexpr (!ROUT) {
        if (lane_in && x1 >= x0 - P && x1 < xend + P) {
          const T* zk = zb2 + (int)(x1 & 1) * 2 * EY * kEZ;
          const bool out_x = x2 >= x0 && x2 < xend && zok;
          Row<T, P> xr;
          T dkx, dmx;
          xr.load_smem(xr1 + XH, dkx, dmx);
          const int s2 = (int)((x1 - x0 + P) % R);
          // ring 2 and lag slots of plane x2 (x2 >= x0 - 2P; used for x2 >= x0)
          const int base = (int)((x2 - x0 + R) % R);
          const int ls = (int)((x2 - x0 + 3 * P + 2) % (P + 1));
#pragma unroll
          for (int j = 0; j < R1; ++j) {
            const int q = w + j * NW;
            if (q >= TY) continue;
            T mbv, sv;
            contract_y<T, P>(&yr[j], zk + q * kEZ + lane,
                             zk + (EY + q) * kEZ + lane, &mbv, &sv);
            T* slot = ring2 + s2 * 2 * TY * kEZ + q * kEZ + lane;
            slot[0] = rnd ? round_bf16(mbv) : mbv;
            slot[TY * kEZ] = rnd ? round_bf16(sv) : sv;
            if (!out_x || y0 + q >= NY) continue;
            const T raw = contract_x<T, P>(xr, ring2 + q * kEZ + lane,
                                           2 * TY * kEZ, TY * kEZ, base);
            const T* lg = lag + ls * 2 * TY * kEZ + q * kEZ + lane;
            const T r1 = lg[0], d1 = lg[TY * kEZ];
            const int64_t g = (x2 * NY + y0 + q) * N + gz;
            const T diag = dkx * ay[j] + dmx * by[j];
            const T r2 = r1 - raw;
            const T d2 = c0b * d1 + (c1b / diag) * r2;
            T xv = xbuf[(b * TY + q) * kEZ + lane];
            const T x2v = xv + d1 + d2;
            if (last) {
              static_cast<T*>(out0)[g] = x2v;
            } else {
              store_state(out0, g, r2, obf);
              store_state(out1, g, d2, obf);
              out2[g] = x2v;
            }
          }
        }
      } else {
        if (lane2 && x1 >= x0 - G && x1 < xend + G) {
          const T* zk = zb2 + (int)(x1 & 1) * 2 * EY * kEZ;
          // the planes of step two: the interior's, and step three's lead-in
          const bool out_x = x2 >= x0 - (G - P) && x2 < xend + (G - P);
          const bool x_in = x2 >= x0 && x2 < xend;
          Row<T, P> xr;
          T dkx, dmx;
          xr.load_smem(xr1 + XH, dkx, dmx);
          const int s2 = (int)((x1 - xs) % R);
          const int base = (int)((x2 - P - xs + R) % R);
          const int ls = (int)((x2 - x0 + G + P + 1) % (P + 1));
#pragma unroll
          for (int j = 0; j < R1; ++j) {
            const int q = w + j * NW;
            if (q >= E2) continue;
            const int e2 = ey[j] - P;  // the row in step two's column
            T mbv, sv;
            contract_y<T, P>(&yr[j], zk + e2 * kEZ + lane,
                             zk + (EY + e2) * kEZ + lane, &mbv, &sv);
            T* slot = ring2 + s2 * 2 * E2 * kEZ + e2 * kEZ + lane;
            slot[0] = rnd ? round_bf16(mbv) : mbv;
            slot[E2 * kEZ] = rnd ? round_bf16(sv) : sv;
            if (!out_x) continue;
            const int64_t yl = y0 - G + ey[j];
            T r2 = T(0), d2 = T(0);
            if (on_grid(x2) && on_grid_y(yl) && zok) {
              const T raw = contract_x<T, P>(xr, ring2 + e2 * kEZ + lane,
                                             2 * E2 * kEZ, E2 * kEZ, base);
              const T* lg = lag + ls * 2 * E2 * kEZ + e2 * kEZ + lane;
              const T r1 = lg[0], d1 = lg[E2 * kEZ];
              const T diag = dkx * ay[j] + dmx * by[j];
              r2 = r1 - raw;
              d2 = c0b * d1 + (c1b / diag) * r2;
              // x2 final on the interior; r2 kept for step three
              if (x_in && q < TY && lane_in && yl < NY) {
                const int64_t g = (x2 * NY + yl) * N + gz;
                static_cast<T*>(out0)[g] =
                    xbuf[(b * TY + q) * kEZ + lane] + d1 + d2;
                lag2[(ls * TY + q) * kEZ + lane] = r2;
              }
            }
            // step three's stencil input (rounded at the bf16 grade)
            d2p[e2 * kEZ + lane] = rnd ? round_bf16(d2) : d2;
          }
        }
        // step three's z stage of d2 plane x2 on the warp's own rows (the
        // interior lanes; their taps are lanes of the same warp)
        if (x2 >= x0 - P && x2 < xend + P) {
          __syncwarp();
          if (lane_in) {
            T* zo = zb3 + (int)(x2 & 1) * 2 * E2 * kEZ;
#pragma unroll
            for (int j = 0; j < R1; ++j) {
              if (w + j * NW >= E2) continue;
              const int e2 = ey[j] - P;
              T ak, am;
              contract_km<T, P>(zr, d2p + e2 * kEZ + lane - P, ak, am);
              if (rnd) {
                ak = round_bf16(ak);
                am = round_bf16(am);
              }
              zo[e2 * kEZ + lane] = ak;
              zo[(E2 + e2) * kEZ + lane] = am;
            }
          }
        }
      }
    }

    // ---- step one's z stage of input plane xin
    if (xin < xe) {
      const T* buf = win + (i % 3) * WY * WZ;
      T* zo = zb1 + b * 2 * WY * kEZ;
#pragma unroll
      for (int k = 0; k < (WY + NW - 1) / NW; ++k) {
        const int rw = w + k * NW;
        if (rw >= WY) break;
        T ak, am;
        contract_km<T, P>(zr, buf + rw * WZ + lane, ak, am);
        if (rnd) {
          ak = round_bf16(ak);
          am = round_bf16(am);
        }
        zo[rw * kEZ + lane] = ak;
        zo[(WY + rw) * kEZ + lane] = am;
      }
    }

    // ---- step one's y stage of plane xin - 1, its x stage at x1
    if (xin - 1 < xs || xin - 1 >= xe) continue;
    const T* zi = zb1 + (b ^ 1) * 2 * WY * kEZ;
    T* r1slot = ring1 + ((i - 1) % R) * 2 * EY * kEZ;
#pragma unroll
    for (int j = 0; j < R1; ++j) {
      if (ey[j] < 0) continue;
      T mbv, sv;
      contract_y<T, P>(&yr[j], zi + ey[j] * kEZ + lane,
                       zi + (WY + ey[j]) * kEZ + lane, &mbv, &sv);
      r1slot[ey[j] * kEZ + lane] = rnd ? round_bf16(mbv) : mbv;
      r1slot[(EY + ey[j]) * kEZ + lane] = rnd ? round_bf16(sv) : sv;
    }
    const int64_t x1 = xin - 1 - P;
    if (x1 < x0 - G) continue;
    // r1, d1 at plane x1 on the grown rows (zero off the grid)
    const bool xok = on_grid(x1);
    Row<T, P> xr;
    T dkx, dmx;
    xr.load_smem(xr1, dkx, dmx);
    const int base = (int)((x1 - P - xs) % R);
    const int lslot = (int)((x1 - x0 + G) % (P + 1));
#pragma unroll
    for (int j = 0; j < R1; ++j) {
      if (ey[j] < 0) continue;
      T r1 = T(0), d1 = T(0);
      if (xok && on_grid_y(y0 - G + ey[j]) && zok) {
        const T raw = contract_x<T, P>(xr, ring1 + ey[j] * kEZ + lane,
                                       2 * EY * kEZ, EY * kEZ, base);
        const int e = (b * EY + ey[j]) * kEZ + lane;
        const T diag = dkx * ay[j] + dmx * by[j];
        const T rE = rbuf[e];
        const T dE = dbuf[e];
        r1 = rE - raw;
        d1 = c0a * dE + (c1a / diag) * r1;
      }
      // step two's stencil input (rounded at the bf16 grade); the lag ring
      // keeps d1 itself for step two's epilogue
      d1p[ey[j] * kEZ + lane] = rnd ? round_bf16(d1) : d1;
      // the lag ring on step two's rows (row q; ey - P with ROUT)
      const int q = w + j * NW;
      if (q < E2 && lane2) {
        T* lg = lag + lslot * 2 * E2 * kEZ + (ROUT ? ey[j] - P : q) * kEZ +
                lane;
        lg[0] = r1;
        lg[E2 * kEZ] = d1;
      }
    }
    // step two's z stage of d1 plane x1 on the warp's own rows (step two's
    // lanes; their taps are lanes of the same warp)
    __syncwarp();
    if (lane2) {
      T* zo = zb2 + (int)(x1 & 1) * 2 * EY * kEZ;
#pragma unroll
      for (int j = 0; j < R1; ++j) {
        if (ey[j] < 0) continue;
        T ak, am;
        contract_km<T, P>(zr, d1p + ey[j] * kEZ + lane - P, ak, am);
        if (rnd) {
          ak = round_bf16(ak);
          am = round_bf16(am);
        }
        zo[ey[j] * kEZ + lane] = ak;
        zo[(EY + ey[j]) * kEZ + lane] = am;
      }
    }
  }
}

// Where a launch marches: the grid is N^3; the block grid covers NX local
// x planes from global plane XOFF and NY local y rows from global row
// YOFF, and d (r) arrives with HD (HR) planes and HDY (HRY) rows of halo a
// side.  The cube: NX = NY = N, XOFF = YOFF = 0, no halo.  A shard of the
// slab-sharded solve (the TPU kernel's xext=True, pallas_cheb2.py:142-151):
// NX = n_loc p, XOFF its first plane, and d and r extended by the
// neighbours' planes (zeros at the global ends), 2p and p a side; the x
// rows are the global ones, read at the shard's offset, so every output is
// the single-device pair's at the same plane.  A pencil of the 2D-pencil
// solve (xext and yext, pallas_cheb2.py:152-160) does the same along y as
// well: NY = n_loc_y p rows from YOFF, d and r extended by 2p and p rows a
// side (the TPU kernel's 8-rounded y halos are a lane rule of its own),
// and every thread's y rows are the global rows YOFF + its local ones.
struct March {
  int N, NX, XOFF, HD, HR, NY, YOFF, HDY, HRY;
};

template <typename T, int P, bool BF, bool ROUT>
int launch_p(const void* d, const void* r, const T* x, void* out0, void* out1,
             T* out2, const T* kb, const T* mb, const T* ks, const T* dk,
             const T* dm, double c0a, double c1a, double c0b, double c1b,
             const March& g, int mode, int LX, int TY, int NW, int flags,
             void* stream) {
  constexpr int kTY = tile_ty<T, P, ROUT>(), kNW = tile_warps<T, P, ROUT>();
  static_assert(kTY > 0, "no pair tile fits shared memory");
  // the host's tile must be the one this instance was compiled for
  if (TY != kTY || NW != kNW || LX < 1 || g.NX < 1 || g.NY < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      (size_t)smem_elems(P, kTY, kStages<ROUT>) * sizeof(T);
  const void* kernel = (const void*)cheb2_kernel<T, P, BF, ROUT>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const int TZ = kEZ - 2 * (kStages<ROUT> - 1) * P;
  const dim3 grid((unsigned)ceil_div(g.N, TZ), (unsigned)ceil_div(g.NY, kTY),
                  (unsigned)ceil_div(g.NX, LX));
  cheb2_kernel<T, P, BF, ROUT>
      <<<grid, kPairThreads<T, P, ROUT>, smem, (cudaStream_t)stream>>>(
          d, r, x, out0, out1, out2, kb, mb, ks, dk, dm, (T)c0a, (T)c1a,
          (T)c0b, (T)c1b, g.N, g.NX, g.XOFF, g.HD, g.HR, g.NY, g.YOFF, g.HDY,
          g.HRY, mode, LX, flags);
  return (int)cudaGetLastError();
}

// the bf16 grade's instance where a stream goes through registers
template <typename T, int P, bool ROUT>
int launch_grade(const void* d, const void* r, const T* x, void* out0,
                 void* out1, T* out2, const T* kb, const T* mb, const T* ks,
                 const T* dk, const T* dm, double c0a, double c1a,
                 double c0b, double c1b, const March& g, int mode, int LX,
                 int TY, int NW, int flags, void* stream) {
  if constexpr (sizeof(T) == 4) {
    if (flags & (kInBF16 | kRoundBF16))
      return launch_p<T, P, true, ROUT>(d, r, x, out0, out1, out2, kb, mb,
                                        ks, dk, dm, c0a, c1a, c0b, c1b, g,
                                        mode, LX, TY, NW, flags, stream);
  }
  return launch_p<T, P, false, ROUT>(d, r, x, out0, out1, out2, kb, mb, ks,
                                     dk, dm, c0a, c1a, c0b, c1b, g, mode, LX,
                                     TY, NW, flags, stream);
}

// The cheb2f0 pre-pass: d0 = b / (theta diag) on the trimmed grid, one
// block per (x, y) row, the threads along z; the array has DY rows a
// plane, its first x plane is global plane X0 and its first row global row
// Y0 (a shard's extended b starts 2p planes before its own, a pencil's
// also 2p rows before its own), and d0 is zero off the grid.  An
// elementwise HBM pass (8 B a point in f32); it takes the b / (theta diag)
// of every window point out of the marching kernel, which would repeat it
// for each of the 3-4 windows that hold the point.
template <typename T>
__global__ void __launch_bounds__(kThreads)
rhs_kernel(const T* __restrict__ b, T* __restrict__ d0,
           const T* __restrict__ dk, const T* __restrict__ dm, T theta,
           int N_, int X0, int DY, int Y0) {
  const int64_t N = N_, row = blockIdx.x, gx = X0 + row / DY,
                gy = Y0 + row % DY;
  const bool on = gx >= 0 && gx < N && gy >= 0 && gy < N;
  for (int64_t gz = threadIdx.x; gz < N; gz += blockDim.x) {
    const int64_t g = row * N + gz;
    d0[g] = on ? b[g] / (theta * diag_at(dk, dm, gx, gy, gz)) : T(0);
  }
}

// The pair's launch prologue, shared by both engines (cheb2.cu and
// cheb2mma.cu): checks the mode and the march and fills g.  xext: the
// shard's march of NX planes from global plane XOFF, with d and x (= d)
// extended by 2p planes a side and r by p (by 2p for cheb2f0*, where r is
// b).  yext: likewise over NY rows from global row YOFF, with 2p and p rows
// a side.  cheb2f0* becomes chebd2* on d = b / (theta diag), written by the
// pre-pass into scratch, and r = b.  Returns a CUDA error code, 0 on
// success.
template <typename T>
int pair_prologue(const void*& d, const void*& r, const T*& x,
                  const T* dk, const T* dm, T* scratch, double theta, int N,
                  int NX, int XOFF, int xext, int NY, int YOFF, int yext,
                  int p, int& mode, int flags, March& g, void* stream) {
  if (mode < kCheb2 || mode > kF0L || (!xext && (NX != N || XOFF != 0)) ||
      (!yext && (NY != N || YOFF != 0)))
    return (int)cudaErrorInvalidValue;
  const bool f0 = mode == kF0 || mode == kF0L;
  const int hd = 2 * p, hr = (f0 ? 2 : 1) * p;
  g = March{N,  NX,   XOFF,          xext ? hd : 0, xext ? hr : 0,
            NY, YOFF, yext ? hd : 0, yext ? hr : 0};
  if (!f0) return 0;
  // b comes in T, and the pre-pass writes d0 in T: the pair's inputs
  // (d0, b) are never bf16
  if (!scratch || (flags & kInBF16)) return (int)cudaErrorInvalidValue;
  const int DY = NY + 2 * g.HDY;
  const int64_t rows = (int64_t)(NX + 2 * g.HD) * DY;
  rhs_kernel<T><<<(unsigned)rows, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const T*>(d), scratch, dk, dm, (T)theta, N, XOFF - g.HD,
      DY, YOFF - g.HDY);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  r = d;
  d = scratch;
  x = nullptr;
  mode = mode == kF0 ? kChebD2 : kChebD2L;
  return 0;
}

}  // namespace
