// B.1 — fused banded Laplace operator with single-step Chebyshev epilogues.
//
// Replaces the TPU kernel portable_multigrid_tpu/ops/pallas_laplace.py
// PallasLaplaceOperator._run (the exact "banded" core and the bf16 "mxu"
// core; modes apply, residual1t, residual3t, cheb, chebl, chebd, chebdl, at
// float or bf16 recurrence state, and the untrimmed residual).  It computes M A M u on trimmed state
// with
//     A = Kx (x) My (x) Mz + Mx (x) Ky (x) Mz + Mx (x) My (x) Kz,
// each 1D factor (2p+1)-banded with the Dirichlet mask folded in, followed by
// the mode's elementwise epilogue (laplace_epilogue in common.cuh).  Every K
// contraction runs in difference form (march.cuh), with the row sums of the
// trimmed mask-folded K taken on the host (ksum); M stays direct.  The TPU
// kernel sums K directly, which leaves the f32 Q4 r=6 solve 6.6e-5 off its
// golden L2 norm.  The diagonal is rebuilt from its 1D factors instead of
// being streamed.
//
// The slab of the sharded solve (ops/cuda_laplace.py CudaLaplaceSlab; the
// TPU kernel's make_pallas_slab, xmask="vector", with its modes chebf,
// residual3f and residual1f, pallas_laplace.py:232-242): x has factors of
// its own, a partial assembly over the slab's cells with the shard's slice
// of the x mask folded in (interior shard boundaries stay unmasked, so the
// boundary rows carry only the slab's cells), NX = n_loc p output planes,
// and an x-full input of NX + 1 planes (the shard's state and its right
// neighbour's first plane).  The output drops the slab's last plane, whose
// partial row the caller completes.  The modes run the epilogues of apply,
// residual1t, residual3t and cheb on that geometry (the Operator struct).
// The pencil of the 2D-pencil sharded solve (CudaLaplacePencil; the TPU
// kernel's make_pallas_slab2d, pallas_laplace.py:1020, xmask and ymask
// "vector") gives y the same: factors of its own over NY = n_loc_y p
// output rows from an input of NYI = NY + 1 rows, so that the output
// drops the pencil's last x plane and last y row; z keeps the global
// factors.  The cube passes its factors for all three axes and the slab
// the global ones for y, so that their arithmetic is the one before.
//
// The untrimmed residual (mode kResidual, pallas_laplace.py:217: the first
// half of the full-grid smoother's step) reads u and rhs on the FULL grid,
// (N + 1)^3, at its strides in the same march, with no trim copy first: the
// input rows are NZI = N + 1 long and there are NYI = N + 1 of them in
// NXI = N + 1 planes, rhs is read at u's index, and r0 = rhs - M A M u and
// d0 = r0 / (theta diag) are written trimmed, N^3, in T (JAX's out_dtypes
// (dtype, dtype)).  The window stops at z = N as on the cube; it takes the
// Dirichlet plane x = N and row y = N, which the trimmed bands weigh by
// zero (they must be finite: zero under the solver's invariant), so the
// result is the trimmed modes' M A M u of the trimmed u.
//
// The JAX package's smoother grade (float only; StateFlags in common.cuh):
//   * bf16 state: in the cheb family u (= d) and in1 (= r) are stored in
//     bf16, and r' and d' (r0 and d0 of residual3t) are written in bf16;
//     x and every other field stay float (the TPU kernel's out_dtypes);
//   * the bf16 operator grade (the "mxu" core): the window values u, the
//     z products Kz u and Mz u and the y products My Mz u and
//     (Ky Mz + My Kz) u are rounded to bf16 where they are stored, the
//     products accumulate in float, and the host passes bands rounded to
//     bf16 with K's row sums taken from the rounded bands, so that the
//     difference form is the TPU core's direct sum up to float rounding.
// A bf16 or rounded window, and a bf16 epilogue u and r, come by plain
// loads into registers a plane ahead, as cp.async would bring them, and go
// to shared memory, converted (and rounded), at the top of the next plane
// (stage_bits and unstage in common.cuh): cp.async moves 4 bytes at
// least, bf16 pairs starting at z0 - p are misaligned for odd p, and it
// cannot round.  The window stays float in shared memory.  That route is a
// second instance of the kernel (BF), so that the registers it holds do
// not weigh on the exact instance.
//
// What bounds it on the H100: HBM traffic is 8 B/DoF in f32 for apply (u in,
// one field out) to 24 B/DoF for cheb (u, r, x in; three out), 0.040-0.120
// ms at 256^3; but the 7 banded products of 2p+1 taps per point, the
// shared-memory operand loads that feed them and the latency of the stage
// chain come first.
//
// Design: the x-marching plane engine of cheb2.cu, one step and no growth.
// A block owns a y-z column of TY x 32 output points (each row one warp of
// 32 z lanes) and marches a chunk of LX output planes along x; the chunk's
// input planes run from x0 - p to x0 + LX + p.  For each input plane x_in:
//   1. the u window (TY + 2p rows of 32 + 2p, zeros off the grid) arrives
//      by cp.async a plane ahead, with the epilogue's inputs at the output
//      plane x_o = x_in - p (u, r, x at the thread's own points) and the x
//      row of x_o (K, M, K's row sum, dK, dM);
//   2. the z stage (Kz u, Mz u) on every window row, into one of two sets of
//      z products;
//   3. an iteration later, the y stage gives the two y-z products the x
//      stage needs (My Mz u and Ky Mz u + My Kz u) on the column, into a
//      ring of 2p+1 planes;
//   4. once x_in is in the ring, the x contraction gives raw = M A M u at
//      x_o, and the epilogue writes the mode's outputs.
// Every input plane goes through the z and y stages once; only the chunk's
// 2p lead-in planes and the column's 2p halo rows of the z stage are extra.
// A thread keeps its z row (its lane) and its y rows (two adjacent rows,
// whose y stages share their tap loads) for the whole march, so their
// bands, row sums and the diagonal's y-z factors stay in registers; every
// ring entry and epilogue input is private to the thread that reads it.
// The z stage of plane x_in and the y and x stages of x_in - 1 share an
// iteration, with three windows and two sets of z products in flight, so a
// plane costs one block barrier.  The tile (TY rows, warps) is a
// compile-time function of the type that ops/cuda_laplace.py mirrors
// (laplace_tile), one block per SM.
#include "march.cuh"

using namespace pmg;

namespace {

// warps of a block and rows of its column: march_warps (12 in float, 8
// in double), two rows a warp, the rule of cheb2.cu.  At p = 4 on an H100
// 80GB HBM3 at 700 W, two blocks of 8 warps over 16 rows per SM were as
// fast, and one block of 16 warps at 128 registers 3% faster.
template <typename T>
constexpr int kWarps = march_warps<T>();
template <typename T>
constexpr int kTY = 2 * kWarps<T>;

// shared-memory elements of a block with TY rows; must match
// march_smem_elems() in ops/cuda_laplace.py.  Layout: three u windows
// [3][WY][WZ], two sets of z products [2][2][WY][32], the ring
// [R][2][TY][32], two sets of the epilogue's inputs [2][3][TY][32] (u, r, x
// at the output plane), three x rows [3][xrow_elems].
__host__ __device__ constexpr int64_t smem_elems(int p, int ty) {
  const int64_t R = 2 * p + 1, WY = ty + 2 * p, WZ = kEZ + 2 * p;
  return 3 * WY * WZ + 4 * WY * kEZ + R * 2 * ty * kEZ + 6 * ty * kEZ +
         3 * xrow_elems(p);
}

// BF: the instance of the bf16 grade (float only): the window (bf16 or
// rounded) and a bf16 epilogue u and r travel through registers
// (stage_bits); the other instance moves every stream by cp.async and at
// most stores r' and d' in bf16.
template <typename T, int P, bool BF>
__global__ void __launch_bounds__(kWarps<T> * 32, 1)
laplace_kernel(const void* __restrict__ u, const void* __restrict__ in1,
               const T* __restrict__ in2, void* __restrict__ out0,
               void* __restrict__ out1, T* __restrict__ out2,
               const T* __restrict__ kb, const T* __restrict__ ks,
               const T* __restrict__ mb, const T* __restrict__ dk,
               const T* __restrict__ dm, const T* __restrict__ ykb,
               const T* __restrict__ yks, const T* __restrict__ ymb,
               const T* __restrict__ ydk, const T* __restrict__ ydm,
               const T* __restrict__ xkb, const T* __restrict__ xks,
               const T* __restrict__ xmb, const T* __restrict__ xdk,
               const T* __restrict__ xdm, T c0, T c1, int N_, int NY_,
               int NYI_, int NX_, int NXI_, int NZI_, int mode, int LX,
               int flags) {
  constexpr int R = 2 * P + 1, NW = kWarps<T>, TY = kTY<T>, RW = TY / NW;
  constexpr int WY = TY + 2 * P, WZ = kEZ + 2 * P, XH = xrow_elems(P);
  constexpr int TP = TY * kEZ;  // one plane of the column
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* win = reinterpret_cast<T*>(smem_raw);  // [3][WY][WZ]
  T* zb = win + 3 * WY * WZ;                // [2][2][WY][32]  Kz u, Mz u
  T* ring = zb + 4 * WY * kEZ;              // [R][2][TY][32]  MB, S
  T* ebuf = ring + R * 2 * TP;              // [2][3][TY][32]  u, r, x
  T* xrow = ebuf + 6 * TP;                  // [3][XH]
  // z extent N; NY output rows along y from NYI input rows, NX output
  // planes along x from NXI input planes; input rows of NZI values (N + 1
  // on the full grid, else N)
  const int64_t N = N_, NY = NY_, NYI = NYI_, NX = NX_, NXI = NXI_,
                NZI = NZI_;
  const int lane = threadIdx.x % kEZ, w = threadIdx.x / kEZ;
  const int64_t z0 = (int64_t)blockIdx.x * kEZ, y0 = (int64_t)blockIdx.y * TY;
  const int64_t x0 = (int64_t)blockIdx.z * LX;
  const int64_t xend = x0 + LX < NX ? x0 + LX : NX;
  const int64_t xs = x0 - P, xe = xend + P;
  const int64_t gz = z0 + lane;  // the thread's z row, all march long
  const bool zok = gz < N;
  // the epilogue's inputs: u at the output (residual3t and the cheb
  // family), in1 (every mode but apply; the untrimmed residual's rhs lies
  // on the full grid, as u does), in2 (cheb, chebl)
  const bool need_u = mode >= kRes3 && mode <= kChebDL,
             need_r = mode != kApply,
             need_x = mode == kCheb || mode == kChebL,
             full_r = mode == kResidual;
  // u and in1 stored in bf16; r' and d' (r0 and d0) stored in bf16; the
  // bf16 operator grade (StateFlags)
  const bool ibf = BF && (flags & kInBF16), obf = flags & kOutBF16,
             rnd = BF && (flags & kRoundBF16);
  // the registers of the window (KR rows x KC columns a thread) and of
  // the epilogue's bf16 u and r, in flight from one plane to the next
  constexpr int KR = (WY + NW - 1) / NW, KC = (WZ + kEZ - 1) / kEZ;
  uint32_t sw[BF ? KR : 1][BF ? KC : 1], se[BF ? 2 : 1][BF ? RW : 1];

  // the thread's rows q = qw + j of the column, their bands and the
  // diagonal's y-z factors: diag = dK_x ay + dM_x by
  const int qw = w * RW;
  Row<T, P> yr[RW];
  T ay[RW], by[RW];
#pragma unroll
  for (int j = 0; j < RW; ++j) {
    const int64_t gy = y0 + qw + j;
    yr[j].load(ykb, ymb, yks, NY, gy);
    const bool ok = zok && gy < NY;
    ay[j] = ok ? ydm[gy] * dm[gz] : T(0);
    by[j] = ok ? ydk[gy] * dm[gz] + ydm[gy] * dk[gz] : T(0);
  }
  Row<T, P> zr;
  zr.load(kb, mb, ks, N, gz);
  // everything the iteration of input plane xn reads from global memory,
  // by cp.async (zeros off the grid), or into the staging registers: the u
  // window of xn; the epilogue's inputs at x_o = xn - 1 - P on the
  // thread's points, into buffer b; the x row of x_o
  auto load_plane = [&](int64_t xn, int b) {
    if (xn < xe) {
      const bool xok = xn >= 0 && xn < NXI;
      if constexpr (BF) {
#pragma unroll
        for (int k = 0; k < KR; ++k) {
          const int rw = w + k * NW;
          const int64_t yy = y0 - P + rw;
          const bool yok = xok && rw < WY && yy >= 0 && yy < NYI;
#pragma unroll
          for (int kc = 0; kc < KC; ++kc) {
            const int64_t zz = z0 - P + lane + kc * kEZ;
            sw[k][kc] = stage_bits(u, (xn * NYI + yy) * NZI + zz,
                                   yok && zz >= 0 && zz < N, ibf);
          }
        }
      } else {
        T* dst = win + (int)((xn - xs) % 3) * WY * WZ;
        for (int rw = w; rw < WY; rw += NW) {
          const int64_t yy = y0 - P + rw;
          const bool yok = xok && yy >= 0 && yy < NYI;
          for (int c = lane; c < WZ; c += kEZ) {
            const int64_t zz = z0 - P + c;
            const bool ok = yok && zz >= 0 && zz < N;
            const T* src = static_cast<const T*>(u);
            cp_async_elem(dst + rw * WZ + c,
                          ok ? src + (xn * NYI + yy) * NZI + zz : src, ok);
          }
        }
      }
    }
    const int64_t xo = xn - 1 - P;
    if (xo >= x0 && xo < xend) {
      if (zok) {
#pragma unroll
        for (int j = 0; j < RW; ++j) {
          const int q = qw + j;
          if (y0 + q >= NY) continue;
          // u at the output point (its input row), and in1, in2 there
          const int64_t gu = (xo * NYI + y0 + q) * NZI + gz,
                        g = (xo * NY + y0 + q) * N + gz, gr = full_r ? gu : g;
          T* e = ebuf + (b * 3 * TY + q) * kEZ + lane;
          // the epilogue's u and r as stored, never rounded
          if (ibf) {
            if constexpr (BF) {
              se[0][j] = stage_bits(u, gu, need_u, true);
              se[1][j] = stage_bits(in1, gr, need_r, true);
            }
          } else {
            if (need_u) cp_async_elem(e, static_cast<const T*>(u) + gu, true);
            if (need_r)
              cp_async_elem(e + TP, static_cast<const T*>(in1) + gr, true);
          }
          if (need_x) cp_async_elem(e + 2 * TP, in2 + g, true);
        }
      }
      if (w == NW - 1) {
        T* xr = xrow + (int)((xn - xs) % 3) * XH;
        for (int e = lane; e < 2 * R + 3; e += kEZ) {
          const T* src = e < R        ? xkb + e * NX
                         : e < 2 * R  ? xmb + (e - R) * NX
                         : e == 2 * R ? xks
                         : e == 2 * R + 1 ? xdk
                                          : xdm;
          cp_async_elem(xr + e, src + xo, true);
        }
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
      const int64_t xo = xn - 1 - P;
      if (ibf && xo >= x0 && xo < xend && zok) {
#pragma unroll
        for (int j = 0; j < RW; ++j) {
          const int q = qw + j;
          if (y0 + q >= NY) continue;
          T* e = ebuf + (b * 3 * TY + q) * kEZ + lane;
          if (need_u) e[0] = unstage(se[0][j], true, false);
          if (need_r) e[TP] = unstage(se[1][j], true, false);
        }
      }
    }
  };
  // The march, one block barrier a plane.  Iteration xin runs, on data the
  // last iteration left behind the barrier: the z stage of input plane
  // xin; the y stage of plane xin - 1 into the ring; the x stage and the
  // epilogue at x_o = xin - 1 - P.  The windows cycle through three
  // buffers, the x rows through three sets and the z products through two,
  // so that no stage overwrites what a slower warp may still read.
  // The registers staged for plane xin + 1 land in shared memory at the
  // top of the next iteration, before its barrier.
  load_plane(xs, 0);
  put_plane(xs, 0);
  for (int64_t xin = xs; xin <= xe; ++xin) {
    const int i = (int)(xin - xs), b = i & 1;
    if (xin > xs) put_plane(xin, b);
    if (xin < xe) {
      load_plane(xin + 1, b ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // ---- z stage of input plane xin
    if (xin < xe) {
      const T* buf = win + (i % 3) * WY * WZ;
      T* zo = zb + b * 2 * WY * kEZ;
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

    // ---- y stage of plane xin - 1 into ring slot (xin - 1 - xs) % R
    if (xin == xs) continue;
    const T* zi = zb + (b ^ 1) * 2 * WY * kEZ;
    T* slot = ring + ((i - 1) % R) * 2 * TP + qw * kEZ + lane;
    {
      T mbv[RW], sv[RW];
      contract_y<T, P, RW>(yr, zi + qw * kEZ + lane,
                           zi + (WY + qw) * kEZ + lane, mbv, sv);
#pragma unroll
      for (int j = 0; j < RW; ++j) {
        slot[j * kEZ] = rnd ? round_bf16(mbv[j]) : mbv[j];
        slot[TP + j * kEZ] = rnd ? round_bf16(sv[j]) : sv[j];
      }
    }

    // ---- x stage and epilogue at x_o = xin - 1 - P
    const int64_t xo = xin - 1 - P;
    if (xo < x0 || !zok) continue;
    Row<T, P> xr;
    T dkx, dmx;
    xr.load_smem(xrow + (i % 3) * XH, dkx, dmx);
    const int base = (int)((xo - P - xs) % R);
#pragma unroll
    for (int j = 0; j < RW; ++j) {
      const int q = qw + j;
      if (y0 + q >= NY) continue;
      const T raw = contract_x<T, P>(xr, ring + q * kEZ + lane, 2 * TP, TP,
                                     base);
      const T* e = ebuf + (b * 3 * TY + q) * kEZ + lane;
      laplace_epilogue(
          mode, (xo * NY + y0 + q) * N + gz, raw,
          [&](int k) { return e[k * TP]; }, out0, out1, out2, c0, c1,
          [&] { return dkx * ay[j] + dmx * by[j]; }, obf);
    }
  }
}

// The operator's arrays and the launch geometry, as the host hands them
// over: the z factors (kb, ks, mb, dk, dm) of extent N, the y factors
// (ykb, yks, ymb; ydk, ydm) of NY rows, NY output rows from NYI input
// rows, and the x factors (xkb, xks, xmb; xdk, xdm) of NX rows, NX output
// planes from NXI input planes, input rows of NZI values.  On the cube every
// axis has the z factors and NX = NXI = NY = NYI = NZI = N (N + 1 for the
// inputs of the untrimmed residual); on a slab of the sharded solve x has the
// slab's own (a partial assembly over its cells, the per-shard slices of
// the diagonal factors) and NXI = NX + 1 (the input is x-full); on a
// pencil of the 2D-pencil solve y has the pencil's own too and
// NYI = NY + 1.
template <typename T>
struct Operator {
  const T *kb, *ks, *mb, *dk, *dm, *ykb, *yks, *ymb, *ydk, *ydm, *xkb, *xks,
      *xmb, *xdk, *xdm;
  int N, NY, NYI, NX, NXI, NZI;
};

template <typename T, int P, bool BF>
int launch_p(const void* u, const void* in1, const T* in2, void* out0,
             void* out1, T* out2, const Operator<T>& op, double c0,
             double c1, int mode, int LX, int TY, int NW, int flags,
             void* stream) {
  constexpr int kNW = kWarps<T>, kRows = kTY<T>;
  constexpr size_t smem = (size_t)smem_elems(P, kRows) * sizeof(T);
  static_assert(smem <= (size_t)kSmemLimit, "B.1 tile exceeds shared memory");
  // the host's tile must be the one this instance was compiled for
  if (TY != kRows || NW != kNW || LX < 1 || mode < kApply ||
      mode > kResidual || (flags && sizeof(T) != 4) || op.NX < 1 ||
      op.NXI < op.NX || op.NY < 1 || op.NYI < op.NY || op.NZI < op.N)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem((const void*)laplace_kernel<T, P, BF>, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute((const void*)laplace_kernel<T, P, BF>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)ceil_div(op.N, kEZ),
                  (unsigned)ceil_div(op.NY, kRows),
                  (unsigned)ceil_div(op.NX, LX));
  laplace_kernel<T, P, BF><<<grid, kNW * 32, smem, (cudaStream_t)stream>>>(
      u, in1, in2, out0, out1, out2, op.kb, op.ks, op.mb, op.dk, op.dm,
      op.ykb, op.yks, op.ymb, op.ydk, op.ydm, op.xkb, op.xks, op.xmb, op.xdk,
      op.xdm, (T)c0, (T)c1, op.N, op.NY, op.NYI, op.NX, op.NXI, op.NZI, mode,
      LX, flags);
  return (int)cudaGetLastError();
}

// the bf16 grade's instance where a stream goes through registers
template <typename T, int P>
int launch_grade(const void* u, const void* in1, const T* in2, void* out0,
                 void* out1, T* out2, const Operator<T>& op, double c0,
                 double c1, int mode, int LX, int TY, int NW, int flags,
                 void* stream) {
  if constexpr (sizeof(T) == 4) {
    if (flags & (kInBF16 | kRoundBF16))
      return launch_p<T, P, true>(u, in1, in2, out0, out1, out2, op, c0, c1,
                                  mode, LX, TY, NW, flags, stream);
  }
  return launch_p<T, P, false>(u, in1, in2, out0, out1, out2, op, c0, c1,
                               mode, LX, TY, NW, flags, stream);
}

template <typename T>
int launch(const void* u, const void* in1, const T* in2, void* out0,
           void* out1, T* out2, const Operator<T>& op, double c0, double c1,
           int p, int mode, int LX, int TY, int NW, int flags, void* stream) {
  switch (p) {
#define PMG_CASE(PP)                                                        \
  case PP:                                                                  \
    return launch_grade<T, PP>(u, in1, in2, out0, out1, out2, op, c0, c1,   \
                               mode, LX, TY, NW, flags, stream);
    PMG_CASE(1) PMG_CASE(2) PMG_CASE(3) PMG_CASE(4) PMG_CASE(5) PMG_CASE(6)
    PMG_CASE(7)
#undef PMG_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// (LX, TY, NW): LX output planes per block along x, TY rows of the block's
// y-z column and NW warps (the compiled tile of laplace_tile); flags: the
// StateFlags of the launch (float only).  u, in1, out0 and out1 are float
// or bf16 as the flags say.  kb .. dm: the z factors (extent N); ykb ..
// ydm: the y factors (NY rows); xkb .. xdm: the x factors (NX rows); NY
// output rows from NYI input rows, NX output planes from NXI input planes,
// input rows of NZI values (the Operator struct above).
#define PMG_LAPLACE_ENTRY(NAME, T)                                           \
  extern "C" int NAME(const void* u, const void* in1, const T* in2,         \
                      void* out0, void* out1, T* out2, const T* kb,         \
                      const T* ks, const T* mb, const T* dk, const T* dm,   \
                      const T* ykb, const T* yks, const T* ymb,             \
                      const T* ydk, const T* ydm, const T* xkb,             \
                      const T* xks, const T* xmb, const T* xdk,             \
                      const T* xdm, double c0, double c1, int N, int NY,    \
                      int NYI, int NX, int NXI, int NZI, int p, int mode,   \
                      int LX, int TY, int NW, int flags, void* stream) {    \
    const Operator<T> op{kb,  ks,  mb,  dk,  dm, ykb, yks, ymb,             \
                         ydk, ydm, xkb, xks, xmb, xdk, xdm,                 \
                         N,   NY,  NYI, NX,  NXI, NZI};                     \
    return launch<T>(u, in1, in2, out0, out1, out2, op, c0, c1, p, mode,    \
                     LX, TY, NW, flags, stream);                            \
  }

PMG_LAPLACE_ENTRY(pmg_laplace_f32, float)
PMG_LAPLACE_ENTRY(pmg_laplace_f64, double)
