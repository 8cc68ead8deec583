// B.4 — fused banded 2D Laplace operator with single-step Chebyshev epilogues.
//
// Replaces the TPU kernel portable_multigrid_tpu/ops/pallas_laplace2d.py
// PallasLaplace2D._run (modes apply, residual1t, residual3t, cheb, chebl,
// chebd, chebdl; the recurrence state in float or bf16, with the operator
// exact, as the TPU kernel has it: u and r of the cheb family read from
// bf16 by plain loads into registers a row ahead, stored to shared memory
// at the top of the next row (stage_bits and unstage of common.cuh, in a
// second instance, BF); r' and d' (r0, d0) written in bf16 by store_state).  It computes M A M u on trimmed state — an N x N grid
// [x, y], N = n p, C order with y contiguous — with
//     A = Kx (x) My + Mx (x) Ky,
// each 1D factor (2p+1)-banded with the Dirichlet mask folded in, followed by
// the mode's elementwise epilogue (laplace_epilogue in common.cuh).  The
// diagonal dKx dMy + dMx dKy is rebuilt from its 1D factors.
//
// Each stiffness contraction runs in difference form,
//     (K u)_i = sum_o K[i, i+o] (u_{i+o} - u_i) + s_i u_i,
// s_i the row sum of the mask-folded K (zero away from the Dirichlet ends).
// It is the same operator with less roundoff: the direct sum loses the
// small K u of a smooth u to cancellation in f32, an error that grows 4x
// per refinement (3.4% of the solution's L2 norm at Q7 r=9), while the
// differences of neighbouring values are small and nearly exact.
//
// What bounds it on the H100: HBM traffic is 8 B/DoF in f32 for apply (u in,
// one field out) to 24 B/DoF for cheb (u, r, x in; three out), 31-92 us at
// the 2D Q7 r=9 fine level (3584^2 trimmed DoFs); the two banded products of
// 2p+1 taps a point (about 95 FP32 lane-slots at p = 7) are ~40 us of FP
// issue.  So the instructions that feed the products come first: the first,
// tiled design read its u window 1.75x per point, ran the y stage on its
// halo rows (1.44 rows a row) and reloaded the x row's 31 band coefficients
// from global memory at every point, ~88 loads a point at p = 7.
//
// Design: an x-marching row engine.  A block of kNW warps owns a column of
// TY = 32 kNW consecutive y points, one a thread, and marches a chunk of LX
// output rows along x; the chunk's input rows run from x0 - p to
// x0 + LX + p - 1, so only its 2p lead-in rows are extra.  For input row
// x_in = x0 - p + i:
//   1. the u row (TY + 2p values, zeros off the grid), and at the output
//      row x_o = x_in - p its x row (K, M, K's row sum, dK, dM) and the
//      epilogue's inputs (u, r, x at the thread's point) arrive by cp.async
//      kAhead rows ahead, into one of kStages buffer sets;
//   2. the y stage (Ky u, My u: 2p+1 taps from shared memory with the
//      thread's y band in registers for the whole march) runs once per
//      input row, into a ring of the last 2p+1 (My u, Ky u) pairs.  The ring
//      holds the thread's own column, so it is thread-private and lives in
//      registers, shifted by one slot a row (2(2p+1) register moves);
//   3. the x stage reads the x row in broadcast 16-byte loads and contracts
//      the ring: raw = Kx (My u) + Mx (Ky u) at x_o, then the epilogue.
// A row costs one block barrier.  Its buffers are small (9 KB at p = 7 in
// f32), so kBlocks blocks share an SM; the register cap that follows is the
// occupancy the host's chunk rule counts (laplace2d_tile in
// ops/cuda_laplace2d.py).  A march unrolled by 2p+1 rows, which makes the
// ring's slots static without the moves, was 22-28% slower on an H100 80GB
// HBM3 at 700 W: it repeats the row's body, epilogue and loads included,
// 2p+1 times, and spilled at p = 7.
#include "march.cuh"

using namespace pmg;

namespace {

// warps of a block, one y point a thread; must match NW in
// ops/cuda_laplace2d.py
constexpr int kNW = 4;
constexpr int kTY = 32 * kNW;
// blocks an SM holds at once (the register cap of __launch_bounds__: 128
// registers a thread in float, 255 in double); laplace2d_blocks() mirrors it
template <typename T>
constexpr int kBlocks = sizeof(T) == 4 ? 4 : 2;
// buffer sets of the cp.async pipeline and the rows in flight ahead of the
// one computed (STAGES in ops/cuda_laplace2d.py)
constexpr int kStages = 4;
constexpr int kAhead = kStages - 1;

// elements of one buffer set: the u row with its halo (rounded up to 16
// bytes of float), the x row (xrow_elems), the epilogue's u, r, x
__host__ __device__ constexpr int stage_elems(int p, int ty) {
  return (ty + 2 * p + 3) / 4 * 4 + xrow_elems(p) + 3 * ty;
}

// shared-memory elements of a block; must match laplace2d_smem_elems() in
// ops/cuda_laplace2d.py
__host__ __device__ constexpr int64_t smem_elems(int p, int ty) {
  return (int64_t)kStages * stage_elems(p, ty);
}

// BF: the instance of bf16 state (float only): the bf16 u row and the
// epilogue's bf16 u and r travel through registers (stage_bits); the other
// instance moves every stream by cp.async and at most stores r' and d' in
// bf16.
template <typename T, int P, bool BF>
__global__ void __launch_bounds__(kTY, kBlocks<T>)
laplace2d_kernel(const void* __restrict__ u, const void* __restrict__ in1,
                 const T* __restrict__ in2, void* __restrict__ out0,
                 void* __restrict__ out1, T* __restrict__ out2,
                 const T* __restrict__ kb, const T* __restrict__ ks,
                 const T* __restrict__ mb, const T* __restrict__ dk,
                 const T* __restrict__ dm, T c0, T c1, int N_, int mode,
                 int LX, int flags) {
  constexpr int R = 2 * P + 1, TY = kTY, WY = TY + 2 * P;
  constexpr int XOFF = (WY + 3) / 4 * 4, EOFF = XOFF + xrow_elems(P);
  constexpr int SE = stage_elems(P, TY);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* stage = reinterpret_cast<T*>(smem_raw);  // [kStages][SE]
  const int64_t N = N_;
  const int t = threadIdx.x;
  const int64_t y0 = (int64_t)blockIdx.x * TY, x0 = (int64_t)blockIdx.y * LX;
  const int64_t xend = x0 + LX < N ? x0 + LX : N;
  const int64_t xs = x0 - P;                  // the first input row
  const int rows = (int)(xend - x0) + 2 * P;  // input rows of the march
  const int64_t gy = y0 + t;  // the thread's y point, all march long
  const bool yok = gy < N;
  // the epilogue's inputs: u at the output (residual3t and the cheb
  // family), in1 (every mode but apply), in2 (cheb, chebl)
  const bool need_u = mode >= kRes3, need_r = mode != kApply,
             need_x = mode == kCheb || mode == kChebL;
  // u and in1 stored in bf16; r' and d' (r0 and d0) stored in bf16
  // (StateFlags; the 2D operator has no bf16 grade, as in the JAX package)
  const bool ibf = BF && (flags & kInBF16), obf = flags & kOutBF16;
  // the registers of one row's bf16 u values (KC a thread) and of the
  // epilogue's u and r, in flight from one row to the next
  constexpr int KC = (WY + TY - 1) / TY;
  uint32_t su[BF ? KC : 1], se[BF ? 2 : 1];

  Row<T, P> yr;
  yr.load(kb, mb, ks, N, gy);
  const T dky = yok ? dk[gy] : T(0), dmy = yok ? dm[gy] : T(0);

  // everything row i of the march reads from global memory, into buffer
  // set i % kStages: the u row x_in = xs + i, and at an output row
  // x_o = x_in - P its x row and the epilogue's inputs
  auto load_row = [&](int i) {
    if (i < rows) {
      T* st = stage + (i % kStages) * SE;
      const int64_t xin = xs + i;
      const bool xok = xin >= 0 && xin < N;
      if constexpr (BF) {
#pragma unroll
        for (int kc = 0; kc < KC; ++kc) {
          const int64_t yy = y0 - P + t + kc * TY;
          su[kc] = stage_bits(u, xin * N + yy,
                              xok && t + kc * TY < WY && yy >= 0 && yy < N,
                              true);
        }
      } else {
        for (int c = t; c < WY; c += TY) {
          const int64_t yy = y0 - P + c;
          const bool ok = xok && yy >= 0 && yy < N;
          cp_async_elem(st + c,
                        ok ? static_cast<const T*>(u) + xin * N + yy
                           : static_cast<const T*>(u),
                        ok);
        }
      }
      const int64_t xo = xin - P;
      if (xo >= x0) {
        for (int e = t; e < 2 * R + 3; e += TY) {
          const T* src = e < R        ? kb + e * N
                         : e < 2 * R  ? mb + (e - R) * N
                         : e == 2 * R ? ks
                         : e == 2 * R + 1 ? dk
                                          : dm;
          cp_async_elem(st + XOFF + e, src + xo, true);
        }
        if (yok) {
          const int64_t g = xo * N + gy;
          T* e = st + EOFF + t;
          if constexpr (BF) {
            se[0] = stage_bits(u, g, need_u, true);
            se[1] = stage_bits(in1, g, need_r, true);
          } else {
            if (need_u) cp_async_elem(e, static_cast<const T*>(u) + g, true);
            if (need_r)
              cp_async_elem(e + TY, static_cast<const T*>(in1) + g, true);
          }
          if (need_x) cp_async_elem(e + 2 * TY, in2 + g, true);
        }
      }
    }
    cp_async_commit();
  };

  // the staging registers of row i into its buffer set (the guards of
  // load_row)
  auto put_row = [&](int i) {
    if constexpr (BF) {
      if (i < rows) {
        T* st = stage + (i % kStages) * SE;
#pragma unroll
        for (int kc = 0; kc < KC; ++kc)
          if (t + kc * TY < WY) st[t + kc * TY] = unstage(su[kc], true, false);
        if (xs + i - P >= x0 && yok) {
          if (need_u) st[EOFF + t] = unstage(se[0], true, false);
          if (need_r) st[EOFF + TY + t] = unstage(se[1], true, false);
        }
      }
    }
  };

  // the ring: My u (rb) and Ky u (ra) of the last R input rows at the
  // thread's point, the newest in slot R - 1
  T rb[R], ra[R];
#pragma unroll
  for (int o = 0; o < R; ++o) rb[o] = ra[o] = T(0);
#pragma unroll
  for (int j = 0; j < kAhead; ++j) {
    load_row(j);
    put_row(j);
  }
  // the registers staged for row i + kAhead land in shared memory at the
  // top of the next iteration, before its barrier
  for (int i = 0; i < rows; ++i) {
    if (i > 0) put_row(i - 1 + kAhead);
    cp_async_wait<kAhead - 1>();
    __syncthreads();  // row i in; row i - 1's buffer set read by all
    load_row(i + kAhead);
    const T* st = stage + (i % kStages) * SE;
    // ---- y stage of input row i, into the ring's newest slot
#pragma unroll
    for (int o = 0; o + 1 < R; ++o) {
      rb[o] = rb[o + 1];
      ra[o] = ra[o + 1];
    }
    contract_km<T, P>(yr, st + t, ra[R - 1], rb[R - 1]);
    // ---- x stage and epilogue at x_o = x0 - 2P + i (input row i - 2P + o
    // in slot o)
    if (i >= 2 * P && yok) {
      Row<T, P> xr;
      T dkx, dmx;
      xr.load_smem(st + XOFF, dkx, dmx);
      const T mbc = rb[P];
      T rk = xr.s * mbc, rm = T(0);
#pragma unroll
      for (int o = 0; o < R; ++o) {
        rk += xr.k[o] * (rb[o] - mbc);
        rm += xr.m[o] * ra[o];
      }
      const T* e = st + EOFF + t;
      laplace_epilogue(
          mode, (x0 - 2 * P + i) * N + gy, rk + rm,
          [&](int k) { return e[k * TY]; }, out0, out1, out2, c0, c1,
          [&] { return dkx * dmy + dmx * dky; }, obf);
    }
  }
}

template <typename T, int P, bool BF>
int launch_p(const void* u, const void* in1, const T* in2, void* out0,
             void* out1, T* out2, const T* kb, const T* ks, const T* mb,
             const T* dk, const T* dm, double c0, double c1, int N, int mode,
             int LX, int TY, int NW, int flags, void* stream) {
  constexpr size_t smem = (size_t)smem_elems(P, kTY) * sizeof(T);
  static_assert(smem <= (size_t)kSmemLimit, "B.4 tile exceeds shared memory");
  // the host's tile must be the one this instance was compiled for
  if (TY != kTY || NW != kNW || LX < 1 || mode < kApply || mode > kChebDL ||
      (flags & kRoundBF16) || (flags && sizeof(T) != 4))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem((const void*)laplace2d_kernel<T, P, BF>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)ceil_div(N, kTY), (unsigned)ceil_div(N, LX));
  laplace2d_kernel<T, P, BF><<<grid, kTY, smem, (cudaStream_t)stream>>>(
      u, in1, in2, out0, out1, out2, kb, ks, mb, dk, dm, (T)c0, (T)c1, N,
      mode, LX, flags);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* u, const void* in1, const T* in2, void* out0,
           void* out1, T* out2, const T* kb, const T* ks, const T* mb,
           const T* dk, const T* dm, double c0, double c1, int N, int p,
           int mode, int LX, int TY, int NW, int flags, void* stream) {
  switch (p) {
#define PMG_CASE(PP)                                                        \
  case PP:                                                                  \
    if constexpr (sizeof(T) == 4) {                                         \
      if (flags & kInBF16)                                                  \
        return launch_p<T, PP, true>(u, in1, in2, out0, out1, out2, kb, ks, \
                                     mb, dk, dm, c0, c1, N, mode, LX, TY,   \
                                     NW, flags, stream);                    \
    }                                                                       \
    return launch_p<T, PP, false>(u, in1, in2, out0, out1, out2, kb, ks,   \
                                  mb, dk, dm, c0, c1, N, mode, LX, TY, NW, \
                                  flags, stream);
    PMG_CASE(1) PMG_CASE(2) PMG_CASE(3) PMG_CASE(4) PMG_CASE(5) PMG_CASE(6)
    PMG_CASE(7)
#undef PMG_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// (LX, TY, NW): LX output rows per block along x, TY y points of the
// block's column and NW warps (the compiled tile of laplace2d_tile); flags:
// kInBF16 and kOutBF16 of StateFlags (float only).  u, in1, out0 and out1
// are float or bf16 as the flags say.
extern "C" int pmg_laplace2d_f32(const void* u, const void* in1,
                                 const float* in2, void* out0, void* out1,
                                 float* out2, const float* kb, const float* ks,
                                 const float* mb, const float* dk,
                                 const float* dm, double c0, double c1, int N,
                                 int p, int mode, int LX, int TY, int NW,
                                 int flags, void* stream) {
  return launch<float>(u, in1, in2, out0, out1, out2, kb, ks, mb, dk, dm, c0,
                       c1, N, p, mode, LX, TY, NW, flags, stream);
}

extern "C" int pmg_laplace2d_f64(const void* u, const void* in1,
                                 const double* in2, void* out0, void* out1,
                                 double* out2, const double* kb,
                                 const double* ks, const double* mb,
                                 const double* dk, const double* dm, double c0,
                                 double c1, int N, int p, int mode, int LX,
                                 int TY, int NW, int flags, void* stream) {
  return launch<double>(u, in1, in2, out0, out1, out2, kb, ks, mb, dk, dm, c0,
                        c1, N, p, mode, LX, TY, NW, flags, stream);
}
