// B.1 — fused banded Laplace operator with single-step Chebyshev epilogues.
//
// Replaces the TPU kernel portable_multigrid_tpu/ops/pallas_laplace.py
// PallasLaplaceOperator._run (exact "banded" core; modes apply, residual1t,
// residual3t, cheb, chebl, chebd, chebdl).  It computes M A M u on trimmed
// state with
//     A = Kx (x) My (x) Mz + Mx (x) Ky (x) Mz + Mx (x) My (x) Kz,
// each 1D factor (2p+1)-banded with the Dirichlet mask folded in, followed by
// the mode's elementwise epilogue (laplace_epilogue in common.cuh).  The
// diagonal is rebuilt from its 1D factors instead of being streamed.
//
// What bounds it on the H100: HBM traffic.  apply reads u and writes one
// field (8 B/DoF in f32), the cheb modes read d, r, x and write three
// (24 B/DoF); at 3.35 TB/s the r=6 Q4 fine level (16.8M trimmed DoFs) is
// 40 us for apply and 120 us for cheb.  The FLOPs (about 60 per DoF) are
// far under the f32 peak.
//
// Design: one thread block owns a TX x TY x TZ output tile.  It loads u with
// a halo of p on every side into shared memory (zeros outside the grid),
// contracts z (Kz u and Mz u share each load), then y, then x, in the order
// of pallas_laplace.py:466-469, keeping every intermediate in shared memory
// (stage helpers in common.cuh; the degree is a template parameter, so each
// thread holds its row's band coefficients in registers).  The band arrays
// are the GLOBAL mask-folded 1D matrices, so every tile reads its own halo
// and no carry planes are needed (the TPU carries exist only because a
// Pallas grid runs in order).  The price of this simple first version is
// halo re-reads (an 8x8 xy tile at p = 4 reads its window about 3x, mostly
// from L2); z-marching, TMA and tile tuning are later work.
#include "common.cuh"

using namespace pmg;

namespace {

// shared-memory elements for a tile; must match laplace_smem_elems() in
// ops/cuda_laplace.py
__host__ __device__ inline int64_t smem_elems(int p, int TX, int TY, int TZ,
                                              int64_t* buf0) {
  const int64_t WX = TX + 2 * p, WY = TY + 2 * p, WZ = TZ + 2 * p;
  const int64_t win = WX * WY * WZ;
  const int64_t ystage = 2 * WX * TY * TZ;
  const int64_t b0 = win > ystage ? win : ystage;
  if (buf0) *buf0 = b0;
  return b0 + 2 * WX * WY * TZ;
}

template <typename T, int P>
__global__ void __launch_bounds__(kThreads)
laplace_kernel(const T* __restrict__ u, const T* __restrict__ in1,
               const T* __restrict__ in2, T* __restrict__ out0,
               T* __restrict__ out1, T* __restrict__ out2,
               const T* __restrict__ kb, const T* __restrict__ mb,
               const T* __restrict__ dk, const T* __restrict__ dm, T c0, T c1,
               int N_, int mode, int TX, int TY, int TZ) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int64_t N = N_;
  const int WX = TX + 2 * P, WY = TY + 2 * P, WZ = TZ + 2 * P;
  int64_t b0;
  smem_elems(P, TX, TY, TZ, &b0);
  T* buf0 = reinterpret_cast<T*>(smem_raw);
  T* buf1 = buf0 + b0;
  const int64_t x0 = (int64_t)blockIdx.z * TX;
  const int64_t y0 = (int64_t)blockIdx.y * TY;
  const int64_t z0 = (int64_t)blockIdx.x * TZ;

  // u window with a halo of P (zeros outside the grid)
  const int nwin = WX * WY * WZ;
  for (int i = threadIdx.x; i < nwin; i += blockDim.x) {
    const int lz = i % WZ, t = i / WZ, ly = t % WY, lx = t / WY;
    const int64_t gx = x0 - P + lx, gy = y0 - P + ly, gz = z0 - P + lz;
    buf0[i] = inside(gx, gy, gz, N) ? u[(gx * N + gy) * N + gz] : T(0);
  }
  __syncthreads();

  // z: a = Kz u, b = Mz u on (WX, WY, TZ)
  T* A = buf1;
  T* B = buf1 + WX * WY * TZ;
  stage_z<T, P>(buf0, WZ, A, B, WX * WY, TZ, z0, kb, mb, N);
  __syncthreads();

  // y: mb = My b, s = Ky b + My a on (WX, TY, TZ)
  T* MB = buf0;
  T* S = buf0 + WX * TY * TZ;
  stage_y<T, P>(A, B, WY, MB, S, WX, TY, TZ, y0, kb, mb, N);
  __syncthreads();

  // x: raw = Kx mb + Mx s on the tile, then the mode's epilogue
  stage_x<T, P>(MB, S, TX, TY, TZ, x0, kb, mb, N,
                [&](int lx, int ly, int lz, T raw) {
    const int64_t gx = x0 + lx, gy = y0 + ly, gz = z0 + lz;
    if (gx >= N || gy >= N || gz >= N) return;
    laplace_epilogue(mode, (gx * N + gy) * N + gz, raw, u, in1, in2, out0,
                     out1, out2, c0, c1,
                     [&] { return diag_at(dk, dm, gx, gy, gz); });
  });
}

template <typename T, int P>
int launch_p(const T* u, const T* in1, const T* in2, T* out0, T* out1,
             T* out2, const T* kb, const T* mb, const T* dk, const T* dm,
             double c0, double c1, int N, int mode, int TX, int TY, int TZ,
             void* stream) {
  const size_t smem = (size_t)smem_elems(P, TX, TY, TZ, nullptr) * sizeof(T);
  cudaError_t err = allow_smem((const void*)laplace_kernel<T, P>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)ceil_div(N, TZ), (unsigned)ceil_div(N, TY),
                  (unsigned)ceil_div(N, TX));
  laplace_kernel<T, P><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      u, in1, in2, out0, out1, out2, kb, mb, dk, dm, (T)c0, (T)c1, N, mode,
      TX, TY, TZ);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const T* u, const T* in1, const T* in2, T* out0, T* out1, T* out2,
           const T* kb, const T* mb, const T* dk, const T* dm, double c0,
           double c1, int N, int p, int mode, int TX, int TY, int TZ,
           void* stream) {
  switch (p) {
#define PMG_CASE(PP)                                                        \
  case PP:                                                                  \
    return launch_p<T, PP>(u, in1, in2, out0, out1, out2, kb, mb, dk, dm,  \
                           c0, c1, N, mode, TX, TY, TZ, stream);
    PMG_CASE(1) PMG_CASE(2) PMG_CASE(3) PMG_CASE(4) PMG_CASE(5) PMG_CASE(6)
    PMG_CASE(7)
#undef PMG_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int pmg_laplace_f32(const float* u, const float* in1,
                               const float* in2, float* out0, float* out1,
                               float* out2, const float* kb, const float* mb,
                               const float* dk, const float* dm, double c0,
                               double c1, int N, int p, int mode, int TX,
                               int TY, int TZ, void* stream) {
  return launch<float>(u, in1, in2, out0, out1, out2, kb, mb, dk, dm, c0, c1,
                       N, p, mode, TX, TY, TZ, stream);
}

extern "C" int pmg_laplace_f64(const double* u, const double* in1,
                               const double* in2, double* out0, double* out1,
                               double* out2, const double* kb,
                               const double* mb, const double* dk,
                               const double* dm, double c0, double c1, int N,
                               int p, int mode, int TX, int TY, int TZ,
                               void* stream) {
  return launch<double>(u, in1, in2, out0, out1, out2, kb, mb, dk, dm, c0, c1,
                        N, p, mode, TX, TY, TZ, stream);
}
