// B.4 — fused banded 2D Laplace operator with single-step Chebyshev epilogues.
//
// Replaces the TPU kernel portable_multigrid_tpu/ops/pallas_laplace2d.py
// PallasLaplace2D._run (modes apply, residual1t, residual3t, cheb, chebl,
// chebd, chebdl).  It computes M A M u on trimmed state — an N x N grid
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
// What bounds it on the H100: HBM traffic.  apply reads u and writes one
// field (8 B/DoF in f32), the cheb modes read d, r, x and write three
// (24 B/DoF); at 3.35 TB/s the 2D Q7 r=9 fine level (3584^2 trimmed DoFs)
// is 31 us for apply and 92 us for cheb.  The FLOPs (about 4(2p+1) per DoF
// plus the halo rows) are far under the f32 peak.
//
// Design: one thread block owns a TX x TY output tile.  It loads u with a
// halo of p on every side into shared memory (zeros outside the grid),
// contracts y (Ky u and My u share each load), then x (raw = Kx (My u) +
// Mx (Ky u)): the degree is a template parameter and each thread holds its
// row's band coefficients in registers.  The bands are the GLOBAL
// mask-folded trimmed 1D matrices, so every tile reads its own halo;
// the TPU kernel's carry row (pallas_laplace2d.py:274-285) exists only
// because a Pallas grid runs in order, and is gone here, as are its lane
// padding, 8-row DMA frames and bf16 streams.  The host picks the tile from
// shared memory (laplace2d_tile in ops/cuda_laplace2d.py); at p = 7 a
// 32 x 64 f32 tile takes 38 KB, so several blocks share an SM.
#include "common.cuh"

using namespace pmg;

namespace {

// shared-memory elements for a tile; must match laplace2d_smem_elems() in
// ops/cuda_laplace2d.py
__host__ __device__ inline int64_t smem_elems(int p, int TX, int TY) {
  const int64_t WX = TX + 2 * p, WY = TY + 2 * p;
  return WX * WY + 2 * WX * TY;
}

// y contraction of the window rows r < R (row length inY, output column c
// centred at input index c + P):
//     A[r][c] = (Ky u) in difference form,  B[r][c] = (My u).
template <typename T, int P>
__device__ __forceinline__ void stage_y(const T* in, int inY, T* A, T* B,
                                        int R, int C, int64_t gy0,
                                        const T* __restrict__ kb,
                                        const T* __restrict__ ks,
                                        const T* __restrict__ mb, int64_t N) {
  const int rows = blockDim.x / C;
  const int c = threadIdx.x % C, r0 = threadIdx.x / C;
  if (r0 >= rows) return;
  T k[2 * P + 1], m[2 * P + 1];
  load_bands<T, P>(kb, mb, N, gy0 + c, k, m);
  const T s = (gy0 + c < N) ? ks[gy0 + c] : T(0);
  for (int r = r0; r < R; r += rows) {
    const T* src = in + (int64_t)r * inY + c;
    const T uc = src[P];
    T ak = s * uc, am = T(0);
#pragma unroll
    for (int o = 0; o <= 2 * P; ++o) {
      const T v = src[o];
      ak += k[o] * (v - uc);
      am += m[o] * v;
    }
    A[(int64_t)r * C + c] = ak;
    B[(int64_t)r * C + c] = am;
  }
}

// x contraction of the y-stage pair, rows [x][C] for x < WX:
//     raw[x][c] = (Kx B)[x][c] in difference form + (Mx A)[x][c]
// for x < TX, handed to epi(x, c, raw).
template <typename T, int P, typename Epi>
__device__ __forceinline__ void stage_x(const T* B, const T* A, int TX, int C,
                                        int64_t gx0, const T* __restrict__ kb,
                                        const T* __restrict__ ks,
                                        const T* __restrict__ mb, int64_t N,
                                        Epi epi) {
  for (int xc = threadIdx.x; xc < TX * C; xc += blockDim.x) {
    const int x = xc / C, c = xc % C;
    T k[2 * P + 1], m[2 * P + 1];
    load_bands<T, P>(kb, mb, N, gx0 + x, k, m);
    const int64_t base = (int64_t)x * C + c;
    const T bc = B[base + P * C];
    T raw = ((gx0 + x < N) ? ks[gx0 + x] : T(0)) * bc;
#pragma unroll
    for (int o = 0; o <= 2 * P; ++o) {
      raw += k[o] * (B[base + o * C] - bc) + m[o] * A[base + o * C];
    }
    epi(x, c, raw);
  }
}

template <typename T, int P>
__global__ void __launch_bounds__(kThreads)
laplace2d_kernel(const T* __restrict__ u, const T* __restrict__ in1,
                 const T* __restrict__ in2, T* __restrict__ out0,
                 T* __restrict__ out1, T* __restrict__ out2,
                 const T* __restrict__ kb, const T* __restrict__ ks,
                 const T* __restrict__ mb, const T* __restrict__ dk,
                 const T* __restrict__ dm, T c0, T c1, int N_, int mode,
                 int TX, int TY) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int64_t N = N_;
  const int WX = TX + 2 * P, WY = TY + 2 * P;
  T* win = reinterpret_cast<T*>(smem_raw);
  T* A = win + WX * WY;  // Ky u on (WX, TY)
  T* B = A + WX * TY;    // My u on (WX, TY)
  const int64_t x0 = (int64_t)blockIdx.y * TX;
  const int64_t y0 = (int64_t)blockIdx.x * TY;

  // u window with a halo of P (zeros outside the grid)
  const int nwin = WX * WY;
  for (int i = threadIdx.x; i < nwin; i += blockDim.x) {
    const int ly = i % WY, lx = i / WY;
    const int64_t gx = x0 - P + lx, gy = y0 - P + ly;
    win[i] = (gx >= 0 && gx < N && gy >= 0 && gy < N) ? u[gx * N + gy] : T(0);
  }
  __syncthreads();

  // y: a = Ky u, b = My u on (WX, TY)
  stage_y<T, P>(win, WY, A, B, WX, TY, y0, kb, ks, mb, N);
  __syncthreads();

  // x: raw = Kx b + Mx a on the tile, then the mode's epilogue
  stage_x<T, P>(B, A, TX, TY, x0, kb, ks, mb, N, [&](int lx, int ly, T raw) {
    const int64_t gx = x0 + lx, gy = y0 + ly;
    if (gx >= N || gy >= N) return;
    laplace_epilogue(mode, gx * N + gy, raw, u, in1, in2, out0, out1, out2,
                     c0, c1, [&] { return dk[gx] * dm[gy] + dm[gx] * dk[gy]; });
  });
}

template <typename T, int P>
int launch_p(const T* u, const T* in1, const T* in2, T* out0, T* out1,
             T* out2, const T* kb, const T* ks, const T* mb, const T* dk,
             const T* dm, double c0, double c1, int N, int mode, int TX,
             int TY, void* stream) {
  const size_t smem = (size_t)smem_elems(P, TX, TY) * sizeof(T);
  cudaError_t err = allow_smem((const void*)laplace2d_kernel<T, P>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)ceil_div(N, TY), (unsigned)ceil_div(N, TX));
  laplace2d_kernel<T, P><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      u, in1, in2, out0, out1, out2, kb, ks, mb, dk, dm, (T)c0, (T)c1, N,
      mode, TX, TY);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const T* u, const T* in1, const T* in2, T* out0, T* out1, T* out2,
           const T* kb, const T* ks, const T* mb, const T* dk, const T* dm,
           double c0, double c1, int N, int p, int mode, int TX, int TY,
           void* stream) {
  // stage_y maps one thread to one column of the tile's y extent
  if (TY > kThreads || kThreads % TY != 0) return (int)cudaErrorInvalidValue;
  switch (p) {
#define PMG_CASE(PP)                                                        \
  case PP:                                                                  \
    return launch_p<T, PP>(u, in1, in2, out0, out1, out2, kb, ks, mb, dk,  \
                           dm, c0, c1, N, mode, TX, TY, stream);
    PMG_CASE(1) PMG_CASE(2) PMG_CASE(3) PMG_CASE(4) PMG_CASE(5) PMG_CASE(6)
    PMG_CASE(7)
#undef PMG_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int pmg_laplace2d_f32(const float* u, const float* in1,
                                 const float* in2, float* out0, float* out1,
                                 float* out2, const float* kb, const float* ks,
                                 const float* mb, const float* dk,
                                 const float* dm, double c0, double c1, int N,
                                 int p, int mode, int TX, int TY,
                                 void* stream) {
  return launch<float>(u, in1, in2, out0, out1, out2, kb, ks, mb, dk, dm, c0,
                       c1, N, p, mode, TX, TY, stream);
}

extern "C" int pmg_laplace2d_f64(const double* u, const double* in1,
                                 const double* in2, double* out0,
                                 double* out1, double* out2, const double* kb,
                                 const double* ks, const double* mb,
                                 const double* dk, const double* dm, double c0,
                                 double c1, int N, int p, int mode, int TX,
                                 int TY, void* stream) {
  return launch<double>(u, in1, in2, out0, out1, out2, kb, ks, mb, dk, dm, c0,
                        c1, N, p, mode, TX, TY, stream);
}
