// B.2 — two Chebyshev recurrence steps per pass (temporal blocking).
//
// Replaces the TPU kernel portable_multigrid_tpu/ops/pallas_cheb2.py
// Cheb2Kernel.steps2 (modes cheb2, cheb2l, chebd2, chebd2l, cheb2f0,
// cheb2f0l at its exact=True grade).  On trimmed state it computes
//     r1 = r  - A d      d1 = c0a d  + (c1a / diag) r1
//     r2 = r1 - A d1     d2 = c0b d1 + (c1b / diag) r2
//     x2 = x + d1 + d2
// with A the mask-folded banded operator of laplace.cu.  "l" modes write x2
// only; chebd2* take x == d; cheb2f0* start from the rhs b (passed in the d
// slot): d0 = b / (theta diag), r0 = b, x0 = d0, all derived in-kernel.
//
// What bounds it on the H100: HBM traffic, 24 B/DoF in f32 for two steps
// (d, r, x in; r2, d2, x2 out) against 48 B/DoF for two single steps: the
// pair halves the smoother's dominant stream, which is the point of the
// kernel.  At 3.35 TB/s the r=6 Q4 fine level needs 120 us per pair.
//
// Design: the second application A d1 needs d1 completed within p of every
// output point, so a block owning a TX x TY x TZ tile loads d with a 2p halo
// in all three dimensions, computes step one redundantly on the tile grown
// by p, and step two on the tile itself; r and x are read straight from
// global memory at the points that need them.  Unlike the TPU kernel, where
// z sits whole in the lanes, the halo here is 3D, so the window and the
// stage buffers grow as (T + 4p)^3: the host picks the largest tile that
// fits the 227 KB of shared memory per block, and a block of 512 threads
// brings enough warps to an SM that holds only one such block.  Where even
// the smallest candidate does not fit (p >= 5 in f64, p = 7 in f32), the
// same code runs on per-block slices of a global workspace that the wrapper
// allocates — a correct, slower path.  The redundant halo work (about 6x
// the FMAs of two plain steps at p = 4 with 8x8x16 tiles) is the cost of
// this first version.
#include "common.cuh"

using namespace pmg;

namespace {

// one block per SM fits the buffers, so the block brings its own warps
constexpr int kPairThreads = 512;

enum Mode { kCheb2 = 0, kCheb2L = 1, kChebD2 = 2, kChebD2L = 3, kF0 = 4,
            kF0L = 5 };

// per-block buffer elements (buf0, buf1); must match cheb2_smem_elems() in
// ops/cuda_cheb2.py
__host__ __device__ inline int64_t smem_elems(int p, int TX, int TY, int TZ,
                                              int64_t* buf0) {
  const int64_t DX = TX + 4 * p, DY = TY + 4 * p, DZ = TZ + 4 * p;
  const int64_t EX = TX + 2 * p, EY = TY + 2 * p, EZ = TZ + 2 * p;
  const int64_t win = DX * DY * DZ;
  const int64_t y1 = 2 * DX * EY * EZ;
  const int64_t s2 = 2 * EX * EY * TZ + 2 * EX * TY * TZ;
  int64_t b0 = win > y1 ? win : y1;
  b0 = b0 > s2 ? b0 : s2;
  const int64_t z1 = 2 * DX * DY * EZ;
  const int64_t e1 = 2 * EX * EY * EZ;
  if (buf0) *buf0 = b0;
  return b0 + (z1 > e1 ? z1 : e1);
}

template <typename T, int P>
__global__ void __launch_bounds__(kPairThreads)
cheb2_kernel(const T* __restrict__ d, const T* __restrict__ r,
             const T* __restrict__ x, T* __restrict__ out0,
             T* __restrict__ out1, T* __restrict__ out2,
             const T* __restrict__ kb, const T* __restrict__ mb,
             const T* __restrict__ dk, const T* __restrict__ dm, T c0a, T c1a,
             T c0b, T c1b, T theta, int N_, int mode, int TX, int TY, int TZ,
             T* workspace) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int64_t N = N_;
  const int DX = TX + 4 * P, DY = TY + 4 * P, DZ = TZ + 4 * P;
  const int EX = TX + 2 * P, EY = TY + 2 * P, EZ = TZ + 2 * P;
  int64_t b0;
  const int64_t per_block = smem_elems(P, TX, TY, TZ, &b0);
  T* buf0;
  if (workspace) {
    const int64_t blk =
        ((int64_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    buf0 = workspace + blk * per_block;
  } else {
    buf0 = reinterpret_cast<T*>(smem_raw);
  }
  T* buf1 = buf0 + b0;
  const int64_t x0 = (int64_t)blockIdx.z * TX;
  const int64_t y0 = (int64_t)blockIdx.y * TY;
  const int64_t z0 = (int64_t)blockIdx.x * TZ;
  const bool f0 = mode == kF0 || mode == kF0L;

  // ---- d window with a 2P halo (d0 = b / (theta diag) in the f0 modes)
  const int nwin = DX * DY * DZ;
  for (int i = threadIdx.x; i < nwin; i += blockDim.x) {
    const int lz = i % DZ, t = i / DZ, ly = t % DY, lx = t / DY;
    const int64_t gx = x0 - 2 * P + lx, gy = y0 - 2 * P + ly,
                  gz = z0 - 2 * P + lz;
    T v = T(0);
    if (inside(gx, gy, gz, N)) {
      v = d[(gx * N + gy) * N + gz];
      if (f0) v = v / (theta * diag_at(dk, dm, gx, gy, gz));
    }
    buf0[i] = v;
  }
  __syncthreads();

  // ---- step one on the tile grown by P: z, y, x
  T* A1 = buf1;
  T* B1 = buf1 + (int64_t)DX * DY * EZ;
  stage_z<T, P>(buf0, DZ, A1, B1, DX * DY, EZ, z0 - P, kb, mb, N);
  __syncthreads();
  T* MB1 = buf0;
  T* S1 = buf0 + (int64_t)DX * EY * EZ;
  stage_y<T, P>(A1, B1, DY, MB1, S1, DX, EY, EZ, y0 - P, kb, mb, N);
  __syncthreads();
  // r1 = r - A d, d1 = c0a d + (c1a / diag) r1 (zero outside the grid)
  T* D1 = buf1;
  T* R1 = buf1 + (int64_t)EX * EY * EZ;
  stage_x<T, P>(MB1, S1, EX, EY, EZ, x0 - P, kb, mb, N,
                [&](int lx, int ly, int lz, T raw) {
    const int64_t gx = x0 - P + lx, gy = y0 - P + ly, gz = z0 - P + lz;
    T r1 = T(0), d1 = T(0);
    if (inside(gx, gy, gz, N)) {
      const int64_t g = (gx * N + gy) * N + gz;
      const T diag = diag_at(dk, dm, gx, gy, gz);
      T dE, rE;
      if (f0) {
        rE = d[g];
        dE = rE / (theta * diag);
      } else {
        rE = r[g];
        dE = d[g];
      }
      r1 = rE - raw;
      d1 = c0a * dE + (c1a / diag) * r1;
    }
    const int64_t e = ((int64_t)lx * EY + ly) * EZ + lz;
    D1[e] = d1;
    R1[e] = r1;
  });
  __syncthreads();

  // ---- step two on the tile: z, y, x
  T* A2 = buf0;
  T* B2 = buf0 + (int64_t)EX * EY * TZ;
  stage_z<T, P>(D1, EZ, A2, B2, EX * EY, TZ, z0, kb, mb, N);
  __syncthreads();
  T* MB2 = buf0 + 2 * (int64_t)EX * EY * TZ;
  T* S2 = MB2 + (int64_t)EX * TY * TZ;
  stage_y<T, P>(A2, B2, EY, MB2, S2, EX, TY, TZ, y0, kb, mb, N);
  __syncthreads();
  const bool last = mode == kCheb2L || mode == kChebD2L || mode == kF0L;
  stage_x<T, P>(MB2, S2, TX, TY, TZ, x0, kb, mb, N,
                [&](int lx, int ly, int lz, T raw) {
    const int64_t gx = x0 + lx, gy = y0 + ly, gz = z0 + lz;
    if (gx >= N || gy >= N || gz >= N) return;
    const int64_t e = ((int64_t)(lx + P) * EY + ly + P) * EZ + lz + P;
    const int64_t g = (gx * N + gy) * N + gz;
    const T diag = diag_at(dk, dm, gx, gy, gz);
    const T d1 = D1[e];
    const T r2 = R1[e] - raw;
    const T d2 = c0b * d1 + (c1b / diag) * r2;
    T xv;
    if (mode == kCheb2 || mode == kCheb2L) {
      xv = x[g];
    } else if (f0) {
      xv = d[g] / (theta * diag);
    } else {
      xv = d[g];
    }
    const T x2 = xv + d1 + d2;
    if (last) {
      out0[g] = x2;
    } else {
      out0[g] = r2;
      out1[g] = d2;
      out2[g] = x2;
    }
  });
}

template <typename T, int P>
int launch_p(const T* d, const T* r, const T* x, T* out0, T* out1, T* out2,
             const T* kb, const T* mb, const T* dk, const T* dm, double c0a,
             double c1a, double c0b, double c1b, double theta, int N,
             int mode, int TX, int TY, int TZ, T* workspace, void* stream) {
  size_t smem = 0;
  if (!workspace) {
    smem = (size_t)smem_elems(P, TX, TY, TZ, nullptr) * sizeof(T);
    cudaError_t err = allow_smem((const void*)cheb2_kernel<T, P>, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)ceil_div(N, TZ), (unsigned)ceil_div(N, TY),
                  (unsigned)ceil_div(N, TX));
  cheb2_kernel<T, P><<<grid, kPairThreads, smem, (cudaStream_t)stream>>>(
      d, r, x, out0, out1, out2, kb, mb, dk, dm, (T)c0a, (T)c1a, (T)c0b,
      (T)c1b, (T)theta, N, mode, TX, TY, TZ, workspace);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const T* d, const T* r, const T* x, T* out0, T* out1, T* out2,
           const T* kb, const T* mb, const T* dk, const T* dm, double c0a,
           double c1a, double c0b, double c1b, double theta, int N, int p,
           int mode, int TX, int TY, int TZ, T* workspace, void* stream) {
  switch (p) {
#define PMG_CASE(PP)                                                          \
  case PP:                                                                    \
    return launch_p<T, PP>(d, r, x, out0, out1, out2, kb, mb, dk, dm, c0a,   \
                           c1a, c0b, c1b, theta, N, mode, TX, TY, TZ,         \
                           workspace, stream);
    PMG_CASE(1) PMG_CASE(2) PMG_CASE(3) PMG_CASE(4) PMG_CASE(5) PMG_CASE(6)
    PMG_CASE(7)
#undef PMG_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int pmg_cheb2_f32(const float* d, const float* r, const float* x,
                             float* out0, float* out1, float* out2,
                             const float* kb, const float* mb, const float* dk,
                             const float* dm, double c0a, double c1a,
                             double c0b, double c1b, double theta, int N,
                             int p, int mode, int TX, int TY, int TZ,
                             float* workspace, void* stream) {
  return launch<float>(d, r, x, out0, out1, out2, kb, mb, dk, dm, c0a, c1a,
                       c0b, c1b, theta, N, p, mode, TX, TY, TZ, workspace,
                       stream);
}

extern "C" int pmg_cheb2_f64(const double* d, const double* r,
                             const double* x, double* out0, double* out1,
                             double* out2, const double* kb, const double* mb,
                             const double* dk, const double* dm, double c0a,
                             double c1a, double c0b, double c1b, double theta,
                             int N, int p, int mode, int TX, int TY, int TZ,
                             double* workspace, void* stream) {
  return launch<double>(d, r, x, out0, out1, out2, kb, mb, dk, dm, c0a, c1a,
                        c0b, c1b, theta, N, p, mode, TX, TY, TZ, workspace,
                        stream);
}
