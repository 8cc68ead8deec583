// B.2 — the pair's modes (cheb2, cheb2l, chebd2, chebd2l, cheb2f0,
// cheb2f0l) of the kernel in cheb2.cuh, and the cheb2f0 pre-pass.
#include "cheb2.cuh"

namespace {

// The cheb2f0 pre-pass: d0 = b / (theta diag) on the trimmed grid, one
// block per (x, y) row, the threads along z.  An elementwise HBM pass
// (8 B a point in f32); it takes the b / (theta diag) of every window point
// out of the marching kernel, which would repeat it for each of the 3-4
// windows that hold the point.
template <typename T>
__global__ void __launch_bounds__(kThreads)
rhs_kernel(const T* __restrict__ b, T* __restrict__ d0,
           const T* __restrict__ dk, const T* __restrict__ dm, T theta,
           int N_) {
  const int64_t N = N_, row = blockIdx.x, gx = row / N, gy = row % N;
  for (int64_t gz = threadIdx.x; gz < N; gz += blockDim.x) {
    const int64_t g = row * N + gz;
    d0[g] = b[g] / (theta * diag_at(dk, dm, gx, gy, gz));
  }
}

// cheb2f0* is chebd2* on d = b / (theta diag) (the pre-pass, into
// scratch) and r = b
template <typename T>
int launch(const void* d, const void* r, const T* x, void* out0, void* out1,
           T* out2, const T* kb, const T* mb, const T* ks, const T* dk,
           const T* dm, T* scratch, double c0a, double c1a, double c0b,
           double c1b, double theta, int N, int p, int mode, int LX, int TY,
           int NW, int flags, void* stream) {
  if (mode < kCheb2 || mode > kF0L || (flags && sizeof(T) != 4))
    return (int)cudaErrorInvalidValue;
  if (mode == kF0 || mode == kF0L) {
    // b comes in T, and the pre-pass writes d0 in T: the pair's inputs
    // (d0, b) are never bf16
    if (!scratch || (flags & kInBF16)) return (int)cudaErrorInvalidValue;
    rhs_kernel<T><<<(unsigned)((int64_t)N * N), kThreads, 0,
                    (cudaStream_t)stream>>>(static_cast<const T*>(d), scratch,
                                            dk, dm, (T)theta, N);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    r = d;
    d = scratch;
    x = nullptr;
    mode = mode == kF0 ? kChebD2 : kChebD2L;
  }
  switch (p) {
#define PMG_CASE(PP)                                                         \
  case PP:                                                                   \
    return launch_grade<T, PP, false>(d, r, x, out0, out1, out2, kb, mb, ks, \
                                      dk, dm, c0a, c1a, c0b, c1b, N, mode,   \
                                      LX, TY, NW, flags, stream);
    PMG_CASE(1) PMG_CASE(2) PMG_CASE(3) PMG_CASE(4) PMG_CASE(5) PMG_CASE(6)
    PMG_CASE(7)
#undef PMG_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// (LX, TY, NW): LX output planes per block along x, TY interior rows of the
// block's y-z column and NW warps (the compiled tile of cheb2_tile);
// scratch: a trimmed field for the cheb2f0 modes' d0, else unused; flags:
// the StateFlags of the launch (float only).  d, r, out0 and out1 are
// float or bf16 as the flags say.
extern "C" int pmg_cheb2_f32(const void* d, const void* r, const float* x,
                             void* out0, void* out1, float* out2,
                             const float* kb, const float* mb, const float* ks,
                             const float* dk, const float* dm, float* scratch,
                             double c0a, double c1a, double c0b, double c1b,
                             double theta, int N, int p, int mode, int LX,
                             int TY, int NW, int flags, void* stream) {
  return launch<float>(d, r, x, out0, out1, out2, kb, mb, ks, dk, dm, scratch,
                       c0a, c1a, c0b, c1b, theta, N, p, mode, LX, TY, NW,
                       flags, stream);
}

extern "C" int pmg_cheb2_f64(const void* d, const void* r, const double* x,
                             void* out0, void* out1, double* out2,
                             const double* kb, const double* mb,
                             const double* ks, const double* dk,
                             const double* dm, double* scratch, double c0a,
                             double c1a, double c0b, double c1b, double theta,
                             int N, int p, int mode, int LX, int TY, int NW,
                             int flags, void* stream) {
  return launch<double>(d, r, x, out0, out1, out2, kb, mb, ks, dk, dm, scratch,
                        c0a, c1a, c0b, c1b, theta, N, p, mode, LX, TY, NW,
                        flags, stream);
}
