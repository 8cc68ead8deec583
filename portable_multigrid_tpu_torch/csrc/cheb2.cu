// B.2 — the pair's modes (cheb2, cheb2l, chebd2, chebd2l, cheb2f0,
// cheb2f0l) of the kernel in cheb2.cuh, and the cheb2f0 pre-pass.
#include "cheb2.cuh"

namespace {

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

// cheb2f0* is chebd2* on d = b / (theta diag) (the pre-pass, into
// scratch) and r = b.  xext: the shard's march (March in cheb2.cuh) of
// NX planes from global plane XOFF, with d and x (= d) extended by 2p
// planes a side and r by p (by 2p for cheb2f0*, where r is b).  yext:
// likewise over NY rows from global row YOFF, with 2p and p rows a side.
template <typename T>
int launch(const void* d, const void* r, const T* x, void* out0, void* out1,
           T* out2, const T* kb, const T* mb, const T* ks, const T* dk,
           const T* dm, T* scratch, double c0a, double c1a, double c0b,
           double c1b, double theta, int N, int NX, int XOFF, int xext,
           int NY, int YOFF, int yext, int p, int mode, int LX, int TY,
           int NW, int flags, void* stream) {
  if (mode < kCheb2 || mode > kF0L || (flags && sizeof(T) != 4) ||
      (!xext && (NX != N || XOFF != 0)) || (!yext && (NY != N || YOFF != 0)))
    return (int)cudaErrorInvalidValue;
  const bool f0 = mode == kF0 || mode == kF0L;
  const int hd = 2 * p, hr = (f0 ? 2 : 1) * p;
  const March g{N,  NX,   XOFF,           xext ? hd : 0, xext ? hr : 0,
                NY, YOFF, yext ? hd : 0, yext ? hr : 0};
  if (f0) {
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
  }
  switch (p) {
#define PMG_CASE(PP)                                                         \
  case PP:                                                                   \
    return launch_grade<T, PP, false>(d, r, x, out0, out1, out2, kb, mb, ks, \
                                      dk, dm, c0a, c1a, c0b, c1b, g, mode,   \
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
// scratch: a field of d's shape for the cheb2f0 modes' d0, else unused;
// flags: the StateFlags of the launch (float only).  d, r, out0 and out1
// are float or bf16 as the flags say.  N: the grid's extent; NX, XOFF,
// xext: the march of a shard along x (NX = N, XOFF = 0, xext = 0 on the
// cube); NY, YOFF, yext: along y (a pencil's; NY = N, YOFF = 0, yext = 0
// elsewhere).
#define PMG_CHEB2_ENTRY(NAME, T)                                              \
  extern "C" int NAME(const void* d, const void* r, const T* x, void* out0,  \
                      void* out1, T* out2, const T* kb, const T* mb,         \
                      const T* ks, const T* dk, const T* dm, T* scratch,     \
                      double c0a, double c1a, double c0b, double c1b,        \
                      double theta, int N, int NX, int XOFF, int xext,       \
                      int NY, int YOFF, int yext, int p, int mode, int LX,   \
                      int TY, int NW, int flags, void* stream) {             \
    return launch<T>(d, r, x, out0, out1, out2, kb, mb, ks, dk, dm, scratch, \
                     c0a, c1a, c0b, c1b, theta, N, NX, XOFF, xext, NY, YOFF, \
                     yext, p, mode, LX, TY, NW, flags, stream);              \
  }

PMG_CHEB2_ENTRY(pmg_cheb2_f32, float)
PMG_CHEB2_ENTRY(pmg_cheb2_f64, double)
