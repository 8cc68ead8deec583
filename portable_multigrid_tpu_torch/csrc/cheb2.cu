// B.2 — the pair's modes (cheb2, cheb2l, chebd2, chebd2l, cheb2f0,
// cheb2f0l) of the CUDA-core kernel in cheb2.cuh: the exact grade, float64
// and the production grade's instances that cheb2mma.cu does not replace.
#include "cheb2.cuh"

namespace {

// cheb2f0* is chebd2* on d = b / (theta diag) (the pre-pass, into
// scratch) and r = b (pair_prologue in cheb2.cuh).
template <typename T>
int launch(const void* d, const void* r, const T* x, void* out0, void* out1,
           T* out2, const T* kb, const T* mb, const T* ks, const T* dk,
           const T* dm, T* scratch, double c0a, double c1a, double c0b,
           double c1b, double theta, int N, int NX, int XOFF, int xext,
           int NY, int YOFF, int yext, int p, int mode, int LX, int TY,
           int NW, int flags, void* stream) {
  if (flags && sizeof(T) != 4) return (int)cudaErrorInvalidValue;
  March g;
  const int err =
      pair_prologue<T>(d, r, x, dk, dm, scratch, theta, N, NX, XOFF, xext,
                       NY, YOFF, yext, p, mode, flags, g, stream);
  if (err) return err;
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
