// B.2 — cheb2lr, the recurrence-ending pair that also gives the next
// V-cycle residual r_out = r2 - A d2 (pallas_cheb2.py, rout=True): the
// ROUT instances of the kernel in cheb2.cuh, one per degree and type whose
// tile fits one block (p <= 5 in float, p <= 3 in double; the host's
// cheb2_tile refuses the others, and so does this dispatch).
#include "cheb2.cuh"

namespace {

template <typename T>
int launch_rout(const void* d, const void* r, const T* x, T* x2, T* rout,
                const T* kb, const T* mb, const T* ks, const T* dk,
                const T* dm, double c0a, double c1a, double c0b, double c1b,
                int N, int p, int LX, int TY, int NW, int flags,
                void* stream) {
  // x2 and r_out are stored in T; a double kernel has no bf16 flag
  if ((flags & kOutBF16) || (flags && sizeof(T) != 4))
    return (int)cudaErrorInvalidValue;
  switch (p) {
#define PMG_CASE(PP)                                                       \
  case PP:                                                                 \
    if constexpr (tile_ty<T, PP, true>() > 0)                              \
      return launch_grade<T, PP, true>(d, r, x, x2, rout, nullptr, kb, mb, \
                                       ks, dk, dm, c0a, c1a, c0b, c1b,     \
                                       March{N, N, 0, 0, 0, N, 0, 0, 0},   \
                                       kCheb2LR, LX, TY, NW, flags,        \
                                       stream);                            \
    return (int)cudaErrorInvalidValue;
    PMG_CASE(1) PMG_CASE(2) PMG_CASE(3) PMG_CASE(4) PMG_CASE(5) PMG_CASE(6)
    PMG_CASE(7)
#undef PMG_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// (LX, TY, NW): the compiled tile of cheb2_tile(..., rout=True); d and r
// are float or bf16 as the flags (StateFlags, float only) say; x, x2 and
// r_out are float.
extern "C" int pmg_cheb2lr_f32(const void* d, const void* r, const float* x,
                               float* x2, float* rout, const float* kb,
                               const float* mb, const float* ks,
                               const float* dk, const float* dm, double c0a,
                               double c1a, double c0b, double c1b, int N,
                               int p, int LX, int TY, int NW, int flags,
                               void* stream) {
  return launch_rout<float>(d, r, x, x2, rout, kb, mb, ks, dk, dm, c0a, c1a,
                            c0b, c1b, N, p, LX, TY, NW, flags, stream);
}

extern "C" int pmg_cheb2lr_f64(const void* d, const void* r, const double* x,
                               double* x2, double* rout, const double* kb,
                               const double* mb, const double* ks,
                               const double* dk, const double* dm, double c0a,
                               double c1a, double c0b, double c1b, int N,
                               int p, int LX, int TY, int NW, int flags,
                               void* stream) {
  return launch_rout<double>(d, r, x, x2, rout, kb, mb, ks, dk, dm, c0a, c1a,
                             c0b, c1b, N, p, LX, TY, NW, flags, stream);
}
