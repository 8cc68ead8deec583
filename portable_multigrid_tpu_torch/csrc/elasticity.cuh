// B.5's launch interface, shared by its two instances: the CUDA-core kernel
// (elasticity.cu: the exact core, float64 and the slab) and the tensor-core
// kernel of the mxu grade (elasticitymma.cu).  They share the operator's
// arrays, the launch checks, the C entry point's arguments and
// laplace_epilogue (common.cuh), and no arithmetic.
#pragma once

#include "common.cuh"

namespace pmg {

// The four band arrays [2p+1, N] and the row sums [N] of K, G, H.
template <typename T>
struct Bands {
  const T* kb;
  const T* ks;
  const T* mb;
  const T* gb;
  const T* gs;
  const T* hb;
  const T* hs;
};

// The operator's arrays and the launch geometry, as the host hands them
// over: the y-z factors (b; dk, dm) of extent N and the x factors (xb; xdk,
// xdm) of NX rows, NX output planes from NXI input planes.  On the cube x
// has the y-z factors and NX = NXI = N; on a slab x has the slab's own
// and NXI = NX + 1 (the input is x-full).
template <typename T>
struct Operator {
  Bands<T> b;
  const T *dk, *dm;
  Bands<T> xb;
  const T *xdk, *xdm;
  int N, NX, NXI;
};

// The checks of both instances: a trimmed-state mode; the state streams
// never bf16 and the mxu grade (kRoundBF16) in float only; an x-full input
// (a slab's) takes apply alone.
template <typename T>
inline bool elasticity_args_ok(const Operator<T>& op, int mode, int flags) {
  return mode >= kApply && mode <= kChebDL && !(flags & ~kRoundBF16) &&
         !(flags && sizeof(T) != 4) && op.N >= 1 && op.NX >= 1 &&
         op.NXI >= op.NX && (op.NXI == op.NX || mode == kApply);
}

}  // namespace pmg

// The C entry point NAME in T: kb .. dm the y-z factors (extent N), xkb ..
// xdm the x factors (NX rows), NX output planes from NXI input planes (the
// Operator above); flags kRoundBF16 for the mxu grade, else 0; (LX, TY, W)
// the launch tile, which LAUNCH (the instance's, with these arguments)
// reads.
#define PMG_ELASTICITY_ENTRY(NAME, T, LAUNCH)                                \
  extern "C" int NAME(                                                       \
      const T* u, const T* in1, const T* in2, T* out0, T* out1, T* out2,     \
      const T* kb, const T* ks, const T* mb, const T* gb, const T* gs,       \
      const T* hb, const T* hs, const T* dk, const T* dm, const T* xkb,      \
      const T* xks, const T* xmb, const T* xgb, const T* xgs, const T* xhb,  \
      const T* xhs, const T* xdk, const T* xdm, double mu, double lam,       \
      double c0, double c1, int N, int NX, int NXI, int p, int mode, int LX, \
      int TY, int W, int flags, void* stream) {                              \
    const pmg::Operator<T> op{{kb, ks, mb, gb, gs, hb, hs},                  \
                              dk,                                            \
                              dm,                                            \
                              {xkb, xks, xmb, xgb, xgs, xhb, xhs},           \
                              xdk,                                           \
                              xdm,                                           \
                              N,                                             \
                              NX,                                            \
                              NXI};                                          \
    if (!pmg::elasticity_args_ok(op, mode, flags))                           \
      return (int)cudaErrorInvalidValue;                                     \
    return LAUNCH(u, in1, in2, out0, out1, out2, op, mu, lam, c0, c1, p,     \
                  mode, LX, TY, W, flags, stream);                           \
  }
