// Shared device helpers for the port's hand-written Hopper kernels.
//
// State layout everywhere: a trimmed 3D grid [x, y, z] of N^3 values,
// C-order with z contiguous, or a trimmed 2D grid [x, y] with y contiguous
// (the global last plane per axis is dropped and constrained entries are
// zero).  1D operators are stored as bands:
// band[(o + p) * N + i] = W[i, i + o] for o in [-p, p], zero where i + o
// leaves [0, N) — the Dirichlet mask is folded into the matrices, so a
// contraction never needs a separate mask.  A kernel keeps the 2(2p+1)
// coefficients of the rows it contracts in registers (the degree p is a
// template parameter); threads next to each other own neighbouring entries
// of the contiguous axis, so shared and global accesses are contiguous
// across a warp.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pmg {

constexpr int kThreads = 256;

// Separable diagonal of A = Kx My Mz + Mx Ky Mz + Mx My Kz from its 1D
// diagonal factors (raw, unmasked values on constrained entries).
template <typename T>
__device__ __forceinline__ T diag_at(const T* __restrict__ dk,
                                     const T* __restrict__ dm, int64_t gx,
                                     int64_t gy, int64_t gz) {
  return dk[gx] * dm[gy] * dm[gz] + dm[gx] * (dk[gy] * dm[gz] + dm[gy] * dk[gz]);
}

// Modes of the fused Laplace kernels (laplace.cu, laplace2d.cu), in the
// order of KERNEL_MODES in ops/cuda_laplace.py: the trimmed modes, then
// B.1's untrimmed residual (laplace.cu alone), whose u and rhs lie on the
// full grid.
enum LaplaceMode { kApply = 0, kRes1 = 1, kRes3 = 2, kCheb = 3, kChebL = 4,
                   kChebD = 5, kChebDL = 6, kResidual = 7 };

// Storage of the state streams.  The Chebyshev recurrence's r and d may
// live in bf16 between passes while every kernel computes in T (JAX's
// sdtype="bf16"): a stream is read through stage_bits and unstage (below)
// and written through store_state, which rounds to nearest even
// (__float2bfloat16_rn, as JAX's astype and torch's .to(torch.bfloat16)
// round).  A flag says which storage a stream has; a double kernel never
// gets a bf16 flag (the wrappers refuse it).
template <typename T>
__device__ __forceinline__ void store_state(void* p, int64_t g, T v, bool bf) {
  if (bf)
    static_cast<__nv_bfloat16*>(p)[g] = __float2bfloat16_rn(float(v));
  else
    static_cast<T*>(p)[g] = v;
}

// v rounded to bf16 and back: the rounding points of the bf16 operator
// grade (the JAX package's "mxu" core and B.2's production grade)
template <typename T>
__device__ __forceinline__ T round_bf16(T v) {
  return T(__bfloat162float(__float2bfloat16_rn(float(v))));
}

// Launch flags of the Laplace family (laplace.cu, cheb2.cu, laplace2d.cu):
// the stencil input and the first epilogue input (u and r, or d and r) are
// bf16; the two recurrence outputs (r', d') are bf16; the operator rounds
// at the bf16 grade.
enum StateFlags { kInBF16 = 1, kOutBF16 = 2, kRoundBF16 = 4 };

// The mode's elementwise epilogue at flat index g of the outputs, given
// raw = (M A M u)[g] (pallas_laplace.py:631-682):
//     apply       out = A u
//     residual1t  out = rhs - A u
//     residual3t  r0 = rhs - A u, d0 = r0 / (theta diag), x0 = u + d0
//     residual    r0 and d0 of residual3t, both in T (no x0)
//     cheb        r' = r - A d, d' = c0 d + (c1 / diag) r', x' = x + d'
//     chebl       x' only;  chebd / chebdl: x == d on entry.
// in(k) gives the inputs at the point in T: u (k = 0), in1 (rhs / r) and
// in2 (x); diag() the diagonal.  Only the modes that need an input or the
// diagonal call for it.  With obf the recurrence outputs (r0 and d0, r'
// and d') are stored in bf16; x0 and x' take the unrounded d0 and d', as
// the TPU kernel's out_dtypes do, and stay in T with every other output.
template <typename T, typename In, typename Diag>
__device__ __forceinline__ void laplace_epilogue(int mode, int64_t g, T raw,
                                                 In in, void* __restrict__ out0,
                                                 void* __restrict__ out1,
                                                 T* __restrict__ out2, T c0,
                                                 T c1, Diag diag,
                                                 bool obf = false) {
  T* o0 = static_cast<T*>(out0);
  if (mode == kApply) {
    o0[g] = raw;
    return;
  }
  if (mode == kRes1) {
    o0[g] = in(1) - raw;
    return;
  }
  const T dg = diag();
  if (mode == kResidual) {
    const T r0 = in(1) - raw;
    o0[g] = r0;
    static_cast<T*>(out1)[g] = r0 / (c0 * dg);
    return;
  }
  if (mode == kRes3) {
    const T r0 = in(1) - raw;
    const T d0 = r0 / (c0 * dg);
    store_state(out0, g, r0, obf);
    store_state(out1, g, d0, obf);
    out2[g] = in(0) + d0;
    return;
  }
  const T d = in(0);
  const T x = (mode == kChebD || mode == kChebDL) ? d : in(2);
  const T rn = in(1) - raw;
  const T dn = c0 * d + (c1 / dg) * rn;
  if (mode == kChebL || mode == kChebDL) {
    o0[g] = x + dn;
  } else {
    store_state(out0, g, rn, obf);
    store_state(out1, g, dn, obf);
    out2[g] = x + dn;
  }
}

// The same, with the inputs read from global fields at g.
template <typename T, typename Diag>
__device__ __forceinline__ void laplace_epilogue(
    int mode, int64_t g, T raw, const T* __restrict__ u,
    const T* __restrict__ in1, const T* __restrict__ in2, T* __restrict__ out0,
    T* __restrict__ out1, T* __restrict__ out2, T c0, T c1, Diag diag) {
  laplace_epilogue(
      mode, g, raw, [&](int k) { return (k == 0 ? u : k == 1 ? in1 : in2)[g]; },
      out0, out1, out2, c0, c1, diag);
}

// Asynchronous copy of one element from global to shared memory (cp.async,
// L1-allocating); with valid false it writes a zero and reads nothing, and
// src need only be a valid global address.
template <typename T>
__device__ __forceinline__ void cp_async_elem(T* dst, const T* src,
                                              bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
               "l"(src), "n"(sizeof(T)), "r"(valid ? (int)sizeof(T) : 0)
               : "memory");
}

// A float element of a state stream on its way to shared memory through a
// register, for the streams cp.async cannot move: cp.async copies 4, 8 or
// 16 bytes, never a 2-byte bf16, and a window of bf16 pairs would be
// misaligned wherever it starts at an odd element (z0 - p with p odd); and
// it cannot round.  stage_bits issues the load (the raw bits: bf16 in the
// low half, or a float) a plane ahead of its use, as cp.async would;
// nothing waits for it until unstage, at the top of the next plane,
// converts it (a bf16 is the top half of a float) and with rnd rounds it
// to bf16.  With valid false the bits are zero; base need only be a valid
// global address.
__device__ __forceinline__ uint32_t stage_bits(const void* base, int64_t g,
                                               bool valid, bool bf) {
  uint32_t bits = 0;
  if (valid)
    bits = bf ? (uint32_t) static_cast<const unsigned short*>(base)[g]
              : __float_as_uint(static_cast<const float*>(base)[g]);
  return bits;
}

__device__ __forceinline__ float unstage(uint32_t bits, bool bf, bool rnd) {
  const float v = __uint_as_float(bf ? bits << 16 : bits);
  return rnd ? round_bf16(v) : v;
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Dynamic shared memory above 48 KB must be opted into per kernel.
inline cudaError_t allow_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

__host__ __device__ inline int64_t ceil_div(int64_t a, int64_t b) {
  return (a + b - 1) / b;
}

}  // namespace pmg
