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
// order of MODES in ops/cuda_laplace.py.
enum LaplaceMode { kApply = 0, kRes1 = 1, kRes3 = 2, kCheb = 3, kChebL = 4,
                   kChebD = 5, kChebDL = 6 };

// The mode's elementwise epilogue at flat index g of the outputs, given
// raw = (M A M u)[g] (pallas_laplace.py:631-682):
//     apply       out = A u
//     residual1t  out = rhs - A u
//     residual3t  r0 = rhs - A u, d0 = r0 / (theta diag), x0 = u + d0
//     cheb        r' = r - A d, d' = c0 d + (c1 / diag) r', x' = x + d'
//     chebl       x' only;  chebd / chebdl: x == d on entry.
// in(k) gives the inputs at the point: u (k = 0), in1 (rhs / r) and in2
// (x); diag() the diagonal.  Only the modes that need an input or the
// diagonal call for it.
template <typename T, typename In, typename Diag>
__device__ __forceinline__ void laplace_epilogue(int mode, int64_t g, T raw,
                                                 In in, T* __restrict__ out0,
                                                 T* __restrict__ out1,
                                                 T* __restrict__ out2, T c0,
                                                 T c1, Diag diag) {
  if (mode == kApply) {
    out0[g] = raw;
    return;
  }
  if (mode == kRes1) {
    out0[g] = in(1) - raw;
    return;
  }
  const T dg = diag();
  if (mode == kRes3) {
    const T r0 = in(1) - raw;
    const T d0 = r0 / (c0 * dg);
    out0[g] = r0;
    out1[g] = d0;
    out2[g] = in(0) + d0;
    return;
  }
  const T d = in(0);
  const T x = (mode == kChebD || mode == kChebDL) ? d : in(2);
  const T rn = in(1) - raw;
  const T dn = c0 * d + (c1 / dg) * rn;
  if (mode == kChebL || mode == kChebDL) {
    out0[g] = x + dn;
  } else {
    out0[g] = rn;
    out1[g] = dn;
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
