// Shared device helpers for the port's hand-written Hopper kernels.
//
// State layout everywhere: a trimmed 3D grid [x, y, z] of N^3 values,
// C-order with z contiguous, or a trimmed 2D grid [x, y] with y contiguous
// (the global last plane per axis is dropped and constrained entries are
// zero).  A 2D kernel contracts its contiguous axis with stage_z.  1D operators are stored as bands:
// band[(o + p) * N + i] = W[i, i + o] for o in [-p, p], zero where i + o
// leaves [0, N) — the Dirichlet mask is folded into the matrices, so a
// contraction never needs a separate mask.
//
// The stage helpers below contract one axis of a shared-memory block.  The
// band coefficients of an output row depend only on its index along the
// contracted axis, so each thread keeps the 2(2p+1) coefficients of its row
// in registers (the degree p is a template parameter) and walks the other
// in-block axis with them; threads next to each other own neighbouring z
// entries, so shared and global accesses are contiguous across a warp.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace pmg {

constexpr int kThreads = 256;

// The 2P+1 coefficients of row g of the K and M bands (zeros for a row
// outside [0, N), which makes its outputs zero).
template <typename T, int P>
__device__ __forceinline__ void load_bands(const T* __restrict__ kb,
                                           const T* __restrict__ mb, int64_t N,
                                           int64_t g, T (&k)[2 * P + 1],
                                           T (&m)[2 * P + 1]) {
  const bool in = g >= 0 && g < N;
#pragma unroll
  for (int o = 0; o <= 2 * P; ++o) {
    k[o] = in ? kb[o * N + g] : T(0);
    m[o] = in ? mb[o * N + g] : T(0);
  }
}

// z contraction: for rows r < R of an input with row length inZ,
//   outK[r][c] = sum_o Kz[gz0 + c][o] in[r][c + o],  outM likewise,
// c < C.  Output c's stencil centre sits at input index c + P.
template <typename T, int P>
__device__ __forceinline__ void stage_z(const T* in, int inZ, T* outK, T* outM,
                                        int R, int C, int64_t gz0,
                                        const T* __restrict__ kb,
                                        const T* __restrict__ mb, int64_t N) {
  const int rows = blockDim.x / C;
  const int c = threadIdx.x % C, r0 = threadIdx.x / C;
  if (r0 >= rows) return;
  T k[2 * P + 1], m[2 * P + 1];
  load_bands<T, P>(kb, mb, N, gz0 + c, k, m);
  for (int r = r0; r < R; r += rows) {
    const T* src = in + (int64_t)r * inZ + c;
    T ak = T(0), am = T(0);
#pragma unroll
    for (int o = 0; o <= 2 * P; ++o) {
      const T v = src[o];
      ak += k[o] * v;
      am += m[o] * v;
    }
    outK[(int64_t)r * C + c] = ak;
    outM[(int64_t)r * C + c] = am;
  }
}

// y contraction of the z-stage pair (a = Kz u, b = Mz u), input [A][Bin][C]:
//   MB[x][y][c] = sum_o My[gy0 + y][o] b[x][y + o][c]
//   S [x][y][c] = sum_o Ky[..][o] b[x][y + o][c] + My[..][o] a[x][y + o][c]
// for x < A, y < B.
template <typename T, int P>
__device__ __forceinline__ void stage_y(const T* a, const T* b, int Bin,
                                        T* MB, T* S, int A, int B, int C,
                                        int64_t gy0, const T* __restrict__ kb,
                                        const T* __restrict__ mb, int64_t N) {
  for (int yc = threadIdx.x; yc < B * C; yc += blockDim.x) {
    const int y = yc / C, c = yc % C;
    T k[2 * P + 1], m[2 * P + 1];
    load_bands<T, P>(kb, mb, N, gy0 + y, k, m);
    for (int x = 0; x < A; ++x) {
      const int64_t base = ((int64_t)x * Bin + y) * C + c;
      T vm = T(0), vs = T(0);
#pragma unroll
      for (int o = 0; o <= 2 * P; ++o) {
        const T bv = b[base + (int64_t)o * C];
        vm += m[o] * bv;
        vs += k[o] * bv + m[o] * a[base + (int64_t)o * C];
      }
      const int64_t out = ((int64_t)x * B + y) * C + c;
      MB[out] = vm;
      S[out] = vs;
    }
  }
}

// x contraction of the y-stage pair, input [Ain][B][C]:
//   raw[x][y][c] = sum_o Kx[gx0 + x][o] MB[x + o][y][c] + Mx[..][o] S[x + o][y][c]
// for x < A, handed to epi(x, y, c, raw).
template <typename T, int P, typename Epi>
__device__ __forceinline__ void stage_x(const T* MB, const T* S, int A, int B,
                                        int C, int64_t gx0,
                                        const T* __restrict__ kb,
                                        const T* __restrict__ mb, int64_t N,
                                        Epi epi) {
  const int64_t plane = (int64_t)B * C;
  for (int xc = threadIdx.x; xc < A * C; xc += blockDim.x) {
    const int x = xc / C, c = xc % C;
    T k[2 * P + 1], m[2 * P + 1];
    load_bands<T, P>(kb, mb, N, gx0 + x, k, m);
    for (int y = 0; y < B; ++y) {
      const int64_t base = (int64_t)x * plane + (int64_t)y * C + c;
      T raw = T(0);
#pragma unroll
      for (int o = 0; o <= 2 * P; ++o) {
        raw += k[o] * MB[base + o * plane] + m[o] * S[base + o * plane];
      }
      epi(x, y, c, raw);
    }
  }
}

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

// The mode's elementwise epilogue at flat index g, given raw = (M A M u)[g]
// (pallas_laplace.py:631-682):
//     apply       out = A u
//     residual1t  out = rhs - A u
//     residual3t  r0 = rhs - A u, d0 = r0 / (theta diag), x0 = u + d0
//     cheb        r' = r - A d, d' = c0 d + (c1 / diag) r', x' = x + d'
//     chebl       x' only;  chebd / chebdl: x == d on entry.
// diag() rebuilds the diagonal from its 1D factors; only the modes that
// need it call it.
template <typename T, typename Diag>
__device__ __forceinline__ void laplace_epilogue(
    int mode, int64_t g, T raw, const T* __restrict__ u,
    const T* __restrict__ in1, const T* __restrict__ in2, T* __restrict__ out0,
    T* __restrict__ out1, T* __restrict__ out2, T c0, T c1, Diag diag) {
  if (mode == kApply) {
    out0[g] = raw;
    return;
  }
  if (mode == kRes1) {
    out0[g] = in1[g] - raw;
    return;
  }
  const T dg = diag();
  if (mode == kRes3) {
    const T r0 = in1[g] - raw;
    const T d0 = r0 / (c0 * dg);
    out0[g] = r0;
    out1[g] = d0;
    out2[g] = u[g] + d0;
    return;
  }
  const T d = u[g];
  const T x = (mode == kChebD || mode == kChebDL) ? d : in2[g];
  const T rn = in1[g] - raw;
  const T dn = c0 * d + (c1 / dg) * rn;
  if (mode == kChebL || mode == kChebDL) {
    out0[g] = x + dn;
  } else {
    out0[g] = rn;
    out1[g] = dn;
    out2[g] = x + dn;
  }
}

__device__ __forceinline__ bool inside(int64_t gx, int64_t gy, int64_t gz,
                                       int64_t N) {
  return gx >= 0 && gx < N && gy >= 0 && gy < N && gz >= 0 && gz < N;
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
