// Helpers of the x-marching engines of the Laplace family (laplace.cu, B.1,
// cheb2.cu, B.2, and the 2D row engine laplace2d.cu, B.4).
//
// A block of a 3D engine owns a y-z column whose rows are one warp of 32 z
// lanes and marches along x.  A thread keeps the band coefficients of its z
// row (its lane) and of its y rows in registers (Row) for the whole march;
// the x row of the plane being finished comes from shared memory.  The
// three contractions of M A M u,
//     z: Kz u, Mz u
//     y: MB = My (Mz u),  S = Ky (Mz u) + My (Kz u)
//     x: raw = Kx MB + Mx S,
// run with every K in difference form,
//     (K u)_i = sum_o K[i, i+o] (u_{i+o} - u_i) + s_i u_i,
// s_i the row sum of the trimmed mask-folded K (ksum on the host): the
// differences of neighbouring values of a smooth field are small and nearly
// exact, where the direct sum loses the small K u to cancellation.  M stays
// direct.
#pragma once

#include "common.cuh"

namespace pmg {

constexpr int kEZ = 32;  // z extent of a column row: one warp
constexpr int64_t kSmemLimit = 227 * 1024;  // shared memory of one block

// warps a marching block may have: 12 in float (168 registers a thread),
// 8 in double (255 registers); one block per SM
template <typename T>
__host__ __device__ constexpr int march_warps() {
  return sizeof(T) == 4 ? 12 : 8;
}

// elements of an x row in shared memory: K and M (2p+1 each), K's row sum,
// dK and dM, rounded up to 16 bytes of float
__host__ __device__ constexpr int xrow_elems(int p) {
  return (4 * p + 5 + 3) / 4 * 4;
}

// The coefficients of one row of K and M and K's row sum (zeros for a row
// outside [0, N), which makes its outputs zero).
template <typename T, int P>
struct Row {
  T k[2 * P + 1], m[2 * P + 1], s;

  __device__ __forceinline__ void load(const T* __restrict__ kb,
                                       const T* __restrict__ mb,
                                       const T* __restrict__ ks, int64_t N,
                                       int64_t row) {
    const bool in = row >= 0 && row < N;
#pragma unroll
    for (int o = 0; o <= 2 * P; ++o) {
      k[o] = in ? kb[o * N + row] : T(0);
      m[o] = in ? mb[o * N + row] : T(0);
    }
    s = in ? ks[row] : T(0);
  }

  // The row and the diagonal factors dK, dM from an x row in shared
  // memory (k, m, s, dK, dM in order; 16-byte aligned), in broadcast
  // 16-byte loads.
  __device__ __forceinline__ void load_smem(const T* src, T& dk, T& dm) {
    constexpr int V = 16 / sizeof(T);
#pragma unroll
    for (int q = 0; q < (4 * P + 5 + V - 1) / V; ++q) {
      T v[V];
      if constexpr (V == 4) {
        const float4 t = reinterpret_cast<const float4*>(src)[q];
        v[0] = t.x;
        v[1] = t.y;
        v[2] = t.z;
        v[3] = t.w;
      } else {
        const double2 t = reinterpret_cast<const double2*>(src)[q];
        v[0] = t.x;
        v[1] = t.y;
      }
#pragma unroll
      for (int u = 0; u < V; ++u) {
        const int e = q * V + u;
        if (e <= 2 * P) {
          k[e] = v[u];
        } else if (e <= 4 * P + 1) {
          m[e - 2 * P - 1] = v[u];
        } else if (e == 4 * P + 2) {
          s = v[u];
        } else if (e == 4 * P + 3) {
          dk = v[u];
        } else if (e == 4 * P + 4) {
          dm = v[u];
        }
      }
    }
  }
};

// K and M of a row along z, u[o] the 2P+1 taps.
template <typename T, int P>
__device__ __forceinline__ void contract_km(const Row<T, P>& w, const T* u,
                                            T& ak, T& am) {
  const T uc = u[P];
  ak = w.s * uc;
  am = T(0);
#pragma unroll
  for (int o = 0; o <= 2 * P; ++o) {
    const T v = u[o];
    ak += w.k[o] * (v - uc);
    am += w.m[o] * v;
  }
}

// The y stage at RW adjacent rows of one lane, w[j] the bands of row j:
// za / zm the K / M z products from the first row's first tap (stride 32);
// MB = My (Mz u), S = Ky (Mz u) + My (Kz u) into mb[j], s[j].  The rows'
// 2P+1 taps overlap, so each tap row is loaded once for all of them.
template <typename T, int P, int RW = 1>
__device__ __forceinline__ void contract_y(const Row<T, P>* w, const T* za,
                                           const T* zm, T* mb, T* s) {
  T bc[RW];
#pragma unroll
  for (int j = 0; j < RW; ++j) {
    bc[j] = zm[(j + P) * kEZ];
    mb[j] = T(0);
    s[j] = w[j].s * bc[j];
  }
#pragma unroll
  for (int t = 0; t < 2 * P + RW; ++t) {
    const T bv = zm[t * kEZ], av = za[t * kEZ];
#pragma unroll
    for (int j = 0; j < RW; ++j) {
      const int o = t - j;
      if (o < 0 || o > 2 * P) continue;
      mb[j] += w[j].m[o] * bv;
      s[j] += w[j].k[o] * (bv - bc[j]) + w[j].m[o] * av;
    }
  }
}

// The x stage from a ring of 2P+1 planes of (MB, S) pairs: planes
// x - P + o in slots (base + o) % R, the pair's S `half` elements after
// its MB; raw = Kx MB + Mx S.
template <typename T, int P>
__device__ __forceinline__ T contract_x(const Row<T, P>& w, const T* ring,
                                        int slot_elems, int half, int base) {
  constexpr int R = 2 * P + 1;
  int c = base + P;
  if (c >= R) c -= R;
  const T mbc = ring[c * slot_elems];
  T raw = w.s * mbc;
#pragma unroll
  for (int o = 0; o < R; ++o) {
    int s = base + o;
    if (s >= R) s -= R;
    const T* e = ring + s * slot_elems;
    raw += w.k[o] * (e[0] - mbc) + w.m[o] * e[half];
  }
  return raw;
}

}  // namespace pmg
