// B.5 — fused banded linear-elasticity operator with single-step Chebyshev
// epilogues.
//
// Replaces the TPU kernel portable_multigrid_tpu/ops/pallas_elasticity.py
// PallasElasticityOperator._run (exact "banded" core, iota mask; modes
// apply, residual1t, residual3t, cheb, chebl, chebd, chebdl — the seven
// trimmed-state modes of B.1).  It computes M A M u for a 3-component field
// on trimmed state — [3, N, N, N], N = n p, C order with z contiguous:
//
//   out_c = sum_a alpha_{a,c} (K@a, M elsewhere) u_c
//         + sum_{a != c} mu (G@a, H@c, M@third) u_a
//                      + lam (G@c, H@a, M@third) u_a,
//
// alpha_{c,c} = 2 mu + lam, mu otherwise; K, M, G = int l_i' l_j and
// H = G^T are the GLOBAL mask-folded trimmed 1D matrices, (2p+1)-banded and
// the same on every axis.  The mode's epilogue (laplace_epilogue in
// common.cuh) runs per component, with diag_c = sum_k alpha_{k,c}
// (dK@k, dM elsewhere) rebuilt from the 1D diagonal factors.
//
// Every K, G and H contraction runs in difference form,
//     (W u)_i = sum_o W[i, i+o] (u_{i+o} - u_i) + s_i u_i,
// s_i the row sum of the mask-folded trimmed matrix (taken on the host, zero
// away from the Dirichlet ends: interior rows of K, G and G^T sum to zero).
// The direct sum cancels terms of size |W||u| down to the O(h) result of a
// smooth u and loses it to f32 roundoff; M stays direct.
//
// What bounds it on the H100: shared-memory traffic, then HBM.  apply reads
// u and writes one field (2 x 84.9 MB in f32 at the Q3 r=6 fine level, 3 x
// 192^3 trimmed values: 0.051 ms at 3.35 TB/s); the cheb modes read d, r, x
// and write three (0.152 ms).  The 21 chains share their z and y stages,
// but each output still costs about 200 FMAs through shared memory.
//
// Design: one thread block owns a TX x TY x TZ output tile of all three
// components.  The TPU kernel keeps 12 z-stage and 14 y-stage products live
// at once (pallas_elasticity.py:363-436); that does not fit 227 KB of shared
// memory at a useful tile, so the block loops over the INPUT component a:
//   1. load u_a's window with a halo of p (zeros outside the grid);
//   2. z stage: K, M, G, H along z on (WX, WY, TZ);
//   3. y stage: the component's seven y-z products on (WX, TY, TZ), summed
//      with their mu / lam / alpha weights into at most six groups, each
//      keyed by the output it feeds and the x matrix it meets next (the
//      groups reuse the window's buffer);
//   4. x stage: each group contracted along x into the block's three output
//      accumulators on (TX, TY, TZ), which stay in shared memory and are
//      owned thread by thread.
// After the third component each output element runs the epilogue.  The
// TPU kernel's carry planes (pallas_elasticity.py:459-501), 128-lane zpad
// and 8-row DMA tails exist because a Pallas grid runs in order on VMEM
// blocks; here every tile reads its own halo.  The host picks the tile per
// (p, itemsize) from the shared-memory formula (elasticity_tile in
// ops/cuda_elasticity.py).
#include "common.cuh"

using namespace pmg;

namespace {

constexpr int kGroups = 6;

// shared-memory elements of a tile; must match elasticity_smem_elems() in
// ops/cuda_elasticity.py.  Layout: [window | groups] [4 z products]
// [3 output accumulators].
__host__ __device__ inline int64_t smem_elems(int p, int TX, int TY, int TZ,
                                              int64_t* zoff, int64_t* ooff) {
  const int64_t WX = TX + 2 * p, WY = TY + 2 * p, WZ = TZ + 2 * p;
  const int64_t win = WX * WY * WZ;
  const int64_t groups = kGroups * WX * TY * TZ;
  const int64_t b0 = win > groups ? win : groups;
  const int64_t zprod = 4 * WX * WY * TZ;
  if (zoff) *zoff = b0;
  if (ooff) *ooff = b0 + zprod;
  return b0 + zprod + 3 * (int64_t)TX * TY * TZ;
}

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

// The coefficients of one row of K, M, G, H and its three row sums (zeros
// for a row outside [0, N), which makes its outputs zero).
template <typename T, int P>
struct Row {
  T k[2 * P + 1], m[2 * P + 1], g[2 * P + 1], h[2 * P + 1];
  T ks, gs, hs;

  __device__ __forceinline__ void load(const Bands<T>& b, int64_t N,
                                       int64_t row) {
    const bool in = row >= 0 && row < N;
#pragma unroll
    for (int o = 0; o <= 2 * P; ++o) {
      k[o] = in ? b.kb[o * N + row] : T(0);
      m[o] = in ? b.mb[o * N + row] : T(0);
      g[o] = in ? b.gb[o * N + row] : T(0);
      h[o] = in ? b.hb[o * N + row] : T(0);
    }
    ks = in ? b.ks[row] : T(0);
    gs = in ? b.gs[row] : T(0);
    hs = in ? b.hs[row] : T(0);
  }
};

// One 1D contraction at a point whose 2P+1 inputs are src[o * stride]:
// in difference form for a band with row sum s, direct for M.
template <typename T, int P>
__device__ __forceinline__ T diff_dot(const T (&w)[2 * P + 1], T s,
                                      const T* src, int64_t stride) {
  const T c = src[P * stride];
  T acc = s * c;
#pragma unroll
  for (int o = 0; o <= 2 * P; ++o) acc += w[o] * (src[o * stride] - c);
  return acc;
}

template <typename T, int P>
__device__ __forceinline__ T direct_dot(const T (&w)[2 * P + 1], const T* src,
                                        int64_t stride) {
  T acc = T(0);
#pragma unroll
  for (int o = 0; o <= 2 * P; ++o) acc += w[o] * src[o * stride];
  return acc;
}

// z stage: the window rows r < R (row length WZ) -> K, M, G, H along z on
// columns c < C; column c's stencil centre sits at window index c + P.
template <typename T, int P>
__device__ __forceinline__ void stage_z(const T* win, int WZ, T* zk, T* zm,
                                        T* zg, T* zh, int R, int C,
                                        int64_t gz0, const Bands<T>& b,
                                        int64_t N) {
  const int rows = blockDim.x / C;
  const int c = threadIdx.x % C, r0 = threadIdx.x / C;
  Row<T, P> w;
  w.load(b, N, gz0 + c);
  for (int r = r0; r < R; r += rows) {
    const T* src = win + (int64_t)r * WZ + c;
    const T uc = src[P];
    T ak = w.ks * uc, am = T(0), ag = w.gs * uc, ah = w.hs * uc;
#pragma unroll
    for (int o = 0; o <= 2 * P; ++o) {
      const T v = src[o], dv = v - uc;
      ak += w.k[o] * dv;
      am += w.m[o] * v;
      ag += w.g[o] * dv;
      ah += w.h[o] * dv;
    }
    const int64_t out = (int64_t)r * C + c;
    zk[out] = ak;
    zm[out] = am;
    zg[out] = ag;
    zh[out] = ah;
  }
}

// y stage for input component A: from the z products on (WX, WY, TZ) to the
// component's groups on (WX, TY, TZ).  Product names: y matrix, then z
// matrix (hm = H along y of M along z).  Group g of component A feeds
//   A = 0: out0 via Kx, Mx; out1 via Gx, Hx; out2 via Gx, Hx
//   A = 1: out1 via Kx, Mx; out0 via Hx, Gx; out2 via Mx
//   A = 2: out2 via Kx, Mx; out0 via Hx, Gx; out1 via Mx
// (the grouping of pallas_elasticity.py:440-457, one component at a time).
template <typename T, int P, int A>
__device__ __forceinline__ void stage_y(const T* zk, const T* zm,
                                        const T* zg, const T* zh, T* grp,
                                        int WX, int WY, int TY, int TZ,
                                        int64_t gy0, const Bands<T>& b,
                                        int64_t N, T mu, T lam) {
  const int nyz = TY * TZ;
  const int yz = threadIdx.x % nyz, xstep = blockDim.x / nyz;
  const int y = yz / TZ, z = yz % TZ;
  Row<T, P> w;
  w.load(b, N, gy0 + y);
  const T al = T(2) * mu + lam;
  const int64_t gsz = (int64_t)WX * nyz;  // one group array
  for (int x = threadIdx.x / nyz; x < WX; x += xstep) {
    const int64_t in = ((int64_t)x * WY + y) * TZ + z;
    const T mm = direct_dot<T, P>(w.m, zm + in, TZ);
    const T km = diff_dot<T, P>(w.k, w.ks, zm + in, TZ);
    const T mk = direct_dot<T, P>(w.m, zk + in, TZ);
    T* g = grp + (int64_t)x * nyz + yz;
    if constexpr (A == 0) {
      const T gm = diff_dot<T, P>(w.g, w.gs, zm + in, TZ);
      const T hm = diff_dot<T, P>(w.h, w.hs, zm + in, TZ);
      g[0] = al * mm;
      g[gsz] = mu * (km + mk);
      g[2 * gsz] = mu * hm;
      g[3 * gsz] = lam * gm;
      g[4 * gsz] = mu * direct_dot<T, P>(w.m, zh + in, TZ);
      g[5 * gsz] = lam * direct_dot<T, P>(w.m, zg + in, TZ);
    } else if constexpr (A == 1) {
      const T gm = diff_dot<T, P>(w.g, w.gs, zm + in, TZ);
      const T hm = diff_dot<T, P>(w.h, w.hs, zm + in, TZ);
      const T gh = diff_dot<T, P>(w.g, w.gs, zh + in, TZ);
      const T hg = diff_dot<T, P>(w.h, w.hs, zg + in, TZ);
      g[0] = mu * mm;
      g[gsz] = al * km + mu * mk;
      g[2 * gsz] = mu * gm;
      g[3 * gsz] = lam * hm;
      g[4 * gsz] = mu * gh + lam * hg;
    } else {
      const T gh = diff_dot<T, P>(w.g, w.gs, zh + in, TZ);
      const T hg = diff_dot<T, P>(w.h, w.hs, zg + in, TZ);
      g[0] = mu * mm;
      g[gsz] = mu * km + al * mk;
      g[2 * gsz] = mu * direct_dot<T, P>(w.m, zg + in, TZ);
      g[3 * gsz] = lam * direct_dot<T, P>(w.m, zh + in, TZ);
      g[4 * gsz] = mu * hg + lam * gh;
    }
  }
}

// x stage for input component A: each group contracted along x into the
// three output accumulators on (TX, TY, TZ).  A thread owns the same output
// elements for every component, so the accumulators need no atomics.
template <typename T, int P, int A>
__device__ __forceinline__ void stage_x(const T* grp, T* acc, int WX, int TX,
                                        int TY, int TZ, int64_t gx0,
                                        const Bands<T>& b, int64_t N) {
  const int nxz = TX * TZ;
  const int xz = threadIdx.x % nxz, ystep = blockDim.x / nxz;
  const int x = xz / TZ, z = xz % TZ;
  Row<T, P> w;
  w.load(b, N, gx0 + x);
  const int64_t plane = (int64_t)TY * TZ;
  const int64_t gsz = (int64_t)WX * plane;
  const int64_t osz = (int64_t)TX * plane;
  for (int y = threadIdx.x / nxz; y < TY; y += ystep) {
    const T* g = grp + (int64_t)x * plane + (int64_t)y * TZ + z;
    const int64_t o = (int64_t)x * plane + (int64_t)y * TZ + z;
    acc[A * osz + o] += diff_dot<T, P>(w.k, w.ks, g, plane) +
                        direct_dot<T, P>(w.m, g + gsz, plane);
    if constexpr (A == 0) {
      acc[1 * osz + o] += diff_dot<T, P>(w.g, w.gs, g + 2 * gsz, plane) +
                          diff_dot<T, P>(w.h, w.hs, g + 3 * gsz, plane);
      acc[2 * osz + o] += diff_dot<T, P>(w.g, w.gs, g + 4 * gsz, plane) +
                          diff_dot<T, P>(w.h, w.hs, g + 5 * gsz, plane);
    } else {
      acc[0 * osz + o] += diff_dot<T, P>(w.h, w.hs, g + 2 * gsz, plane) +
                          diff_dot<T, P>(w.g, w.gs, g + 3 * gsz, plane);
      acc[(A == 1 ? 2 : 1) * osz + o] +=
          direct_dot<T, P>(w.m, g + 4 * gsz, plane);
    }
  }
}

// One input component's contribution to the block's three outputs.
template <typename T, int P, int A>
__device__ __forceinline__ void component(const T* __restrict__ u, T* buf0,
                                          T* zbuf, T* acc, int TX, int TY,
                                          int TZ, int64_t x0, int64_t y0,
                                          int64_t z0, const Bands<T>& b,
                                          int64_t N, T mu, T lam) {
  const int WX = TX + 2 * P, WY = TY + 2 * P, WZ = TZ + 2 * P;
  const T* ua = u + A * N * N * N;
  const int nwin = WX * WY * WZ;
  for (int i = threadIdx.x; i < nwin; i += blockDim.x) {
    const int lz = i % WZ, t = i / WZ, ly = t % WY, lx = t / WY;
    const int64_t gx = x0 - P + lx, gy = y0 - P + ly, gz = z0 - P + lz;
    buf0[i] = inside(gx, gy, gz, N) ? ua[(gx * N + gy) * N + gz] : T(0);
  }
  __syncthreads();
  const int64_t zsz = (int64_t)WX * WY * TZ;
  T *zk = zbuf, *zm = zbuf + zsz, *zg = zbuf + 2 * zsz, *zh = zbuf + 3 * zsz;
  stage_z<T, P>(buf0, WZ, zk, zm, zg, zh, WX * WY, TZ, z0, b, N);
  __syncthreads();
  stage_y<T, P, A>(zk, zm, zg, zh, buf0, WX, WY, TY, TZ, y0, b, N, mu, lam);
  __syncthreads();
  stage_x<T, P, A>(buf0, acc, WX, TX, TY, TZ, x0, b, N);
  __syncthreads();
}

template <typename T, int P>
__global__ void __launch_bounds__(kThreads)
elasticity_kernel(const T* __restrict__ u, const T* __restrict__ in1,
                  const T* __restrict__ in2, T* __restrict__ out0,
                  T* __restrict__ out1, T* __restrict__ out2, Bands<T> b,
                  const T* __restrict__ dk, const T* __restrict__ dm, T mu,
                  T lam, T c0, T c1, int N_, int mode, int TX, int TY,
                  int TZ) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int64_t N = N_;
  int64_t zoff, ooff;
  smem_elems(P, TX, TY, TZ, &zoff, &ooff);
  T* buf0 = reinterpret_cast<T*>(smem_raw);
  T* zbuf = buf0 + zoff;
  T* acc = buf0 + ooff;
  const int64_t x0 = (int64_t)blockIdx.z * TX;
  const int64_t y0 = (int64_t)blockIdx.y * TY;
  const int64_t z0 = (int64_t)blockIdx.x * TZ;
  const int tile = TX * TY * TZ;
  for (int i = threadIdx.x; i < 3 * tile; i += blockDim.x) acc[i] = T(0);
  // the first component's window load is followed by a barrier, so the
  // zeroed accumulators are in place before the first x stage
  component<T, P, 0>(u, buf0, zbuf, acc, TX, TY, TZ, x0, y0, z0, b, N, mu,
                     lam);
  component<T, P, 1>(u, buf0, zbuf, acc, TX, TY, TZ, x0, y0, z0, b, N, mu,
                     lam);
  component<T, P, 2>(u, buf0, zbuf, acc, TX, TY, TZ, x0, y0, z0, b, N, mu,
                     lam);

  const T al = T(2) * mu + lam;
  const int64_t N3 = N * N * N;
  for (int i = threadIdx.x; i < 3 * tile; i += blockDim.x) {
    const int c = i / tile, r = i % tile;
    const int lz = r % TZ, t = r / TZ, ly = t % TY, lx = t / TY;
    const int64_t gx = x0 + lx, gy = y0 + ly, gz = z0 + lz;
    if (gx >= N || gy >= N || gz >= N) continue;
    laplace_epilogue(mode, c * N3 + (gx * N + gy) * N + gz, acc[i], u, in1,
                     in2, out0, out1, out2, c0, c1, [&] {
      const T t0 = dk[gx] * dm[gy] * dm[gz];
      const T t1 = dm[gx] * dk[gy] * dm[gz];
      const T t2 = dm[gx] * dm[gy] * dk[gz];
      return (c == 0 ? al : mu) * t0 + (c == 1 ? al : mu) * t1 +
             (c == 2 ? al : mu) * t2;
    });
  }
}

template <typename T, int P>
int launch_p(const T* u, const T* in1, const T* in2, T* out0, T* out1,
             T* out2, const Bands<T>& b, const T* dk, const T* dm, double mu,
             double lam, double c0, double c1, int N, int mode, int TX,
             int TY, int TZ, void* stream) {
  const size_t smem =
      (size_t)smem_elems(P, TX, TY, TZ, nullptr, nullptr) * sizeof(T);
  cudaError_t err = allow_smem((const void*)elasticity_kernel<T, P>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)ceil_div(N, TZ), (unsigned)ceil_div(N, TY),
                  (unsigned)ceil_div(N, TX));
  elasticity_kernel<T, P><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      u, in1, in2, out0, out1, out2, b, dk, dm, (T)mu, (T)lam, (T)c0, (T)c1,
      N, mode, TX, TY, TZ);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const T* u, const T* in1, const T* in2, T* out0, T* out1, T* out2,
           const T* kb, const T* ks, const T* mb, const T* gb, const T* gs,
           const T* hb, const T* hs, const T* dk, const T* dm, double mu,
           double lam, double c0, double c1, int N, int p, int mode, int TX,
           int TY, int TZ, void* stream) {
  // each stage maps the threads of a block onto whole rows of the tile
  if (kThreads % TZ || kThreads % (TY * TZ) || kThreads % (TX * TZ) ||
      mode < kApply || mode > kChebDL)
    return (int)cudaErrorInvalidValue;
  const Bands<T> b{kb, ks, mb, gb, gs, hb, hs};
  switch (p) {
#define PMG_CASE(PP)                                                       \
  case PP:                                                                 \
    return launch_p<T, PP>(u, in1, in2, out0, out1, out2, b, dk, dm, mu,  \
                           lam, c0, c1, N, mode, TX, TY, TZ, stream);
    PMG_CASE(1) PMG_CASE(2) PMG_CASE(3) PMG_CASE(4) PMG_CASE(5) PMG_CASE(6)
    PMG_CASE(7)
#undef PMG_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int pmg_elasticity_f32(
    const float* u, const float* in1, const float* in2, float* out0,
    float* out1, float* out2, const float* kb, const float* ks,
    const float* mb, const float* gb, const float* gs, const float* hb,
    const float* hs, const float* dk, const float* dm, double mu, double lam,
    double c0, double c1, int N, int p, int mode, int TX, int TY, int TZ,
    void* stream) {
  return launch<float>(u, in1, in2, out0, out1, out2, kb, ks, mb, gb, gs, hb,
                       hs, dk, dm, mu, lam, c0, c1, N, p, mode, TX, TY, TZ,
                       stream);
}

extern "C" int pmg_elasticity_f64(
    const double* u, const double* in1, const double* in2, double* out0,
    double* out1, double* out2, const double* kb, const double* ks,
    const double* mb, const double* gb, const double* gs, const double* hb,
    const double* hs, const double* dk, const double* dm, double mu,
    double lam, double c0, double c1, int N, int p, int mode, int TX, int TY,
    int TZ, void* stream) {
  return launch<double>(u, in1, in2, out0, out1, out2, kb, ks, mb, gb, gs,
                        hb, hs, dk, dm, mu, lam, c0, c1, N, p, mode, TX, TY,
                        TZ, stream);
}
