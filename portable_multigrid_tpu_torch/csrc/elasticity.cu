// B.5 — fused banded linear-elasticity operator with single-step Chebyshev
// epilogues.
//
// Replaces the TPU kernel portable_multigrid_tpu/ops/pallas_elasticity.py
// PallasElasticityOperator._run (the exact "banded" core, iota mask; modes
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
// The slab of the sharded solve (ops/cuda_elasticity.py CudaElasticitySlab;
// the TPU kernel's make_pallas_elasticity_slab, xmask="vector",
// pallas_elasticity.py:703-732, in its one mode on that path, apply): x has
// factors of its own, the bands and row sums of K, M, G and H = G^T
// assembled over the slab's cells only, with the shard's slice of the
// global x mask folded in (interior shard boundaries stay unmasked, so
// their rows carry only this slab's cells), NX = n_loc p output planes, and
// an x-full input of NXI = NX + 1 planes (the shard's trimmed planes and
// its right neighbour's first).  The output drops the slab's last plane,
// whose partial row the caller completes (parallel/sharding.py).  The
// slab-partial G's rows do not sum to zero (an element's row i sums to
// l_i(1) - l_i(0): -1 on a cell's first row), so the host takes the x row
// sums from the masked partial matrices themselves.  Its epilogue is
// apply's alone: every other mode is refused where NXI != NX.  The cube
// passes its own factors as the x ones with NX = NXI = N, so that its
// arithmetic is the one before.
//
// The mxu grade (kRoundBF16 of StateFlags in common.cuh) runs in
// elasticitymma.cu; this file's entries refuse it.
//
// What bounds it on the H100: FP32 FMA throughput and shared-memory
// traffic, then HBM.  The 21 chains share 45 banded products per grid point
// (12 along z, 21 along y, 12 along x), 45 (2p+1) FMAs: 0.067 ms of FP32
// work at 3 x 192^3, p = 3, against an HBM floor of 0.051 ms for apply (u
// read, one field written) and 0.152 ms for cheb.
//
// Design: an x-marching plane engine.  A block owns a (TY, 32) column of
// the y-z plane for all three components and marches along x over a chunk
// of LX output planes.  For each input plane x_in (the chunk plus p lead-in
// planes on each side):
//   1. the plane's window of all three components (halo p in y and z, zeros
//      outside the grid) arrives by cp.async, double-buffered: plane x_in+1
//      loads while x_in is contracted;
//   2. per component a, the z stage (K, M, G, H along z on the window's
//      WY = TY + 2p rows), then the y stage on the block's column: a
//      thread owns one (y, z) point and sums the component's seven y-z
//      products, weighted by mu / lam / alpha, into 12 register groups keyed
//      by output c and x matrix (K, M, G, H) — the grouping of
//      pallas_elasticity.py:440-457 across components.  The z stage of
//      component a+1 shares a barrier interval with the y stage of a (two
//      z-product buffers), so a plane costs four barriers;
//   3. the thread writes its 12 groups into its own slot of a ring of 2p+1
//      planes in shared memory; once plane x+p is in, it contracts its
//      ring entries along x (the x row is the same for the whole plane, a
//      broadcast) into the three outputs at x, in registers, and runs the
//      epilogue straight to HBM.  The ring is thread-private, so the x stage
//      needs no barrier and no shared-memory output accumulators.
// Each input plane goes through the z and y stages once; only the chunk's
// 2p lead-in planes are recomputed.  The z and y rows of a thread are fixed
// for the whole march, so their band coefficients and row sums stay in
// registers.  The host picks TY (block = 32 TY threads) and LX from
// elasticity_tile in ops/cuda_elasticity.py, which mirrors smem_elems.  The
// TPU kernel's carry planes, 128-lane zpad and 8-row DMA tails exist
// because a Pallas grid runs in order on VMEM blocks; here the ring carries
// the x neighbours within a block and every block reads its own halo.
#include "elasticity.cuh"

using namespace pmg;

namespace {

constexpr int kTZ = 32;      // z extent of a block's column: one warp
constexpr int kGroups = 12;  // (output c, x matrix X), index 4 c + X
enum XMat { kXK = 0, kXM = 1, kXG = 2, kXH = 3 };

// Threads a block may have: 256 up to p = 3, 128 above (the host's tile
// keeps to it), so that two f32 blocks per SM leave the p >= 4 instances
// 255 registers a thread and the p <= 3 ones 128 (no spills either way).
template <int P>
constexpr int kMaxThreads = P <= 3 ? kThreads : kThreads / 2;

// shared-memory elements of a block; must match elasticity_smem_elems() in
// ops/cuda_elasticity.py.  Layout: two windows of three components
// [2][3][WY][WZ], two z-product sets [2][4][WY][32], the ring
// [2p+1][12][32 TY].
__host__ __device__ inline int64_t smem_elems(int p, int TY) {
  const int64_t WY = TY + 2 * p, WZ = kTZ + 2 * p;
  return 2 * 3 * WY * WZ + 2 * 4 * WY * kTZ +
         (int64_t)(2 * p + 1) * kGroups * TY * kTZ;
}

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

// z stage of one component: window rows r < WY (row length WZ) -> K, M, G,
// H along z into zb[4][WY][32].  A thread keeps its z column (and so its z
// row w) for every row it takes.
template <typename T, int P>
__device__ __forceinline__ void stage_z(const T* win, int WY, int WZ, T* zb,
                                        const Row<T, P>& w) {
  const int tz = threadIdx.x % kTZ, rows = blockDim.x / kTZ;
  const int nz = WY * kTZ;
  for (int r = threadIdx.x / kTZ; r < WY; r += rows) {
    const T* src = win + r * WZ + tz;
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
    T* out = zb + r * kTZ + tz;
    out[0] = ak;
    out[nz] = am;
    out[2 * nz] = ag;
    out[3 * nz] = ah;
  }
}

// y stage of input component A at the thread's (y, z) point: the seven y-z
// products of the component from zb[4][WY][32] (product names: y matrix,
// then z matrix; hm = H along y of M along z), summed with their weights
// into the 12 groups g[4 c + X] (pallas_elasticity.py:440-457):
//   A = 0: 0K al mm, 0M mu (km + mk), 1G mu hm, 1H lam gm, 2G mu mh, 2H lam mg
//   A = 1: 1K mu mm, 1M al km + mu mk, 0H mu gm, 0G lam hm, 2M mu gh + lam hg
//   A = 2: 2K mu mm, 2M mu km + al mk, 0H mu mg, 0G lam mh, 1M mu hg + lam gh
template <typename T, int P, int A>
__device__ __forceinline__ void stage_y(const T* zb, int WY,
                                        const Row<T, P>& w, T mu, T lam,
                                        T (&g)[kGroups]) {
  const int nz = WY * kTZ;
  const T* zk = zb + (threadIdx.x / kTZ) * kTZ + threadIdx.x % kTZ;
  const T* zm = zk + nz;
  const T* zg = zk + 2 * nz;
  const T* zh = zk + 3 * nz;
  const T al = T(2) * mu + lam;
  const T cm = zm[P * kTZ], cg = zg[P * kTZ], ch = zh[P * kTZ];
  T mm = T(0), km = w.ks * cm, mk = T(0);
  // A = 0, 1: gm, hm; A = 0, 2: mg, mh; A = 1, 2: gh, hg
  T gm = w.gs * cm, hm = w.hs * cm, mg = T(0), mh = T(0);
  T gh = w.gs * ch, hg = w.hs * cg;
#pragma unroll
  for (int o = 0; o <= 2 * P; ++o) {
    const int s = o * kTZ;
    const T vm = zm[s], dm = vm - cm;
    mm += w.m[o] * vm;
    km += w.k[o] * dm;
    mk += w.m[o] * zk[s];
    if constexpr (A != 2) {
      gm += w.g[o] * dm;
      hm += w.h[o] * dm;
    }
    if constexpr (A != 1) {
      mg += w.m[o] * zg[s];
      mh += w.m[o] * zh[s];
    }
    if constexpr (A != 0) {
      gh += w.g[o] * (zh[s] - ch);
      hg += w.h[o] * (zg[s] - cg);
    }
  }
  if constexpr (A == 0) {
    g[0 + kXK] += al * mm;
    g[0 + kXM] += mu * (km + mk);
    g[4 + kXG] += mu * hm;
    g[4 + kXH] += lam * gm;
    g[8 + kXG] += mu * mh;
    g[8 + kXH] += lam * mg;
  } else if constexpr (A == 1) {
    g[4 + kXK] += mu * mm;
    g[4 + kXM] += al * km + mu * mk;
    g[0 + kXH] += mu * gm;
    g[0 + kXG] += lam * hm;
    g[8 + kXM] += mu * gh + lam * hg;
  } else {
    g[8 + kXK] += mu * mm;
    g[8 + kXM] += mu * km + al * mk;
    g[0 + kXH] += mu * mg;
    g[0 + kXG] += lam * mh;
    g[4 + kXM] += mu * hg + lam * gh;
  }
}

template <typename T, int P>
__global__ void __launch_bounds__(kMaxThreads<P>, sizeof(T) == 4 ? 2 : 1)
elasticity_kernel(const T* __restrict__ u, const T* __restrict__ in1,
                  const T* __restrict__ in2, T* __restrict__ out0,
                  T* __restrict__ out1, T* __restrict__ out2, Bands<T> b,
                  const T* __restrict__ dk, const T* __restrict__ dm,
                  Bands<T> xb, const T* __restrict__ xdk,
                  const T* __restrict__ xdm, T mu, T lam, T c0, T c1, int N_,
                  int NX_, int NXI_, int mode, int LX, int TY) {
  constexpr int R = 2 * P + 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // y and z extent N; NX output planes along x from NXI input planes; a
  // component's stride in the input and in the outputs
  const int64_t N = N_, NX = NX_, NXI = NXI_;
  const int64_t SI = NXI * N * N, SO = NX * N * N;
  const int WY = TY + 2 * P, WZ = kTZ + 2 * P;
  const int nwin = WY * WZ, ncols = TY * kTZ;
  T* win = reinterpret_cast<T*>(smem_raw);  // [2][3][WY][WZ]
  T* zbuf = win + 2 * 3 * nwin;             // [2][4][WY][32]
  T* ring = zbuf + 2 * 4 * WY * kTZ;        // [R][12][ncols]
  const int tid = threadIdx.x;
  const int64_t z0 = (int64_t)blockIdx.x * kTZ, y0 = (int64_t)blockIdx.y * TY;
  const int64_t x0 = (int64_t)blockIdx.z * LX;
  const int64_t gy = y0 + tid / kTZ, gz = z0 + tid % kTZ;
  const bool own = gy < N && gz < N;
  const int64_t xs = x0 - P, xe = (x0 + LX < NX ? x0 + LX : NX) + P;

  // the three components' windows of input plane xin, zeros off the grid
  auto load_plane = [&](int64_t xin, T* dst) {
    const bool xok = xin >= 0 && xin < NXI;
    for (int i = tid; i < 3 * nwin; i += blockDim.x) {
      const int a = i / nwin, r = i % nwin;
      const int64_t yy = y0 - P + r / WZ, zz = z0 - P + r % WZ;
      const bool ok = xok && yy >= 0 && yy < N && zz >= 0 && zz < N;
      cp_async_elem(dst + i, ok ? u + a * SI + (xin * N + yy) * N + zz : u,
                    ok);
    }
    cp_async_commit();
  };

  Row<T, P> zr, yr;
  zr.load(b, N, gz);
  yr.load(b, N, gy);
  const T al = T(2) * mu + lam;
  T* zb0 = zbuf;
  T* zb1 = zbuf + 4 * WY * kTZ;

  load_plane(xs, win);
  for (int64_t xin = xs; xin < xe; ++xin) {
    const int i = (int)(xin - xs);
    T* w = win + (i & 1) * 3 * nwin;
    if (xin + 1 < xe) {
      load_plane(xin + 1, win + ((i + 1) & 1) * 3 * nwin);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // plane xin in; the last plane's z products all read
    T g[kGroups];
#pragma unroll
    for (int k = 0; k < kGroups; ++k) g[k] = T(0);
    stage_z<T, P>(w, WY, WZ, zb0, zr);
    __syncthreads();
    stage_y<T, P, 0>(zb0, WY, yr, mu, lam, g);
    stage_z<T, P>(w + nwin, WY, WZ, zb1, zr);
    __syncthreads();
    stage_y<T, P, 1>(zb1, WY, yr, mu, lam, g);
    stage_z<T, P>(w + 2 * nwin, WY, WZ, zb0, zr);
    __syncthreads();
    stage_y<T, P, 2>(zb0, WY, yr, mu, lam, g);

    // the thread's slot of plane xin in the ring
    T* slot = ring + (i % R) * kGroups * ncols + tid;
#pragma unroll
    for (int k = 0; k < kGroups; ++k)
      slot[k * ncols] = g[k];

    // plane x + p is in: contract the ring along x into the outputs at x
    const int64_t x = xin - P;
    if (x < x0 || !own) continue;
    Row<T, P> xr;
    xr.load(xb, NX, x);
    const int base = (int)(x - x0) % R;  // ring slot of plane x - p
    int sc = base + P;
    if (sc >= R) sc -= R;
    const T* rc = ring + sc * kGroups * ncols + tid;
    T cen[kGroups], acc[3];
#pragma unroll
    for (int k = 0; k < kGroups; ++k) cen[k] = rc[k * ncols];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      acc[c] = xr.ks * cen[4 * c + kXK] + xr.gs * cen[4 * c + kXG] +
               xr.hs * cen[4 * c + kXH];
    }
#pragma unroll
    for (int o = 0; o < R; ++o) {
      int s = base + o;
      if (s >= R) s -= R;
      const T* rs = ring + s * kGroups * ncols + tid;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        acc[c] += xr.k[o] * (rs[(4 * c + kXK) * ncols] - cen[4 * c + kXK]) +
                  xr.m[o] * rs[(4 * c + kXM) * ncols] +
                  xr.g[o] * (rs[(4 * c + kXG) * ncols] - cen[4 * c + kXG]) +
                  xr.h[o] * (rs[(4 * c + kXH) * ncols] - cen[4 * c + kXH]);
      }
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      laplace_epilogue(mode, c * SO + (x * N + gy) * N + gz, acc[c], u, in1,
                       in2, out0, out1, out2, c0, c1, [&] {
        const T t0 = xdk[x] * dm[gy] * dm[gz];
        const T t1 = xdm[x] * dk[gy] * dm[gz];
        const T t2 = xdm[x] * dm[gy] * dk[gz];
        return (c == 0 ? al : mu) * t0 + (c == 1 ? al : mu) * t1 +
               (c == 2 ? al : mu) * t2;
      });
    }
  }
}

template <typename T, int P>
int launch_p(const T* u, const T* in1, const T* in2, T* out0, T* out1,
             T* out2, const Operator<T>& op, double mu, double lam,
             double c0, double c1, int mode, int LX, int TY, void* stream) {
  if (TY * kTZ > kMaxThreads<P>) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)smem_elems(P, TY) * sizeof(T);
  const void* kernel = (const void*)elasticity_kernel<T, P>;
  cudaError_t err = allow_smem(kernel, smem);
  // two blocks of up to 113 KB per SM need the whole shared-memory carveout
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)ceil_div(op.N, kTZ), (unsigned)ceil_div(op.N, TY),
                  (unsigned)ceil_div(op.NX, LX));
  elasticity_kernel<T, P><<<grid, TY * kTZ, smem, (cudaStream_t)stream>>>(
      u, in1, in2, out0, out1, out2, op.b, op.dk, op.dm, op.xb, op.xdk,
      op.xdm, (T)mu, (T)lam, (T)c0, (T)c1, op.N, op.NX, op.NXI, mode, LX, TY);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const T* u, const T* in1, const T* in2, T* out0, T* out1, T* out2,
           const Operator<T>& op, double mu, double lam, double c0, double c1,
           int p, int mode, int LX, int TY, int TZ, int flags, void* stream) {
  // a block is TY warps, one per y row of its column (the operator and
  // the mode are checked in PMG_ELASTICITY_ENTRY, elasticity.cuh)
  if (TZ != kTZ || TY < 1 || TY * kTZ > kThreads || LX < 1 ||
      (flags & kRoundBF16))
    return (int)cudaErrorInvalidValue;
  switch (p) {
#define PMG_CASE(PP)                                                        \
  case PP:                                                                  \
    return launch_p<T, PP>(u, in1, in2, out0, out1, out2, op, mu, lam,      \
                           c0, c1, mode, LX, TY, stream);
    PMG_CASE(1) PMG_CASE(2) PMG_CASE(3) PMG_CASE(4) PMG_CASE(5) PMG_CASE(6)
    PMG_CASE(7)
#undef PMG_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// (LX, TY, TZ) is the launch tile: LX output planes per block along x, a
// (TY, TZ = 32) column of the y-z plane.
PMG_ELASTICITY_ENTRY(pmg_elasticity_f32, float, launch<float>)
PMG_ELASTICITY_ENTRY(pmg_elasticity_f64, double, launch<double>)
