// B.3 — fused separable grid transfer: restrict, prolongate, prolongate+add.
//
// Replaces the TPU kernel portable_multigrid_tpu/ops/pallas_transfer.py
// PallasTransfer._run.  Between trimmed 3D levels the transfer is
//     P = Px (x) Py (x) Pz,   P_ax = diag(w_f m_f) E_ax diag(m_c)
// (1/valence weights and both Dirichlet masks folded into one 1D matrix per
// axis, _axis_matrix_1d(...)[:-1, :-1]); restriction is the exact transpose.
// Both kernels compute out = (W (x) W (x) W) in (+ add) for one 1D matrix W
// given row by row in a padded-row ("ELL") form: row i has its nonzeros in
// columns starts[i] .. starts[i] + w - 1, values vals[i * w + k].  The
// wrapper passes W = P for prolongation and W = P^T for restriction.  A
// field with a leading component axis ([3, ...], elasticity) is one launch:
// the component is a grid axis.
//
// What bounds it on the H100: HBM traffic.  Prolongate+add reads the coarse
// field (1/8 of a fine one) and the fine addend and writes the fine result,
// about 8.5 B per fine DoF in f32; restriction reads the fine field and
// writes an eighth of it, about 4.5 B per fine DoF: 0.023 ms at 256^3 and
// 0.029 ms at 3 x 192^3 at 3.35 TB/s.  The FMAs are few (w = p + 1 taps a
// row for prolongation), so what a design must avoid is reading a field more
// than once and leaving the latency of its loads in the way.
//
// prolongate (prolong_kernel): the first, tiled design read the coarse
// input straight from global memory at every tap of its x stage, about 4x
// over through L2, with each FMA's weight a global load too, and ran its y
// and z stages through shared memory behind two barriers a tile.  Now a
// block owns a fine (8, 32) column of the y-z plane and a chunk of LX fine
// x rows, and marches along the coarse x planes the chunk reaches (about
// LX / 2 + w of them).  Each coarse plane's (LY, LZ) window arrives once, by
// cp.async, kPStages - 1 planes ahead; it is contracted along z through
// shared memory, then along y at the thread's fine (y, z) point, into a
// register ring of the last w planes.  The fine rows of a coarse cell share
// their window, so when the plane that completes it arrives, the thread
// emits those 2p rows from the ring (the chunk's starts and weights in
// shared memory, read as broadcasts), adding the addend read once,
// coalesced along z.  The coarse field is read about once per column, the
// fine output and the addend stream once.
//
// restrict (restrict_kernel): the input is the fine field, eight times the
// output, so it must be read once.  A block owns a coarse (8, 32) column of
// the y-z plane and a chunk of 16 coarse x rows, and marches along the fine
// x planes the chunk reaches (2 x 16 + w - 2 of them).  Each fine plane's
// (LY, LZ) window arrives once, by cp.async, coalesced along z and double-
// buffered; it is contracted along z, then y, through shared memory, and the
// result at the thread's (y, z) point is added into the chunk's coarse x
// rows that the plane feeds, kept in registers until the march ends.  The
// thread's y and z rows stay in registers and the chunk's x rows in shared
// memory.  The TPU's hi/lo bf16 split and its 8-row padded DMA frame were
// Mosaic workarounds and are not carried over: the contractions are plain
// f32 / f64 FMAs.
#include "common.cuh"

using namespace pmg;

namespace {

constexpr int kRY = 8, kRZ = 32;  // restriction: coarse (y, z) column
constexpr int kChunk = 16;        // restriction: coarse x rows per block
constexpr int kPY = 8, kPZ = 32;  // prolongation: fine (y, z) column
// prolongation: coarse-plane buffers, kPStages - 1 planes in flight ahead of
// the one contracted, and the blocks an SM holds at once (the register cap
// of the launch bounds); PROLONG_STAGES and prolong_blocks() in
// ops/cuda_transfer.py
constexpr int kPStages = 4;
template <typename T, int W>
constexpr int kPBlocks = sizeof(T) == 4 ? (W <= 5 ? 4 : 3) : 2;

// per-block shared-memory elements of restrict_kernel, values only (kChunk
// int starts follow them); must match restrict_smem_bytes() in
// ops/cuda_transfer.py
__host__ __device__ inline int64_t restrict_smem_elems(int w, int LY, int LZ) {
  return 2 * (int64_t)LY * LZ + (int64_t)LY * kRZ + (int64_t)kChunk * w;
}

// ... of prolong_kernel, values only (LX int starts follow them); must match
// prolong_smem_bytes() in ops/cuda_transfer.py
__host__ __device__ inline int64_t prolong_smem_elems(int w, int LX, int LY,
                                                      int LZ) {
  return kPStages * (int64_t)LY * LZ + (int64_t)LY * kPZ + (int64_t)LX * w;
}

// One row of W for a thread: its offset in the block's window and its w
// values, zero-padded to WM (zeros for a row outside [0, n_out)).
template <typename T, int WM>
__device__ __forceinline__ int load_row(const int* __restrict__ starts,
                                        const T* __restrict__ vals, int w,
                                        int64_t n_out, int64_t row,
                                        int64_t s0, T (&v)[WM]) {
  const bool in = row < n_out;
#pragma unroll
  for (int k = 0; k < WM; ++k) v[k] = in && k < w ? vals[row * w + k] : T(0);
  return in ? (int)(starts[row] - s0) : 0;
}

template <typename T, int WM>
__global__ void __launch_bounds__(kRY * kRZ)
restrict_kernel(const T* __restrict__ in, T* __restrict__ out,
                const int* __restrict__ starts, const T* __restrict__ vals,
                int w, int n_in_, int n_out_, int LY, int LZ) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int64_t n_in = n_in_, n_out = n_out_;
  T* plane = reinterpret_cast<T*>(smem_raw);  // [2][LY][LZ]
  T* zb = plane + 2 * LY * LZ;                // [LY][kRZ]
  T* xv = zb + LY * kRZ;                      // [kChunk][w]
  int* xs = reinterpret_cast<int*>(xv + kChunk * w);  // [kChunk]
  const int tid = threadIdx.x, tz = tid % kRZ, ty = tid / kRZ;
  // blockIdx.z runs over (component, x chunk)
  const int64_t nch = ceil_div(n_out, kChunk);
  const int64_t comp = blockIdx.z / nch;
  in += comp * n_in * n_in * n_in;
  out += comp * n_out * n_out * n_out;
  const int64_t cx0 = (blockIdx.z % nch) * kChunk;
  const int64_t y0 = (int64_t)blockIdx.y * kRY;
  const int64_t z0 = (int64_t)blockIdx.x * kRZ;
  const int64_t sy = starts[y0], sz = starts[z0];
  const int cn = (int)(n_out - cx0 < kChunk ? n_out - cx0 : kChunk);

  T vy[WM], vz[WM];
  const int oy = load_row<T, WM>(starts, vals, w, n_out, y0 + ty, sy, vy);
  const int oz = load_row<T, WM>(starts, vals, w, n_out, z0 + tz, sz, vz);
  for (int i = tid; i < cn * w; i += blockDim.x) xv[i] = vals[cx0 * w + i];
  for (int i = tid; i < cn; i += blockDim.x) xs[i] = starts[cx0 + i];

  // the fine x planes the chunk's rows reach
  const int64_t f0 = starts[cx0], f1 = starts[cx0 + cn - 1] + w;
  // window rows across the warps, z along the lanes (no index division)
  auto load_plane = [&](int64_t fx, T* dst) {
    for (int ly = ty; ly < LY; ly += kRY) {
      const int64_t row = (fx * n_in + sy + ly) * n_in + sz;
      const bool yok = sy + ly < n_in;
      for (int lz = tz; lz < LZ; lz += kRZ) {
        const bool ok = yok && sz + lz < n_in;
        cp_async_elem(dst + ly * LZ + lz, ok ? in + row + lz : in, ok);
      }
    }
    cp_async_commit();
  };

  T acc[kChunk];
#pragma unroll
  for (int c = 0; c < kChunk; ++c) acc[c] = T(0);
  load_plane(f0, plane);
  for (int64_t fx = f0; fx < f1; ++fx) {
    const int i = (int)(fx - f0);
    const T* pl = plane + (i & 1) * LY * LZ;
    if (fx + 1 < f1) {
      load_plane(fx + 1, plane + ((i + 1) & 1) * LY * LZ);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // plane fx in; the last plane's z stage all read
    // z: the window's rows at the thread's z column
    for (int ly = ty; ly < LY; ly += kRY) {
      const T* r = pl + ly * LZ + oz;
      T a = T(0);
#pragma unroll
      for (int k = 0; k < WM; ++k)
        if (k < w) a += vz[k] * r[k];
      zb[ly * kRZ + tz] = a;
    }
    __syncthreads();
    // y at the thread's point, then into the coarse x rows plane fx feeds
    T v = T(0);
#pragma unroll
    for (int k = 0; k < WM; ++k)
      if (k < w) v += vy[k] * zb[(oy + k) * kRZ + tz];
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      const int k = (int)(fx - xs[c < cn ? c : 0]);
      if (c < cn && k >= 0 && k < w) acc[c] += xv[c * w + k] * v;
    }
  }
  const int64_t gy = y0 + ty, gz = z0 + tz;
  if (gy >= n_out || gz >= n_out) return;
#pragma unroll
  for (int c = 0; c < kChunk; ++c)
    if (c < cn) out[((cx0 + c) * n_out + gy) * n_out + gz] = acc[c];
}

template <typename T, int W>
__global__ void __launch_bounds__(kPY * kPZ, kPBlocks<T, W>)
prolong_kernel(const T* __restrict__ in, const T* __restrict__ add,
               T* __restrict__ out, const int* __restrict__ starts,
               const T* __restrict__ vals, int n_in_, int n_out_, int LX,
               int LY, int LZ) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int64_t n_in = n_in_, n_out = n_out_;
  T* plane = reinterpret_cast<T*>(smem_raw);     // [kPStages][LY][LZ]
  T* zb = plane + kPStages * LY * LZ;            // [LY][kPZ]
  T* xv = zb + LY * kPZ;                         // [LX][W]
  int* xs = reinterpret_cast<int*>(xv + LX * W);  // [LX]
  const int tid = threadIdx.x, tz = tid % kPZ, ty = tid / kPZ;
  // blockIdx.z runs over (component, x chunk)
  const int64_t nch = ceil_div(n_out, LX);
  const int64_t comp = blockIdx.z / nch;
  in += comp * n_in * n_in * n_in;
  out += comp * n_out * n_out * n_out;
  if (add) add += comp * n_out * n_out * n_out;
  const int64_t x0 = (blockIdx.z % nch) * LX;
  const int64_t y0 = (int64_t)blockIdx.y * kPY;
  const int64_t z0 = (int64_t)blockIdx.x * kPZ;
  const int64_t sy = starts[y0], sz = starts[z0];
  const int cn = (int)(n_out - x0 < LX ? n_out - x0 : LX);

  T vy[W], vz[W];
  const int oy = load_row<T, W>(starts, vals, W, n_out, y0 + ty, sy, vy);
  const int oz = load_row<T, W>(starts, vals, W, n_out, z0 + tz, sz, vz);
  for (int i = tid; i < cn * W; i += blockDim.x) xv[i] = vals[x0 * W + i];
  for (int i = tid; i < cn; i += blockDim.x) xs[i] = starts[x0 + i];

  // the coarse x planes the chunk's rows reach: f0 .. f0 + np - 1
  const int64_t f0 = starts[x0];
  const int np = (int)(starts[x0 + cn - 1] + W - f0);
  // coarse plane f0 + j into buffer j % kPStages: window rows across the
  // warps, z along the lanes (zeros past the grid)
  auto load_plane = [&](int j) {
    if (j < np) {
      T* dst = plane + (j % kPStages) * LY * LZ;
      for (int ly = ty; ly < LY; ly += kPY) {
        const int64_t row = ((f0 + j) * n_in + sy + ly) * n_in + sz;
        const bool yok = sy + ly < n_in;
        for (int lz = tz; lz < LZ; lz += kPZ) {
          const bool ok = yok && sz + lz < n_in;
          cp_async_elem(dst + ly * LZ + lz, ok ? in + row + lz : in, ok);
        }
      }
    }
    cp_async_commit();
  };

  const int64_t gy = y0 + ty, gz = z0 + tz;
  const bool ok = gy < n_out && gz < n_out;
  auto at = [&](int row) { return ((x0 + row) * n_out + gy) * n_out + gz; };
  // the ring: the (y, z)-contracted values of the last W coarse planes,
  // the newest in ring[W - 1]
  T ring[W];
#pragma unroll
  for (int k = 0; k < W; ++k) ring[k] = T(0);
  // the next group of chunk rows to emit, rows next .. next + ne - 1 (at
  // most 2W of the rows that share a window; a coarse cell's 2p fine rows
  // at degree p = W - 1), and its addend, loaded as soon as the group
  // before it is written
  int next = 0, ne = 0;
  T addv[2 * W];
  auto fetch = [&] {
    ne = 0;
#pragma unroll
    for (int e = 0; e < 2 * W; ++e) {
      if (next + e < cn && xs[next + e] == xs[next]) {
        ne = e + 1;
        if (add && ok) addv[e] = add[at(next + e)];
      }
    }
  };
#pragma unroll
  for (int j = 0; j < kPStages - 1; ++j) load_plane(j);
  __syncthreads();  // the chunk's rows in
  if (next < cn) fetch();
  for (int j = 0; j < np; ++j) {
    // into the buffer plane j - 1 used, whose z stage all threads have
    // finished (the second barrier of the last iteration)
    load_plane(j + kPStages - 1);
    cp_async_wait<kPStages - 1>();
    __syncthreads();  // plane j in; the last plane's y stage all read zb
    // z: the window's rows at the thread's z column
    const T* pl = plane + (j % kPStages) * LY * LZ;
    for (int ly = ty; ly < LY; ly += kPY) {
      const T* r = pl + ly * LZ + oz;
      T a = T(0);
#pragma unroll
      for (int k = 0; k < W; ++k) a += vz[k] * r[k];
      zb[ly * kPZ + tz] = a;
    }
    __syncthreads();
    // y at the thread's point, into the ring
    T v = T(0);
#pragma unroll
    for (int k = 0; k < W; ++k) v += vy[k] * zb[(oy + k) * kPZ + tz];
#pragma unroll
    for (int k = 0; k + 1 < W; ++k) ring[k] = ring[k + 1];
    ring[W - 1] = v;
    // x: the chunk's rows whose window ends at plane f0 + j (its first
    // plane in ring[0])
    while (next < cn && xs[next] + W - 1 == f0 + j) {
#pragma unroll
      for (int e = 0; e < 2 * W; ++e) {
        if (e < ne && ok) {
          const T* xw = xv + (next + e) * W;
          T acc = T(0);
#pragma unroll
          for (int k = 0; k < W; ++k) acc += xw[k] * ring[k];
          out[at(next + e)] = add ? acc + addv[e] : acc;
        }
      }
      next += ne;
      if (next < cn) fetch();
    }
  }
}

template <typename T, int W>
int launch_prolong_w(const T* in, const T* add, T* out, const int* starts,
                     const T* vals, int n_in, int n_out, int count, int LX,
                     int LY, int LZ, void* stream) {
  const size_t smem = (size_t)prolong_smem_elems(W, LX, LY, LZ) * sizeof(T) +
                      LX * sizeof(int);
  cudaError_t err = allow_smem((const void*)prolong_kernel<T, W>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)ceil_div(n_out, kPZ),
                  (unsigned)ceil_div(n_out, kPY),
                  (unsigned)(count * ceil_div(n_out, LX)));
  prolong_kernel<T, W><<<grid, kPY * kPZ, smem, (cudaStream_t)stream>>>(
      in, add, out, starts, vals, n_in, n_out, LX, LY, LZ);
  return (int)cudaGetLastError();
}

// the row width of P: p + 1 taps for degree p (1..7), fewer on tiny grids
template <typename T>
int launch_prolong(const T* in, const T* add, T* out, const int* starts,
                   const T* vals, int w, int n_in, int n_out, int count,
                   int LX, int LY, int LZ, void* stream) {
  if (LX < 1) return (int)cudaErrorInvalidValue;
  switch (w) {
#define PMG_CASE(WW)                                                      \
  case WW:                                                                \
    return launch_prolong_w<T, WW>(in, add, out, starts, vals, n_in,      \
                                   n_out, count, LX, LY, LZ, stream);
    PMG_CASE(1) PMG_CASE(2) PMG_CASE(3) PMG_CASE(4) PMG_CASE(5) PMG_CASE(6)
    PMG_CASE(7) PMG_CASE(8)
#undef PMG_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T, int WM>
int launch_restrict_w(const T* in, T* out, const int* starts, const T* vals,
                      int w, int n_in, int n_out, int count, int LY, int LZ,
                      void* stream) {
  const size_t smem = (size_t)restrict_smem_elems(w, LY, LZ) * sizeof(T) +
                      kChunk * sizeof(int);
  cudaError_t err = allow_smem((const void*)restrict_kernel<T, WM>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)ceil_div(n_out, kRZ),
                  (unsigned)ceil_div(n_out, kRY),
                  (unsigned)(count * ceil_div(n_out, kChunk)));
  restrict_kernel<T, WM><<<grid, kRY * kRZ, smem, (cudaStream_t)stream>>>(
      in, out, starts, vals, w, n_in, n_out, LY, LZ);
  return (int)cudaGetLastError();
}

// the row width rounded up to 4q + 1 (q = 1..7: degrees 1..7, w <= 4p + 1)
template <typename T>
int launch_restrict(const T* in, T* out, const int* starts, const T* vals,
                    int w, int n_in, int n_out, int count, int LY, int LZ,
                    void* stream) {
  switch (w <= 5 ? 1 : (w + 2) / 4) {
#define PMG_CASE(Q)                                                        \
  case Q:                                                                  \
    return launch_restrict_w<T, 4 * Q + 1>(in, out, starts, vals, w, n_in, \
                                           n_out, count, LY, LZ, stream);
    PMG_CASE(1) PMG_CASE(2) PMG_CASE(3) PMG_CASE(4) PMG_CASE(5) PMG_CASE(6)
    PMG_CASE(7)
#undef PMG_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int pmg_prolong_f32(const float* in, const float* add, float* out,
                               const int* starts, const float* vals, int w,
                               int n_in, int n_out, int count, int LX, int LY,
                               int LZ, void* stream) {
  return launch_prolong<float>(in, add, out, starts, vals, w, n_in, n_out,
                               count, LX, LY, LZ, stream);
}

extern "C" int pmg_prolong_f64(const double* in, const double* add,
                               double* out, const int* starts,
                               const double* vals, int w, int n_in, int n_out,
                               int count, int LX, int LY, int LZ,
                               void* stream) {
  return launch_prolong<double>(in, add, out, starts, vals, w, n_in, n_out,
                                count, LX, LY, LZ, stream);
}

extern "C" int pmg_restrict_f32(const float* in, float* out, const int* starts,
                                const float* vals, int w, int n_in, int n_out,
                                int count, int LY, int LZ, void* stream) {
  return launch_restrict<float>(in, out, starts, vals, w, n_in, n_out, count,
                                LY, LZ, stream);
}

extern "C" int pmg_restrict_f64(const double* in, double* out,
                                const int* starts, const double* vals, int w,
                                int n_in, int n_out, int count, int LY, int LZ,
                                void* stream) {
  return launch_restrict<double>(in, out, starts, vals, w, n_in, n_out, count,
                                 LY, LZ, stream);
}
