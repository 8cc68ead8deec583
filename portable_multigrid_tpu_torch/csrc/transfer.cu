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
// 0.029 ms at 3 x 192^3 at 3.35 TB/s.
//
// prolongate (transfer_kernel): a block owns a TX x TY x TZ output tile.  It
// contracts x reading the coarse input straight from global memory
// (coalesced along z), keeping the (TX, LY, LZ) result in shared memory,
// where LY / LZ are the input extents its rows reach (sized on the host from
// the nondecreasing row starts), then contracts y and z through shared
// memory and adds the addend in the epilogue.
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

// per-block shared-memory elements of transfer_kernel; must match
// transfer_smem_elems() in ops/cuda_transfer.py
__host__ __device__ inline int64_t smem_elems(int TX, int TY, int LY, int LZ) {
  return (int64_t)TX * LY * LZ + (int64_t)TX * TY * LZ;
}

// ... of restrict_kernel, values only (kChunk int starts follow them); must
// match restrict_smem_elems() in ops/cuda_transfer.py
__host__ __device__ inline int64_t restrict_smem_elems(int w, int LY, int LZ) {
  return 2 * (int64_t)LY * LZ + (int64_t)LY * kRZ + (int64_t)kChunk * w;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
transfer_kernel(const T* __restrict__ in, const T* __restrict__ add,
                T* __restrict__ out, const int* __restrict__ starts,
                const T* __restrict__ vals, int w, int n_in_, int n_out_,
                int TX, int TY, int TZ, int LY, int LZ) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int64_t n_in = n_in_, n_out = n_out_;
  T* buf1 = reinterpret_cast<T*>(smem_raw);  // x stage (TX, LY, LZ)
  T* buf2 = buf1 + (int64_t)TX * LY * LZ;     // y stage (TX, TY, LZ)
  // blockIdx.z runs over (component, x tile)
  const int64_t ntx = ceil_div(n_out, TX);
  const int64_t comp = blockIdx.z / ntx;
  in += comp * n_in * n_in * n_in;
  out += comp * n_out * n_out * n_out;
  if (add) add += comp * n_out * n_out * n_out;
  const int64_t x0 = (blockIdx.z % ntx) * TX;
  const int64_t y0 = (int64_t)blockIdx.y * TY;
  const int64_t z0 = (int64_t)blockIdx.x * TZ;
  const int64_t sy = starts[y0], sz = starts[z0];
  const int tid = threadIdx.x, nt = blockDim.x;

  // x: (TX, LY, LZ), straight from global memory (z-contiguous rows, so
  // neighbouring threads read neighbouring addresses)
  const int n1 = TX * LY * LZ;
  for (int i = tid; i < n1; i += nt) {
    const int lz = i % LZ, t = i / LZ, ly = t % LY, lx = t / LY;
    const int64_t gx = x0 + lx, gy = sy + ly, gz = sz + lz;
    T acc = T(0);
    if (gx < n_out && gy < n_in && gz < n_in) {
      const int64_t s = starts[gx];
      const T* src = in + (s * n_in + gy) * n_in + gz;
      for (int k = 0; k < w; ++k) {
        acc += vals[gx * w + k] * src[(int64_t)k * n_in * n_in];
      }
    }
    buf1[i] = acc;
  }
  __syncthreads();

  // y: (TX, TY, LZ)
  const int n2 = TX * TY * LZ;
  for (int i = tid; i < n2; i += nt) {
    const int lz = i % LZ, t = i / LZ, ly = t % TY, lx = t / TY;
    const int64_t gy = y0 + ly;
    T acc = T(0);
    if (gy < n_out) {
      const int64_t off = starts[gy] - sy;
      for (int k = 0; k < w; ++k) {
        acc += vals[gy * w + k] * buf1[((int64_t)lx * LY + off + k) * LZ + lz];
      }
    }
    buf2[i] = acc;
  }
  __syncthreads();

  // z + addend: the tile
  const int n3 = TX * TY * TZ;
  for (int i = tid; i < n3; i += nt) {
    const int lz = i % TZ, t = i / TZ, ly = t % TY, lx = t / TY;
    const int64_t gx = x0 + lx, gy = y0 + ly, gz = z0 + lz;
    if (gx >= n_out || gy >= n_out || gz >= n_out) continue;
    const int64_t off = starts[gz] - sz;
    const T* src = buf2 + ((int64_t)lx * TY + ly) * LZ + off;
    T acc = T(0);
    for (int k = 0; k < w; ++k) acc += vals[gz * w + k] * src[k];
    const int64_t g = (gx * n_out + gy) * n_out + gz;
    out[g] = add ? acc + add[g] : acc;
  }
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

template <typename T>
int launch(const T* in, const T* add, T* out, const int* starts, const T* vals,
           int w, int n_in, int n_out, int count, int TX, int TY, int TZ,
           int LY, int LZ, void* stream) {
  const size_t smem = (size_t)smem_elems(TX, TY, LY, LZ) * sizeof(T);
  cudaError_t err = allow_smem((const void*)transfer_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)ceil_div(n_out, TZ), (unsigned)ceil_div(n_out, TY),
                  (unsigned)(count * ceil_div(n_out, TX)));
  transfer_kernel<T><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      in, add, out, starts, vals, w, n_in, n_out, TX, TY, TZ, LY, LZ);
  return (int)cudaGetLastError();
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

extern "C" int pmg_transfer_f32(const float* in, const float* add, float* out,
                                const int* starts, const float* vals, int w,
                                int n_in, int n_out, int count, int TX, int TY,
                                int TZ, int LY, int LZ, void* stream) {
  return launch<float>(in, add, out, starts, vals, w, n_in, n_out, count, TX,
                       TY, TZ, LY, LZ, stream);
}

extern "C" int pmg_transfer_f64(const double* in, const double* add,
                                double* out, const int* starts,
                                const double* vals, int w, int n_in, int n_out,
                                int count, int TX, int TY, int TZ, int LY,
                                int LZ, void* stream) {
  return launch<double>(in, add, out, starts, vals, w, n_in, n_out, count, TX,
                        TY, TZ, LY, LZ, stream);
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
