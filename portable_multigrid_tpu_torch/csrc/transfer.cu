// B.3 — fused separable grid transfer: restrict, prolongate, prolongate+add.
//
// Replaces the TPU kernel portable_multigrid_tpu/ops/pallas_transfer.py
// PallasTransfer._run.  Between trimmed 3D levels the transfer is
//     P = Px (x) Py (x) Pz,   P_ax = diag(w_f m_f) E_ax diag(m_c)
// (1/valence weights and both Dirichlet masks folded into one 1D matrix per
// axis, _axis_matrix_1d(...)[:-1, :-1]); restriction is the exact transpose.
// The kernel computes out = (W (x) W (x) W) in (+ add) for one 1D matrix W
// given row by row in a padded-row ("ELL") form: row i has its nonzeros in
// columns starts[i] .. starts[i] + w - 1, values vals[i * w + k].  The
// wrapper passes W = P for prolongation and W = P^T for restriction, so one
// kernel serves every direction, and a restriction column's 4p+1 fine rows
// are read once per tile instead of as a per-point (4p+1)^3 gather.
//
// What bounds it on the H100: HBM traffic.  Prolongate+add reads the coarse
// field (1/8 of a fine one) and the fine addend and writes the fine result,
// about 8.5 B per fine DoF in f32; restriction reads the fine field and
// writes an eighth of it, about 4.5 B per fine DoF.  At 3.35 TB/s the r=6
// fine pair is tens of microseconds.
//
// Design: a block owns a TX x TY x TZ output tile.  It contracts x reading
// the input straight from global memory (coalesced along z), keeping the
// (TX, LY, LZ) result in shared memory, where LY / LZ are the input extents
// its rows reach (sized on the host from the nondecreasing row starts), then
// contracts y and z through shared memory and adds the addend in the
// epilogue.  Loading a full 3D input window first would not fit shared
// memory for restriction at large p.  The TPU's
// hi/lo bf16 split and its 8-row padded DMA frame were Mosaic workarounds
// and are not carried over: the contractions are plain f32 / f64 FMAs.
#include "common.cuh"

using namespace pmg;

namespace {

// per-block shared-memory elements; must match transfer_smem_elems() in
// ops/cuda_transfer.py
__host__ __device__ inline int64_t smem_elems(int TX, int TY, int LY, int LZ) {
  return (int64_t)TX * LY * LZ + (int64_t)TX * TY * LZ;
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
  const int64_t x0 = (int64_t)blockIdx.z * TX;
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

template <typename T>
int launch(const T* in, const T* add, T* out, const int* starts, const T* vals,
           int w, int n_in, int n_out, int TX, int TY, int TZ, int LY, int LZ,
           void* stream) {
  const size_t smem = (size_t)smem_elems(TX, TY, LY, LZ) * sizeof(T);
  cudaError_t err = allow_smem((const void*)transfer_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)ceil_div(n_out, TZ), (unsigned)ceil_div(n_out, TY),
                  (unsigned)ceil_div(n_out, TX));
  transfer_kernel<T><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      in, add, out, starts, vals, w, n_in, n_out, TX, TY, TZ, LY, LZ);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int pmg_transfer_f32(const float* in, const float* add, float* out,
                                const int* starts, const float* vals, int w,
                                int n_in, int n_out, int TX, int TY, int TZ,
                                int LY, int LZ, void* stream) {
  return launch<float>(in, add, out, starts, vals, w, n_in, n_out, TX, TY, TZ,
                       LY, LZ, stream);
}

extern "C" int pmg_transfer_f64(const double* in, const double* add,
                                double* out, const int* starts,
                                const double* vals, int w, int n_in, int n_out,
                                int TX, int TY, int TZ, int LY, int LZ,
                                void* stream) {
  return launch<double>(in, add, out, starts, vals, w, n_in, n_out, TX, TY, TZ,
                        LY, LZ, stream);
}
