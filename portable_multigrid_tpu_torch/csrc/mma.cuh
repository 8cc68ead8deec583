// bf16 fragments of mma.sync.m16n8k16 (bf16 in, float32 accumulators): the
// helpers of the tensor-core instances (cheb2mma.cu, elasticitymma.cu).
#pragma once

#include "common.cuh"

namespace pmg {

__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// two floats rounded to bf16, lo in the low half (the lower column of a
// fragment register)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return bf16_bits(lo) | (bf16_bits(hi) << 16);
}

__device__ __forceinline__ float lo_bf16(uint32_t w) {
  return __uint_as_float(w << 16);
}

__device__ __forceinline__ float hi_bf16(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// c += A B, A 16 x 16 (row), B 16 x 8 (col), bf16 in, float accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s)
      : "memory");
}

// the band fragments B[k][n] = band_{k - n}[row n] of an 8-row group whose
// row n lies on global row gy0 + n (valid below nvalid); k the 16 KT input
// rows from the group's first tap row; band [2P+1][N] as common.cuh stores
// it
template <int P, int KT>
__device__ __forceinline__ void band_fragments(const float* __restrict__ band,
                                               int N, int gy0, int nvalid,
                                               int lane,
                                               uint32_t (&yb)[KT][2]) {
  const int n = lane >> 2, t = lane & 3;
  const int gy = gy0 + n;
  const bool ok = n < nvalid && gy >= 0 && gy < N;
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float v[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int o = 16 * kt + 2 * t + 8 * j + u - n;
        v[u] = ok && o >= 0 && o <= 2 * P ? band[o * N + gy] : 0.f;
      }
      yb[kt][j] = pack_bf16(v[0], v[1]);
    }
  }
}

}  // namespace pmg
