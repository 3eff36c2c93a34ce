// Warp-level bf16 tensor-core helpers of the flash-attention backward
// kernels (flash_attn_bwd.cu): mma.sync m16n8k16 with f32 accumulation and
// its operand fragments read from shared memory.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace fgdm {

typedef __nv_bfloat16 bf16;

// c += a * b over one 16x8x16 tile.
__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragment (16x16, row-major in shared memory with row stride ld) of the
// m16n8k16 product: rows g and g+8, columns 2t, 2t+1 and 2t+8, 2t+9.
__device__ __forceinline__ void load_a(uint32_t a[4], const bf16* base, int ld,
                                       int g, int t) {
  a[0] = ld_pair(base + g * ld + 2 * t);
  a[1] = ld_pair(base + (g + 8) * ld + 2 * t);
  a[2] = ld_pair(base + g * ld + 2 * t + 8);
  a[3] = ld_pair(base + (g + 8) * ld + 2 * t + 8);
}

// B fragment (16x8, k x n) read from an n-major tile: element (k, n) sits at
// base[n * ld + k].
__device__ __forceinline__ void load_b(uint32_t b[2], const bf16* base, int ld,
                                       int g, int t) {
  b[0] = ld_pair(base + g * ld + 2 * t);
  b[1] = ld_pair(base + g * ld + 2 * t + 8);
}

// Copy `rows` rows of a [*, D] bf16 tile from global memory (row stride D)
// into shared memory (row stride ld), zero-filling columns D..DK-1 and rows
// at or past `valid`.  16 bytes per thread per step.
template <int D, int DK, int THREADS>
__device__ __forceinline__ void load_rows(bf16* dst, int ld, const bf16* src,
                                          int rows, int valid, int tid) {
  constexpr int CH = DK / 8;
  for (int idx = tid; idx < rows * CH; idx += THREADS) {
    const int r = idx / CH, c8 = idx % CH;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid && c8 * 8 < D)
      val = *reinterpret_cast<const uint4*>(src + (size_t)r * D + c8 * 8);
    *reinterpret_cast<uint4*>(dst + r * ld + c8 * 8) = val;
  }
}

// Copy `rows` rows of a [*, D] bf16 tile transposed into shared memory:
// element (r, c) lands at dst[c * ld + r]; rows at or past `valid` are zero.
template <int D, int THREADS>
__device__ __forceinline__ void load_rows_t(bf16* dst, int ld, const bf16* src,
                                            int rows, int valid, int tid) {
  constexpr int CH = D / 8;
  for (int idx = tid; idx < rows * CH; idx += THREADS) {
    const int r = idx / CH, c8 = idx % CH;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid)
      val = *reinterpret_cast<const uint4*>(src + (size_t)r * D + c8 * 8);
    const bf16* e = reinterpret_cast<const bf16*>(&val);
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[(c8 * 8 + j) * ld + r] = e[j];
  }
}

}  // namespace fgdm
