// Flash-attention forward at head dim 512 for Hopper (sm_90a), bf16 in /
// bf16 out: the VAE mid-block's single 512-wide head.
//
// Replaces two Pallas TPU kernels of fgdm_tpu/kernels/attention.py:
//   _flash_kernel    (:121)  row-major, whole K/V resident (N = 1024)
//   _flash_kernel_kv (:516)  K/V streamed over the grid    (N = 4096)
// (the d <= 96 kernel _flash_kernel_t stays in flash_attn_fwd.cu).  The TPU
// needed two kernels for VMEM residency; here one kernel computes
// softmax(q k^T * scale) v with an online softmax, so no N x N matrix
// reaches device memory, and a small second kernel combines partial results
// when the keys are split across blocks.
//
// What bounds it on the card: 4*N^2*512 operations on 8*N*512 bytes, far
// above the ridge, so the tensor cores bound it, and with B*H = 1 the card
// only fills if the work of one head is spread over the SMs.  The design:
//
//   * A block owns 64 query rows and a slice of the keys.  The grid is
//     (row tiles) x (KV splits) x (B*H); the host picks the split count so
//     that one wave of blocks covers the 132 SMs (kernels/attention.py
//     kv_splits).  With one split the block normalises and writes bf16
//     output (and lse); otherwise it writes its unnormalised f32 output with
//     the row maximum and row sum, and flash_combine_kernel merges the
//     partials in a fixed order (rescale by exp2(m_i - m), sum, one division,
//     one rounding).  No atomics: reruns are bit-identical.  The same pass
//     combines flash_attn_fwd_f32.cu's partials into f32.
//   * Q (64 x 512, 64 KB) stays in shared memory for the whole block; K and
//     V tiles of 32 keys (32 KB each) come by TMA into a two-stage ring
//     behind full/empty mbarriers, filled by one producer warp.  All tiles
//     are stored as eight 64-column panels with the 128-byte swizzle.
//   * Both products run on wgmma.  S = Q K^T takes both operands K-major
//     from shared memory (m64n32k16, 32 steps over d).  O += P V takes P from
//     registers (the score accumulators, rounded to bf16, already have the
//     A-fragment layout) and V as an MN-major B operand through the
//     descriptor's transpose bit, so V is never transposed by hand.
//   * The 64 x 512 f32 output is split over two consumer warpgroups, 256
//     columns each (128 accumulator registers a thread, m64n256k16).  Both
//     need the same P; each computes S for all 32 keys itself (Q K^T twice,
//     no exchange through shared memory).
//   * The online softmax runs on the score accumulators in registers, row
//     statistics shared by quad shuffles, in base 2 (scores scaled by
//     scale * log2 e).
//
// Numerics follow the plain version (_xla_attention, attention.py:63-71):
// f32 scores and statistics, P rounded to bf16 before P.V, f32 accumulation
// of the output, one division by the row sum at the end.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace fgdm;

constexpr int D = 512;
constexpr int BM = 64;                  // query rows per block
constexpr int BN = 32;                  // keys per streamed tile
constexpr int STAGES = 2;
constexpr int PANELS = D / 64;          // 64-column panels of a tile
constexpr int Q_PANEL = BM * 128;       // bytes
constexpr int KV_PANEL = BN * 128;
constexpr int Q_BYTES = PANELS * Q_PANEL;    // 64 KB
constexpr int KV_BYTES = PANELS * KV_PANEL;  // 32 KB
constexpr int HEADER = 1024;            // the mbarriers, ahead of the tiles
constexpr int SMEM = 1024 + HEADER + Q_BYTES + 2 * STAGES * KV_BYTES;
constexpr int THREADS = 2 * 128 + 32;   // two consumer warpgroups, a producer
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// q/k/v as 3-D maps {512, n, bh} with boxes {64, 64, 1} (q) and {64, 32, 1}
// (k, v).  o [bh, nq, 512] bf16 and lse [bh, nq] f32 (or null) are written
// when gridDim.y == 1; else part_o [splits, bh, nq, 512] f32 (unnormalised),
// part_m (row maxima of the scores times scale * log2 e) and part_l (row
// sums of exp2) [splits, bh, nq].  sl = scale * log2 e.
__global__ void __launch_bounds__(THREADS)
flash_fwd_d512_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      bf16* __restrict__ o, float* __restrict__ lse,
                      float* __restrict__ part_o, float* __restrict__ part_m,
                      float* __restrict__ part_l, int nq, int nk,
                      int tiles_per_split, float sl) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_full = base;
  const uint32_t k_full = base + 8, k_empty = k_full + 8 * STAGES;
  const uint32_t v_full = k_empty + 8 * STAGES, v_empty = v_full + 8 * STAGES;
  const uint32_t q_s = base + HEADER;
  const uint32_t k_ring = q_s + Q_BYTES;
  const uint32_t v_ring = k_ring + STAGES * KV_BYTES;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int row0 = blockIdx.x * BM;
  const int split = blockIdx.y, splits = gridDim.y;
  const int bh = blockIdx.z, n_bh = gridDim.z;
  const int t0 = split * tiles_per_split;
  const int t1 = min(t0 + tiles_per_split, nk / BN);

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(k_full + 8 * i, 1);
      mbar_init(v_full + 8 * i, 1);
      mbar_init(k_empty + 8 * i, 8);  // one arrival per consumer warp
      mbar_init(v_empty + 8 * i, 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 8) {
    // ---- producer ----
    if (lane == 0) {
      mbar_expect_tx(q_full, Q_BYTES);
      for (int p = 0; p < PANELS; ++p)
        tma_load_3d(q_s + p * Q_PANEL, &qmap, q_full, p * 64, row0, bh);
      int s = 0;
      uint32_t ph = 1;
      for (int t = t0; t < t1; ++t) {
        mbar_wait(k_empty + 8 * s, ph);
        mbar_expect_tx(k_full + 8 * s, KV_BYTES);
        for (int p = 0; p < PANELS; ++p)
          tma_load_3d(k_ring + s * KV_BYTES + p * KV_PANEL, &kmap,
                      k_full + 8 * s, p * 64, t * BN, bh);
        mbar_wait(v_empty + 8 * s, ph);
        mbar_expect_tx(v_full + 8 * s, KV_BYTES);
        for (int p = 0; p < PANELS; ++p)
          tma_load_3d(v_ring + s * KV_BYTES + p * KV_PANEL, &vmap,
                      v_full + 8 * s, p * 64, t * BN, bh);
        if (++s == STAGES) { s = 0; ph ^= 1; }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns output columns [256 wg, 256 wg + 256);
  // this thread rows 16 w4 + g and + 8 of the tile ----
  const int wg = warp >> 2, w4 = warp & 3;
  const int g = lane >> 2, t = lane & 3;

  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  mbar_wait(q_full, 0);
  int s = 0;
  uint32_t ph = 0;
#pragma unroll 1
  for (int tile = t0; tile < t1; ++tile) {
    // S = Q K^T over the 32 keys of the tile
    float sc[16];
    mbar_wait(k_full + 8 * s, ph);
    const uint32_t k_s = k_ring + s * KV_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk & 3) * 32;
      wgmma_m64n32k16_ss(
          sc, desc_sw128(q_s + (kk >> 2) * Q_PANEL + off, 16, 1024),
          desc_sw128(k_s + (kk >> 2) * KV_PANEL + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    __syncwarp();
    if (lane == 0) mbar_arrive(k_empty + 8 * s);

    // online softmax in base 2; sc[4j], sc[4j+1] are row g, sc[4j+2],
    // sc[4j+3] row g + 8, at keys 8j + 2t and + 1
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
    const float mn0 = fmaxf(m0, quad_max(mx0) * sl);
    const float mn1 = fmaxf(m1, quad_max(mx1) * sl);
    const float alpha0 = exp2f(m0 - mn0), alpha1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      sc[4 * j] = exp2f(sc[4 * j] * sl - mn0);
      sc[4 * j + 1] = exp2f(sc[4 * j + 1] * sl - mn0);
      sc[4 * j + 2] = exp2f(sc[4 * j + 2] * sl - mn1);
      sc[4 * j + 3] = exp2f(sc[4 * j + 3] * sl - mn1);
      sum0 += sc[4 * j] + sc[4 * j + 1];
      sum1 += sc[4 * j + 2] + sc[4 * j + 3];
    }
    l0 = l0 * alpha0 + sum0;  // this thread's share; the quad adds up below
    l1 = l1 * alpha1 + sum1;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      acc[4 * j] *= alpha0;
      acc[4 * j + 1] *= alpha0;
      acc[4 * j + 2] *= alpha1;
      acc[4 * j + 3] *= alpha1;
    }
    // P as A fragments: two k16 steps over the 32 keys
    uint32_t pa[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }

    // O += P V on this warpgroup's four column panels of V
    mbar_wait(v_full + 8 * s, ph);
    const uint32_t v_s = v_ring + s * KV_BYTES + 4 * wg * KV_PANEL;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
      wgmma_m64n256k16_rs_tb(acc, pa[kk],
                             desc_sw128(v_s + kk * 2048, KV_PANEL, 1024), 1);
    wgmma_commit();
    wgmma_wait<0>();
    __syncwarp();
    if (lane == 0) mbar_arrive(v_empty + 8 * s);
    if (++s == STAGES) { s = 0; ph ^= 1; }
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const int ra = row0 + w4 * 16 + g, rb = ra + 8;
  const int col0 = wg * 256 + 2 * t;
  if (splits == 1) {
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
    bf16* oa = o + ((size_t)bh * nq + ra) * D + col0;
    bf16* ob = o + ((size_t)bh * nq + rb) * D + col0;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      if (ra < nq)
        *reinterpret_cast<__nv_bfloat162*>(oa + 8 * j) =
            __floats2bfloat162_rn(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
      if (rb < nq)
        *reinterpret_cast<__nv_bfloat162*>(ob + 8 * j) =
            __floats2bfloat162_rn(acc[4 * j + 2] * inv1,
                                  acc[4 * j + 3] * inv1);
    }
    if (lse != nullptr && wg == 0 && t == 0) {
      if (ra < nq) lse[(size_t)bh * nq + ra] = (m0 + log2f(l0)) * LN2;
      if (rb < nq) lse[(size_t)bh * nq + rb] = (m1 + log2f(l1)) * LN2;
    }
  } else {
    const size_t pr = (size_t)split * n_bh + bh;
    float* oa = part_o + (pr * nq + ra) * D + col0;
    float* ob = part_o + (pr * nq + rb) * D + col0;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      if (ra < nq)
        *reinterpret_cast<float2*>(oa + 8 * j) =
            make_float2(acc[4 * j], acc[4 * j + 1]);
      if (rb < nq)
        *reinterpret_cast<float2*>(ob + 8 * j) =
            make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
    if (wg == 0 && t == 0) {
      if (ra < nq) {
        part_m[pr * nq + ra] = m0;
        part_l[pr * nq + ra] = l0;
      }
      if (rb < nq) {
        part_m[pr * nq + rb] = m1;
        part_l[pr * nq + rb] = l1;
      }
    }
  }
}

// One block per output row, four columns a thread.  part_* as above with
// rows = bh * nq; o [rows, 512] in T (bf16 for this file's kernel, f32 for
// flash_attn_fwd_f32.cu's); lse [rows] f32 or null.
__device__ __forceinline__ void store4(bf16* p, float4 a) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a.x, a.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(a.z, a.w);
  uint2 packed;
  packed.x = *reinterpret_cast<uint32_t*>(&lo);
  packed.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = packed;
}

__device__ __forceinline__ void store4(float* p, float4 a) {
  *reinterpret_cast<float4*>(p) = a;
}

template <typename T>
__global__ void __launch_bounds__(D / 4)
flash_combine_kernel(const float* __restrict__ part_o,
                     const float* __restrict__ part_m,
                     const float* __restrict__ part_l, T* __restrict__ o,
                     float* __restrict__ lse, int rows, int splits) {
  const int row = blockIdx.x, col = threadIdx.x * 4;
  float m = -INFINITY;
  for (int i = 0; i < splits; ++i)
    m = fmaxf(m, part_m[(size_t)i * rows + row]);
  float l = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = 0; i < splits; ++i) {
    const float w = exp2f(part_m[(size_t)i * rows + row] - m);
    l += w * part_l[(size_t)i * rows + row];
    const float4 p = *reinterpret_cast<const float4*>(
        part_o + ((size_t)i * rows + row) * D + col);
    acc.x += w * p.x;
    acc.y += w * p.y;
    acc.z += w * p.z;
    acc.w += w * p.w;
  }
  const float inv = 1.f / l;
  store4(o + (size_t)row * D + col,
         make_float4(acc.x * inv, acc.y * inv, acc.z * inv, acc.w * inv));
  if (lse != nullptr && threadIdx.x == 0) lse[row] = (m + log2f(l)) * LN2;
}

int encode_qkv(CUtensorMap* map, const void* p, int n, int bh, int box_rows) {
  const cuuint64_t dims[3] = {D, (cuuint64_t)n, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {D * 2, (cuuint64_t)n * D * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  return encode_bf16_map(map, p, 3, dims, strides, box);
}

}  // namespace

extern "C" {

// The main kernel.  q/k/v: contiguous [bh, n, 512] bf16, 16-byte aligned, on
// the current device; nk a multiple of 32; the keys go to `splits` blocks a
// row tile, ceil(nk / 32 / splits) tiles each, every split non-empty.  With
// splits == 1, o [bh, nq, 512] bf16 and lse ([bh, nq] f32 or null) are
// written; else the partials part_o [splits, bh, nq, 512] f32, part_m and
// part_l [splits, bh, nq] f32 for fgdm_flash_combine.  Returns 0, a
// cudaError_t code (launch errors included) or a tensor-map error.
int fgdm_flash_attn_fwd_d512(const void* q, const void* k, const void* v,
                             void* o, void* lse, void* part_o, void* part_m,
                             void* part_l, int bh, int nq, int nk, int splits,
                             float scale, void* stream) {
  if (bh <= 0 || bh > 65535 || nq <= 0 || nk <= 0 || nk % BN != 0 ||
      splits < 1 || splits > 65535)
    return (int)cudaErrorInvalidValue;
  const int tiles = nk / BN, per = (tiles + splits - 1) / splits;
  if ((tiles + per - 1) / per != splits) return (int)cudaErrorInvalidValue;
  if (splits == 1 ? o == nullptr
                  : (part_o == nullptr || part_m == nullptr ||
                     part_l == nullptr))
    return (int)cudaErrorInvalidValue;
  CUtensorMap qmap, kmap, vmap;
  int rc = encode_qkv(&qmap, q, nq, bh, BM);
  if (rc == 0) rc = encode_qkv(&kmap, k, nk, bh, BN);
  if (rc == 0) rc = encode_qkv(&vmap, v, nk, bh, BN);
  if (rc != 0) return rc;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_d512_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((nq + BM - 1) / BM, splits, bh);
  flash_fwd_d512_kernel<<<grid, THREADS, SMEM,
                          static_cast<cudaStream_t>(stream)>>>(
      qmap, kmap, vmap, static_cast<bf16*>(o), static_cast<float*>(lse),
      static_cast<float*>(part_o), static_cast<float*>(part_m),
      static_cast<float*>(part_l), nq, nk, per,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

// The combine pass over the partials of this file's kernel or of
// flash_attn_fwd_f32.cu's: rows = bh * nq output rows of 512 columns, o in
// bf16 (out_f32 == 0) or f32 (out_f32 == 1).  Returns 0 or a cudaError_t
// code.
int fgdm_flash_combine(const void* part_o, const void* part_m,
                       const void* part_l, void* o, void* lse, int rows,
                       int splits, int out_f32, void* stream) {
  if (rows <= 0 || splits < 1 || (out_f32 != 0 && out_f32 != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* po = static_cast<const float*>(part_o);
  const float* pm = static_cast<const float*>(part_m);
  const float* pl = static_cast<const float*>(part_l);
  if (out_f32)
    flash_combine_kernel<float><<<rows, D / 4, 0, s>>>(
        po, pm, pl, static_cast<float*>(o), static_cast<float*>(lse), rows,
        splits);
  else
    flash_combine_kernel<bf16><<<rows, D / 4, 0, s>>>(
        po, pm, pl, static_cast<bf16*>(o), static_cast<float*>(lse), rows,
        splits);
  return (int)cudaGetLastError();
}

const char* fgdm_cuda_error_string(int code) { return error_string(code); }

}  // extern "C"
