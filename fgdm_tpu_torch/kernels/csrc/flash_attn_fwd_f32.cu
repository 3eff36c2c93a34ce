// Flash-attention forward in float32 for Hopper (sm_90a): f32 in / f32 out
// at the head dims 40 and 80 (the SD-1.x UNet's) and 512 (the VAE's single
// head), IEEE float32 products on the CUDA cores.
//
// Replaces, in float32, three Pallas TPU kernels of
// fgdm_tpu/kernels/attention.py, which the JAX package runs in float32
// wherever the model computes in float32 (--precision full):
//   _flash_kernel_t  (:157)  d <= 96, optional logsumexp
//   _flash_kernel    (:121)  d = 512, whole K/V resident
//   _flash_kernel_kv (:516)  d = 512, K/V streamed
// The bf16 kernels (flash_attn_fwd.cu, flash_attn_fwd_d512.cu) stay for
// bf16.  At d = 512 the keys may be split across blocks as there
// (kernels/attention.py kv_splits): a split block writes the same f32
// partials, and flash_attn_fwd_d512.cu's combine pass merges them.
//
// What bounds it on the card: 4*N^2*d operations on 16*N*d bytes.  No tensor
// core keeps float32's 24-bit products (TF32 keeps 11 bits, about three
// digits), so the products run as FFMA, 67 TFLOP/s at most, and that bounds
// every shape the gate admits (N >= 512).  The design keeps the FMA units
// fed from shared memory:
//
//   * A block owns BM query rows and walks the keys of its slice in tiles
//     of BN (Tile<D> below).  Q stays in shared memory; the next K tile is
//     copied in by cp.async while the block computes the softmax and P.V of
//     this one, the next V tile while it computes the next Q K^T.
//   * S = Q K^T: each thread computes a 4 x 4 block of scores from float4
//     reads of Q and K rows (rows padded by 4 floats, so the eight keys a
//     quarter-warp reads fall in different banks): 16 FMAs per 8 loads.  At
//     d = 512 each score's sum is cut into DS = 8 slices of d over eight
//     neighbouring lanes and added up by shuffles, so that all 256 threads
//     work on the 16 x 32 score tile.
//   * The online softmax runs in base 2 (scores times scale * log2 e) on
//     the score tile in shared memory, TPR threads a row, row statistics by
//     shuffles; P overwrites S, and each row's rescale factor goes to
//     shared memory.
//   * O += P V: each thread owns RG rows x 4 columns of the f32 output in
//     registers, rescales them, then reads P rows and V rows as float4.
//   * The end divides by the row sum once and writes the output (and the
//     lse), or, for a split, the unnormalised output, row maximum and row
//     sum.  A fixed order of sums and no atomics: reruns are bit-identical.
//
// Numerics follow the plain version (_xla_attention, attention.py:63-71, in
// float32): f32 scores, softmax and P.V, one division by the row sum.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace fgdm;

constexpr int THREADS = 256;
constexpr float LN2 = 0.6931471805599453f;

// The tile of each head dim: BM query rows and BN keys a block; S = Q K^T
// as TM x TN scores a thread over DS slices of d; P.V as RG rows x 4
// columns a thread.
template <int D>
struct Tile;
template <>
struct Tile<40> {
  static constexpr int BM = 64, BN = 64, TM = 4, TN = 4, DS = 1, RG = 4;
};
template <>
struct Tile<80> {
  static constexpr int BM = 64, BN = 64, TM = 4, TN = 4, DS = 1, RG = 8;
};
template <>
struct Tile<512> {
  static constexpr int BM = 16, BN = 32, TM = 4, TN = 4, DS = 8, RG = 8;
};

// Dynamic shared memory: Q and K tiles (rows of D + 4 floats), the V tile,
// the score tile (rows of BN + 4) and three row statistics.
template <int D>
constexpr int smem_bytes() {
  using T = Tile<D>;
  return 4 * ((T::BM + T::BN) * (D + 4) + T::BN * D +
              T::BM * (T::BN + 4) + 3 * T::BM);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// q [bh, nq, D], k/v [bh, nk, D] f32.  o [bh, nq, D] and lse [bh, nq] (or
// null) are written when gridDim.y == 1; else part_o [splits, bh, nq, D]
// (unnormalised), part_m (row maxima of the scores times sl) and part_l
// (row sums of exp2) [splits, bh, nq].  sl = scale * log2 e.
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, float* __restrict__ part_o,
                     float* __restrict__ part_m, float* __restrict__ part_l,
                     int nq, int nk, int tiles_per_split, float sl) {
  using T = Tile<D>;
  constexpr int BM = T::BM, BN = T::BN, TM = T::TM, TN = T::TN, DS = T::DS,
                RG = T::RG;
  constexpr int QS = D + 4, SS = BN + 4;  // row strides in floats
  constexpr int C4 = D / 4;               // float4 columns of a row
  constexpr int SY = BM / TM, SX = BN / TN;
  constexpr int TPR = THREADS / BM;       // softmax threads of a row
  constexpr int PV_THREADS = BM / RG * C4;
  static_assert(SY * SX * DS == THREADS, "every thread computes scores");
  static_assert(PV_THREADS <= THREADS && BN % TPR == 0 && C4 % DS == 0,
                "tile");

  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;
  float* k_s = q_s + BM * QS;
  float* v_s = k_s + BN * QS;
  float* s_s = v_s + BN * D;
  float* alpha_s = s_s + BM * SS;
  float* l_s = alpha_s + BM;
  float* m_s = l_s + BM;

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * BM;
  const int split = blockIdx.y, splits = gridDim.y;
  const int bh = blockIdx.z, n_bh = gridDim.z;
  const int t0 = split * tiles_per_split;
  const int t1 = min(t0 + tiles_per_split, nk / BN);
  const float* kb = k + (size_t)bh * nk * D;
  const float* vb = v + (size_t)bh * nk * D;

  auto load_k = [&](int tile) {
    for (int i = tid; i < BN * C4; i += THREADS) {
      const int r = i / C4, c = i % C4;
      cp_async16(smem_u32(k_s + r * QS + 4 * c),
                 kb + ((size_t)tile * BN + r) * D + 4 * c, 16);
    }
    cp_async_commit();
  };
  auto load_v = [&](int tile) {
    for (int i = tid; i < BN * C4; i += THREADS) {
      const int r = i / C4, c = i % C4;
      cp_async16(smem_u32(v_s + r * D + 4 * c),
                 vb + ((size_t)tile * BN + r) * D + 4 * c, 16);
    }
    cp_async_commit();
  };

  // Q, with the rows past nq zero (computed, never stored); it lands with
  // the first K tile
  const float* qb = q + (size_t)bh * nq * D;
  for (int i = tid; i < BM * C4; i += THREADS) {
    const int r = i / C4, c = i % C4;
    const bool in = row0 + r < nq;
    cp_async16(smem_u32(q_s + r * QS + 4 * c),
               qb + (size_t)(in ? row0 + r : 0) * D + 4 * c, in ? 16 : 0);
  }
  load_k(t0);
  load_v(t0);

  // S: scores (sy + SY i, sx + SX j) over the d-slice ds
  const int ds = tid % DS, sx = tid / DS % SX, sy = tid / DS / SX;
  // softmax: row srow, keys spart + TPR j; m_run/l_run are the row's
  // running maximum (base 2) and sum, the same in all TPR threads
  const int srow = tid / TPR, spart = tid % TPR;
  float m_run = -INFINITY, l_run = 0.f;
  // P.V: rows pr0 .. pr0 + RG - 1, columns 4 pc .. 4 pc + 3
  const bool pv = tid < PV_THREADS;
  const int pr0 = tid / C4 * RG, pc = tid % C4;
  float acc[RG][4];
#pragma unroll
  for (int r = 0; r < RG; ++r)
    acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;

#pragma unroll 1
  for (int tile = t0; tile < t1; ++tile) {
    const bool more = tile + 1 < t1;
    cp_async_wait<1>();  // Q and this K tile are in (this V may not be)
    __syncthreads();

    float s[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int g = ds; g < C4; g += DS) {
      float4 a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = ld4(q_s + (sy + SY * i) * QS + 4 * g);
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ld4(k_s + (sx + SX * j) * QS + 4 * g);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
        }
    }
#pragma unroll
    for (int off = DS / 2; off > 0; off >>= 1)
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          s[i][j] += __shfl_xor_sync(0xffffffffu, s[i][j], off);
    if (ds == 0) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          s_s[(sy + SY * i) * SS + sx + SX * j] = s[i][j];
    }
    __syncthreads();  // the scores are written, K is read
    if (more) load_k(tile + 1);

    {  // online softmax in base 2; P replaces S
      float* row = s_s + srow * SS;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < BN / TPR; ++j) mx = fmaxf(mx, row[spart + TPR * j]);
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run, mx * sl);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BN / TPR; ++j) {
        const float p = exp2f(row[spart + TPR * j] * sl - m_new);
        row[spart + TPR * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = exp2f(m_run - m_new);
      l_run = l_run * alpha + sum;
      m_run = m_new;
      if (spart == 0) alpha_s[srow] = alpha;
    }
    if (more)
      cp_async_wait<1>();  // this V tile is in (the next K may not be)
    else
      cp_async_wait<0>();
    __syncthreads();

    if (pv) {
#pragma unroll
      for (int r = 0; r < RG; ++r) {
        const float a = alpha_s[pr0 + r];
        acc[r][0] *= a;
        acc[r][1] *= a;
        acc[r][2] *= a;
        acc[r][3] *= a;
      }
#pragma unroll 2
      for (int j = 0; j < BN; j += 4) {
        float4 p[RG];
#pragma unroll
        for (int r = 0; r < RG; ++r) p[r] = ld4(s_s + (pr0 + r) * SS + j);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float4 vv = ld4(v_s + (j + jj) * D + 4 * pc);
#pragma unroll
          for (int r = 0; r < RG; ++r) {
            const float pj = jj == 0 ? p[r].x
                             : jj == 1 ? p[r].y
                             : jj == 2 ? p[r].z
                                       : p[r].w;
            acc[r][0] = fmaf(pj, vv.x, acc[r][0]);
            acc[r][1] = fmaf(pj, vv.y, acc[r][1]);
            acc[r][2] = fmaf(pj, vv.z, acc[r][2]);
            acc[r][3] = fmaf(pj, vv.w, acc[r][3]);
          }
        }
      }
    }
    __syncthreads();  // P and V are read
    if (more) load_v(tile + 1);
  }

  if (spart == 0) {
    l_s[srow] = l_run;
    m_s[srow] = m_run;
  }
  __syncthreads();
  if (pv) {
#pragma unroll
    for (int r = 0; r < RG; ++r) {
      const int row = row0 + pr0 + r;
      if (row >= nq) continue;
      float4 out;
      if (splits == 1) {
        const float l = l_s[pr0 + r];
        out = make_float4(acc[r][0] / l, acc[r][1] / l, acc[r][2] / l,
                          acc[r][3] / l);
        *reinterpret_cast<float4*>(o + ((size_t)bh * nq + row) * D + 4 * pc) =
            out;
      } else {
        out = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
        *reinterpret_cast<float4*>(
            part_o + (((size_t)split * n_bh + bh) * nq + row) * D + 4 * pc) =
            out;
      }
    }
  }
  if (tid < BM && row0 + tid < nq) {
    const size_t r = (size_t)bh * nq + row0 + tid;
    if (splits == 1) {
      if (lse != nullptr) lse[r] = (m_s[tid] + log2f(l_s[tid])) * LN2;
    } else {
      const size_t pr = (size_t)split * n_bh * nq + r;
      part_m[pr] = m_s[tid];
      part_l[pr] = l_s[tid];
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           void* part_o, void* part_m, void* part_l, int bh, int nq, int nk,
           int splits, int smem, float scale, cudaStream_t stream) {
  constexpr int BN = Tile<D>::BN, BM = Tile<D>::BM;
  if (nk % BN != 0 || smem != smem_bytes<D>()) return (int)cudaErrorInvalidValue;
  const int tiles = nk / BN, per = (tiles + splits - 1) / splits;
  if ((tiles + per - 1) / per != splits) return (int)cudaErrorInvalidValue;
  auto kern = flash_fwd_f32_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((nq + BM - 1) / BM, splits, bh);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), static_cast<float*>(part_o),
      static_cast<float*>(part_m), static_cast<float*>(part_l), nq, nk, per,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q/k/v: contiguous [bh, n, d] f32, 16-byte aligned, on the current device;
// d one of 40, 80, 512; nk a multiple of fgdm_flash_attn_f32_block_n(d);
// smem the dynamic shared memory of the tile (kernels/attention.py f32_tile;
// checked against this file's).  With splits == 1, o [bh, nq, d] f32 and lse
// ([bh, nq] f32 or null) are written; else (d = 512 only, every split
// non-empty) the partials part_o [splits, bh, nq, 512], part_m and part_l
// [splits, bh, nq] f32 for fgdm_flash_combine.  Returns 0 or a cudaError_t
// code (launch errors included).
int fgdm_flash_attn_fwd_f32(const void* q, const void* k, const void* v,
                            void* o, void* lse, void* part_o, void* part_m,
                            void* part_l, int bh, int nq, int nk, int d,
                            int splits, int smem, float scale, void* stream) {
  if (bh <= 0 || bh > 65535 || nq <= 0 || nk <= 0 || splits < 1 ||
      splits > 65535 || (splits > 1 && d != 512))
    return (int)cudaErrorInvalidValue;
  if (splits == 1 ? o == nullptr
                  : (part_o == nullptr || part_m == nullptr ||
                     part_l == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 40:
      return launch<40>(q, k, v, o, lse, part_o, part_m, part_l, bh, nq, nk,
                        splits, smem, scale, s);
    case 80:
      return launch<80>(q, k, v, o, lse, part_o, part_m, part_l, bh, nq, nk,
                        splits, smem, scale, s);
    case 512:
      return launch<512>(q, k, v, o, lse, part_o, part_m, part_l, bh, nq, nk,
                         splits, smem, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The keys a tile at head dim d (nk must be a multiple), 0 if the head dim
// is not instantiated.
int fgdm_flash_attn_f32_block_n(int d) {
  switch (d) {
    case 40:
      return Tile<40>::BN;
    case 80:
      return Tile<80>::BN;
    case 512:
      return Tile<512>::BN;
    default:
      return 0;
  }
}

const char* fgdm_cuda_error_string(int code) { return error_string(code); }

}  // extern "C"
