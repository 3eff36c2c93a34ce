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
// (kernels/attention.py f32_kv_splits): a split block writes the same f32
// partials, and flash_attn_fwd_d512.cu's combine pass merges them.
//
// What bounds it on the card: 4*N^2*d operations on 16*N*d bytes.  No tensor
// core keeps float32's 24-bit products (TF32 keeps 11 bits, about three
// digits), so the products run as FFMA, 67 TFLOP/s at most, and that bounds
// every shape the gate admits (N >= 512).  Two kernels keep the FMA units
// fed from shared memory.
//
// flash_fwd_f32_kernel<D>, d = 40 and 80 (K1):
//
//   * A block owns BM query rows and walks the keys in tiles of BN (Tile<D>
//     below).  Q stays in shared memory; the next K tile is copied in by
//     cp.async while the block computes the softmax and P.V of this one,
//     the next V tile while it computes the next Q K^T.
//   * S = Q K^T: each thread computes a 4 x 4 block of scores from float4
//     reads of Q and K rows (rows padded by 4 floats, so the eight keys a
//     quarter-warp reads fall in different banks): 16 FMAs per 8 loads.
//   * The online softmax runs in base 2 (scores times scale * log2 e) on
//     the score tile in shared memory, TPR threads a row, row statistics by
//     shuffles; P overwrites S, and each row's rescale factor goes to
//     shared memory.
//   * O += P V: each thread owns RG rows x 4 columns of the f32 output in
//     registers, rescales them, then reads P rows and V rows as float4.
//   * The end divides by the row sum once and writes the output (and the
//     lse).
//
// flash_fwd_d512_f32_kernel, d = 512 (K2 and K3): at this width a K/V byte
// read for few query rows makes the block wait on L2 (16 rows a block read
// 8 bytes of K/V per FMA pair), so the design spends shared memory on rows:
//
//   * A block owns BM = 64 query rows, resident in shared memory
//     (64 x 512 f32, 129 KB), and walks its slice's keys in tiles of
//     BN = 128: each K/V byte serves 64 rows.
//   * K and V stream through one ring of three cp.async stages, 16 KB
//     each, two chunks ahead: per key tile 16 chunks of K (128 keys x 32 of
//     d) for the scores, then 16 chunks of V (8 keys x 512) for P.V.  One
//     barrier a chunk: the stage a load overwrites was read before it.
//   * S = Q K^T: each thread sums 8 rows x 4 keys over the whole of d in
//     registers (12 float4 reads per 128 FMAs; the 8 rows are the same
//     in a warp, so Q reads are broadcasts).  The scores go to shared
//     memory for the online softmax (base 2, 4 threads a row, as above).
//   * O += P V: each thread owns 8 rows x 16 columns of the f32 output
//     (128 registers), the columns 4 lane + 128 q so that a warp reads
//     512 contiguous bytes of a V row; P reads are broadcasts.  (Warps of
//     2 rows x 16 lanes, a third fewer shared-memory wavefronts, ran 3 %
//     slower: shared memory is not what bounds the block.)
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
// as TM x TN scores a thread; P.V as RG rows x 4 columns a thread.
template <int D>
struct Tile;
template <>
struct Tile<40> {
  static constexpr int BM = 64, BN = 64, TM = 4, TN = 4, RG = 4;
};
template <>
struct Tile<80> {
  static constexpr int BM = 64, BN = 64, TM = 4, TN = 4, RG = 8;
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
// null) are written.  sl = scale * log2 e.
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int nq, int nk, float sl) {
  using T = Tile<D>;
  constexpr int BM = T::BM, BN = T::BN, TM = T::TM, TN = T::TN, RG = T::RG;
  constexpr int QS = D + 4, SS = BN + 4;  // row strides in floats
  constexpr int C4 = D / 4;               // float4 columns of a row
  constexpr int SY = BM / TM, SX = BN / TN;
  constexpr int TPR = THREADS / BM;       // softmax threads of a row
  constexpr int PV_THREADS = BM / RG * C4;
  static_assert(SY * SX == THREADS, "every thread computes scores");
  static_assert(PV_THREADS <= THREADS && BN % TPR == 0, "tile");

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
  const int bh = blockIdx.y;
  const int tiles = nk / BN;
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
  load_k(0);
  load_v(0);

  // S: scores (sy + SY i, sx + SX j)
  const int sx = tid % SX, sy = tid / SX;
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
  for (int tile = 0; tile < tiles; ++tile) {
    const bool more = tile + 1 < tiles;
    cp_async_wait<1>();  // Q and this K tile are in (this V may not be)
    __syncthreads();

    float s[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int g = 0; g < C4; ++g) {
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
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j)
        s_s[(sy + SY * i) * SS + sx + SX * j] = s[i][j];
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
      const float l = l_s[pr0 + r];
      *reinterpret_cast<float4*>(o + ((size_t)bh * nq + row) * D + 4 * pc) =
          make_float4(acc[r][0] / l, acc[r][1] / l, acc[r][2] / l,
                      acc[r][3] / l);
    }
  }
  if (tid < BM && row0 + tid < nq && lse != nullptr)
    lse[(size_t)bh * nq + row0 + tid] = (m_s[tid] + log2f(l_s[tid])) * LN2;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int bh, int nq, int nk, int smem, float scale,
           cudaStream_t stream) {
  constexpr int BN = Tile<D>::BN, BM = Tile<D>::BM;
  if (nk % BN != 0 || smem != smem_bytes<D>()) return (int)cudaErrorInvalidValue;
  auto kern = flash_fwd_f32_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((nq + BM - 1) / BM, bh);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), nq, nk, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

// The d = 512 kernel's tile: BM query rows and BN keys a block, K chunks of
// DC columns of d, V chunks of VK keys, a ring of STAGES chunk buffers.
namespace d512 {
constexpr int D = 512, BM = 64, BN = 128, DC = 32, VK = 8, STAGES = 3;
constexpr int QS = D + 4;          // Q row stride (floats)
constexpr int KS = DC + 4;         // K chunk row stride
constexpr int SS = BN + 4;         // score row stride
constexpr int KCH = D / DC;        // K chunks a key tile
constexpr int CH = KCH + BN / VK;  // chunks a key tile: K's, then V's
constexpr int BUF = BN * KS;       // floats a ring stage
static_assert(BUF >= VK * D, "a V chunk fits a stage");
constexpr int SMEM = 4 * (BM * QS + BM * SS + STAGES * BUF + 3 * BM);
}  // namespace d512

// q [bh, nq, 512], k/v [bh, nk, 512] f32; outputs as flash_fwd_f32_kernel's
// (o and lse, or the partials of slice blockIdx.y).  blockIdx.x walks the
// 64-row tiles, blockIdx.z the heads.
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_d512_f32_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ o,
                          float* __restrict__ lse, float* __restrict__ part_o,
                          float* __restrict__ part_m,
                          float* __restrict__ part_l, int nq, int nk,
                          int tiles_per_split, float sl) {
  using namespace d512;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;
  float* s_s = q_s + BM * QS;
  float* ring = s_s + BM * SS;
  float* alpha_s = ring + STAGES * BUF;
  float* l_s = alpha_s + BM;
  float* m_s = l_s + BM;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int row0 = blockIdx.x * BM;
  const int split = blockIdx.y, splits = gridDim.y;
  const int bh = blockIdx.z, n_bh = gridDim.z;
  const int t0 = split * tiles_per_split;
  const int t1 = min(t0 + tiles_per_split, nk / BN);
  const int n_chunks = (t1 - t0) * CH;
  const float* kb = k + (size_t)bh * nk * D;
  const float* vb = v + (size_t)bh * nk * D;

  // chunk g of the block's stream into stage g % STAGES; past the end an
  // empty group, so that every wait below counts the same groups
  auto load = [&](int g) {
    if (g < n_chunks) {
      float* dst = ring + (g % STAGES) * BUF;
      const int tile = t0 + g / CH, c = g % CH;
      if (c < KCH) {
        const float* src = kb + (size_t)tile * BN * D + c * DC;
        for (int i = tid; i < BN * DC / 4; i += THREADS) {
          const int r = i / (DC / 4), c4 = i % (DC / 4);
          cp_async16(smem_u32(dst + r * KS + 4 * c4),
                     src + (size_t)r * D + 4 * c4, 16);
        }
      } else {
        const float* src = vb + ((size_t)tile * BN + (c - KCH) * VK) * D;
        for (int i = tid; i < VK * D / 4; i += THREADS)
          cp_async16(smem_u32(dst + 4 * i), src + 4 * i, 16);
      }
    }
    cp_async_commit();
  };

  // Q, with the rows past nq zero (computed, never stored)
  const float* qb = q + (size_t)bh * nq * D;
  for (int i = tid; i < BM * D / 4; i += THREADS) {
    const int r = i / (D / 4), c4 = i % (D / 4);
    const bool in = row0 + r < nq;
    cp_async16(smem_u32(q_s + r * QS + 4 * c4),
               qb + (size_t)(in ? row0 + r : 0) * D + 4 * c4, in ? 16 : 0);
  }
  cp_async_commit();
  load(0);
  load(1);

  // S: rows warp + 8 i, keys lane + 32 j; softmax: row srow, keys
  // spart + 4 j (m_run/l_run the same in the row's 4 threads); P.V: rows
  // 8 warp + r, columns 4 lane + 128 q + e
  const int srow = tid / 4, spart = tid % 4;
  float m_run = -INFINITY, l_run = 0.f;
  float sacc[8][4];
  float oacc[8][16];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int e = 0; e < 16; ++e) oacc[r][e] = 0.f;

#pragma unroll 1
  for (int g = 0; g < n_chunks; ++g) {
    cp_async_wait<1>();  // Q and chunk g are in (g + 1 may not be)
    __syncthreads();     // and every thread is done with chunk g - 1
    load(g + 2);
    const float* buf = ring + (g % STAGES) * BUF;
    const int c = g % CH;
    if (c < KCH) {
      if (c == 0) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sacc[i][j] = 0.f;
      }
      const float* qc = q_s + warp * QS + c * DC;
#pragma unroll 2
      for (int g4 = 0; g4 < DC / 4; ++g4) {
        float4 b[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          b[j] = ld4(buf + (lane + 32 * j) * KS + 4 * g4);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float4 a = ld4(qc + 8 * i * QS + 4 * g4);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            sacc[i][j] = fmaf(a.x, b[j].x, sacc[i][j]);
            sacc[i][j] = fmaf(a.y, b[j].y, sacc[i][j]);
            sacc[i][j] = fmaf(a.z, b[j].z, sacc[i][j]);
            sacc[i][j] = fmaf(a.w, b[j].w, sacc[i][j]);
          }
        }
      }
      if (c == KCH - 1) {  // the tile's scores are whole: softmax
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            s_s[(warp + 8 * i) * SS + lane + 32 * j] = sacc[i][j];
        __syncthreads();
        float* row = s_s + srow * SS;
        float mx = -INFINITY;
#pragma unroll 8
        for (int j = 0; j < BN / 4; ++j) mx = fmaxf(mx, row[spart + 4 * j]);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_run, mx * sl);
        float sum = 0.f;
#pragma unroll 8
        for (int j = 0; j < BN / 4; ++j) {
          const float p = exp2f(row[spart + 4 * j] * sl - m_new);
          row[spart + 4 * j] = p;
          sum += p;
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        const float alpha = exp2f(m_run - m_new);
        l_run = l_run * alpha + sum;
        m_run = m_new;
        if (spart == 0) alpha_s[srow] = alpha;
        __syncthreads();  // P and the rescale factors are written
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const float a = alpha_s[8 * warp + r];
#pragma unroll
          for (int e = 0; e < 16; ++e) oacc[r][e] *= a;
        }
      }
    } else {
      const float* pr = s_s + 8 * warp * SS + (c - KCH) * VK;
#pragma unroll
      for (int jj = 0; jj < VK; jj += 4) {
        float4 p[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) p[r] = ld4(pr + r * SS + jj);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float4 vv[4];
#pragma unroll
          for (int qq = 0; qq < 4; ++qq)
            vv[qq] = ld4(buf + (jj + e) * D + 4 * lane + 128 * qq);
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            const float pe = e == 0 ? p[r].x
                             : e == 1 ? p[r].y
                             : e == 2 ? p[r].z
                                      : p[r].w;
#pragma unroll
            for (int qq = 0; qq < 4; ++qq) {
              oacc[r][4 * qq] = fmaf(pe, vv[qq].x, oacc[r][4 * qq]);
              oacc[r][4 * qq + 1] = fmaf(pe, vv[qq].y, oacc[r][4 * qq + 1]);
              oacc[r][4 * qq + 2] = fmaf(pe, vv[qq].z, oacc[r][4 * qq + 2]);
              oacc[r][4 * qq + 3] = fmaf(pe, vv[qq].w, oacc[r][4 * qq + 3]);
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();  // the empty trailing groups

  if (spart == 0) {
    l_s[srow] = l_run;
    m_s[srow] = m_run;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int rl = 8 * warp + r, row = row0 + rl;
    if (row >= nq) continue;
    const float l = l_s[rl];
#pragma unroll
    for (int qq = 0; qq < 4; ++qq) {
      float4 a = make_float4(oacc[r][4 * qq], oacc[r][4 * qq + 1],
                             oacc[r][4 * qq + 2], oacc[r][4 * qq + 3]);
      float* dst = part_o + (((size_t)split * n_bh + bh) * nq + row) * D;
      if (splits == 1) {
        a = make_float4(a.x / l, a.y / l, a.z / l, a.w / l);
        dst = o + ((size_t)bh * nq + row) * D;
      }
      *reinterpret_cast<float4*>(dst + 4 * lane + 128 * qq) = a;
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

int launch_d512(const void* q, const void* k, const void* v, void* o,
                void* lse, void* part_o, void* part_m, void* part_l, int bh,
                int nq, int nk, int splits, int smem, float scale,
                cudaStream_t stream) {
  using namespace d512;
  if (nk % BN != 0 || smem != SMEM) return (int)cudaErrorInvalidValue;
  const int tiles = nk / BN, per = (tiles + splits - 1) / splits;
  if ((tiles + per - 1) / per != splits) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_d512_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((nq + BM - 1) / BM, splits, bh);
  flash_fwd_d512_f32_kernel<<<grid, THREADS, smem, stream>>>(
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
// checked against this file's: Tile<D> at d = 40 and 80, d512:: at 512).
// With splits == 1, o [bh, nq, d] f32 and lse ([bh, nq] f32 or null) are
// written; else (d = 512 only, every split non-empty) the partials part_o
// [splits, bh, nq, 512], part_m and part_l [splits, bh, nq] f32 for
// fgdm_flash_combine.  Returns 0 or a cudaError_t code (launch errors
// included).
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
      return launch<40>(q, k, v, o, lse, bh, nq, nk, smem, scale, s);
    case 80:
      return launch<80>(q, k, v, o, lse, bh, nq, nk, smem, scale, s);
    case 512:
      return launch_d512(q, k, v, o, lse, part_o, part_m, part_l, bh, nq, nk,
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
      return d512::BN;
    default:
      return 0;
  }
}

const char* fgdm_cuda_error_string(int code) { return error_string(code); }

}  // extern "C"
