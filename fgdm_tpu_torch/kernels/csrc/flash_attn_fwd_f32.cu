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
// flash_fwd_f32_kernel<D, BN, WARPS, STAGES>, d = 40 and 80 (K1).  Every
// warp owns 16 query rows and runs both products on them; the warps share
// only the K/V tiles:
//
//   * A block of WARPS warps owns BM = 16 WARPS query rows (Q in shared
//     memory) and walks the keys in tiles of BN.  K and V stream through a
//     ring of STAGES cp.async tiles: tile t + STAGES - 1 is copied in while
//     the block computes tile t, so the copy overlaps whole tiles.  One
//     block barrier a tile (the stage a copy overwrites was read before it).
//   * S = Q K^T in registers: lane 8 rg + kl of a warp scores its rows
//     rg + 4 i (i < 4) against the keys kl + 8 j (j < BN / 8) from float4
//     reads (Q and K rows padded by 4 floats: each read is one wavefront):
//     4 x 8 scores, 128 FMAs per 12 reads at BN = 64.
//   * The online softmax runs in base 2 on those registers: row maxima by
//     three shuffles among the 8 lanes of a row; each lane keeps its own
//     part of the row sums, added up once at the end.
//   * P crosses shared memory once, into the warp's own 16 x (BN + 8)
//     tile, behind a warp barrier (no block barrier).
//   * O += P V: the 8 lanes of a row group split d into LD lanes of ten
//     columns (float2 reads of V rows, 2 (dl + LD e)) and the keys into
//     8 / LD partitions (at d = 40 two: even and odd keys), so every lane
//     sums 4 rows x 10 columns, 40 FMAs per 5 float2 reads and a float4 of
//     P per 4 keys.  The partitions' sums are added once at the end.
//   * The end adds the lanes' row sums and the partitions' outputs by
//     shuffles in a fixed order, divides by the row sum once and writes the
//     output (and the lse).  No atomics: reruns are bit-identical.
//
// The tiles (BM, BN, STAGES) the sweep times are instantiated below
// (FGDM_K1_F32); kernels/attention.py flash_f32_plan picks one.
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
//     memory for the online softmax (base 2, 4 threads a row, shuffles).
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

constexpr int THREADS = 256;  // the d = 512 kernel's
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float lane4(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// P.V's split of a row group's 8 lanes: LD lanes across d (ten columns
// each), 8 / LD partitions of the keys.
template <int D>
struct PvSplit;
template <>
struct PvSplit<40> {
  static constexpr int LD = 4;
};
template <>
struct PvSplit<80> {
  static constexpr int LD = 8;
};

// Dynamic shared memory of a K1 tile: Q, the K/V ring (rows of D + 4
// floats) and each warp's P tile (16 rows of BN + 8).
template <int D, int BN, int WARPS, int STAGES>
constexpr int smem_bytes() {
  return 4 * (16 * WARPS * (D + 4) + STAGES * 2 * BN * (D + 4) +
              16 * WARPS * (BN + 8));
}

// q [bh, nq, D], k/v [bh, nk, D] f32.  o [bh, nq, D] and lse [bh, nq] (or
// null) are written.  sl = scale * log2 e.
template <int D, int BN, int WARPS, int STAGES>
__global__ void __launch_bounds__(32 * WARPS)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int nq, int nk, float sl) {
  constexpr int NT = 32 * WARPS, BM = 16 * WARPS;
  constexpr int QS = D + 4;          // Q, K and V row stride (floats)
  constexpr int PS = BN + 8;         // P row stride
  constexpr int TN = BN / 8;         // keys a lane scores
  constexpr int C4 = D / 4;          // float4 columns of a row
  constexpr int LD = PvSplit<D>::LD, KP = 8 / LD;
  constexpr int PW = BN / KP + 4;    // a key partition's span in a P row
  constexpr int E = D / (2 * LD);    // float2 columns a lane sums
  constexpr int TILE = BN * QS;      // floats of a K or V tile
  static_assert(E == 5 && BN % 32 == 0 && KP * PW <= PS, "tile");

  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;
  float* ring = q_s + BM * QS;  // stage s: K at 2 s TILE, V after it
  float* p_s = ring + STAGES * 2 * TILE;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = lane >> 3, kl = lane & 7;
  const int dl = kl / KP, kp = kl % KP;
  const int row0 = blockIdx.x * BM;
  const int bh = blockIdx.y;
  const int tiles = nk / BN;
  const float* kb = k + (size_t)bh * nk * D;
  const float* vb = v + (size_t)bh * nk * D;

  // tile t into stage t % STAGES; past the end an empty group, so that
  // every wait below counts the same groups
  auto load_kv = [&](int t) {
    if (t < tiles) {
      float* ks = ring + (t % STAGES) * 2 * TILE;
      for (int i = tid; i < BN * C4; i += NT) {
        const int r = i / C4, c = i % C4;
        const size_t off = ((size_t)t * BN + r) * D + 4 * c;
        cp_async16(smem_u32(ks + r * QS + 4 * c), kb + off, 16);
        cp_async16(smem_u32(ks + TILE + r * QS + 4 * c), vb + off, 16);
      }
    }
    cp_async_commit();
  };

  // Q, with the rows past nq zero (computed, never stored); it lands with
  // the first K/V tile
  const float* qb = q + (size_t)bh * nq * D;
  for (int i = tid; i < BM * C4; i += NT) {
    const int r = i / C4, c = i % C4;
    const bool in = row0 + r < nq;
    cp_async16(smem_u32(q_s + r * QS + 4 * c),
               qb + (size_t)(in ? row0 + r : 0) * D + 4 * c, in ? 16 : 0);
  }
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) load_kv(t);

  // this lane's rows rg + 4 i of the warp's 16: in Q, and in its P tile
  const float* qw = q_s + (16 * warp + rg) * QS;
  float* pw = p_s + (16 * warp + rg) * PS;
  float m_run[4], l_run[4], acc[4][E][2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[i][e][0] = acc[i][e][1] = 0.f;
  }

#pragma unroll 1
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<STAGES - 2>();  // Q and tile t are in
    __syncthreads();              // ... for every thread; tile t - 1 is read
    load_kv(t + STAGES - 1);
    const float* ks = ring + (t % STAGES) * 2 * TILE;
    const float* vs = ks + TILE;

    float s[4][TN];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int g = 0; g < C4; ++g) {
      float4 a[4], b[TN];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = ld4(qw + 4 * i * QS + 4 * g);
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ld4(ks + (kl + 8 * j) * QS + 4 * g);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
        }
    }

    // online softmax in base 2; P into the warp's tile, key kl + 8 j at
    // its partition's span
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = s[i][0];
#pragma unroll
      for (int j = 1; j < TN; ++j) mx = fmaxf(mx, s[i][j]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m_run[i], mx * sl);
      const float alpha = exp2f(m_run[i] - m_new);
      m_run[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float p = exp2f(fmaf(s[i][j], sl, -m_new));
        sum += p;
        pw[4 * i * PS + (kl % KP) * PW + kl / KP + 8 / KP * j] = p;
      }
      l_run[i] = l_run[i] * alpha + sum;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        acc[i][e][0] *= alpha;
        acc[i][e][1] *= alpha;
      }
    }
    __syncwarp();  // the warp's P is written

    // O += P V over this lane's key partition: keys KP (4 u + c) + kp
#pragma unroll 2
    for (int u = 0; u < BN / KP / 4; ++u) {
      float4 p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ld4(pw + 4 * i * PS + kp * PW + 4 * u);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float* vr = vs + (KP * (4 * u + c) + kp) * QS + 2 * dl;
        float2 vv[E];
#pragma unroll
        for (int e = 0; e < E; ++e) vv[e] = ld2(vr + 2 * LD * e);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pc = lane4(p[i], c);
#pragma unroll
          for (int e = 0; e < E; ++e) {
            acc[i][e][0] = fmaf(pc, vv[e].x, acc[i][e][0]);
            acc[i][e][1] = fmaf(pc, vv[e].y, acc[i][e][1]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();  // the empty trailing groups

  // the row sums over the row's 8 lanes, the partitions' outputs; then the
  // lanes of partition i % KP write row i
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 4);
    if (KP == 2) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        acc[i][e][0] += __shfl_xor_sync(0xffffffffu, acc[i][e][0], 1);
        acc[i][e][1] += __shfl_xor_sync(0xffffffffu, acc[i][e][1], 1);
      }
    }
    const int row = row0 + 16 * warp + rg + 4 * i;
    if (row >= nq) continue;
    if (i % KP == kp) {
      float* orow = o + ((size_t)bh * nq + row) * D + 2 * dl;
#pragma unroll
      for (int e = 0; e < E; ++e)
        *reinterpret_cast<float2*>(orow + 2 * LD * e) =
            make_float2(acc[i][e][0] / l_run[i], acc[i][e][1] / l_run[i]);
    }
    if (kl == 0 && lse != nullptr)
      lse[(size_t)bh * nq + row] = (m_run[i] + log2f(l_run[i])) * LN2;
  }
}

template <int D, int BN, int WARPS, int STAGES>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int bh, int nq, int nk, int smem, float scale,
           cudaStream_t stream) {
  if (nk % BN != 0 || smem != smem_bytes<D, BN, WARPS, STAGES>())
    return (int)cudaErrorInvalidValue;
  auto kern = flash_fwd_f32_kernel<D, BN, WARPS, STAGES>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((nq + 16 * WARPS - 1) / (16 * WARPS), bh);
  kern<<<grid, 32 * WARPS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), nq, nk, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

// Blocks of a K1 tile resident on an SM at once, into *out.
template <int D, int BN, int WARPS, int STAGES>
int resident(int smem, int* out) {
  auto kern = flash_fwd_f32_kernel<D, BN, WARPS, STAGES>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, kern, 32 * WARPS, (size_t)smem);
}

// The K1 tiles: (query rows, keys, ring stages) a block at each head dim.
#define FGDM_K1_F32_TILES(X) \
  X(64, 64, 2)               \
  X(64, 64, 3)               \
  X(128, 64, 2)              \
  X(128, 64, 3)              \
  X(64, 32, 2)               \
  X(64, 32, 3)               \
  X(128, 32, 2)              \
  X(128, 32, 3)

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
// the tile bm x bn x stages and its dynamic shared memory smem
// (kernels/attention.py f32_tile; checked against this file's: one of
// FGDM_K1_F32_TILES at d = 40 and 80, d512:: at 512).  With splits == 1,
// o [bh, nq, d] f32 and lse ([bh, nq] f32 or null) are written; else
// (d = 512 only, every split non-empty) the partials part_o
// [splits, bh, nq, 512], part_m and part_l [splits, bh, nq] f32 for
// fgdm_flash_combine.  Returns 0 or a cudaError_t code (launch errors
// included).
int fgdm_flash_attn_fwd_f32(const void* q, const void* k, const void* v,
                            void* o, void* lse, void* part_o, void* part_m,
                            void* part_l, int bh, int nq, int nk, int d,
                            int bm, int bn, int stages, int splits, int smem,
                            float scale, void* stream) {
  if (bh <= 0 || bh > 65535 || nq <= 0 || nk <= 0 || splits < 1 ||
      splits > 65535 || (splits > 1 && d != 512))
    return (int)cudaErrorInvalidValue;
  if (splits == 1 ? o == nullptr
                  : (part_o == nullptr || part_m == nullptr ||
                     part_l == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 512) {
    if (bm != d512::BM || bn != d512::BN || stages != d512::STAGES)
      return (int)cudaErrorInvalidValue;
    return launch_d512(q, k, v, o, lse, part_o, part_m, part_l, bh, nq, nk,
                       splits, smem, scale, s);
  }
#define FGDM_K1_F32(BM, BN, STAGES)                                    \
  if (bm == BM && bn == BN && stages == STAGES) {                      \
    if (d == 40)                                                       \
      return launch<40, BN, BM / 16, STAGES>(q, k, v, o, lse, bh, nq,  \
                                             nk, smem, scale, s);      \
    if (d == 80)                                                       \
      return launch<80, BN, BM / 16, STAGES>(q, k, v, o, lse, bh, nq,  \
                                             nk, smem, scale, s);      \
  }
  FGDM_K1_F32_TILES(FGDM_K1_F32)
#undef FGDM_K1_F32
  return (int)cudaErrorInvalidValue;
}

// Blocks of the d = 40/80 tile bm x bn x stages (smem as above) resident on
// an SM at once, into *out.  Returns 0 or a cudaError_t code.
int fgdm_flash_attn_f32_resident(int d, int bm, int bn, int stages, int smem,
                                 int* out) {
  if (out == nullptr) return (int)cudaErrorInvalidValue;
#define FGDM_K1_F32(BM, BN, STAGES)                                    \
  if (bm == BM && bn == BN && stages == STAGES &&                      \
      smem == (d == 40 ? smem_bytes<40, BN, BM / 16, STAGES>()         \
                       : smem_bytes<80, BN, BM / 16, STAGES>())) {     \
    if (d == 40) return resident<40, BN, BM / 16, STAGES>(smem, out);  \
    if (d == 80) return resident<80, BN, BM / 16, STAGES>(smem, out);  \
  }
  FGDM_K1_F32_TILES(FGDM_K1_F32)
#undef FGDM_K1_F32
  return (int)cudaErrorInvalidValue;
}

// The keys every tile at head dim d divides (nk must be a multiple), 0 if
// the head dim is not instantiated.
int fgdm_flash_attn_f32_block_n(int d) {
  switch (d) {
    case 40:
    case 80:
      return 64;
    case 512:
      return d512::BN;
    default:
      return 0;
  }
}

const char* fgdm_cuda_error_string(int code) { return error_string(code); }

}  // extern "C"
