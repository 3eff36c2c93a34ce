// Flash-attention backward in float32 for Hopper (sm_90a): f32 in / f32 out
// at the UNet's head dims 40 and 80, IEEE float32 products on the CUDA
// cores.
//
// Replaces, in float32, the two Pallas TPU kernels of
// fgdm_tpu/kernels/attention.py, which the JAX package runs in float32
// wherever a float32 model is differentiated through a gated
// self-attention (float32 training):
//   _flash_bwd_dq_kernel_t  (:299, pallas_call :399)  dQ, per query block
//   _flash_bwd_dkv_kernel_t (:329, pallas_call :416)  dK, dV, per key block
// The bf16 kernels (flash_attn_bwd.cu) stay for bf16.  The math is theirs
// (Dao 2022, §B), from the forward's lse (natural log) and
// delta = rowsum(dO * O), both f32 [bh, nq]:
//   p  = exp(s * q k^T - lse)         dP = dO v^T
//   dS = p * (dP - delta)
//   dQ = s * dS k      dK = s * dS^T q      dV = p^T dO
// so no N x N matrix reaches device memory.
//
// What bounds them on the card.  Per score dQ does 6*d operations (S, dP,
// dS.K) and dK/dV 8*d (S^T, dP^T, P^T.dO, dS^T.Q), and each one exp.  No
// tensor core keeps float32's 24-bit products (TF32 keeps 11 bits), so the
// products run as FFMA, 67 TFLOP/s at most, and that bounds every shape the
// gate admits; bytes (~20*N*d per head) are far below.  The design is the
// float32 forward's (flash_attn_fwd_f32.cu), turned round for each kernel:
//
//   * dQ (flash_bwd_dq_f32_kernel): a block owns BQ query rows of one
//     (batch, head).  Q, dO and the rows' lse (times log2 e) and delta stay
//     in shared memory; K and V tiles of BK keys stream through two stages
//     by cp.async: tile t + 1 is copied in while the block computes tile t.
//   * dK/dV (flash_bwd_dkv_f32_kernel): a block owns BK key rows.  K and V
//     stay in shared memory; Q and dO tiles of BQ queries stream through two
//     stages by cp.async, and the next tile's lse and delta go through
//     registers into the other stage while the block computes this one.
//   * Scores: each thread computes a 4 x 4 block of S and of dP (or of S^T
//     and dP^T) from float4 reads of rows padded by 4 floats (the eight rows
//     a quarter-warp reads fall in different banks), 16 FMAs per 8 loads;
//     then p in base 2 (one FFMA of the score with scale * log2 e and the
//     row's lse * log2 e, one exp2) and dS in registers, written to a tile
//     in shared memory (P^T beside dS^T in dK/dV).
//   * Products: each thread owns RG rows x 4 columns of dQ (of dK and dV)
//     in registers and reads the dS (P^T, dS^T) rows and the K (dO, Q)
//     rows as float4.  dQ and dK are scaled once at the end.
//   * Two barriers a tile, no atomics and a fixed order of sums: every
//     output element is summed by one thread, so a rerun is bit-identical.
//   * Masking: the gate admits Nq != Nk and Nq % 64 != 0.  Query rows past
//     nq arrive as zeros (cp.async with 0 bytes) with lse +inf and delta 0,
//     so p = dS = 0 and they add nothing to dK/dV (JAX pads lse with +inf,
//     attention.py:395-397); the dQ kernel never writes them.  Nk is a
//     multiple of the key tile (the gate takes Nk % 512 == 0).
//
// Numerics follow the plain version (attention_bwd_ref: f32 scores, p from
// lse, f32 products), sums in another order.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace fgdm;

constexpr int THREADS = 256;
constexpr float LOG2E = 1.4426950408889634f;

// The tile of each head dim: BQ query rows and BK keys (a dQ block's rows
// and streamed key tile; a dK/dV block's rows are BK keys and its streamed
// tile BQ queries); the products as RG rows x 4 columns a thread.
template <int D>
struct Tile;
template <>
struct Tile<40> {
  static constexpr int BQ = 64, BK = 64, RG = 4;
};
template <>
struct Tile<80> {
  static constexpr int BQ = 64, BK = 64, RG = 8;
};

// Dynamic shared memory of the dQ kernel: Q and dO (rows of D + 4 floats),
// two stages of K and V, the dS tile (rows of BK + 4), lse and delta.
template <int D>
constexpr int dq_smem_bytes() {
  using T = Tile<D>;
  return 4 * (2 * T::BQ * (D + 4) + 4 * T::BK * (D + 4) +
              T::BQ * (T::BK + 4) + 2 * T::BQ);
}

// Of the dK/dV kernel: K and V, two stages of Q and dO, the P^T and dS^T
// tiles (rows of BQ + 4), two stages of lse and delta.
template <int D>
constexpr int dkv_smem_bytes() {
  using T = Tile<D>;
  return 4 * (2 * T::BK * (D + 4) + 4 * T::BQ * (D + 4) +
              2 * T::BK * (T::BQ + 4) + 4 * T::BQ);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Adds the 4 x 4 products of rows a_rows[i * SY] and b_rows[j * SX] (each a
// row of C4 float4s in shared memory, stride S floats) to acc.
template <int C4, int S, int SY, int SX>
__device__ __forceinline__ void scores4x4(float (&acc)[4][4],
                                          const float* a_rows,
                                          const float* b_rows) {
#pragma unroll 2
  for (int g = 0; g < C4; ++g) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = ld4(a_rows + SY * i * S + 4 * g);
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = ld4(b_rows + SX * j * S + 4 * g);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
        acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
        acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
        acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
      }
  }
}

__device__ __forceinline__ float lane(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ void fma4(float (&acc)[4], float a,
                                     const float4& b) {
  acc[0] = fmaf(a, b.x, acc[0]);
  acc[1] = fmaf(a, b.y, acc[1]);
  acc[2] = fmaf(a, b.z, acc[2]);
  acc[3] = fmaf(a, b.w, acc[3]);
}

// q/dout [bh, nq, D], k/v [bh, nk, D], lse/delta [bh, nq] f32 -> dq
// [bh, nq, D].  sl = scale * log2 e.
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, int nq, int nk, float sl,
                        float scale) {
  using T = Tile<D>;
  constexpr int BQ = T::BQ, BK = T::BK, RG = T::RG;
  constexpr int QS = D + 4, SS = BK + 4;  // row strides in floats
  constexpr int C4 = D / 4;               // float4 columns of a row
  constexpr int SY = BQ / 4, SX = BK / 4;
  constexpr int ACC_THREADS = BQ / RG * C4;
  static_assert(SY * SX == THREADS, "every thread computes scores");
  static_assert(ACC_THREADS <= THREADS && D % 4 == 0, "tile");

  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;
  float* do_s = q_s + BQ * QS;
  float* kv_s = do_s + BQ * QS;  // stage s: K at 2 s BK QS, V after it
  float* ds_s = kv_s + 4 * BK * QS;
  float* l_s = ds_s + BQ * SS;
  float* dl_s = l_s + BQ;

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int tiles = nk / BK;
  const float* kb = k + (size_t)bh * nk * D;
  const float* vb = v + (size_t)bh * nk * D;

  auto load_kv = [&](int tile, int stage) {
    float* ks = kv_s + stage * 2 * BK * QS;
    float* vs = ks + BK * QS;
    for (int i = tid; i < BK * C4; i += THREADS) {
      const int r = i / C4, c = i % C4;
      const size_t off = ((size_t)tile * BK + r) * D + 4 * c;
      cp_async16(smem_u32(ks + r * QS + 4 * c), kb + off, 16);
      cp_async16(smem_u32(vs + r * QS + 4 * c), vb + off, 16);
    }
    cp_async_commit();
  };

  // Q and dO, the rows past nq zero; they land with the first K/V tile
  const float* qb = q + (size_t)bh * nq * D;
  const float* dob = dout + (size_t)bh * nq * D;
  for (int i = tid; i < BQ * C4; i += THREADS) {
    const int r = i / C4, c = i % C4;
    const bool in = row0 + r < nq;
    const size_t off = (size_t)(in ? row0 + r : 0) * D + 4 * c;
    cp_async16(smem_u32(q_s + r * QS + 4 * c), qb + off, in ? 16 : 0);
    cp_async16(smem_u32(do_s + r * QS + 4 * c), dob + off, in ? 16 : 0);
  }
  load_kv(0, 0);
  if (tid < BQ) {
    const bool in = row0 + tid < nq;
    const size_t r = (size_t)bh * nq + (in ? row0 + tid : 0);
    l_s[tid] = in ? lse[r] * LOG2E : INFINITY;
    dl_s[tid] = in ? delta[r] : 0.f;
  }

  // scores (sy + SY i, sx + SX j); products: rows pr0 .. pr0 + RG - 1,
  // columns 4 pc .. 4 pc + 3
  const int sx = tid % SX, sy = tid / SX;
  const bool mine = tid < ACC_THREADS;
  const int pr0 = tid / C4 * RG, pc = tid % C4;
  float acc[RG][4];
#pragma unroll
  for (int r = 0; r < RG; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
  __syncthreads();  // lse and delta are written
  float l2[4], dl[4];  // of this thread's score rows
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    l2[i] = l_s[sy + SY * i];
    dl[i] = dl_s[sy + SY * i];
  }

#pragma unroll 1
  for (int tile = 0; tile < tiles; ++tile) {
    const int st = tile & 1;
    cp_async_wait<0>();  // this tile (and Q, dO) are in
    __syncthreads();     // ... for every thread; the last dS and K are read
    if (tile + 1 < tiles) load_kv(tile + 1, st ^ 1);
    const float* ks = kv_s + st * 2 * BK * QS;
    const float* vs = ks + BK * QS;

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    scores4x4<C4, QS, SY, SX>(s, q_s + sy * QS, ks + sx * QS);
    scores4x4<C4, QS, SY, SX>(dp, do_s + sy * QS, vs + sx * QS);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = exp2f(fmaf(s[i][j], sl, -l2[i]));
        ds_s[(sy + SY * i) * SS + sx + SX * j] = p * (dp[i][j] - dl[i]);
      }
    __syncthreads();  // dS is written

    if (mine) {  // dQ += dS K
#pragma unroll 2
      for (int j = 0; j < BK; j += 4) {
        float4 a[RG];
#pragma unroll
        for (int r = 0; r < RG; ++r) a[r] = ld4(ds_s + (pr0 + r) * SS + j);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float4 kk = ld4(ks + (j + jj) * QS + 4 * pc);
#pragma unroll
          for (int r = 0; r < RG; ++r) fma4(acc[r], lane(a[r], jj), kk);
        }
      }
    }
  }

  if (mine) {
#pragma unroll
    for (int r = 0; r < RG; ++r) {
      const int row = row0 + pr0 + r;
      if (row >= nq) continue;
      *reinterpret_cast<float4*>(dq + ((size_t)bh * nq + row) * D + 4 * pc) =
          make_float4(acc[r][0] * scale, acc[r][1] * scale,
                      acc[r][2] * scale, acc[r][3] * scale);
    }
  }
}

// The same arguments -> dk, dv [bh, nk, D].
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         int nq, int nk, float sl, float scale) {
  using T = Tile<D>;
  constexpr int BQ = T::BQ, BK = T::BK, RG = T::RG;
  constexpr int QS = D + 4, SS = BQ + 4;
  constexpr int C4 = D / 4;
  constexpr int SY = BK / 4, SX = BQ / 4;
  constexpr int ACC_THREADS = BK / RG * C4;
  static_assert(SY * SX == THREADS, "every thread computes scores");
  static_assert(ACC_THREADS <= THREADS && D % 4 == 0 && BQ <= THREADS,
                "tile");

  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;
  float* v_s = k_s + BK * QS;
  float* qd_s = v_s + BK * QS;  // stage s: Q at 2 s BQ QS, dO after it
  float* pt_s = qd_s + 4 * BQ * QS;
  float* dst_s = pt_s + BK * SS;
  float* l_s = dst_s + BK * SS;  // stage s: lse at 2 s BQ, delta after it

  const int tid = threadIdx.x;
  const int key0 = blockIdx.x * BK;
  const int bh = blockIdx.y;
  const int tiles = (nq + BQ - 1) / BQ;
  const float* qb = q + (size_t)bh * nq * D;
  const float* dob = dout + (size_t)bh * nq * D;
  const float* lb = lse + (size_t)bh * nq;
  const float* db = delta + (size_t)bh * nq;

  auto load_qdo = [&](int tile, int stage) {
    float* qs = qd_s + stage * 2 * BQ * QS;
    float* ds = qs + BQ * QS;
    for (int i = tid; i < BQ * C4; i += THREADS) {
      const int r = i / C4, c = i % C4;
      const int row = tile * BQ + r;
      const bool in = row < nq;
      const size_t off = (size_t)(in ? row : 0) * D + 4 * c;
      cp_async16(smem_u32(qs + r * QS + 4 * c), qb + off, in ? 16 : 0);
      cp_async16(smem_u32(ds + r * QS + 4 * c), dob + off, in ? 16 : 0);
    }
    cp_async_commit();
  };

  // K and V land with the first Q/dO tile
  for (int i = tid; i < BK * C4; i += THREADS) {
    const int r = i / C4, c = i % C4;
    const size_t off = ((size_t)bh * nk + key0 + r) * D + 4 * c;
    cp_async16(smem_u32(k_s + r * QS + 4 * c), k + off, 16);
    cp_async16(smem_u32(v_s + r * QS + 4 * c), v + off, 16);
  }
  load_qdo(0, 0);
  // a query row's lse (times log2 e) and delta: +inf and 0 past nq
  auto row_stats = [&](int tile, float& l, float& d) {
    const int row = tile * BQ + tid;
    const bool in = row < nq;
    l = in ? lb[row] * LOG2E : INFINITY;
    d = in ? db[row] : 0.f;
  };
  if (tid < BQ) row_stats(0, l_s[tid], l_s[BQ + tid]);

  const int sx = tid % SX, sy = tid / SX;
  const bool mine = tid < ACC_THREADS;
  const int pr0 = tid / C4 * RG, pc = tid % C4;
  float acc_k[RG][4], acc_v[RG][4];
#pragma unroll
  for (int r = 0; r < RG; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc_k[r][c] = acc_v[r][c] = 0.f;

#pragma unroll 1
  for (int tile = 0; tile < tiles; ++tile) {
    const int st = tile & 1;
    const bool more = tile + 1 < tiles;
    cp_async_wait<0>();  // this tile (and K, V) are in
    __syncthreads();     // ... for every thread; the last P^T, dS^T are read
    float next_l = 0.f, next_d = 0.f;
    if (more) {
      load_qdo(tile + 1, st ^ 1);
      if (tid < BQ) row_stats(tile + 1, next_l, next_d);
    }
    const float* qs = qd_s + st * 2 * BQ * QS;
    const float* dos = qs + BQ * QS;
    const float* ls = l_s + st * 2 * BQ;
    const float* dls = ls + BQ;

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    scores4x4<C4, QS, SY, SX>(s, k_s + sy * QS, qs + sx * QS);
    scores4x4<C4, QS, SY, SX>(dp, v_s + sy * QS, dos + sx * QS);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float l2 = ls[sx + SX * j], dl = dls[sx + SX * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = exp2f(fmaf(s[i][j], sl, -l2));
        const int at = (sy + SY * i) * SS + sx + SX * j;
        pt_s[at] = p;
        dst_s[at] = p * (dp[i][j] - dl);
      }
    }
    __syncthreads();  // P^T and dS^T are written

    if (mine) {  // dV += P^T dO, dK += dS^T Q
#pragma unroll 1
      for (int j = 0; j < BQ; j += 4) {
        float4 a[RG], b[RG];
#pragma unroll
        for (int r = 0; r < RG; ++r) {
          a[r] = ld4(pt_s + (pr0 + r) * SS + j);
          b[r] = ld4(dst_s + (pr0 + r) * SS + j);
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float4 dd = ld4(dos + (j + jj) * QS + 4 * pc);
          const float4 qq = ld4(qs + (j + jj) * QS + 4 * pc);
#pragma unroll
          for (int r = 0; r < RG; ++r) {
            fma4(acc_v[r], lane(a[r], jj), dd);
            fma4(acc_k[r], lane(b[r], jj), qq);
          }
        }
      }
    }
    if (more && tid < BQ) {  // the other stage was last read a tile ago
      l_s[(st ^ 1) * 2 * BQ + tid] = next_l;
      l_s[(st ^ 1) * 2 * BQ + BQ + tid] = next_d;
    }
  }

  if (mine) {
#pragma unroll
    for (int r = 0; r < RG; ++r) {
      const size_t at = ((size_t)bh * nk + key0 + pr0 + r) * D + 4 * pc;
      *reinterpret_cast<float4*>(dk + at) =
          make_float4(acc_k[r][0] * scale, acc_k[r][1] * scale,
                      acc_k[r][2] * scale, acc_k[r][3] * scale);
      *reinterpret_cast<float4*>(dv + at) =
          make_float4(acc_v[r][0], acc_v[r][1], acc_v[r][2], acc_v[r][3]);
    }
  }
}

template <typename K>
int prepare(K kern, int smem) {
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int bh, int nq,
              int nk, int smem, float scale, cudaStream_t stream) {
  using T = Tile<D>;
  if (nk % T::BK != 0 || smem != dq_smem_bytes<D>())
    return (int)cudaErrorInvalidValue;
  auto kern = flash_bwd_dq_f32_kernel<D>;
  const int err = prepare(kern, smem);
  if (err != 0) return err;
  const dim3 grid((nq + T::BQ - 1) / T::BQ, bh);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), nq, nk, scale * LOG2E, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int bh,
               int nq, int nk, int smem, float scale, cudaStream_t stream) {
  using T = Tile<D>;
  if (nk % T::BK != 0 || smem != dkv_smem_bytes<D>())
    return (int)cudaErrorInvalidValue;
  auto kern = flash_bwd_dkv_f32_kernel<D>;
  const int err = prepare(kern, smem);
  if (err != 0) return err;
  const dim3 grid(nk / T::BK, bh);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), nq, nk,
      scale * LOG2E, scale);
  return (int)cudaGetLastError();
}

bool bad_shape(int bh, int nq, int nk) {
  return bh <= 0 || bh > 65535 || nq <= 0 || nk <= 0;
}

}  // namespace

extern "C" {

// q/dout: contiguous [bh, nq, d] f32, k/v [bh, nk, d] f32, lse (natural
// log) and delta [bh, nq] f32, all on the current device, 16-byte aligned;
// d one of 40, 80; nk a multiple of fgdm_flash_attn_bwd_f32_block_n(d);
// smem the dynamic shared memory of the tile (kernels/attention.py
// bwd_f32_tile; checked against this file's).  Writes dq [bh, nq, d] f32.
// Returns 0 or a cudaError_t code (launch errors included).
int fgdm_flash_attn_bwd_f32_dq(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dq, int bh, int nq,
                               int nk, int d, int smem, float scale,
                               void* stream) {
  if (bad_shape(bh, nq, nk)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 40:
      return launch_dq<40>(q, k, v, dout, lse, delta, dq, bh, nq, nk, smem,
                           scale, s);
    case 80:
      return launch_dq<80>(q, k, v, dout, lse, delta, dq, bh, nq, nk, smem,
                           scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The same inputs; writes dk and dv [bh, nk, d] f32.
int fgdm_flash_attn_bwd_f32_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dk, void* dv, int bh,
                                int nq, int nk, int d, int smem, float scale,
                                void* stream) {
  if (bad_shape(bh, nq, nk)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 40:
      return launch_dkv<40>(q, k, v, dout, lse, delta, dk, dv, bh, nq, nk,
                            smem, scale, s);
    case 80:
      return launch_dkv<80>(q, k, v, dout, lse, delta, dk, dv, bh, nq, nk,
                            smem, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The keys a tile at head dim d (nk must be a multiple), 0 if the head dim
// is not instantiated.
int fgdm_flash_attn_bwd_f32_block_n(int d) {
  switch (d) {
    case 40:
      return Tile<40>::BK;
    case 80:
      return Tile<80>::BK;
    default:
      return 0;
  }
}

const char* fgdm_cuda_error_string(int code) { return error_string(code); }

}  // extern "C"
