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
// gate admits; bytes (~20*N*d per head) are far below.  Both kernels are
// the float32 forward's K1 design (flash_attn_fwd_f32.cu): every warp owns
// 16 rows and runs every product on them, the warps share only the
// streamed tiles, and what one product hands the next crosses shared
// memory once, in the warp's own tile:
//
//   * dQ (flash_bwd_dq_f32_kernel<D, BN, WARPS, STAGES>): the forward with
//     a second score product (dP = dO V^T) and K in V's place in the last.
//     A block of WARPS warps owns BM = 16 WARPS query rows of one (batch,
//     head): Q and dO stay in shared memory (rows padded by 4 floats), and
//     each lane keeps its rows' lse (times log2 e) and delta in registers.
//     K and V tiles of BN keys stream through a ring of STAGES cp.async
//     tiles: tile t + STAGES - 1 is copied in while the block computes
//     tile t.  One block barrier a tile.  Lane 8 rg + kl of a warp scores
//     its rows rg + 4 i (i < 4) against the keys kl + 8 j (j < BN / 8): S
//     and dP in registers from float4 reads (one wavefront each), then
//     p = exp2(s * scale * log2 e - lse * log2 e) (one FFMA, one exp2) and
//     dS = p (dP - delta).  dS crosses shared memory once, into the warp's
//     own 16 x (BN + 8) tile, behind a warp barrier.  dQ += dS K: the 8
//     lanes of a row group split d into LD lanes of ten columns (float2
//     reads of K rows) and the keys into 8 / LD partitions (at d = 40 even
//     and odd keys), so every lane sums 4 rows x 10 columns, 40 FMAs per 5
//     float2 reads and a float4 of dS per 4 keys; the partitions' sums are
//     added by one shuffle at the end.  The tiles (BM, BN, STAGES) the
//     sweep times are instantiated below (FGDM_K5_F32).
//   * dK/dV (flash_bwd_dkv_f32_kernel<D, BQ, WARPS, STAGES>): the same
//     design turned round.  A block of WARPS warps owns BK = 16 WARPS key
//     rows (K and V in shared memory), each warp 16 of them; Q and dO tiles
//     of BQ queries stream through a ring of STAGES cp.async tiles, and
//     each tile's lse (times log2 e) and delta go through registers into
//     their stage a tile ahead.  One block barrier a tile.  Lane 8 rg + kl
//     of a warp scores its key rows rg + 4 i (i < 4) against the queries
//     kl + 8 j (j < BQ / 8): S^T and dP^T in registers from float4 reads,
//     then p and dS^T.  P^T and dS^T cross shared memory once, into the
//     warp's own tiles, behind a warp barrier; the products read them as
//     float4s that serve the LD lanes of a row group at once.  dV += P^T dO
//     and dK += dS^T Q: the 8 lanes of a row group split d into LD lanes of
//     ten columns (float2 reads of dO and Q rows) and the queries into
//     8 / LD partitions (at d = 40 even and odd queries), so every lane
//     sums 4 key rows x 10 columns of dK and of dV (80 FMAs per 10 float2
//     reads); the partitions' sums are added by one shuffle at the end.
//     The tiles (BK, BQ, STAGES) the sweep times are instantiated below
//     (FGDM_K6_F32).
//   * kernels/attention.py flash_bwd_f32_plan picks each kernel's tile.
//   * dQ and dK are scaled once at the end; no atomics and a fixed order
//     of sums: a rerun is bit-identical.
//   * Masking: the gate admits Nq != Nk and Nq % 64 != 0.  Query rows past
//     nq arrive as zeros (cp.async with 0 bytes) with lse +inf and delta 0,
//     so p = dS = 0 and they add nothing to dK/dV (JAX pads lse with +inf,
//     attention.py:395-397); the dQ kernel never writes them.  Nk is a
//     multiple of each kernel's key tile (the gate takes Nk % 512 == 0).
//
// Numerics follow the plain version (attention_bwd_ref: f32 scores, p from
// lse, f32 products), sums in another order.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace fgdm;

constexpr float LOG2E = 1.4426950408889634f;
constexpr int MAX_SMEM = 232448;  // dynamic shared memory a block may use

// Dynamic shared memory of the dQ kernel: Q and dO (rows of D + 4 floats),
// STAGES of K and V (the same rows), each warp's dS tile (16 rows of
// BN + 8).
template <int D, int BN, int WARPS, int STAGES>
constexpr int dq_smem_bytes() {
  return 4 * (2 * 16 * WARPS * (D + 4) + STAGES * 2 * BN * (D + 4) +
              16 * WARPS * (BN + 8));
}

// Of the dK/dV kernel: K and V (rows of D + 4 floats), STAGES of Q, dO
// (the same rows), lse and delta, each warp's P^T and dS^T tiles (16 rows
// of BQ + 8).
template <int D, int BQ, int WARPS, int STAGES>
constexpr int dkv_smem_bytes() {
  return 4 * (2 * 16 * WARPS * (D + 4) + STAGES * (2 * BQ * (D + 4) + 2 * BQ) +
              2 * 16 * WARPS * (BQ + 8));
}

// Both kernels' split of a row group's 8 lanes in the last products: LD
// lanes across d (ten columns each), 8 / LD partitions of the streamed
// rows (keys for dQ, queries for dK/dV).
template <int D>
struct DSplit;
template <>
struct DSplit<40> {
  static constexpr int LD = 4;
};
template <>
struct DSplit<80> {
  static constexpr int LD = 8;
};

// Keys every tile the host plans divides (K5's BN, K6's BK): nk must be a
// multiple (kernels/attention.py _K5_F32_PLAN, _K6_F32_PLAN).
constexpr int KEY_MULTIPLE = 64;

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float lane(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ void dot4(float& acc, const float4& a,
                                     const float4& b) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  acc = fmaf(a.w, b.w, acc);
}

// q/dout [bh, nq, D], k/v [bh, nk, D], lse/delta [bh, nq] f32 -> dq
// [bh, nq, D]: K5 at the tile WARPS x 16 query rows, BN streamed keys, a
// ring of STAGES.  sl = scale * log2 e.
template <int D, int BN, int WARPS, int STAGES>
__global__ void __launch_bounds__(32 * WARPS)
flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, int nq, int nk, float sl,
                        float scale) {
  constexpr int NT = 32 * WARPS, BM = 16 * WARPS;
  constexpr int QS = D + 4;          // Q, dO, K and V row stride (floats)
  constexpr int PS = BN + 8;         // dS row stride
  constexpr int TN = BN / 8;         // keys a lane scores
  constexpr int C4 = D / 4;
  constexpr int LD = DSplit<D>::LD, KP = 8 / LD;
  constexpr int PW = BN / KP + 4;    // a key partition's span in a dS row
  constexpr int E = D / (2 * LD);    // float2 columns a lane sums
  constexpr int TILE = BN * QS;      // floats of a K or V tile
  static_assert(E == 5 && BN % 32 == 0 && KP * PW <= PS, "tile");

  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;
  float* do_s = q_s + BM * QS;
  float* ring = do_s + BM * QS;  // stage s: K at 2 s TILE, V after it
  float* ds_s = ring + STAGES * 2 * TILE;

  const int tid = threadIdx.x, warp = tid >> 5;
  const int rg = (tid & 31) >> 3, kl = tid & 7;
  const int dl = kl / KP, kp = kl % KP;
  const int row0 = blockIdx.x * BM;
  const int bh = blockIdx.y;
  const int tiles = nk / BN;
  const float* kb = k + (size_t)bh * nk * D;
  const float* vb = v + (size_t)bh * nk * D;

  // K/V tile t into stage t % STAGES; past the end an empty group, so that
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

  // Q and dO, the rows past nq zero; they land with the first K/V tile
  const float* qb = q + (size_t)bh * nq * D;
  const float* dob = dout + (size_t)bh * nq * D;
  for (int i = tid; i < BM * C4; i += NT) {
    const int r = i / C4, c = i % C4;
    const bool in = row0 + r < nq;
    const size_t off = (size_t)(in ? row0 + r : 0) * D + 4 * c;
    cp_async16(smem_u32(q_s + r * QS + 4 * c), qb + off, in ? 16 : 0);
    cp_async16(smem_u32(do_s + r * QS + 4 * c), dob + off, in ? 16 : 0);
  }
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) load_kv(t);

  // this lane's rows rg + 4 i of the warp's 16: in Q, dO and its dS tile;
  // their lse (times log2 e) and delta, +inf and 0 past nq so that their
  // p and dS are 0
  const int wrow = 16 * warp + rg;
  const float* qw = q_s + wrow * QS;
  const float* dow = do_s + wrow * QS;
  float* dsw = ds_s + wrow * PS;
  float l2[4], dlt[4], acc[4][E][2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + wrow + 4 * i;
    const bool in = row < nq;
    const size_t r = (size_t)bh * nq + (in ? row : 0);
    l2[i] = in ? lse[r] * LOG2E : INFINITY;
    dlt[i] = in ? delta[r] : 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[i][e][0] = acc[i][e][1] = 0.f;
  }

#pragma unroll 1
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<STAGES - 2>();  // Q, dO and tile t are in
    __syncthreads();              // ... for every thread; tile t - 1 is read
    load_kv(t + STAGES - 1);
    const float* ks = ring + (t % STAGES) * 2 * TILE;
    const float* vs = ks + TILE;

    // S = Q K^T and dP = dO V^T: rows rg + 4 i, keys kl + 8 j
    float s[4][TN], dp[4][TN];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) s[i][j] = dp[i][j] = 0.f;
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
        for (int j = 0; j < TN; ++j) dot4(s[i][j], a[i], b[j]);
    }
#pragma unroll 2
    for (int g = 0; g < C4; ++g) {
      float4 a[4], b[TN];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = ld4(dow + 4 * i * QS + 4 * g);
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ld4(vs + (kl + 8 * j) * QS + 4 * g);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) dot4(dp[i][j], a[i], b[j]);
    }
    // p and dS in base 2, into the warp's tile at key kl + 8 j's partition
    // span
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int at = kp * PW + kl / KP + 8 / KP * j;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = exp2f(fmaf(s[i][j], sl, -l2[i]));
        dsw[4 * i * PS + at] = p * (dp[i][j] - dlt[i]);
      }
    }
    __syncwarp();  // the warp's dS is written

    // dQ += dS K over this lane's key partition: keys KP (4 u + c) + kp
#pragma unroll 2
    for (int u = 0; u < BN / KP / 4; ++u) {
      float4 ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ds[i] = ld4(dsw + 4 * i * PS + kp * PW + 4 * u);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float* kr = ks + (KP * (4 * u + c) + kp) * QS + 2 * dl;
        float2 kk[E];
#pragma unroll
        for (int e = 0; e < E; ++e) kk[e] = ld2(kr + 2 * LD * e);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float dc = lane(ds[i], c);
#pragma unroll
          for (int e = 0; e < E; ++e) {
            acc[i][e][0] = fmaf(dc, kk[e].x, acc[i][e][0]);
            acc[i][e][1] = fmaf(dc, kk[e].y, acc[i][e][1]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();  // the empty trailing groups

  // the partitions' sums; the lanes of partition i % KP write row i
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (KP == 2) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        acc[i][e][0] += __shfl_xor_sync(0xffffffffu, acc[i][e][0], 1);
        acc[i][e][1] += __shfl_xor_sync(0xffffffffu, acc[i][e][1], 1);
      }
    }
    const int row = row0 + wrow + 4 * i;
    if (row >= nq || i % KP != kp) continue;
    float* qrow = dq + ((size_t)bh * nq + row) * D + 2 * dl;
#pragma unroll
    for (int e = 0; e < E; ++e)
      *reinterpret_cast<float2*>(qrow + 2 * LD * e) =
          make_float2(acc[i][e][0] * scale, acc[i][e][1] * scale);
  }
}

// The same arguments -> dk, dv [bh, nk, D]: K6 at the tile WARPS x 16 key
// rows, BQ streamed query rows, a ring of STAGES.
template <int D, int BQ, int WARPS, int STAGES>
__global__ void __launch_bounds__(32 * WARPS)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         int nq, int nk, float sl, float scale) {
  constexpr int NT = 32 * WARPS, BK = 16 * WARPS;
  constexpr int QS = D + 4;          // K, V, Q and dO row stride (floats)
  constexpr int PS = BQ + 8;         // P^T and dS^T row stride
  constexpr int TN = BQ / 8;         // queries a lane scores
  constexpr int C4 = D / 4;
  constexpr int LD = DSplit<D>::LD, KP = 8 / LD;
  constexpr int PW = BQ / KP + 4;    // a query partition's span in a row
  constexpr int E = D / (2 * LD);    // float2 columns a lane sums
  constexpr int TILE = BQ * QS;      // floats of a Q or dO tile
  constexpr int STAGE = 2 * TILE + 2 * BQ;  // Q, dO, lse * log2 e, delta
  static_assert(E == 5 && BQ % 32 == 0 && BQ <= NT && KP * PW <= PS,
                "tile");

  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;
  float* v_s = k_s + BK * QS;
  float* ring = v_s + BK * QS;
  float* pt_s = ring + STAGES * STAGE;  // each warp's 16 rows of P^T
  float* dst_s = pt_s + BK * PS;        // and of dS^T

  const int tid = threadIdx.x, warp = tid >> 5;
  const int rg = (tid & 31) >> 3, kl = tid & 7;
  const int dl = kl / KP, kp = kl % KP;
  const int key0 = blockIdx.x * BK;
  const int bh = blockIdx.y;
  const int tiles = (nq + BQ - 1) / BQ;
  const float* qb = q + (size_t)bh * nq * D;
  const float* dob = dout + (size_t)bh * nq * D;
  const float* lb = lse + (size_t)bh * nq;
  const float* db = delta + (size_t)bh * nq;

  // Q/dO tile t into stage t % STAGES, the rows past nq zero; past the end
  // an empty group, so that every wait below counts the same groups
  auto load_qdo = [&](int t) {
    if (t < tiles) {
      float* qs = ring + (t % STAGES) * STAGE;
      for (int i = tid; i < BQ * C4; i += NT) {
        const int r = i / C4, c = i % C4;
        const int row = t * BQ + r;
        const bool in = row < nq;
        const size_t off = (size_t)(in ? row : 0) * D + 4 * c;
        cp_async16(smem_u32(qs + r * QS + 4 * c), qb + off, in ? 16 : 0);
        cp_async16(smem_u32(qs + TILE + r * QS + 4 * c), dob + off,
                   in ? 16 : 0);
      }
    }
    cp_async_commit();
  };
  // query row t BQ + tid's lse (times log2 e) and delta: +inf and 0 past
  // nq, so that its p and dS are 0
  auto row_stats = [&](int t, float& l, float& d) {
    const int row = t * BQ + tid;
    const bool in = row < nq;
    l = in ? lb[row] * LOG2E : INFINITY;
    d = in ? db[row] : 0.f;
  };

  // K and V land with the first Q/dO tile
  for (int i = tid; i < BK * C4; i += NT) {
    const int r = i / C4, c = i % C4;
    const size_t off = ((size_t)bh * nk + key0 + r) * D + 4 * c;
    cp_async16(smem_u32(k_s + r * QS + 4 * c), k + off, 16);
    cp_async16(smem_u32(v_s + r * QS + 4 * c), v + off, 16);
  }
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    load_qdo(t);
    if (t < tiles && tid < BQ) {
      float* st = ring + t * STAGE + 2 * TILE;
      row_stats(t, st[tid], st[BQ + tid]);
    }
  }

  // this lane's key rows rg + 4 i of the warp's 16: in K and V, and in its
  // P^T and dS^T tiles
  const float* kw = k_s + (16 * warp + rg) * QS;
  const float* vw = v_s + (16 * warp + rg) * QS;
  float* ptw = pt_s + (16 * warp + rg) * PS;
  float* dsw = dst_s + (16 * warp + rg) * PS;
  float acc_k[4][E][2], acc_v[4][E][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < E; ++e)
      acc_k[i][e][0] = acc_k[i][e][1] = acc_v[i][e][0] = acc_v[i][e][1] = 0.f;

#pragma unroll 1
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<STAGES - 2>();  // K, V and tile t are in
    __syncthreads();              // ... for every thread; tile t - 1 is read
    const int next = t + STAGES - 1;
    load_qdo(next);
    float next_l = 0.f, next_d = 0.f;
    if (next < tiles && tid < BQ) row_stats(next, next_l, next_d);
    const float* qs = ring + (t % STAGES) * STAGE;
    const float* dos = qs + TILE;
    const float* ls = dos + TILE;
    const float* dls = ls + BQ;

    // S^T = K Q^T and dP^T = V dO^T: key rows rg + 4 i, queries kl + 8 j
    float s[4][TN], dp[4][TN];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int g = 0; g < C4; ++g) {
      float4 a[4], b[TN];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = ld4(kw + 4 * i * QS + 4 * g);
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ld4(qs + (kl + 8 * j) * QS + 4 * g);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) dot4(s[i][j], a[i], b[j]);
    }
#pragma unroll 2
    for (int g = 0; g < C4; ++g) {
      float4 a[4], b[TN];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = ld4(vw + 4 * i * QS + 4 * g);
#pragma unroll
      for (int j = 0; j < TN; ++j)
        b[j] = ld4(dos + (kl + 8 * j) * QS + 4 * g);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) dot4(dp[i][j], a[i], b[j]);
    }
    // p and dS in base 2, into the warp's tiles at query kl + 8 j's
    // partition span
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const float l2 = ls[kl + 8 * j], dl2 = dls[kl + 8 * j];
      const int at = (kl % KP) * PW + kl / KP + 8 / KP * j;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = exp2f(fmaf(s[i][j], sl, -l2));
        ptw[4 * i * PS + at] = p;
        dsw[4 * i * PS + at] = p * (dp[i][j] - dl2);
      }
    }
    __syncwarp();  // the warp's P^T and dS^T are written

    // dV += P^T dO, dK += dS^T Q over this lane's query partition: queries
    // KP (4 u + c) + kp
#pragma unroll 1
    for (int u = 0; u < BQ / KP / 4; ++u) {
      float4 pt[4], ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pt[i] = ld4(ptw + 4 * i * PS + kp * PW + 4 * u);
        ds[i] = ld4(dsw + 4 * i * PS + kp * PW + 4 * u);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int at = (KP * (4 * u + c) + kp) * QS + 2 * dl;
        float2 qq[E], dd[E];
#pragma unroll
        for (int e = 0; e < E; ++e) {
          qq[e] = ld2(qs + at + 2 * LD * e);
          dd[e] = ld2(dos + at + 2 * LD * e);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pc = lane(pt[i], c), dc = lane(ds[i], c);
#pragma unroll
          for (int e = 0; e < E; ++e) {
            acc_v[i][e][0] = fmaf(pc, dd[e].x, acc_v[i][e][0]);
            acc_v[i][e][1] = fmaf(pc, dd[e].y, acc_v[i][e][1]);
            acc_k[i][e][0] = fmaf(dc, qq[e].x, acc_k[i][e][0]);
            acc_k[i][e][1] = fmaf(dc, qq[e].y, acc_k[i][e][1]);
          }
        }
      }
    }
    if (next < tiles && tid < BQ) {  // that stage was last read a tile ago
      float* st = ring + (next % STAGES) * STAGE + 2 * TILE;
      st[tid] = next_l;
      st[BQ + tid] = next_d;
    }
  }
  cp_async_wait<0>();  // the empty trailing groups

  // the partitions' sums; the lanes of partition i % KP write key row i
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (KP == 2) {
#pragma unroll
      for (int e = 0; e < E; ++e)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          acc_k[i][e][h] += __shfl_xor_sync(0xffffffffu, acc_k[i][e][h], 1);
          acc_v[i][e][h] += __shfl_xor_sync(0xffffffffu, acc_v[i][e][h], 1);
        }
    }
    if (i % KP != kp) continue;
    const size_t at =
        ((size_t)bh * nk + key0 + 16 * warp + rg + 4 * i) * D + 2 * dl;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      *reinterpret_cast<float2*>(dk + at + 2 * LD * e) =
          make_float2(acc_k[i][e][0] * scale, acc_k[i][e][1] * scale);
      *reinterpret_cast<float2*>(dv + at + 2 * LD * e) =
          make_float2(acc_v[i][e][0], acc_v[i][e][1]);
    }
  }
}

template <typename K>
int prepare(K kern, int smem) {
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <int D, int BN, int WARPS, int STAGES>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int bh, int nq,
              int nk, int smem, float scale, cudaStream_t stream) {
  constexpr int SMEM = dq_smem_bytes<D, BN, WARPS, STAGES>();
  if constexpr (SMEM > MAX_SMEM) {  // no such block (d = 80 at 128 x 64 x 3)
    return (int)cudaErrorInvalidValue;
  } else {
    if (nk % BN != 0 || smem != SMEM) return (int)cudaErrorInvalidValue;
    auto kern = flash_bwd_dq_f32_kernel<D, BN, WARPS, STAGES>;
    const int err = prepare(kern, smem);
    if (err != 0) return err;
    const dim3 grid((nq + 16 * WARPS - 1) / (16 * WARPS), bh);
    kern<<<grid, 32 * WARPS, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<float*>(dq), nq, nk, scale * LOG2E, scale);
    return (int)cudaGetLastError();
  }
}

template <int D, int BQ, int WARPS, int STAGES>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int bh,
               int nq, int nk, int smem, float scale, cudaStream_t stream) {
  constexpr int SMEM = dkv_smem_bytes<D, BQ, WARPS, STAGES>();
  if constexpr (SMEM > MAX_SMEM) {  // no such block (d = 80 at 128 x 64)
    return (int)cudaErrorInvalidValue;
  } else {
    if (nk % (16 * WARPS) != 0 || smem != SMEM)
      return (int)cudaErrorInvalidValue;
    auto kern = flash_bwd_dkv_f32_kernel<D, BQ, WARPS, STAGES>;
    const int err = prepare(kern, smem);
    if (err != 0) return err;
    const dim3 grid(nk / (16 * WARPS), bh);
    kern<<<grid, 32 * WARPS, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<float*>(dk), static_cast<float*>(dv), nq, nk,
        scale * LOG2E, scale);
    return (int)cudaGetLastError();
  }
}

// Blocks of a K5 tile resident on an SM at once, into *out.
template <int D, int BN, int WARPS, int STAGES>
int resident_dq(int smem, int* out) {
  if constexpr (dq_smem_bytes<D, BN, WARPS, STAGES>() > MAX_SMEM) {
    return (int)cudaErrorInvalidValue;
  } else {
    auto kern = flash_bwd_dq_f32_kernel<D, BN, WARPS, STAGES>;
    const int err = prepare(kern, smem);
    if (err != 0) return err;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, kern, 32 * WARPS, (size_t)smem);
  }
}

// Blocks of a K6 tile resident on an SM at once, into *out.
template <int D, int BQ, int WARPS, int STAGES>
int resident_dkv(int smem, int* out) {
  if constexpr (dkv_smem_bytes<D, BQ, WARPS, STAGES>() > MAX_SMEM) {
    return (int)cudaErrorInvalidValue;
  } else {
    auto kern = flash_bwd_dkv_f32_kernel<D, BQ, WARPS, STAGES>;
    const int err = prepare(kern, smem);
    if (err != 0) return err;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, kern, 32 * WARPS, (size_t)smem);
  }
}

// The K5 tiles: (query rows, streamed keys, ring stages) a block at each
// head dim.
#define FGDM_K5_F32_TILES(X) \
  X(64, 64, 2)               \
  X(64, 64, 3)               \
  X(128, 64, 2)              \
  X(128, 64, 3)              \
  X(64, 32, 2)               \
  X(64, 32, 3)               \
  X(128, 32, 2)              \
  X(128, 32, 3)

// The K6 tiles: (key rows, streamed queries, ring stages) a block at each
// head dim.
#define FGDM_K6_F32_TILES(X) \
  X(64, 64, 2)               \
  X(64, 64, 3)               \
  X(128, 64, 2)              \
  X(128, 64, 3)              \
  X(64, 32, 2)               \
  X(64, 32, 3)               \
  X(128, 32, 2)              \
  X(128, 32, 3)

bool bad_shape(int bh, int nq, int nk) {
  return bh <= 0 || bh > 65535 || nq <= 0 || nk <= 0;
}

}  // namespace

extern "C" {

// q/dout: contiguous [bh, nq, d] f32, k/v [bh, nk, d] f32, lse (natural
// log) and delta [bh, nq] f32, all on the current device, 16-byte aligned;
// d one of 40, 80; the K5 tile bm x bn x stages (query rows a block,
// streamed keys, ring stages; one of FGDM_K5_F32_TILES) with its smem
// (kernels/attention.py bwd_f32_tile; checked against this file's); nk a
// multiple of bn.  Writes dq [bh, nq, d] f32.  Returns 0 or a cudaError_t
// code (launch errors included).
int fgdm_flash_attn_bwd_f32_dq(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dq, int bh, int nq,
                               int nk, int d, int bm, int bn, int stages,
                               int smem, float scale, void* stream) {
  if (bad_shape(bh, nq, nk)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FGDM_K5_F32(BM, BN, STAGES)                                          \
  if (bm == BM && bn == BN && stages == STAGES) {                            \
    if (d == 40)                                                             \
      return launch_dq<40, BN, BM / 16, STAGES>(q, k, v, dout, lse, delta,   \
                                                dq, bh, nq, nk, smem, scale, \
                                                s);                          \
    if (d == 80)                                                             \
      return launch_dq<80, BN, BM / 16, STAGES>(q, k, v, dout, lse, delta,   \
                                                dq, bh, nq, nk, smem, scale, \
                                                s);                          \
  }
  FGDM_K5_F32_TILES(FGDM_K5_F32)
#undef FGDM_K5_F32
  return (int)cudaErrorInvalidValue;
}

// Blocks of the K5 tile bm x bn x stages (smem as above) resident on an SM
// at once, into *out.  Returns 0 or a cudaError_t code.
int fgdm_flash_attn_bwd_f32_dq_resident(int d, int bm, int bn, int stages,
                                        int smem, int* out) {
  if (out == nullptr) return (int)cudaErrorInvalidValue;
#define FGDM_K5_F32(BM, BN, STAGES)                                      \
  if (bm == BM && bn == BN && stages == STAGES &&                        \
      smem == (d == 40 ? dq_smem_bytes<40, BN, BM / 16, STAGES>()        \
                       : dq_smem_bytes<80, BN, BM / 16, STAGES>())) {    \
    if (d == 40) return resident_dq<40, BN, BM / 16, STAGES>(smem, out); \
    if (d == 80) return resident_dq<80, BN, BM / 16, STAGES>(smem, out); \
  }
  FGDM_K5_F32_TILES(FGDM_K5_F32)
#undef FGDM_K5_F32
  return (int)cudaErrorInvalidValue;
}

// The same inputs and the K6 tile bk x bq x stages (key rows a block,
// streamed queries, ring stages; one of FGDM_K6_F32_TILES) with its smem;
// nk a multiple of bk.  Writes dk and dv [bh, nk, d] f32.
int fgdm_flash_attn_bwd_f32_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dk, void* dv, int bh,
                                int nq, int nk, int d, int bk, int bq,
                                int stages, int smem, float scale,
                                void* stream) {
  if (bad_shape(bh, nq, nk)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FGDM_K6_F32(BK, BQ, STAGES)                                         \
  if (bk == BK && bq == BQ && stages == STAGES) {                           \
    if (d == 40)                                                            \
      return launch_dkv<40, BQ, BK / 16, STAGES>(q, k, v, dout, lse, delta, \
                                                 dk, dv, bh, nq, nk, smem,  \
                                                 scale, s);                 \
    if (d == 80)                                                            \
      return launch_dkv<80, BQ, BK / 16, STAGES>(q, k, v, dout, lse, delta, \
                                                 dk, dv, bh, nq, nk, smem,  \
                                                 scale, s);                 \
  }
  FGDM_K6_F32_TILES(FGDM_K6_F32)
#undef FGDM_K6_F32
  return (int)cudaErrorInvalidValue;
}

// Blocks of the K6 tile bk x bq x stages (smem as above) resident on an SM
// at once, into *out.  Returns 0 or a cudaError_t code.
int fgdm_flash_attn_bwd_f32_dkv_resident(int d, int bk, int bq, int stages,
                                         int smem, int* out) {
  if (out == nullptr) return (int)cudaErrorInvalidValue;
#define FGDM_K6_F32(BK, BQ, STAGES)                                        \
  if (bk == BK && bq == BQ && stages == STAGES &&                          \
      smem == (d == 40 ? dkv_smem_bytes<40, BQ, BK / 16, STAGES>()         \
                       : dkv_smem_bytes<80, BQ, BK / 16, STAGES>())) {     \
    if (d == 40) return resident_dkv<40, BQ, BK / 16, STAGES>(smem, out);  \
    if (d == 80) return resident_dkv<80, BQ, BK / 16, STAGES>(smem, out);  \
  }
  FGDM_K6_F32_TILES(FGDM_K6_F32)
#undef FGDM_K6_F32
  return (int)cudaErrorInvalidValue;
}

// The keys every planned tile at head dim d divides (nk must be a
// multiple), 0 if the head dim is not instantiated.
int fgdm_flash_attn_bwd_f32_block_n(int d) {
  return d == 40 || d == 80 ? KEY_MULTIPLE : 0;
}

const char* fgdm_cuda_error_string(int code) { return error_string(code); }

}  // extern "C"
