// Flash-attention backward at the UNet's head dims (40, 80) for Hopper
// (sm_90a), bf16 in / bf16 out.
//
// Replaces the two Pallas TPU kernels of fgdm_tpu/kernels/attention.py:
//   _flash_bwd_dq_kernel_t  (:299, pallas_call :399)  dQ, per query block
//   _flash_bwd_dkv_kernel_t (:329, pallas_call :416)  dK, dV, per key block
// and computes their math (Dao 2022, §B) from the forward's residuals: the
// logsumexp of the scaled scores (lse, natural log) and
// delta = rowsum(dO * O), which the wrapper computes as one torch reduction,
// as the JAX package does in XLA (attention.py:390-393):
//   p  = exp(s * q k^T - lse)         dP = dO v^T
//   dS = p * (dP - delta)
//   dQ = s * dS k      dK = s * dS^T q      dV = p^T dO
// so no N x N matrix reaches device memory.
//
// Two kernels, as on the TPU, and no atomics: the dQ kernel's block owns
// query rows and streams keys; the dK/dV kernel's block owns key rows and
// streams queries.  Every output element is summed by one thread in a fixed
// order, so a rerun is bit-identical.  S and dP are computed in both.
//
// What bounds them on the card.  Per score dQ does 6*d tensor operations
// (S, dP, dS.K) and dK/dV 8*d (S^T, dP^T, P^T.dO, dS^T.Q), and each one
// exp: at d = 40 the exps (3.9e12/s on the special-function units) take
// 1.0x (dQ) and 0.8x (dK/dV) the products' time at 989 TFLOP/s, at d = 80
// the products lead.  Bytes (~10*N*d per head) are far below either.  The
// design is the forward's (flash_attn_fwd.cu), turned round for each kernel:
//
//   * dQ (flash_bwd_dq_kernel): a block owns 64 query rows per consumer
//     warpgroup (WGS, 1 or 2) of one (batch, head).  Q and dO are loaded
//     once by TMA; K and V tiles of BN keys (64 or 128) stream through a
//     ring of 2-4 stages behind full/empty mbarriers, filled by one
//     producer warp.  S = Q K^T and dP = dO V^T run on wgmma m64n{BN}k16
//     with both operands K-major over d in shared memory (TMA zero-fills d
//     up to the 64-column box: 3 k16 steps at d = 40, 5 at d = 80).  P and
//     dS stay in the accumulator registers, and dS, rounded to bf16, is the
//     A operand of dQ += dS K, whose B is the same K tile read MN-major
//     (the transpose bit of wgmma): N runs over whole 64-wide swizzle
//     atoms, so d is padded to NP = 64 (d = 40) or 128 (d = 80) with the
//     zeros TMA wrote, and the columns past d are not stored.
//   * dK/dV (flash_bwd_dkv_kernel): a block owns 64 key rows per consumer
//     warpgroup.  K and V are loaded once; Q and dO tiles of 64 queries
//     stream through the ring, with the tile's lse (times log2 e; +inf past
//     nq) and delta, which the producer warp writes with plain stores
//     before it arrives at the stage's barrier.  S^T = K Q^T and
//     dP^T = V dO^T run on wgmma m64n64k16 (K-major over d); P^T and dS^T
//     stay in registers and, rounded to bf16, are the A operands of
//     dV += P^T dO and dK += dS^T Q (m64n{NP}k16), whose B operands are the
//     same dO and Q tiles read MN-major.  dK is scaled once at the end.
//   * Reading B in place costs 60 % more work in the accumulating products
//     (N = 64 for d = 40, 128 for d = 80) and 12-24 more accumulator
//     registers, and saves the transposed copies of K, Q and dO that a
//     K-major B at N = d needs (the forward's V^T): at [8,8,1024,40] those
//     copies took 0.042 ms beside 0.18 ms of the two kernels.
//   * The exps in base 2: s * log2 e is folded into one FFMA per score
//     before ex2.approx, and lse is taken times log2 e.
//   * Overlap inside a warpgroup: tile j's two score products are issued
//     with tile j-1's accumulating products; the warpgroup waits only for
//     S (wgmma_wait<2>), runs the exps while dP and the previous products
//     run, then dS, and packs the A fragments once everything has landed.
//     A ring stage is released one tile late, when the products that read
//     its transposed operand are done.
//   * Overlap across warpgroups (WGS = 2): named barriers hand the turn to
//     issue wgmmas from one warpgroup to the other, as in the forward.
//   * Masking: the gate admits Nq != Nk and Nq % 64 != 0.  Query rows at or
//     past nq arrive as zeros (TMA fill); in the dK/dV kernel their lse is
//     +inf and delta 0, so p = dS = 0; the dQ kernel never writes them.
//     The dK/dV kernel masks its stores of key rows past nk.
//
// The host (kernels/attention.py flash_bwd_plan) picks the streamed tile,
// the stages and WGS per shape; chip_smoke.py --sweep times the choices.
//
// On an H100 80GB HBM3 at 700 W (chip_smoke.py, device time): at the
// training step's [8,8,1024,40] dQ 0.053 ms (128 keys x 4 stages x 2
// warpgroups) and dK/dV 0.071 ms (64 queries x 4 x 2), 33 / 31 % of their
// bounds, together level with SDPA's whole backward (0.127); at
// [2,8,4096,40] 0.171 / 0.232 ms (40 / 37 %).  Two warpgroups need the
// producer warpgroup's registers: dK/dV at d = 40 takes 218 a thread in
// its one-warpgroup build, above the 168 of a 384-thread launch.  At
// d = 80 the NP = 128 accumulators leave dK/dV with two warpgroups, and dQ
// with 128-key tiles, short of registers even at 232 (spills, and ptxas
// serializes their wgmmas): the plan takes one warpgroup and 64-key tiles
// there.  Tried and dropped: K^T, Q^T and dO^T handed over by the wrapper
// as K-major B operands at N = d (the copies took 0.042 ms of 0.225 at
// [8,8,1024,40]); the first tile's products behind a runtime branch inside
// the loop, which made ptxas serialize every wgmma of the kernel (C7520,
// "divergent path"): 1.4-1.8x slower at every shape.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace fgdm;

constexpr int WG_ROWS = 64;         // rows a consumer warpgroup owns
constexpr int MAX_STAGES = 4;       // ring depth the header has room for
constexpr int HEADER = 1024;        // the mbarriers, ahead of the tiles
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory a block may use
constexpr float LOG2E = 1.4426950408889634f;
// Registers a thread with two consumer warpgroups: 168 at launch (384
// threads), the producer warpgroup's share moved to the consumers:
// 128 * 40 + 256 * 232 <= 65536.
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;

// What both kernels keep resident: two tiles (Q and dO, or K and V) of 64
// rows per warpgroup, in 64-column panels.
template <int D, int WGS>
struct Resident {
  static constexpr int PANELS = (D + 63) / 64;
  static constexpr int KSTEPS = (D + 15) / 16;   // k16 steps over d
  static constexpr int NP = PANELS * 64;         // d padded to whole atoms
  static constexpr int PANEL = WG_ROWS * 128;    // bytes
  static constexpr int HALF = WGS * PANELS * PANEL;
  static constexpr int BYTES = 2 * HALF;
  // two consumer warpgroups come with a whole producer warpgroup, so that
  // registers can move to them (setmaxnreg); one with a producer warp
  static constexpr int THREADS = WGS == 2 ? 384 : 160;
  static_assert(D % 8 == 0 && D <= 128, "head dim");
  static_assert(WGS == 1 || WGS == 2, "consumer warpgroups");
};

// dQ: a stage holds K and V tiles of BN keys, in 64-column panels.
template <int D, int BN, int WGS>
struct DqCfg : Resident<D, WGS> {
  typedef Resident<D, WGS> R;
  static constexpr int K_PANEL = BN * 128;
  static constexpr int K_BYTES = R::PANELS * K_PANEL;
  static constexpr int STAGE = 2 * K_BYTES;
  static constexpr int smem(int stages) {
    return 1024 + HEADER + R::BYTES + stages * STAGE;
  }
  static_assert(BN == 64 || BN == 128, "keys per tile");
};

// dK/dV: a stage holds Q and dO tiles of BQ queries and (after all the
// stages' tiles) the tile's lse * log2 e and delta in f32.
template <int D, int BQ, int WGS>
struct DkvCfg : Resident<D, WGS> {
  typedef Resident<D, WGS> R;
  static constexpr int Q_PANEL = BQ * 128;
  static constexpr int Q_BYTES = R::PANELS * Q_PANEL;
  static constexpr int STAGE = 2 * Q_BYTES;
  static constexpr int ROWS = 2 * BQ * 4;
  static constexpr int smem(int stages) {
    return 1024 + HEADER + R::BYTES + stages * (STAGE + ROWS);
  }
  static_assert(BQ == 64, "queries per tile");
};

// One accumulating k16 step of a 64 x NP product, A from registers, B a
// tile of 16 rows read MN-major (NP = 64 or 128 contiguous columns in
// 64-wide swizzle atoms, atoms `atom` bytes apart).
template <int NP>
__device__ __forceinline__ void mn_step(float (&acc)[NP / 2],
                                        const uint32_t (&a)[4], uint32_t row,
                                        uint32_t atom) {
  const uint64_t b = desc_sw128(row, atom, 1024);
  if constexpr (NP == 64)
    wgmma_m64n64k16_rs_tb(acc, a, b, 1);
  else
    wgmma_m64n128k16_rs_tb(acc, a, b, 1);
}

__device__ __forceinline__ void release(uint32_t bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

template <int N>
__device__ __forceinline__ void pack_a(uint32_t (&a)[N / 16][4],
                                       const float (&x)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    a[kk][0] = pack_bf16(x[8 * kk], x[8 * kk + 1]);
    a[kk][1] = pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
    a[kk][2] = pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
    a[kk][3] = pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
    fence_regs(a[kk]);
  }
}

// Turns to issue wgmmas when two warpgroups share the block: warpgroup w
// issues between bar.sync(1 + w) and its arrival at the next one's barrier.
template <int WGS>
struct Turns {
  int wg;
  __device__ void first() const {
    if (WGS > 1 && wg == WGS - 1) named_bar_arrive(1, 256);  // 0 goes first
  }
  __device__ void begin() const {
    if (WGS > 1) named_bar_sync(1 + wg, 256);
  }
  __device__ void end() const {
    if (WGS > 1) named_bar_arrive(1 + (wg + 1) % WGS, 256);
  }
  // the last warpgroup's last end() arrived at barrier 1 with no one waiting
  __device__ void last() const {
    if (WGS > 1 && wg == 0) named_bar_sync(1, 256);
  }
};

// The producer side of the register budget: returns true for the one warp
// that loads, after the producer warpgroup (two consumer warpgroups) gave
// its registers back; the others are done.
template <int WGS>
__device__ __forceinline__ bool producer_warp(int warp) {
  if constexpr (WGS == 2) setmaxnreg_dec<PRODUCER_REGS>();
  return warp == 4 * WGS;
}

template <int WGS>
__device__ __forceinline__ void consumer_registers() {
  if constexpr (WGS == 2) setmaxnreg_inc<CONSUMER_REGS>();
}

// Tile j's step of a consumer warpgroup, with or without tile j-1's
// accumulating products (tile 0 has none): a compile-time choice, so that
// no wgmma is issued or waited for on a divergent path (ptxas would
// serialize every wgmma of the kernel).
using First = std::false_type;
using Next = std::true_type;

// In the wgmma D layout thread (warp w4 of its warpgroup, lane 4g + t)
// holds x[4i], x[4i+1] of row 16 w4 + g at columns 8i + 2t and + 1, and
// x[4i+2], x[4i+3] of row + 8 at the same columns.

// q/do as 3-D maps {d, nq, bh} with box {64, 64, 1}; k/v {d, nk, bh} with
// box {64, BN, 1}.  lse, delta [bh, nq] f32; dq [bh, nq, d] bf16.
// sl = scale * log2 e.
template <int D, int BN, int WGS>
__global__ void __launch_bounds__(WGS == 2 ? 384 : 160, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap domap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    int nq, int nk, int stages, float sl, float scale) {
  typedef DqCfg<D, BN, WGS> C;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t res_full = base;
  const uint32_t full = base + 8, empty = full + 8 * MAX_STAGES;
  const uint32_t q_s = base + HEADER, do_s = q_s + C::HALF;
  const uint32_t ring = q_s + C::BYTES;  // stage i: K, V

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int row0 = blockIdx.x * WGS * WG_ROWS;
  const int bh = blockIdx.y;
  const int tiles = nk / BN;

  if (tid == 0) {
    mbar_init(res_full, 1);
    for (int i = 0; i < stages; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, 4 * WGS);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 4 * WGS) {
    // ---- producer ----
    if (producer_warp<WGS>(warp) && lane == 0) {
      mbar_expect_tx(res_full, C::BYTES);
      for (int w = 0; w < WGS; ++w)
        for (int p = 0; p < C::PANELS; ++p) {
          const uint32_t off = (w * C::PANELS + p) * C::PANEL;
          tma_load_3d(q_s + off, &qmap, res_full, p * 64, row0 + w * WG_ROWS,
                      bh);
          tma_load_3d(do_s + off, &domap, res_full, p * 64,
                      row0 + w * WG_ROWS, bh);
        }
      int s = 0;
      uint32_t ph = 1;
      for (int t = 0; t < tiles; ++t) {
        const uint32_t st = ring + s * C::STAGE, bar = full + 8 * s;
        mbar_wait(empty + 8 * s, ph);
        mbar_expect_tx(bar, C::STAGE);
        for (int p = 0; p < C::PANELS; ++p) {
          tma_load_3d(st + p * C::K_PANEL, &kmap, bar, p * 64, t * BN, bh);
          tma_load_3d(st + C::K_BYTES + p * C::K_PANEL, &vmap, bar, p * 64,
                      t * BN, bh);
        }
        if (++s == stages) { s = 0; ph ^= 1; }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns query rows [64 wg, 64 wg + 64) ----
  consumer_registers<WGS>();
  const int wg = warp >> 2, w4 = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t q_wg = q_s + wg * C::PANELS * C::PANEL;
  const uint32_t do_wg = do_s + wg * C::PANELS * C::PANEL;
  const int ra = row0 + wg * WG_ROWS + w4 * 16 + g, rb = ra + 8;
  // rows past nq (zeros, never written) take lse = delta = 0: finite
  const float la = ra < nq ? lse[(size_t)bh * nq + ra] * LOG2E : 0.f;
  const float lb = rb < nq ? lse[(size_t)bh * nq + rb] * LOG2E : 0.f;
  const float da = ra < nq ? delta[(size_t)bh * nq + ra] : 0.f;
  const float db = rb < nq ? delta[(size_t)bh * nq + rb] : 0.f;

  float acc[C::NP / 2], sc[BN / 2], dp[BN / 2];
#pragma unroll
  for (int i = 0; i < C::NP / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) sc[i] = dp[i] = 0.f;
  uint32_t dsa[BN / 16][4];
  const Turns<WGS> turns{wg};

  // S = Q K^T and dP = dO V^T, two commit groups
  auto issue_scores = [&](uint32_t st) {
#pragma unroll
    for (int kk = 0; kk < C::KSTEPS; ++kk) {
      const uint32_t off = (kk >> 2) * C::PANEL + (kk & 3) * 32;
      const uint32_t koff = (kk >> 2) * C::K_PANEL + (kk & 3) * 32;
      qk_step<BN>(sc, desc_sw128(q_wg + off, 16, 1024),
                  desc_sw128(st + koff, 16, 1024), kk > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < C::KSTEPS; ++kk) {
      const uint32_t off = (kk >> 2) * C::PANEL + (kk & 3) * 32;
      const uint32_t koff = (kk >> 2) * C::K_PANEL + (kk & 3) * 32;
      qk_step<BN>(dp, desc_sw128(do_wg + off, 16, 1024),
                  desc_sw128(st + C::K_BYTES + koff, 16, 1024), kk > 0);
    }
    wgmma_commit();
  };
  // dQ += dS K (K's tile MN-major, 16 keys = 2048 bytes a step), one
  // commit group
  auto issue_dq = [&](uint32_t st) {
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      mn_step<C::NP>(acc, dsa[kk], st + kk * 2048, C::K_PANEL);
    wgmma_commit();
  };
  auto exp_p = [&] {
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      sc[4 * i] = ex2(fmaf(sc[4 * i], sl, -la));
      sc[4 * i + 1] = ex2(fmaf(sc[4 * i + 1], sl, -la));
      sc[4 * i + 2] = ex2(fmaf(sc[4 * i + 2], sl, -lb));
      sc[4 * i + 3] = ex2(fmaf(sc[4 * i + 3], sl, -lb));
    }
  };
  auto grad_s = [&] {
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      dp[4 * i] = sc[4 * i] * (dp[4 * i] - da);
      dp[4 * i + 1] = sc[4 * i + 1] * (dp[4 * i + 1] - da);
      dp[4 * i + 2] = sc[4 * i + 2] * (dp[4 * i + 2] - db);
      dp[4 * i + 3] = sc[4 * i + 3] * (dp[4 * i + 3] - db);
    }
  };

  // stage s holds tile j, stage ps tile j-1
  auto step = [&](auto next, int s, int ps) {
    turns.begin();
    wgmma_fence();
    issue_scores(ring + s * C::STAGE);
    if constexpr (decltype(next)::value)
      issue_dq(ring + ps * C::STAGE);  // dQ += dS_{j-1} K_{j-1}
    turns.end();
    if constexpr (decltype(next)::value) wgmma_wait<2>();  // S_j is done
    else wgmma_wait<1>();
    fence_regs(sc);
    exp_p();
    if constexpr (decltype(next)::value) wgmma_wait<1>();  // dP_j is done
    else wgmma_wait<0>();
    fence_regs(dp);
    grad_s();
    if constexpr (decltype(next)::value) {
      wgmma_wait<0>();  // dS_{j-1}'s registers are free, its stage too
      fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) fence_regs(dsa[kk]);
      release(empty + 8 * ps, lane);
    }
    pack_a<BN>(dsa, dp);
  };

  turns.first();
  mbar_wait(res_full, 0);
  mbar_wait(full, 0);
  step(First(), 0, 0);
  int s = 1, ps = 0;  // stages >= 2
  uint32_t ph = 0;
#pragma unroll 1
  for (int j = 1; j < tiles; ++j) {
    mbar_wait(full + 8 * s, ph);
    step(Next(), s, ps);
    ps = s;
    if (++s == stages) { s = 0; ph ^= 1; }
  }
  wgmma_fence();
  issue_dq(ring + ps * C::STAGE);
  wgmma_wait<0>();
  fence_regs(acc);
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) fence_regs(dsa[kk]);
  release(empty + 8 * ps, lane);
  turns.last();

  bf16* oa = dq + ((size_t)bh * nq + ra) * D + 2 * t;
  bf16* ob = oa + 8 * D;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    if (ra < nq)
      *reinterpret_cast<__nv_bfloat162*>(oa + 8 * i) = __floats2bfloat162_rn(
          acc[4 * i] * scale, acc[4 * i + 1] * scale);
    if (rb < nq)
      *reinterpret_cast<__nv_bfloat162*>(ob + 8 * i) = __floats2bfloat162_rn(
          acc[4 * i + 2] * scale, acc[4 * i + 3] * scale);
  }
}

// k/v as 3-D maps {d, nk, bh} with box {64, 64, 1}; q/do {d, nq, bh} with
// box {64, BQ, 1}.  lse, delta [bh, nq] f32; dk/dv [bh, nk, d] bf16.
// sl = scale * log2 e.
template <int D, int BQ, int WGS>
__global__ void __launch_bounds__(WGS == 2 ? 384 : 160, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap,
                     const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap domap,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int nq, int nk, int stages,
                     float sl, float scale) {
  typedef DkvCfg<D, BQ, WGS> C;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t res_full = base;
  const uint32_t full = base + 8, empty = full + 8 * MAX_STAGES;
  const uint32_t k_s = base + HEADER, v_s = k_s + C::HALF;
  const uint32_t ring = k_s + C::BYTES;  // stage i: Q, dO
  // stage i's lse * log2 e at rows + 2 BQ i, its delta BQ further
  float* rows =
      reinterpret_cast<float*>(smem_raw + (ring + stages * C::STAGE - raw));

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int key0 = blockIdx.x * WGS * WG_ROWS;
  const int bh = blockIdx.y;
  const int tiles = (nq + BQ - 1) / BQ;

  if (tid == 0) {
    mbar_init(res_full, 1);
    for (int i = 0; i < stages; ++i) {
      mbar_init(full + 8 * i, 32);        // every producer lane arrives
      mbar_init(empty + 8 * i, 4 * WGS);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 4 * WGS) {
    // ---- producer: lane 0 asks for the tiles, every lane writes its share
    // of the row statistics before it arrives ----
    if (!producer_warp<WGS>(warp)) return;
    if (lane == 0) {
      mbar_expect_tx(res_full, C::BYTES);
      for (int w = 0; w < WGS; ++w)
        for (int p = 0; p < C::PANELS; ++p) {
          const uint32_t off = (w * C::PANELS + p) * C::PANEL;
          tma_load_3d(k_s + off, &kmap, res_full, p * 64, key0 + w * WG_ROWS,
                      bh);
          tma_load_3d(v_s + off, &vmap, res_full, p * 64, key0 + w * WG_ROWS,
                      bh);
        }
    }
    int s = 0;
    uint32_t ph = 1;
    for (int t = 0; t < tiles; ++t) {
      const uint32_t st = ring + s * C::STAGE, bar = full + 8 * s;
      float* rs = rows + 2 * BQ * s;
      mbar_wait(empty + 8 * s, ph);
      for (int i = lane; i < BQ; i += 32) {
        const int q = t * BQ + i;
        const bool ok = q < nq;
        rs[i] = ok ? lse[(size_t)bh * nq + q] * LOG2E : INFINITY;
        rs[BQ + i] = ok ? delta[(size_t)bh * nq + q] : 0.f;
      }
      if (lane == 0) {
        mbar_expect_tx(bar, C::STAGE);
        for (int p = 0; p < C::PANELS; ++p) {
          tma_load_3d(st + p * C::Q_PANEL, &qmap, bar, p * 64, t * BQ, bh);
          tma_load_3d(st + C::Q_BYTES + p * C::Q_PANEL, &domap, bar, p * 64,
                      t * BQ, bh);
        }
      } else {
        mbar_arrive(bar);
      }
      if (++s == stages) { s = 0; ph ^= 1; }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns key rows [64 wg, 64 wg + 64); the
  // accumulators' rows are keys, the score tiles' columns queries ----
  consumer_registers<WGS>();
  const int wg = warp >> 2, w4 = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t k_wg = k_s + wg * C::PANELS * C::PANEL;
  const uint32_t v_wg = v_s + wg * C::PANELS * C::PANEL;

  float dka[C::NP / 2], dva[C::NP / 2], sc[BQ / 2], dp[BQ / 2];
#pragma unroll
  for (int i = 0; i < C::NP / 2; ++i) dka[i] = dva[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BQ / 2; ++i) sc[i] = dp[i] = 0.f;
  uint32_t pa[BQ / 16][4], dsa[BQ / 16][4];
  const Turns<WGS> turns{wg};

  // S^T = K Q^T and dP^T = V dO^T, two commit groups
  auto issue_scores = [&](uint32_t st) {
#pragma unroll
    for (int kk = 0; kk < C::KSTEPS; ++kk) {
      const uint32_t off = (kk >> 2) * C::PANEL + (kk & 3) * 32;
      const uint32_t qoff = (kk >> 2) * C::Q_PANEL + (kk & 3) * 32;
      qk_step<BQ>(sc, desc_sw128(k_wg + off, 16, 1024),
                  desc_sw128(st + qoff, 16, 1024), kk > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < C::KSTEPS; ++kk) {
      const uint32_t off = (kk >> 2) * C::PANEL + (kk & 3) * 32;
      const uint32_t qoff = (kk >> 2) * C::Q_PANEL + (kk & 3) * 32;
      qk_step<BQ>(dp, desc_sw128(v_wg + off, 16, 1024),
                  desc_sw128(st + C::Q_BYTES + qoff, 16, 1024), kk > 0);
    }
    wgmma_commit();
  };
  // dV += P^T dO and dK += dS^T Q (dO's and Q's tiles MN-major, 16
  // queries = 2048 bytes a step), one commit group
  auto issue_dkv = [&](uint32_t st) {
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      mn_step<C::NP>(dva, pa[kk], st + C::Q_BYTES + kk * 2048, C::Q_PANEL);
      mn_step<C::NP>(dka, dsa[kk], st + kk * 2048, C::Q_PANEL);
    }
    wgmma_commit();
  };
  auto exp_p = [&](const float* rs) {
#pragma unroll
    for (int i = 0; i < BQ / 8; ++i) {
      const float2 l = *reinterpret_cast<const float2*>(rs + 8 * i + 2 * t);
      sc[4 * i] = ex2(fmaf(sc[4 * i], sl, -l.x));
      sc[4 * i + 1] = ex2(fmaf(sc[4 * i + 1], sl, -l.y));
      sc[4 * i + 2] = ex2(fmaf(sc[4 * i + 2], sl, -l.x));
      sc[4 * i + 3] = ex2(fmaf(sc[4 * i + 3], sl, -l.y));
    }
  };
  auto grad_s = [&](const float* rs) {
#pragma unroll
    for (int i = 0; i < BQ / 8; ++i) {
      const float2 e =
          *reinterpret_cast<const float2*>(rs + BQ + 8 * i + 2 * t);
      dp[4 * i] = sc[4 * i] * (dp[4 * i] - e.x);
      dp[4 * i + 1] = sc[4 * i + 1] * (dp[4 * i + 1] - e.y);
      dp[4 * i + 2] = sc[4 * i + 2] * (dp[4 * i + 2] - e.x);
      dp[4 * i + 3] = sc[4 * i + 3] * (dp[4 * i + 3] - e.y);
    }
  };

  // stage s holds tile j, stage ps tile j-1
  auto step = [&](auto next, int s, int ps) {
    const float* rs = rows + 2 * BQ * s;
    turns.begin();
    wgmma_fence();
    issue_scores(ring + s * C::STAGE);
    if constexpr (decltype(next)::value)
      issue_dkv(ring + ps * C::STAGE);  // tile j-1's products
    turns.end();
    if constexpr (decltype(next)::value) wgmma_wait<2>();  // S^T_j is done
    else wgmma_wait<1>();
    fence_regs(sc);
    exp_p(rs);
    if constexpr (decltype(next)::value) wgmma_wait<1>();  // dP^T_j is done
    else wgmma_wait<0>();
    fence_regs(dp);
    grad_s(rs);
    if constexpr (decltype(next)::value) {
      wgmma_wait<0>();  // tile j-1's A registers are free, its stage too
      fence_regs(dka);
      fence_regs(dva);
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        fence_regs(pa[kk]);
        fence_regs(dsa[kk]);
      }
      release(empty + 8 * ps, lane);
    }
    pack_a<BQ>(pa, sc);
    pack_a<BQ>(dsa, dp);
  };

  turns.first();
  mbar_wait(res_full, 0);
  mbar_wait(full, 0);
  step(First(), 0, 0);
  int s = 1, ps = 0;  // stages >= 2
  uint32_t ph = 0;
#pragma unroll 1
  for (int j = 1; j < tiles; ++j) {
    mbar_wait(full + 8 * s, ph);
    step(Next(), s, ps);
    ps = s;
    if (++s == stages) { s = 0; ph ^= 1; }
  }
  wgmma_fence();
  issue_dkv(ring + ps * C::STAGE);
  wgmma_wait<0>();
  fence_regs(dka);
  fence_regs(dva);
#pragma unroll
  for (int kk = 0; kk < BQ / 16; ++kk) {
    fence_regs(pa[kk]);
    fence_regs(dsa[kk]);
  }
  release(empty + 8 * ps, lane);
  turns.last();

  const int ra = key0 + wg * WG_ROWS + w4 * 16 + g, rb = ra + 8;
  const size_t oa = ((size_t)bh * nk + ra) * D + 2 * t, ob = oa + 8 * D;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    if (ra < nk) {
      *reinterpret_cast<__nv_bfloat162*>(dk + oa + 8 * i) =
          __floats2bfloat162_rn(dka[4 * i] * scale, dka[4 * i + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + oa + 8 * i) =
          __floats2bfloat162_rn(dva[4 * i], dva[4 * i + 1]);
    }
    if (rb < nk) {
      *reinterpret_cast<__nv_bfloat162*>(dk + ob + 8 * i) =
          __floats2bfloat162_rn(dka[4 * i + 2] * scale,
                                dka[4 * i + 3] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + ob + 8 * i) =
          __floats2bfloat162_rn(dva[4 * i + 2], dva[4 * i + 3]);
    }
  }
}

// A 3-D bf16 map {d, rows, bh} over a contiguous [bh, rows, d] tensor,
// box {64, box_rows, 1}.
int encode(CUtensorMap* map, const void* p, int d, int rows, int bh,
           int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows,
                              (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2,
                                 (cuuint64_t)d * rows * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  return encode_bf16_map(map, p, 3, dims, strides, box);
}

template <typename Kern>
int prepare(Kern kern, int smem) {
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <int D, int BN, int WGS>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int bh, int nq,
              int nk, int stages, float scale, cudaStream_t stream) {
  typedef DqCfg<D, BN, WGS> C;
  if (nk % BN != 0 || stages < 2 || stages > MAX_STAGES ||
      C::smem(stages) > SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  CUtensorMap qmap, domap, kmap, vmap;
  int rc = encode(&qmap, q, D, nq, bh, WG_ROWS);
  if (rc == 0) rc = encode(&domap, dout, D, nq, bh, WG_ROWS);
  if (rc == 0) rc = encode(&kmap, k, D, nk, bh, BN);
  if (rc == 0) rc = encode(&vmap, v, D, nk, bh, BN);
  if (rc != 0) return rc;
  auto kern = flash_bwd_dq_kernel<D, BN, WGS>;
  if ((rc = prepare(kern, C::smem(stages))) != 0) return rc;
  const dim3 grid((nq + WGS * WG_ROWS - 1) / (WGS * WG_ROWS), bh);
  kern<<<grid, C::THREADS, C::smem(stages), stream>>>(
      qmap, domap, kmap, vmap, lse, delta, static_cast<bf16*>(dq), nq, nk,
      stages, scale * LOG2E, scale);
  return (int)cudaGetLastError();
}

template <int D, int BQ, int WGS>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dk, void* dv,
               int bh, int nq, int nk, int stages, float scale,
               cudaStream_t stream) {
  typedef DkvCfg<D, BQ, WGS> C;
  if (stages < 2 || stages > MAX_STAGES || C::smem(stages) > SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  CUtensorMap kmap, vmap, qmap, domap;
  int rc = encode(&kmap, k, D, nk, bh, WG_ROWS);
  if (rc == 0) rc = encode(&vmap, v, D, nk, bh, WG_ROWS);
  if (rc == 0) rc = encode(&qmap, q, D, nq, bh, BQ);
  if (rc == 0) rc = encode(&domap, dout, D, nq, bh, BQ);
  if (rc != 0) return rc;
  auto kern = flash_bwd_dkv_kernel<D, BQ, WGS>;
  if ((rc = prepare(kern, C::smem(stages))) != 0) return rc;
  const dim3 grid((nk + WGS * WG_ROWS - 1) / (WGS * WG_ROWS), bh);
  kern<<<grid, C::THREADS, C::smem(stages), stream>>>(
      kmap, vmap, qmap, domap, lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), nq, nk, stages, scale * LOG2E, scale);
  return (int)cudaGetLastError();
}

template <int D>
int dq_d(const void* q, const void* k, const void* v, const void* dout,
         const float* lse, const float* delta, void* dq, int bh, int nq,
         int nk, int bn, int stages, int wgs, float scale, cudaStream_t s) {
  if (bn == 64 && wgs == 1)
    return launch_dq<D, 64, 1>(q, k, v, dout, lse, delta, dq, bh, nq, nk,
                               stages, scale, s);
  if (bn == 64 && wgs == 2)
    return launch_dq<D, 64, 2>(q, k, v, dout, lse, delta, dq, bh, nq, nk,
                               stages, scale, s);
  if (bn == 128 && wgs == 1)
    return launch_dq<D, 128, 1>(q, k, v, dout, lse, delta, dq, bh, nq, nk,
                                stages, scale, s);
  if (bn == 128 && wgs == 2)
    return launch_dq<D, 128, 2>(q, k, v, dout, lse, delta, dq, bh, nq, nk,
                                stages, scale, s);
  return (int)cudaErrorInvalidValue;
}

template <int D>
int dkv_d(const void* q, const void* k, const void* v, const void* dout,
          const float* lse, const float* delta, void* dk, void* dv, int bh,
          int nq, int nk, int bq, int stages, int wgs, float scale,
          cudaStream_t s) {
  if (bq == 64 && wgs == 1)
    return launch_dkv<D, 64, 1>(q, k, v, dout, lse, delta, dk, dv, bh, nq,
                                nk, stages, scale, s);
  if (bq == 64 && wgs == 2)
    return launch_dkv<D, 64, 2>(q, k, v, dout, lse, delta, dk, dv, bh, nq,
                                nk, stages, scale, s);
  return (int)cudaErrorInvalidValue;
}

bool bad_shape(int bh, int nq, int nk) {
  return bh <= 0 || bh > 65535 || nq <= 0 || nk <= 0 || nk % 64 != 0;
}

}  // namespace

extern "C" {

// q/k/v/dout/dq: contiguous [bh, n, d] bf16; lse, delta: contiguous
// [bh, nq] f32; all 16-byte aligned on the current device.  The tile: bn
// keys (64 or 128, dividing nk), a ring of `stages` (2..4), wgs (1 or 2)
// consumer warpgroups of 64 query rows.  Returns 0, a cudaError_t code
// (launch errors included) or a tensor-map error.
int fgdm_flash_attn_bwd_dq(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse,
                           const void* delta, void* dq, int bh, int nq,
                           int nk, int d, int bn, int stages, int wgs,
                           float scale, void* stream) {
  if (bad_shape(bh, nq, nk)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  switch (d) {
    case 40: return dq_d<40>(q, k, v, dout, l, dl, dq, bh, nq, nk, bn,
                             stages, wgs, scale, s);
    case 80: return dq_d<80>(q, k, v, dout, l, dl, dq, bh, nq, nk, bn,
                             stages, wgs, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// q/k/v/dout/dk/dv, lse, delta as above.  The tile: bq queries (64), a
// ring of `stages` (2..4), wgs (1 or 2) consumer warpgroups of 64 key rows.
// Returns as above.
int fgdm_flash_attn_bwd_dkv(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dk, void* dv, int bh,
                            int nq, int nk, int d, int bq, int stages,
                            int wgs, float scale, void* stream) {
  if (bad_shape(bh, nq, nk)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  switch (d) {
    case 40: return dkv_d<40>(q, k, v, dout, l, dl, dk, dv, bh, nq, nk, bq,
                              stages, wgs, scale, s);
    case 80: return dkv_d<80>(q, k, v, dout, l, dl, dk, dv, bh, nq, nk, bq,
                              stages, wgs, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The least key tile of both kernels for head dim d (nk must be a
// multiple), 0 if the head dim has no instantiation.
int fgdm_flash_attn_bwd_block_n(int d) {
  switch (d) {
    case 40: case 80: return 64;
    default: return 0;
  }
}

const char* fgdm_cuda_error_string(int code) { return error_string(code); }

}  // extern "C"
