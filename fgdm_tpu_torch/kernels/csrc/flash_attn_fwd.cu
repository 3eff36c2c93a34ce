// Flash-attention forward at the UNet's head dims (40, 80) for Hopper
// (sm_90a), bf16 in / bf16 out, with the optional logsumexp output that the
// backward reads.
//
// Replaces the Pallas TPU kernel fgdm_tpu/kernels/attention.py:157
// _flash_kernel_t (pallas_call at :257), the transposed-layout kernel for
// d <= 96 of the UNet and ControlNet heads.  The transposed layout was for
// the TPU's lane padding and has no counterpart here.  The d = 512 kernels
// of the VAE mid-block are replaced by flash_attn_fwd_d512.cu.
//
// It computes softmax(q k^T * scale) v with an online softmax, so no N x N
// matrix reaches device memory.  Numerics follow the plain version
// (_xla_attention, attention.py:63-71): f32 scores and statistics, P rounded
// to bf16 before P.V, f32 accumulation, one division by the row sum at the
// end; lse is the natural-log logsumexp of the scaled scores.
//
// What bounds it on the card.  Per score the two products do 4*d tensor
// operations (160 at d = 40, 320 at d = 80) and the softmax one exp.  The
// H100's 989 TFLOP/s of bf16 against ~3.9e12 exp/s on the special-function
// units (16 a clock per SM x 132 SMs x ~1.83 GHz) make d = 40 exp-bound
// (the exps take 1.6x the products' time) and d = 80 about even (0.8x).
// Bytes (8*N*d per head) are far below either.  So the softmax has to run
// while the tensor cores work, and the design is built around that:
//
//   * A block owns 64 query rows per consumer warpgroup (WGS, 1 or 2) of
//     one (batch, head).  Q is loaded once by TMA and stays.  K and V tiles
//     of BN keys (64 or 128) come by TMA into a ring of 2-4 stages behind
//     full/empty mbarriers, filled by one producer warp.  TMA's zero fill
//     pads d to the contraction width (columns past d of the 64-column box)
//     and fills the rows of a ragged last query tile; the stores of O and
//     lse are masked there.
//   * S = Q K^T runs on wgmma m64n{BN}k16 with both operands K-major in
//     shared memory (128-byte swizzle, 64-column panels): 3 k16 steps at
//     d = 40 (48 columns, 40..47 zero), 5 at d = 80 (four in the first
//     panel, one in the second).
//   * O += P V runs on wgmma m64n{d}k16 with P from registers: the score
//     accumulators, rounded to bf16, already have the A-fragment layout, so
//     nothing of S or P goes through shared memory.  V's B operand has to
//     be N = d wide.  An MN-major B straight from V [keys][d] would read a
//     40- or 80-wide slice of a 64-wide swizzle atom, while the canonical
//     MN-major layouts tile N in whole atoms (that form is untried); zero
//     padding N to 64/128 would waste 38-60 % of the P.V work.  So the
//     wrapper lays V out as V^T [bh, d, nk] (one copy, like the
//     .contiguous() that multihead_attention already makes) and B is
//     K-major: d rows of 64 contiguous keys per panel, the same layout as
//     K's, at N = 40 or 80 exactly.
//   * The softmax runs on the accumulators in registers: base 2, with
//     scale * log2(e) folded into one FFMA per score before ex2.approx, row
//     max and row sum shared by quad shuffles.
//   * Overlap inside a warpgroup: the Q K^T of tile j is issued together
//     with the P V of tile j-1; the warpgroup waits only for the former
//     (wgmma_wait<1>) and runs tile j's softmax while the latter runs, then
//     rescales O once P V is done.
//   * Overlap across warpgroups (WGS = 2): named barriers hand the turn to
//     issue wgmmas from one warpgroup to the other, so one warpgroup's
//     softmax runs while the other's products run.
//
// The host (kernels/attention.py flash_fwd_plan) picks BN, the stages and
// WGS per shape; chip_smoke.py --sweep times the choices.  No atomics, no
// split of the keys across blocks: reruns are bit-identical.
//
// On an H100 SXM at 700 W (chip_smoke.py): 128 keys x 2 stages x 2
// warpgroups, 146 registers at d = 40 and 166 at d = 80, no spills, 71,680
// and 141,312 B of shared memory, one block an SM; 0.160 ms at
// [2,8,4096,40] and 0.613 ms at [8,8,4096,40], 43-45 % of the exp bound and
// level with SDPA; at N = 1024 (8 key tiles a block) the block's start and
// end are not hidden: 25-29 % of the exp bound at d = 40, 20-22 % of the
// tensor bound at d = 80.  Tried and dropped (chip_smoke.py's K1 sweep):
// three consumer warpgroups at d = 40 (192 rows a block, 126 registers
// under the 416-thread bound with 176 B of spills) took 0.211 / 0.749 ms
// at those two shapes; rings of 3-4 stages are within 1 % of 2; 64-key
// tiles (6-18 %) and one warpgroup (4-37 %) are slower at every swept
// shape.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace fgdm;

constexpr int WG_ROWS = 64;        // query rows of one consumer warpgroup
constexpr int MAX_STAGES = 4;      // K/V ring depth the header has room for
constexpr int HEADER = 1024;       // the mbarriers, ahead of the tiles
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory a block may use
constexpr float LN2 = 0.6931471805599453f;

template <int D, int BN, int WGS>
struct Cfg {
  static constexpr int PANELS = (D + 63) / 64;  // 64-column panels of Q, K
  static constexpr int KSTEPS = (D + 15) / 16;  // k16 steps of Q K^T
  static constexpr int Q_PANEL = WG_ROWS * 128;  // bytes
  static constexpr int Q_BYTES = WGS * PANELS * Q_PANEL;
  static constexpr int K_PANEL = BN * 128;
  static constexpr int K_BYTES = PANELS * K_PANEL;
  static constexpr int V_PANEL = D * 128;  // V^T: d rows of 64 keys
  static constexpr int V_BYTES = (BN / 64) * V_PANEL;
  static constexpr int STAGE = K_BYTES + V_BYTES;
  static constexpr int THREADS = WGS * 128 + 32;
  static constexpr int smem(int stages) {
    return 1024 + HEADER + Q_BYTES + stages * STAGE;
  }
  static_assert(D % 8 == 0 && D <= 128, "head dim");
  static_assert(WGS == 1 || WGS == 2, "consumer warpgroups");
  static_assert(BN == 64 || BN == 128, "keys per tile");
  static_assert(V_PANEL % 1024 == 0, "swizzled tiles start 1024-aligned");
};

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// q/k as 3-D maps {d, n, bh} with boxes {64, 64, 1} and {64, BN, 1}; vt
// (V^T) as {nk, d, bh} with box {64, d, 1}.  o [bh, nq, d] bf16; lse
// [bh, nq] f32 or null.  sl = scale * log2 e.
template <int D, int BN, int WGS>
__global__ void __launch_bounds__(WGS * 128 + 32, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap,
                 bf16* __restrict__ o, float* __restrict__ lse, int nq,
                 int nk, int stages, float sl) {
  typedef Cfg<D, BN, WGS> C;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_full = base;
  const uint32_t k_full = base + 8, k_empty = k_full + 8 * MAX_STAGES;
  const uint32_t v_full = k_empty + 8 * MAX_STAGES;
  const uint32_t v_empty = v_full + 8 * MAX_STAGES;
  const uint32_t q_s = base + HEADER;
  const uint32_t ring = q_s + C::Q_BYTES;  // stage i: K, then V^T

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int row0 = blockIdx.x * WGS * WG_ROWS;
  const int bh = blockIdx.y;
  const int tiles = nk / BN;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int i = 0; i < stages; ++i) {
      mbar_init(k_full + 8 * i, 1);
      mbar_init(v_full + 8 * i, 1);
      mbar_init(k_empty + 8 * i, 4 * WGS);  // one arrival per consumer warp
      mbar_init(v_empty + 8 * i, 4 * WGS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4 * WGS) {
    // ---- producer ----
    if (lane == 0) {
      mbar_expect_tx(q_full, C::Q_BYTES);
      for (int w = 0; w < WGS; ++w)
        for (int p = 0; p < C::PANELS; ++p)
          tma_load_3d(q_s + (w * C::PANELS + p) * C::Q_PANEL, &qmap, q_full,
                      p * 64, row0 + w * WG_ROWS, bh);
      int s = 0;
      uint32_t ph = 1;
      for (int t = 0; t < tiles; ++t) {
        const uint32_t st = ring + s * C::STAGE;
        mbar_wait(k_empty + 8 * s, ph);
        mbar_expect_tx(k_full + 8 * s, C::K_BYTES);
        for (int p = 0; p < C::PANELS; ++p)
          tma_load_3d(st + p * C::K_PANEL, &kmap, k_full + 8 * s, p * 64,
                      t * BN, bh);
        mbar_wait(v_empty + 8 * s, ph);
        mbar_expect_tx(v_full + 8 * s, C::V_BYTES);
        for (int c = 0; c < BN / 64; ++c)
          tma_load_3d(st + C::K_BYTES + c * C::V_PANEL, &vmap, v_full + 8 * s,
                      t * BN + c * 64, 0, bh);
        if (++s == stages) { s = 0; ph ^= 1; }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns query rows [64 wg, 64 wg + 64) of the
  // block; this thread rows 16 w4 + g and + 8 of them.  In the wgmma D
  // layout acc[4i], acc[4i+1] are row g at columns 8i + 2t and + 1,
  // acc[4i+2], acc[4i+3] row g + 8 (the same for sc over keys). ----
  const int wg = warp >> 2, w4 = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t q_wg = q_s + wg * C::PANELS * C::Q_PANEL;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float sc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) sc[i] = 0.f;
  uint32_t pa[BN / 16][4];
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  // Warpgroup w issues its wgmmas between bar.sync(1 + w) and the arrival
  // at the next warpgroup's barrier: the turns go round.
  auto turn_begin = [&] {
    if (WGS > 1) named_bar_sync(1 + wg, 256);
  };
  auto turn_end = [&] {
    if (WGS > 1) named_bar_arrive(1 + (wg + 1) % WGS, 256);
  };
  auto issue_qk = [&](uint32_t k_s) {
#pragma unroll
    for (int kk = 0; kk < C::KSTEPS; ++kk) {
      const uint32_t off = (kk & 3) * 32;
      qk_step<BN>(sc,
                  desc_sw128(q_wg + (kk >> 2) * C::Q_PANEL + off, 16, 1024),
                  desc_sw128(k_s + (kk >> 2) * C::K_PANEL + off, 16, 1024),
                  kk > 0);
    }
    wgmma_commit();
  };
  auto issue_pv = [&](uint32_t v_s) {
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      pv_step<D>(acc, pa[kk],
                 desc_sw128(v_s + (kk >> 2) * C::V_PANEL + (kk & 3) * 32, 16,
                            1024));
    wgmma_commit();
  };
  auto release = [&](uint32_t bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  // Online softmax of the tile in sc (raw q.k), in base 2: sc becomes
  // exp2(sc * sl - m), the row statistics move on, and alpha0/alpha1 are set
  // to the factors by which the output accumulated so far is rescaled.
  auto softmax = [&](float& alpha0, float& alpha1) {
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
    const float mn0 = fmaxf(m0, quad_max(mx0) * sl);
    const float mn1 = fmaxf(m1, quad_max(mx1) * sl);
    alpha0 = ex2(m0 - mn0);
    alpha1 = ex2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      sc[4 * j] = ex2(fmaf(sc[4 * j], sl, -mn0));
      sc[4 * j + 1] = ex2(fmaf(sc[4 * j + 1], sl, -mn0));
      sc[4 * j + 2] = ex2(fmaf(sc[4 * j + 2], sl, -mn1));
      sc[4 * j + 3] = ex2(fmaf(sc[4 * j + 3], sl, -mn1));
      sum0 += sc[4 * j] + sc[4 * j + 1];
      sum1 += sc[4 * j + 2] + sc[4 * j + 3];
    }
    l0 = l0 * alpha0 + sum0;  // this thread's share; the quad adds up below
    l1 = l1 * alpha1 + sum1;
  };
  // P as A fragments, one k16 step per 16 keys.
  auto pack_p = [&] {
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
      fence_regs(pa[kk]);
    }
  };

  if (WGS > 1 && wg == WGS - 1) named_bar_arrive(1, 256);  // 0 goes first
  mbar_wait(q_full, 0);

  // tile 0: S, softmax, P
  int ks = 0, vs = 0;          // ring stages of tile j's K and tile j-1's V
  uint32_t kph = 0, vph = 0;
  float alpha0, alpha1;
  mbar_wait(k_full, 0);
  turn_begin();
  wgmma_fence();
  issue_qk(ring);
  turn_end();
  wgmma_wait<0>();
  fence_regs(sc);
  release(k_empty);
  softmax(alpha0, alpha1);
  pack_p();
  if (++ks == stages) { ks = 0; kph ^= 1; }

#pragma unroll 1
  for (int j = 1; j < tiles; ++j) {
    mbar_wait(k_full + 8 * ks, kph);
    mbar_wait(v_full + 8 * vs, vph);
    turn_begin();
    wgmma_fence();
    issue_qk(ring + ks * C::STAGE);                // S_j = Q K_j^T
    issue_pv(ring + vs * C::STAGE + C::K_BYTES);   // O += P_{j-1} V_{j-1}
    turn_end();
    wgmma_wait<1>();  // S_j is done; P V runs on
    fence_regs(sc);
    release(k_empty + 8 * ks);
    softmax(alpha0, alpha1);
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(sc);  // P's registers are rewritten only after the wait
    release(v_empty + 8 * vs);
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      acc[4 * i] *= alpha0;
      acc[4 * i + 1] *= alpha0;
      acc[4 * i + 2] *= alpha1;
      acc[4 * i + 3] *= alpha1;
    }
    fence_regs(acc);  // ... and written before the next wgmma_fence
    pack_p();
    if (++ks == stages) { ks = 0; kph ^= 1; }
    if (++vs == stages) { vs = 0; vph ^= 1; }
  }

  // the last tile's P V
  mbar_wait(v_full + 8 * vs, vph);
  wgmma_fence();
  issue_pv(ring + vs * C::STAGE + C::K_BYTES);
  wgmma_wait<0>();
  fence_regs(acc);
  release(v_empty + 8 * vs);
  // the last warpgroup's last turn_end arrived at barrier 1 with no one
  // waiting
  if (WGS > 1 && wg == 0) named_bar_sync(1, 256);

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const int ra = row0 + wg * WG_ROWS + w4 * 16 + g, rb = ra + 8;
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  bf16* oa = o + ((size_t)bh * nq + ra) * D + 2 * t;
  bf16* ob = oa + 8 * D;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    if (ra < nq)
      *reinterpret_cast<__nv_bfloat162*>(oa + 8 * i) =
          __floats2bfloat162_rn(acc[4 * i] * inv0, acc[4 * i + 1] * inv0);
    if (rb < nq)
      *reinterpret_cast<__nv_bfloat162*>(ob + 8 * i) =
          __floats2bfloat162_rn(acc[4 * i + 2] * inv1, acc[4 * i + 3] * inv1);
  }
  if (lse != nullptr && t == 0) {
    if (ra < nq) lse[(size_t)bh * nq + ra] = (m0 + log2f(l0)) * LN2;
    if (rb < nq) lse[(size_t)bh * nq + rb] = (m1 + log2f(l1)) * LN2;
  }
}

int encode(CUtensorMap* map, const void* p, int inner, int rows, int bh,
           int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)rows,
                              (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)inner * 2,
                                 (cuuint64_t)inner * rows * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  return encode_bf16_map(map, p, 3, dims, strides, box);
}

template <int D, int BN, int WGS>
int launch(const void* q, const void* k, const void* vt, void* o, void* lse,
           int bh, int nq, int nk, int stages, float scale,
           cudaStream_t stream) {
  typedef Cfg<D, BN, WGS> C;
  if (nk % BN != 0 || stages < 2 || stages > MAX_STAGES ||
      C::smem(stages) > SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  CUtensorMap qmap, kmap, vmap;
  int rc = encode(&qmap, q, D, nq, bh, WG_ROWS);
  if (rc == 0) rc = encode(&kmap, k, D, nk, bh, BN);
  if (rc == 0) rc = encode(&vmap, vt, nk, D, bh, D);
  if (rc != 0) return rc;
  auto kern = flash_fwd_kernel<D, BN, WGS>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::smem(stages));
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((nq + WGS * WG_ROWS - 1) / (WGS * WG_ROWS), bh);
  kern<<<grid, C::THREADS, C::smem(stages), stream>>>(
      qmap, kmap, vmap, static_cast<bf16*>(o), static_cast<float*>(lse), nq,
      nk, stages, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

template <int D>
int launch_d(const void* q, const void* k, const void* vt, void* o,
             void* lse, int bh, int nq, int nk, int bn, int stages, int wgs,
             float scale, cudaStream_t s) {
  if (bn == 64 && wgs == 1)
    return launch<D, 64, 1>(q, k, vt, o, lse, bh, nq, nk, stages, scale, s);
  if (bn == 64 && wgs == 2)
    return launch<D, 64, 2>(q, k, vt, o, lse, bh, nq, nk, stages, scale, s);
  if (bn == 128 && wgs == 1)
    return launch<D, 128, 1>(q, k, vt, o, lse, bh, nq, nk, stages, scale, s);
  if (bn == 128 && wgs == 2)
    return launch<D, 128, 2>(q, k, vt, o, lse, bh, nq, nk, stages, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q/k: contiguous [bh, n, d] bf16; vt: V transposed, contiguous [bh, d, nk]
// bf16; o: [bh, nq, d] bf16; all 16-byte aligned on the current device.
// lse: null, or contiguous [bh, nq] f32 that receives the logsumexp of each
// query row's scaled scores.  The tile: bn keys (64 or 128, dividing nk),
// a ring of `stages` (2..4) K/V tiles, wgs (1 or 2) consumer warpgroups of
// 64 query rows.  Returns 0, a cudaError_t code (launch errors included) or
// a tensor-map error.
int fgdm_flash_attn_fwd(const void* q, const void* k, const void* vt,
                        void* o, void* lse, int bh, int nq, int nk, int d,
                        int bn, int stages, int wgs, float scale,
                        void* stream) {
  if (bh <= 0 || bh > 65535 || nq <= 0 || nk <= 0 || nk % 8 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 40: return launch_d<40>(q, k, vt, o, lse, bh, nq, nk, bn, stages,
                                 wgs, scale, s);
    case 80: return launch_d<80>(q, k, vt, o, lse, bh, nq, nk, bn, stages,
                                 wgs, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The least key tile for head dim d (nk must be a multiple), 0 if the head
// dim has no instantiation.
int fgdm_flash_attn_block_n(int d) {
  switch (d) {
    case 40: case 80: return 64;
    default: return 0;
  }
}

const char* fgdm_cuda_error_string(int code) { return error_string(code); }

}  // extern "C"
