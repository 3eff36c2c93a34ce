// Flash-attention backward for Hopper (sm_90a), bf16 in / bf16 out.
//
// Replaces the two Pallas TPU kernels of fgdm_tpu/kernels/attention.py:
//   _flash_bwd_dq_kernel_t  (:299)  dQ, one program per query block
//   _flash_bwd_dkv_kernel_t (:329)  dK and dV, one program per key block
// and computes their math (Dao 2022, §B) from the forward's residuals: the
// logsumexp of the scaled scores (lse, natural log) and
// delta = rowsum(dO * O), which the wrapper computes as one torch reduction,
// as the JAX package does in XLA (attention.py:390-393):
//   p  = exp(s * q k^T - lse)         dP = dO v^T
//   dS = p * (dP - delta)
//   dQ = s * dS k      dK = s * dS^T q      dV = p^T dO
// so no N x N matrix ever reaches device memory.
//
// Two kernels, as on the TPU, and no atomics: the dQ kernel's block owns BM
// query rows of one (batch, head) and streams K/V tiles; the dK/dV kernel's
// block owns BN key rows and streams Q/dO/lse/delta tiles.  Every output
// element is summed by one thread in a fixed order, so a rerun is
// bit-identical.
//
// Numerics match the forward kernel: S = Q K^T and dP = dO V^T on mma.sync
// m16n8k16 (bf16 operands, f32 accumulation); p and dS in f32, then cast to
// bf16 for the dV / dQ / dK products, which accumulate in f32; dQ, dK and dV
// are written in bf16.  Query rows at or past nq are masked (p = dS = 0, the
// counterpart of the TPU's lse = +inf padding) and never written.
//
// What bounds it on the card: dQ does 6*N^2*d and dK/dV 8*N^2*d operations
// against ~10*N*d bytes, so the tensor cores and exp() bound both.  This
// first version is simple rather than fast: mma.sync (not wgmma), no TMA,
// dS and P staged through shared memory, the operands a product needs
// transposed (K^T, Q^T, dO^T) copied transposed into shared memory, and
// S / dP recomputed in both kernels.
//
// The head dim is padded to a multiple of 16 for the contractions over d
// (d=40 -> 48) with zero-filled shared memory; the products that contract
// over keys or queries need only d % 8 == 0.  Columns past d are never
// written.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using namespace fgdm;

template <int D, int BM, int BN, int NW>
struct BwdCfg {
  static constexpr int DK = (D + 15) / 16 * 16;  // contraction over d, padded
  static constexpr int LD = DK + 8;              // row-major [rows][DK] tiles
  static constexpr int THREADS = NW * 32;
  static constexpr int ST = (BM / 16) * (BN / 8);  // 16x8 tiles of S and dP
  static_assert(D % 8 == 0, "head dim must be a multiple of 8");
  static_assert(BM % 16 == 0 && BN % 16 == 0, "tile sizes");
};

// One 16x8 tile (query rows mt*16.., keys nt*8..) of S = Q K^T and
// dP = dO V^T, from row-major Q/dO tiles and n-major (row-major [key][d])
// K/V tiles in shared memory.
template <int DK>
__device__ __forceinline__ void score_tiles(float s[4], float dp[4],
                                            const bf16* qs, const bf16* dos,
                                            const bf16* ks, const bf16* vs,
                                            int ld, int mt, int nt, int g,
                                            int t) {
#pragma unroll
  for (int i = 0; i < 4; ++i) s[i] = dp[i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DK; kk += 16) {
    uint32_t a[4], b[2];
    load_a(a, qs + mt * 16 * ld + kk, ld, g, t);
    load_b(b, ks + nt * 8 * ld + kk, ld, g, t);
    mma_16816(s, a, b);
    load_a(a, dos + mt * 16 * ld + kk, ld, g, t);
    load_b(b, vs + nt * 8 * ld + kk, ld, g, t);
    mma_16816(dp, a, b);
  }
}

// dQ: grid (ceil(nq / BM), bh).
template <int D, int BM, int BN, int NW>
__global__ void __launch_bounds__(NW * 32)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    int nq, int nk, float scale) {
  typedef BwdCfg<D, BM, BN, NW> C;
  constexpr int LDKT = BN + 8;  // K^T: [D][BN]
  constexpr int LDS = BN + 8;   // dS: [BM][BN]
  constexpr int OT = (BM / 16) * (D / 8);
  constexpr int OPW = OT / NW;
  static_assert(OT % NW == 0, "output tiles must split evenly over warps");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dos = qs + BM * C::LD;
  bf16* ks = dos + BM * C::LD;
  bf16* vs = ks + BN * C::LD;
  bf16* kt = vs + BN * C::LD;
  bf16* dss = kt + D * LDKT;
  float* lse_s = reinterpret_cast<float*>(dss + BM * LDS);
  float* delta_s = lse_s + BM;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  const int bh = blockIdx.y;
  const int row0 = blockIdx.x * BM;
  const int valid = nq - row0;
  const size_t qoff = ((size_t)bh * nq + row0) * D;
  const bf16* kg = k + (size_t)bh * nk * D;
  const bf16* vg = v + (size_t)bh * nk * D;

  load_rows<D, C::DK, C::THREADS>(qs, C::LD, q + qoff, BM, valid, tid);
  load_rows<D, C::DK, C::THREADS>(dos, C::LD, dout + qoff, BM, valid, tid);
  for (int r = tid; r < BM; r += C::THREADS) {
    const bool ok = r < valid;
    lse_s[r] = ok ? lse[(size_t)bh * nq + row0 + r] : 0.f;
    delta_s[r] = ok ? delta[(size_t)bh * nq + row0 + r] : 0.f;
  }

  float acc[OPW][4];
#pragma unroll
  for (int i = 0; i < OPW; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int kb = 0; kb < nk; kb += BN) {
    load_rows<D, C::DK, C::THREADS>(ks, C::LD, kg + (size_t)kb * D, BN, BN,
                                    tid);
    load_rows<D, C::DK, C::THREADS>(vs, C::LD, vg + (size_t)kb * D, BN, BN,
                                    tid);
    load_rows_t<D, C::THREADS>(kt, LDKT, kg + (size_t)kb * D, BN, BN, tid);
    __syncthreads();

    // dS = p * (dP - delta), one 16x8 tile per warp at a time, to shared
    // memory in bf16.  Rows past nq get 0.
    for (int st = warp; st < C::ST; st += NW) {
      const int mt = st / (BN / 8), nt = st % (BN / 8);
      float s[4], dp[4];
      score_tiles<C::DK>(s, dp, qs, dos, ks, vs, C::LD, mt, nt, g, t);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = mt * 16 + g + 8 * h;
        float ds0 = 0.f, ds1 = 0.f;
        if (r < valid) {
          const float l = lse_s[r], dl = delta_s[r];
          ds0 = __expf(s[2 * h] * scale - l) * (dp[2 * h] - dl);
          ds1 = __expf(s[2 * h + 1] * scale - l) * (dp[2 * h + 1] - dl);
        }
        *reinterpret_cast<__nv_bfloat162*>(dss + r * LDS + nt * 8 + 2 * t) =
            __floats2bfloat162_rn(ds0, ds1);
      }
    }
    __syncthreads();

    // dQ += dS K over this warp's output tiles.
#pragma unroll
    for (int i = 0; i < OPW; ++i) {
      const int ot = warp + i * NW;
      const int mt = ot / (D / 8), nt = ot % (D / 8);
#pragma unroll
      for (int kk = 0; kk < BN; kk += 16) {
        uint32_t a[4], b[2];
        load_a(a, dss + mt * 16 * LDS + kk, LDS, g, t);
        load_b(b, kt + nt * 8 * LDKT + kk, LDKT, g, t);
        mma_16816(acc[i], a, b);
      }
    }
    __syncthreads();
  }

  bf16* dqg = dq + qoff;
#pragma unroll
  for (int i = 0; i < OPW; ++i) {
    const int ot = warp + i * NW;
    const int mt = ot / (D / 8), nt = ot % (D / 8);
    const int r0 = mt * 16 + g, r1 = r0 + 8;
    const int col = nt * 8 + 2 * t;
    if (r0 < valid)
      *reinterpret_cast<__nv_bfloat162*>(dqg + (size_t)r0 * D + col) =
          __floats2bfloat162_rn(acc[i][0] * scale, acc[i][1] * scale);
    if (r1 < valid)
      *reinterpret_cast<__nv_bfloat162*>(dqg + (size_t)r1 * D + col) =
          __floats2bfloat162_rn(acc[i][2] * scale, acc[i][3] * scale);
  }
}

// dK, dV: grid (nk / BN, bh).
template <int D, int BM, int BN, int NW>
__global__ void __launch_bounds__(NW * 32)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int nq, int nk, float scale) {
  typedef BwdCfg<D, BM, BN, NW> C;
  constexpr int LDT = BM + 8;  // Q^T, dO^T: [D][BM]; P^T, dS^T: [BN][BM]
  constexpr int OT = (BN / 16) * (D / 8);
  constexpr int OPW = OT / NW;
  static_assert(OT % NW == 0, "output tiles must split evenly over warps");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + BN * C::LD;
  bf16* qs = vs + BN * C::LD;
  bf16* dos = qs + BM * C::LD;
  bf16* qt = dos + BM * C::LD;
  bf16* dot = qt + D * LDT;
  bf16* pt = dot + D * LDT;
  bf16* dst = pt + BN * LDT;
  float* lse_s = reinterpret_cast<float*>(dst + BN * LDT);
  float* delta_s = lse_s + BM;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  const int bh = blockIdx.y;
  const int col0 = blockIdx.x * BN;
  const size_t koff = ((size_t)bh * nk + col0) * D;
  const bf16* qg = q + (size_t)bh * nq * D;
  const bf16* dog = dout + (size_t)bh * nq * D;

  load_rows<D, C::DK, C::THREADS>(ks, C::LD, k + koff, BN, BN, tid);
  load_rows<D, C::DK, C::THREADS>(vs, C::LD, v + koff, BN, BN, tid);

  float acc_dk[OPW][4], acc_dv[OPW][4];
#pragma unroll
  for (int i = 0; i < OPW; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc_dk[i][j] = acc_dv[i][j] = 0.f;

  for (int qb = 0; qb < nq; qb += BM) {
    const int valid = nq - qb;
    load_rows<D, C::DK, C::THREADS>(qs, C::LD, qg + (size_t)qb * D, BM, valid,
                                    tid);
    load_rows<D, C::DK, C::THREADS>(dos, C::LD, dog + (size_t)qb * D, BM,
                                    valid, tid);
    load_rows_t<D, C::THREADS>(qt, LDT, qg + (size_t)qb * D, BM, valid, tid);
    load_rows_t<D, C::THREADS>(dot, LDT, dog + (size_t)qb * D, BM, valid, tid);
    for (int r = tid; r < BM; r += C::THREADS) {
      const bool ok = r < valid;
      lse_s[r] = ok ? lse[(size_t)bh * nq + qb + r] : 0.f;
      delta_s[r] = ok ? delta[(size_t)bh * nq + qb + r] : 0.f;
    }
    __syncthreads();

    // p and dS for this query tile, stored transposed ([key][query]) in
    // bf16: they are the A operands of dV = p^T dO and dK = dS^T q.
    for (int st = warp; st < C::ST; st += NW) {
      const int mt = st / (BN / 8), nt = st % (BN / 8);
      float s[4], dp[4];
      score_tiles<C::DK>(s, dp, qs, dos, ks, vs, C::LD, mt, nt, g, t);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = mt * 16 + g + 8 * h;
        const int c = nt * 8 + 2 * t;
        float p0 = 0.f, p1 = 0.f, ds0 = 0.f, ds1 = 0.f;
        if (r < valid) {
          const float l = lse_s[r], dl = delta_s[r];
          p0 = __expf(s[2 * h] * scale - l);
          p1 = __expf(s[2 * h + 1] * scale - l);
          ds0 = p0 * (dp[2 * h] - dl);
          ds1 = p1 * (dp[2 * h + 1] - dl);
        }
        pt[c * LDT + r] = __float2bfloat16(p0);
        pt[(c + 1) * LDT + r] = __float2bfloat16(p1);
        dst[c * LDT + r] = __float2bfloat16(ds0);
        dst[(c + 1) * LDT + r] = __float2bfloat16(ds1);
      }
    }
    __syncthreads();

    // dV += p^T dO and dK += dS^T q over this warp's output tiles.
#pragma unroll
    for (int i = 0; i < OPW; ++i) {
      const int ot = warp + i * NW;
      const int mt = ot / (D / 8), nt = ot % (D / 8);
#pragma unroll
      for (int kk = 0; kk < BM; kk += 16) {
        uint32_t a[4], b[2];
        load_a(a, pt + mt * 16 * LDT + kk, LDT, g, t);
        load_b(b, dot + nt * 8 * LDT + kk, LDT, g, t);
        mma_16816(acc_dv[i], a, b);
        load_a(a, dst + mt * 16 * LDT + kk, LDT, g, t);
        load_b(b, qt + nt * 8 * LDT + kk, LDT, g, t);
        mma_16816(acc_dk[i], a, b);
      }
    }
    __syncthreads();
  }

  bf16* dkg = dk + koff;
  bf16* dvg = dv + koff;
#pragma unroll
  for (int i = 0; i < OPW; ++i) {
    const int ot = warp + i * NW;
    const int mt = ot / (D / 8), nt = ot % (D / 8);
    const int col = nt * 8 + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const size_t off = (size_t)(mt * 16 + g + 8 * h) * D + col;
      *reinterpret_cast<__nv_bfloat162*>(dkg + off) = __floats2bfloat162_rn(
          acc_dk[i][2 * h] * scale, acc_dk[i][2 * h + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dvg + off) =
          __floats2bfloat162_rn(acc_dv[i][2 * h], acc_dv[i][2 * h + 1]);
    }
  }
}

template <int D, int BM, int BN>
constexpr size_t dq_smem() {
  typedef BwdCfg<D, BM, BN, 4> C;
  return sizeof(bf16) * (size_t)(2 * BM * C::LD + 2 * BN * C::LD +
                                 D * (BN + 8) + BM * (BN + 8)) +
         sizeof(float) * 2 * BM;
}

template <int D, int BM, int BN>
constexpr size_t dkv_smem() {
  typedef BwdCfg<D, BM, BN, 4> C;
  return sizeof(bf16) * (size_t)(2 * BN * C::LD + 2 * BM * C::LD +
                                 2 * D * (BM + 8) + 2 * BN * (BM + 8)) +
         sizeof(float) * 2 * BM;
}

bool bad_shape(int bh, int nq, int nk, int bn) {
  return nk % bn != 0 || nq <= 0 || nk <= 0 || bh <= 0 || bh > 65535;
}

template <int D, int BM, int BN, int NW>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int bh, int nq,
              int nk, float scale, cudaStream_t stream) {
  if (bad_shape(bh, nq, nk, BN)) return (int)cudaErrorInvalidValue;
  constexpr size_t smem = dq_smem<D, BM, BN>();
  auto kern = flash_bwd_dq_kernel<D, BM, BN, NW>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((nq + BM - 1) / BM, bh);
  kern<<<grid, NW * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, delta,
      static_cast<bf16*>(dq), nq, nk, scale);
  return (int)cudaGetLastError();
}

template <int D, int BM, int BN, int NW>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dk, void* dv,
               int bh, int nq, int nk, float scale, cudaStream_t stream) {
  if (bad_shape(bh, nq, nk, BN)) return (int)cudaErrorInvalidValue;
  constexpr size_t smem = dkv_smem<D, BM, BN>();
  auto kern = flash_bwd_dkv_kernel<D, BM, BN, NW>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(nk / BN, bh);
  kern<<<grid, NW * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, delta,
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), nq, nk, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q/k/v/dout/dq/dk/dv: contiguous [bh, n, d] bf16 on the current device,
// 16-byte aligned; lse and delta: contiguous [bh, nq] f32.  nk must be a
// multiple of fgdm_flash_attn_bwd_block_n(d).  Each returns 0 or a
// cudaError_t code (launch errors included).
int fgdm_flash_attn_bwd_dq(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse,
                           const void* delta, void* dq, int bh, int nq,
                           int nk, int d, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  switch (d) {
    case 40: return launch_dq<40, 64, 64, 4>(q, k, v, dout, l, dl, dq, bh, nq, nk, scale, s);
    case 80: return launch_dq<80, 64, 64, 4>(q, k, v, dout, l, dl, dq, bh, nq, nk, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int fgdm_flash_attn_bwd_dkv(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dk, void* dv, int bh,
                            int nq, int nk, int d, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  switch (d) {
    case 40: return launch_dkv<40, 64, 64, 4>(q, k, v, dout, l, dl, dk, dv, bh, nq, nk, scale, s);
    case 80: return launch_dkv<80, 64, 64, 4>(q, k, v, dout, l, dl, dk, dv, bh, nq, nk, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Keys per tile of both kernels for head dim d (nk must be a multiple), 0
// if the head dim has no instantiation.
int fgdm_flash_attn_bwd_block_n(int d) {
  switch (d) {
    case 40: case 80: return 64;
    default: return 0;
  }
}

const char* fgdm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
