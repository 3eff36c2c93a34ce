// Flash-attention forward at the UNet's head dims (40, 80) for Hopper
// (sm_90a), bf16 in / bf16 out.
//
// Replaces the Pallas TPU kernel fgdm_tpu/kernels/attention.py:157
// _flash_kernel_t (pallas_call at :257), the transposed-layout kernel for
// d <= 96 of the UNet and ControlNet heads.  The transposed layout was for
// the TPU's lane padding and has no counterpart here.  The two d = 512
// kernels of the VAE mid-block, _flash_kernel (:121) and _flash_kernel_kv
// (:516), are replaced by flash_attn_fwd_d512.cu.
//
// The kernel computes softmax(q k^T * scale) v: each block owns BM query
// rows of one (batch, head) and streams K/V tiles of BN keys through shared
// memory with an online softmax, so no N x N matrix ever reaches device
// memory.  It optionally writes the logsumexp of the scaled scores, the
// residual of the backward.
//
// Numerics follow the plain version (_xla_attention, attention.py:63-71):
// scores and softmax statistics in f32, P cast to bf16 before P.V, f32
// accumulation of the output, one division by the row sum at the end.
//
// What bounds it on the card: the two products are 4*N^2*d operations
// against 8*N*d bytes, far above the H100's ~295 op/byte ridge, so the
// tensor cores and the exp() unit bound it.  The kernel reaches a few
// percent of that bound: it multiplies with mma.sync m16n8k16 on fragments
// read by 32-bit shared loads, stages the scores and P through shared
// memory behind block-wide barriers and loads synchronously.  The d = 512
// kernel's design (wgmma, TMA tiles behind mbarriers, P kept in registers)
// is the way up for this one too.  The output accumulator lives in
// registers; each warp owns a fixed set of 16x8 output tiles.
//
// The head dim is padded to a multiple of 16 for the q.k contraction with
// zero-filled shared memory (d=40 -> 48); the P.V product needs only a
// multiple of 8, which every instantiated d is.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using namespace fgdm;

template <int D, int BM, int BN, int NW>
struct Cfg {
  static constexpr int DK = (D + 15) / 16 * 16;  // q.k contraction, padded
  static constexpr int LDQ = DK + 8;             // bf16 row strides (+16 B
  static constexpr int LDK = DK + 8;             //  against bank conflicts)
  static constexpr int LDV = BN + 8;             // V^T: [D][BN]
  static constexpr int LDS = BN + 4;             // f32 scores
  static constexpr int LDP = BN + 8;             // bf16 probabilities
  static constexpr int MT = BM / 16;             // 16-row tiles
  static constexpr int ST = MT * (BN / 8);       // 16x8 score tiles
  static constexpr int OT = MT * (D / 8);        // 16x8 output tiles
  static constexpr int OT_PER_WARP = OT / NW;
  static constexpr int THREADS = NW * 32;
  static constexpr size_t SMEM =
      sizeof(bf16) * (size_t)(BM * LDQ + BN * LDK + D * LDV + BM * LDP) +
      sizeof(float) * (size_t)(BM * LDS + 3 * BM);
  static_assert(D % 8 == 0, "head dim must be a multiple of 8");
  static_assert(BM % 16 == 0 && BN % 16 == 0, "tile sizes");
  static_assert(OT % NW == 0, "output tiles must split evenly over warps");
};

template <int D, int BM, int BN, int NW>
__global__ void __launch_bounds__(NW * 32)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 float* __restrict__ lse, int nq, int nk, float scale) {
  typedef Cfg<D, BM, BN, NW> C;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + BM * C::LDQ;
  bf16* vt = ks + BN * C::LDK;
  bf16* ps = vt + D * C::LDV;
  float* ss = reinterpret_cast<float*>(ps + BM * C::LDP);
  float* m_s = ss + BM * C::LDS;
  float* l_s = m_s + BM;
  float* alpha_s = l_s + BM;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // groupID of the mma fragment layouts
  const int t = lane & 3;   // thread in group

  const int bh = blockIdx.y;
  const int row0 = blockIdx.x * BM;
  const bf16* qg = q + ((size_t)bh * nq + row0) * D;
  const bf16* kg = k + (size_t)bh * nk * D;
  const bf16* vg = v + (size_t)bh * nk * D;

  // Q tile -> shared, zero-padded in rows (past nq) and columns (past D).
  load_rows<D, C::DK, C::THREADS>(qs, C::LDQ, qg, BM, nq - row0, tid);
  for (int r = tid; r < BM; r += C::THREADS) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
  }

  float acc[C::OT_PER_WARP][4];
#pragma unroll
  for (int i = 0; i < C::OT_PER_WARP; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int kb = 0; kb < nk; kb += BN) {
    // K tile (row-major, zero-padded columns) and V tile (transposed).
    load_rows<D, C::DK, C::THREADS>(ks, C::LDK, kg + (size_t)kb * D, BN, BN,
                                    tid);
    load_rows_t<D, C::THREADS>(vt, C::LDV, vg + (size_t)kb * D, BN, BN, tid);
    __syncthreads();

    // S = (Q K^T) * scale, one 16x8 tile per warp at a time.
    for (int st = warp; st < C::ST; st += NW) {
      const int mt = st / (BN / 8), nt = st % (BN / 8);
      float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < C::DK; kk += 16) {
        uint32_t a[4], b[2];
        load_a(a, qs + mt * 16 * C::LDQ + kk, C::LDQ, g, t);
        load_b(b, ks + nt * 8 * C::LDK + kk, C::LDK, g, t);
        mma_16816(c, a, b);
      }
      float* s0 = ss + (mt * 16 + g) * C::LDS + nt * 8 + 2 * t;
      float* s1 = s0 + 8 * C::LDS;
      s0[0] = c[0] * scale;
      s0[1] = c[1] * scale;
      s1[0] = c[2] * scale;
      s1[1] = c[3] * scale;
    }
    __syncthreads();

    // Online softmax: one warp per row, lanes across the BN keys.
    for (int r = warp; r < BM; r += NW) {
      const float* srow = ss + r * C::LDS;
      float mx = -INFINITY;
      for (int j = lane; j < BN; j += 32) mx = fmaxf(mx, srow[j]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < BN; j += 32) {
        const float p = __expf(srow[j] - m_new);
        sum += p;
        ps[r * C::LDP + j] = __float2bfloat16(p);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = __expf(m_old - m_new);
        alpha_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // O = O * alpha + P V over this warp's output tiles.
#pragma unroll
    for (int i = 0; i < C::OT_PER_WARP; ++i) {
      const int ot = warp + i * NW;
      const int mt = ot / (D / 8), nt = ot % (D / 8);
      const float a0 = alpha_s[mt * 16 + g];
      const float a1 = alpha_s[mt * 16 + g + 8];
      acc[i][0] *= a0;
      acc[i][1] *= a0;
      acc[i][2] *= a1;
      acc[i][3] *= a1;
#pragma unroll
      for (int kk = 0; kk < BN; kk += 16) {
        uint32_t a[4], b[2];
        load_a(a, ps + mt * 16 * C::LDP + kk, C::LDP, g, t);
        load_b(b, vt + nt * 8 * C::LDV + kk, C::LDV, g, t);
        mma_16816(acc[i], a, b);
      }
    }
    __syncthreads();
  }

  // The flash backward's residual: logsumexp of the scaled scores, in
  // natural-log units (the scores above are already scaled and p = exp(s - m)).
  if (lse != nullptr) {
    for (int r = tid; r < BM; r += C::THREADS)
      if (row0 + r < nq)
        lse[(size_t)bh * nq + row0 + r] = m_s[r] + logf(l_s[r]);
  }

  bf16* og = o + ((size_t)bh * nq + row0) * D;
#pragma unroll
  for (int i = 0; i < C::OT_PER_WARP; ++i) {
    const int ot = warp + i * NW;
    const int mt = ot / (D / 8), nt = ot % (D / 8);
    const int r0 = mt * 16 + g, r1 = r0 + 8;
    const int col = nt * 8 + 2 * t;
    if (row0 + r0 < nq) {
      const float inv = 1.f / l_s[r0];
      *reinterpret_cast<__nv_bfloat162*>(og + (size_t)r0 * D + col) =
          __floats2bfloat162_rn(acc[i][0] * inv, acc[i][1] * inv);
    }
    if (row0 + r1 < nq) {
      const float inv = 1.f / l_s[r1];
      *reinterpret_cast<__nv_bfloat162*>(og + (size_t)r1 * D + col) =
          __floats2bfloat162_rn(acc[i][2] * inv, acc[i][3] * inv);
    }
  }
}

template <int D, int BM, int BN, int NW>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int bh, int nq, int nk, float scale, cudaStream_t stream) {
  typedef Cfg<D, BM, BN, NW> C;
  if (nk % BN != 0 || nq <= 0 || nk <= 0 || bh <= 0 || bh > 65535)
    return (int)cudaErrorInvalidValue;
  auto kern = flash_fwd_kernel<D, BM, BN, NW>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((nq + BM - 1) / BM, bh);
  kern<<<grid, C::THREADS, C::SMEM, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, nq, nk, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q/k/v/o: contiguous [bh, n, d] bf16 on the current device, 16-byte
// aligned.  lse: null, or contiguous [bh, nq] f32 that receives the
// logsumexp of each query row's scaled scores.  Returns 0 or a cudaError_t
// code (launch errors included).
int fgdm_flash_attn_fwd(const void* q, const void* k, const void* v, void* o,
                        void* lse, int bh, int nq, int nk, int d, float scale,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (d) {
    case 40: return launch<40, 64, 64, 4>(q, k, v, o, l, bh, nq, nk, scale, s);
    case 80: return launch<80, 64, 64, 4>(q, k, v, o, l, bh, nq, nk, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Keys per streamed tile for head dim d (nk must be a multiple), 0 if the
// head dim has no instantiation.
int fgdm_flash_attn_block_n(int d) {
  switch (d) {
    case 40: case 80: return 64;
    default: return 0;
  }
}

const char* fgdm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
