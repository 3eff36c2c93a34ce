// Direct 3x3 convolution (stride 1, SAME padding, bias) for Hopper (sm_90a),
// bf16 in / bf16 out, f32 accumulation.
//
// Replaces the Pallas TPU kernel fgdm_tpu/kernels/conv.py:100 _kernel
// (pallas_call at :161, reached through _run_padded :157 from both
// _conv3x3_fwd :176, whole planes, and _conv3x3_slab_fwd :223, height/width
// slabs with a one-row halo).  On the TPU one program held a zero-padded NHWC
// plane in VMEM and ran nine shifted [rows, C] x [C, Co] products; the padded
// copy and the slabs existed only because VMEM is small.  Here one kernel
// serves both callers as an implicit GEMM over the port's NCHW layout:
//
//   M = N*H*W output pixels, N = Co output channels, K = 9*C (tap-major:
//   k = (ky*3 + kx)*C + c, the layout of the [Co, 3, 3, C] weight copy).
//
// Each block owns BM=128 pixels x BN=128 output channels and walks K in
// steps of BK=32 channels of one tap.  The A tile (pixels x channels) is
// read straight from NCHW: for one channel, neighbouring pixels of a row are
// neighbouring addresses, so a warp reads 32 consecutive pixels of one
// channel and the tile is staged in shared memory transposed ([pixel][k]) for
// mma.sync.  Out-of-plane taps (the halo) read as zeros by bounds checks, so
// no padded copy exists; pixels past N*H*W and channels past C are zero too.
// The B tile comes from the K-major weight copy in 16-byte vectors.  The next
// step's tile is loaded into registers while the tensor cores work on the
// current one.  The epilogue adds the f32 bias to the f32 sum before the
// single rounding to bf16 (conv.py:120-121), stages the tile in shared
// memory as [channel][pixel] and writes NCHW rows with consecutive threads
// on consecutive pixels.  No atomics: every output is one thread's sum in a
// fixed order, so reruns are bit-identical.
//
// What bounds it on the card: at the serving shapes a conv does 2*M*Co*9*C
// operations against ~2*(M*C + M*Co) bytes, hundreds of operations per byte,
// so the tensor cores bound it.  This first version is simple rather than
// fast: mma.sync m16n8k16 (not wgmma), one shared-memory stage filled through
// registers (no TMA, no cp.async pipeline), scalar 2-byte activation loads.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using namespace fgdm;

constexpr int BM = 128;                 // output pixels per block
constexpr int BN = 128;                 // output channels per block
constexpr int BK = 32;                  // input channels per K step
constexpr int NW = 8;                   // warps: 2 (pixels) x 4 (channels)
constexpr int THREADS = NW * 32;
constexpr int WM = BM / 2, WN = BN / 4; // 64 x 32 outputs per warp
constexpr int MT = WM / 16, NT = WN / 8;
constexpr int LDA = BK + 8;             // A: [pixel][k], bf16 (+16 B per row
constexpr int LDB = BK + 8;             // B: [co][k]      against bank conflicts)
constexpr int LDC = BM + 8;             // output tile: [co][pixel]
constexpr int A_PAIRS = BM * BK / 2 / THREADS;  // channel pairs per thread
constexpr int B_VECS = BN * BK / 8 / THREADS;   // 16-byte weight chunks
constexpr int SMEM_AB = 2 * (BM * LDA + BN * LDB);
constexpr int SMEM_C = 2 * BN * LDC;
constexpr int SMEM = SMEM_AB > SMEM_C ? SMEM_AB : SMEM_C;
static_assert(THREADS % BM == 0, "each thread loads and stores one pixel");
static_assert(BN * BK % (8 * THREADS) == 0, "whole weight chunks per thread");
static_assert(SMEM <= 48 * 1024, "static shared memory");

// One K step's operands in registers: 2*A_PAIRS channels of this thread's
// pixel at one tap, and B_VECS chunks of 8 weights.
struct Stage {
  uint32_t a[A_PAIRS];
  uint4 b[B_VECS];
};

__device__ __forceinline__ void load_stage(
    Stage& st, const uint16_t* __restrict__ xn, const bf16* __restrict__ w,
    int s, int n_cc, int c, int co, int h, int wd, size_t hw, bool p_ok,
    int py, int px, int cpair0, int co0, int tid) {
  const int tap = s / n_cc;
  const int c0 = (s - tap * n_cc) * BK;
  const int iy = py + tap / 3 - 1, ix = px + tap % 3 - 1;
  const bool in = p_ok && iy >= 0 && iy < h && ix >= 0 && ix < wd;
  const size_t off = in ? (size_t)iy * wd + ix : 0;
#pragma unroll
  for (int i = 0; i < A_PAIRS; ++i) {
    const int ch = c0 + 2 * (cpair0 + i * (THREADS / BM));
    uint32_t v = 0u;
    if (in && ch < c) {  // c % 8 == 0, so ch + 1 < c as well
      v = (uint32_t)xn[off + (size_t)ch * hw]
          | ((uint32_t)xn[off + (size_t)(ch + 1) * hw] << 16);
    }
    st.a[i] = v;
  }
#pragma unroll
  for (int j = 0; j < B_VECS; ++j) {
    const int idx = tid + j * THREADS;
    const int row = idx / (BK / 8), k8 = idx % (BK / 8);
    const int oc = co0 + row, ch = c0 + k8 * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (oc < co && ch < c)
      v = *reinterpret_cast<const uint4*>(w + ((size_t)oc * 9 + tap) * c + ch);
    st.b[j] = v;
  }
}

__device__ __forceinline__ void store_stage(const Stage& st, bf16* as,
                                            bf16* bs, int pl, int cpair0,
                                            int tid) {
#pragma unroll
  for (int i = 0; i < A_PAIRS; ++i)
    *reinterpret_cast<uint32_t*>(
        as + pl * LDA + 2 * (cpair0 + i * (THREADS / BM))) = st.a[i];
#pragma unroll
  for (int j = 0; j < B_VECS; ++j) {
    const int idx = tid + j * THREADS;
    *reinterpret_cast<uint4*>(bs + (idx / (BK / 8)) * LDB
                              + (idx % (BK / 8)) * 8) = st.b[j];
  }
}

// x: [n, c, h, wd] bf16; w: [co, 3, 3, c] bf16; bias: [co] f32;
// out: [n, co, h, wd] bf16.
__global__ void __launch_bounds__(THREADS)
conv3x3_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
               const float* __restrict__ bias, bf16* __restrict__ out, int n,
               int c, int co, int h, int wd) {
  __shared__ __align__(16) unsigned char smem[SMEM];
  bf16* as = reinterpret_cast<bf16*>(smem);
  bf16* bs = as + BM * LDA;
  bf16* cs = reinterpret_cast<bf16*>(smem);  // reused by the epilogue

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;     // mma fragment coordinates
  const int wm = warp % 2, wn = warp / 2;
  const size_t hw = (size_t)h * wd;
  const long long m_total = (long long)n * h * wd;
  const long long p0 = (long long)blockIdx.x * BM;
  const int co0 = blockIdx.y * BN;

  // This thread's pixel, for the activation loads and the output stores.
  const int pl = tid % BM;
  const long long p = p0 + pl;
  const bool p_ok = p < m_total;
  int pn = 0, py = 0, px = 0;
  if (p_ok) {
    pn = (int)(p / (long long)hw);
    const int r = (int)(p - (long long)pn * (long long)hw);
    py = r / wd;
    px = r - py * wd;
  }
  const uint16_t* xn =
      reinterpret_cast<const uint16_t*>(x) + (size_t)pn * c * hw;
  const int cpair0 = tid / BM;

  const int n_cc = (c + BK - 1) / BK;
  const int steps = 9 * n_cc;

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  Stage st;
  load_stage(st, xn, w, 0, n_cc, c, co, h, wd, hw, p_ok, py, px, cpair0, co0,
             tid);
  for (int s = 0; s < steps; ++s) {
    __syncthreads();  // the previous step's MMAs are done with the tiles
    store_stage(st, as, bs, pl, cpair0, tid);
    __syncthreads();
    if (s + 1 < steps)  // in flight while the tensor cores run
      load_stage(st, xn, w, s + 1, n_cc, c, co, h, wd, hw, p_ok, py, px,
                 cpair0, co0, tid);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[MT][4], b[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        load_a(a[i], as + (wm * WM + i * 16) * LDA + kk, LDA, g, t);
#pragma unroll
      for (int j = 0; j < NT; ++j)
        load_b(b[j], bs + (wn * WN + j * 8) * LDB + kk, LDB, g, t);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_16816(acc[i][j], a[i], b[j]);
    }
  }
  __syncthreads();

  // Epilogue: f32 sum + f32 bias, one rounding, staged as [co][pixel].
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = wn * WN + j * 8 + 2 * t;
    const float b0 = co0 + col < co ? bias[co0 + col] : 0.f;
    const float b1 = co0 + col + 1 < co ? bias[co0 + col + 1] : 0.f;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int r0 = wm * WM + i * 16 + g;
      cs[col * LDC + r0] = __float2bfloat16(acc[i][j][0] + b0);
      cs[(col + 1) * LDC + r0] = __float2bfloat16(acc[i][j][1] + b1);
      cs[col * LDC + r0 + 8] = __float2bfloat16(acc[i][j][2] + b0);
      cs[(col + 1) * LDC + r0 + 8] = __float2bfloat16(acc[i][j][3] + b1);
    }
  }
  __syncthreads();
  if (p_ok) {
    bf16* on = out + (size_t)pn * co * hw + (size_t)py * wd + px;
    for (int i = tid / BM; i < BN && co0 + i < co; i += THREADS / BM)
      on[(size_t)(co0 + i) * hw] = cs[i * LDC + pl];
  }
}

}  // namespace

extern "C" {

// x: contiguous [n, c, h, w] bf16; wk: contiguous [co, 3, 3, c] bf16 (16-byte
// aligned); bias: contiguous [co] f32; out: contiguous [n, co, h, w] bf16;
// all on the current device.  c must be a multiple of 8.  Returns 0 or a
// cudaError_t code (launch errors included).
int fgdm_conv3x3(const void* x, const void* wk, const void* bias, void* out,
                 int n, int c, int co, int h, int w, void* stream) {
  if (n <= 0 || c <= 0 || co <= 0 || h <= 0 || w <= 0 || c % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const long long m = (long long)n * h * w;
  const long long bx = (m + BM - 1) / BM;
  const int by = (co + BN - 1) / BN;
  if (bx > 0x7fffffffLL || by > 65535) return (int)cudaErrorInvalidValue;
  conv3x3_kernel<<<dim3((unsigned)bx, by), THREADS, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wk),
      static_cast<const float*>(bias), static_cast<bf16*>(out), n, c, co, h,
      w);
  return (int)cudaGetLastError();
}

const char* fgdm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
