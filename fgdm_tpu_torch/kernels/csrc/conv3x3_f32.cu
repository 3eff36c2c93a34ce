// Direct 3x3 convolution (stride 1, SAME padding, bias) in float32 for
// Hopper (sm_90a): f32 in / f32 out, IEEE float32 products on the CUDA
// cores.
//
// Replaces, in float32, the Pallas TPU kernel fgdm_tpu/kernels/conv.py:100
// _kernel (pallas_call at :161) behind both of its callers, _conv3x3_fwd
// (:176, whole planes) and _conv3x3_slab_fwd (:223, slabs), which the JAX
// package runs in float32 wherever a model computes in float32 with
// FGDM_PALLAS_CONV / FGDM_PALLAS_CONV_VAE on (its gates have no dtype test).
// conv3x3.cu stays for bf16.  Two kernels, as there:
//
//   nchw_to_nhwc_f32_kernel  the pre-pass: a tiled transpose of [N, C, H*W]
//     into [N, H*W, C] scratch through shared memory, 128-byte rows on both
//     sides.  Bound by bytes.
//
//   conv3x3_f32_kernel  an implicit GEMM, M = N*H*W output pixels, N = Co,
//     K = 9*C tap-major (the packed [Co, 9, C] f32 weight).  2*M*Co*9*C
//     operations on ~4*(M*C + M*Co) bytes: no tensor core keeps float32's
//     24-bit products (TF32 keeps 11 bits), so the FFMA rate (67 TFLOP/s)
//     bounds it.  The design keeps the FMA units fed from shared memory:
//
//     * A block owns a rectangle of th x tw <= 128 output pixels of one
//       image (whole rows where W <= 64, conv3x3_plan in kernels/conv.py)
//       and 128 output channels.  Per chunk of BK = 8 input channels it
//       copies the rectangle plus its one-pixel border, [th+2][tw+2][8],
//       into shared memory ONCE for all nine taps, zeros where the border
//       lies outside the plane, and the chunk's weights, [128][9][8].  The
//       next chunk's copies (cp.async, two stages) overlap this chunk's
//       products.
//     * Each thread computes 8 pixels x 8 output channels (64 f32 sums in
//       registers): pixel slots px + 16 i, channels cy + 16 j, so that the
//       16 lanes of a half-warp read 16 neighbouring pixels (padded to 12
//       floats a pixel: conflict-free float4 reads) and write 16
//       neighbouring outputs.  A tap of a pixel is a fixed offset into the
//       halo tile: 16 float4 reads per 256 FMAs.
//     * The f32 bias is added to the f32 sum before the one store
//       (conv.py:120-121).  A fixed order of sums (chunk, tap, channel) and
//       no atomics: reruns are bit-identical.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace fgdm;

constexpr int THREADS = 256;
constexpr int BM = 128;           // pixel slots per block
constexpr int BN = 128;           // output channels per block
constexpr int BK = 8;             // input channels per chunk
constexpr int HPS = BK + 4;       // floats per halo pixel
constexpr int WS = 9 * BK + 4;    // floats per output channel of a chunk
constexpr int STAGES = 2;

__host__ __device__ inline int stage_floats(int th, int tw) {
  return (th + 2) * (tw + 2) * HPS + BN * WS;
}

__host__ __device__ inline int smem_bytes(int th, int tw) {
  return STAGES * stage_floats(th, tw) * 4;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// xt [n, h, wd, c] f32 (the pre-pass's output); wk [co, 9, c] f32; bias [co]
// f32; out [n, co, h, wd] f32.  blockIdx.x walks (image, tile row, tile
// column), blockIdx.y the 128-channel output tiles.
__global__ void __launch_bounds__(THREADS, 1)
conv3x3_f32_kernel(const float* __restrict__ xt, const float* __restrict__ wk,
                   const float* __restrict__ bias, float* __restrict__ out,
                   int c, int co, int h, int wd, int th, int tw, int tiles_x,
                   int tiles_y) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  int bx = blockIdx.x;
  const int x0 = (bx % tiles_x) * tw;
  bx /= tiles_x;
  const int r0 = (bx % tiles_y) * th;
  const int img = bx / tiles_y;
  const int co0 = blockIdx.y * BN;
  const int n_chunks = c / BK;
  const int hw2 = tw + 2, halo_px = (th + 2) * hw2;
  const int stage = stage_floats(th, tw);
  const float* xi = xt + (size_t)img * h * wd * c;

  auto load = [&](int ch, int st) {
    float* halo = smem + st * stage;
    float* w_s = halo + halo_px * HPS;
    const int c0 = ch * BK;
    for (int i = tid; i < halo_px * 2; i += THREADS) {
      const int p = i >> 1, half = i & 1;
      const int y = r0 - 1 + p / hw2, x = x0 - 1 + p % hw2;
      const bool in = y >= 0 && y < h && x >= 0 && x < wd;
      cp_async16(smem_u32(halo + p * HPS + 4 * half),
                 xi + ((size_t)(in ? y : 0) * wd + (in ? x : 0)) * c + c0 +
                     4 * half,
                 in ? 16 : 0);
    }
    for (int i = tid; i < BN * 18; i += THREADS) {
      const int ol = i / 18, tap = i % 18 >> 1, half = i & 1;
      const bool in = co0 + ol < co;
      cp_async16(smem_u32(w_s + ol * WS + tap * BK + 4 * half),
                 wk + ((size_t)(in ? co0 + ol : 0) * 9 + tap) * c + c0 +
                     4 * half,
                 in ? 16 : 0);
    }
    cp_async_commit();
  };

  // pixel slots px + 16 i of the rectangle (slot s is pixel (s / tw,
  // s % tw)); output channels co0 + cy + 16 j
  const int px = tid % 16, cy = tid / 16;
  const int valid = th * tw;
  int hp0[8];  // each slot's halo pixel at tap (0, 0)
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    int s = px + 16 * i;
    if (s >= valid) s = 0;  // computed, never stored
    hp0[i] = (s / tw) * hw2 + s % tw;
  }
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  load(0, 0);
#pragma unroll 1
  for (int ch = 0; ch < n_chunks; ++ch) {
    if (ch + 1 < n_chunks) {
      load(ch + 1, (ch + 1) % STAGES);
      cp_async_wait<1>();  // this chunk is in (the next may not be)
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* halo = smem + (ch % STAGES) * stage;
    const float* w_s = halo + halo_px * HPS + cy * WS;
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int toff = (tap / 3) * hw2 + tap % 3;
#pragma unroll
      for (int c4 = 0; c4 < BK / 4; ++c4) {
        float4 b[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          b[j] = ld4(w_s + 16 * j * WS + tap * BK + 4 * c4);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float4 a = ld4(halo + (hp0[i] + toff) * HPS + 4 * c4);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            acc[i][j] = fmaf(a.x, b[j].x, acc[i][j]);
            acc[i][j] = fmaf(a.y, b[j].y, acc[i][j]);
            acc[i][j] = fmaf(a.z, b[j].z, acc[i][j]);
            acc[i][j] = fmaf(a.w, b[j].w, acc[i][j]);
          }
        }
      }
    }
    __syncthreads();  // this stage is read before the next load overwrites it
  }

  float* on = out + (size_t)img * co * h * wd;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int oc = co0 + cy + 16 * j;
    if (oc >= co) continue;
    const float bj = bias[oc];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int s = px + 16 * i;
      const int y = r0 + s / tw, x = x0 + s % tw;
      if (s < valid && y < h && x < wd)
        on[((size_t)oc * h + y) * wd + x] = acc[i][j] + bj;
    }
  }
}

// [N, C, HW] -> [N, HW, C], 32 channels x 32 pixels per block through a
// padded shared tile.
__global__ void __launch_bounds__(256)
nchw_to_nhwc_f32_kernel(const float* __restrict__ x, float* __restrict__ y,
                        int c, int hw) {
  __shared__ float tile[32][33];
  const int p0 = blockIdx.x * 32, c0 = blockIdx.y * 32;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const float* xin = x + (size_t)blockIdx.z * c * hw;
  float* yout = y + (size_t)blockIdx.z * hw * c;
#pragma unroll
  for (int i = ty; i < 32; i += 8) {
    const int cc = c0 + i, pp = p0 + tx;
    tile[i][tx] = cc < c && pp < hw ? xin[(size_t)cc * hw + pp] : 0.f;
  }
  __syncthreads();
#pragma unroll
  for (int i = ty; i < 32; i += 8) {
    const int pp = p0 + i, cc = c0 + tx;
    if (pp < hw && cc < c) yout[(size_t)pp * c + cc] = tile[tx][i];
  }
}

}  // namespace

extern "C" {

// The pre-pass.  x: contiguous [n, c, hw] f32; y: contiguous [n, hw, c]
// f32, both on the current device.  Returns 0 or a cudaError_t code.
int fgdm_nchw_to_nhwc_f32(const void* x, void* y, int n, int c, int hw,
                          void* stream) {
  if (n <= 0 || c <= 0 || hw <= 0 || n > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((hw + 31) / 32, (c + 31) / 32, n);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  nchw_to_nhwc_f32_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y), c, hw);
  return (int)cudaGetLastError();
}

// The conv.  xt: contiguous [n, h, w, c] f32 (the pre-pass's output); wk:
// contiguous [co, 9, c] f32; bias: contiguous [co] f32; out: contiguous
// [n, co, h, w] f32; all 16-byte aligned on the current device; c a
// multiple of 8.  The tile: th x tw <= 128 pixels of one image, smem the
// dynamic shared memory (conv3x3_plan's numbers; checked against this
// file's).  Returns 0 or a cudaError_t code (launch errors included).
int fgdm_conv3x3_f32(const void* xt, const void* wk, const void* bias,
                     void* out, int n, int c, int co, int h, int w, int th,
                     int tw, int smem, void* stream) {
  if (n <= 0 || c <= 0 || co <= 0 || h <= 0 || w <= 0 || c % BK != 0 ||
      th <= 0 || tw <= 0 || th * tw > BM || smem != smem_bytes(th, tw))
    return (int)cudaErrorInvalidValue;
  const int tiles_x = (w + tw - 1) / tw, tiles_y = (h + th - 1) / th;
  const long long gx = (long long)tiles_x * tiles_y * n;
  const int gy = (co + BN - 1) / BN;
  if (gx > 0x7fffffffLL || gy > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  conv3x3_f32_kernel<<<dim3((unsigned)gx, gy), THREADS, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xt), static_cast<const float*>(wk),
      static_cast<const float*>(bias), static_cast<float*>(out), c, co, h, w,
      th, tw, tiles_x, tiles_y);
  return (int)cudaGetLastError();
}

const char* fgdm_cuda_error_string(int code) { return error_string(code); }

}  // extern "C"
