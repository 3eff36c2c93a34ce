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
//     bounds it.  What the design does about that:
//
//     * Fill the card.  A block owns a rectangle of th x tw <= BM output
//       pixels of one image and BN output channels, BM and BN each 128 or
//       64 (Tile below: 256 threads, each TI pixels x TJ channels of f32
//       sums in registers), and the chunks of 8 input channels of one slice
//       of the reduction: with S > 1 slices the S blocks of a pixel x
//       channel tile form one thread-block cluster.  conv3x3_plan
//       (kernels/conv.py) picks the tile, the blocks an SM is compiled for
//       and S per shape, so that the channel tiles fit Co (320 = 5 x 64) and
//       the small planes (one image of 32^2) still give every SM a block.
//     * Per chunk of BK = 8 input channels a block copies the rectangle
//       plus its one-pixel border, [th+2][tw+2][8], into shared memory ONCE
//       for all nine taps, zeros where the border lies outside the plane,
//       and the chunk's weights, [BN][9][8].  The next chunk's copies
//       (cp.async, two stages) overlap this chunk's products; one barrier
//       pair a chunk, 9 * 8 * TI * TJ FMAs a thread between them.
//     * Thread (px, cy) computes pixel slots px + 16 i and channels
//       cy + 16 j, so that the 16 lanes of a half-warp read 16 neighbouring
//       pixels (padded to 12 floats a pixel: conflict-free float4 reads) and
//       write 16 neighbouring outputs.  A tap of a pixel is a fixed offset
//       into the halo tile: each slot's row base is computed once a tap
//       row, the three taps of a row and the chunk's channels are unrolled
//       with constant offsets, TI + TJ float4 reads per 4 * TI * TJ FMAs.
//       (Warps of 8 pixels x 4 channels, one wavefront a read instead of
//       two, ran no faster: shared memory is not what bounds the block.)
//     * The 128 x 128 tile runs one block an SM (its 64 sums and operands
//       take ~250 registers a thread; capped at 128 for two blocks an SM it
//       spilled and ran 10-20 % slower), the 128 x 64 and 64 x 64 tiles two,
//       so that one block's barrier wait is covered by the other's products.
//     * A cluster's S partial tiles meet in distributed shared memory: each
//       block stages its sums in its own shared memory, and block r of the
//       cluster adds the S tiles of its 1/S of the output channels in rank
//       order 0, 1, ..., S-1, then the bias, and stores.  The f32 bias is
//       added to the f32 sum before the one store (conv.py:120-121).  A
//       fixed order of sums (slice, then chunk, tap, channel within it) and
//       no atomics: reruns are bit-identical.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace fgdm;

constexpr int THREADS = 256;
constexpr int BK = 8;             // input channels per chunk
constexpr int HPS = BK + 4;       // floats per halo pixel
constexpr int WS = 9 * BK + 4;    // floats per output channel of a chunk
constexpr int STAGES = 2;
constexpr int RPAD = 16;          // pad of a staged partial's rows
constexpr int MAX_SPLITS = 8;     // a portable cluster

// Pixel slots (BM) and output channels (BN) a block: 16 x 16 threads, each
// TI slots x TJ channels.
template <int TI, int TJ>
struct Tile {
  static constexpr int BM = 16 * TI, BN = 16 * TJ;
};

__host__ __device__ inline int stage_floats(int th, int tw, int bn) {
  return (th + 2) * (tw + 2) * HPS + bn * WS;
}

// The operand stages, or the staged partial [bn][bm + RPAD] of a split
// tile, whichever is larger (they share memory).
__host__ __device__ inline int smem_bytes(int th, int tw, int bm, int bn,
                                          int splits) {
  const int stages = STAGES * stage_floats(th, tw, bn) * 4;
  const int part = splits > 1 ? bn * (bm + RPAD) * 4 : 0;
  return stages > part ? stages : part;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// A float4 from the shared memory of a block of this cluster (the address
// from map_to_rank).
__device__ __forceinline__ float4 ld_cluster_f4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// xt [n, h, wd, c] f32 (the pre-pass's output); wk [co, 9, c] f32; bias [co]
// f32; out [n, co, h, wd] f32.  blockIdx.x walks (image, tile row, tile
// column, slice) with the slice fastest (a cluster's blocks are its
// slices), blockIdx.y the BN-channel output tiles.  Slice s takes chunks
// [s * per, min((s + 1) * per, c / BK)).
template <int TI, int TJ, int MINB>
__global__ void __launch_bounds__(THREADS, MINB)
conv3x3_f32_kernel(const float* __restrict__ xt, const float* __restrict__ wk,
                   const float* __restrict__ bias, float* __restrict__ out,
                   int c, int co, int h, int wd, int th, int tw, int tiles_x,
                   int tiles_y, int splits, int per) {
  constexpr int BM = Tile<TI, TJ>::BM, BN = Tile<TI, TJ>::BN;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int split = blockIdx.x % splits;
  int bx = blockIdx.x / splits;
  const int x0 = (bx % tiles_x) * tw;
  bx /= tiles_x;
  const int r0 = (bx % tiles_y) * th;
  const int img = bx / tiles_y;
  const int co0 = blockIdx.y * BN;
  const int ch0 = split * per;
  const int ch1 = min(ch0 + per, c / BK);
  const int hw2 = tw + 2, halo_px = (th + 2) * hw2;
  const int stage = stage_floats(th, tw, BN);
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
  int hp0[TI];  // each slot's halo offset (floats) at tap (0, 0)
#pragma unroll
  for (int i = 0; i < TI; ++i) {
    int s = px + 16 * i;
    if (s >= valid) s = 0;  // computed, never stored
    hp0[i] = ((s / tw) * hw2 + s % tw) * HPS;
  }
  float acc[TI][TJ];
#pragma unroll
  for (int i = 0; i < TI; ++i)
#pragma unroll
    for (int j = 0; j < TJ; ++j) acc[i][j] = 0.f;

  load(ch0, 0);
#pragma unroll 1
  for (int ch = ch0; ch < ch1; ++ch) {
    const int st = (ch - ch0) % STAGES;
    if (ch + 1 < ch1) {
      load(ch + 1, (ch + 1 - ch0) % STAGES);
      cp_async_wait<1>();  // this chunk is in (the next may not be)
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* halo = smem + st * stage;
    const float* w_s = halo + halo_px * HPS + cy * WS;
#pragma unroll 1
    for (int ky = 0; ky < 3; ++ky) {
      const float* hrow = halo + ky * hw2 * HPS;
      const float* wrow = w_s + ky * 3 * BK;
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
#pragma unroll
        for (int c4 = 0; c4 < BK / 4; ++c4) {
          float4 b[TJ];
#pragma unroll
          for (int j = 0; j < TJ; ++j)
            b[j] = ld4(wrow + 16 * j * WS + kx * BK + 4 * c4);
#pragma unroll
          for (int i = 0; i < TI; ++i) {
            const float4 a = ld4(hrow + hp0[i] + kx * HPS + 4 * c4);
#pragma unroll
            for (int j = 0; j < TJ; ++j) {
              acc[i][j] = fmaf(a.x, b[j].x, acc[i][j]);
              acc[i][j] = fmaf(a.y, b[j].y, acc[i][j]);
              acc[i][j] = fmaf(a.z, b[j].z, acc[i][j]);
              acc[i][j] = fmaf(a.w, b[j].w, acc[i][j]);
            }
          }
        }
      }
    }
    __syncthreads();  // this stage is read before the next load overwrites it
  }

  float* on = out + (size_t)img * co * h * wd;
  if (splits == 1) {
#pragma unroll
    for (int j = 0; j < TJ; ++j) {
      const int oc = co0 + cy + 16 * j;
      if (oc >= co) continue;
      const float bj = bias[oc];
#pragma unroll
      for (int i = 0; i < TI; ++i) {
        const int s = px + 16 * i;
        const int y = r0 + s / tw, x = x0 + s % tw;
        if (s < valid && y < h && x < wd)
          on[((size_t)oc * h + y) * wd + x] = acc[i][j] + bj;
      }
    }
    return;
  }

  // The slices meet: stage this block's partial [BN][BM + RPAD] (the
  // operand stages are read: the loop ended on a barrier), then block
  // `split` of the cluster sums channels [split * BN / S, (split + 1) *
  // BN / S) over the cluster's blocks in rank order.
  constexpr int RS = BM + RPAD;
#pragma unroll
  for (int j = 0; j < TJ; ++j)
#pragma unroll
    for (int i = 0; i < TI; ++i)
      smem[(cy + 16 * j) * RS + px + 16 * i] = acc[i][j];
  cluster_arrive();
  cluster_wait();
  const int rows = BN / splits;
  for (int e = tid; e < rows * (BM / 4); e += THREADS) {
    const int ol = split * rows + e / (BM / 4), s0 = 4 * (e % (BM / 4));
    const int oc = co0 + ol;
    if (oc >= co || s0 >= valid) continue;
    const uint32_t a = smem_u32(smem + ol * RS + s0);
    float4 sum = ld_cluster_f4(map_to_rank(a, 0));
    for (int r = 1; r < splits; ++r) {
      const float4 p = ld_cluster_f4(map_to_rank(a, r));
      sum.x += p.x;
      sum.y += p.y;
      sum.z += p.z;
      sum.w += p.w;
    }
    const float bj = bias[oc];
    const float v[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int s = s0 + t;
      const int y = r0 + s / tw, x = x0 + s % tw;
      if (s < valid && y < h && x < wd)
        on[((size_t)oc * h + y) * wd + x] = v[t] + bj;
    }
  }
  cluster_arrive();  // no block leaves while a peer may read its partial
  cluster_wait();
}

template <int TI, int TJ, int MINB>
int launch(const float* xt, const float* wk, const float* bias, float* out,
           int c, int co, int h, int w, int th, int tw, int tiles_x,
           int tiles_y, long long gx, int splits, int per, int smem,
           cudaStream_t stream) {
  constexpr int BN = Tile<TI, TJ>::BN;
  auto kern = conv3x3_f32_kernel<TI, TJ, MINB>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(gx * splits), (unsigned)((co + BN - 1) / BN));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kern, xt, wk, bias, out, c, co, h, w, th, tw,
                           tiles_x, tiles_y, splits, per);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
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
// multiple of 8.  The plan (conv3x3_plan's numbers; checked against this
// file's): bm x bn x minb one of 128 x 128 x 1, 128 x 64 x 2 and 64 x 64 x 2
// (the tiles the sweep kept: 64 x 128 and 128 x 128 at two blocks an SM,
// capped at 128 registers, spilled and lost to these); the rectangle
// th x tw <= bm pixels of one image; the c / 8 chunks cut into `splits`
// (1, 2, 4 or 8) non-empty slices of `per`;
// smem the dynamic shared memory.  Returns 0 or a cudaError_t code (launch
// errors included).
int fgdm_conv3x3_f32(const void* xt, const void* wk, const void* bias,
                     void* out, int n, int c, int co, int h, int w, int bm,
                     int bn, int minb, int th, int tw, int splits, int per,
                     int smem, void* stream) {
  if (n <= 0 || c <= 0 || co <= 0 || h <= 0 || w <= 0 || c % BK != 0 ||
      th <= 0 || tw <= 0 || th * tw > bm ||
      smem != smem_bytes(th, tw, bm, bn, splits))
    return (int)cudaErrorInvalidValue;
  const int chunks = c / BK;
  if (splits < 1 || splits > MAX_SPLITS || (splits & (splits - 1)) != 0 ||
      per < 1 || (chunks + per - 1) / per != splits)
    return (int)cudaErrorInvalidValue;
  const int tiles_x = (w + tw - 1) / tw, tiles_y = (h + th - 1) / th;
  const long long gx = (long long)tiles_x * tiles_y * n;
  if (gx * splits > 0x7fffffffLL || (co + bn - 1) / bn > 65535)
    return (int)cudaErrorInvalidValue;
  const float* x_ = static_cast<const float*>(xt);
  const float* w_ = static_cast<const float*>(wk);
  const float* b_ = static_cast<const float*>(bias);
  float* o_ = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FGDM_CONV_F32(TI, TJ, MINB)                                          \
  if (bm == 16 * TI && bn == 16 * TJ && minb == MINB)                        \
    return launch<TI, TJ, MINB>(x_, w_, b_, o_, c, co, h, w, th, tw, tiles_x, \
                                tiles_y, gx, splits, per, smem, s);
  FGDM_CONV_F32(8, 8, 1)
  FGDM_CONV_F32(8, 4, 2)
  FGDM_CONV_F32(4, 4, 2)
#undef FGDM_CONV_F32
  return (int)cudaErrorInvalidValue;
}

// The blocks of a plan's kernel (bm, bn, minb, smem as for fgdm_conv3x3_f32)
// resident on the device at once in clusters of `splits`
// (cudaOccupancyMaxActiveClusters times splits), into *out.  Returns 0 or a
// cudaError_t code.
int fgdm_conv3x3_f32_resident(int bm, int bn, int minb, int splits, int smem,
                              int* out) {
  const void* kern = nullptr;
  if (bm == 128 && bn == 128 && minb == 1)
    kern = (const void*)conv3x3_f32_kernel<8, 8, 1>;
  else if (bm == 128 && bn == 64 && minb == 2)
    kern = (const void*)conv3x3_f32_kernel<8, 4, 2>;
  else if (bm == 64 && bn == 64 && minb == 2)
    kern = (const void*)conv3x3_f32_kernel<4, 4, 2>;
  if (kern == nullptr || splits < 1 || splits > MAX_SPLITS || out == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)splits);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = (size_t)smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
  if (err != cudaSuccess) return (int)err;
  *out = clusters * splits;
  return 0;
}

const char* fgdm_cuda_error_string(int code) { return error_string(code); }

}  // extern "C"
