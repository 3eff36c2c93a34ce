// Direct 3x3 convolution (stride 1, SAME padding, bias) for Hopper (sm_90a),
// bf16 in / bf16 out, f32 accumulation.
//
// Replaces the Pallas TPU kernel fgdm_tpu/kernels/conv.py:100 _kernel
// (pallas_call at :161, reached through _run_padded :157 from both
// _conv3x3_fwd :176, whole planes, and _conv3x3_slab_fwd :223, height/width
// slabs with a one-row halo).  On the TPU one program held a zero-padded NHWC
// plane in VMEM and ran nine shifted [rows, C] x [C, Co] products; the padded
// copy and the slabs existed because VMEM is small.  Here two kernels serve
// both callers:
//
//   nchw_to_nhwc_kernel  the pre-pass: the port's tensors are NCHW (pixels
//     contiguous), the main kernel wants the channels contiguous, so a tiled
//     transpose through shared memory writes [N, H, W, C] scratch, 16-byte
//     accesses on both sides.  Bound by bytes (each element read and written
//     once).
//
//   conv3x3_wgmma_kernel  an implicit GEMM, M = N*H*W output pixels, N = Co,
//     K = 9*C tap-major (k = (ky*3 + kx)*C + c, the layout of the packed
//     [Co, 9, C] weight).  It does 2*M*Co*9*C operations on ~2*(M*C + M*Co)
//     bytes, hundreds of operations per byte at the served shapes, so the
//     tensor cores bound it, and what the design has to do is keep them fed:
//
//     * A block owns a rectangle of th x tw output pixels of one image (whole
//       rows where W <= 64) and BN = 128 output channels.  Per chunk of
//       BK = 64 input channels one 4-D TMA box brings the rectangle plus its
//       one-pixel border, [th+2][tw+2][64], into shared memory ONCE for all
//       nine taps; the box starts at (row0-1, x0-1) and the hardware writes
//       zeros for what lies outside the plane or past C, so the halo needs
//       no bounds checks and no padded copy.
//     * A is taken from registers: ldmatrix.x4 reads the 16x16 fragment of a
//       tap as sixteen row addresses into the halo tile, one per pixel, so a
//       pixel window that wraps at row ends costs nothing (a wgmma descriptor
//       could not describe it).  The tile keeps TMA's 128-byte swizzle, which
//       makes eight neighbouring pixels hit eight different bank groups.
//     * B, the [128 co][64 k] weight tile of one (chunk, tap), comes by TMA
//       from the packed weight with the same swizzle and is read by
//       wgmma.mma_async (m64n128k16, f32 accumulators in registers) through a
//       shared-memory descriptor; Co past the end is zero-filled.
//     * One producer warp keeps both rings (2 halo stages, 4-6 weight stages)
//       in flight behind full/empty mbarriers; 1 or 2 consumer warpgroups,
//       each owning 64 pixels, wait, multiply and release.  No block-wide
//       barrier in the K loop.
//     * The epilogue adds the f32 bias to the f32 sum before the single
//       rounding to bf16 (conv.py:120-121), stages the tile as [co][pixel]
//       in the halo ring's memory and writes NCHW rows in 16-byte stores.
//       No atomics and a fixed order of sums: reruns are bit-identical.
//
//   The tile (bm = 64 or 128 pixels; th, tw) is chosen per shape on the
//   host (kernels/conv.py conv3x3_plan) so that the card's 132 SMs have
//   blocks to run at the 16x16 planes as well.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace fgdm;

constexpr int BN = 128;              // output channels per block
constexpr int BK = 64;               // input channels per chunk: 128 bytes
constexpr int W_TILE = BN * BK * 2;  // one (chunk, tap) of weights: 16 KB
constexpr int HALO_STAGES = 2;
constexpr int MAX_W_STAGES = 8;
constexpr int HEADER = 1024;         // the mbarriers, ahead of the tiles

__host__ __device__ inline int halo_bytes(int th, int tw) {
  return ((th + 2) * (tw + 2) * BK * 2 + 1023) / 1024 * 1024;
}

__host__ __device__ inline int smem_bytes(int bm, int th, int tw, int wst) {
  const int halo = HALO_STAGES * halo_bytes(th, tw);
  const int epi = BN * (bm + 8) * 2;
  // 1024 spare bytes: the kernel aligns its base to the swizzle atom
  return 1024 + HEADER + wst * W_TILE + (halo > epi ? halo : epi);
}

// x: NHWC activations as a 4-D map {C, W, H, N}; w: packed weights as a 3-D
// map {C, 9, Co}; bias [co] f32; out [n, co, h, wd] bf16.  blockIdx.x walks
// (image, tile row, tile column), blockIdx.y the 128-channel output tiles.
template <int NWG>
__global__ void __launch_bounds__(NWG * 128 + 32)
conv3x3_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap wmap,
                     const float* __restrict__ bias, bf16* __restrict__ out,
                     int c, int co, int h, int wd, int th, int tw,
                     int tiles_x, int tiles_y, int wst) {
  constexpr int BM = NWG * 64;
  constexpr int CONSUMERS = NWG * 128;
  constexpr int LDC = BM + 8;  // epilogue tile [co][pixel], +16 B per row

  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* base_ptr = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t full_w = base, empty_w = base + 8 * MAX_W_STAGES;
  const uint32_t full_h = base + 16 * MAX_W_STAGES;
  const uint32_t empty_h = full_h + 8 * HALO_STAGES;
  const uint32_t w_ring = base + HEADER;
  const uint32_t h_ring = w_ring + wst * W_TILE;
  const int h_stage = halo_bytes(th, tw);
  bf16* cs = reinterpret_cast<bf16*>(base_ptr + HEADER + wst * W_TILE);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;

  int bx = blockIdx.x;
  const int x0 = (bx % tiles_x) * tw;
  bx /= tiles_x;
  const int r0 = (bx % tiles_y) * th;
  const int img = bx / tiles_y;
  const int co0 = blockIdx.y * BN;
  const int n_chunks = (c + BK - 1) / BK;

  if (tid == 0) {
    for (int i = 0; i < wst; ++i) {
      mbar_init(full_w + 8 * i, 1);
      mbar_init(empty_w + 8 * i, NWG * 4);
    }
    for (int i = 0; i < HALO_STAGES; ++i) {
      mbar_init(full_h + 8 * i, 1);
      mbar_init(empty_h + 8 * i, NWG * 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == NWG * 4) {
    // ---- producer: one lane keeps the TMA loads in flight ----
    if (lane == 0) {
      const uint32_t halo_tx = (uint32_t)((th + 2) * (tw + 2) * BK * 2);
      int ws = 0, hs = 0;
      uint32_t wph = 1, hph = 1;  // a fresh barrier's "previous" phase is done
      for (int ch = 0; ch < n_chunks; ++ch) {
        mbar_wait(empty_h + 8 * hs, hph);
        mbar_expect_tx(full_h + 8 * hs, halo_tx);
        tma_load_4d(h_ring + hs * h_stage, &xmap, full_h + 8 * hs, ch * BK,
                    x0 - 1, r0 - 1, img);
        if (++hs == HALO_STAGES) { hs = 0; hph ^= 1; }
        for (int tap = 0; tap < 9; ++tap) {
          mbar_wait(empty_w + 8 * ws, wph);
          mbar_expect_tx(full_w + 8 * ws, W_TILE);
          tma_load_3d(w_ring + ws * W_TILE, &wmap, full_w + 8 * ws, ch * BK,
                      tap, co0);
          if (++ws == wst) { ws = 0; wph ^= 1; }
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns pixel slots [64 wg, 64 wg + 64) of the
  // tile; slot s is pixel (s / tw, s % tw) of the rectangle ----
  const int wg = warp >> 2, w4 = warp & 3;
  const int valid = th * tw;
  // ldmatrix.x4: lanes 0-15 give rows 0-15 at k 0-7, lanes 16-31 at k 8-15
  const int lrow = lane & 15, khalf = lane >> 4;
  int lslot = wg * 64 + w4 * 16 + lrow;
  if (lslot >= valid) lslot = 0;  // computed, never stored
  // this lane's row of the A fragment as a halo pixel, at tap (0, 0)
  const int hp0 = (lslot / tw) * (tw + 2) + lslot % tw;

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  // A fragments of one tap: lane's pixel row at the tap's offset, the four
  // k16 steps of the chunk at their swizzled 16-byte chunks.
  auto load_a = [&](uint32_t (&a)[BK / 16][4], uint32_t halo, int tap) {
    const int hp = hp0 + (tap / 3) * (tw + 2) + tap % 3;
    const uint32_t row = halo + hp * (BK * 2);
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks)
      ldmatrix_x4(a[ks], row + (((ks * 2 + khalf) ^ (hp & 7)) << 4));
  };

  // Within a chunk the taps are software-pipelined: while the tensor cores
  // work on tap i (committed, not waited for), the fragments of tap i + 1
  // are loaded into the other register set; a weight stage is released once
  // the wgmma group that read it has completed.
  int ws = 0, hs = 0;
  uint32_t wph = 0, hph = 0;
#pragma unroll 1
  for (int ch = 0; ch < n_chunks; ++ch) {
    mbar_wait(full_h + 8 * hs, hph);
    const uint32_t halo = h_ring + hs * h_stage;
    uint32_t a[2][BK / 16][4];
    load_a(a[0], halo, 0);
    int prev = 0;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      mbar_wait(full_w + 8 * ws, wph);
      const uint64_t bdesc = desc_sw128(w_ring + ws * W_TILE, 16, 1024);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks)
        wgmma_m64n128k16_rs(acc, a[tap & 1][ks], bdesc + 2 * ks, 1);
      wgmma_commit();
      if (tap > 0) {
        wgmma_wait<1>();  // tap - 1 is done with its weights and fragments
        __syncwarp();
        if (lane == 0) mbar_arrive(empty_w + 8 * prev);
      }
      prev = ws;
      if (++ws == wst) { ws = 0; wph ^= 1; }
      if (tap < 8) load_a(a[(tap + 1) & 1], halo, tap + 1);
    }
    wgmma_wait<0>();
    __syncwarp();
    if (lane == 0) {
      mbar_arrive(empty_w + 8 * prev);
      mbar_arrive(empty_h + 8 * hs);
    }
    if (++hs == HALO_STAGES) { hs = 0; hph ^= 1; }
  }

  // ---- epilogue: every halo load has landed and been read by its consumer
  // once all consumers are here, so the halo ring's memory is free ----
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
  const int g = lane >> 2, t = lane & 3;
  const int slot = wg * 64 + w4 * 16 + g;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = j * 8 + 2 * t;
    const float b0 = co0 + col < co ? bias[co0 + col] : 0.f;
    const float b1 = co0 + col + 1 < co ? bias[co0 + col + 1] : 0.f;
    cs[col * LDC + slot] = __float2bfloat16(acc[4 * j] + b0);
    cs[(col + 1) * LDC + slot] = __float2bfloat16(acc[4 * j + 1] + b1);
    cs[col * LDC + slot + 8] = __float2bfloat16(acc[4 * j + 2] + b0);
    cs[(col + 1) * LDC + slot + 8] = __float2bfloat16(acc[4 * j + 3] + b1);
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");

  bf16* on = out + (size_t)img * co * h * wd;
  if (wd % 8 == 0 && tw % 8 == 0) {
    const int segs = tw / 8;
    for (int i = tid; i < BN * th * segs; i += CONSUMERS) {
      const int seg = i % segs, ty = (i / segs) % th, col = i / (segs * th);
      const int x = x0 + seg * 8, y = r0 + ty;
      if (co0 + col < co && y < h && x < wd)
        *reinterpret_cast<uint4*>(on + ((size_t)(co0 + col) * h + y) * wd + x) =
            *reinterpret_cast<const uint4*>(cs + col * LDC + ty * tw + seg * 8);
    }
  } else {
    for (int i = tid; i < BN * valid; i += CONSUMERS) {
      const int s = i % valid, col = i / valid;
      const int x = x0 + s % tw, y = r0 + s / tw;
      if (co0 + col < co && y < h && x < wd)
        on[((size_t)(co0 + col) * h + y) * wd + x] = cs[col * LDC + s];
    }
  }
}

// [N, C, HW] -> [N, HW, C], 64 channels x 64 pixels per block through a
// chunk-swizzled shared tile: 16-byte global accesses on both sides (pixels
// in, channels out), conflict-free shared accesses on both.
__global__ void __launch_bounds__(256)
nchw_to_nhwc_kernel(const bf16* __restrict__ x, bf16* __restrict__ y, int c,
                    int hw) {
  __shared__ __align__(16) bf16 tile[64][64];  // [channel][pixel chunk ^ c/8]
  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * 64, c0 = blockIdx.y * 64;
  const bf16* xin = x + (size_t)blockIdx.z * c * hw;
  bf16* yout = y + (size_t)blockIdx.z * hw * c;
  const bool vec = hw % 8 == 0;
  for (int i = tid; i < 512; i += 256) {
    const int v = i % 8, ch = i / 8;
    const int cc = c0 + ch, pp = p0 + v * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (cc < c) {
      const bf16* src = xin + (size_t)cc * hw + pp;
      if (vec && pp < hw) {
        val = *reinterpret_cast<const uint4*>(src);
      } else {
        bf16* e = reinterpret_cast<bf16*>(&val);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (pp + j < hw) e[j] = src[j];
      }
    }
    *reinterpret_cast<uint4*>(&tile[ch][(v ^ (ch >> 3)) * 8]) = val;
  }
  __syncthreads();
  for (int i = tid; i < 512; i += 256) {
    const int v = i % 8, px = i / 8;  // 8 channels c0 + 8v.., pixel p0 + px
    const int pp = p0 + px, cc = c0 + v * 8;
    if (pp < hw && cc < c) {  // c % 8 == 0: the chunk is whole
      uint4 val;
      bf16* e = reinterpret_cast<bf16*>(&val);
      const int col = (((px >> 3) ^ v) << 3) + (px & 7);
#pragma unroll
      for (int j = 0; j < 8; ++j) e[j] = tile[v * 8 + j][col];
      *reinterpret_cast<uint4*>(yout + (size_t)pp * c + cc) = val;
    }
  }
}

template <int NWG>
int launch(const CUtensorMap& xmap, const CUtensorMap& wmap,
           const float* bias, bf16* out, int c, int co, int h, int w, int th,
           int tw, int tiles_x, int tiles_y, int wst, dim3 grid, int smem,
           cudaStream_t stream) {
  auto kern = conv3x3_wgmma_kernel<NWG>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, NWG * 128 + 32, smem, stream>>>(
      xmap, wmap, bias, out, c, co, h, w, th, tw, tiles_x, tiles_y, wst);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The pre-pass.  x: contiguous [n, c, h*w] bf16; y: contiguous [n, h*w, c]
// bf16, both 16-byte aligned on the current device; c a multiple of 8.
// Returns 0 or a cudaError_t code.
int fgdm_nchw_to_nhwc(const void* x, void* y, int n, int c, int hw,
                      void* stream) {
  if (n <= 0 || c <= 0 || hw <= 0 || c % 8 != 0 || n > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid((hw + 63) / 64, (c + 63) / 64, n);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  nchw_to_nhwc_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<bf16*>(y), c, hw);
  return (int)cudaGetLastError();
}

// The conv.  xt: contiguous [n, h, w, c] bf16 (the pre-pass's output); wk:
// contiguous [co, 9, c] bf16; bias: contiguous [co] f32; out: contiguous
// [n, co, h, w] bf16; all 16-byte aligned on the current device; c a multiple
// of 8.  The tile: bm = 64 or 128 pixel slots, th x tw <= bm pixels of
// one image, wst weight stages, smem the dynamic shared memory
// (conv3x3_plan's numbers; checked against this file's).  Returns 0, a
// cudaError_t code (launch errors included) or a tensor-map error.
int fgdm_conv3x3(const void* xt, const void* wk, const void* bias, void* out,
                 int n, int c, int co, int h, int w, int bm, int th, int tw,
                 int wst, int smem, void* stream) {
  if (n <= 0 || c <= 0 || co <= 0 || h <= 0 || w <= 0 || c % 8 != 0 ||
      th <= 0 || tw <= 0 || th * tw > bm || th > 254 || tw > 254 ||
      wst < 2 || wst > MAX_W_STAGES || smem != smem_bytes(bm, th, tw, wst))
    return (int)cudaErrorInvalidValue;
  const int tiles_x = (w + tw - 1) / tw, tiles_y = (h + th - 1) / th;
  const long long gx = (long long)tiles_x * tiles_y * n;
  const int gy = (co + BN - 1) / BN;
  if (gx > 0x7fffffffLL || gy > 65535) return (int)cudaErrorInvalidValue;

  CUtensorMap xmap, wmap;
  const cuuint64_t xd[4] = {(cuuint64_t)c, (cuuint64_t)w, (cuuint64_t)h,
                            (cuuint64_t)n};
  const cuuint64_t xs[3] = {(cuuint64_t)c * 2, (cuuint64_t)w * c * 2,
                            (cuuint64_t)h * w * c * 2};
  const cuuint32_t xb[4] = {BK, (cuuint32_t)(tw + 2), (cuuint32_t)(th + 2), 1};
  int rc = encode_bf16_map(&xmap, xt, 4, xd, xs, xb);
  if (rc != 0) return rc;
  const cuuint64_t wd[3] = {(cuuint64_t)c, 9, (cuuint64_t)co};
  const cuuint64_t wsb[2] = {(cuuint64_t)c * 2, (cuuint64_t)c * 18};
  const cuuint32_t wb[3] = {BK, 1, BN};
  rc = encode_bf16_map(&wmap, wk, 3, wd, wsb, wb);
  if (rc != 0) return rc;

  const dim3 grid((unsigned)gx, gy);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  bf16* o = static_cast<bf16*>(out);
  switch (bm) {
    case 64:
      return launch<1>(xmap, wmap, b, o, c, co, h, w, th, tw, tiles_x,
                       tiles_y, wst, grid, smem, s);
    case 128:
      return launch<2>(xmap, wmap, b, o, c, co, h, w, th, tw, tiles_x,
                       tiles_y, wst, grid, smem, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* fgdm_cuda_error_string(int code) { return error_string(code); }

}  // extern "C"
