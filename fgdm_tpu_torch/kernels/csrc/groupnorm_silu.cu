// Fused GroupNorm + affine (+ SiLU) for Hopper (sm_90a): one launch a call,
// one thread-block cluster a (batch, group).
//
// Replaces the Pallas TPU kernel fgdm_tpu/kernels/groupnorm.py:68 _kernel
// (pallas_call :183).  There a sequential grid (b, 2, n_chunks) carries the
// channel sums in VMEM scratch from phase 0 (sums) to phase 1 (normalise),
// so x crosses HBM twice.  Here the layout is the port's NCHW, where each
// (batch, group) is one contiguous span of C/G * H*W elements, and the
// statistics never leave the chip: the blocks of one cluster share them
// through distributed shared memory (DSMEM) in place of the TPU's scratch.
//
// What bounds it on the card: bytes.  The least it must move is one read of
// x and one write of y (plus the C weights and biases); it does about ten
// f32 operations an element, far below the f32 rate.  The design reaches
// for that bound by reading x from device memory once:
//
//   * The grid is one cluster of k blocks (k in {1, 2, 4, 8, 16}) per
//     (batch, group).  Block `rank` owns the slice [rank*slice,
//     (rank+1)*slice) of its group's span (the last one shorter).  The host
//     picks k, the slice, the threads and the shared memory
//     (kernels/groupnorm.py gn_plan): the smallest k whose slices fit a
//     block's share of an SM and that gives about one wave of blocks.
//   * Load once: one thread brings the slice into dynamic shared memory with
//     1-D bulk copies (cp.async.bulk ... mbarrier::complete_tx) of CHUNK
//     bytes, one mbarrier each, so that the sums start on the first chunk
//     while the others are in flight.
//   * Statistics, in f32, in one pass: s1 = sum(x - K) and s2 = sum((x -
//     K)^2) with K the slice's first element, so the block's triple is n,
//     mean = K + s1/n, M2 = s2 - s1*s1/n.  These are the TPU kernel's sum
//     and sum of squares (groupnorm.py:117-119), shifted: unshifted, E[x^2]
//     - mean^2 loses the variance to cancellation when |mean| >> std, while
//     K lies within a few std of the mean.  One pass, not a centred second
//     one, because the statistics sit on the critical path of every call
//     (no store can start before them) and a second pass costs a block
//     reduction and ~2 instructions an element.
//   * Each block publishes its triple in its own shared memory; a cluster
//     barrier; warp 0 of every block reads all k triples through DSMEM and
//     combines them in rank order (Chan et al.), so every block gets the
//     same mean and rstd, with no atomics, and reruns are bit-identical.
//     Block sums are fixed shuffle trees, so the whole result is.
//   * Normalise from shared memory: mul = rstd*w_c and add = b_c - mean*mul
//     for the group's C/G channels in a table; y = x*mul + add, SiLU in f32
//     (template flag), one rounding, 16-byte stores.  A vector's channel is
//     a multiply-high, not a division.
//   * Groups larger than a cluster's shared memory (the 512^2 VAE planes):
//     each block keeps `resident` elements of its slice in shared memory and
//     streams the rest twice inside the same launch, once for the statistics
//     (asked into L2 at the start, read after the first chunk has landed)
//     and once to normalise; the second read comes mostly from the 50 MB L2.
//   * A group whose span is not a multiple of 16 bytes (or an unaligned x)
//     cannot take bulk copies or 16-byte accesses: the same kernel loads and
//     stores it an element at a time (vec = 0).
//   * DSMEM lifetime: a block arrives at a second cluster barrier once its
//     warp 0 has read the peers' triples and waits on it at its very end,
//     so no block exits while a peer may still read its shared memory.
//
// Numerics follow the plain version: f32 statistics, f32 affine and SiLU,
// one cast to x's dtype (bf16, f16 or f32).

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace fgdm;

constexpr int SMEM_BLOCK = 232448;  // dynamic shared memory a block may take
constexpr int HEADER = 1024;        // barriers, triple, reduction scratch
constexpr int CHUNK = 16384;        // bytes of one bulk copy and its mbarrier
constexpr int MAX_CHUNKS = 16;      // mbarriers in the header
constexpr int MAX_THREADS = 512;
constexpr int MAX_CLUSTER = 16;     // non-portable above 8
constexpr int STAT_OFF = 128;       // the block's triple: mean, M2, n
constexpr int RED_OFF = 192;        // two floats per warp
static_assert(MAX_CHUNKS * 8 <= STAT_OFF, "barriers overlap the triple");
static_assert(RED_OFF + 2 * 4 * (MAX_THREADS / 32) <= HEADER,
              "reduction scratch overlaps the table");
static_assert((SMEM_BLOCK - HEADER + CHUNK - 1) / CHUNK <= MAX_CHUNKS,
              "a resident slice needs more barriers");

// Bytes of the per-channel table (mul, add), rounded to 16.
__host__ __device__ constexpr int table_bytes(int cpg) {
  return (8 * cpg + 15) / 16 * 16;
}

// --- element types: f32 conversions, 16-byte vectors of V elements --------

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static __device__ __forceinline__ float to(float v) { return v; }
  static __device__ __forceinline__ float from(float v) { return v; }
  static __device__ __forceinline__ void unpack(uint32_t w, float* f) {
    f[0] = __uint_as_float(w);
  }
  static __device__ __forceinline__ uint32_t pack(const float* f) {
    return __float_as_uint(f[0]);
  }
};

template <>
struct Elem<bf16> {
  static __device__ __forceinline__ float to(bf16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ bf16 from(float v) {
    return __float2bfloat16_rn(v);
  }
  static __device__ __forceinline__ void unpack(uint32_t w, float* f) {
    f[0] = __uint_as_float(w << 16);
    f[1] = __uint_as_float(w & 0xffff0000u);
  }
  static __device__ __forceinline__ uint32_t pack(const float* f) {
    return pack_bf16(f[0], f[1]);
  }
};

template <>
struct Elem<__half> {
  static __device__ __forceinline__ float to(__half v) {
    return __half2float(v);
  }
  static __device__ __forceinline__ __half from(float v) {
    return __float2half_rn(v);
  }
  static __device__ __forceinline__ void unpack(uint32_t w, float* f) {
    f[0] = __half2float(__ushort_as_half((unsigned short)(w & 0xffffu)));
    f[1] = __half2float(__ushort_as_half((unsigned short)(w >> 16)));
  }
  static __device__ __forceinline__ uint32_t pack(const float* f) {
    __half2 h = __floats2half2_rn(f[0], f[1]);
    return *reinterpret_cast<uint32_t*>(&h);
  }
};

// V consecutive elements as f32: one 16-byte access (V = 16 / sizeof(T),
// address 16-byte aligned) or one element (V = 1).
template <typename T, int V>
__device__ __forceinline__ void load(const T* p, float (&f)[V]) {
  if constexpr (V == 1) {
    f[0] = Elem<T>::to(*p);
  } else {
    static_assert(V * sizeof(T) == 16, "a vector is 16 bytes");
    constexpr int PER = 4 / sizeof(T);  // elements in a 32-bit word
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) Elem<T>::unpack(w[i], f + i * PER);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store(T* p, const float (&f)[V]) {
  if constexpr (V == 1) {
    *p = Elem<T>::from(f[0]);
  } else {
    constexpr int PER = 4 / sizeof(T);
    uint4 u;
    u.x = Elem<T>::pack(f);
    u.y = Elem<T>::pack(f + PER);
    u.z = Elem<T>::pack(f + 2 * PER);
    u.w = Elem<T>::pack(f + 3 * PER);
    *reinterpret_cast<uint4*>(p) = u;
  }
}

// --- block sums: fixed shuffle trees, the same bits on every thread -------

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// a and b summed over the block, returned to every thread.
__device__ __forceinline__ void block_sum2(float& a, float& b, float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  a = warp_sum(a);
  b = warp_sum(b);
  __syncthreads();  // the scratch's previous readers are done
  if (lane == 0) {
    red[warp] = a;
    red[MAX_THREADS / 32 + warp] = b;
  }
  __syncthreads();
  a = warp_sum(lane < warps ? red[lane] : 0.f);
  b = warp_sum(lane < warps ? red[MAX_THREADS / 32 + lane] : 0.f);
}

template <bool SILU>
__device__ __forceinline__ float act(float v) {
  if constexpr (SILU)
    return __fdividef(v, 1.f + __expf(-v));
  else
    return v;
}

// e / hw for 0 <= e < 2^31 as a multiply-high and a shift (the divisor's
// magic number, as CUTLASS's FastDivmod): one integer division a block, not
// one a vector.
struct Channel {
  int hw;
  uint32_t mul, shr;
  __device__ explicit Channel(int hw_) : hw(hw_), mul(0), shr(0) {
    if (hw > 1) {
      const uint32_t p = 31 + (32 - __clz(hw - 1));  // 31 + ceil(log2 hw)
      mul = (uint32_t)(((1ull << p) + (uint64_t)hw - 1) / (uint64_t)hw);
      shr = p - 32;
    }
  }
  __device__ __forceinline__ int of(int e) const {
    return hw > 1 ? (int)(__umulhi((uint32_t)e, mul) >> shr) : e;
  }
};

// y = act(x * mul[c] + add[c]) for V consecutive elements, the first at
// index e of the group's span (channel e / hw).  `whole`: hw is a multiple
// of V (and e of V), so the vector lies in one channel; else it may cross
// into the next ones.
template <bool SILU, int V>
__device__ __forceinline__ void normalise(float (&f)[V], int e,
                                          const Channel& ch, bool whole,
                                          const float* mul,
                                          const float* add) {
  int c = ch.of(e);
  float m = mul[c], a = add[c];
  if (whole) {
#pragma unroll
    for (int j = 0; j < V; ++j) f[j] = act<SILU>(fmaf(f[j], m, a));
    return;
  }
  int next = (c + 1) * ch.hw;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    if (e + j >= next) {
      ++c;
      next += ch.hw;
      m = mul[c];
      a = add[c];
    }
    f[j] = act<SILU>(fmaf(f[j], m, a));
  }
}

// The block's statistics pass, V elements an access: sums of d = x - shift
// and d^2 over its slice.  The resident part comes from shared memory chunk
// by chunk as its bulk copies land (`bars`, or none when the slice was
// loaded an element at a time); the streamed part from device memory is
// read after the first chunk, while the others are still in flight.
template <typename T, int V>
__device__ __forceinline__ void add_shifted(const T* p, float shift,
                                            float& s1, float& s2) {
  float f[V];
  load<T, V>(p, f);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const float d = f[j] - shift;
    s1 += d;
    s2 = fmaf(d, d, s2);
  }
}

template <typename T, int V>
__device__ __forceinline__ void shifted_sums(const T* xs, int nres,
                                             const uint64_t* bars,
                                             const T* xstream, int nstream,
                                             float shift, float& s1,
                                             float& s2) {
  const int nv = nres / V, per = CHUNK / (V * (int)sizeof(T));
  for (int c = 0; c * per < nv; ++c) {
    if (bars != nullptr) mbar_wait(smem_u32(bars + c), 0);
    const int end = min(nv, (c + 1) * per);
    for (int v = c * per + threadIdx.x; v < end; v += blockDim.x)
      add_shifted<T, V>(xs + v * V, shift, s1, s2);
    if (c == 0) {
#pragma unroll 4
      for (int v = threadIdx.x; v < nstream / V; v += blockDim.x)
        add_shifted<T, V>(xstream + v * V, shift, s1, s2);
    }
  }
}

template <typename T, bool SILU, int V>
__device__ __forceinline__ void write_out(const T* xs, int nres,
                                          const T* xstream, int nstream,
                                          T* y, int start, const Channel& ch,
                                          const float* mul,
                                          const float* add) {
  const bool whole = ch.hw % V == 0;
  for (int v = threadIdx.x; v < nres / V; v += blockDim.x) {
    float f[V];
    load<T, V>(xs + v * V, f);
    normalise<SILU, V>(f, start + v * V, ch, whole, mul, add);
    store<T, V>(y + v * V, f);
  }
#pragma unroll 4
  for (int v = threadIdx.x; v < nstream / V; v += blockDim.x) {
    float f[V];
    load<T, V>(xstream + v * V, f);
    normalise<SILU, V>(f, start + nres + v * V, ch, whole, mul, add);
    store<T, V>(y + nres + v * V, f);
  }
}

// grid = (batch * groups) clusters of k blocks along x.  w, b: f32 [C].
// span = cpg * hw elements a group; block `rank` owns [rank*slice,
// min((rank+1)*slice, span)) and keeps its first `resident` elements in
// shared memory.  vec: 16-byte accesses and bulk copies (x and y 16-byte
// aligned, span, slice and resident multiples of 16 bytes), else one
// element at a time.
template <typename T, bool SILU>
__global__ void __launch_bounds__(MAX_THREADS)
    gn_silu_kernel(const T* __restrict__ x, T* __restrict__ y,
                   const float* __restrict__ w, const float* __restrict__ b,
                   int num_groups, int cpg, int hw, int span, int slice,
                   int resident, int vec, float eps) {
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  uint32_t* stat = reinterpret_cast<uint32_t*>(smem + STAT_OFF);
  float* red = reinterpret_cast<float*>(smem + RED_OFF);
  float* mul = reinterpret_cast<float*>(smem + HEADER);
  float* add = mul + cpg;
  T* xs = reinterpret_cast<T*>(smem + HEADER + table_bytes(cpg));
  constexpr int V = 16 / sizeof(T);

  const int k = (int)cluster_blocks(), rank = (int)cluster_rank();
  const long long grp = blockIdx.x / k;  // batch * num_groups + group
  const int start = rank * slice;
  const int n = max(0, min(slice, span - start));
  const int nres = min(n, resident), nstream = n - nres;
  const T* xg = x + grp * span + start;
  T* yg = y + grp * span + start;
  const int tid = threadIdx.x;

  // 1. the resident part into shared memory; the streamed part towards L2
  if (vec) {
    const int bytes = nres * (int)sizeof(T);
    const int chunks = (bytes + CHUNK - 1) / CHUNK;
    if (tid == 0) {
      for (int c = 0; c < chunks; ++c) mbar_init(smem_u32(bars + c), 1);
      mbar_fence_init();
      for (int c = 0; c < chunks; ++c) {
        const int off = c * CHUNK, len = min(CHUNK, bytes - off);
        mbar_expect_tx(smem_u32(bars + c), (uint32_t)len);
        bulk_load(smem_u32(xs) + off, reinterpret_cast<const char*>(xg) + off,
                  (uint32_t)len, smem_u32(bars + c));
      }
      const char* rest = reinterpret_cast<const char*>(xg + nres);
      for (int off = 0; off < nstream * (int)sizeof(T); off += CHUNK)
        bulk_prefetch_l2(rest + off,
                         (uint32_t)min(CHUNK, nstream * (int)sizeof(T) - off));
    }
  } else {
    for (int i = tid; i < nres; i += blockDim.x) xs[i] = xg[i];
  }
  __syncthreads();  // barriers initialised, or the element loads stored

  // 2. the block's triple (n, mean, M2) from sums of x - shift, the shift
  // being the slice's first element: one pass, and no cancellation where
  // |mean| >> std, as the TPU's E[x^2] - mean^2 would suffer
  float shift = 0.f, s1 = 0.f, s2 = 0.f;
  if (nres > 0) {
    if (vec) mbar_wait(smem_u32(bars), 0);
    shift = Elem<T>::to(xs[0]);
  }
  if (vec)
    shifted_sums<T, V>(xs, nres, bars, xg + nres, nstream, shift, s1, s2);
  else
    shifted_sums<T, 1>(xs, nres, nullptr, xg + nres, nstream, shift, s1,
                       s2);
  block_sum2(s1, s2, red);
  if (tid == 0) {
    const float nf = (float)max(n, 1);
    stat[0] = __float_as_uint(shift + s1 / nf);
    stat[1] = __float_as_uint(fmaxf(s2 - s1 * (s1 / nf), 0.f));
    stat[2] = (uint32_t)n;
  }
  cluster_arrive();
  cluster_wait();

  // 3. warp 0 combines the k triples in rank order and fills the table
  if (tid < 32) {
    float mj = 0.f, m2j = 0.f;
    uint32_t nj = 0;
    if (tid < k) {
      const uint32_t a = map_to_rank(smem_u32(stat), (uint32_t)tid);
      mj = __uint_as_float(ld_cluster_u32(a));
      m2j = __uint_as_float(ld_cluster_u32(a + 4));
      nj = ld_cluster_u32(a + 8);
    }
    float mean = 0.f, m2 = 0.f, cnt = 0.f;
    for (int j = 0; j < k; ++j) {
      const float mb = __shfl_sync(0xffffffffu, mj, j);
      const float m2b = __shfl_sync(0xffffffffu, m2j, j);
      const uint32_t nb = __shfl_sync(0xffffffffu, nj, j);
      if (nb == 0) continue;
      const float tot = cnt + (float)nb, fb = (float)nb / tot;
      const float delta = mb - mean;
      mean = fmaf(delta, fb, mean);
      m2 = m2 + m2b + delta * delta * cnt * fb;
      cnt = tot;
    }
    const float rstd = rsqrtf(m2 / (float)span + eps);
    const int c0 = (int)(grp % num_groups) * cpg;
    for (int c = tid; c < cpg; c += 32) {
      const float mc = rstd * w[c0 + c];
      mul[c] = mc;
      add[c] = b[c0 + c] - mean * mc;
    }
  }
  __syncthreads();  // the table is written; warp 0 has read its peers
  cluster_arrive();  // this block no longer reads the peers' memory

  // 4. normalise, affine, SiLU, one rounding
  const Channel ch(hw);
  if (vec)
    write_out<T, SILU, V>(xs, nres, xg + nres, nstream, yg, start, ch, mul,
                          add);
  else
    write_out<T, SILU, 1>(xs, nres, xg + nres, nstream, yg, start, ch, mul,
                          add);
  cluster_wait();  // no block leaves while a peer may read its triple
}

// Per device, once per instantiation: the dynamic shared memory above 48 KB
// and clusters of 16 (non-portable) allowed.
template <typename T, bool SILU>
int prepare() {
  static unsigned long long ready = 0;  // one bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (bit && (ready & bit)) return 0;
  err = cudaFuncSetAttribute(gn_silu_kernel<T, SILU>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BLOCK);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(gn_silu_kernel<T, SILU>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
  if (err != cudaSuccess) return (int)err;
  ready |= bit;
  return 0;
}

cudaLaunchConfig_t config(int clusters, int k, int threads, int smem,
                          cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)clusters * (unsigned)k);
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)k;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename T, bool SILU>
int launch(const void* x, void* y, const void* w, const void* b,
           int clusters, int num_groups, int cpg, int hw, int span,
           int slice, int resident, int k, int threads, int smem, int vec,
           float eps, cudaStream_t stream) {
  int rc = prepare<T, SILU>();
  if (rc != 0) return rc;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      config(clusters, k, threads, smem, stream, attr);
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, gn_silu_kernel<T, SILU>, static_cast<const T*>(x),
      static_cast<T*>(y), static_cast<const float*>(w),
      static_cast<const float*>(b), num_groups, cpg, hw, span, slice,
      resident, vec, eps);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int max_clusters(int k, int threads, int smem, int* out) {
  int rc = prepare<T, true>();
  if (rc != 0) return rc;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(1, k, threads, smem, nullptr, attr);
  return (int)cudaOccupancyMaxActiveClusters(
      out, (const void*)gn_silu_kernel<T, true>, &cfg);
}

int elem_bytes(int dtype) { return dtype == 0 ? 4 : 2; }

}  // namespace

extern "C" {

// y = act(GroupNorm(x) * w + b) over x contiguous [batch, C, hw] on the
// current device.  dtype: 0 f32, 1 bf16, 2 f16 (x and y); w and b
// contiguous f32 [C]; clusters = batch * num_groups; cpg = C / num_groups;
// span = cpg * hw.  The plan (k, threads, slice, resident, smem, vec) is
// kernels/groupnorm.py gn_plan's, checked against this file's constants.
// Returns 0 or a cudaError_t code (launch errors included).
int fgdm_group_norm_silu(const void* x, void* y, const void* w, const void* b,
                         int dtype, int silu, int clusters, int num_groups,
                         int cpg, int hw, int span, int slice, int resident,
                         int k, int threads, int smem, int vec, float eps,
                         void* stream) {
  const int es = elem_bytes(dtype);
  const bool ok_k = k == 1 || k == 2 || k == 4 || k == 8 || k == MAX_CLUSTER;
  if (dtype < 0 || dtype > 2 || clusters <= 0 || num_groups <= 0 ||
      cpg <= 0 || hw <= 0 || (long long)cpg * hw != span || !ok_k ||
      slice <= 0 || (long long)k * slice < span || resident <= 0 ||
      resident > slice || threads < 128 || threads > MAX_THREADS ||
      threads % 32 != 0 || (long long)clusters * k > 0x7fffffffLL ||
      smem != HEADER + table_bytes(cpg) + resident * es || smem > SMEM_BLOCK)
    return (int)cudaErrorInvalidValue;
  if (vec && ((uintptr_t)x % 16 || (uintptr_t)y % 16 || span * es % 16 ||
              slice * es % 16 || resident * es % 16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FGDM_GN_LAUNCH(T, SILU)                                              \
  launch<T, SILU>(x, y, w, b, clusters, num_groups, cpg, hw, span, slice,  \
                  resident, k, threads, smem, vec, eps, s)
  switch (dtype * 2 + (silu ? 1 : 0)) {
    case 0: return FGDM_GN_LAUNCH(float, false);
    case 1: return FGDM_GN_LAUNCH(float, true);
    case 2: return FGDM_GN_LAUNCH(bf16, false);
    case 3: return FGDM_GN_LAUNCH(bf16, true);
    case 4: return FGDM_GN_LAUNCH(__half, false);
    default: return FGDM_GN_LAUNCH(__half, true);
  }
#undef FGDM_GN_LAUNCH
}

// How many clusters of k blocks (threads and smem bytes each) the current
// device holds at once (cudaOccupancyMaxActiveClusters), into *out; 0 means
// such a cluster does not schedule.  Returns 0 or a cudaError_t code.
int fgdm_gn_max_active_clusters(int dtype, int k, int threads, int smem,
                                int* out) {
  if (out == nullptr || k < 1 || k > MAX_CLUSTER || threads < 32 ||
      threads > MAX_THREADS || smem < 0 || smem > SMEM_BLOCK)
    return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return max_clusters<float>(k, threads, smem, out);
    case 1: return max_clusters<bf16>(k, threads, smem, out);
    case 2: return max_clusters<__half>(k, threads, smem, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* fgdm_cuda_error_string(int code) { return error_string(code); }

}  // extern "C"
