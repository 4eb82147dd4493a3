// Amax-scaled int8 / fp8 (e4m3) fake quantization of the split-link
// payloads, for Hopper (sm_90a).  Built by repro_torch/kernels/build.py into
// a shared library with a plain C interface and bound with ctypes
// (repro_torch/kernels/quantize.py).
//
// The input is S slices of n floats; each slice (one client's tensor) gets
// its own scale, as the JAX engine's vmapped calls give:
//   scale = amax(|x_s|) / qmax, or 1 where the amax is 0
//   int8: clip(round_half_even(x / scale), -127, 127) * scale
//   fp8:  e4m3(x / scale) * scale
//
// Two routes, picked by the wrapper's plan (quantize.py: plan()) from the
// slice size alone, before any launch:
//
// 1. One pass, quantize_fused_kernel, for every slice that a thread block
//    cluster holds in shared memory.  Replaces both TPU kernels of
//    src/repro/kernels/quantize.py, _amax_kernel (:74) and _qdq_kernel (:88).
//    One cluster of C blocks (C = 1, 2, 4 or 8, the smallest whose share,
//    n / C floats, fits a block's shared memory) takes one slice: each block
//    brings its share on chip with bulk asynchronous copies (cp.async.bulk,
//    kChunkBytes a copy, each completing on its own mbarrier, all issued
//    before the math) and takes the max of |x| chunk by chunk as they land.
//    The blocks publish their maxima in shared memory; after a cluster
//    barrier every block reads the C maxima through distributed shared
//    memory and takes the same amax.  The round trip is then computed from
//    shared memory and written with 16-byte stores.  So the slice is read
//    from device memory once, not twice, in one launch, with no fill of an
//    amax buffer and no atomics.  A second cluster barrier, waited on just
//    before a block exits, keeps each block's shared memory alive until
//    every block of its cluster has read it.
// 2. Two passes, for slices beyond a cluster (the VGG cut tensors):
//    amax_kernel (replaces _amax_kernel, :74) writes one partial max per
//    block into scratch that every launch overwrites, from 16-byte loads,
//    kUnroll of them in flight a thread, over a grid sized from the SMs and
//    the blocks resident on each; qdq_kernel (replaces _qdq_kernel, :88)
//    takes the max of its slice's partials and writes the round trip.
//
// What bounds both: streaming, about one operation per byte, so device
// memory.  A call must read x once and write the result once, 8 bytes an
// element; the two-pass route reads x a second time.  The fused route
// confines a slice to its cluster's C SMs (80 of 132 at the training
// round's shape), and there each SM's own stream of loads, then of stores,
// sets the time rather than the card's memory: one slice alone takes
// most of the time that ten take (chip_smoke.py phase 3 prints the rate by
// number of slices and each phase's end from a -DQUANTIZE_PROFILE build).
// Max is exact and order-free, so every route gives the amax bit for bit
// as the plain version does.
//
// Bit-exactness with the plain version needs IEEE division (x / scale, not a
// multiply by the reciprocal) and round-half-to-even (rintf): the library is
// built without --use_fast_math.  fp8 goes through the hardware conversion
// with finite saturation; |x / scale| <= 448 up to one rounding, and values
// up to 464 round to 448 either way, so saturation never changes a result.
//
// No allocation and no synchronisation here: each entry point launches on
// the caller's stream and returns cudaGetLastError() (or the error of the
// attribute call or launch that failed).
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// the two-pass kernels: threads a block, 16-byte loads in flight a thread
constexpr int kThreads = 256;
constexpr int kUnroll = 4;
// the fused kernel: threads a block, bytes a bulk copy, blocks a cluster at
// most, and the most static shared memory a block may take besides its
// share (the wrapper's plan subtracts it from the card's opt-in limit)
constexpr int kFusedThreads = 512;
constexpr int kChunkBytes = 32768;
constexpr int kMaxCluster = 8;
constexpr int kScratchBytes = 1024;
// a share fits 227 KB (232,448 bytes), so it takes at most 8 chunks
constexpr int kMaxChunks = 8;
static_assert(kMaxChunks * kChunkBytes >= 232448, "too few chunk barriers");
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float warp_max(float m) {
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
  return m;
}

__device__ __forceinline__ float max4(float4 v) {
  return fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w)));
}

// The max of m over the block, in thread 0 (scratch: one float a warp).
template <int kBlock>
__device__ __forceinline__ float block_max(float m, float* warp_scratch) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  m = warp_max(m);
  if (lane == 0) warp_scratch[warp] = m;
  __syncthreads();
  m = lane < kBlock / 32 ? warp_scratch[lane] : 0.f;
  return warp == 0 ? warp_max(m) : 0.f;
}

__device__ __forceinline__ float scale_of(float amax, float qmax) {
  return amax > 0.f ? amax / qmax : 1.f;
}

// The round trip of x at scale s.  A zero passes as it is, sign and all,
// and divides 1 instead: IEEE division takes its slow path on a zero
// dividend, and the ReLU cut tensors are about half zeros.
template <bool kFp8>
__device__ __forceinline__ float qdq(float x, float s) {
  const float v = (x == 0.f ? 1.f : x) / s;
  float q;
  if (kFp8) {
    const __nv_fp8_storage_t b =
        __nv_cvt_float_to_fp8(v, __NV_SATFINITE, __NV_E4M3);
    q = __half2float(__half(__nv_cvt_fp8_to_halfraw(b, __NV_E4M3)));
  } else {
    q = fminf(fmaxf(rintf(v), -127.f), 127.f);
  }
  return x == 0.f ? x : q * s;
}

// Floats from p up to the next 16-byte boundary (0 if p lies on one).
__device__ __forceinline__ long long to_aligned(const float* p) {
  return (4 - (long long)((reinterpret_cast<uintptr_t>(p) >> 2) & 3)) & 3;
}

// ---------------------------------------------------------------------------
// the two-pass route
// ---------------------------------------------------------------------------

// grid (parts, S): partial[s * parts + b] = max |x| over block b's elements
// of slice s.  Every block writes its partial, so the scratch needs no fill.
__global__ void __launch_bounds__(kThreads)
amax_kernel(const float* __restrict__ x, long long n,
            float* __restrict__ partial) {
  __shared__ float warp_scratch[kThreads / 32];
  const float* xs = x + (size_t)blockIdx.y * n;
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kThreads;
  // the ragged ends by plain loads, the 16-byte body by vector loads
  const long long head = min(n, to_aligned(xs));
  const long long nv = (n - head) / 4;
  const long long tail = head + nv * 4;
  float m = 0.f;
  if (tid < head) m = fabsf(xs[tid]);
  if (tail + tid < n) m = fmaxf(m, fabsf(xs[tail + tid]));
  const float4* v = reinterpret_cast<const float4*>(xs + head);
  long long i = tid;
  for (; i + (kUnroll - 1) * stride < nv; i += kUnroll * stride) {
    float4 a[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) a[u] = __ldg(v + i + u * stride);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) m = fmaxf(m, max4(a[u]));
  }
  for (; i < nv; i += stride) m = fmaxf(m, max4(__ldg(v + i)));
  m = block_max<kThreads>(m, warp_scratch);
  if (threadIdx.x == 0)
    partial[(size_t)blockIdx.y * gridDim.x + blockIdx.x] = m;
}

// grid (blocks_per_slice(n), S).  Each block takes its slice's amax as the
// max of the amax pass's `parts` partials; block 0 of each slice writes it
// to `amax` where that is given.
template <bool kFp8>
__global__ void __launch_bounds__(kThreads)
qdq_kernel(const float* __restrict__ x, long long n,
           const float* __restrict__ partial, int parts, float qmax,
           float* __restrict__ out, float* __restrict__ amax) {
  __shared__ float warp_scratch[kThreads / 32];
  __shared__ float slice_amax;
  const float* ps = partial + (size_t)blockIdx.y * parts;
  float m = 0.f;
  for (int i = threadIdx.x; i < parts; i += kThreads) m = fmaxf(m, ps[i]);
  m = block_max<kThreads>(m, warp_scratch);
  if (threadIdx.x == 0) {
    slice_amax = m;
    if (amax != nullptr && blockIdx.x == 0) amax[blockIdx.y] = m;
  }
  __syncthreads();
  const float s = scale_of(slice_amax, qmax);
  const float* xs = x + (size_t)blockIdx.y * n;
  float* os = out + (size_t)blockIdx.y * n;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kThreads)
    os[i] = qdq<kFp8>(xs[i], s);
}

int blocks_per_slice(long long n) {
  const long long per_block = (long long)kThreads * 8;
  long long b = (n + per_block - 1) / per_block;
  if (b < 1) b = 1;
  if (b > 1024) b = 1024;
  return (int)b;
}

// ---------------------------------------------------------------------------
// the fused route: one cluster a slice
// ---------------------------------------------------------------------------

struct FusedScratch {
  uint64_t full[kMaxChunks];               // one mbarrier a bulk copy
  float warp_max[kFusedThreads / 32];
  float slot;                              // this block's max, for the cluster
  float amax;                              // the slice's amax
};
static_assert(sizeof(FusedScratch) <= kScratchBytes,
              "the plan reserves kScratchBytes of static shared memory");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t addr,
                                              uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(addr), "r"(parity)
      : "memory");
  return done != 0;
}

// Returns once the phase of parity `parity` has completed.  A wait of more
// than 2^35 clocks (over 15 s: a copy that never lands) traps, so that the
// launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  if (mbar_try_wait(addr, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(addr, parity))
    if (clock64() - t0 > (1ll << 35)) __trap();
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global
// memory into this block's shared memory, completing `bar`'s transactions
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned cluster_size() {
  unsigned c;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(c));
  return c;
}

__device__ __forceinline__ unsigned cluster_id() {
  unsigned c;
  asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(c));
  return c;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// `*p` in the shared memory of the cluster's block `rank`
__device__ __forceinline__ float ld_dsmem(const float* p, unsigned rank) {
  uint32_t remote;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_u32(p)), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(v)
               : "r"(remote)
               : "memory");
  return v;
}

#ifdef QUANTIZE_PROFILE
// The diagnostic build (-DQUANTIZE_PROFILE, a library of its own): thread 0
// of each fused block stamps the global timer (ns) at the block's start,
// when its share has landed and its max is taken, when the cluster's amax
// is known, and when every thread of the block has issued its stores.
constexpr int kProfileBlocks = 1024;
__device__ unsigned long long g_stamps[kProfileBlocks][4];

__device__ __forceinline__ void stamp(int k) {
  if (threadIdx.x == 0 && blockIdx.x < kProfileBlocks) {
    unsigned long long ns;
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(ns));
    g_stamps[blockIdx.x][k] = ns;
  }
}
#else
__device__ __forceinline__ void stamp(int) {}
#endif

// grid S * C blocks in clusters of C; cluster s takes slice s, its block r
// the floats [r * share, (r + 1) * share) of it.  Dynamic shared memory:
// `share` floats.
template <bool kFp8>
__global__ void __launch_bounds__(kFusedThreads, 1)
quantize_fused_kernel(const float* __restrict__ x, long long n, int share,
                      float qmax, float* __restrict__ out,
                      float* __restrict__ amax) {
  extern __shared__ __align__(128) float4 body_s[];
  __shared__ FusedScratch sc;
  stamp(0);
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const unsigned rank = cluster_rank(), c = cluster_size();
  const unsigned s = cluster_id();
  const float* xs = x + (size_t)s * n;
  float* os = out + (size_t)s * n;
  const long long lo = min(n, (long long)rank * share);
  const long long hi = min(n, lo + share);
  // the 16-byte-aligned body [a0, a1) goes by bulk copies; the at most 3
  // floats before it and 3 after it by plain loads, held in registers
  const long long a0 = min(hi, lo + to_aligned(xs + lo));
  const long long a1 = a0 + (hi - a0) / 4 * 4;
  const int body_bytes = (int)((a1 - a0) * 4);
  const int chunks = (body_bytes + kChunkBytes - 1) / kChunkBytes;
  if (t == 0) {
    for (int k = 0; k < chunks; ++k) mbar_init(&sc.full[k], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int k = 0; k < chunks; ++k) {
      const int bytes = min(kChunkBytes, body_bytes - k * kChunkBytes);
      mbar_expect_tx(&sc.full[k], bytes);
      bulk_load(body_s + k * (kChunkBytes / 16),
                xs + a0 + k * (kChunkBytes / 4), bytes, &sc.full[k]);
    }
  }
  long long ri = -1;
  if (t < 3 && lo + t < a0) ri = lo + t;
  if (t >= 3 && t < 6 && a1 + t - 3 < hi) ri = a1 + t - 3;
  const float rv = ri >= 0 ? xs[ri] : 0.f;
  float m = fabsf(rv);
  __syncthreads();                         // the barriers are initialised
  for (int k = 0; k < chunks; ++k) {
    mbar_wait(&sc.full[k], 0);
    const float4* chunk = body_s + k * (kChunkBytes / 16);
    const int nv = min(kChunkBytes, body_bytes - k * kChunkBytes) / 16;
    for (int i = t; i < nv; i += kFusedThreads) m = fmaxf(m, max4(chunk[i]));
  }
  m = block_max<kFusedThreads>(m, sc.warp_max);
  stamp(1);
  if (t == 0) sc.slot = m;
  cluster_arrive();                        // every block's slot is published
  cluster_wait();
  stamp(2);
  if (warp == 0) {
    float a = lane < (int)c ? ld_dsmem(&sc.slot, lane) : 0.f;
    a = warp_max(a);
    if (lane == 0) {
      sc.amax = a;
      if (amax != nullptr && rank == 0) amax[s] = a;
    }
  }
  cluster_arrive();                        // no more reads of other blocks
  __syncthreads();
  const float scale = scale_of(sc.amax, qmax);
  if (to_aligned(os + a0) == 0) {          // out lies as x does: 16-byte stores
    float4* o = reinterpret_cast<float4*>(os + a0);
    for (int i = t; i < body_bytes / 16; i += kFusedThreads) {
      const float4 v = body_s[i];
      o[i] = make_float4(qdq<kFp8>(v.x, scale), qdq<kFp8>(v.y, scale),
                         qdq<kFp8>(v.z, scale), qdq<kFp8>(v.w, scale));
    }
  } else {
    const float* body_f = reinterpret_cast<const float*>(body_s);
    for (int i = t; i < body_bytes / 4; i += kFusedThreads)
      os[a0 + i] = qdq<kFp8>(body_f[i], scale);
  }
  if (ri >= 0) os[ri] = qdq<kFp8>(rv, scale);
#ifdef QUANTIZE_PROFILE
  __syncthreads();
#endif
  stamp(3);
  cluster_wait();                          // no block's slot read after exit
}

typedef void (*FusedKernel)(const float*, long long, int, float, float*,
                            float*);

FusedKernel fused_kernel(int fmt) {
  return fmt == 1 ? &quantize_fused_kernel<true>
                  : &quantize_fused_kernel<false>;
}

// The largest dynamic shared memory set on each kernel and device so far.
int g_smem_set[2][kMaxDevices];

cudaError_t set_fused_smem(int fmt, int bytes) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (bytes <= g_smem_set[fmt][dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(fused_kernel(fmt),
                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) g_smem_set[fmt][dev] = bytes;
  return e;
}

bool fused_args_ok(long long n, int cluster, int share_bytes, int fmt) {
  return n >= 1 && fmt >= 0 && fmt <= 1 && share_bytes >= 16 &&
         share_bytes % 16 == 0 && (long long)share_bytes / 4 * cluster >= n &&
         (cluster == 1 || cluster == 2 || cluster == 4 ||
          cluster == kMaxCluster);
}

cudaLaunchConfig_t fused_config(int S, int cluster, int share_bytes,
                                cudaStream_t stream,
                                cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)S * cluster);
  cfg.blockDim = dim3(kFusedThreads);
  cfg.dynamicSmemBytes = (size_t)share_bytes;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// The card's SMs, the shared memory a block may opt in to, and the amax
// pass's blocks resident on one SM.
extern "C" int quantize_limits(int* n_sm, int* smem_optin, int* amax_per_sm) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(smem_optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(amax_per_sm,
                                                      &amax_kernel, kThreads,
                                                      0);
  return (int)e;
}

// Clusters of `cluster` fused blocks with `share_bytes` of dynamic shared
// memory each that the card holds at once (0: the launch cannot run).
extern "C" int quantize_fused_clusters(int cluster, int share_bytes, int fmt,
                                       int* clusters) {
  if (!fused_args_ok(1, cluster, share_bytes, fmt))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = set_fused_smem(fmt, share_bytes);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = fused_config(1, cluster, share_bytes, 0, &attr);
  return (int)cudaOccupancyMaxActiveClusters(clusters, fused_kernel(fmt),
                                             &cfg);
}

// fmt: 0 = int8, 1 = fp8 (e4m3).  One launch: S clusters of `cluster`
// blocks, each block holding share_bytes / 4 floats of its slice.  amax: (S,)
// or null.
extern "C" int quantize_fused(const float* x, int S, long long n, int cluster,
                              int share_bytes, int fmt, float* out,
                              float* amax, void* stream) {
  if (S < 1 || !fused_args_ok(n, cluster, share_bytes, fmt))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = set_fused_smem(fmt, share_bytes);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = fused_config(
      S, cluster, share_bytes, static_cast<cudaStream_t>(stream), &attr);
  e = cudaLaunchKernelEx(&cfg, fused_kernel(fmt), x, n, share_bytes / 4,
                         fmt == 1 ? 448.f : 127.f, out, amax);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// partial: (S, parts) fp32 scratch, every entry written.
extern "C" int quantize_amax(const float* x, int S, long long n, int parts,
                             float* partial, void* stream) {
  if (S < 1 || S > 65535 || n < 1 || parts < 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(parts, S);
  amax_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, n, partial);
  return (int)cudaGetLastError();
}

// fmt: 0 = int8, 1 = fp8 (e4m3).  partial: the amax pass's (S, parts);
// amax: (S,) or null.
extern "C" int quantize_qdq(const float* x, int S, long long n,
                            const float* partial, int parts, int fmt,
                            float* out, float* amax, void* stream) {
  if (S < 1 || S > 65535 || n < 1 || parts < 1 || fmt < 0 || fmt > 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(blocks_per_slice(n), S);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fmt == 1)
    qdq_kernel<true><<<grid, kThreads, 0, s>>>(x, n, partial, parts, 448.f,
                                               out, amax);
  else
    qdq_kernel<false><<<grid, kThreads, 0, s>>>(x, n, partial, parts, 127.f,
                                                out, amax);
  return (int)cudaGetLastError();
}

#ifdef QUANTIZE_PROFILE
// The stamps of the last fused launch's first `blocks` blocks, 4 a block.
extern "C" int quantize_fused_stamps(unsigned long long* stamps, int blocks) {
  if (blocks < 1 || blocks > kProfileBlocks) return (int)cudaErrorInvalidValue;
  return (int)cudaMemcpyFromSymbol(stamps, g_stamps,
                                   sizeof(unsigned long long) * 4 * blocks);
}
#endif
