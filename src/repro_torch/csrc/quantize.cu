// Amax-scaled int8 / fp8 (e4m3) fake quantization of the split-link
// payloads, for Hopper (sm_90a).  Built by repro_torch/kernels/build.py into
// a shared library with a plain C interface and bound with ctypes
// (repro_torch/kernels/quantize.py).
//
// Replaces the TPU kernels in src/repro/kernels/quantize.py:
//   quantize_amax  <- _amax_kernel (the first pallas_call of
//                     quantize_dequantize_pallas);
//   quantize_qdq   <- _qdq_kernel (the second pallas_call).
//
// The input is S slices of n floats; each slice (one client's tensor) gets
// its own scale, as the JAX engine's vmapped calls give:
//   scale = amax(|x_s|) / qmax, or 1 where the amax is 0
//   int8: clip(round_half_even(x / scale), -127, 127) * scale
//   fp8:  e4m3(x / scale) * scale
//
// What bounds it: both passes are pure streaming, about one operation per byte,
// so they are bound by device memory: the amax pass reads 4 bytes an element,
// the qdq pass reads 4 and writes 4 (at the training round's shape, 10 slices
// of 262,144 elements: 10.5 MB, about 3 us, and 21 MB, about 6 us, at the 3.35
// TB/s an H100 SXM publishes for 700 W).  The TPU's sequential read-modify-write
// amax over the grid becomes a per-block reduction plus one atomicMax on the
// float's bits per block, which orders correctly because |x| >= 0; the scale
// stays on the device and the qdq pass reads it from there, so no host sync
// sits between the passes.
//
// Bit-exactness with the plain version needs IEEE division (x / scale, not a
// multiply by the reciprocal) and round-half-to-even (rintf): the library is
// built without --use_fast_math.  fp8 goes through the hardware conversion
// with finite saturation; |x / scale| <= 448 up to one rounding, and values
// up to 464 round to 448 either way, so saturation never changes a result.
//
// No allocation and no synchronisation here: the caller zeroes amax, and
// each entry point launches on the caller's stream and returns
// cudaGetLastError().
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
amax_kernel(const float* __restrict__ x, long long n,
            float* __restrict__ amax) {
  const float* xs = x + (size_t)blockIdx.y * n;
  float m = 0.f;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kThreads)
    m = fmaxf(m, fabsf(xs[i]));
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
  __shared__ float warp_max[kThreads / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < kThreads / 32 ? warp_max[lane] : 0.f;
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
    // non-negative floats order like their bit patterns as ints
    if (lane == 0)
      atomicMax(reinterpret_cast<int*>(amax + blockIdx.y), __float_as_int(m));
  }
}

template <bool kFp8>
__global__ void __launch_bounds__(kThreads)
qdq_kernel(const float* __restrict__ x, long long n,
           const float* __restrict__ amax, float qmax,
           float* __restrict__ out) {
  const float a = amax[blockIdx.y];
  const float s = a > 0.f ? a / qmax : 1.f;
  const float* xs = x + (size_t)blockIdx.y * n;
  float* os = out + (size_t)blockIdx.y * n;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kThreads) {
    const float v = xs[i] / s;
    float q;
    if (kFp8) {
      const __nv_fp8_storage_t b =
          __nv_cvt_float_to_fp8(v, __NV_SATFINITE, __NV_E4M3);
      q = __half2float(__half(__nv_cvt_fp8_to_halfraw(b, __NV_E4M3)));
    } else {
      q = fminf(fmaxf(rintf(v), -127.f), 127.f);
    }
    os[i] = q * s;
  }
}

int blocks_per_slice(long long n) {
  const long long per_block = (long long)kThreads * 8;
  long long b = (n + per_block - 1) / per_block;
  if (b < 1) b = 1;
  if (b > 1024) b = 1024;
  return (int)b;
}

}  // namespace

extern "C" int quantize_amax(const float* x, int S, long long n, float* amax,
                             void* stream) {
  if (S < 1 || S > 65535 || n < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid(blocks_per_slice(n), S);
  amax_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, n, amax);
  return (int)cudaGetLastError();
}

// fmt: 0 = int8, 1 = fp8 (e4m3)
extern "C" int quantize_qdq(const float* x, int S, long long n,
                            const float* amax, int fmt, float* out,
                            void* stream) {
  if (S < 1 || S > 65535 || n < 1 || fmt < 0 || fmt > 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(blocks_per_slice(n), S);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fmt == 1)
    qdq_kernel<true><<<grid, kThreads, 0, s>>>(x, n, amax, 448.f, out);
  else
    qdq_kernel<false><<<grid, kThreads, 0, s>>>(x, n, amax, 127.f, out);
  return (int)cudaGetLastError();
}
