// Device helpers shared by the sLSTM scan's forward (slstm_scan.cu) and
// backward (slstm_scan_bwd.cu): the per-head arrival counter's release and
// acquire, the fixed-order butterfly that adds a unit's k-slices across
// neighbouring lanes, and 4-byte cp.async copies into shared memory.
#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void red_release(unsigned* p, unsigned v) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

// a ? x : y on values already in registers; written as selp so that the
// compiler cannot turn it into a load from a computed index, which would
// put the butterfly's array in local memory
__device__ __forceinline__ float select(bool a, float x, float y) {
  float r;
  asm("{ .reg .pred p; setp.ne.b32 p, %3, 0; selp.f32 %0, %1, %2, p; }"
      : "=f"(r) : "f"(x), "f"(y), "r"((int)a));
  return r;
}

// One level of the butterfly over lanes d apart: of its N pairs (v[i],
// v[i + N]) a lane keeps the upper ones if ``up``, else the lower ones, and
// adds the partner's.
template <int N, int M>
__device__ __forceinline__ void butterfly(float (&v)[M], bool up, int d,
                                          unsigned lanes) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float send = select(up, v[i], v[i + N]);
    const float keep = select(up, v[i + N], v[i]);
    v[i] = keep + __shfl_xor_sync(lanes, send, d);
  }
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

}  // namespace
