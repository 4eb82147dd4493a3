// Forward flash attention with grouped-query heads, causal masking and an
// optional sliding window, for Hopper (sm_90a).  Built by
// repro_torch/kernels/build.py into a shared library with a plain C
// interface and bound with ctypes (repro_torch/kernels/flash_attention.py).
//
// Replaces the TPU kernel in src/repro/kernels/flash_attention.py
// (flash_attention -> _flash_kernel), and computes what it computes:
//   o[b, h, i] = sum_j softmax_j(s[i, j]) v[b, h / G, j],
//   s[i, j]    = (q[b, h, i] . k[b, h / G, j]) / sqrt(hd),
// with G = H / KVH (any integer, 5 for Qwen3-14B's 40 over 8 heads) and no
// replicated K/V; key j is masked unless j < Skv, j <= i (causal) and
// j > i - window (window > 0).  Scores, the online softmax (running max
// from -1e30, p zeroed where masked) and the accumulators are fp32; a row
// that sees no key outputs 0 (l == 0 -> 1); inputs are fp32 or bf16, the
// output is in the input's type.
//
// Design: one block of 128 threads per (q tile of 64 rows, head, batch).
// The block holds its Q tile in shared memory, walks the key tiles of 64
// that can be unmasked for it (those wholly above the causal diagonal or
// wholly before the window are skipped; a row none of whose keys are
// visited keeps l == 0 and outputs 0, as a fully masked row does), stages
// each K/V tile in shared memory as fp32, and keeps the 64 x hd output
// accumulator in registers: each thread owns 4 query rows and, of the
// scores, 8 key columns; of the output, hd / 8 feature columns.  The 8
// threads of a row are neighbouring lanes of one warp, so the row max and
// sum are three shuffles.  P goes through shared memory (in the K tile's
// space, which is free by then) to the P.V product.  Ragged Sq and Skv are
// masked here, so a prompt of any length goes through the kernel.
//
// Strides: every tensor is addressed as (B, H, S, hd) through its batch,
// head and sequence strides (the head dim must be contiguous), so the model
// hands in views of its (B, S, H, hd) projections and gets the output in
// that layout, with no transposed copies.
//
// What bounds it: at Qwen3-14B's prefill shape, q (4, 40, 2048, 128) and
// k, v (4, 8, 2048, 128) in bf16, causal, it does about 1.7e11 operations
// on 0.2 GB, far above the card's ridge point, so operations bound it:
// 0.17 ms at the 989 TFLOP/s bf16 tensor-core rate.  This simple kernel
// multiplies in fp32 on the CUDA cores (67 TFLOP/s at most, and shared
// memory loads feed every two to three multiply-adds), so it sits well
// off that bound; wgmma, TMA and warp specialisation are later work.
//
// Built without --use_fast_math: expf of scores far below the running max
// must give 0, and the masked -1e30 scores must never make a NaN.
//
// No allocation and no synchronisation here: the entry point launches on
// the caller's stream and returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBlockQ = 64;           // query rows per block
constexpr int kBlockK = 64;           // keys per tile
constexpr int kThreads = 128;
constexpr int kLanesPerRow = 8;       // threads sharing one query row
constexpr int kRows = kBlockQ / (kThreads / kLanesPerRow);  // 4 per thread
constexpr int kCols = kBlockK / kLanesPerRow;               // 8 per thread
constexpr int kPad = kBlockQ + 1;     // row stride of the transposed tiles
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

static_assert(kBlockQ == kBlockK, "the transposed tiles share kPad");

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// max / sum over the 8 neighbouring lanes of one query row
__device__ __forceinline__ float row_max(float x) {
  for (int off = 1; off < kLanesPerRow; off <<= 1)
    x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
  for (int off = 1; off < kLanesPerRow; off <<= 1)
    x += __shfl_xor_sync(kFull, x, off);
  return x;
}

struct Strides {
  long long b, h, s;  // in elements; the head dim is contiguous
};

template <int HD>
constexpr int smem_floats() {
  // Q^T [HD][kPad], K^T [max(HD, kBlockK)][kPad] (also P^T [kBlockK][kPad]),
  // V [kBlockK][HD]
  return HD * kPad + (HD > kBlockK ? HD : kBlockK) * kPad + kBlockK * HD;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int group, int Sq,
             int Skv, Strides qs, Strides ks, Strides vs, Strides os,
             int causal, int window, float sm_scale) {
  static_assert(HD % kLanesPerRow == 0, "head dim must be a multiple of 8");
  constexpr int kOut = HD / kLanesPerRow;  // output columns per thread
  extern __shared__ float smem[];
  float* q_t = smem;                        // [HD][kPad]
  float* k_t = q_t + HD * kPad;             // [HD][kPad]
  float* p_t = k_t;                         // [kBlockK][kPad], after S
  float* v_s = k_t + (HD > kBlockK ? HD : kBlockK) * kPad;  // [kBlockK][HD]

  const int q0 = blockIdx.x * kBlockQ;
  const int head = blockIdx.y, batch = blockIdx.z;
  const int kv_head = head / group;
  const int tid = threadIdx.x;
  const int row0 = (tid / kLanesPerRow) * kRows;  // this thread's first row
  const int col = tid % kLanesPerRow;             // its first column

  const T* qb = q + batch * qs.b + head * qs.h;
  const T* kb = k + batch * ks.b + kv_head * ks.h;
  const T* vb = v + batch * vs.b + kv_head * vs.h;
  T* ob = o + batch * os.b + head * os.h;

  for (int i = tid; i < kBlockQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    q_t[d * kPad + r] = q0 + r < Sq ? to_float(qb[(q0 + r) * qs.s + d]) : 0.f;
  }

  float acc[kRows][kOut];
  float m[kRows], l[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kOut; ++c) acc[i][c] = 0.f;
  }

  // the key tiles that can hold an unmasked key for some row of this tile
  int k_end = Skv;
  if (causal) k_end = min(k_end, q0 + kBlockQ);
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_end = (k_end + kBlockK - 1) / kBlockK;

  for (int t = k_begin / kBlockK; t < t_end; ++t) {
    const int k0 = t * kBlockK;
    __syncthreads();  // the last tile's P and V are no longer read
    for (int i = tid; i < kBlockK * HD; i += kThreads) {
      const int r = i / HD, d = i % HD;
      const bool in = k0 + r < Skv;
      k_t[d * kPad + r] = in ? to_float(kb[(k0 + r) * ks.s + d]) : 0.f;
      v_s[r * HD + d] = in ? to_float(vb[(k0 + r) * vs.s + d]) : 0.f;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = q_t[d * kPad + row0 + i];
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        kv[j] = k_t[d * kPad + col + j * kLanesPerRow];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // mask, then the online softmax update of each row
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qi = q0 + row0 + i;
      bool ok[kCols];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kj = k0 + col + j * kLanesPerRow;
        ok[j] = kj < Skv && (!causal || kj <= qi) &&
                (window <= 0 || kj > qi - window);
        s[i][j] = ok[j] ? s[i][j] * sm_scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        s[i][j] = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += s[i][j];
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kOut; ++c) acc[i][c] *= alpha;
    }

    __syncthreads();  // every thread is done with K^T: it becomes P^T
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        p_t[(col + j * kLanesPerRow) * kPad + row0 + i] = s[i][j];
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < kBlockK; ++j) {
      float pv[kRows], vv[kOut];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = p_t[j * kPad + row0 + i];
#pragma unroll
      for (int c = 0; c < kOut; ++c)
        vv[c] = v_s[j * HD + col + c * kLanesPerRow];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < kOut; ++c)
          acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + row0 + i;
    if (qi >= Sq) continue;
    const float denom = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int c = 0; c < kOut; ++c)
      store(&ob[qi * os.s + col + c * kLanesPerRow], acc[i][c] / denom);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int group, int Sq, int Skv,
                   const long long* st, int causal, int window,
                   cudaStream_t stream) {
  constexpr int bytes = smem_floats<HD>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBlockQ - 1) / kBlockQ, H, B);
  flash_kernel<T, HD><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), group, Sq, Skv,
      Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
      Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]}, causal,
      window, (float)(1.0 / sqrt((double)HD)));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(int hd, const void* q, const void* k, const void* v,
                      void* o, int B, int H, int group, int Sq, int Skv,
                      const long long* st, int causal, int window,
                      cudaStream_t s) {
  switch (hd) {
    case 32: return launch<T, 32>(q, k, v, o, B, H, group, Sq, Skv, st, causal, window, s);
    case 64: return launch<T, 64>(q, k, v, o, B, H, group, Sq, Skv, st, causal, window, s);
    case 80: return launch<T, 80>(q, k, v, o, B, H, group, Sq, Skv, st, causal, window, s);
    case 96: return launch<T, 96>(q, k, v, o, B, H, group, Sq, Skv, st, causal, window, s);
    case 112: return launch<T, 112>(q, k, v, o, B, H, group, Sq, Skv, st, causal, window, s);
    case 128: return launch<T, 128>(q, k, v, o, B, H, group, Sq, Skv, st, causal, window, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o: (B, H, Sq, hd); k, v: (B, KVH, Skv, hd), each addressed through
// strides[3 * t .. 3 * t + 2] = its (batch, head, sequence) strides in
// elements, t = q, k, v, o.  dtype: 0 = float32, 1 = bfloat16.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int dtype, int B,
                                   int H, int KVH, int Sq, int Skv, int hd,
                                   const long long* strides, int causal,
                                   int window, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || H > 65535 || KVH < 1 || H % KVH ||
      Sq < 1 || Skv < 1 || window < 0 || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int group = H / KVH;
  if (dtype == 1)
    return (int)launch_hd<__nv_bfloat16>(hd, q, k, v, o, B, H, group, Sq,
                                         Skv, strides, causal, window, s);
  return (int)launch_hd<float>(hd, q, k, v, o, B, H, group, Sq, Skv,
                               strides, causal, window, s);
}
