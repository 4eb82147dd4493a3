// The Mamba2 (SSD) selective scan for Hopper (sm_90a).  Built by
// repro_torch/kernels/build.py into a shared library with a plain C
// interface and bound with ctypes (repro_torch/kernels/mamba2_scan.py).
//
// Replaces the TPU kernel in src/repro/kernels/mamba2_scan.py (mamba2_scan
// -> _mamba2_kernel), and computes what it computes, per batch row b and
// head h, from a zero state:
//   S_t = exp(dt_t A) S_{t-1} + B_t (dt_t x_t)^T      (S: N x hd)
//   y_t = C_t . S_t + D x_t
// with one (B, C) group shared by all heads, all arithmetic in fp32; x, B,
// C and y are fp32 or bf16, dt, A and D fp32.  Where the TPU kernel returns
// y only, this one also writes the final state S_S, as (hd, N) per (b, h),
// the layout of the model's decode cache: the model's prefill hands it on
// to decode, so no second pass over the prompt computes it.
//
// Design: one block of 256 threads per (head, batch row), 448 blocks at
// Zamba2-7B's prefill shape.  The block walks the sequence in chunks of
// L = 64 steps (the model's chunk of 256 does not fit: its (c, c) decay and
// score tiles alone would be 256 KB each in fp32, and an SM has 227 KB of
// shared memory; the function does not depend on the chunk).  The (N, hd)
// state stays in shared memory across chunks.  For each chunk, with
// cum = the inclusive prefix sum of dt A over the chunk:
//   G[t][s] = (C_t . B_s) exp(cum_t - cum_s) dt_s    for s <= t, else 0
//   y_t     = sum_s G[t][s] x_s + exp(cum_t) C_t . S + D x_t
//   S      <- exp(cum_L) S + sum_s B_s exp(cum_L - cum_s) dt_s x_s^T
// Each of the four products is a 64 x 64 output tile with a 64-deep sum
// (or N-deep), computed on the CUDA cores from shared memory: each thread
// owns a 4 x 4 sub-tile at rows ty + 16 i and columns tx + 16 j.  B and C
// are held transposed, [n][t] with a row stride of L + 1, so that every
// shared-memory read of a warp is a broadcast or hits distinct banks.  N
// and hd up to 64 are zero-padded to 64 in shared memory, and a ragged last
// chunk is zero-padded in time (dt = 0 there, so cum stays flat and the
// padded steps add nothing to the state); rows past the end are not
// written.  The prefix sum is one warp's shuffle scan, two steps a lane.
//
// Overflow: cum falls by |dt A| a step, so exp(cum_t - cum_s) for s > t can
// pass fp32's range (at random init about 0.3-1.3 a step; 64 steps of 1.5
// give exp(96) = inf, and inf * 0 is NaN).  The kernel computes that
// exponent only where s <= t, where it is at most 1, and writes 0 elsewhere;
// it never multiplies by a 0/1 mask.  Every other exponent it takes is of a
// number <= 0.  Built without --use_fast_math.
//
// Strides: x is addressed as (B, S, nh, hd) and B, C as (B, S, N) through
// their batch, time (and head) strides, the last dim contiguous, so the
// model's slices of its (B, S, d_in + 2N) conv output go in with no copy;
// dt (B, S, nh) through its three strides.  y is written contiguous (B, S,
// nh, hd) in x's type, the final state contiguous (B, nh, hd, N) in fp32.
//
// What bounds it: at Zamba2-7B's prefill shape, x (4, 2048, 112, 64) bf16,
// the function must move about 0.25 GB (x read, y written, dt, B, C, the
// final state) and do 4 hd N operations a step per (b, h) in the
// inter-chunk products, 1.5e10 in all, so bytes bound it: about 0.074 ms
// at 3.35 TB/s.  This simple kernel does the chunked products in fp32 on
// the CUDA cores (about 2e10 multiply-adds at L = 64, shared-memory loads
// feeding every two), so it sits far off that bound; tensor cores are later
// work.
//
// No allocation and no synchronisation here: the entry point launches on
// the caller's stream and returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kL = 64;         // steps per chunk
constexpr int kP = 64;         // N and hd, padded
constexpr int kPad = kL + 1;   // row stride of the transposed B, C and of G
constexpr int kTile = 16;      // threads per side of the 16 x 16 grid
constexpr int kThreads = kTile * kTile;
constexpr int kSub = kP / kTile;  // 4 x 4 outputs per thread
constexpr unsigned kFull = 0xffffffffu;

static_assert(kL == kP, "the four products share one 64 x 64 tiling");

// shared memory, in floats
constexpr int kOffS = 0;                      // state S [kP][kP] (n, p)
constexpr int kOffB = kOffS + kP * kP;        // B^T [kP][kPad] (n, s)
constexpr int kOffC = kOffB + kP * kPad;      // C^T [kP][kPad] (n, t)
constexpr int kOffX = kOffC + kP * kPad;      // x [kL][kP] (s, p)
constexpr int kOffG = kOffX + kL * kP;        // G [kL][kPad] (t, s)
constexpr int kOffCum = kOffG + kL * kPad;    // cum [kL]
constexpr int kOffW = kOffCum + kL;           // exp(cum_L - cum_s) dt_s [kL]
constexpr int kOffDt = kOffW + kL;            // dt [kL]
constexpr int kSmemFloats = kOffDt + kL;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
mamba2_scan_kernel(const T* __restrict__ x, long long x_sb, long long x_st,
                   long long x_sh, const float* __restrict__ dt,
                   long long dt_sb, long long dt_st, long long dt_sh,
                   const float* __restrict__ A, const T* __restrict__ Bm,
                   long long b_sb, long long b_st, const T* __restrict__ Cm,
                   long long c_sb, long long c_st,
                   const float* __restrict__ D, T* __restrict__ y,
                   float* __restrict__ state_out, int S, int nh, int hd,
                   int N) {
  extern __shared__ float smem[];
  float* st = smem + kOffS;
  float* bt = smem + kOffB;
  float* ct = smem + kOffC;
  float* xs = smem + kOffX;
  float* g = smem + kOffG;
  float* cum = smem + kOffCum;
  float* wd = smem + kOffW;
  float* dts = smem + kOffDt;

  const int head = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int tx = tid % kTile, ty = tid / kTile;
  const float a_h = A[head];
  const float d_h = D[head];

  for (int i = tid; i < kP * kP; i += kThreads) st[i] = 0.f;

  const T* xb = x + b * x_sb + head * x_sh;
  const float* dtb = dt + b * dt_sb + head * dt_sh;
  const T* bb = Bm + b * b_sb;
  const T* cb = Cm + b * c_sb;
  T* yb = y + ((long long)b * S * nh + head) * hd;
  const long long y_st = (long long)nh * hd;

  for (int c0 = 0; c0 < S; c0 += kL) {
    const int len = min(kL, S - c0);

    // 1. the chunk's B^T, C^T and x, zero-padded; dt and its prefix sum
    for (int i = tid; i < kL * kP; i += kThreads) {
      const int t = i / kP, n = i % kP;
      const bool in = t < len;
      const long long row = (long long)(c0 + t);
      bt[n * kPad + t] = (in && n < N) ? to_float(bb[row * b_st + n]) : 0.f;
      ct[n * kPad + t] = (in && n < N) ? to_float(cb[row * c_st + n]) : 0.f;
      xs[t * kP + n] = (in && n < hd) ? to_float(xb[row * x_st + n]) : 0.f;
    }
    if (tid < 32) {  // one warp, steps 2 lane and 2 lane + 1
      const int t0 = 2 * tid, t1 = t0 + 1;
      const float d0 = t0 < len ? dtb[(long long)(c0 + t0) * dt_st] : 0.f;
      const float d1 = t1 < len ? dtb[(long long)(c0 + t1) * dt_st] : 0.f;
      const float a0 = d0 * a_h, a1 = d1 * a_h;
      float run = a0 + a1;  // inclusive scan of the pair sums
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(kFull, run, off);
        if (tid >= off) run += up;
      }
      const float before = run - (a0 + a1);
      cum[t0] = before + a0;
      cum[t1] = before + a0 + a1;
      dts[t0] = d0;
      dts[t1] = d1;
    }
    __syncthreads();

    // 2. G, masked where s > t without taking the exponent; the state
    //    update's weights
    {
      float acc[kSub][kSub] = {};
      for (int n = 0; n < N; ++n) {
        float cv[kSub], bv[kSub];
#pragma unroll
        for (int i = 0; i < kSub; ++i) {
          cv[i] = ct[n * kPad + ty + kTile * i];
          bv[i] = bt[n * kPad + tx + kTile * i];
        }
#pragma unroll
        for (int i = 0; i < kSub; ++i)
#pragma unroll
          for (int j = 0; j < kSub; ++j) acc[i][j] = fmaf(cv[i], bv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < kSub; ++i) {
        const int t = ty + kTile * i;
#pragma unroll
        for (int j = 0; j < kSub; ++j) {
          const int s = tx + kTile * j;
          g[t * kPad + s] =
              s <= t ? acc[i][j] * expf(cum[t] - cum[s]) * dts[s] : 0.f;
        }
      }
      if (tid < kL) wd[tid] = expf(cum[kL - 1] - cum[tid]) * dts[tid];
    }
    __syncthreads();

    // 3. y = G x + exp(cum_t) C_t . S + D x, written for rows < len
    {
      float acc[kSub][kSub] = {}, inter[kSub][kSub] = {};
      for (int s = 0; s < kL; ++s) {
        float gv[kSub], xv[kSub];
#pragma unroll
        for (int i = 0; i < kSub; ++i) {
          gv[i] = g[(ty + kTile * i) * kPad + s];
          xv[i] = xs[s * kP + tx + kTile * i];
        }
#pragma unroll
        for (int i = 0; i < kSub; ++i)
#pragma unroll
          for (int j = 0; j < kSub; ++j) acc[i][j] = fmaf(gv[i], xv[j], acc[i][j]);
      }
      for (int n = 0; n < N; ++n) {
        float cv[kSub], sv[kSub];
#pragma unroll
        for (int i = 0; i < kSub; ++i) {
          cv[i] = ct[n * kPad + ty + kTile * i];
          sv[i] = st[n * kP + tx + kTile * i];
        }
#pragma unroll
        for (int i = 0; i < kSub; ++i)
#pragma unroll
          for (int j = 0; j < kSub; ++j)
            inter[i][j] = fmaf(cv[i], sv[j], inter[i][j]);
      }
#pragma unroll
      for (int i = 0; i < kSub; ++i) {
        const int t = ty + kTile * i;
        if (t >= len) continue;
        const float decay = expf(cum[t]);
#pragma unroll
        for (int j = 0; j < kSub; ++j) {
          const int p = tx + kTile * j;
          if (p < hd)
            store(&yb[(long long)(c0 + t) * y_st + p],
                  acc[i][j] + decay * inter[i][j] + d_h * xs[t * kP + p]);
        }
      }
    }
    __syncthreads();  // every read of S is done

    // 4. S <- exp(cum_L) S + sum_s B_s wd_s x_s^T, each thread its own
    //    4 x 4 entries
    {
      float acc[kSub][kSub] = {};
      for (int s = 0; s < kL; ++s) {
        const float w = wd[s];
        float bv[kSub], xv[kSub];
#pragma unroll
        for (int i = 0; i < kSub; ++i) {
          bv[i] = bt[(ty + kTile * i) * kPad + s] * w;
          xv[i] = xs[s * kP + tx + kTile * i];
        }
#pragma unroll
        for (int i = 0; i < kSub; ++i)
#pragma unroll
          for (int j = 0; j < kSub; ++j) acc[i][j] = fmaf(bv[i], xv[j], acc[i][j]);
      }
      const float total = expf(cum[kL - 1]);
#pragma unroll
      for (int i = 0; i < kSub; ++i)
#pragma unroll
        for (int j = 0; j < kSub; ++j) {
          float* e = &st[(ty + kTile * i) * kP + tx + kTile * j];
          *e = fmaf(total, *e, acc[i][j]);
        }
    }
    __syncthreads();  // the next chunk overwrites B^T, C^T, x and G
  }

  // the final state in the cache's layout: (hd, N) for this (b, head)
  float* so = state_out + ((long long)b * nh + head) * hd * N;
  for (int i = tid; i < hd * N; i += kThreads) {
    const int p = i / N, n = i % N;
    so[i] = st[n * kP + p];
  }
}

template <typename T>
cudaError_t launch(const void* x, const long long* xs, const float* dt,
                   const long long* dts, const float* A, const void* Bm,
                   const long long* bs, const void* Cm, const long long* cs,
                   const float* D, void* y, float* state_out, int B, int S,
                   int nh, int hd, int N, cudaStream_t stream) {
  constexpr int bytes = kSmemFloats * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      mamba2_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(nh, B);
  mamba2_scan_kernel<T><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), xs[0], xs[1], xs[2], dt, dts[0], dts[1],
      dts[2], A, static_cast<const T*>(Bm), bs[0], bs[1],
      static_cast<const T*>(Cm), cs[0], cs[1], D, static_cast<T*>(y),
      state_out, S, nh, hd, N);
  return cudaGetLastError();
}

}  // namespace

// x: (B, S, nh, hd), strides x_strides = its (batch, time, head) strides in
// elements, the last dim contiguous; dt: (B, S, nh) fp32, dt_strides its
// three strides; A, D: (nh,) fp32 contiguous; Bm, Cm: (B, S, N), strides
// (batch, time), the last dim contiguous; x, Bm, Cm and y of one type
// (dtype 0 = float32, 1 = bfloat16); y: (B, S, nh, hd) contiguous; state:
// (B, nh, hd, N) fp32 contiguous.  hd and N at most 64.  Returns the
// launch's cudaError_t.
extern "C" int mamba2_scan_fwd(const void* x, const long long* x_strides,
                               const float* dt, const long long* dt_strides,
                               const float* A, const void* Bm,
                               const long long* b_strides, const void* Cm,
                               const long long* c_strides, const float* D,
                               void* y, float* state, int dtype, int B,
                               int S, int nh, int hd, int N, void* stream) {
  if (B < 1 || B > 65535 || S < 1 || nh < 1 || hd < 1 || hd > kP || N < 1 ||
      N > kP || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, x_strides, dt, dt_strides, A, Bm,
                                      b_strides, Cm, c_strides, D, y, state,
                                      B, S, nh, hd, N, s);
  return (int)launch<float>(x, x_strides, dt, dt_strides, A, Bm, b_strides,
                            Cm, c_strides, D, y, state, B, S, nh, hd, N, s);
}
