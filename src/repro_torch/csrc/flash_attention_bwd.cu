// Backward pass of flash attention (grouped-query heads, causal masking and
// an optional sliding window) for Hopper (sm_90a), on the CUDA cores.  Built
// by repro_torch/kernels/build.py into a shared library with a plain C
// interface and bound with ctypes (repro_torch/kernels/flash_attention.py,
// FlashAttention.backward).
//
// The TPU kernel (src/repro/kernels/flash_attention.py, flash_attention ->
// _flash_kernel) defines no backward: the JAX model trains through its jnp
// stand-in _chunked_attend (src/repro/models/attention.py), and JAX's VJP of
// that is the reference.  Given the forward's q, k, v, its output o and
// each row's log-sum-exp lse (flash_attention.cu writes it), and the
// output's gradient dO, with s = 1 / sqrt(hd) and G = H / KVH:
//
//   P[i, j]  = exp(s q_i . k_j - lse_i)   where key j is unmasked, else 0
//   D_i      = dO_i . o_i
//   dS[i, j] = P[i, j] (dO_i . v_j - D_i)
//   dV_j     = sum over the group's G heads and rows i of P[i, j] dO_i
//   dK_j     = s sum over the group's heads and rows of dS[i, j] q_i
//   dQ_i     = s sum_j dS[i, j] k_j
//
// with the forward's mask (key j < Skv, j <= i if causal, j > i - window if
// window > 0) and its addressing: every tensor (B, heads, S, hd) through its
// batch, head and sequence strides, the head dim contiguous, so the model's
// views of its (B, S, heads, hd) projections go in as they are, and the
// gradients come out in the layout the caller allocated.  A row that sees
// no key has lse = -inf and P = 0, so its gradients are 0, never NaN (P is
// only evaluated where the key is unmasked).  Inputs fp32 or bf16; products,
// P, dS and the accumulators fp32; the gradients are rounded once, to the
// input's type, when they are written.
//
// Three kernels, launched in order on the caller's stream:
//   flash_bwd_delta<T, HD>  D = rowsum(dO * o), one warp a row;
//   flash_bwd_dkdv<T, HD>   one block per (key tile of 64, KV head, batch),
//       the heaviest causal tiles first; K and V stay in shared memory while
//       the block walks the group's G query heads and, for each, the query
//       tiles of 64 rows that can see a key of its tile; it recomputes S and
//       dP = dO V^T, then P and dS, and adds P^T dO to dV and dS^T Q to dK in
//       registers.  The sum over the group is a loop in one block, so GQA
//       needs no atomics and the result is the same bit for bit on every run;
//   flash_bwd_dq<T, HD>     one block per (query tile of 64, head, batch),
//       Q, dO, lse and D staged once; it walks the key tiles the forward
//       visits, recomputes S, dP, P and dS, and adds dS K to dQ.
// Each block has 256 threads on a 16 x 16 grid; a thread holds a 4 x 4
// piece of each 64 x 64 score tile and 4 rows x hd / 16 columns of each
// accumulator.  Tiles lie transposed in shared memory ([hd][64 rows]): the
// operand a thread reads four rows of at once has a row stride of 68 floats
// (float4 loads, 16-byte aligned), the operand it reads one column of at a
// time a stride of 65 (an odd stride puts 32 neighbouring columns or rows in
// 32 banks); the loads that fill them map a warp's lanes so that their
// transposed stores fall in 32 banks.
//
// What bounds it: at H2O-Danube-1.8B's training shape, q (4, 32, 4096, 80)
// and k, v (4, 8, 4096, 80), causal, the five products the backward needs
// are about 8.6e11 operations on about 0.5 GB in bf16: 0.87 ms at the
// card's bf16 tensor-core peak, 12.8 ms at its fp32 CUDA-core peak.  This
// kernel multiplies on the CUDA cores in fp32 and recomputes S and dP in
// both passes (seven products for five), and a score tile's inner loop
// reads shared memory for every two to four multiply-adds, so it runs far
// from either bound.  Moving the products to the tensor cores (wgmma with
// TMA-fed tiles, as the forward does) is the redesign that follows.
//
// Built without --use_fast_math: exp of a score far below lse must give 0.
// No allocation and no synchronisation here: the entry point launches on
// the caller's stream (the caller allocates D's scratch) and returns
// cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

struct Strides {
  long long b, h, s;  // in elements; the head dim is contiguous
};

constexpr int kTile = 64;           // query rows and keys per tile
constexpr int kThreads = 256;       // a 16 x 16 grid
constexpr int kWide = kTile + 4;    // row stride of the float4-read tiles
constexpr int kNarrow = kTile + 1;  // row stride of the float-read tiles
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// dst[d * LD + r] = src[(row0 + r) * s + d] as fp32, for r < kTile and
// d < HD; rows at or past n are 0.  For the stride-68 tiles a warp loads 8
// neighbouring d of 4 rows (banks 4 d + r: all 32), for the stride-65 ones
// 32 neighbouring d of one row (banks d + r).
template <typename T, int HD, int LD>
__device__ __forceinline__ void load_t(float* __restrict__ dst,
                                       const T* __restrict__ src,
                                       long long s, int row0, int n) {
  constexpr int kDs = (LD % 2) ? 32 : 8;
  constexpr int kRs = 32 / kDs;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int di = lane % kDs, ri = lane / kDs;
  for (int r = warp * kRs + ri; r < kTile; r += kWarps * kRs) {
    const int row = row0 + r;
    if (row < n) {
      const T* src_row = src + (long long)row * s;
#pragma unroll
      for (int d = di; d < HD; d += kDs) dst[d * LD + r] = to_f(src_row[d]);
    } else {
#pragma unroll
      for (int d = di; d < HD; d += kDs) dst[d * LD + r] = 0.f;
    }
  }
}

// Two 64 x 64 products over the head dim at once, a 4 x 4 piece a thread:
// sa[i][j] = sum_d A[d][4 ty + i] B[d][tx + 16 j], sb likewise from A2 and
// B2.  A and A2 have row stride kWide, B and B2 kNarrow.
template <int HD>
__device__ __forceinline__ void scores(float (&sa)[4][4], float (&sb)[4][4],
                                       const float* __restrict__ A,
                                       const float* __restrict__ B,
                                       const float* __restrict__ A2,
                                       const float* __restrict__ B2, int ty,
                                       int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) sa[i][j] = sb[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    const float4 a = *reinterpret_cast<const float4*>(A + d * kWide + 4 * ty);
    const float4 a2 =
        *reinterpret_cast<const float4*>(A2 + d * kWide + 4 * ty);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float av2[4] = {a2.x, a2.y, a2.z, a2.w};
    float b[4], b2[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      b[j] = B[d * kNarrow + tx + 16 * j];
      b2[j] = B2[d * kNarrow + tx + 16 * j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sa[i][j] = fmaf(av[i], b[j], sa[i][j]);
        sb[i][j] = fmaf(av2[i], b2[j], sb[i][j]);
      }
  }
}

// acc[i][c] += sum_m W[m][4 ty + i] X[tx + 16 c][m] over the tile's 64 m:
// W (a P or dS tile) has row stride kWide, X (a transposed input tile)
// kNarrow.
template <int HD>
__device__ __forceinline__ void accumulate(float (&acc)[4][HD / 16],
                                           const float* __restrict__ W,
                                           const float* __restrict__ X,
                                           int ty, int tx) {
  constexpr int kC = HD / 16;
#pragma unroll 4
  for (int m = 0; m < kTile; ++m) {
    const float4 w = *reinterpret_cast<const float4*>(W + m * kWide + 4 * ty);
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const float x = X[(tx + 16 * c) * kNarrow + m];
      acc[0][c] = fmaf(w.x, x, acc[0][c]);
      acc[1][c] = fmaf(w.y, x, acc[1][c]);
      acc[2][c] = fmaf(w.z, x, acc[2][c]);
      acc[3][c] = fmaf(w.w, x, acc[3][c]);
    }
  }
}

__device__ __forceinline__ bool unmasked(int i, int j, int Sq, int Skv,
                                         int causal, int window) {
  return i < Sq && j < Skv && (!causal || j <= i) &&
         (window <= 0 || j > i - window);
}

// D[b, h, i] = dO . o, one warp a row of the flattened (B, H, Sq)
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta(const T* __restrict__ o, const T* __restrict__ dout,
                float* __restrict__ delta, int H, int Sq, long long rows,
                Strides os, Strides dos) {
  const long long r = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  if (r >= rows) return;
  const int lane = threadIdx.x % 32;
  const int i = (int)(r % Sq);
  const long long bh = r / Sq;
  const int h = (int)(bh % H), b = (int)(bh / H);
  const T* orow = o + b * os.b + h * os.h + i * os.s;
  const T* drow = dout + b * dos.b + h * dos.h + i * dos.s;
  float acc = 0.f;
#pragma unroll
  for (int d = lane; d < HD; d += 32)
    acc = fmaf(to_f(orow[d]), to_f(drow[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[r] = acc;
}

template <int HD>
constexpr int dkdv_floats() {
  // K^T, V^T [HD][kWide]; Q^T, dO^T [HD][kNarrow]; P, dS [kTile][kWide];
  // lse, D [kTile]
  return 2 * HD * kWide + 2 * HD * kNarrow + 2 * kTile * kWide + 2 * kTile;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               T* __restrict__ dk, T* __restrict__ dv, int B, int H, int KVH,
               int Sq, int Skv, Strides qs, Strides ks, Strides vs,
               Strides dos, Strides dks, Strides dvs, int causal, int window,
               float scale) {
  constexpr int kC = HD / 16;
  extern __shared__ float4 smem4[];
  float* kt = reinterpret_cast<float*>(smem4);  // [HD][kWide]
  float* vt = kt + HD * kWide;                  // [HD][kWide]
  float* qt = vt + HD * kWide;                  // [HD][kNarrow]
  float* dot = qt + HD * kNarrow;               // [HD][kNarrow]
  float* ps = dot + HD * kNarrow;               // [kTile q][kWide k]
  float* dss = ps + kTile * kWide;              // [kTile q][kWide k]
  float* row_lse = dss + kTile * kWide;         // [kTile]
  float* row_d = row_lse + kTile;               // [kTile]

  // block -> (key tile, KV head, batch), the key tile slowest: under the
  // causal mask the first key tiles meet the most query rows, so they start
  // first and the last wave holds the lightest blocks
  const int bid = blockIdx.x;
  const int k0 = bid / (B * KVH) * kTile;
  const int kv_head = bid % KVH, batch = bid / KVH % B;
  const int group = H / KVH;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  // the query rows that can see a key of this tile
  const int q_begin = causal ? k0 : 0;
  const int q_end = window > 0 ? min(Sq, k0 + kTile - 1 + window) : Sq;
  const int t_begin = q_begin / kTile;
  const int t_end = q_end > q_begin ? (q_end + kTile - 1) / kTile : t_begin;

  load_t<T, HD, kWide>(kt, k + batch * ks.b + kv_head * ks.h, ks.s, k0, Skv);
  load_t<T, HD, kWide>(vt, v + batch * vs.b + kv_head * vs.h, vs.s, k0, Skv);

  float acc_dk[4][kC], acc_dv[4][kC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kC; ++c) acc_dk[i][c] = acc_dv[i][c] = 0.f;

  for (int hh = 0; hh < group; ++hh) {
    const int head = kv_head * group + hh;
    const long long row_base = ((long long)batch * H + head) * Sq;
    for (int t = t_begin; t < t_end; ++t) {
      const int q0 = t * kTile;
      __syncthreads();  // the last tile's Q, dO, P and dS are no longer read
      load_t<T, HD, kNarrow>(qt, q + batch * qs.b + head * qs.h, qs.s, q0,
                             Sq);
      load_t<T, HD, kNarrow>(dot, dout + batch * dos.b + head * dos.h,
                             dos.s, q0, Sq);
      if (tid < kTile) {
        const bool in = q0 + tid < Sq;
        row_lse[tid] = in ? lse[row_base + q0 + tid] : 0.f;
        row_d[tid] = in ? delta[row_base + q0 + tid] : 0.f;
      }
      __syncthreads();

      // S^T and dP^T: keys 4 ty + i, query rows tx + 16 j
      float st[4][4], dpt[4][4];
      scores<HD>(st, dpt, kt, qt, vt, dot, ty, tx);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tx + 16 * j, qi = q0 + r;
        const float l = row_lse[r], dd = row_d[r];
        float p[4], ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool ok =
              unmasked(qi, k0 + 4 * ty + i, Sq, Skv, causal, window);
          p[i] = ok ? expf(fmaf(st[i][j], scale, -l)) : 0.f;
          ds[i] = p[i] * (dpt[i][j] - dd);
        }
        *reinterpret_cast<float4*>(ps + r * kWide + 4 * ty) =
            make_float4(p[0], p[1], p[2], p[3]);
        *reinterpret_cast<float4*>(dss + r * kWide + 4 * ty) =
            make_float4(ds[0], ds[1], ds[2], ds[3]);
      }
      __syncthreads();
      accumulate<HD>(acc_dv, ps, dot, ty, tx);  // dV += P^T dO
      accumulate<HD>(acc_dk, dss, qt, ty, tx);  // dK += dS^T Q
    }
  }

  T* dkb = dk + batch * dks.b + kv_head * dks.h;
  T* dvb = dv + batch * dvs.b + kv_head * dvs.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + 4 * ty + i;
    if (key >= Skv) continue;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int d = tx + 16 * c;
      dkb[(long long)key * dks.s + d] = from_f<T>(acc_dk[i][c] * scale);
      dvb[(long long)key * dvs.s + d] = from_f<T>(acc_dv[i][c]);
    }
  }
}

template <int HD>
constexpr int dq_floats() {
  // Q^T, dO^T [HD][kWide]; K^T, V^T [HD][kNarrow]; dS [kTile k][kWide q]
  return 2 * HD * kWide + 2 * HD * kNarrow + kTile * kWide;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             T* __restrict__ dq, int B, int H, int KVH, int Sq, int Skv,
             Strides qs, Strides ks, Strides vs, Strides dos, Strides dqs,
             int causal, int window, float scale) {
  constexpr int kC = HD / 16;
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);  // [HD][kWide]
  float* dot = qt + HD * kWide;                 // [HD][kWide]
  float* kt = dot + HD * kWide;                 // [HD][kNarrow]
  float* vt = kt + HD * kNarrow;                // [HD][kNarrow]
  float* dst = vt + HD * kNarrow;               // [kTile k][kWide q]

  // block -> (query tile, head, batch), the query tile slowest and
  // reversed: under the causal mask the last tiles see the most keys
  const int n_qt = (Sq + kTile - 1) / kTile;
  const int bid = blockIdx.x;
  const int q0 = (n_qt - 1 - bid / (B * H)) * kTile;
  const int head = bid % H, batch = bid / H % B;
  const int kv_head = head / (H / KVH);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  load_t<T, HD, kWide>(qt, q + batch * qs.b + head * qs.h, qs.s, q0, Sq);
  load_t<T, HD, kWide>(dot, dout + batch * dos.b + head * dos.h, dos.s, q0,
                       Sq);
  // this thread's rows 4 ty + i: their lse and D
  const long long row_base = ((long long)batch * H + head) * Sq;
  float l[4], dd[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + 4 * ty + i;
    l[i] = qi < Sq ? lse[row_base + qi] : 0.f;
    dd[i] = qi < Sq ? delta[row_base + qi] : 0.f;
  }

  // the key tiles that can hold an unmasked key for a row of this tile
  int k_end = Skv;
  if (causal) k_end = min(k_end, q0 + kTile);
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_end = (k_end + kTile - 1) / kTile;

  float acc[4][kC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kC; ++c) acc[i][c] = 0.f;

  const T* kb = k + batch * ks.b + kv_head * ks.h;
  const T* vb = v + batch * vs.b + kv_head * vs.h;
  for (int t = k_begin / kTile; t < t_end; ++t) {
    const int k0 = t * kTile;
    __syncthreads();  // the last tile's K, V and dS are no longer read
    load_t<T, HD, kNarrow>(kt, kb, ks.s, k0, Skv);
    load_t<T, HD, kNarrow>(vt, vb, vs.s, k0, Skv);
    __syncthreads();

    // S and dP: query rows 4 ty + i, keys tx + 16 j
    float s[4][4], dp[4][4];
    scores<HD>(s, dp, qt, kt, dot, vt, ty, tx);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool ok =
            unmasked(q0 + 4 * ty + i, k0 + c, Sq, Skv, causal, window);
        const float p = ok ? expf(fmaf(s[i][j], scale, -l[i])) : 0.f;
        ds[i] = p * (dp[i][j] - dd[i]);
      }
      *reinterpret_cast<float4*>(dst + c * kWide + 4 * ty) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();
    accumulate<HD>(acc, dst, kt, ty, tx);  // dQ += dS K
  }

  T* dqb = dq + batch * dqs.b + head * dqs.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + 4 * ty + i;
    if (qi >= Sq) continue;
#pragma unroll
    for (int c = 0; c < kC; ++c)
      dqb[(long long)qi * dqs.s + tx + 16 * c] = from_f<T>(acc[i][c] * scale);
  }
}

// st[3 t .. 3 t + 2]: the (batch, head, sequence) strides of tensor t = q,
// k, v, o, dO, dQ, dK, dV
template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, int B, int H, int KVH, int Sq, int Skv,
           const long long* st, int causal, int window,
           cudaStream_t stream) {
  const auto S = [st](int t) {
    return Strides{st[3 * t], st[3 * t + 1], st[3 * t + 2]};
  };
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* dop = static_cast<const T*>(dout);
  const float scale = (float)(1.0 / sqrt((double)HD));

  const long long rows = (long long)B * H * Sq;
  const long long delta_blocks = (rows + kWarps - 1) / kWarps;
  if (delta_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  flash_bwd_delta<T, HD><<<(unsigned)delta_blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(o), dop, delta, H, Sq, rows, S(3), S(4));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  constexpr int kv_bytes = dkdv_floats<HD>() * (int)sizeof(float);
  err = cudaFuncSetAttribute(flash_bwd_dkdv<T, HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kv_bytes);
  if (err != cudaSuccess) return (int)err;
  const int n_kt = (Skv + kTile - 1) / kTile;
  flash_bwd_dkdv<T, HD><<<n_kt * B * KVH, kThreads, kv_bytes, stream>>>(
      qp, kp, vp, dop, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      B, H, KVH, Sq, Skv, S(0), S(1), S(2), S(4), S(6), S(7), causal, window,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  constexpr int q_bytes = dq_floats<HD>() * (int)sizeof(float);
  err = cudaFuncSetAttribute(flash_bwd_dq<T, HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             q_bytes);
  if (err != cudaSuccess) return (int)err;
  const int n_qt = (Sq + kTile - 1) / kTile;
  flash_bwd_dq<T, HD><<<n_qt * B * H, kThreads, q_bytes, stream>>>(
      qp, kp, vp, dop, lse, delta, static_cast<T*>(dq), B, H, KVH, Sq, Skv,
      S(0), S(1), S(2), S(4), S(5), causal, window, scale);
  return (int)cudaGetLastError();
}

using Launch = int (*)(const void*, const void*, const void*, const void*,
                       const void*, const float*, float*, void*, void*,
                       void*, int, int, int, int, int, const long long*, int,
                       int, cudaStream_t);

template <int HD>
Launch pick(bool bf16) {
  if (bf16) return launch<__nv_bfloat16, HD>;
  return launch<float, HD>;
}

}  // namespace

// q, o, dout, dq: (B, H, Sq, hd); k, v, dk, dv: (B, KVH, Skv, hd), each
// addressed through strides[3 t .. 3 t + 2] = its (batch, head, sequence)
// strides in elements, t = q, k, v, o, dout, dq, dk, dv.  lse: the
// forward's (B, H, Sq) fp32; delta: (B, H, Sq) fp32 scratch.  dtype: 0 =
// float32, 1 = bfloat16, for every tensor but lse and delta.  The blocks
// of flash_bwd_dkdv (key tiles x B x KVH) and flash_bwd_dq (query tiles x
// B x H) must fit a 1-d grid.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const float* lse,
                                   float* delta, void* dq, void* dk,
                                   void* dv, int dtype, int B, int H,
                                   int KVH, int Sq, int Skv, int hd,
                                   const long long* strides, int causal,
                                   int window, void* stream) {
  if (B < 1 || H < 1 || KVH < 1 || H % KVH || Sq < 1 || Skv < 1 ||
      window < 0 || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  const long long n_kt = (Skv + kTile - 1) / kTile;
  const long long n_qt = (Sq + kTile - 1) / kTile;
  if (n_kt * B * KVH > 0x7fffffffLL || n_qt * B * H > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const bool bf16 = dtype == 1;
  Launch fn = nullptr;
  switch (hd) {
    case 32: fn = pick<32>(bf16); break;
    case 64: fn = pick<64>(bf16); break;
    case 80: fn = pick<80>(bf16); break;
    case 96: fn = pick<96>(bf16); break;
    case 112: fn = pick<112>(bf16); break;
    case 128: fn = pick<128>(bf16); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return fn(q, k, v, o, dout, lse, delta, dq, dk, dv, B, H, KVH, Sq, Skv,
            strides, causal, window, static_cast<cudaStream_t>(stream));
}
