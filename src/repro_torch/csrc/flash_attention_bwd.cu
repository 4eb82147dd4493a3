// Backward pass of flash attention (grouped-query heads, causal masking and
// an optional sliding window) for Hopper (sm_90a).  Built by
// repro_torch/kernels/build.py into a shared library with a plain C
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
// only evaluated where the key is unmasked).  P, dS and the accumulators
// are fp32; the gradients are rounded once, to the input's type, when they
// are written.  Both routes first launch flash_bwd_delta<T, HD> (D, one
// warp a row); then, by the inputs' type:
//
// bf16 (every training path): two kernels on the tensor cores, each
// recomputing S and dP (12 products where the bound counts 5), so that no
// block adds into another's output: no atomics, and two launches agree bit
// for bit.  q, k, v and dO are bf16, so S = Q K^T and dP = dO V^T are exact
// products summed in fp32 by wgmma; P (as exp2(s log2 e q.k - lse log2 e),
// one fma and one exp2 a score) and dS are formed in fp32 in registers
// and each is split into bf16 terms, hi = bf16(x), lo = bf16(x - hi) and,
// where there are three, bf16 of what is left, and every product that
// reads them is issued once a term: kKvTerms = 3 for P^T dO and dS^T Q,
// kDqTerms = 2 for dS K.  One term, as FA2/FA3 round P and dS, misses the
// bf16 check's tolerance by two orders of magnitude in the CPU emulation
// of tests/test_torch_flash_bwd_wgmma.py, and two meet it there; on an
// H100 two for dK and dV left 1 of scripts/flash_bwd_study.py's 24 checks
// at danube's shape 1.05x over it, on a small value of an early key (such
// sums run over 4 heads of up to 4,096 rows; the fp32 reference's own
// error takes part of the budget), and three left none over; dQ, a sum
// over one head's keys, did not miss with two.  wgmma sums a tile's
// products (its k16 steps and terms) into a zeroed fp32 tile, which is
// then added into the gradient's accumulator with fp32 adds: the tensor
// cores drop the low bits of their running sums instead of rounding them,
// and chaining every tile's wgmma into the accumulator over a key's whole
// column (4,096 rows of 4 heads at danube's shape) put all 24 of those
// checks over the limit, up to 10.5x.
//   flash_bwd_dkdv_wgmma<HD>  one block per (key tile of 128, KV head,
//       batch), the heaviest causal key tiles first; two consumer
//       warpgroups own 64 keys each, and a producer warpgroup (setmaxnreg
//       gives its registers to them) loads K and V once by TMA, then
//       streams Q and dO tiles of 64 rows over the group's G heads and, for
//       each, the query tiles that can see a key of the block, through a
//       2-stage mbarrier ring; one of its warps brings each tile's lse and D
//       into shared memory beside it.  Per tile a consumer computes S^T =
//       K Q^T and dP^T = V dO^T (wgmma m64n64k16, both operands K-major),
//       P^T and dS^T in the accumulator fragment (its columns are query
//       rows, so lse and D are read by column), packs their terms straight
//       into A fragments (one product's accumulator layout is the next
//       one's A layout) and forms P^T dO and dS^T Q (A from registers, dO
//       and Q as the MN-major B operand in pieces of at most 64 head-dim
//       columns, one per swizzle atom), each added into dV or dK.  P is
//       formed while the dP product runs.  The sum over the group is the
//       loop in the block, in a fixed order.
//   flash_bwd_dq_wgmma<HD>    one block per (query tile of 128, head,
//       batch), the heaviest tile first; Q, dO, lse and D staged once, K
//       and V tiles of 128 keys streamed by TMA over the keys the tile can
//       see; per tile each consumer warpgroup (64 rows) computes S = Q K^T
//       and dP = dO V^T (the forward's first product), dS, its terms, and
//       dS K (K as the MN-major B operand, the forward's second product),
//       added into dQ.
// Both mask only the tiles that hold a masked key for some row, skip a
// warpgroup's tile where it holds none that is unmasked, and read lse =
// +inf for a row past Sq or one that sees no key, so that its P is 0.
//
// fp32 (the card-against-CPU checks): CUDA-core kernels, fp32 arithmetic
// throughout (a wgmma on fp32 data would be TF32).
//   flash_bwd_dkdv<float, HD>  one block per (key tile of 64, KV head,
//       batch), the heaviest causal tiles first; K and V stay in shared
//       memory while the block walks the group's G query heads and, for
//       each, the query tiles of 64 rows that can see a key of its tile; it
//       recomputes S and dP = dO V^T, then P and dS, and adds P^T dO to dV
//       and dS^T Q to dK in registers;
//   flash_bwd_dq<float, HD>    one block per (query tile of 64, head,
//       batch), Q, dO, lse and D staged once; it walks the key tiles the
//       forward visits, recomputes S, dP, P and dS, and adds dS K to dQ.
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
// card's bf16 tensor-core peak, so operations bound it.  The bf16 kernels
// issue 12 products of that size (7 distinct ones, the 3 that read P or dS
// once a term), about 2.1e12 operations: 2.08 ms at the peak, before the
// masked halves of the diagonal tiles.  Between a tile's products the
// consumers form P and dS (an exp a score) and add the tiles up on the CUDA
// cores; only the other warpgroup's products overlap that.  The fp32
// kernels multiply on the CUDA cores (the five products alone are 12.8 ms
// at the fp32 peak) and read shared memory every two to four multiply-adds.
//
// Built without --use_fast_math: exp of a score far below lse must give 0.
// No allocation and no synchronisation here: each entry point launches on
// the caller's stream (the caller allocates D's scratch) and returns
// cudaGetLastError() (or, for a tensor map cuTensorMapEncodeTiled refuses,
// the negated CUresult).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"  // mbarriers, TMA, wgmma; the tensor-map encoder

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

// ===========================================================================
// bf16: wgmma, TMA and mbarriers (hopper.cuh)
// ===========================================================================

// bf16 terms of P and dS in the dK/dV kernel, of dS in the dQ kernel
constexpr int kKvTerms = 3;
constexpr int kDqTerms = 2;
constexpr int kKvKeys = 128;  // dK/dV kernel: keys a block, 64 a warpgroup
constexpr int kKvRows = 64;   // dK/dV kernel: query rows a streamed tile
constexpr int kDqRows = 128;  // dQ kernel: query rows a block
constexpr int kDqKeys = 128;  // dQ kernel: keys a streamed K/V tile
constexpr int kRowBox = kKvRows * kChunk * 2;  // one 64 x 64 bf16 box
// the full barrier of a streamed tile: the TMA thread's arrival (with the
// bytes it expects) and one from each lane of the warp that brings lse, D
constexpr unsigned kFullArrivals = 1 + 32;
constexpr float kLog2e = 1.4426950408889634f;

static_assert(kKvKeys == kWgKeys && kDqRows == kWgRows &&
                  kDqKeys == kWgKeys,
              "the 128-row tiles use the forward's boxes");

// (v0, v1) -> T packed bf16 pairs whose sum is (v0, v1) to within 2^-8T
// of each: hi = bf16(v), then bf16 of what is left; v0 in the low half, as
// the A fragments hold a pair
template <int T>
__device__ __forceinline__ void split(float v0, float v1, uint32_t (&t)[T]) {
#pragma unroll
  for (int k = 0; k < T; ++k) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
    t[k] = *reinterpret_cast<const uint32_t*>(&h);
    const float2 hf = __bfloat1622float2(h);
    v0 -= hf.x;
    v1 -= hf.y;
  }
}

// The A fragments of k16 step kk of a 64 x N accumulator fragment x (its
// columns become the product's depth): columns 16 kk .. are the n8 blocks
// 2 kk and 2 kk + 1, each in T terms
template <int KSteps, int T>
__device__ __forceinline__ void pack_terms(const float* x,
                                           uint32_t (&a)[KSteps][T][4]) {
#pragma unroll
  for (int kk = 0; kk < KSteps; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      uint32_t t[T];
      split<T>(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1], t);
#pragma unroll
      for (int k = 0; k < T; ++k) a[kk][k][r] = t[k];
    }
}

// tile (64 x N, fp32) = A . B over KSteps k16 steps, each A in T terms
// (B in shared memory, MN-major: KSteps x 16 rows of N <= 64 columns from
// b_addr); issued, not waited for
template <int N, int KSteps, int T>
__device__ __forceinline__ void issue_terms(
    float* tile, const uint32_t (&a)[KSteps][T][4], uint32_t b_addr) {
#pragma unroll
  for (int kk = 0; kk < KSteps; ++kk)
#pragma unroll
    for (int k = 0; k < T; ++k)
      wgmma_rs<N>(tile, a[kk][k], smem_desc(b_addr + kk * 2 * kAtomBytes));
}

// acc (64 x HD, fp32, a wgmma accumulator fragment) += A . B, B's HD
// columns in boxes of 64 box_bytes apart.  wgmma sums a box's products into
// a zeroed tile, which is added into acc with fp32 adds: the tensor cores
// drop the low bits of their sums (they truncate, where an fp32 add
// rounds), so one long chain of wgmma into acc over a whole row or key
// range (4,096 rows of 4 heads for a key at danube's shape) would carry a
// bias that grows with the chain; a tile's chain is KSteps x T long.
// One box of columns at a time keeps the tile to 32 registers (a tile
// spanning the head dim, one wait for both boxes, measured slower).
template <int HD, int KSteps, int T>
__device__ __forceinline__ void add_product(
    float* acc, const uint32_t (&a)[KSteps][T][4], uint32_t b_addr,
    int box_bytes) {
  constexpr int kN0 = HD < kChunk ? HD : kChunk;  // columns in box 0
  constexpr int kN1 = HD - kN0;                   // in box 1
  float tile[kChunk / 2];
#pragma unroll
  for (int c = 0; c < (kN1 > 0 ? 2 : 1); ++c) {
#pragma unroll
    for (int i = 0; i < kChunk / 2; ++i) tile[i] = 0.f;
    fence_regs<kChunk / 2>(tile);
    wgmma_fence();
    if (c == 0) issue_terms<kN0, KSteps, T>(tile, a, b_addr);
    if constexpr (kN1 > 0)
      if (c == 1) issue_terms<kN1, KSteps, T>(tile, a, b_addr + box_bytes);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<kChunk / 2>(tile);
#pragma unroll
    for (int i = 0; i < (c == 0 ? kN0 : kN1) / 2; ++i)
      acc[c * kChunk / 2 + i] += tile[i];
  }
}

// a row's lse and D as the wgmma kernels read them: lse in base 2 (lse
// log2 e, so that P = exp2(s log2 e q.k - that): one fma and one exp2), and
// +inf past Sq and where the row sees no key (lse = -inf), so that P is 0
__device__ __forceinline__ void row_stats(const float* __restrict__ lse,
                                          const float* __restrict__ delta,
                                          long long base, int qi, int Sq,
                                          float* l, float* d) {
  *l = INFINITY;
  *d = 0.f;
  if (qi < Sq) {
    const float x = lse[base + qi];
    *l = x == -INFINITY ? INFINITY : x * kLog2e;
    *d = delta[base + qi];
  }
}

template <int HD>
constexpr int dkdv_wgmma_bytes() {
  constexpr int chunks = (HD + kChunk - 1) / kChunk;
  // K, V tiles of 128 keys; kStages x (Q, dO) tiles of 64 rows; alignment
  return 2 * chunks * kBoxBytes + kStages * 2 * chunks * kRowBox + 1024;
}

template <int HD>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_do,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int B, int H, int KVH,
                     int Sq, int Skv, Strides dks, Strides dvs, int causal,
                     int window, float scale, float scale_log2) {
  static_assert(HD % 16 == 0 && HD <= 2 * kChunk, "head dim");
  constexpr int kChunks = (HD + kChunk - 1) / kChunk;
  constexpr int kKvTile = kChunks * kBoxBytes;  // K or V, 128 keys
  constexpr int kQTile = kChunks * kRowBox;     // Q or dO, 64 rows
  constexpr int kSteps = HD / 16;          // k16 steps of K Q^T over hd
  constexpr int kRSteps = kKvRows / 16;    // k16 steps of P^T dO over rows
  constexpr int kAcc = HD / 2;             // dK or dV floats a thread holds
  constexpr int kS = kKvRows / 2;          // S^T floats a thread holds

  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bar_kv, bar_full[kStages], bar_empty[kStages];
  __shared__ float row_lse[kStages][kKvRows], row_d[kStages][kKvRows];
  // the swizzle atoms must start on 1024-byte boundaries
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sk = smem;                         // [kChunks][128][64]
  uint8_t* sv = sk + kKvTile;
  uint8_t* sq = sv + kKvTile;                 // [kStages] tiles of 64 rows
  uint8_t* sdo = sq + kStages * kQTile;       // [kStages] tiles

  // block -> (key tile, KV head, batch), the key tile slowest: under the
  // causal mask the first key tiles meet the most query rows, so they start
  // first and the last wave holds the lightest blocks
  const int bid = blockIdx.x;
  const int k0 = bid / (B * KVH) * kKvKeys;
  const int kv_head = bid % KVH, batch = bid / KVH % B;
  const int group = H / KVH;

  // the query tiles that can see a key of this block, for each of the
  // group's heads: step i is head i / n_qt, tile t_begin + i % n_qt
  const int q_begin = causal ? k0 : 0;
  const int q_end = window > 0 ? min(Sq, k0 + kKvKeys - 1 + window) : Sq;
  const int t_begin = q_begin / kKvRows;
  const int n_qt =
      q_end > q_begin ? (q_end + kKvRows - 1) / kKvRows - t_begin : 0;
  const int n_steps = group * n_qt;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    mbar_init(&bar_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&bar_full[s], kFullArrivals);
      mbar_init(&bar_empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kProducerRegs));
    if (warp == kConsumerWarps && lane == 0) {
      // K and V once, then each step's Q and dO into the next free stage
      mbar_expect_tx(&bar_kv, 2 * kKvTile);
      for (int c = 0; c < kChunks; ++c) {
        tma_load_4d(sk + c * kBoxBytes, &tm_k, &bar_kv, c * kChunk, k0,
                    kv_head, batch);
        tma_load_4d(sv + c * kBoxBytes, &tm_v, &bar_kv, c * kChunk, k0,
                    kv_head, batch);
      }
      for (int i = 0; i < n_steps; ++i) {
        const int s = i % kStages;
        const int head = kv_head * group + i / n_qt;
        const int q0 = (t_begin + i % n_qt) * kKvRows;
        mbar_wait(&bar_empty[s], ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(&bar_full[s], 2 * kQTile);
        for (int c = 0; c < kChunks; ++c) {
          tma_load_4d(sq + s * kQTile + c * kRowBox, &tm_q, &bar_full[s],
                      c * kChunk, q0, head, batch);
          tma_load_4d(sdo + s * kQTile + c * kRowBox, &tm_do, &bar_full[s],
                      c * kChunk, q0, head, batch);
        }
      }
    } else if (warp == kConsumerWarps + 1) {
      // each step's lse and D, beside its tiles
      for (int i = 0; i < n_steps; ++i) {
        const int s = i % kStages;
        const int head = kv_head * group + i / n_qt;
        const int q0 = (t_begin + i % n_qt) * kKvRows;
        const long long base = ((long long)batch * H + head) * Sq;
        mbar_wait(&bar_empty[s], ((i / kStages) & 1) ^ 1);
        for (int r = lane; r < kKvRows; r += 32)
          row_stats(lse, delta, base, q0 + r, Sq, &row_lse[s][r],
                    &row_d[s][r]);
        mbar_arrive(&bar_full[s]);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        kConsumerRegs));
    // a consumer: warpgroup wg owns keys kw0 .. kw0 + 63; in the S^T
    // fragments (keys x query rows) a thread holds keys key and key + 8
    // and, of each 8 rows, the two at 2 (lane % 4)
    const int wg = warp / 4;
    const int kw0 = k0 + wg * 64;
    const int key = kw0 + (warp % 4) * 16 + lane / 4;
    const int col = 2 * (lane % 4);

    float dk_acc[kAcc], dv_acc[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) dk_acc[i] = dv_acc[i] = 0.f;

    const uint32_t k_addr = smem_u32(sk) + wg * 64 * 128;
    const uint32_t v_addr = smem_u32(sv) + wg * 64 * 128;
    mbar_wait(&bar_kv, 0);

    for (int i = 0; i < n_steps; ++i) {
      const int s = i % kStages;
      const int q0 = (t_begin + i % n_qt) * kKvRows;
      mbar_wait(&bar_full[s], (i / kStages) & 1);
      // does a row of this tile see a key of this warpgroup?
      const bool seen = kw0 < Skv &&
                        (!causal || q0 + kKvRows - 1 >= kw0) &&
                        (window <= 0 || q0 - (kw0 + 63) < window);
      if (seen) {
        const uint32_t q_addr = smem_u32(sq + s * kQTile);
        const uint32_t do_addr = smem_u32(sdo + s * kQTile);
        // S^T = K Q^T and dP^T = V dO^T, two groups in flight
        float st[kS], dpt[kS];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kSteps; ++kk)
          wgmma_ss_n64(st,
                       smem_desc(k_addr + (kk / 4) * kBoxBytes +
                                 (kk % 4) * 32),
                       smem_desc(q_addr + (kk / 4) * kRowBox +
                                 (kk % 4) * 32),
                       kk > 0);
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < kSteps; ++kk)
          wgmma_ss_n64(dpt,
                       smem_desc(v_addr + (kk / 4) * kBoxBytes +
                                 (kk % 4) * 32),
                       smem_desc(do_addr + (kk / 4) * kRowBox +
                                 (kk % 4) * 32),
                       kk > 0);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs<kS>(st);

        // P^T in place of S^T: the fragment's column 8 j + col + (e & 1)
        // is query row q0 + that; masked only where this warpgroup's keys
        // meet a masked key of some row
        const bool ragged = kw0 + 64 > Skv;
        const bool diag = causal && kw0 + 63 > q0;
        const bool edge = window > 0 && kw0 <= q0 + kKvRows - 1 - window;
        const float* tl = row_lse[s];
        const float* td = row_d[s];
        if (ragged || diag || edge) {
#pragma unroll
          for (int j = 0; j < kS / 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = 8 * j + col + (e & 1);
              const int kj = key + (e >> 1) * 8, qi = q0 + r;
              const bool ok = kj < Skv && (!causal || kj <= qi) &&
                              (window <= 0 || kj > qi - window);
              st[4 * j + e] =
                  ok ? exp2f(fmaf(st[4 * j + e], scale_log2, -tl[r])) : 0.f;
            }
        } else {
#pragma unroll
          for (int j = 0; j < kS / 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              st[4 * j + e] = exp2f(fmaf(st[4 * j + e], scale_log2,
                                        -tl[8 * j + col + (e & 1)]));
        }

        wgmma_wait<0>();
        fence_regs<kS>(dpt);

        // dS^T = P^T (dP^T - D) in place of dP^T; then dV += P^T dO and
        // dK += dS^T Q, each A in kKvTerms terms
#pragma unroll
        for (int j = 0; j < kS / 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dpt[4 * j + e] = st[4 * j + e] *
                             (dpt[4 * j + e] - td[8 * j + col + (e & 1)]);
        uint32_t pa[kRSteps][kKvTerms][4], da[kRSteps][kKvTerms][4];
        pack_terms<kRSteps, kKvTerms>(st, pa);
        pack_terms<kRSteps, kKvTerms>(dpt, da);
        add_product<HD, kRSteps, kKvTerms>(dv_acc, pa, do_addr, kRowBox);
        add_product<HD, kRSteps, kKvTerms>(dk_acc, da, q_addr, kRowBox);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&bar_empty[s]);
    }

    // s dK and dV in bf16, keys < Skv only, through the outputs' strides
    __nv_bfloat16* dkb = dk + batch * dks.b + kv_head * dks.h;
    __nv_bfloat16* dvb = dv + batch * dvs.b + kv_head * dvs.h;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kj = key + 8 * h;
      if (kj >= Skv) continue;
      __nv_bfloat16* krow = dkb + kj * dks.s + col;
      __nv_bfloat16* vrow = dvb + kj * dvs.s + col;
#pragma unroll
      for (int j = 0; j < kAcc / 4; ++j) {
        *reinterpret_cast<uint32_t*>(krow + 8 * j) =
            pack_bf16(dk_acc[4 * j + 2 * h] * scale,
                      dk_acc[4 * j + 2 * h + 1] * scale);
        *reinterpret_cast<uint32_t*>(vrow + 8 * j) =
            pack_bf16(dv_acc[4 * j + 2 * h], dv_acc[4 * j + 2 * h + 1]);
      }
    }
  }
}

template <int HD>
constexpr int dq_wgmma_bytes() {
  constexpr int tile = (HD + kChunk - 1) / kChunk * kBoxBytes;
  // Q, dO; kStages x (K, V); alignment
  return 2 * tile + kStages * 2 * tile + 1024;
}

template <int HD>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_do,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta,
                   __nv_bfloat16* __restrict__ dq, int B, int H, int KVH,
                   int Sq, int Skv, Strides dqs, int causal, int window,
                   float scale, float scale_log2) {
  static_assert(HD % 16 == 0 && HD <= 2 * kChunk, "head dim");
  constexpr int kChunks = (HD + kChunk - 1) / kChunk;
  constexpr int kTileBytes = kChunks * kBoxBytes;  // Q, dO, K or V tile
  constexpr int kSteps = HD / 16;         // k16 steps of Q K^T over hd
  constexpr int kPSteps = kDqKeys / 16;   // k16 steps of dS K over keys
  constexpr int kAcc = HD / 2;            // dQ floats a thread holds
  constexpr int kS = kDqKeys / 2;         // S floats a thread holds

  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bar_q, bar_k[kStages], bar_v[kStages],
      bar_empty[kStages];
  __shared__ float row_lse[kDqRows], row_d[kDqRows];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sq = smem;                              // [kChunks][128][64]
  uint8_t* sdo = sq + kTileBytes;
  uint8_t* sk = sdo + kTileBytes;                  // [kStages] tiles
  uint8_t* sv = sk + kStages * kTileBytes;         // [kStages] tiles

  // block -> (query tile, head, batch), the query tile slowest and
  // reversed: under the causal mask the last tiles see the most keys
  const int n_qt = (Sq + kDqRows - 1) / kDqRows;
  const int bid = blockIdx.x;
  const int q0 = (n_qt - 1 - bid / (B * H)) * kDqRows;
  const int head = bid % H, batch = bid / H % B;
  const int kv_head = head / (H / KVH);

  // the key tiles that can hold an unmasked key for some row of this tile
  int k_end = Skv;
  if (causal) k_end = min(k_end, q0 + kDqRows);
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_begin = k_begin / kDqKeys;
  const int n_tiles = max(0, (k_end + kDqKeys - 1) / kDqKeys - t_begin);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    mbar_init(&bar_q, kFullArrivals);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&bar_k[s], 1);
      mbar_init(&bar_v[s], 1);
      mbar_init(&bar_empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kProducerRegs));
    if (warp == kConsumerWarps && lane == 0) {
      // Q and dO once, then each K/V tile into the next free stage
      mbar_expect_tx(&bar_q, 2 * kTileBytes);
      for (int c = 0; c < kChunks; ++c) {
        tma_load_4d(sq + c * kBoxBytes, &tm_q, &bar_q, c * kChunk, q0, head,
                    batch);
        tma_load_4d(sdo + c * kBoxBytes, &tm_do, &bar_q, c * kChunk, q0,
                    head, batch);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        const int k0 = (t_begin + i) * kDqKeys;
        mbar_wait(&bar_empty[s], ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(&bar_k[s], kTileBytes);
        for (int c = 0; c < kChunks; ++c)
          tma_load_4d(sk + s * kTileBytes + c * kBoxBytes, &tm_k, &bar_k[s],
                      c * kChunk, k0, kv_head, batch);
        mbar_expect_tx(&bar_v[s], kTileBytes);
        for (int c = 0; c < kChunks; ++c)
          tma_load_4d(sv + s * kTileBytes + c * kBoxBytes, &tm_v, &bar_v[s],
                      c * kChunk, k0, kv_head, batch);
      }
    } else if (warp == kConsumerWarps + 1) {
      const long long base = ((long long)batch * H + head) * Sq;
      for (int r = lane; r < kDqRows; r += 32)
        row_stats(lse, delta, base, q0 + r, Sq, &row_lse[r], &row_d[r]);
      mbar_arrive(&bar_q);
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        kConsumerRegs));
    // a consumer: warpgroup wg owns rows q0 + 64 wg .. + 63; in the wgmma
    // fragments a thread holds rows row and row + 8 and, of each 8 keys,
    // the two at 2 (lane % 4)
    const int wg = warp / 4;
    const int wg_row0 = q0 + wg * 64;
    const int row = wg_row0 + (warp % 4) * 16 + lane / 4;
    const int col = 2 * (lane % 4);

    float acc[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;

    const uint32_t q_addr = smem_u32(sq) + wg * 64 * 128;
    const uint32_t do_addr = smem_u32(sdo) + wg * 64 * 128;
    mbar_wait(&bar_q, 0);
    float l[2], dd[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] = row_lse[row - q0 + 8 * h];
      dd[h] = row_d[row - q0 + 8 * h];
    }

    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStages;
      const uint32_t parity = (i / kStages) & 1;
      const int k0 = (t_begin + i) * kDqKeys;
      // does a row of this warpgroup see a key of this tile?
      const bool seen = wg_row0 < Sq && (!causal || k0 <= wg_row0 + 63) &&
                        (window <= 0 || k0 + kDqKeys - 1 > wg_row0 - window);
      if (!seen) {
        // released only once its loads have landed
        mbar_wait(&bar_k[s], parity);
        mbar_wait(&bar_v[s], parity);
      } else {
        // S = Q K^T and dP = dO V^T, two groups in flight
        float sc[kS], dp[kS];
        const uint32_t k_addr = smem_u32(sk + s * kTileBytes);
        const uint32_t v_addr = smem_u32(sv + s * kTileBytes);
        mbar_wait(&bar_k[s], parity);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kSteps; ++kk) {
          const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
          wgmma_ss_n128(sc, smem_desc(q_addr + off), smem_desc(k_addr + off),
                        kk > 0);
        }
        wgmma_commit();
        mbar_wait(&bar_v[s], parity);
#pragma unroll
        for (int kk = 0; kk < kSteps; ++kk) {
          const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
          wgmma_ss_n128(dp, smem_desc(do_addr + off), smem_desc(v_addr + off),
                        kk > 0);
        }
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs<kS>(sc);

        // P in place of S, masked only where this warpgroup's rows meet a
        // masked key
        const bool ragged = k0 + kDqKeys > Skv;
        const bool diag = causal && k0 + kDqKeys - 1 > wg_row0;
        const bool edge = window > 0 && k0 <= wg_row0 + 63 - window;
        if (ragged || diag || edge) {
#pragma unroll
          for (int j = 0; j < kS / 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int kj = k0 + 8 * j + col + (e & 1);
              const int r = row + (e >> 1) * 8;
              const bool ok = kj < Skv && (!causal || kj <= r) &&
                              (window <= 0 || kj > r - window);
              sc[4 * j + e] = ok ? exp2f(fmaf(sc[4 * j + e], scale_log2,
                                              -l[e >> 1]))
                                 : 0.f;
            }
        } else {
#pragma unroll
          for (int j = 0; j < kS / 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              sc[4 * j + e] =
                  exp2f(fmaf(sc[4 * j + e], scale_log2, -l[e >> 1]));
        }
        wgmma_wait<0>();
        fence_regs<kS>(dp);

        // dS = P (dP - D), in kDqTerms terms; dQ += dS K
#pragma unroll
        for (int j = 0; j < kS / 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dp[4 * j + e] = sc[4 * j + e] * (dp[4 * j + e] - dd[e >> 1]);
        uint32_t da[kPSteps][kDqTerms][4];
        pack_terms<kPSteps, kDqTerms>(dp, da);
        add_product<HD, kPSteps, kDqTerms>(acc, da, k_addr, kBoxBytes);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&bar_empty[s]);
    }

    // s dQ in bf16, rows < Sq only, through the output's strides
    __nv_bfloat16* qb = dq + batch * dqs.b + head * dqs.h;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row + 8 * h;
      if (r >= Sq) continue;
      __nv_bfloat16* qrow = qb + r * dqs.s + col;
#pragma unroll
      for (int j = 0; j < kAcc / 4; ++j)
        *reinterpret_cast<uint32_t*>(qrow + 8 * j) = pack_bf16(
            acc[4 * j + 2 * h] * scale, acc[4 * j + 2 * h + 1] * scale);
    }
  }
}

// st[3 t .. 3 t + 2]: the (batch, head, sequence) strides of tensor t = q,
// k, v, o, dO, dQ, dK, dV
Strides strides_of(const long long* st, int t) {
  return Strides{st[3 * t], st[3 * t + 1], st[3 * t + 2]};
}

// D = rowsum(dO o) into delta, (B, H, Sq) fp32
template <typename T, int HD>
cudaError_t launch_delta(const void* o, const void* dout, float* delta,
                         int B, int H, int Sq, const long long* st,
                         cudaStream_t stream) {
  const long long rows = (long long)B * H * Sq;
  const long long delta_blocks = (rows + kWarps - 1) / kWarps;
  if (delta_blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_bwd_delta<T, HD><<<(unsigned)delta_blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, H, Sq,
      rows, strides_of(st, 3), strides_of(st, 4));
  return cudaGetLastError();
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, int B, int H, int KVH, int Sq, int Skv,
           const long long* st, int causal, int window,
           cudaStream_t stream) {
  const auto S = [st](int t) { return strides_of(st, t); };
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* dop = static_cast<const T*>(dout);
  const float scale = (float)(1.0 / sqrt((double)HD));

  cudaError_t err = launch_delta<T, HD>(o, dout, delta, B, H, Sq, st,
                                        stream);
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

template <int HD>
int launch_wgmma(const void* q, const void* k, const void* v, const void* o,
                 const void* dout, const float* lse, float* delta, void* dq,
                 void* dk, void* dv, int B, int H, int KVH, int Sq, int Skv,
                 const long long* st, int causal, int window,
                 cudaStream_t stream) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  // the dK/dV kernel streams Q and dO in boxes of 64 rows, the dQ kernel
  // reads them in boxes of 128; K and V are read in boxes of 128 by both
  CUtensorMap tm_q64, tm_do64, tm_q, tm_do, tm_k, tm_v;
  CUresult r = make_map(&tm_q64, encode, q, HD, Sq, H, B, st, kKvRows);
  if (r == CUDA_SUCCESS)
    r = make_map(&tm_do64, encode, dout, HD, Sq, H, B, st + 12, kKvRows);
  if (r == CUDA_SUCCESS) r = make_map(&tm_q, encode, q, HD, Sq, H, B, st);
  if (r == CUDA_SUCCESS)
    r = make_map(&tm_do, encode, dout, HD, Sq, H, B, st + 12);
  if (r == CUDA_SUCCESS)
    r = make_map(&tm_k, encode, k, HD, Skv, KVH, B, st + 3);
  if (r == CUDA_SUCCESS)
    r = make_map(&tm_v, encode, v, HD, Skv, KVH, B, st + 6);
  if (r != CUDA_SUCCESS) return -(int)r;
  const float scale = (float)(1.0 / sqrt((double)HD));

  cudaError_t err = launch_delta<__nv_bfloat16, HD>(o, dout, delta, B, H,
                                                    Sq, st, stream);
  if (err != cudaSuccess) return (int)err;

  constexpr int kv_bytes = dkdv_wgmma_bytes<HD>();
  err = cudaFuncSetAttribute(flash_bwd_dkdv_wgmma<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kv_bytes);
  if (err != cudaSuccess) return (int)err;
  const int n_kt = (Skv + kKvKeys - 1) / kKvKeys;
  flash_bwd_dkdv_wgmma<HD><<<n_kt * B * KVH, kWgThreads, kv_bytes, stream>>>(
      tm_q64, tm_k, tm_v, tm_do64, lse, delta,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), B,
      H, KVH, Sq, Skv, strides_of(st, 6), strides_of(st, 7), causal, window,
      scale, scale * kLog2e);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  constexpr int q_bytes = dq_wgmma_bytes<HD>();
  err = cudaFuncSetAttribute(flash_bwd_dq_wgmma<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             q_bytes);
  if (err != cudaSuccess) return (int)err;
  const int n_qt = (Sq + kDqRows - 1) / kDqRows;
  flash_bwd_dq_wgmma<HD><<<n_qt * B * H, kWgThreads, q_bytes, stream>>>(
      tm_q, tm_k, tm_v, tm_do, lse, delta, static_cast<__nv_bfloat16*>(dq),
      B, H, KVH, Sq, Skv, strides_of(st, 5), causal, window, scale,
      scale * kLog2e);
  return (int)cudaGetLastError();
}

using Launch = int (*)(const void*, const void*, const void*, const void*,
                       const void*, const float*, float*, void*, void*,
                       void*, int, int, int, int, int, const long long*, int,
                       int, cudaStream_t);

template <int HD>
Launch pick(bool bf16) {
  if (bf16) return launch_wgmma<HD>;
  return launch<float, HD>;
}

int run(bool bf16, const void* q, const void* k, const void* v,
        const void* o, const void* dout, const float* lse, float* delta,
        void* dq, void* dk, void* dv, int B, int H, int KVH, int Sq, int Skv,
        int hd, const long long* strides, int causal, int window,
        void* stream) {
  if (B < 1 || H < 1 || KVH < 1 || H % KVH || Sq < 1 || Skv < 1 ||
      window < 0)
    return (int)cudaErrorInvalidValue;
  const long long n_kt = (Skv + kTile - 1) / kTile;
  const long long n_qt = (Sq + kTile - 1) / kTile;
  if (n_kt * B * KVH > 0x7fffffffLL || n_qt * B * H > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
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

}  // namespace

// q, o, dout, dq: (B, H, Sq, hd); k, v, dk, dv: (B, KVH, Skv, hd), each
// addressed through strides[3 t .. 3 t + 2] = its (batch, head, sequence)
// strides in elements, t = q, k, v, o, dout, dq, dk, dv.  lse: the
// forward's (B, H, Sq) fp32; delta: (B, H, Sq) fp32 scratch.  The blocks
// of the dK/dV kernel (key tiles x B x KVH) and the dQ kernel (query tiles
// x B x H) must fit a 1-d grid.  flash_attention_bwd takes float32 tensors
// (the CUDA-core kernels), flash_attention_bwd_wgmma bfloat16 ones (the
// tensor-core kernels, which also need q, k, v and dout 16-byte aligned
// with strides that are multiples of 8 elements: the tensor maps' rule,
// checked by the wrapper).
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const float* lse,
                                   float* delta, void* dq, void* dk,
                                   void* dv, int B, int H, int KVH, int Sq,
                                   int Skv, int hd, const long long* strides,
                                   int causal, int window, void* stream) {
  return run(false, q, k, v, o, dout, lse, delta, dq, dk, dv, B, H, KVH, Sq,
             Skv, hd, strides, causal, window, stream);
}

extern "C" int flash_attention_bwd_wgmma(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int B, int H, int KVH, int Sq, int Skv, int hd,
    const long long* strides, int causal, int window, void* stream) {
  return run(true, q, k, v, o, dout, lse, delta, dq, dk, dv, B, H, KVH, Sq,
             Skv, hd, strides, causal, window, stream);
}
