// The backward of the Mamba2 (SSD) selective scan for Hopper (sm_90a).
// Built by repro_torch/kernels/build.py into a shared library with a plain
// C interface and bound with ctypes (repro_torch/kernels/mamba2_scan.py,
// mamba2_scan_bwd_cuda and the autograd Function Mamba2Scan).
//
// Replaces no Pallas kernel: the TPU kernel (src/repro/kernels/
// mamba2_scan.py:88) has no backward, and the JAX model trains through
// the VJP of its jnp stand-in ssd_chunked (src/repro/models/ssm.py:79).
// For the forward of csrc/mamba2_scan.cu, per batch row b and head h,
//   S_t = exp(dt_t A) S_{t-1} + B_t (dt_t x_t)^T,  y_t = C_t . S_t + D x_t,
// and the upstream gradient dy, it gives dx, ddt, dA, dB, dC and dD; the
// final state takes no gradient (training drops it).
//
// It walks each (b, h)'s chunks of L = 64 steps in reverse, carrying dS,
// the gradient on the state at the chunk's end (N x hd, fp32, 0 after the
// last chunk), and starts each chunk from S0, the state at its start, that
// the forward's training variant saved.  Within a chunk, with cum the
// inclusive prefix sum of dt A over the chunk, L[t][s] = exp(cum_t -
// cum_s) for s <= t (else 0), G'[t][s] = (C_t . B_s) L[t][s], w_s =
// exp(cum_L - cum_s) dt_s, the same quadratic (SSD) form as the forward:
//   dxdt_s = sum_t G'[t][s] dy_t + exp(cum_L - cum_s) dS^T B_s
//   dx_s   = D dy_s + dt_s dxdt_s,   ddt_s = x_s . dxdt_s + A da_s
//   dCB[t][s] = L[t][s] dt_s (dy_t . x_s)          (summed over heads)
//   dC_t = sum_s dCB[t][s] B_s + exp(cum_t) S0 dy_t
//   dB_s = sum_t dCB[t][s] C_t + w_s dS x_s
//   dS  <- exp(cum_L) dS + sum_t exp(cum_t) C_t dy_t^T
// and da_u, the gradient on a_u = dt_u A: the reverse prefix sum of the
// gradients on cum (+Q[t][s] to cum_t and -Q[t][s] to cum_s, Q = G' dt_s
// (dy_t . x_s); dy_t . y_inter_t, the inter-chunk output exp(cum_t) C_t
// S0; <dS, S0> exp(cum_L) and R_s = w_s B_s^T dS x_s to cum_L, -R_s to
// cum_s), summed as terms of one sign each, where the sums taken first
// would cancel:
//   da_u = sum_{t >= u > s} Q[t][s] + sum_{s < u} R_s + exp(cum_L) <dS, S0>
//          + sum_{t >= u} dy_t . y_inter_t
// ddt_u takes A da_u and dA takes sum_u dt_u da_u.  A ragged last chunk is
// zero-padded with dt = 0; cum_L is cum at the chunk's 64th step, equal to
// its last real step's.
//
// Overflow, as the forward: exp(cum_t - cum_s) is taken only where s <= t
// (at most 1) and 0 written elsewhere, never a 0/1 mask times an exponent;
// every other exponent here is of a number <= 0.  Built without
// --use_fast_math.
//
// B and C are shared by all heads, so dB, dC, dA and dD are sums over
// heads (and dA, dD over batch rows and time too).  No atomics: a block
// takes kHeads heads of one batch row, sums their dB and dC contributions
// (and the dCB that two of the products share) before it writes them, as
// per-block partials (2, G, B, S, N) fp32 with G = ceil(nh / kHeads), and
// its heads' dA and dD as (2, B, nh) partials; mamba2_scan_bwd_merge then
// sums the partials in a fixed order (G, then B), so two launches agree
// bit for bit.
//
// The first design, on the CUDA cores in fp32 for bf16 and fp32 inputs
// alike (x, B, C and dy are read and converted; dx, dB and dC rounded once
// to the inputs' type at the end): one block of 256 threads per kHeads = 2
// heads and batch row, every 64 x 64 product a 16 x 16 grid of threads
// with a 4 x 4 sub-tile each (rows ty + 16 i, columns tx + 16 j), as the
// forward's fp32 kernel.  Every tile lives in shared memory once, with a
// row stride of 65 floats, so that a warp's reads are conflict-free in
// either orientation (65 = 1 mod 32): B, C, C B^T and dCB for the chunk;
// x, dy, S0, G' and Q for the head at hand; and each head's dS carry;
// 11 tiles, 183 KB, so one block an SM.  Per chunk and head six 64-deep
// products (dy x^T, G'^T dy, B dS, dy S0^T, x dS^T, and the new dS), and
// per chunk three shared by the heads (C B^T, dCB B, dCB^T C).
//
// What bounds it: at the training path's top, x and dy (4, 4096, 112, 64)
// bf16, N 64, it must move about 1.2 GB (x, dy read, dx written, the saved
// states (4, 64, 112, 64, 64) fp32 read, dt, ddt, B, C, dB, dC) and do
// 9.06e10 operations in its products (six 64 x 64 x 64 products a head
// and chunk, three a chunk shared by all heads), so bytes bound it: 0.36
// ms at 3.35 TB/s, against 0.09 ms of products at the bf16 tensor-core
// peak.  This first design repeats the shared products in each block and
// runs every product on the CUDA cores, 1.68 ms at 67 TFLOP/s fp32 alone.
// mma.sync products, as the forward's, are a later design's.
//
// No allocation and no synchronisation here: the entry point launches on
// the caller's stream and returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kL = 64;         // steps per chunk, the forward's
constexpr int kP = 64;         // N and hd, padded
constexpr int kPad = kL + 1;   // row stride of every tile
constexpr int kTile = 16;      // threads per side of the 16 x 16 grid
constexpr int kThreads = kTile * kTile;
constexpr int kSub = kP / kTile;  // 4 x 4 outputs per thread
constexpr int kHeads = 2;      // heads a block, their dB and dC summed
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

static_assert(kL == kP, "the products share one 64 x 64 tiling");

// shared memory: tiles of kP rows x kPad floats, then vectors of kL floats
constexpr int kTileFloats = kP * kPad;
enum {
  kTB,    // B [s][n]
  kTC,    // C [t][n]
  kTCB,   // C B^T [t][s]
  kTDCB,  // dCB [t][s], summed over the block's heads
  kTX,    // x [s][p], the head at hand
  kTDY,   // dy [t][p]
  kTS0,   // S0 [p][n], the saved state at the chunk's start
  kTG,    // G' [t][s]
  kTQ,    // Q [t][s]
  kTDS,   // dS [n][p], one a head
};
constexpr int kTiles = kTDS + kHeads;
enum {
  kVCum,    // cum
  kVEcum,   // exp(cum_t)
  kVWl,     // exp(cum_L - cum_s)
  kVDt,     // dt
  kVDdt,    // x_s . dxdt_s
  kVDaq,    // sum_{t >= u > s} Q[t][s]
  kVInter,  // dy_t . y_inter_t
  kVR,      // R_s
  kVecs
};
constexpr int kOffVec = kTiles * kTileFloats;
constexpr int kOffRed = kOffVec + kVecs * kL;      // kWarps partial sums
constexpr int kSmemFloats = kOffRed + 2 * kWarps;
constexpr int kSmemBytes = kSmemFloats * (int)sizeof(float);

static_assert(kSmemBytes <= 227 * 1024, "one block must fit on an SM");

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// the sum over the 16 threads of a row of the grid (lanes tx = 0..15 of
// one half-warp), in a fixed order; every lane of the half gets it
__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(kFull, v, off);
  return v;
}

template <typename T>
struct BwdArgs {
  const T* x;
  long long x_sb, x_st, x_sh;
  const float* dt;
  long long dt_sb, dt_st, dt_sh;
  const float* A;
  const T* Bm;
  long long b_sb, b_st;
  const T* Cm;
  long long c_sb, c_st;
  const float* D;
  const T* dy;            // (B, S, nh, hd) contiguous
  const float* states;    // (B, nc, nh, hd, N) contiguous
  T* dx;                  // (B, S, nh, hd) contiguous
  float* ddt;             // (B, S, nh) contiguous
  float* part_bc;         // (2, G, B, S, N): dB, then dC partials
  float* part_ad;         // (2, B, nh): dA, then dD partials
  int Bsz, S, nh, hd, N;
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
mamba2_scan_bwd_kernel(const BwdArgs<T> p) {
  extern __shared__ float smem[];
  float* const tb = smem + kTB * kTileFloats;
  float* const tc = smem + kTC * kTileFloats;
  float* const tcb = smem + kTCB * kTileFloats;
  float* const tdcb = smem + kTDCB * kTileFloats;
  float* const tx_ = smem + kTX * kTileFloats;
  float* const tdy = smem + kTDY * kTileFloats;
  float* const ts0 = smem + kTS0 * kTileFloats;
  float* const tg = smem + kTG * kTileFloats;
  float* const tq = smem + kTQ * kTileFloats;
  float* const vec = smem + kOffVec;
  float* const red = smem + kOffRed;
  float* const v_cum = vec + kVCum * kL;
  float* const v_ecum = vec + kVEcum * kL;
  float* const v_wl = vec + kVWl * kL;
  float* const v_dt = vec + kVDt * kL;
  float* const v_ddt = vec + kVDdt * kL;
  float* const v_daq = vec + kVDaq * kL;
  float* const v_inter = vec + kVInter * kL;
  float* const v_r = vec + kVR * kL;

  const int tid = threadIdx.x;
  const int tx = tid % kTile, ty = tid / kTile;
  const int warp = tid >> 5, lane = tid & 31;
  const int grp = blockIdx.x, b = blockIdx.y;
  const int G = gridDim.x;
  const int S = p.S, nh = p.nh, hd = p.hd, N = p.N;
  const int nc = (S + kL - 1) / kL;

  for (int i = tid; i < kHeads * kTileFloats; i += kThreads)
    smem[kTDS * kTileFloats + i] = 0.f;
  // this thread's share of each head's dA (warp 0) and dD
  float dA_acc[kHeads], dD_acc[kHeads];
#pragma unroll
  for (int k = 0; k < kHeads; ++k) dA_acc[k] = dD_acc[k] = 0.f;

  for (int c = nc - 1; c >= 0; --c) {
    const int c0 = c * kL;
    const int len = min(kL, S - c0);
    __syncthreads();  // the previous chunk is done with every tile
    for (int i = tid; i < kL * kP; i += kThreads) {
      const int t = i / kP, n = i % kP;
      const bool in = t < len && n < N;
      const long long row = c0 + t;
      tb[t * kPad + n] = in ? to_f(p.Bm[b * p.b_sb + row * p.b_st + n]) : 0.f;
      tc[t * kPad + n] = in ? to_f(p.Cm[b * p.c_sb + row * p.c_st + n]) : 0.f;
    }
    __syncthreads();
    // C B^T [t][s]; read after the first head's loads' barrier
    {
      float acc[kSub][kSub] = {};
      for (int n = 0; n < N; ++n) {
        float cv[kSub], bv[kSub];
#pragma unroll
        for (int i = 0; i < kSub; ++i) {
          cv[i] = tc[(ty + kTile * i) * kPad + n];
          bv[i] = tb[(tx + kTile * i) * kPad + n];
        }
#pragma unroll
        for (int i = 0; i < kSub; ++i)
#pragma unroll
          for (int j = 0; j < kSub; ++j) acc[i][j] = fmaf(cv[i], bv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < kSub; ++i)
#pragma unroll
        for (int j = 0; j < kSub; ++j)
          tcb[(ty + kTile * i) * kPad + tx + kTile * j] = acc[i][j];
    }
    // the block's sums over its heads: dCB [t][s], dB [s][n], dC [t][n]
    float dcb[kSub][kSub] = {}, dbs[kSub][kSub] = {}, dcs[kSub][kSub] = {};

    for (int k = 0; k < kHeads; ++k) {
      const int h = grp * kHeads + k;
      if (h >= nh) break;  // the same for every thread of the block
      const float a_h = p.A[h], d_h = p.D[h];
      float* const tds = smem + (kTDS + k) * kTileFloats;

      // 1. the head's x, dy and S0, zero-padded; dt, its prefix sum and
      //    exponents (warp 0, steps 2 lane and 2 lane + 1)
      for (int i = tid; i < kL * kP; i += kThreads) {
        const int r = i / kP, col = i % kP;
        const bool in = r < len && col < hd;
        const long long row = c0 + r;
        tx_[r * kPad + col] =
            in ? to_f(p.x[b * p.x_sb + row * p.x_st + h * p.x_sh + col])
               : 0.f;
        tdy[r * kPad + col] =
            in ? to_f(p.dy[((b * (long long)S + row) * nh + h) * hd + col])
               : 0.f;
        ts0[r * kPad + col] =
            (r < hd && col < N)
                ? p.states[((((long long)b * nc + c) * nh + h) * hd + r) * N +
                           col]
                : 0.f;
      }
      if (warp == 0) {
        const int t0 = 2 * lane, t1 = t0 + 1;
        const float* dtb = p.dt + b * p.dt_sb + h * p.dt_sh;
        const float d0 = t0 < len ? dtb[(long long)(c0 + t0) * p.dt_st] : 0.f;
        const float d1 = t1 < len ? dtb[(long long)(c0 + t1) * p.dt_st] : 0.f;
        const float a0 = d0 * a_h, a1 = d1 * a_h;
        float run = a0 + a1;  // inclusive scan of the pair sums
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float up = __shfl_up_sync(kFull, run, off);
          if (lane >= off) run += up;
        }
        const float cum0 = run - a1, cum1 = run;
        const float last = __shfl_sync(kFull, cum1, 31);  // cum_L
        v_cum[t0] = cum0;
        v_cum[t1] = cum1;
        v_ecum[t0] = expf(cum0);
        v_ecum[t1] = expf(cum1);
        v_wl[t0] = expf(last - cum0);
        v_wl[t1] = expf(last - cum1);
        v_dt[t0] = d0;
        v_dt[t1] = d1;
      }
      __syncthreads();

      // 2. M = dy x^T; G' = C B^T L (0 above the diagonal, the exponent
      //    not taken there); Q = G' dt_s M; dCB += L dt_s M
      {
        float m[kSub][kSub] = {};
        for (int q = 0; q < hd; ++q) {
          float yv[kSub], xv[kSub];
#pragma unroll
          for (int i = 0; i < kSub; ++i) {
            yv[i] = tdy[(ty + kTile * i) * kPad + q];
            xv[i] = tx_[(tx + kTile * i) * kPad + q];
          }
#pragma unroll
          for (int i = 0; i < kSub; ++i)
#pragma unroll
            for (int j = 0; j < kSub; ++j) m[i][j] = fmaf(yv[i], xv[j], m[i][j]);
        }
#pragma unroll
        for (int i = 0; i < kSub; ++i) {
          const int t = ty + kTile * i;
          const float ct = v_cum[t];
#pragma unroll
          for (int j = 0; j < kSub; ++j) {
            const int s = tx + kTile * j;
            const float l = s <= t ? expf(ct - v_cum[s]) : 0.f;
            const float gp = tcb[t * kPad + s] * l;
            const float dm = v_dt[s] * m[i][j];
            tg[t * kPad + s] = gp;
            tq[t * kPad + s] = gp * dm;
            dcb[i][j] = fmaf(l, dm, dcb[i][j]);
          }
        }
      }
      __syncthreads();

      // 3. dxdt = G'^T dy + e^(cum_L - cum_s) B dS; dx; x . dxdt; dD
      {
        float acc[kSub][kSub] = {}, accb[kSub][kSub] = {};
        for (int t = 0; t < len; ++t) {
          float gv[kSub], yv[kSub];
#pragma unroll
          for (int i = 0; i < kSub; ++i) {
            gv[i] = tg[t * kPad + ty + kTile * i];
            yv[i] = tdy[t * kPad + tx + kTile * i];
          }
#pragma unroll
          for (int i = 0; i < kSub; ++i)
#pragma unroll
            for (int j = 0; j < kSub; ++j) acc[i][j] = fmaf(gv[i], yv[j], acc[i][j]);
        }
        for (int n = 0; n < N; ++n) {
          float bv[kSub], sv[kSub];
#pragma unroll
          for (int i = 0; i < kSub; ++i) {
            bv[i] = tb[(ty + kTile * i) * kPad + n];
            sv[i] = tds[n * kPad + tx + kTile * i];
          }
#pragma unroll
          for (int i = 0; i < kSub; ++i)
#pragma unroll
            for (int j = 0; j < kSub; ++j)
              accb[i][j] = fmaf(bv[i], sv[j], accb[i][j]);
        }
        T* dxb = p.dx + ((long long)b * S + c0) * nh * hd + (long long)h * hd;
        const long long dx_st = (long long)nh * hd;
#pragma unroll
        for (int i = 0; i < kSub; ++i) {
          const int s = ty + kTile * i;
          const float wl = v_wl[s], dts = v_dt[s];
          float part = 0.f;
#pragma unroll
          for (int j = 0; j < kSub; ++j) {
            const int q = tx + kTile * j;
            const float dxdt = fmaf(wl, accb[i][j], acc[i][j]);
            const float xv = tx_[s * kPad + q], yv = tdy[s * kPad + q];
            part = fmaf(xv, dxdt, part);
            dD_acc[k] = fmaf(yv, xv, dD_acc[k]);
            if (s < len && q < hd)
              dxb[s * dx_st + q] = from_f<T>(fmaf(d_h, yv, dts * dxdt));
          }
          part = row_sum16(part);
          if (tx == 0) v_ddt[s] = part;
        }
      }

      // 4. P = dy S0^T [t][n]: dC += e^cum_t P; dy_t . y_inter_t
      {
        float acc[kSub][kSub] = {};
        for (int q = 0; q < hd; ++q) {
          float yv[kSub], sv[kSub];
#pragma unroll
          for (int i = 0; i < kSub; ++i) {
            yv[i] = tdy[(ty + kTile * i) * kPad + q];
            sv[i] = ts0[q * kPad + tx + kTile * i];
          }
#pragma unroll
          for (int i = 0; i < kSub; ++i)
#pragma unroll
            for (int j = 0; j < kSub; ++j) acc[i][j] = fmaf(yv[i], sv[j], acc[i][j]);
        }
#pragma unroll
        for (int i = 0; i < kSub; ++i) {
          const int t = ty + kTile * i;
          const float e = v_ecum[t];
          float part = 0.f;
#pragma unroll
          for (int j = 0; j < kSub; ++j) {
            dcs[i][j] = fmaf(e, acc[i][j], dcs[i][j]);
            part = fmaf(tc[t * kPad + tx + kTile * j], acc[i][j], part);
          }
          part = row_sum16(part);
          if (tx == 0) v_inter[t] = e * part;
        }
      }

      // 5. P = x dS^T [s][n]: dB += w_s P; R_s = w_s B_s . P_s
      {
        float acc[kSub][kSub] = {};
        for (int q = 0; q < hd; ++q) {
          float xv[kSub], sv[kSub];
#pragma unroll
          for (int i = 0; i < kSub; ++i) {
            xv[i] = tx_[(ty + kTile * i) * kPad + q];
            sv[i] = tds[(tx + kTile * i) * kPad + q];
          }
#pragma unroll
          for (int i = 0; i < kSub; ++i)
#pragma unroll
            for (int j = 0; j < kSub; ++j) acc[i][j] = fmaf(xv[i], sv[j], acc[i][j]);
        }
#pragma unroll
        for (int i = 0; i < kSub; ++i) {
          const int s = ty + kTile * i;
          const float w = v_wl[s] * v_dt[s];
          float part = 0.f;
#pragma unroll
          for (int j = 0; j < kSub; ++j) {
            dbs[i][j] = fmaf(w, acc[i][j], dbs[i][j]);
            part = fmaf(tb[s * kPad + tx + kTile * j], acc[i][j], part);
          }
          part = row_sum16(part);
          if (tx == 0) v_r[s] = w * part;
        }
      }

      // 6. <dS, S0> (per-warp partials); each row of Q replaced by its
      //    exclusive prefix sum, sum_{s' < s} Q[t][s'] (threads 0-63)
      {
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < kSub; ++i)
#pragma unroll
          for (int j = 0; j < kSub; ++j) {
            const int n = ty + kTile * i, q = tx + kTile * j;
            part = fmaf(tds[n * kPad + q], ts0[q * kPad + n], part);
          }
        part = warp_sum(part);
        if (lane == 0) red[warp] = part;
        if (tid < kL) {
          float run = 0.f;
          for (int s = 0; s < kL; ++s) {
            const float q = tq[tid * kPad + s];
            tq[tid * kPad + s] = run;
            run += q;
          }
        }
      }
      __syncthreads();  // every read of dS is done

      // 7. dS <- e^cum_L dS + sum_t e^cum_t C_t dy_t^T, each thread its
      //    own 4 x 4 entries; then threads 64-127 sum the prefix sums of Q
      //    down the columns, sum_{t >= u} sum_{s < u} Q[t][s]
      {
        float acc[kSub][kSub] = {};
        for (int t = 0; t < len; ++t) {
          const float e = v_ecum[t];
          float cv[kSub], yv[kSub];
#pragma unroll
          for (int i = 0; i < kSub; ++i) {
            cv[i] = e * tc[t * kPad + ty + kTile * i];
            yv[i] = tdy[t * kPad + tx + kTile * i];
          }
#pragma unroll
          for (int i = 0; i < kSub; ++i)
#pragma unroll
            for (int j = 0; j < kSub; ++j) acc[i][j] = fmaf(cv[i], yv[j], acc[i][j]);
        }
        const float total = v_ecum[kL - 1];
#pragma unroll
        for (int i = 0; i < kSub; ++i)
#pragma unroll
          for (int j = 0; j < kSub; ++j) {
            float* e = &tds[(ty + kTile * i) * kPad + tx + kTile * j];
            *e = fmaf(total, *e, acc[i][j]);
          }
        if (tid >= kL && tid < 2 * kL) {
          const int u = tid - kL;
          float run = 0.f;
          for (int t = u; t < kL; ++t) run += tq[t * kPad + u];
          v_daq[u] = run;
        }
      }
      __syncthreads();

      // 8. da, ddt and dA (warp 0, steps 2 lane and 2 lane + 1): R's
      //    exclusive prefix sum and dy . y_inter's inclusive suffix sum by
      //    shuffles of the pair sums
      if (warp == 0) {
        float ss0 = 0.f;
        for (int w = 0; w < kWarps; ++w) ss0 += red[w];
        const int t0 = 2 * lane, t1 = t0 + 1;
        const float r0 = v_r[t0], r1 = v_r[t1];
        const float i0 = v_inter[t0], i1 = v_inter[t1];
        float rp = r0 + r1, is = i0 + i1;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float up = __shfl_up_sync(kFull, rp, off);
          const float dn = __shfl_down_sync(kFull, is, off);
          if (lane >= off) rp += up;
          if (lane + off < 32) is += dn;
        }
        const float base = v_ecum[kL - 1] * ss0;
        const float da0 = v_daq[t0] + (rp - r0 - r1) + base + is;
        const float da1 = v_daq[t1] + (rp - r1) + base + (is - i0);
        float* ddtb = p.ddt + ((long long)b * S + c0) * nh + h;
        if (t0 < len) ddtb[(long long)t0 * nh] = fmaf(a_h, da0, v_ddt[t0]);
        if (t1 < len) ddtb[(long long)t1 * nh] = fmaf(a_h, da1, v_ddt[t1]);
        dA_acc[k] = fmaf(v_dt[t0], da0, dA_acc[k]);
        dA_acc[k] = fmaf(v_dt[t1], da1, dA_acc[k]);
      }
      __syncthreads();  // the next head overwrites x, dy, S0, G', Q
    }

    // the heads' dCB: dC += dCB B, dB += dCB^T C; then the partials
#pragma unroll
    for (int i = 0; i < kSub; ++i)
#pragma unroll
      for (int j = 0; j < kSub; ++j)
        tdcb[(ty + kTile * i) * kPad + tx + kTile * j] = dcb[i][j];
    __syncthreads();
    for (int s = 0; s < len; ++s) {
      float dv[kSub], dw[kSub], bv[kSub], cv[kSub];
#pragma unroll
      for (int i = 0; i < kSub; ++i) {
        dv[i] = tdcb[(ty + kTile * i) * kPad + s];  // dCB[t][s], rows t
        dw[i] = tdcb[s * kPad + ty + kTile * i];    // dCB[s][t'], rows t'
        bv[i] = tb[s * kPad + tx + kTile * i];
        cv[i] = tc[s * kPad + tx + kTile * i];
      }
#pragma unroll
      for (int i = 0; i < kSub; ++i)
#pragma unroll
        for (int j = 0; j < kSub; ++j) {
          dcs[i][j] = fmaf(dv[i], bv[j], dcs[i][j]);
          dbs[i][j] = fmaf(dw[i], cv[j], dbs[i][j]);
        }
    }
    const long long plane = (long long)p.Bsz * S * N;
    float* pb = p.part_bc + (long long)grp * plane + ((long long)b * S + c0) * N;
    float* pc = pb + (long long)G * plane;
#pragma unroll
    for (int i = 0; i < kSub; ++i) {
      const int r = ty + kTile * i;
      if (r >= len) continue;
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        const int n = tx + kTile * j;
        if (n < N) {
          pb[(long long)r * N + n] = dbs[i][j];
          pc[(long long)r * N + n] = dcs[i][j];
        }
      }
    }
  }

  // the heads' dA and dD over the chunks: warp sums, then warp 0's in
  // order
#pragma unroll
  for (int k = 0; k < kHeads; ++k) {
    const int h = grp * kHeads + k;
    __syncthreads();
    const float a = warp_sum(dA_acc[k]), d = warp_sum(dD_acc[k]);
    if (lane == 0) {
      red[warp] = a;
      red[kWarps + warp] = d;
    }
    __syncthreads();
    if (tid == 0 && h < nh) {
      float sa = 0.f, sd = 0.f;
      for (int w = 0; w < kWarps; ++w) {
        sa += red[w];
        sd += red[kWarps + w];
      }
      p.part_ad[(long long)b * nh + h] = sa;
      p.part_ad[(long long)(p.Bsz + b) * nh + h] = sd;
    }
  }
}

// dB, dC (B, S, N) in T: the G partials summed in order; dA, dD (nh,)
// fp32: the B partials summed in order
template <typename T>
__global__ void __launch_bounds__(256)
mamba2_scan_bwd_merge(const float* __restrict__ part_bc,
                      const float* __restrict__ part_ad, T* __restrict__ dB,
                      T* __restrict__ dC, float* __restrict__ dA,
                      float* __restrict__ dD, int G, int Bsz, long long plane,
                      int nh) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < plane) {
    float sb = 0.f, sc = 0.f;
    for (int g = 0; g < G; ++g) {
      sb += part_bc[(long long)g * plane + i];
      sc += part_bc[(long long)(G + g) * plane + i];
    }
    dB[i] = from_f<T>(sb);
    dC[i] = from_f<T>(sc);
  }
  if (i < nh) {
    float sa = 0.f, sd = 0.f;
    for (int b = 0; b < Bsz; ++b) {
      sa += part_ad[(long long)b * nh + i];
      sd += part_ad[(long long)(Bsz + b) * nh + i];
    }
    dA[i] = sa;
    dD[i] = sd;
  }
}

template <typename T>
int launch(const void* x, const long long* x_strides, const float* dt,
           const long long* dt_strides, const float* A, const void* Bm,
           const long long* b_strides, const void* Cm,
           const long long* c_strides, const float* D, const void* dy,
           const float* states, void* dx, float* ddt, void* dB, void* dC,
           float* dA, float* dD, float* part_bc, float* part_ad, int B,
           int S, int nh, int hd, int N, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      mamba2_scan_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  BwdArgs<T> p;
  p.x = static_cast<const T*>(x);
  p.x_sb = x_strides[0];
  p.x_st = x_strides[1];
  p.x_sh = x_strides[2];
  p.dt = dt;
  p.dt_sb = dt_strides[0];
  p.dt_st = dt_strides[1];
  p.dt_sh = dt_strides[2];
  p.A = A;
  p.Bm = static_cast<const T*>(Bm);
  p.b_sb = b_strides[0];
  p.b_st = b_strides[1];
  p.Cm = static_cast<const T*>(Cm);
  p.c_sb = c_strides[0];
  p.c_st = c_strides[1];
  p.D = D;
  p.dy = static_cast<const T*>(dy);
  p.states = states;
  p.dx = static_cast<T*>(dx);
  p.ddt = ddt;
  p.part_bc = part_bc;
  p.part_ad = part_ad;
  p.Bsz = B;
  p.S = S;
  p.nh = nh;
  p.hd = hd;
  p.N = N;
  const int G = (nh + kHeads - 1) / kHeads;
  mamba2_scan_bwd_kernel<T>
      <<<dim3(G, B), kThreads, kSmemBytes, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long plane = (long long)B * S * N;
  const long long work = plane > nh ? plane : nh;
  mamba2_scan_bwd_merge<T><<<(unsigned)((work + 255) / 256), 256, 0, stream>>>(
      part_bc, part_ad, static_cast<T*>(dB), static_cast<T*>(dC), dA, dD, G,
      B, plane, nh);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 (1) or fp32 (0) x, Bm, Cm, dy, dx, dB, dC.  x: (B, S, nh, hd),
// strides x_strides = its (batch, time, head) strides in elements, the
// last dim contiguous; dt: (B, S, nh) fp32, dt_strides its three strides;
// A, D: (nh,) fp32; Bm, Cm: (B, S, N), strides (batch, time), the last dim
// contiguous; dy: (B, S, nh, hd) contiguous; states: the forward's saves,
// (B, ceil(S / 64), nh, hd, N) fp32 contiguous.  Writes dx (B, S, nh, hd)
// and ddt (B, S, nh) contiguous, dB and dC (B, S, N) contiguous, dA and dD
// (nh,); part_bc (2, ceil(nh / 2), B, S, N) and part_ad (2, B, nh) fp32 are
// the caller's scratch.  hd and N at most 64.  Two launches on the
// caller's stream (the kernel, then the merge); returns the cudaError_t.
extern "C" int mamba2_scan_bwd(int bf16, const void* x,
                               const long long* x_strides, const float* dt,
                               const long long* dt_strides, const float* A,
                               const void* Bm, const long long* b_strides,
                               const void* Cm, const long long* c_strides,
                               const float* D, const void* dy,
                               const float* states, void* dx, float* ddt,
                               void* dB, void* dC, float* dA, float* dD,
                               float* part_bc, float* part_ad, int B, int S,
                               int nh, int hd, int N, void* stream) {
  if (B < 1 || B > 65535 || S < 1 || nh < 1 || hd < 1 || hd > kP || N < 1 ||
      N > kP)
    return (int)cudaErrorInvalidValue;
  auto* st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(x, x_strides, dt, dt_strides, A, Bm,
                                      b_strides, Cm, c_strides, D, dy, states,
                                      dx, ddt, dB, dC, dA, dD, part_bc,
                                      part_ad, B, S, nh, hd, N, st)
              : launch<float>(x, x_strides, dt, dt_strides, A, Bm, b_strides,
                              Cm, c_strides, D, dy, states, dx, ddt, dB, dC,
                              dA, dD, part_bc, part_ad, B, S, nh, hd, N, st);
}
