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
// heads (and dA, dD over batch rows and time too).  No atomics: every sum
// runs in a fixed order, so two launches agree bit for bit.
//
// What bounds it: at the training path's top, x and dy (4, 4096, 112, 64)
// bf16, N 64, it must move about 1.2 GB (x, dy read, dx written, the saved
// states (4, 64, 112, 64, 64) fp32 read, dt, ddt, B, C, dB, dC) and do
// 9.06e10 operations in its products (six 64 x 64 x 64 products a head and
// chunk, three a chunk shared by all heads), so bytes bound it: 0.36 ms at
// 3.35 TB/s, against 0.09 ms of products at the bf16 tensor-core peak.
//
// Two routes, which the wrapper's plan_bwd picks from dtype and shape
// before any launch (it raises on what neither takes):
//
// * simt (fp32 inputs, the card-vs-CPU checks; bf16 when forced): the first
//   design, mamba2_scan_bwd_kernel<T> on the CUDA cores in fp32 (an mma on
//   fp32 data would be TF32), one block of 256 threads per kHeads = 2 heads
//   and batch row, every 64 x 64 product a 16 x 16 grid of threads with a
//   4 x 4 sub-tile each, every tile in shared memory with a row stride of
//   65 floats (11 tiles, 183 KB: one block an SM); the block sums its
//   heads' dB and dC (and their dCB, before dCB B and dCB^T C) into
//   partials (2, G, B, S, N), G = ceil(nh / 2), that mamba2_scan_bwd_merge
//   sums in order (G, then B).  Its clock profile (-DMAMBA2_BWD_PROFILE) at
//   Zamba2-7B's shapes: 154.6k SM clocks a chunk of two heads at B 4 and
//   B 1 alike, of which the heads' element-by-element loads of x, dy and
//   S0 behind a barrier took 0.37 and the products 0.56; 56 blocks at B 1
//   (76 of 132 SMs idle), two waves at B 4.
//
// * mma (bf16 inputs, the training path): three launches.
//   mamba2_bwd_cb forms C B^T once a batch row and chunk (products of bf16
//   values, exact in fp32), in the main kernel's fragment order.
//   mamba2_scan_bwd_mma_kernel takes one head and batch row a block of 8
//   warps (112 blocks at B 1, 448 at B 4) in clusters of up to kMmaCluster
//   = 8 heads (the largest power of two dividing nh), and runs every
//   product on the tensor cores with mma.sync m16n8k16 bf16 -> fp32, as
//   the forward does (each product is 64 x 64 x 64, too small for wgmma's
//   asynchrony to pay, and G'^T goes from M^T's accumulators to the next
//   product's A fragment in registers): x, dy, B and C are bf16 and go in
//   as one term; the fp32 operands (G'^T, dS, S0, e^cum C) are split into
//   kBwdTerms = 2 bf16 terms (one missed 1e-4 of max|ref| by 22x in the CPU
//   emulation, tests/test_torch_mamba2_bwd_split.py), each 16-deep k-step's
//   products summed, smallest term first, into a zeroed tile that is then
//   added in fp32 (the tensor cores truncate their running sums).  Warp w
//   takes rows 16 (w / 2) of B dS, M^T = x dy^T, G'^T dy and dx over its
//   half of hd (the pair forms M^T's causal tiles both, and each stores Q
//   and dCB for the tiles of its parity), n8 tile w of dy S0^T and x dS^T
//   (S0's fragments loaded straight into registers a chunk ahead, which
//   also give <dS, S0>; each tile's share of y_inter and R summed there),
//   and rows 16 (w / 2) of the dS update over its half of hd; then all
//   threads take Q's sums for da, four a row and a column, 16 values each
//   in registers; warp 7 forms da.  The heads' dCB, e^cum_t dy S0^T and
//   w_s x dS^T terms go to three fp32 slots in shared memory (43 KB);
//   after a cluster barrier each block sums its 1 / cluster share of the
//   slots over the cluster's blocks in rank order through DSMEM into one
//   partial set a cluster, batch row and chunk (154 MB at B 4, where the
//   simt route's partials are 470 MB), and a second cluster barrier frees
//   the slots.  x and dy of the next chunk arrive by cp.async into a
//   2-stage ring while a chunk computes, B and C once B and C are read,
//   C B^T's fragments a tile ahead from L2, dt a chunk ahead into the scan
//   warp's registers.  Tiles are bf16 with the forward's 16-byte XOR
//   swizzle, fp32 tiles XOR-swizzled in groups of 8 floats (fsw), so that
//   two blocks (115,488 bytes of shared memory, 128 registers each) fit an
//   SM.  Its clock profile at B 1: about 28k clocks a chunk (one head),
//   the causal tiles of row tile 0 (B dS, M^T, G'^T dy: 96 products of 8
//   warps' 128 a chunk) about 0.45 of warp 0's, the cluster's sums 0.17;
//   at B 4 the 448 blocks run in two rounds of 264 slots.
//   mamba2_bwd_epilogue, four blocks a batch row and chunk (one a 16-row
//   tile), sums the partial sets in order and forms dC += dCB B and dB +=
//   dCB^T C (dCB split into two terms) once a batch row and chunk; its
//   block (0, 0, 0) sums dA and dD over the batch rows.  Built with
//   -DMAMBA2_BWD_PROFILE, block (0, 0)'s thread 0 adds up the SM clocks of
//   each phase of its chunks (BWD_PHASES["mma"]).
//
// No allocation and no synchronisation here: the entry points launch on
// the caller's stream and return the first failure's cudaError_t; the
// wrapper hands in the scratch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mamba2_common.cuh"  // swizzled tiles, ldmatrix, mma, split

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
static_assert(kSmemBytes == 185152, "the wrapper's SIMT_SMEM");

#ifdef MAMBA2_BWD_PROFILE
// The diagnostic build (-DMAMBA2_BWD_PROFILE, a library of its own): thread
// 0 of block (0, 0) adds up the SM clocks of each phase of its chunks
// (mamba2_scan_bwd_simt_profile and mamba2_scan_bwd_mma_profile read and
// clear them).  A warp issues past a __syncthreads until an instruction
// that needs the barrier, and a clock read does not, so each read is
// predicated on a word loaded from shared memory, which waits for the
// release (the word is never the NaN pattern it is compared with): about
// an LDS's latency a phase, in this build only.
enum {
  kPhBC,        // the chunk's B and C loads
  kPhCB,        // C B^T
  kPhHead,      // a head's x, dy, S0 loads and dt's prefix sum
  kPhStep2,     // M, G', Q, dCB
  kPhStep3,     // dxdt, dx, x . dxdt
  kPhDbDc,      // dy S0^T and x dS^T: the heads' dC and dB terms, y_inter, R
  kPhDa,        // <dS, S0>, Q's prefix sums, da, ddt, dA
  kPhDs,        // the dS update and Q's column sums
  kPhShared,    // dCB B and dCB^T C over the block's heads
  kPhWrite,     // the dB and dC partials written
  kPhCount
};
__device__ long long g_simt_clocks[kPhCount];
#define PHASE(k)                                                          \
  if (prof_on) {                                                          \
    long long now;                                                        \
    const unsigned dep =                                                  \
        *reinterpret_cast<const volatile unsigned*>(prof_word);           \
    asm volatile("{ .reg .pred p; setp.ne.u32 p, %1, 0x7fc00001;"          \
                 " @p mov.u64 %0, %%clock64; @!p mov.u64 %0, 0; }"         \
                 : "=l"(now) : "r"(dep) : "memory");                      \
    prof[k] += now - prof_last;                                           \
    prof_last = now;                                                      \
  }
#else
#define PHASE(k)
#endif

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
#ifdef MAMBA2_BWD_PROFILE
  const void* prof_word = smem;
  const bool prof_on = tid == 0 && grp == 0 && b == 0;
  long long prof[kPhCount] = {};
  long long prof_last = clock64();
#endif

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
    PHASE(kPhBC);
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
    PHASE(kPhCB);
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
      PHASE(kPhHead);

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
      PHASE(kPhStep2);

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
      PHASE(kPhStep3);

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
      PHASE(kPhDbDc);

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
      PHASE(kPhDa);

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
      PHASE(kPhDs);

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
      PHASE(kPhDa);
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
    PHASE(kPhShared);
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
    PHASE(kPhWrite);
  }
#ifdef MAMBA2_BWD_PROFILE
  if (prof_on)
    for (int k = 0; k < kPhCount; ++k) g_simt_clocks[k] += prof[k];
#endif

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

// ---------------------------------------------------------------------------
// bf16: the mma route (mamba2_bwd_cb, mamba2_scan_bwd_mma_kernel,
// mamba2_bwd_epilogue)
// ---------------------------------------------------------------------------

constexpr int kMmaWarps = 8;
constexpr int kMmaThreads = 256;       // one head and batch row a block
constexpr int kMmaCluster = 8;         // heads a cluster at most
constexpr int kBwdTerms = 2;           // bf16 terms of an fp32 operand
constexpr int kTriTiles = 10;          // 16 x 16 tiles of a 64 x 64 with s <= t
constexpr int kTriFloats = kTriTiles * 256;
constexpr int kTile64 = kL * kP;       // floats of a 64 x 64 fp32 tile
constexpr int kSlotFloats = kTriFloats + 2 * kTile64;  // dCB, dC, dB
constexpr int kQStride = 17;           // row stride of Q's 16 x 16 tiles
constexpr int kBf16Tile = kL * kP * 2;  // bytes of a 64 x 64 bf16 tile
constexpr int kScalFloats = 4 * kL;    // cum log2 e, e^cum, e^(cum_L - cum),
                                       // dt
constexpr int kSideThreads = 128;      // the prologue's and epilogue's
constexpr float kLog2e = 1.4426950408889634f;

static_assert(kMmaThreads == 32 * kMmaWarps, "8 warps");
static_assert(kTriTiles * 16 * kQStride <= kTile64, "Q fits in the dB slot");

// shared memory of the main kernel, in bytes
constexpr int kOffRing = 0;                          // 2 stages of x, dy
constexpr int kOffBt = kOffRing + 4 * kBf16Tile;     // B [s][n]
constexpr int kOffCt = kOffBt + kBf16Tile;           // C [t][n]
constexpr int kOffDS = kOffCt + kBf16Tile;           // dS [n][p] fp32
constexpr int kOffSlot = kOffDS + kTile64 * 4;       // dCB, dC, dB fp32
constexpr int kOffScal = kOffSlot + kSlotFloats * 4; // 2 slots of scalars
constexpr int kOffSums = kOffScal + 2 * kScalFloats * 4;
// x . dxdt by p-half [2][64], da's Q sums [64], each n8 tile's share of R
// and of y_inter [8][64] each and of <dS, S0> [8]
constexpr int kRedFloats = 2 * kL + kL + 2 * kMmaWarps * kL + kMmaWarps;
constexpr int kMmaSmemBytes = kOffSums + kRedFloats * 4;
static_assert(kMmaSmemBytes == 115488, "the wrapper's BWD_MMA_SMEM");
static_assert(kMmaSmemBytes <= 113 * 1024,
              "two blocks must fit in an SM's 228 KB of shared memory");

#ifdef MAMBA2_BWD_PROFILE
enum {
  kMphWait,     // chunk's loads landed, the cluster's pull done, next issued
  kMphRows,     // B dS, C B^T's tiles -> G'^T, Q, dCB, G'^T dy, dx
  kMphP4,       // dy S0^T -> dC terms, <dS, S0>, next S0 issued
  kMphBar1,     // the block's barrier, Q's sums for da
  kMphP5,       // x dS^T -> dB terms; the dS update, into registers
  kMphBar2,     // the block's barrier
  kMphStore,    // dS stored, B and C of the next chunk issued
  kMphDa,       // the cluster's sums of its slots (and da in warp 7)
  kMphCount
};
__device__ long long g_mma_clocks[kMphCount];
#endif

// word offset of (r, c) in a 64 x 64 fp32 tile: its 8-float groups XOR-
// swizzled by (r ^ r / 2) % 4, so that a warp reading pairs along rows or
// along columns, or writing mma accumulators, hits distinct banks
__device__ __forceinline__ int fsw(int r, int c) {
  return r * 64 + (c ^ (((r ^ (r >> 1)) & 3) << 3));
}

// the packed index of 16 x 16 tile (i, j), i <= j, of a 64 x 64
__device__ __forceinline__ int tri(int i, int j) {
  return i * 4 - (i * (i - 1)) / 2 + (j - i);
}

__device__ __forceinline__ void commit_group() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// 16 bytes at `p` in the shared memory of the cluster's block `rank`
__device__ __forceinline__ float4 ld_dsmem4(const float* p, unsigned rank) {
  uint32_t remote;
  float4 v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_addr(p)), "r"(rank));
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(remote)
               : "memory");
  return v;
}

struct MmaArgs {
  const __nv_bfloat16* x;
  long long x_sb, x_st, x_sh;
  const float* dt;
  long long dt_sb, dt_st, dt_sh;
  const float* A;
  const __nv_bfloat16* Bm;
  long long b_sb, b_st;
  const __nv_bfloat16* Cm;
  long long c_sb, c_st;
  const float* D;
  const __nv_bfloat16* dy;  // (B, S, nh, hd) contiguous
  const float* states;      // (B, nc, nh, hd, N) contiguous
  __nv_bfloat16* dx;        // (B, S, nh, hd) contiguous
  float* ddt;               // (B, S, nh) contiguous
  __nv_bfloat16* dB;        // (B, S, N) contiguous
  __nv_bfloat16* dC;
  float* dA;                // (nh,)
  float* dD;
  float* cbt;               // (B, nc, kTriFloats): C B^T by fragment
  float* part;              // (B, nc, nh / cluster, kSlotFloats)
  float* part_ad;           // (2, B, nh): dA, then dD
  int Bsz, S, nh, hd, N, cluster;
};

// rows [c 64, c 64 + 64) of B (or C) into a swizzled bf16 tile, zero past S
// and N: 128 threads, a 16-byte chunk each of rows r and r + 32 at a time
__device__ __forceinline__ void load_bc_tile(uint32_t dst,
                                             const __nv_bfloat16* base,
                                             long long st, int c, int S,
                                             int N, int tid, int threads) {
  for (int idx = tid; idx < kL * 8; idx += threads) {
    const int r = idx >> 3, c8 = (idx & 7) * 8;
    const long long row = (long long)c * kL + r;
    const bool v = row < S && c8 < N;
    cp_async16(dst + swz(r, c8), base + (v ? row * st + c8 : 0), v);
  }
}

// C B^T, once a batch row and chunk: CBt[s][t] = B_s . C_t over the 10
// tiles with s <= t, written in the main kernel's fragment order (tile k,
// n8 half h, lane l: the m16n8 accumulator's 4 floats at ((k 2 + h) 32 +
// l) 4), so that its warps read them with one 16-byte load a half
__global__ void __launch_bounds__(kSideThreads)
mamba2_bwd_cb(const MmaArgs p) {
  __shared__ __align__(128) unsigned char sm[2 * kBf16Tile];
  const int c = blockIdx.x, b = blockIdx.y, nc = gridDim.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const uint32_t ba = smem_addr(sm), ca = ba + kBf16Tile;
  load_bc_tile(ba, p.Bm + b * p.b_sb, p.b_st, c, p.S, p.N, tid, kSideThreads);
  load_bc_tile(ca, p.Cm + b * p.c_sb, p.c_st, c, p.S, p.N, tid, kSideThreads);
  commit_group();
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  float4* out = reinterpret_cast<float4*>(
      p.cbt + ((long long)b * nc + c) * kTriFloats);
  for (int u = warp; u < 2 * kTriTiles; u += kSideThreads / 32) {
    const int k = u >> 1, hh = u & 1;
    const int i = (k >= 4) + (k >= 7) + (k >= 9);
    const int j = i + k - tri(i, i);
    float acc[4] = {};
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // N in k-steps of 16
      uint32_t a[4], bf[2];
      ldsm_x4(a, ba + swz(16 * i + (lane & 15), 16 * kk + 8 * (lane >> 4)));
      ldsm_x2(bf, ca + swz(16 * j + 8 * hh + (lane & 7),
                           16 * kk + 8 * ((lane >> 3) & 1)));
      mma(acc, a, bf[0], bf[1]);
    }
    out[u * 32 + lane] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  }
}

__global__ void __launch_bounds__(kMmaThreads, 2)
mamba2_scan_bwd_mma_kernel(const MmaArgs p) {
  extern __shared__ __align__(128) unsigned char sm[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;  // mma fragment coordinates
  const int h = blockIdx.x, b = blockIdx.y;
  const int S = p.S, nh = p.nh, hd = p.hd, N = p.N;
  const int nc = (S + kL - 1) / kL;
  const int CL = p.cluster;
  unsigned rank;  // in the cluster, 0 .. CL - 1
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(rank));
  const int grp = h / CL, G = nh / CL;
  const float a_h = p.A[h], d_h = p.D[h];
  // warp w: row tile i = w / 2 and p-half ph = w % 2 of B dS, G'^T dy and
  // dx (and of the dS update, whose rows are n); n8 tile w of dy S0^T and
  // x dS^T; warp 7 also loads dt and forms the next chunk's scalars
  const int i = warp >> 1, ph = warp & 1;
  const bool scan_warp = warp == kMmaWarps - 1;

  float* const dS = reinterpret_cast<float*>(sm + kOffDS);
  float* const slot = reinterpret_cast<float*>(sm + kOffSlot);
  float* const s_dcb = slot;                  // 10 tiles [s][t], stride 16
  float* const s_dc = slot + kTriFloats;      // [t][n], fsw
  float* const s_db = s_dc + kTile64;         // [s][n], fsw
  float* const s_q = s_db;                    // Q's 10 tiles, stride 17,
                                              // until dB is stored
  float* const red = reinterpret_cast<float*>(sm + kOffSums);
  float* const r_ddt = red;                   // [2][64]
  float* const r_daq = red + 2 * kL;
  float* const r_r = r_daq + kL;              // [8][64] by n8 tile
  float* const r_inter = r_r + kMmaWarps * kL;  // [8][64] by n8 tile
  float* const r_dsd = r_inter + kMmaWarps * kL;  // [8] by n8 tile
  const uint32_t sbase = smem_addr(sm);
  auto scal = [&](int c) {
    return reinterpret_cast<float*>(sm + kOffScal) + (c & 1) * kScalFloats;
  };
#ifdef MAMBA2_BWD_PROFILE
  const void* prof_word = sm + kOffSums;
  const bool prof_on = tid == 0 && h == 0 && b == 0;
  long long prof[kMphCount] = {};
  long long prof_last = clock64();
#endif

  for (int k = tid; k < kTile64; k += kMmaThreads) dS[k] = 0.f;

  // chunk c's x and dy into ring stage c % 2, zero past S and hd: the
  // thread's 16-byte chunk ld_c / 8 of rows ld_r and ld_r + 32
  const int ld_r = tid >> 3, ld_c = (tid & 7) * 8;
  auto issue_xdy = [&](int c) {
    const uint32_t dst = sbase + kOffRing + (c & 1) * 2 * kBf16Tile;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = ld_r + 32 * half;
      const long long row = (long long)c * kL + r;
      const bool v = row < S && ld_c < hd;
      cp_async16(dst + swz(r, ld_c),
                 p.x + b * p.x_sb + (v ? row * p.x_st + h * p.x_sh + ld_c : 0),
                 v);
      cp_async16(dst + kBf16Tile + swz(r, ld_c),
                 p.dy + (v ? ((b * (long long)S + row) * nh + h) * hd + ld_c
                           : 0),
                 v);
    }
  };
  auto issue_bc = [&](int c) {
    load_bc_tile(sbase + kOffBt, p.Bm + b * p.b_sb, p.b_st, c, S, N, tid,
                 kMmaThreads);
    load_bc_tile(sbase + kOffCt, p.Cm + b * p.c_sb, p.c_st, c, S, N, tid,
                 kMmaThreads);
  };
  // S0's B fragments (k = p, n = 8 nt + g) of n8 tile nt for chunk c:
  // s0f[kk] = S0[16 kk + 2 q + {0, 1, 8, 9}][n], 0 past hd and N
  auto load_s0 = [&](int c, int nt, float (&s0f)[4][4]) {
    const int n = 8 * nt + g;
    const float* base =
        p.states + (((long long)b * nc + c) * nh + h) * (long long)hd * N;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int pp = 16 * kk + 2 * q + (e & 1) + 8 * (e >> 1);
        s0f[kk][e] = (pp < hd && n < N)
                         ? ld_early(base + (long long)pp * N + n)
                         : 0.f;
      }
  };
  // the scan warp's dt of chunk c (steps 2 lane and 2 lane + 1, 0 past S)
  auto load_dt = [&](int c, float& d0, float& d1) {
    const long long t0 = (long long)c * kL + 2 * lane;
    const float* base = p.dt + b * p.dt_sb + h * p.dt_sh;
    d0 = t0 < S ? ld_early(base + t0 * p.dt_st) : 0.f;
    d1 = t0 + 1 < S ? ld_early(base + (t0 + 1) * p.dt_st) : 0.f;
  };
  // ... and its prefix sum and exponents into scalar slot c % 2
  auto scan = [&](int c, float d0, float d1) {
    float* sc = scal(c);
    const float a0 = d0 * a_h, a1 = d1 * a_h;
    float run = a0 + a1;  // inclusive scan of the pair sums
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float up = __shfl_up_sync(kFull, run, off);
      if (lane >= off) run += up;
    }
    const float cum0 = run - a1, cum1 = run;
    const float last = __shfl_sync(kFull, cum1, 31);  // cum_L
    const int t0 = 2 * lane;
    sc[t0] = cum0 * kLog2e;
    sc[t0 + 1] = cum1 * kLog2e;
    sc[kL + t0] = expf(cum0);
    sc[kL + t0 + 1] = expf(cum1);
    const float w0 = expf(last - cum0), w1 = expf(last - cum1);
    sc[2 * kL + t0] = w0;
    sc[2 * kL + t0 + 1] = w1;
    sc[3 * kL + t0] = d0;
    sc[3 * kL + t0 + 1] = d1;
  };

  float dn0 = 0.f, dn1 = 0.f;
  issue_xdy(nc - 1);
  issue_bc(nc - 1);
  commit_group();
  if (scan_warp) {
    load_dt(nc - 1, dn0, dn1);
    scan(nc - 1, dn0, dn1);
    if (nc > 1) load_dt(nc - 2, dn0, dn1);
  }
  float s0r[4][4];  // S0 of n8 tile w, a chunk ahead
  load_s0(nc - 1, warp, s0r);
  float dD_acc = 0.f, dA_acc = 0.f;
  cluster_arrive();  // nothing of a chunk past the last to pull

  for (int c = nc - 1; c >= 0; --c) {
    const int c0 = c * kL;
    const int len = min(kL, S - c0);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // chunk c's tiles and scalars are in; c + 1 is done
    cluster_wait();   // every block of the cluster has summed c + 1's slots
    if (c > 0) {
      issue_xdy(c - 1);
      commit_group();
      if (scan_warp) {
        scan(c - 1, dn0, dn1);
        if (c > 1) load_dt(c - 2, dn0, dn1);
      }
    }
    PHASE(kMphWait);
    const float* sc = scal(c);
    const unsigned char* xt = sm + kOffRing + (c & 1) * 2 * kBf16Tile;
    const unsigned char* yt = xt + kBf16Tile;
    const uint32_t xa = smem_addr(xt), ya = xa + kBf16Tile;
    const uint32_t ba = sbase + kOffBt, ca = sbase + kOffCt;

    // 1. rows 16 i .. of dxdt, the warp's p-half: e^(cum_L - cum_s) B dS,
    //    then G'^T dy over the causal tiles j >= i, G'^T formed from M^T =
    //    x dy^T and C B^T tile by tile; Q and dCB stored by the warp of the
    //    pair whose parity is j's
    // C B^T's fragments of tile (i, i) from L2, the next tile's fetched
    // while a tile is used
    const float4* cbt = reinterpret_cast<const float4*>(
        p.cbt + ((long long)b * nc + c) * kTriFloats);
    float4 cbn0 = cbt[(2 * tri(i, i)) * 32 + lane];
    float4 cbn1 = cbt[(2 * tri(i, i) + 1) * 32 + lane];
    float acc[4][4];  // rows 16 i + g (+8), columns 32 ph + 8 nn + 2 q (+1)
#pragma unroll
    for (int nn = 0; nn < 4; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nn][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // n in k-steps of 16
      uint32_t a[4];
      ldsm_x4(a, ba + swz(16 * i + (lane & 15), 16 * kk + 8 * (lane >> 4)));
#pragma unroll
      for (int nn = 0; nn < 4; ++nn) {
        const int pc = 32 * ph + 8 * nn + g, n0 = 16 * kk + 2 * q;
        uint32_t b0[kBwdTerms], b1[kBwdTerms];
        split(dS[fsw(n0, pc)], dS[fsw(n0 + 1, pc)], b0);
        split(dS[fsw(n0 + 8, pc)], dS[fsw(n0 + 9, pc)], b1);
        float t4[4] = {};
#pragma unroll
        for (int k2 = kBwdTerms - 1; k2 >= 0; --k2) mma(t4, a, b0[k2], b1[k2]);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nn][e] += t4[e];
      }
    }
    {
      const float w0 = sc[2 * kL + 16 * i + g], w1 = sc[2 * kL + 16 * i + g + 8];
#pragma unroll
      for (int nn = 0; nn < 4; ++nn) {
        acc[nn][0] *= w0;
        acc[nn][1] *= w0;
        acc[nn][2] *= w1;
        acc[nn][3] *= w1;
      }
    }
    for (int j = i; j < 4; ++j) {
      const int k = tri(i, j);
      const float4 cb0 = cbn0, cb1 = cbn1;
      if (j < 3) {
        cbn0 = cbt[(2 * k + 2) * 32 + lane];  // tile (i, j + 1) is k + 1
        cbn1 = cbt[(2 * k + 3) * 32 + lane];
      }
      float m[2][4] = {};  // M^T tile (i, j): rows s, columns t, two n8 halves
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {  // p in k-steps of 16
        uint32_t a[4], bf[4];
        ldsm_x4(a, xa + swz(16 * i + (lane & 15), 16 * kk + 8 * (lane >> 4)));
        ldsm_x4(bf, ya + swz(16 * j + (lane & 7) + 8 * (lane >> 4),
                             16 * kk + 8 * ((lane >> 3) & 1)));
        mma(m[0], a, bf[0], bf[1]);
        mma(m[1], a, bf[2], bf[3]);
      }
      const bool mine = ph == (j & 1);
      uint32_t gt[kBwdTerms][4];  // G'^T's A fragment (rows s, k = t)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float4 cb = hh ? cb1 : cb0;
        const float cbe[4] = {cb.x, cb.y, cb.z, cb.w};
        float gv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int sl = g + 8 * (e >> 1), tl = 8 * hh + 2 * q + (e & 1);
          const int s = 16 * i + sl, t = 16 * j + tl;
          const float l = s <= t ? exp2f(sc[t] - sc[s]) : 0.f;
          const float dm = sc[3 * kL + s] * m[hh][e];
          gv[e] = cbe[e] * l;
          if (mine) {
            s_q[k * 16 * kQStride + sl * kQStride + tl] = gv[e] * dm;
            s_dcb[k * 256 + sl * 16 + tl] = l * dm;
          }
        }
        uint32_t t0[kBwdTerms], t1[kBwdTerms];
        split(gv[0], gv[1], t0);
        split(gv[2], gv[3], t1);
#pragma unroll
        for (int k2 = 0; k2 < kBwdTerms; ++k2) {
          gt[k2][2 * hh] = t0[k2];
          gt[k2][2 * hh + 1] = t1[k2];
        }
      }
#pragma unroll
      for (int qq = 0; qq < 2; ++qq) {  // p columns 32 ph + 16 qq ..
        uint32_t bf[4];
        ldsm_x4_t(bf, ya + swz(16 * j + (lane & 7) + 8 * ((lane >> 3) & 1),
                               32 * ph + 16 * qq + 8 * (lane >> 4)));
#pragma unroll
        for (int n2 = 0; n2 < 2; ++n2) {
          float t4[4] = {};
#pragma unroll
          for (int k2 = kBwdTerms - 1; k2 >= 0; --k2)
            mma(t4, gt[k2], bf[2 * n2], bf[2 * n2 + 1]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[2 * qq + n2][e] += t4[e];
        }
      }
    }
    // dx = D dy + dt dxdt (rows < len); x . dxdt by p-half; dD
    {
      float part[2] = {0.f, 0.f};
      __nv_bfloat16* dxb =
          p.dx + ((long long)b * S + c0) * nh * hd + (long long)h * hd;
      const long long dx_st = (long long)nh * hd;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int s = 16 * i + g + 8 * r;
        const float dts = sc[3 * kL + s];
#pragma unroll
        for (int nn = 0; nn < 4; ++nn) {
          const int pc = 32 * ph + 8 * nn + 2 * q;
          const float2 xv =
              to_float2(*reinterpret_cast<const uint32_t*>(xt + swz(s, pc)));
          const float2 yv =
              to_float2(*reinterpret_cast<const uint32_t*>(yt + swz(s, pc)));
          const float v0 = acc[nn][2 * r], v1 = acc[nn][2 * r + 1];
          part[r] = fmaf(xv.x, v0, part[r]);
          part[r] = fmaf(xv.y, v1, part[r]);
          dD_acc = fmaf(yv.x, xv.x, dD_acc);
          dD_acc = fmaf(yv.y, xv.y, dD_acc);
          if (s < len && pc < hd)
            *reinterpret_cast<__nv_bfloat162*>(dxb + s * dx_st + pc) =
                __floats2bfloat162_rn(fmaf(d_h, yv.x, dts * v0),
                                      fmaf(d_h, yv.y, dts * v1));
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        part[r] += __shfl_xor_sync(kFull, part[r], 1);
        part[r] += __shfl_xor_sync(kFull, part[r], 2);
        if (q == 0) r_ddt[ph * kL + 16 * i + g + 8 * r] = part[r];
      }
    }
    PHASE(kMphRows);

    // 2. dy S0^T for n8 tile w (S0 split from the registers it came
    //    into a chunk ahead): dC's term e^cum_t (dy S0^T)[t][n] into its
    //    slot, the tile's share of y_inter_t = C_t . dC_t and of <dS, S0>
    //    over the same (p, n); then chunk c - 1's S0 issued
    {
      const int n = 8 * warp + g;
      float dsd = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float2 dv = *reinterpret_cast<const float2*>(
              &dS[fsw(n, 16 * kk + 2 * q + 8 * r)]);
          dsd = fmaf(dv.x, s0r[kk][2 * r], dsd);
          dsd = fmaf(dv.y, s0r[kk][2 * r + 1], dsd);
        }
      dsd = warp_sum(dsd);
      if (lane == 0) r_dsd[warp] = dsd;
      float a4[4][4];  // rows 16 mt + g (+8), columns 8 w + 2 q (+1)
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) a4[mt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {  // p in k-steps of 16
        uint32_t b0[kBwdTerms], b1[kBwdTerms];
        split(s0r[kk][0], s0r[kk][1], b0);
        split(s0r[kk][2], s0r[kk][3], b1);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          uint32_t a[4];
          ldsm_x4(a, ya + swz(16 * mt + (lane & 15), 16 * kk + 8 * (lane >> 4)));
          float t4[4] = {};
#pragma unroll
          for (int k2 = kBwdTerms - 1; k2 >= 0; --k2)
            mma(t4, a, b0[k2], b1[k2]);
#pragma unroll
          for (int e = 0; e < 4; ++e) a4[mt][e] += t4[e];
        }
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int t = 16 * mt + g + 8 * r;
          const float e = sc[kL + t];
          const float2 v = make_float2(e * a4[mt][2 * r], e * a4[mt][2 * r + 1]);
          *reinterpret_cast<float2*>(&s_dc[fsw(t, 8 * warp + 2 * q)]) = v;
          const float2 cv = to_float2(*reinterpret_cast<const uint32_t*>(
              sm + kOffCt + swz(t, 8 * warp + 2 * q)));
          float part = fmaf(cv.y, v.y, cv.x * v.x);
          part += __shfl_xor_sync(kFull, part, 1);
          part += __shfl_xor_sync(kFull, part, 2);
          if (q == 0) r_inter[warp * kL + t] = part;
        }
      if (c > 0) load_s0(c - 1, warp, s0r);
    }
    PHASE(kMphP4);
    __syncthreads();  // Q, dCB, dC stored; every warp's x . dxdt and <dS, S0>

    // 3. Q's sums for da, sum over s < u and t >= u of Q[s][t] (Q^T: rows
    //    s, columns t), four threads a row, then a column, a 16-wide
    //    segment each, its 16 values in registers: each row's suffix sums
    //    (the segment's own, then the later segments' totals added, in
    //    order) stored in place, then each column's sum over the rows
    //    above it.  Q is 0 where t < s; entries with t <= s hold what no
    //    column sum reads
    {
      const int r = tid >> 2, seg = tid & 3, base = lane & ~3;
      const bool live = seg >= (r >> 4);  // tile (r / 16, seg) is stored
      float* row = s_q + (live ? tri(r >> 4, seg) : 0) * 16 * kQStride +
                   (r & 15) * kQStride;
      float v[16];
#pragma unroll
      for (int t = 0; t < 16; ++t)
        v[t] = live && 16 * seg + t > r ? row[t] : 0.f;
      float run = 0.f;
#pragma unroll
      for (int t = 15; t >= 0; --t) {
        run += v[t];
        v[t] = run;
      }
      float later = 0.f;  // the later segments' totals, in order
#pragma unroll
      for (int k = 3; k > 0; --k) {
        const float tot = __shfl_sync(kFull, run, base + k);
        if (k > seg) later += tot;
      }
      if (live)
#pragma unroll
        for (int t = 0; t < 16; ++t) row[t] = v[t] + later;
    }
    __syncthreads();
    {
      const int u = tid >> 2, seg = tid & 3, base = lane & ~3;
      const bool live = seg <= (u >> 4);  // tile (seg, u / 16) is stored
      const float* col = s_q + (live ? tri(seg, u >> 4) : 0) * 16 * kQStride +
                         (u & 15);
      float run = 0.f;
#pragma unroll
      for (int sl = 0; sl < 16; ++sl)
        if (live && 16 * seg + sl < u) run += col[sl * kQStride];
      float total = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) total += __shfl_sync(kFull, run, base + k);
      if (seg == 0) r_daq[u] = total;
    }
    __syncthreads();  // Q is read: its slot takes dB's terms
    PHASE(kMphBar1);

    // 4. x dS^T for n8 tile w: dB's term w_s (x dS^T)[s][n] into its slot
    //    and the warp's share of R_s = B_s . dB_s over its 8 columns; the
    //    dS update for rows 16 i .., the warp's p-half: e^cum_L dS + sum_t
    //    e^cum_t C_t dy_t^T, into registers
    {
      uint32_t bd[4][2][kBwdTerms];  // dS's B fragments (k = p, n = 8 w + g)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float2 d = *reinterpret_cast<const float2*>(
              &dS[fsw(8 * warp + g, 16 * kk + 2 * q + 8 * r)]);
          split(d.x, d.y, bd[kk][r]);
        }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        float a5[4] = {};  // rows s = 16 mt + g (+8), columns 8 w + 2 q (+1)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {  // p in k-steps of 16
          uint32_t a[4];
          ldsm_x4(a, xa + swz(16 * mt + (lane & 15), 16 * kk + 8 * (lane >> 4)));
          float t4[4] = {};
#pragma unroll
          for (int k2 = kBwdTerms - 1; k2 >= 0; --k2)
            mma(t4, a, bd[kk][0][k2], bd[kk][1][k2]);
#pragma unroll
          for (int e = 0; e < 4; ++e) a5[e] += t4[e];
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int s = 16 * mt + g + 8 * r;
          const float w = sc[2 * kL + s] * sc[3 * kL + s];
          const float2 v = make_float2(w * a5[2 * r], w * a5[2 * r + 1]);
          *reinterpret_cast<float2*>(&s_db[fsw(s, 8 * warp + 2 * q)]) = v;
          const float2 bv = to_float2(*reinterpret_cast<const uint32_t*>(
              sm + kOffBt + swz(s, 8 * warp + 2 * q)));
          float part = fmaf(bv.y, v.y, bv.x * v.x);
          part += __shfl_xor_sync(kFull, part, 1);
          part += __shfl_xor_sync(kFull, part, 2);
          if (q == 0) r_r[warp * kL + s] = part;
        }
      }
    }
    float a6[4][4];  // dS rows n = 16 i + g (+8), columns 32 ph + 8 nn + 2 q
    {
      const float eL = sc[2 * kL - 1];  // e^cum_L
#pragma unroll
      for (int nn = 0; nn < 4; ++nn)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float2 v = *reinterpret_cast<const float2*>(
              &dS[fsw(16 * i + g + 8 * r, 32 * ph + 8 * nn + 2 * q)]);
          a6[nn][2 * r] = eL * v.x;
          a6[nn][2 * r + 1] = eL * v.y;
        }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // t in k-steps of 16
      // A = (e^cum C)^T: C^T's fragment by ldmatrix.trans, scaled by e^cum_t
      // (a0, a1 at steps 16 kk + 2 q (+1); a2, a3 eight steps on), split
      uint32_t a[4];
      ldsm_x4_t(a, ca + swz(16 * kk + (lane & 7) + 8 * (lane >> 4),
                            16 * i + 8 * ((lane >> 3) & 1)));
      const float* ec = sc + kL + 16 * kk + 2 * q;
      uint32_t at[kBwdTerms][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float2 v = to_float2(a[r]);
        const int o = r >= 2 ? 8 : 0;
        uint32_t tt[kBwdTerms];
        split(v.x * ec[o], v.y * ec[o + 1], tt);
#pragma unroll
        for (int k2 = 0; k2 < kBwdTerms; ++k2) at[k2][r] = tt[k2];
      }
#pragma unroll
      for (int qq = 0; qq < 2; ++qq) {
        uint32_t bf[4];
        ldsm_x4_t(bf, ya + swz(16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1),
                               32 * ph + 16 * qq + 8 * (lane >> 4)));
#pragma unroll
        for (int n2 = 0; n2 < 2; ++n2) {
          float t4[4] = {};
#pragma unroll
          for (int k2 = kBwdTerms - 1; k2 >= 0; --k2)
            mma(t4, at[k2], bf[2 * n2], bf[2 * n2 + 1]);
#pragma unroll
          for (int e = 0; e < 4; ++e) a6[2 * qq + n2][e] += t4[e];
        }
      }
    }
    PHASE(kMphP5);
    __syncthreads();  // no warp reads dS any more
    PHASE(kMphBar2);

    // the new dS
#pragma unroll
    for (int nn = 0; nn < 4; ++nn)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<float2*>(
            &dS[fsw(16 * i + g + 8 * r, 32 * ph + 8 * nn + 2 * q)]) =
            make_float2(a6[nn][2 * r], a6[nn][2 * r + 1]);
    __syncthreads();  // the block's dCB, dC and dB terms are in its slots
    cluster_arrive();
    if (c > 0) {  // no warp reads B or C any more
      issue_bc(c - 1);
      commit_group();
    }
    PHASE(kMphStore);

    // 6. da (warp 7, whose share of the cluster's sums below is the
    //    smaller; steps 2 lane and 2 lane + 1), as the simt route: R's
    //    exclusive prefix sum and y_inter's inclusive suffix sum by
    //    shuffles of the pair sums; ddt and dA
    if (warp == kMmaWarps - 1) {
      float ss0 = 0.f;
      for (int w = 0; w < kMmaWarps; ++w) ss0 += r_dsd[w];
      const int t0 = 2 * lane, t1 = t0 + 1;
      float r0 = 0.f, r1 = 0.f, i0 = 0.f, i1 = 0.f;  // the warps' shares
      for (int w = 0; w < kMmaWarps; ++w) {
        r0 += r_r[w * kL + t0];
        r1 += r_r[w * kL + t1];
        i0 += r_inter[w * kL + t0];
        i1 += r_inter[w * kL + t1];
      }
      float rp = r0 + r1, is = i0 + i1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(kFull, rp, off);
        const float dn = __shfl_down_sync(kFull, is, off);
        if (lane >= off) rp += up;
        if (lane + off < 32) is += dn;
      }
      const float base = sc[2 * kL - 1] * ss0;
      const float da0 = r_daq[t0] + (rp - r0 - r1) + base + is;
      const float da1 = r_daq[t1] + (rp - r1) + base + (is - i0);
      float* ddtb = p.ddt + ((long long)b * S + c0) * nh + h;
      if (t0 < len)
        ddtb[(long long)t0 * nh] = fmaf(a_h, da0, r_ddt[t0] + r_ddt[kL + t0]);
      if (t1 < len)
        ddtb[(long long)t1 * nh] = fmaf(a_h, da1, r_ddt[t1] + r_ddt[kL + t1]);
      dA_acc = fmaf(sc[3 * kL + t0], da0, dA_acc);
      dA_acc = fmaf(sc[3 * kL + t1], da1, dA_acc);
    }
    // the cluster's sum of its blocks' slots, in rank order: this block
    // takes its 1 / CL share of the slot's floats, into the partial set of
    // its cluster, batch row and chunk
    cluster_wait();
    {
      const int share = kSlotFloats / 4 / CL;  // float4s
      float4* dst = reinterpret_cast<float4*>(
          p.part + (((long long)b * nc + c) * G + grp) * kSlotFloats);
      for (int idx = (int)rank * share + tid; idx < ((int)rank + 1) * share;
           idx += kMmaThreads) {
        float4 acc4 = ld_dsmem4(slot + 4 * idx, 0);
        for (int r = 1; r < CL; ++r) {
          const float4 v = ld_dsmem4(slot + 4 * idx, (unsigned)r);
          acc4.x += v.x;
          acc4.y += v.y;
          acc4.z += v.z;
          acc4.w += v.w;
        }
        dst[idx] = acc4;
      }
    }
    cluster_arrive();
    PHASE(kMphDa);
  }
  cluster_wait();  // no block leaves while a peer may read its slots

  // the head's dA (warp 7) and dD over the chunks: warp sums, then in
  // warp order
  {
    const float a = warp_sum(dA_acc), d = warp_sum(dD_acc);
    if (lane == 0) {
      r_r[warp] = a;
      r_inter[warp] = d;
    }
    __syncthreads();
    if (tid == 0) {
      float sd = 0.f;
      for (int w = 0; w < kMmaWarps; ++w) sd += r_inter[w];
      p.part_ad[(long long)b * nh + h] = r_r[kMmaWarps - 1];
      p.part_ad[(long long)(p.Bsz + b) * nh + h] = sd;
    }
  }
#ifdef MAMBA2_BWD_PROFILE
  if (prof_on)
    for (int k = 0; k < kMphCount; ++k) g_mma_clocks[k] += prof[k];
#endif
}

// Rows 16 z .. of a batch row and chunk's dB and dC (z = blockIdx.z): the
// clusters' partial sets summed in order, then dC += dCB B and dB += dCB^T
// C on the tensor cores (dCB split into kBwdTerms bf16 terms, each k-step's
// products into a zeroed tile added in fp32), rounded once to bf16; warp w
// takes columns 16 w ..  Block (0, 0, 0) also sums dA and dD over the
// batch rows
__global__ void __launch_bounds__(kSideThreads)
mamba2_bwd_epilogue(const MmaArgs p) {
  __shared__ __align__(128) unsigned char sm[2 * kBf16Tile];
  __shared__ float dcbt[kTile64];  // dCB^T [s][t], fsw: row and column block z
  const int c = blockIdx.x, b = blockIdx.y, z = blockIdx.z, nc = gridDim.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int S = p.S, N = p.N, G = p.nh / p.cluster;
  const int c0 = c * kL, len = min(kL, S - c0);
  const uint32_t ba = smem_addr(sm), ca = ba + kBf16Tile;
  load_bc_tile(ba, p.Bm + b * p.b_sb, p.b_st, c, S, N, tid, kSideThreads);
  load_bc_tile(ca, p.Cm + b * p.c_sb, p.c_st, c, S, N, tid, kSideThreads);
  commit_group();
  const float* part = p.part + ((long long)b * nc + c) * G * kSlotFloats;
  // dCB's tiles (i, z), i <= z (dC's rows) and (z, j), j >= z (dB's rows)
  for (int idx = tid; idx < 4 * 256; idx += kSideThreads) {
    const int u = idx >> 8, e = idx & 255;
    const int ti = u <= z ? u : z, tj = u <= z ? z : u;
    const int off = tri(ti, tj) * 256 + e;
    float v = 0.f;
    for (int gi = 0; gi < G; ++gi) v += part[(long long)gi * kSlotFloats + off];
    dcbt[fsw(16 * ti + (e >> 4), 16 * tj + (e & 15))] = v;
  }
  // the partial sums of dC (rows t) and dB (rows s) at this warp's
  // accumulator positions: rows 16 z + g (+8), columns 16 w + 8 nn + 2 q
  float dc[2][4], db[2][4];
#pragma unroll
  for (int nn = 0; nn < 2; ++nn)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 16 * z + g + 8 * r, col = 16 * warp + 8 * nn + 2 * q;
      float2 sc_ = make_float2(0.f, 0.f), sb_ = make_float2(0.f, 0.f);
      for (int gi = 0; gi < G; ++gi) {
        const float* base = part + (long long)gi * kSlotFloats + kTriFloats;
        const float2 vc = *reinterpret_cast<const float2*>(base + fsw(row, col));
        const float2 vb =
            *reinterpret_cast<const float2*>(base + kTile64 + fsw(row, col));
        sc_.x += vc.x;
        sc_.y += vc.y;
        sb_.x += vb.x;
        sb_.y += vb.y;
      }
      dc[nn][2 * r] = sc_.x;
      dc[nn][2 * r + 1] = sc_.y;
      db[nn][2 * r] = sb_.x;
      db[nn][2 * r + 1] = sb_.y;
    }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  // dC[t][n] += sum_s dCB[t][s] B[s][n]: rows t of tile z, s over tiles
  // kk <= z (dCB is 0 above its diagonal); A = dCB, pairs along s, from
  // dCB^T's rows s and s + 1
  for (int kk = 0; kk <= z; ++kk) {
    uint32_t at[kBwdTerms][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int t = 16 * z + g + 8 * (r & 1);
      const int s = 16 * kk + 2 * q + 8 * (r >> 1);
      uint32_t tt[kBwdTerms];
      split(dcbt[fsw(s, t)], dcbt[fsw(s + 1, t)], tt);
#pragma unroll
      for (int k2 = 0; k2 < kBwdTerms; ++k2) at[k2][r] = tt[k2];
    }
    uint32_t bf[4];
    ldsm_x4_t(bf, ba + swz(16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1),
                           16 * warp + 8 * (lane >> 4)));
#pragma unroll
    for (int n2 = 0; n2 < 2; ++n2) {
      float t4[4] = {};
#pragma unroll
      for (int k2 = kBwdTerms - 1; k2 >= 0; --k2)
        mma(t4, at[k2], bf[2 * n2], bf[2 * n2 + 1]);
#pragma unroll
      for (int e = 0; e < 4; ++e) dc[n2][e] += t4[e];
    }
  }
  // dB[s][n] += sum_t dCB^T[s][t] C[t][n]: rows s of tile z, t over tiles
  // kk >= z; A = dCB^T, pairs along t
  for (int kk = z; kk < 4; ++kk) {
    uint32_t at[kBwdTerms][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int s = 16 * z + g + 8 * (r & 1);
      const int t = 16 * kk + 2 * q + 8 * (r >> 1);
      const float2 v = *reinterpret_cast<const float2*>(&dcbt[fsw(s, t)]);
      uint32_t tt[kBwdTerms];
      split(v.x, v.y, tt);
#pragma unroll
      for (int k2 = 0; k2 < kBwdTerms; ++k2) at[k2][r] = tt[k2];
    }
    uint32_t bf[4];
    ldsm_x4_t(bf, ca + swz(16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1),
                           16 * warp + 8 * (lane >> 4)));
#pragma unroll
    for (int n2 = 0; n2 < 2; ++n2) {
      float t4[4] = {};
#pragma unroll
      for (int k2 = kBwdTerms - 1; k2 >= 0; --k2)
        mma(t4, at[k2], bf[2 * n2], bf[2 * n2 + 1]);
#pragma unroll
      for (int e = 0; e < 4; ++e) db[n2][e] += t4[e];
    }
  }
  // rows < len, columns < N, rounded once to bf16
#pragma unroll
  for (int nn = 0; nn < 2; ++nn)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 16 * z + g + 8 * r, col = 16 * warp + 8 * nn + 2 * q;
      if (row < len && col < N) {
        const long long o = ((long long)b * S + c0 + row) * N + col;
        *reinterpret_cast<__nv_bfloat162*>(p.dC + o) =
            __floats2bfloat162_rn(dc[nn][2 * r], dc[nn][2 * r + 1]);
        *reinterpret_cast<__nv_bfloat162*>(p.dB + o) =
            __floats2bfloat162_rn(db[nn][2 * r], db[nn][2 * r + 1]);
      }
    }
  if (c == 0 && b == 0 && z == 0)
    for (int hh = tid; hh < p.nh; hh += kSideThreads) {
      float sa = 0.f, sd = 0.f;
      for (int bb = 0; bb < p.Bsz; ++bb) {
        sa += p.part_ad[(long long)bb * p.nh + hh];
        sd += p.part_ad[(long long)(p.Bsz + bb) * p.nh + hh];
      }
      p.dA[hh] = sa;
      p.dD[hh] = sd;
    }
}

cudaError_t set_mma_smem() {
  return cudaFuncSetAttribute(mamba2_scan_bwd_mma_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kMmaSmemBytes);
}

cudaLaunchConfig_t mma_config(int nh, int B, int cluster, cudaStream_t st,
                              cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nh, B);
  cfg.blockDim = dim3(kMmaThreads);
  cfg.dynamicSmemBytes = kMmaSmemBytes;
  cfg.stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

#ifdef MAMBA2_BWD_PROFILE
// The first design's clocks of each phase (kPhCount, in the enum's order),
// summed over the chunks of block (0, 0)'s thread 0 since the last read,
// then cleared.
extern "C" int mamba2_scan_bwd_simt_profile(long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_simt_clocks,
                                         sizeof(g_simt_clocks));
  if (err != cudaSuccess) return (int)err;
  static const long long zeros[kPhCount] = {};
  return (int)cudaMemcpyToSymbol(g_simt_clocks, zeros, sizeof(zeros));
}
#endif

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


// bf16 x, Bm, Cm, dy, dx, dB, dC: the mma route, as mamba2_scan_bwd with
// x, Bm and Cm rows 16-byte aligned (the wrapper's mma_layout_problem()
// checks this), hd and N multiples of 8 up to 64, nh a multiple of cluster
// (1, 2, 4 or 8); scratch: (B, ceil(S / 64), kTriFloats) for C B^T, then
// (B, ceil(S / 64), nh / cluster, kSlotFloats) for the clusters' partial
// sets, fp32; part_ad (2, B, nh) fp32.  Three launches on the caller's
// stream (the prologue, the main kernel in clusters, the epilogue);
// returns the first failure's cudaError_t.
extern "C" int mamba2_scan_bwd_mma(
    const void* x, const long long* x_strides, const float* dt,
    const long long* dt_strides, const float* A, const void* Bm,
    const long long* b_strides, const void* Cm, const long long* c_strides,
    const float* D, const void* dy, const float* states, void* dx,
    float* ddt, void* dB, void* dC, float* dA, float* dD, float* scratch,
    float* part_ad, int B, int S, int nh, int hd, int N, int cluster,
    void* stream) {
  if (B < 1 || B > 65535 || S < 1 || nh < 1 || hd < 8 || hd > kP ||
      hd % 8 || N < 8 || N > kP || N % 8 || cluster < 1 ||
      cluster > kMmaCluster || (cluster & (cluster - 1)) || nh % cluster)
    return (int)cudaErrorInvalidValue;
  const int nc = (S + kL - 1) / kL;
  MmaArgs p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.x_sb = x_strides[0];
  p.x_st = x_strides[1];
  p.x_sh = x_strides[2];
  p.dt = dt;
  p.dt_sb = dt_strides[0];
  p.dt_st = dt_strides[1];
  p.dt_sh = dt_strides[2];
  p.A = A;
  p.Bm = static_cast<const __nv_bfloat16*>(Bm);
  p.b_sb = b_strides[0];
  p.b_st = b_strides[1];
  p.Cm = static_cast<const __nv_bfloat16*>(Cm);
  p.c_sb = c_strides[0];
  p.c_st = c_strides[1];
  p.D = D;
  p.dy = static_cast<const __nv_bfloat16*>(dy);
  p.states = states;
  p.dx = static_cast<__nv_bfloat16*>(dx);
  p.ddt = ddt;
  p.dB = static_cast<__nv_bfloat16*>(dB);
  p.dC = static_cast<__nv_bfloat16*>(dC);
  p.dA = dA;
  p.dD = dD;
  p.cbt = scratch;
  p.part = scratch + (long long)B * nc * kTriFloats;
  p.part_ad = part_ad;
  p.Bsz = B;
  p.S = S;
  p.nh = nh;
  p.hd = hd;
  p.N = N;
  p.cluster = cluster;
  auto* st = static_cast<cudaStream_t>(stream);
  mamba2_bwd_cb<<<dim3(nc, B), kSideThreads, 0, st>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = set_mma_smem();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = mma_config(nh, B, cluster, st, &attr);
  err = cudaLaunchKernelEx(&cfg, mamba2_scan_bwd_mma_kernel, p);
  if (err != cudaSuccess) return (int)err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mamba2_bwd_epilogue<<<dim3(nc, B, 4), kSideThreads, 0, st>>>(p);
  return (int)cudaGetLastError();
}

// The mma route's main kernel: its blocks resident on one SM, and its
// clusters of `cluster` blocks resident on the card at once, as the
// occupancy calculator gives them; returns the cudaError_t.
extern "C" int mamba2_scan_bwd_mma_occupancy(int cluster, int* blocks,
                                             int* clusters) {
  cudaError_t err = set_mma_smem();
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, mamba2_scan_bwd_mma_kernel, kMmaThreads, kMmaSmemBytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = mma_config(kMmaCluster * 14, 1, cluster,
                                            nullptr, &attr);
  return (int)cudaOccupancyMaxActiveClusters(
      clusters, mamba2_scan_bwd_mma_kernel, &cfg);
}

#ifdef MAMBA2_BWD_PROFILE
// The mma route's clocks of each phase (kMphCount, in the enum's order),
// summed over the chunks of block (0, 0)'s thread 0 since the last read,
// then cleared.
extern "C" int mamba2_scan_bwd_mma_profile(long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_mma_clocks,
                                         sizeof(g_mma_clocks));
  if (err != cudaSuccess) return (int)err;
  static const long long zeros[kMphCount] = {};
  return (int)cudaMemcpyToSymbol(g_mma_clocks, zeros, sizeof(zeros));
}
#endif
