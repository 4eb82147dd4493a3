// The Mamba2 (SSD) selective scan for Hopper (sm_90a).  Built by
// repro_torch/kernels/build.py into a shared library with a plain C
// interface and bound with ctypes (repro_torch/kernels/mamba2_scan.py).
//
// Replaces the TPU kernel in src/repro/kernels/mamba2_scan.py (mamba2_scan,
// its pl.pallas_call at :88 -> _mamba2_kernel at :26), and computes what it
// computes, per batch row b and head h, from a zero state:
//   S_t = exp(dt_t A) S_{t-1} + B_t (dt_t x_t)^T      (S: N x hd)
//   y_t = C_t . S_t + D x_t
// with one (B, C) group shared by all heads.  Where the TPU kernel returns
// y only, this one also writes the final state S_S, as (hd, N) per (b, h),
// the layout of the model's decode cache: the model's prefill hands it on
// to decode, so no second pass over the prompt computes it.
//
// Both kernels walk the sequence in chunks of L = 64 steps (the model's
// chunk of 256 does not fit: its (c, c) tiles alone would be 256 KB in
// fp32, and an SM has 227 KB of shared memory; the function does not depend
// on the chunk).  For each chunk, with cum = the inclusive prefix sum of
// dt A over the chunk:
//   G[t][s] = (C_t . B_s) exp(cum_t - cum_s) dt_s    for s <= t, else 0
//   y_t     = sum_s G[t][s] x_s + exp(cum_t) C_t . S + D x_t
//   S      <- exp(cum_L) S + sum_s B_s exp(cum_L - cum_s) dt_s x_s^T
// A ragged last chunk is zero-padded in time (dt = 0 there, so cum stays
// flat and the padded steps add nothing to the state); rows past the end
// are not written.  N and hd up to 64 are zero-padded to 64.
//
// Overflow: cum falls by |dt A| a step, so exp(cum_t - cum_s) for s > t can
// pass fp32's range (at random init about 0.3-1.3 a step; 64 steps of 1.5
// give exp(96) = inf, and inf * 0 is NaN).  Both kernels compute that
// exponent only where s <= t, where it is at most 1, and write 0 elsewhere;
// neither multiplies by a 0/1 mask.  Every other exponent they take is of a
// number <= 0.  Built without --use_fast_math.
//
// What bounds it: at Zamba2-7B's prefill shape, x (4, 2048, 112, 64) bf16,
// N 64, the function must move about 0.25 GB (x read, y written, dt, B, C,
// the final state) and do 4 hd N operations a step per (b, h) in the
// inter-chunk products, 1.5e10 in all, so bytes bound it: about 0.074 ms
// at 3.35 TB/s.
//
// Two kernels, picked by x's dtype:
//
// * bf16 (the serving prefills): mamba2_scan_kernel_mma, the chunk products
//   on the tensor cores with mma.sync m16n8k16 bf16 -> fp32.  mma.sync and
//   not wgmma: each product here is 64 x 64 x 64, too small for wgmma's
//   asynchrony to pay, and G, the state's terms and x w are formed in
//   registers between products; mma.sync's fragments let them go from one
//   product's accumulator to the next product's operand without shared
//   memory, where wgmma wants its B operand there.  Exact where the inputs
//   allow it: x, B and C are bf16, and a product of two bf16 values is
//   exact in fp32, so C B^T is one product summed in fp32.  Each of the
//   other three pairs a bf16 operand with an fp32 one, which is split into
//   kTerms = 2 bf16 terms, v = hi + lo with hi = bf16(v) and lo = bf16(v -
//   hi), |v - hi - lo| <= 2^-16 |v|, and each term is one more product into
//   the same fp32 accumulator: G x splits G; C S splits S; the state update
//   splits x w (sum_s x_s w_s B_s^T, the same products as the TPU kernel's
//   (B w)^T x, but a warp's share of x w is its own 16 columns of x, where
//   every warp would need all of B w).  One term fails the phase-3
//   tolerance (about 2e-3 of max|state|), two pass it with a margin of ten
//   (about 4e-6), three are not needed.  cum, the exponents and D x stay
//   fp32 on the CUDA cores; cum is kept in base 2 (cum log2 e), so that
//   each exponent is one exp2f.
//
//   Layout: one block of 8 warps takes kHeads = 2 heads of one batch row,
//   so the two share the chunk's B and C tiles and C B^T; 4 warps per head,
//   warp q owning the head's hd columns 16 q .. 16 q + 15.  The state
//   lives in registers all along, as S^T (hd rows, N columns) in mma
//   accumulator fragments: a warp's 16 x 64 slice is exactly the B operand
//   of C S for its own columns, and the state update accumulates into it.
//   Per chunk a warp: forms its 3 or 2 of the 20 n8 halves of the 10
//   lower-triangle 16 x 16 tiles of C B^T (the 6 tiles above the diagonal
//   are skipped; halves, not tiles, so that no warp takes two tiles while
//   most take one), turns each into both heads' G and stores G's terms to
//   shared memory; computes e^cum_t C S into its y accumulators; loads its
//   x fragments once (ldmatrix.trans; they are the A operand of the
//   update, scaled by w, and the B operand of G x); updates its state;
//   waits on the block for G; adds G x over the causal tiles only (10 of
//   16); adds D x; and stages y in bf16 where it read its x, so that the
//   head's 128 threads store the chunk's y rows with 16-byte stores.  About
//   180 mma a warp a chunk.
//
//   Loads that overlap the math: chunk c + 1's x (both heads), B and C go
//   into a 2-stage ring in shared memory by cp.async (16 bytes a thread, a
//   row of 64 bf16 is 128 B) while chunk c computes, the thread's rows and
//   tiles fixed at compile time; dt, a strided column, is loaded one chunk
//   ahead into registers by one warp per head (warps 4 and 5, which take 2
//   halves of C B^T), which also does that chunk's prefix sum and
//   exponents (cum, exp(cum_t), w_s = exp(cum_L - cum_s) dt_s) before the
//   block waits for G.  Tiles are stored with a 16-byte-chunk XOR swizzle,
//   so ldmatrix and the fragment-sized stores hit 32 distinct banks.
//   cp.async needs x, B and C rows 16-byte aligned: base addresses and the
//   batch, time and head strides multiples of 16 bytes, and hd and N
//   multiples of 8; the wrapper's mma_layout_problem() refuses anything
//   else and raises.  The model's views fit: x's time stride is 7296 x 2 =
//   14,592 B, B starts at 14,336 B and C at 14,464 B.
//
//   Resident: 100 KB of shared memory and at most 128 registers a thread
//   (__launch_bounds__(256, 2)), so 2 blocks, 4 heads, fit on an SM: the
//   serve shape's 224 blocks run in one wave on 132 SMs.  Built with
//   -DMAMBA2_PROFILE, each warp of block (0, 0) sums the SM clocks of each
//   phase of its chunks (mamba2_scan_mma_profile reads them; ptxas may move
//   a clock read across a barrier, so a wait shows in the phase next to
//   it).
//
// * fp32 (the card-vs-CPU checks): mamba2_scan_kernel, on the CUDA cores
//   (an mma on fp32 data would be TF32).  One block of 256 threads per
//   (head, batch row), the (N, hd) state in shared memory across chunks;
//   each of the four products is a 64 x 64 output tile with a 64-deep sum,
//   each thread owning a 4 x 4 sub-tile at rows ty + 16 i and columns tx +
//   16 j.  B and C are held transposed, [n][t] with a row stride of L + 1,
//   so that every shared-memory read of a warp is a broadcast or hits
//   distinct banks.  The prefix sum is one warp's shuffle scan, two steps a
//   lane.
//
// Training variant: handed a chunk_states pointer (else null), either
// kernel also writes the state at the start of every chunk, (B, ceil(S /
// 64), nh, hd, N) fp32 contiguous (zeros for the first chunk), where the
// backward (csrc/mamba2_scan_bwd.cu) starts each chunk from.  It is the
// same compiled kernel as the serving one with one more store a chunk,
// taken from the state it already holds (the bf16 kernel's S^T fragments
// in registers, the fp32 kernel's S in shared memory), so y and the final
// state are the serving variant's bit for bit.  At the training path's B 4
// and S 4096 the saves are 470 MB a launch.
//
// Strides: x is addressed as (B, S, nh, hd) and B, C as (B, S, N) through
// their batch, time (and head) strides, the last dim contiguous, so the
// model's slices of its (B, S, d_in + 2N) conv output go in with no copy;
// dt (B, S, nh) through its three strides.  y is written contiguous (B, S,
// nh, hd) in x's type, the final state contiguous (B, nh, hd, N) in fp32.
//
// No allocation and no synchronisation here: the entry points launch on
// the caller's stream and return cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mamba2_common.cuh"  // swizzled tiles, ldmatrix, mma, split

namespace {

constexpr int kL = 64;         // steps per chunk
constexpr int kP = 64;         // N and hd, padded
constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------------------
// fp32: mamba2_scan_kernel, on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kPad = kL + 1;   // row stride of the transposed B, C and of G
constexpr int kTile = 16;      // threads per side of the 16 x 16 grid
constexpr int kThreads = kTile * kTile;
constexpr int kSub = kP / kTile;  // 4 x 4 outputs per thread

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

__global__ void __launch_bounds__(kThreads)
mamba2_scan_kernel(const float* __restrict__ x, long long x_sb,
                   long long x_st, long long x_sh,
                   const float* __restrict__ dt, long long dt_sb,
                   long long dt_st, long long dt_sh,
                   const float* __restrict__ A, const float* __restrict__ Bm,
                   long long b_sb, long long b_st,
                   const float* __restrict__ Cm, long long c_sb,
                   long long c_st, const float* __restrict__ D,
                   float* __restrict__ y, float* __restrict__ state_out,
                   float* __restrict__ chunk_states, int S, int nh, int hd,
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

  const float* xb = x + b * x_sb + head * x_sh;
  const float* dtb = dt + b * dt_sb + head * dt_sh;
  const float* bb = Bm + b * b_sb;
  const float* cb = Cm + b * c_sb;
  float* yb = y + ((long long)b * S * nh + head) * hd;
  const long long y_st = (long long)nh * hd;

  for (int c0 = 0; c0 < S; c0 += kL) {
    const int len = min(kL, S - c0);

    // 0. the training variant: the state at the chunk's start, (hd, N) for
    //    this (b, head), zeros for the first chunk (S is zeroed but not yet
    //    synchronised there); the last iteration's final barrier ordered
    //    every other chunk's S
    if (chunk_states) {
      float* cs = chunk_states +
                  (((long long)b * ((S + kL - 1) / kL) + c0 / kL) * nh +
                   head) * hd * N;
      for (int i = tid; i < hd * N; i += kThreads)
        cs[i] = c0 == 0 ? 0.f : st[(i % N) * kP + i / N];
    }

    // 1. the chunk's B^T, C^T and x, zero-padded; dt and its prefix sum
    for (int i = tid; i < kL * kP; i += kThreads) {
      const int t = i / kP, n = i % kP;
      const bool in = t < len;
      const long long row = (long long)(c0 + t);
      bt[n * kPad + t] = (in && n < N) ? bb[row * b_st + n] : 0.f;
      ct[n * kPad + t] = (in && n < N) ? cb[row * c_st + n] : 0.f;
      xs[t * kP + n] = (in && n < hd) ? xb[row * x_st + n] : 0.f;
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
            yb[(long long)(c0 + t) * y_st + p] =
                acc[i][j] + decay * inter[i][j] + d_h * xs[t * kP + p];
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

// ---------------------------------------------------------------------------
// bf16: mamba2_scan_kernel_mma, on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kHeads = 2;              // heads a block, sharing B, C, C B^T
constexpr int kWarpsPerHead = 4;       // each owns 16 of the 64 hd columns
constexpr int kMmaThreads = kHeads * kWarpsPerHead * 32;
constexpr int kTerms = 2;              // bf16 terms of an fp32 operand
constexpr int kTileBytes = kL * kP * 2;          // a 64 x 64 bf16 tile
constexpr int kStageBytes = (kHeads + 2) * kTileBytes;  // x per head, B, C
constexpr int kOffGBytes = 2 * kStageBytes;       // after the 2-stage ring
constexpr int kGBytes = kHeads * kTerms * kTileBytes;
constexpr int kOffScalBytes = kOffGBytes + kGBytes;
// per slot (2) and head: cum, dt, exp(cum_t), w_s, kL floats each
constexpr int kScalFloats = 4 * kL;
constexpr int kMmaSmemBytes =
    kOffScalBytes + 2 * kHeads * kScalFloats * (int)sizeof(float);
constexpr int kLowerTiles = 10;        // 16 x 16 tiles of C B^T with s <= t
constexpr float kLog2e = 1.4426950408889634f;

static_assert(kMmaSmemBytes <= 113 * 1024,
              "two blocks must fit in an SM's 228 KB of shared memory");

#ifdef MAMBA2_PROFILE
// the phases of a chunk, in order; each warp of block (0, 0) adds its SM
// clocks to its own row here (mamba2_scan_mma_profile reads and clears
// them)
enum {
  kPhWait,     // wait for the chunk's loads (and the block) + issue next
  kPhCbG,      // C B^T tiles -> G for both heads, G stored
  kPhCs,       // e^cum C S
  kPhUpdate,   // x fragments, the state update
  kPhScan,     // dt's prefix sum and exponents for the next chunk
  kPhWaitG,    // wait for the block's G
  kPhGx,       // G x
  kPhStore,    // D x, y staged, the head's barrier, the 16-byte stores
  kPhCount
};
__device__ unsigned long long g_profile[kHeads * kWarpsPerHead][kPhCount];
#define PROF_MARK(ph)                                      \
  do {                                                     \
    const long long now_ = clock64();                      \
    prof[ph] += (unsigned long long)(now_ - prof_t);       \
    prof_t = now_;                                         \
  } while (0)
#else
#define PROF_MARK(ph) \
  do {                \
  } while (0)
#endif

// named barrier 1 + h over head h's 128 threads (0 is __syncthreads')
__device__ __forceinline__ void head_barrier(int head_local) {
  static_assert(kHeads == 2, "one named barrier per head");
  if (head_local == 0)
    asm volatile("bar.sync 1, %0;\n" ::"n"(kWarpsPerHead * 32) : "memory");
  else
    asm volatile("bar.sync 2, %0;\n" ::"n"(kWarpsPerHead * 32) : "memory");
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
  __nv_bfloat16* y;
  float* state_out;
  float* chunk_states;  // the training variant's saves, or null
  int S, nh, hd, N;
};

__global__ void __launch_bounds__(kMmaThreads, 2)
mamba2_scan_kernel_mma(const MmaArgs p) {
  extern __shared__ __align__(128) unsigned char msmem[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int hl = warp / kWarpsPerHead;          // head within the block
  const int col0 = (warp % kWarpsPerHead) * 16;  // the warp's hd columns
  const int b = blockIdx.y;
  const int head = blockIdx.x * kHeads + hl;
  const bool live = head < p.nh;
  const int nc = (p.S + kL - 1) / kL;
  // warps kWarpsPerHead + h (2 C B^T halves each, where warps 0-3 take 3)
  // load and scan head h's dt
  static_assert(kHeads <= kWarpsPerHead, "a scan warp per head");
  const int scan_h = warp - kWarpsPerHead;
  const bool scan_warp = scan_h >= 0 && scan_h < kHeads;
  const int s_head = blockIdx.x * kHeads + scan_h;
  const bool s_live = scan_warp && s_head < p.nh;
  const float s_a = s_live ? p.A[s_head] : 0.f;
  const float d_h = live ? p.D[head] : 0.f;
  const int g_row = lane >> 2, g_col = 2 * (lane & 3);  // fragment coords
  const int lm_i = lane & 7, lm_q = lane >> 3;          // ldmatrix coords

  float* scal = reinterpret_cast<float*>(msmem + kOffScalBytes);
  auto scal_of = [&](int slot, int h) {
    return scal + (slot * kHeads + h) * kScalFloats;
  };  // cum log2 e [0, kL), dt [kL, 2 kL), exp(cum) [2 kL, 3 kL),
     // w [3 kL, 4 kL)

  // chunk c's x (both heads), B and C into stage c % 2, zero-filled past S,
  // past hd or N, and for a head past nh: the thread copies 16-byte chunk
  // ld_c / 8 of rows ld_r and ld_r + 32 of each tile
  const int ld_r = tid >> 3, ld_c = (tid & 7) * 8;
  const uint32_t ld_dst = smem_addr(msmem) + swz(ld_r, ld_c);
  auto issue_loads = [&](int c) {
    const uint32_t dst = ld_dst + (c & 1) * kStageBytes;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = c * kL + ld_r + 32 * half;
      const bool in = row < p.S;
#pragma unroll
      for (int t = 0; t < kHeads; ++t) {
        const int h = blockIdx.x * kHeads + t;
        const bool v = in && h < p.nh && ld_c < p.hd;
        cp_async16(dst + t * kTileBytes + half * 32 * 128,
                   p.x + b * p.x_sb +
                       (v ? row * p.x_st + h * p.x_sh + ld_c : 0),
                   v);
      }
      const bool vn = in && ld_c < p.N;
      cp_async16(dst + kHeads * kTileBytes + half * 32 * 128,
                 p.Bm + b * p.b_sb + (vn ? row * p.b_st + ld_c : 0), vn);
      cp_async16(dst + (kHeads + 1) * kTileBytes + half * 32 * 128,
                 p.Cm + b * p.c_sb + (vn ? row * p.c_st + ld_c : 0), vn);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  // the scan warp's dt of chunk c: steps 2 lane and 2 lane + 1, 0 past S
  auto load_dt = [&](int c, float& d0, float& d1) {
    const int t0 = c * kL + 2 * lane;
    const float* base = p.dt + b * p.dt_sb + (s_live ? s_head * p.dt_sh : 0);
    d0 = (s_live && t0 < p.S) ? ld_early(base + (long long)t0 * p.dt_st)
                              : 0.f;
    d1 = (s_live && t0 + 1 < p.S)
             ? ld_early(base + (long long)(t0 + 1) * p.dt_st)
             : 0.f;
  };
  // ... and its prefix sum and exponents into slot c % 2
  auto scan = [&](int c, float d0, float d1) {
    float* sc = scal_of(c & 1, scan_h);
    const float a0 = d0 * s_a, a1 = d1 * s_a;
    float run = a0 + a1;  // inclusive scan of the pair sums
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float up = __shfl_up_sync(kFull, run, off);
      if (lane >= off) run += up;
    }
    // cum in base 2 (cum log2 e), so that each exponent is one exp2f
    const float cum0 = (run - a1) * kLog2e, cum1 = run * kLog2e;
    const float last = __shfl_sync(kFull, cum1, 31);  // cum_{L-1}
    const int t0 = 2 * lane;
    sc[t0] = cum0;
    sc[t0 + 1] = cum1;
    sc[kL + t0] = d0;
    sc[kL + t0 + 1] = d1;
    sc[2 * kL + t0] = exp2f(cum0);
    sc[2 * kL + t0 + 1] = exp2f(cum1);
    sc[3 * kL + t0] = exp2f(last - cum0) * d0;
    sc[3 * kL + t0 + 1] = exp2f(last - cum1) * d1;
  };

  // S^T, the warp's 16 hd rows x 64 N columns: st[q] is the m16n8
  // accumulator of N columns 8 q .. 8 q + 7
  float st[8][4];
#pragma unroll
  for (int q = 0; q < 8; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) st[q][e] = 0.f;

#ifdef MAMBA2_PROFILE
  unsigned long long prof[kPhCount] = {};
  long long prof_t = clock64();
#endif

  issue_loads(0);
  float dn0 = 0.f, dn1 = 0.f;
  if (scan_warp) {
    load_dt(0, dn0, dn1);
    scan(0, dn0, dn1);
  }

  for (int c = 0; c < nc; ++c) {
    const int c0 = c * kL;
    const int len = min(kL, p.S - c0);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // chunk c's tiles and scan are in; chunk c - 1 is done
    if (c + 1 < nc) {
      issue_loads(c + 1);
      if (scan_warp) load_dt(c + 1, dn0, dn1);
    }
    PROF_MARK(kPhWait);

    // the training variant: the state at the chunk's start, from the S^T
    // fragments, in the layout of the final state below
    if (p.chunk_states && live) {
      float* cs = p.chunk_states +
                  (((long long)b * nc + c) * p.nh + head) * p.hd * p.N;
#pragma unroll
      for (int q = 0; q < 8; ++q)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = col0 + g_row + 8 * half, n = 8 * q + g_col;
          if (r < p.hd && n < p.N)
            *reinterpret_cast<float2*>(cs + (long long)r * p.N + n) =
                make_float2(st[q][2 * half], st[q][2 * half + 1]);
        }
    }

    unsigned char* stage = msmem + (c & 1) * kStageBytes;
    unsigned char* xt = stage + hl * kTileBytes;
    const unsigned char* bt = stage + kHeads * kTileBytes;
    const unsigned char* ct = bt + kTileBytes;
    const uint32_t xa = smem_addr(xt), ba = smem_addr(bt),
                   ca = smem_addr(ct);
    const float* sc = scal_of(c & 1, hl);

    // C B^T on the 20 n8 halves of the 10 lower-triangle 16 x 16 tiles,
    // halves w, w + 8 and w + 16 for warp w (3 or 2 a warp, where whole
    // tiles would give warps 0 and 1 two each while the others wait), then
    // G for both heads
    for (int u = warp; u < 2 * kLowerTiles; u += kHeads * kWarpsPerHead) {
      const int k = u >> 1, nt = u & 1;
      const int ti = (k >= 1) + (k >= 3) + (k >= 6);
      const int si = k - ti * (ti + 1) / 2;
      float acc[4] = {};
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // N in k-steps of 16
        uint32_t a[4], bf[2];
        ldsm_x4(a, ca + swz(16 * ti + (lane & 15), 16 * j + 8 * (lane >> 4)));
        ldsm_x2(bf, ba + swz(16 * si + 8 * nt + lm_i,
                             16 * j + 8 * (lm_q & 1)));
        mma(acc, a, bf[0], bf[1]);
      }
#pragma unroll
      for (int h = 0; h < kHeads; ++h) {
        const float* hs = scal_of(c & 1, h);
        unsigned char* gt = msmem + kOffGBytes + h * kTerms * kTileBytes;
        const int s = 16 * si + 8 * nt + g_col;
        const float cs0 = hs[s], cs1 = hs[s + 1];
        const float ds0 = hs[kL + s], ds1 = hs[kL + s + 1];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int t = 16 * ti + g_row + 8 * half;
          const float ct_ = hs[t];
          const float g0 =
              s <= t ? acc[2 * half] * exp2f(ct_ - cs0) * ds0 : 0.f;
          const float g1 =
              s + 1 <= t ? acc[2 * half + 1] * exp2f(ct_ - cs1) * ds1 : 0.f;
          uint32_t terms[kTerms];
          split(g0, g1, terms);
#pragma unroll
          for (int k2 = 0; k2 < kTerms; ++k2)
            *reinterpret_cast<uint32_t*>(gt + k2 * kTileBytes + swz(t, s)) =
                terms[k2];
        }
      }
    }
    PROF_MARK(kPhCbG);

    // y = e^cum_t (C S) over all 64 rows and the warp's 16 columns: y[i][n]
    // is the m16n8 accumulator of rows 16 i .., columns col0 + 8 n ..
    float yacc[4][2][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) yacc[i][n][e] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // N in k-steps of 16
      // S's B operand for N rows 16 j ..: S^T[c][n] pairs from st[2 j]
      // (rows n .. n + 7) and st[2 j + 1] (n + 8 ..), column tile 0 from
      // accumulator rows g_row, tile 1 from g_row + 8
      uint32_t s0[2][kTerms], s1[2][kTerms];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        split(st[2 * j][2 * n], st[2 * j][2 * n + 1], s0[n]);
        split(st[2 * j + 1][2 * n], st[2 * j + 1][2 * n + 1], s1[n]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint32_t a[4];
        ldsm_x4(a, ca + swz(16 * i + (lane & 15), 16 * j + 8 * (lane >> 4)));
#pragma unroll
        for (int k2 = 0; k2 < kTerms; ++k2)
#pragma unroll
          for (int n = 0; n < 2; ++n)
            mma(yacc[i][n], a, s0[n][k2], s1[n][k2]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float e0 = sc[2 * kL + 16 * i + g_row];
      const float e1 = sc[2 * kL + 16 * i + g_row + 8];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        yacc[i][n][0] *= e0;
        yacc[i][n][1] *= e0;
        yacc[i][n][2] *= e1;
        yacc[i][n][3] *= e1;
      }
    }
    PROF_MARK(kPhCs);

    // x fragments for the warp's columns, k-step j (steps 16 j ..):
    // {x[s][c], x[s + 8][c], x[s][c + 8], x[s + 8][c + 8]} (8 x 8 each),
    // the B operand of G x for column tiles 0 and 1 as (xf[0], xf[1]) and
    // (xf[2], xf[3]), and the A operand of x^T as (xf[0], xf[2], xf[1],
    // xf[3])
    uint32_t xf[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      ldsm_x4_t(xf[j], xa + swz(16 * j + lm_i + 8 * (lm_q & 1),
                                col0 + 8 * (lm_q >> 1)));

    // S^T <- e^cum_L S^T + (x w)^T B: A = x^T w (the warp's 16 columns x
    // 64 steps), split; B = B (steps x N) by ldmatrix.trans
    {
      const float total = sc[2 * kL + kL - 1];
#pragma unroll
      for (int q = 0; q < 8; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[q][e] *= total;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* w = sc + 3 * kL + 16 * j + g_col;
        const float w0 = w[0], w1 = w[1], w8 = w[8], w9 = w[9];
        // A fragment registers: (rows c, steps s), (c + 8, s), (c, s + 8),
        // (c + 8, s + 8) = xf[j][0], [2], [1], [3]
        uint32_t ax[4][kTerms];
        const int src[4] = {0, 2, 1, 3};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float2 v = to_float2(xf[j][src[r]]);
          const bool hi_steps = r >= 2;
          split(v.x * (hi_steps ? w8 : w0), v.y * (hi_steps ? w9 : w1),
                ax[r]);
        }
#pragma unroll
        for (int qq = 0; qq < 4; ++qq) {  // N columns 16 qq ..
          uint32_t bf[4];
          ldsm_x4_t(bf, ba + swz(16 * j + lm_i + 8 * (lm_q & 1),
                                 16 * qq + 8 * (lm_q >> 1)));
#pragma unroll
          for (int k2 = 0; k2 < kTerms; ++k2) {
            const uint32_t a[4] = {ax[0][k2], ax[1][k2], ax[2][k2],
                                   ax[3][k2]};
            mma(st[2 * qq], a, bf[0], bf[1]);
            mma(st[2 * qq + 1], a, bf[2], bf[3]);
          }
        }
      }
    }
    PROF_MARK(kPhUpdate);

    // chunk c + 1's prefix sum, into the slot chunk c - 1 used
    if (scan_warp && c + 1 < nc) scan(c + 1, dn0, dn1);
    PROF_MARK(kPhScan);

    __syncthreads();  // both heads' G are stored
    PROF_MARK(kPhWaitG);

    // y += G x over the causal tiles: row tile i takes step tiles j <= i
    {
      const uint32_t ga = smem_addr(msmem + kOffGBytes +
                                    hl * kTerms * kTileBytes);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j <= i; ++j)
#pragma unroll
          for (int k2 = 0; k2 < kTerms; ++k2) {
            uint32_t a[4];
            ldsm_x4(a, ga + k2 * kTileBytes +
                           swz(16 * i + (lane & 15), 16 * j + 8 * (lane >> 4)));
            mma(yacc[i][0], a, xf[j][0], xf[j][1]);
            mma(yacc[i][1], a, xf[j][2], xf[j][3]);
          }
    }
    PROF_MARK(kPhGx);

    // y += D x; stage y in bf16 where the warp read its x, then the head's
    // threads store the chunk's rows < len, 16 bytes a thread
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int t = 16 * i + g_row + 8 * half;
          uint32_t* cell = reinterpret_cast<uint32_t*>(
              xt + swz(t, col0 + 8 * n + g_col));
          const float2 xv = to_float2(*cell);
          *cell = as_u32(__floats2bfloat162_rn(
              fmaf(d_h, xv.x, yacc[i][n][2 * half]),
              fmaf(d_h, xv.y, yacc[i][n][2 * half + 1])));
        }
    head_barrier(hl);
    if (live) {
      const int ht = tid % (kWarpsPerHead * 32);
      __nv_bfloat16* yb =
          p.y + ((long long)b * p.S + c0) * p.nh * p.hd +
          (long long)head * p.hd;
      const long long y_st = (long long)p.nh * p.hd;
      for (int idx = ht; idx < len * 8; idx += kWarpsPerHead * 32) {
        const int r = idx >> 3, c8 = idx & 7;
        if (c8 * 8 < p.hd)
          *reinterpret_cast<uint4*>(yb + r * y_st + c8 * 8) =
              *reinterpret_cast<const uint4*>(xt + swz(r, c8 * 8));
      }
    }
    PROF_MARK(kPhStore);

  }

  // the final state in the cache's layout: (hd, N) for this (b, head)
  if (live) {
    float* so = p.state_out + ((long long)b * p.nh + head) * p.hd * p.N;
#pragma unroll
    for (int q = 0; q < 8; ++q)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = col0 + g_row + 8 * half, n = 8 * q + g_col;
        if (r < p.hd && n < p.N)
          *reinterpret_cast<float2*>(so + (long long)r * p.N + n) =
              make_float2(st[q][2 * half], st[q][2 * half + 1]);
      }
  }

#ifdef MAMBA2_PROFILE
  if (blockIdx.x == 0 && blockIdx.y == 0 && lane == 0)
    for (int ph = 0; ph < kPhCount; ++ph) g_profile[warp][ph] += prof[ph];
#endif
}

cudaError_t set_mma_smem() {
  return cudaFuncSetAttribute(mamba2_scan_kernel_mma,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kMmaSmemBytes);
}

}  // namespace

// fp32.  x: (B, S, nh, hd), strides x_strides = its (batch, time, head)
// strides in elements, the last dim contiguous; dt: (B, S, nh) fp32,
// dt_strides its three strides; A, D: (nh,) fp32 contiguous; Bm, Cm: (B,
// S, N), strides (batch, time), the last dim contiguous; x, Bm, Cm and y
// fp32; y: (B, S, nh, hd) contiguous; state: (B, nh, hd, N) fp32
// contiguous; chunk_states: null, or (B, ceil(S / 64), nh, hd, N) fp32
// contiguous for the training variant.  hd and N at most 64.  Returns the
// launch's cudaError_t.
extern "C" int mamba2_scan_fwd(const float* x, const long long* x_strides,
                               const float* dt, const long long* dt_strides,
                               const float* A, const float* Bm,
                               const long long* b_strides, const float* Cm,
                               const long long* c_strides, const float* D,
                               float* y, float* state, float* chunk_states,
                               int B, int S, int nh, int hd, int N,
                               void* stream) {
  if (B < 1 || B > 65535 || S < 1 || nh < 1 || hd < 1 || hd > kP || N < 1 ||
      N > kP)
    return (int)cudaErrorInvalidValue;
  constexpr int bytes = kSmemFloats * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      mamba2_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(nh, B);
  mamba2_scan_kernel<<<grid, kThreads, bytes,
                       static_cast<cudaStream_t>(stream)>>>(
      x, x_strides[0], x_strides[1], x_strides[2], dt, dt_strides[0],
      dt_strides[1], dt_strides[2], A, Bm, b_strides[0], b_strides[1], Cm,
      c_strides[0], c_strides[1], D, y, state, chunk_states, S, nh, hd, N);
  return (int)cudaGetLastError();
}

// bf16, as mamba2_scan_fwd with x, Bm, Cm and y bf16; x, Bm and Cm rows
// 16-byte aligned (base addresses and strides multiples of 16 bytes), hd
// and N multiples of 8 up to 64 (the wrapper's mma_layout_problem() checks
// this before the call).
extern "C" int mamba2_scan_mma_fwd(const void* x, const long long* x_strides,
                                   const float* dt,
                                   const long long* dt_strides,
                                   const float* A, const void* Bm,
                                   const long long* b_strides, const void* Cm,
                                   const long long* c_strides, const float* D,
                                   void* y, float* state,
                                   float* chunk_states, int B, int S,
                                   int nh, int hd, int N, void* stream) {
  if (B < 1 || B > 65535 || S < 1 || nh < 1 || hd < 8 || hd > kP ||
      hd % 8 || N < 8 || N > kP || N % 8)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = set_mma_smem();
  if (err != cudaSuccess) return (int)err;
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
  p.y = static_cast<__nv_bfloat16*>(y);
  p.state_out = state;
  p.chunk_states = chunk_states;
  p.S = S;
  p.nh = nh;
  p.hd = hd;
  p.N = N;
  const dim3 grid((nh + kHeads - 1) / kHeads, B);
  mamba2_scan_kernel_mma<<<grid, kMmaThreads, kMmaSmemBytes,
                           static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// The bf16 kernel's blocks resident on one SM, as the occupancy calculator
// gives it for its threads and shared memory; returns the cudaError_t.
extern "C" int mamba2_scan_mma_occupancy(int* blocks) {
  cudaError_t err = set_mma_smem();
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, mamba2_scan_kernel_mma, kMmaThreads, kMmaSmemBytes);
}

#ifdef MAMBA2_PROFILE
// The SM clocks of each phase (kPhCount of them, in the enum's order)
// summed over the chunks of each of block (0, 0)'s 8 warps (8 rows of
// kPhCount) since the last read, then cleared.
extern "C" int mamba2_scan_mma_profile(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_profile, sizeof(g_profile));
  if (err != cudaSuccess) return (int)err;
  static const unsigned long long zeros[kHeads * kWarpsPerHead][kPhCount] =
      {};
  return (int)cudaMemcpyToSymbol(g_profile, zeros, sizeof(g_profile));
}
#endif
