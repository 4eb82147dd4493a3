// The sLSTM recurrence's backward for Hopper (sm_90a): the gradient on the
// gate inputs wx, given what the forward (csrc/slstm_scan.cu, its training
// variant) saved.  Built by repro_torch/kernels/build.py into a shared
// library with a plain C interface and bound with ctypes
// (repro_torch/kernels/slstm_scan.py, slstm_scan_bwd_cuda).
//
// Replaces no Pallas kernel: the JAX package's kernel has no backward, and
// its model trains through the VJP of the lax.scan over slstm_step in
// src/repro/models/xlstm.py (apply_slstm).  This kernel computes that VJP's
// recurrent part, per batch row b and head, for t = S - 1 down to 0, with the
// carries dc, dn, dm and the recurrent term of dh zero at S - 1:
//   dh   = dh_up[t] + (R dwx_{t+1})             n~ = max(n_t, 1e-6), s = sigmoid(o~)
//   do~  = dh (c_t / n~) s (1 - s),  dc += dh s / n~,  dn += -dh s c_t / n~^2
//   i = exp(i~ - m_t),  f = exp(f~ + m_{t-1} - m_t)
//   dz~  = dc i (1 - tanh^2 z~),  di = dc tanh z~ + dn,  df = dc c_{t-1} + dn n_{t-1}
//   di~  = di i,  df~ = df f,  dm = dm_carry - di i - df f, routed through
//          m_t = max(f~ + m_{t-1}, i~) to i~, or to f~ and m_{t-1} (halves at a tie)
//   carries to t - 1: dc f, dn f, dm_{t-1} = df f (+ the routed part)
//   dwx_t = (dz~, di~, df~, do~);  dh_{t-1}[k] = sum_j R[k, j] dwx_t[j] over 4 hd j
// which is JAX's chain rule taken literally, the stabilizer's path included,
// as repro_torch/kernels/ref.py's slstm_scan_bwd_ref writes it out; the tie
// of n at 1e-6 also halves.  It also writes dh_{-1}, the gradient on the
// initial h.  The gradient on R, the sum over b and t of h_{t-1} dwx_t, is one
// batched product the wrapper leaves to torch.matmul, as JAX leaves it to
// XLA.  The forward's exact fp32 values of pre, c, n and m are read, so
// f~ + m_{t-1} - m_t is computed from the same operands as the forward
// computed it (the stabilizer's terms only cancel where the two agree).
//
// What bounds it: at the top of the xLSTM-1.3B training step, B 4, S 4096,
// 4 heads of 512, the products dh_{t-1} = R dwx_t are 2 B S nh hd 4hd =
// 1.37e11 fp32 operations, 2.05 ms at the 67 TFLOP/s fp32 rate; its bytes
// (pre, c, n, m, dh read, dwx written, about 1.6 GB) take 0.48 ms at 3.35
// TB/s.  As in the forward, step t - 1 needs all of step t's dwx of the head,
// so it is bound by the latency of a step: the product over the SMs that
// hold R, and one exchange between them.
//
// Two routes, chosen by the wrapper's plan_bwd from the shape before any
// launch; both split a head's hd units into groups of U units, one block a
// group (U 16 at 4 heads of 512: 32 blocks a head, 128 on the 132 SMs), and
// run one barrier a step among a head's blocks.
//
// The mma route (slstm_scan_bwd_mma, where U <= 16 and hd <= 512), the one
// xLSTM-1.3B trains through.  A block holds R's columns of its units (all hd
// rows x 4U columns, gate-major: column 16 g + u is unit u's gate g) as
// m16n8k16 A fragments in registers for the whole launch, split into bf16 hi
// and lo terms (128 KiB a block at hd 512: 128 registers a thread); the 8
// warps split the hd rows, 4 m-tiles of 16 a warp.  A step:
//   1. the head's partial sums of step t + 1 (R dwx_{t+1}) for the block's
//      units are read through L2 (ld.global.cg: L1 is not coherent across
//      SMs) and added in block order; the B x U gate threads (one a (row,
//      unit) pair for the run, carries in registers) form dwx_t of their
//      unit from terms of the saved state they took in the last step's
//      barrier shadow, store it to dwx and, in fragment order, to shared
//      memory;
//   2. each warp forms its rows of the block's share of dh_{t-1}, P[b][k] =
//      sum over the block's 4U columns of R[k][.] dwx_t[b][.], on the tensor
//      cores: dwx_t split into hi and lo too, each gate's three products (lo
//      hi, hi lo, hi hi; a product of two bf16 values is exact in fp32) into
//      a zeroed tile (the tensor cores truncate a running sum), the gates'
//      tiles added in fp32 in order; it stores P (B x hd a block) to the
//      head's exchange buffer for the step's parity;
//   3. one release add to the head's arrival counter and an acquire wait for
//      all of the head's blocks (a lane of the last warp), while the gate
//      threads take step t - 1's state-only terms (exp, tanh, sigmoid, the
//      reciprocals of n~ and n~^2) from the saved-state ring, which cp.async
//      fills 4 steps ahead (a warp a field, issued after the product: at the
//      top of the step the copies delayed the exchange's read).
// Only partial sums cross blocks: a block reads G x B x U floats a step (8
// KiB at B 4), a quarter of what the head's dwx_t would be, and no line is
// read by more than one block.  A buffer a parity suffices: a block writes
// step t's sums only after every block has written step t + 1's, which each
// did after reading step t + 2's.  The split leaves about 2^-16 of each
// product (three bf16 terms of two); tests/test_torch_slstm_bwd_split.py
// emulates it on the CPU.
//
// The simt route (slstm_scan_bwd_kernel, every other shape: a block's
// columns of R do not fit the fragments): the first design.  A block holds
// R's rows of its U units (U x 4hd fp32) in shared memory, the first kRegK
// floats of each thread's slice also in registers; the gate threads store
// dwx_t, and after the barrier every block reads the head's whole dwx_t (B
// x 4hd) through L2 and U x J threads form its units of dh_{t-1}: J
// k-slices of the 4hd sum, 4 batch rows a pass, added across the J
// neighbouring lanes by a butterfly of warp shuffles.
//
// Both routes take the gate math from the same two functions (prep_step,
// gate_step), so the stabilizer's tie rules are written once.  On both
// routes sums run in a fixed order and nothing is atomic but the arrival
// counters, so two launches agree bit for bit.  The grid goes out
// with cudaLaunchCooperativeKernel after the entry point has checked that it
// can be resident; a wait traps after 2^35 clocks.  Built without
// --use_fast_math: with m_{-1} = -1e30, f = exp(f~ + m_{-1} - m_0) must give
// 0, not NaN.  Built with -DSLSTM_PROFILE, the first block's thread 0 adds
// up the clocks of each phase of a step, read back by
// slstm_scan_bwd_profile() (slstm_scan.py's bwd_step_profile); without it
// the kernel has no trace of that.
//
// No allocation and no synchronisation here: the entry point launches on the
// caller's stream and returns the launch's cudaError_t.  The caller zeroes
// the arrival counters, one per head, and hands the mma route its exchange
// buffer.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "slstm_common.cuh"  // the barrier, butterfly and cp.async helpers

#ifdef SLSTM_PROFILE
constexpr int kPhases = 6;
__device__ long long g_phase_clocks[kPhases];
// A warp issues past a __syncthreads (BAR.SYNC.DEFER_BLOCKING) until an
// instruction that needs the barrier, and a clock read does not: read
// plainly, it would time the arrival at a barrier, not the release.  So the
// read is predicated on a word loaded from shared memory, which waits for
// the release (the word is never the NaN pattern compared with): about an
// LDS's latency a phase, in this build only.
#define PHASE(k)                                                          \
  if (prof_on) {                                                          \
    long long now;                                                        \
    const unsigned dep = *reinterpret_cast<volatile unsigned*>(smem);     \
    asm volatile("{ .reg .pred p; setp.ne.u32 p, %1, 0x7fc00001;"          \
                 " @p mov.u64 %0, %%clock64; @!p mov.u64 %0, 0; }"         \
                 : "=l"(now) : "r"(dep) : "memory");                      \
    phase_clocks[k] += now - phase_last;                                  \
    phase_last = now;                                                     \
  }
#else
#define PHASE(k)
#endif

namespace {

constexpr float kNegInit = -1e30f;
constexpr float kNMin = 1e-6f;
constexpr int kRows = 4;        // batch rows a pass of the simt product
constexpr int kRing = 4;        // saved-state ring slots: steps t + 1 .. t - 2
constexpr int kFields = 8;      // a slot's fields: z~ i~ f~ o~ c n m dh
constexpr int kMaxThreads = 256;
constexpr int kRegK = 96;       // floats of a thread's slice of R in registers
constexpr long long kSpinClocks = 1ll << 35;

// The shared-memory layout, in floats, for B rows, hd units, U units a block
// and J k-slices of the 4hd-long rows; repro_torch/kernels/slstm_scan.py's
// _smem_floats_bwd computes the same total.  A slice of k_slice floats is
// stored in slice_stride floats, a stride whose count of float4s is odd, so
// that the float4 reads of J neighbouring lanes fall in distinct banks.
struct Layout {
  int k_slice, slice_stride, row;
  int dp_off, ring_off, st_off, total;
};

__host__ __device__ inline Layout make_layout(int B, int hd, int U, int J) {
  Layout L;
  L.k_slice = 4 * ((hd + J - 1) / J);                  // of 4hd, in J slices
  L.slice_stride = L.k_slice + ((L.k_slice / 4) % 2 ? 8 : 4);
  L.row = J * L.slice_stride;                          // a row of 4hd
  L.dp_off = U * L.row;                                // R: U rows
  L.ring_off = L.dp_off + (B + kRows - 1) / kRows * kRows * L.row;  // dwx_t
  L.st_off = L.ring_off + kRing * kFields * B * U;     // the ring
  L.total = L.st_off + 7 * B * U;  // c0, n0, m0; dc, dn, dm; dh_rec
  return L;
}

struct Params {
  const float* r;
  const float *pre, *c, *n, *m, *dh;
  const float *c0, *n0, *m0;
  float *dwx, *dh0;
  float* part;            // the mma route's partial sums: (2, nh, G, B, hd)
  unsigned* arrivals;
  int B, S, nh, hd, units, groups;
};

// all but the newest kRing - 2 groups landed: steps t and t - 1
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;" :: "n"(kRing - 2) : "memory");
}

// the share of max(x, y)'s gradient that goes to x, as jnp.maximum splits it
__device__ __forceinline__ float to_first(float x, float y) {
  return x > y ? 1.f : (x < y ? 0.f : 0.5f);
}

// Step t's terms of one (row, unit) that need no dh: what the saved state
// gives, and the reciprocals of n~ and n~^2, so that gate_step multiplies
// where the chain rule divides (within 1 ulp a term).  sl and sp are the
// ring slots of steps t and t - 1; field q of the pair lies at sl[q fs + i]
// (the simt route's slots are field-major, fs = B U; the mma route's
// row-major, fs = U)
struct Prep {
  float g_up, c, inv_n, sig, sc, inv_nn, tie_n, i_g, f_g, tz, dtz, cp, np,
      to_f;
};

__device__ __forceinline__ Prep prep_step(const float* sl, const float* sp,
                                          int i, int fs) {
  Prep q;
  const float zt = sl[i], it = sl[fs + i], ft = sl[2 * fs + i];
  const float ot = sl[3 * fs + i], n = sl[5 * fs + i], m = sl[6 * fs + i];
  const float mp = sp[6 * fs + i];
  q.g_up = sl[7 * fs + i];
  q.c = sl[4 * fs + i];
  q.cp = sp[4 * fs + i];
  q.np = sp[5 * fs + i];
  const float n_c = fmaxf(n, kNMin);
  q.inv_n = 1.f / n_c;
  q.sig = 1.f / (1.f + expf(-ot));
  q.sc = q.sig * q.c;
  q.inv_nn = 1.f / (n_c * n_c);
  q.tie_n = to_first(n, kNMin);
  q.i_g = expf(it - m);
  q.f_g = expf(ft + mp - m);
  q.tz = tanhf(zt);
  q.dtz = 1.f - q.tz * q.tz;
  q.to_f = to_first(ft + mp, it);
  return q;
}

// dwx_t of one (row, unit): (dz~, di~, df~, do~)
struct GateGrads {
  float dz, di, df, d_o;
};

// Step t's gradients on the gate inputs of one (row, unit), from its
// state-only terms P, its dh (upstream plus recurrent) g, and the carries
// dc, dn, dm from step t + 1, which it turns into step t - 1's; the
// stabilizer's gradient routed through m_t = max(f~ + m_{t-1}, i~)
__device__ __forceinline__ GateGrads gate_step(const Prep& P, float g,
                                               float& car_c, float& car_n,
                                               float& car_m) {
  const float a = g * P.inv_n;               // h = (s c) / n~
  const float d_o = a * P.c * P.sig * (1.f - P.sig);
  const float dc = car_c + a * P.sig;
  const float dn = car_n + (-g * P.sc * P.inv_nn) * P.tie_n;
  const float dz = dc * P.i_g * P.dtz;
  const float di = dc * P.tz + dn;
  const float df = dc * P.cp + dn * P.np;
  float di_t = di * P.i_g, df_t = df * P.f_g;
  const float dm = car_m - di_t - df_t;
  float dmp = df_t;
  df_t = df_t + dm * P.to_f;
  dmp = dmp + dm * P.to_f;
  di_t = di_t + dm * (1.f - P.to_f);
  car_c = dc * P.f_g;
  car_n = dn * P.f_g;
  car_m = dmp;
  return {dz, di_t, df_t, d_o};
}

template <int J>
__global__ void __launch_bounds__(kMaxThreads, 1)
slstm_scan_bwd_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int B = p.B, S = p.S, nh = p.nh, hd = p.hd, U = p.units;
  const Layout L = make_layout(B, hd, U, J);
  const int KS = L.k_slice, SS = L.slice_stride, BU = B * U;
  const int H4 = 4 * hd;
  float* rs = smem;                  // rs[u row + j SS + k] = R[u0 + u, j KS + k]
  float* dp = smem + L.dp_off;       // dp[b row + j SS + k] = dwx_t[b, j KS + k]
  float* ring = smem + L.ring_off;   // ring[slot][q][b][u], q < kFields
  float* st0 = smem + L.st_off;      // st0[q B U + b U + u], q = c0, n0, m0
  float* car = st0 + 3 * BU;         // car[q B U + b U + u], q = dc, dn, dm
  float* dhr = car + 3 * BU;         // dhr[b U + u]: R dwx_{t+1}
  const int nthr = U * J, tid = threadIdx.x;
  const int ul = tid / J, j = tid % J;     // this thread's unit and k-slice
  const int head = blockIdx.x / p.groups;
  const int u0 = (blockIdx.x % p.groups) * U;
  const int nu = min(U, hd - u0);    // the last group of a head may be ragged
  const bool mine = ul < nu;
  const int warp_n = min(32, nthr - (tid & ~31));
  const unsigned lanes = warp_n == 32 ? 0xffffffffu : (1u << warp_n) - 1;
  const long long nhd = (long long)nh * hd;

  // R's rows of this block's units, zero past 4hd and nu; a warp reads
  // neighbouring columns of a row
  const float* rh = p.r + (long long)head * hd * H4 + (long long)u0 * H4;
  for (int i = tid; i < U * J * KS; i += nthr) {
    const int u = i / (J * KS), k = i % (J * KS);
    rs[u * L.row + (k / KS) * SS + k % KS] =
        (k < H4 && u < nu) ? rh[(long long)u * H4 + k] : 0.f;
  }
  // dwx_t rows (the padding rows and columns stay zero), carries, dh_rec
  for (int i = tid; i < L.ring_off - L.dp_off; i += nthr) dp[i] = 0.f;
  for (int i = tid; i < BU; i += nthr) {
    const int b = i / U, u = i % U;
    const long long s = ((long long)b * nh + head) * hd + u0 + u;
    const bool ok = u < nu;
    st0[i] = ok && p.c0 ? p.c0[s] : 0.f;
    st0[BU + i] = ok && p.n0 ? p.n0[s] : 0.f;
    st0[2 * BU + i] = ok && p.m0 ? p.m0[s] : kNegInit;
    car[i] = car[BU + i] = car[2 * BU + i] = 0.f;
    dhr[i] = 0.f;
  }
  // the first kRegK floats of the thread's slice of its row of R
  const float* rrow = rs + ul * L.row + j * SS;
  const bool use_reg = KS >= kRegK;
  __syncthreads();
  float rreg[kRegK];
#pragma unroll
  for (int k = 0; k < kRegK; ++k) rreg[k] = use_reg ? rrow[k] : 0.f;

  // step s's saved state and upstream gradient into ring slot s % kRing, one
  // row (q, b) of U units a slice; one commit group a step
  auto issue = [&](int s) {
    if (s >= 0 && mine) {
      float* dst = ring + (s % kRing) * kFields * BU + ul;
      const long long unit = (long long)head * hd + u0 + ul;
      for (int row = j; row < kFields * B; row += J) {
        const int q = row / B, b = row % B;
        const long long bs = (long long)b * S + s;
        const float* src;
        if (q < 4) src = p.pre + bs * 4 * nhd + q * nhd + unit;
        else if (q == 4) src = p.c + bs * nhd + unit;
        else if (q == 5) src = p.n + bs * nhd + unit;
        else if (q == 6) src = p.m + bs * nhd + unit;
        else src = p.dh + bs * nhd + unit;
        cp_async4(dst + row * U, src);
      }
    }
    cp_async_commit();
  };
  for (int s = S - 1; s > S - kRing; --s) issue(s);

  // the dwx_t rows this thread copies each step: float4s i = tid + q nthr of
  // the B x 4hd / 4, when hd is a multiple of 4 and they take at most 8
  const bool d_vec = (hd & 3) == 0 && B * hd <= 8 * nthr;
  const int q0 = J >= 4 ? ((j & 1) << 1) | ((j >> 1) & 1)
                        : (J == 2 ? (j & 1) << 1 : 0);
  constexpr int kHeld = kRows / (J < kRows ? J : kRows);  // sums a lane holds
  const bool writer = j < (J < kRows ? J : kRows);         // after the butterfly

#ifdef SLSTM_PROFILE
  const bool prof_on = tid == 0 && blockIdx.x == 0;
  long long phase_clocks[kPhases] = {0}, phase_last = clock64();
#endif
  for (int t = S - 1; t >= 0; --t) {
    issue(t - (kRing - 1));
    cp_async_wait_ring();   // this thread's copies of steps t and t - 1 are in
    __syncthreads();        // everyone's, and dh_rec of the last step
    PHASE(0);
    const float* sl = ring + (t % kRing) * kFields * BU;
    const float* sp = t > 0 ? ring + ((t - 1) % kRing) * kFields * BU : st0 - 4 * BU;
    for (int i = tid; i < BU; i += nthr) {
      const int b = i / U, u = i % U;
      if (u >= nu) continue;
      const Prep P = prep_step(sl, sp, i, BU);
      const GateGrads d = gate_step(P, P.g_up + dhr[i], car[i], car[BU + i],
                                    car[2 * BU + i]);
      float* dst = p.dwx + ((long long)b * S + t) * 4 * nhd + (long long)head * hd + u0 + u;
      dst[0] = d.dz;
      dst[nhd] = d.di;
      dst[2 * nhd] = d.df;
      dst[3 * nhd] = d.d_o;
    }
    PHASE(1);
    __syncthreads();
    // publish this block's units of dwx_t, then wait for the head's others
    if (tid == 0) {
      red_release(p.arrivals + head, 1u);
      const unsigned want = (unsigned)(S - t) * (unsigned)p.groups;
      const long long clk = clock64();
      while (ld_acquire(p.arrivals + head) < want)
        if (clock64() - clk > kSpinClocks) __trap();
    }
    __syncthreads();
    PHASE(2);
    // dwx_t of the head, all B rows, through L2
    const float* src = p.dwx + (long long)t * 4 * nhd + (long long)head * hd;
    const long long src_b = (long long)S * 4 * nhd;
    if (d_vec) {
      float4 v[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int i = tid + q * nthr;           // float4 i of the B x 4hd / 4
        if (i < B * hd) {
          const int b = i / hd, col = 4 * (i % hd), g = col / hd;
          v[q] = __ldcg(reinterpret_cast<const float4*>(
              src + b * src_b + g * nhd + col % hd));
        }
      }
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int i = tid + q * nthr;
        if (i < B * hd) {
          const int b = i / hd, col = 4 * (i % hd);
          *reinterpret_cast<float4*>(dp + b * L.row + (col / KS) * SS + col % KS) = v[q];
        }
      }
    } else {
      for (int i = tid; i < B * H4; i += nthr) {
        const int b = i / H4, col = i % H4, g = col / hd;
        dp[b * L.row + (col / KS) * SS + col % KS] =
            __ldcg(src + b * src_b + g * nhd + col % hd);
      }
    }
    __syncthreads();
    PHASE(3);
    // the block's units of dh_{t-1} = R dwx_t, 4 rows a pass
    for (int b0 = 0; b0 < B; b0 += kRows) {
      float v[kRows];
#pragma unroll
      for (int bb = 0; bb < kRows; ++bb) v[bb] = 0.f;
      const float* drow = dp + b0 * L.row + j * SS;
      if (use_reg) {
#pragma unroll
        for (int k = 0; k < kRegK; k += 4) {
#pragma unroll
          for (int bb = 0; bb < kRows; ++bb) {
            const float4 d = *reinterpret_cast<const float4*>(drow + bb * L.row + k);
            float a = v[bb];
            a = fmaf(d.x, rreg[k], a);
            a = fmaf(d.y, rreg[k + 1], a);
            a = fmaf(d.z, rreg[k + 2], a);
            a = fmaf(d.w, rreg[k + 3], a);
            v[bb] = a;
          }
        }
      }
      for (int k = use_reg ? kRegK : 0; k < KS; k += 4) {
        const float4 rv = *reinterpret_cast<const float4*>(rrow + k);
#pragma unroll
        for (int bb = 0; bb < kRows; ++bb) {
          const float4 d = *reinterpret_cast<const float4*>(drow + bb * L.row + k);
          float a = v[bb];
          a = fmaf(d.x, rv.x, a);
          a = fmaf(d.y, rv.y, a);
          a = fmaf(d.z, rv.z, a);
          a = fmaf(d.w, rv.w, a);
          v[bb] = a;
        }
      }
      PHASE(4);
      // the J slices of unit ul lie on J neighbouring lanes: the butterfly
      // leaves lane j the kRows / min(J, kRows) sums of rows q0 + i, added
      // over the slices in a fixed order
      if (J > 1) butterfly<2>(v, j & 1, 1, lanes);
      if (J > 2) butterfly<1>(v, j & 2, 2, lanes);
      if (J > 4) v[0] += __shfl_xor_sync(lanes, v[0], 4);
      if (J > 8) v[0] += __shfl_xor_sync(lanes, v[0], 8);
      if (writer && mine) {
#pragma unroll
        for (int i = 0; i < kHeld; ++i) {
          const int b = b0 + q0 + i;
          if (b < B) dhr[b * U + ul] = v[i];
        }
      }
      PHASE(5);
    }
  }
#ifdef SLSTM_PROFILE
  if (prof_on)
    for (int k = 0; k < kPhases; ++k) g_phase_clocks[k] = phase_clocks[k];
#endif
  __syncthreads();
  for (int i = tid; i < BU; i += nthr) {
    const int b = i / U, u = i % U;
    if (u < nu) p.dh0[((long long)b * nh + head) * hd + u0 + u] = dhr[i];
  }
}

// ---------------------------------------------------------------------------
// the mma route: R's columns as bf16 fragments in registers, the product on
// the tensor cores, partial sums of dh exchanged
// ---------------------------------------------------------------------------

constexpr int kMmaWarps = 8;                  // the hd rows of R split over them
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMmaUnits = 16;                 // a block's units: 4 k-steps of 16
constexpr int kMmaRows = 8;                   // N of m16n8k16: batch rows a tile
constexpr int kMmaRing = 5;                   // ring slots: steps t + 2 .. t - 2
constexpr int kMaxMTiles = 4;                 // m-tiles of 16 a warp: hd <= 512

// The shared-memory layout, in floats, for B rows, U units and G groups a
// head; repro_torch/kernels/slstm_scan.py's _smem_floats_mma computes the
// same total.  The block's dwx_t is stored in fragment order: for gate g
// (k-step g: column 16 g + u is unit u's gate g) and batch row n, the 4
// lanes' float4s (units 2q, 2q + 1, 2q + 8, 2q + 9 for lane q), so that a
// warp reads its B fragments with one conflict-free 16-byte load a lane;
// rows are padded to tiles of 8 (never read) and units past nu stay zero.
struct MmaLayout {
  int nt, red_off, ring_off, st_off, total;
};

__host__ __device__ inline MmaLayout make_mma_layout(int B, int U, int G) {
  MmaLayout L;
  L.nt = (B + kMmaRows - 1) / kMmaRows;        // tiles of 8 batch rows
  L.red_off = 4 * L.nt * kMmaRows * 16;        // dwx_t, fragment order
  L.ring_off = L.red_off + G * B * U;          // the head's partial sums
  L.st_off = L.ring_off + kMmaRing * kFields * B * U;  // the ring
  L.total = L.st_off + kFields * B * U;   // c0, n0, m0 laid out as a slot
  return L;
}

// d += a b, m16n8k16, bf16 operands, fp32 accumulators
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (v0, v1) = hi + lo to within 2^-16 of each: hi = bf16(v), lo = bf16(v -
// hi), each a packed pair with v0 in the low half, as fragments hold it
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(v0 - hf.x, v1 - hf.y));
}

template <int MW>
__global__ void __launch_bounds__(kMmaThreads, 1)
slstm_scan_bwd_mma(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int B = p.B, S = p.S, nh = p.nh, hd = p.hd, U = p.units;
  const int G = p.groups;
  const MmaLayout L = make_mma_layout(B, U, G);
  const int BU = B * U, NB = L.nt * kMmaRows;
  float* frag = smem;                  // frag[((g NB + n) 4 + q) 4 + e]
  float* red = smem + L.red_off;       // red[(g' B + b) U + u]
  float* ring = smem + L.ring_off;     // ring[slot][b][q][u], q < kFields
  float* st0 = smem + L.st_off;        // st0[(b kFields + q) U + u], q = 4, 5,
                                       // 6: c0, n0, m0, as a slot of step -1
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;   // the fragments' row and pair
  const int head = blockIdx.x / G, group = blockIdx.x % G;
  const int u0 = group * U;
  const int nu = min(U, hd - u0);    // the last group of a head may be ragged
  const long long nhd = (long long)nh * hd;
  // thread i < B U owns (row b, unit u) of the gate math for the whole run
  const int gb = tid / U, gu = tid % U;
  const bool gate = tid < BU && gu < nu;
  const int gi = gb * kFields * U + gu;      // (gb, gu) in a ring slot
  const int spinner = kMmaThreads - 32;      // a lane of the last warp
  // the head's partial sums, one (G, B, hd) buffer a step parity
  const long long part_step = (long long)nh * G * B * hd;
  float* part_head = p.part + (long long)head * G * B * hd;

  for (int i = tid; i < L.red_off; i += kMmaThreads) frag[i] = 0.f;
  for (int i = tid; i < BU; i += kMmaThreads) {
    const int b = i / U, u = i % U;
    const long long s = ((long long)b * nh + head) * hd + u0 + u;
    const bool ok = u < nu;
    float* st = st0 + b * kFields * U + u;
    st[4 * U] = ok && p.c0 ? p.c0[s] : 0.f;
    st[5 * U] = ok && p.n0 ? p.n0[s] : 0.f;
    st[6 * U] = ok && p.m0 ? p.m0[s] : kNegInit;
  }
  // the block's columns of R, rows (warp MW + i) 16 .. + 15, as m16n8k16 A
  // fragments (row gq or gq + 8; column 16 g + 2 tq or + 8, and the next),
  // bf16 hi and lo, zero past hd and nu: A[k][16 g + u] = R[k, g hd + u0 + u]
  uint32_t a_hi[MW][4][4], a_lo[MW][4][4];
  const float* rh = p.r + (long long)head * hd * 4 * hd + u0;
#pragma unroll
  for (int i = 0; i < MW; ++i)
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int k = (warp * MW + i) * 16 + gq + 8 * (q & 1);
        const int u = 2 * tq + 8 * (q >> 1);
        const float* src = rh + (long long)k * 4 * hd + g * hd + u;
        const float v0 = k < hd && u < nu ? src[0] : 0.f;
        const float v1 = k < hd && u + 1 < nu ? src[1] : 0.f;
        split2(v0, v1, a_hi[i][g][q], a_lo[i][g][q]);
      }

  // step s's saved state and upstream gradient into ring slot s % kMmaRing:
  // warp w copies field w, its half-warps rows b of one parity, a lane a
  // unit (16 at most), so that a copy takes no division and no branch; one
  // commit group a step
  static_assert(kMmaWarps == kFields, "a warp a field of the ring");
  const int cu = tid & 15;
  const float* c_src = (warp < 4 ? p.pre + warp * nhd
                        : warp == 4 ? p.c : warp == 5 ? p.n
                        : warp == 6 ? p.m : p.dh)
                       + (long long)head * hd + u0 + cu;
  const long long c_step = (warp < 4 ? 4 : 1) * nhd;   // a (b S + s) apart
  auto issue = [&](int s) {
    if (s >= 0 && cu < nu) {
      float* dst = ring + (s % kMmaRing) * kFields * BU + warp * U + cu;
      for (int b = (tid >> 4) & 1; b < B; b += 2)
        cp_async4(dst + b * kFields * U, c_src + ((long long)b * S + s) * c_step);
    }
    cp_async_commit();
  };
  auto slot = [&](int s) {
    return s >= 0 ? ring + (s % kMmaRing) * kFields * BU : st0;
  };
  // the head's partial sums of step s for this block's units, through L2
  // (ld.global.cg: L1 is not coherent across SMs), into red
  // (float4s only where every group of the head is whole: a ragged last
  // group's float4 would run into the next row, past the buffer's end)
  const bool red_vec = (U & 3) == 0 && hd % U == 0;
  auto gather = [&](int s) {
    const float* src = part_head + (s & 1) * part_step + u0;
    if (red_vec) {               // row = g' B + b, float4 q of its U units
      const int q = tid & 3;
      for (int row = tid >> 2; q < U / 4 && row < G * B;
           row += kMmaThreads / 4)
        *reinterpret_cast<float4*>(red + row * U + 4 * q) =
            __ldcg(reinterpret_cast<const float4*>(src + row * hd + 4 * q));
    } else {
      for (int i = tid; i < G * BU; i += kMmaThreads) {
        const int row = i / U, u = i % U;
        red[i] = u < nu ? __ldcg(src + row * hd + u) : 0.f;
      }
    }
  };
  // dh = R dwx of the step whose partial sums red holds, for (gb, gu): the
  // head's groups in order
  auto recurrent = [&]() {
    float rec = 0.f;
    for (int g = 0; g < G; ++g) rec += red[(g * B + gb) * U + gu];
    return rec;
  };

  for (int s = S - 1; s > S - kMmaRing; --s) issue(s);
  asm volatile("cp.async.wait_group %0;" :: "n"(kMmaRing - 3) : "memory");
  __syncthreads();
  Prep P{};
  float car_c = 0.f, car_n = 0.f, car_m = 0.f;   // dc, dn, dm from step t + 1
  if (gate) P = prep_step(slot(S - 1), slot(S - 2), gi, U);

#ifdef SLSTM_PROFILE
  const bool prof_on = tid == 0 && blockIdx.x == 0;
  long long phase_clocks[kPhases] = {0}, phase_last = clock64();
#endif
  for (int t = S - 1; t >= 0; --t) {
    PHASE(0);
    if (t < S - 1) {
      gather(t + 1);
      __syncthreads();
    }
    PHASE(3);
    if (gate) {
      const GateGrads d = gate_step(
          P, P.g_up + (t < S - 1 ? recurrent() : 0.f), car_c, car_n, car_m);
      float* dst = p.dwx + ((long long)gb * S + t) * 4 * nhd
                   + (long long)head * hd + u0 + gu;
      dst[0] = d.dz;
      dst[nhd] = d.di;
      dst[2 * nhd] = d.df;
      dst[3 * nhd] = d.d_o;
      // the B operand: unit gu's gates of row gb
      float* f = frag + ((gb * 4 + ((gu & 7) >> 1)) * 4 + 2 * (gu >> 3)
                         + (gu & 1));
      const int gate_stride = NB * 16;
      f[0] = d.dz;
      f[gate_stride] = d.di;
      f[2 * gate_stride] = d.df;
      f[3 * gate_stride] = d.d_o;
    }
    PHASE(1);
    __syncthreads();
    // the warp's rows of the block's share of dh_{t-1}: P[b][k] = sum over
    // the block's 4U columns of R[k][16 g + u] dwx_t[b][g, u]; each gate's
    // three products (lo hi, hi lo, hi hi) into a zeroed tile, the gates'
    // tiles added in fp32 in gate order
    float* out = part_head + (t & 1) * part_step + (long long)group * B * hd;
    for (int tile = 0; tile < L.nt; ++tile) {
      const bool live = tile * kMmaRows + gq < B;
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (live)
          v = *reinterpret_cast<const float4*>(
              frag + ((g * NB + tile * kMmaRows + gq) * 4 + tq) * 4);
        split2(v.x, v.y, bh[g][0], bl[g][0]);
        split2(v.z, v.w, bh[g][1], bl[g][1]);
      }
      float acc[MW][4];
#pragma unroll
      for (int i = 0; i < MW; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        float d[MW][4];
#pragma unroll
        for (int i = 0; i < MW; ++i) {
#pragma unroll
          for (int e = 0; e < 4; ++e) d[i][e] = 0.f;
          mma(d[i], a_lo[i][g], bh[g][0], bh[g][1]);
        }
#pragma unroll
        for (int i = 0; i < MW; ++i) mma(d[i], a_hi[i][g], bl[g][0], bl[g][1]);
#pragma unroll
        for (int i = 0; i < MW; ++i) mma(d[i], a_hi[i][g], bh[g][0], bh[g][1]);
#pragma unroll
        for (int i = 0; i < MW; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][e] += d[i][e];
      }
      PHASE(4);
      // row k = 16 (warp MW + i) + gq (acc 0, 1) or + 8 (acc 2, 3), batch
      // rows n = 2 tq and 2 tq + 1 of the tile
      const int n = tile * kMmaRows + 2 * tq;
#pragma unroll
      for (int i = 0; i < MW; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = (warp * MW + i) * 16 + gq + 8 * (e >> 1);
          const int b = n + (e & 1);
          if (k < hd && b < B) out[(long long)b * hd + k] = acc[i][e];
        }
    }
    // the ring's copies of step t - 4, issued off the step's critical path
    // (at the top of the step they cost 2-3 % of the launch); this thread's
    // copies of steps t .. t - 2 are in
    issue(t - (kMmaRing - 1));
    asm volatile("cp.async.wait_group %0;" :: "n"(kMmaRing - 3) : "memory");
    PHASE(5);
    __syncthreads();        // everyone's, and the block's partial sums
    // publish this block's partial sums, then wait for the head's others;
    // meanwhile the gate threads take step t - 1's state-only terms
    if (tid == spinner) {
      red_release(p.arrivals + head, 1u);
      const unsigned want = (unsigned)(S - t) * (unsigned)G;
      const long long clk = clock64();
      while (ld_acquire(p.arrivals + head) < want)
        if (clock64() - clk > kSpinClocks) __trap();
    }
    if (gate && t > 0) P = prep_step(slot(t - 1), slot(t - 2), gi, U);
    __syncthreads();
    PHASE(2);
  }
#ifdef SLSTM_PROFILE
  if (prof_on)
    for (int k = 0; k < kPhases; ++k) g_phase_clocks[k] = phase_clocks[k];
#endif
  gather(0);
  __syncthreads();
  if (gate) p.dh0[((long long)gb * nh + head) * hd + u0 + gu] = recurrent();
}

}  // namespace

#ifdef SLSTM_PROFILE
// The clocks of each phase of a step, summed over the steps of the last
// launch, in its first block's thread 0: kPhases values.
extern "C" int slstm_scan_bwd_profile(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_phase_clocks,
                                   sizeof(g_phase_clocks));
}
#endif

// r: (nh, hd, 4 hd) fp32 contiguous; pre: (B, S, 4, nh, hd), c, n, m, dh:
// (B, S, nh, hd), fp32 contiguous, as the forward's training variant wrote
// them (dh the upstream gradient on h); c0, n0, m0: the initial (B, nh, hd)
// state, fp32 contiguous, all three or none (null: zeros and m = -1e30);
// dwx: (B, S, 4, nh, hd) and dh0: (B, nh, hd) fp32 contiguous outputs;
// part: the mma route's exchange, (2, nh, ceil(hd / U), B, hd) fp32 (null on
// the simt route); arrivals: nh zeroed counters.  route (0 simt, 1 mma),
// units (U) and slices come from the wrapper's plan_bwd: ceil(hd / U)
// blocks a head; on the simt route U x J threads (slices J, a power of two
// up to 16); on the mma route 256 threads, slices the m-tiles a warp (1, 2
// or 4).  Writes the dynamic shared memory a block takes to *smem_bytes and
// the blocks the card holds at once to *resident, and returns
// cudaErrorCooperativeLaunchTooLarge, launching nothing, when the grid
// exceeds them; else the launch's cudaError_t.
extern "C" int slstm_scan_bwd(const float* r, const float* pre,
                              const float* c, const float* n, const float* m,
                              const float* dh, const float* c0,
                              const float* n0, const float* m0, float* dwx,
                              float* dh0, float* part, unsigned* arrivals,
                              int B, int S, int nh, int hd, int route,
                              int units, int slices,
                              int* smem_bytes, int* resident,
                              cudaStream_t stream) {
  *smem_bytes = 0;
  *resident = 0;
  if (B < 1 || S < 1 || nh < 1 || hd < 1 || units < 1 || slices < 1 ||
      !c0 != !n0 || !c0 != !m0)
    return (int)cudaErrorInvalidValue;
  const int groups = (hd + units - 1) / units;
  if ((long long)S * groups >= (1ll << 32)) return (int)cudaErrorInvalidValue;
  const void* fn = nullptr;
  int threads = 0;
  long long smem = 0;
  if (route == 0) {            // simt: U x J threads
    threads = units * slices;
    smem = (long long)make_layout(B, hd, units, slices).total * sizeof(float);
    switch (threads <= kMaxThreads ? slices : 0) {
      case 1: fn = (const void*)slstm_scan_bwd_kernel<1>; break;
      case 2: fn = (const void*)slstm_scan_bwd_kernel<2>; break;
      case 4: fn = (const void*)slstm_scan_bwd_kernel<4>; break;
      case 8: fn = (const void*)slstm_scan_bwd_kernel<8>; break;
      case 16: fn = (const void*)slstm_scan_bwd_kernel<16>; break;
      default: return (int)cudaErrorInvalidValue;
    }
  } else if (route == 1) {     // mma: 8 warps, slices = MW m-tiles a warp
    if (units > kMmaUnits || B * units > kMmaThreads ||
        slices > kMaxMTiles || (long long)kMmaWarps * 16 * slices < hd ||
        !part)
      return (int)cudaErrorInvalidValue;
    threads = kMmaThreads;
    smem = (long long)make_mma_layout(B, units, groups).total * sizeof(float);
    switch (slices) {
      case 1: fn = (const void*)slstm_scan_bwd_mma<1>; break;
      case 2: fn = (const void*)slstm_scan_bwd_mma<2>; break;
      case 4: fn = (const void*)slstm_scan_bwd_mma<4>; break;
      default: return (int)cudaErrorInvalidValue;
    }
  } else {
    return (int)cudaErrorInvalidValue;
  }
  *smem_bytes = (int)smem;
  int dev = 0, n_sm = 0, optin = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  if (smem > optin) return (int)cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads,
                                                      (size_t)smem);
  if (e != cudaSuccess) return (int)e;
  *resident = per_sm * n_sm;
  const int grid = nh * groups;
  if (grid > *resident) return (int)cudaErrorCooperativeLaunchTooLarge;
  Params p{r, pre, c, n, m, dh, c0, n0, m0, dwx, dh0, part, arrivals,
           B, S, nh, hd, units, groups};
  void* args[] = {&p};
  return (int)cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(threads), args,
                                          (size_t)smem, stream);
}
