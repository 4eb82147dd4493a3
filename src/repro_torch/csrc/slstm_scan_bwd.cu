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
// Design: the forward's plan turned over.  A head's hd units are split into
// groups of U units, one block a group (U 16 at 4 heads of 512: 32 blocks a
// head, 128 on the 132 SMs); a block holds R's rows of its U units in all 4 hd
// columns (U x 4hd fp32, 128 KiB: what the forward's block holds as columns),
// in shared memory, the first kRegK floats of each thread's slice of its row
// also in registers.  A step has two halves:
//   1. each of the B x U (row, unit) pairs of the block takes its saved
//      state (copied ahead with cp.async into a ring, 2 steps ahead) and its
//      carries, forms dwx_t of its unit (4 values) and stores it to dwx;
//   2. the block's dwx_t rows are the exchange: one release add to the head's
//      arrival counter, an acquire wait for all of the head's blocks, then
//      the whole head's dwx_t (B x 4hd) read through L2 (ld.global.cg, never
//      L1, which is not coherent across SMs) into shared memory, and U x J
//      threads form the block's U units of dh_{t-1}: J k-slices of the 4hd
//      sum, 4 batch rows a pass, added across the J neighbouring lanes by a
//      butterfly of warp shuffles in a fixed order.
// dh_{t-1} of a unit stays in the block that formed it and is the next
// step's recurrent term, so only dwx crosses blocks; each step's dwx lands in
// rows that no block has read yet, so one barrier a step suffices.  This is 4x
// the forward's exchange a step (4U values a row, not U).  Sums run in a
// fixed order and nothing is atomic but the arrival counters, so two launches
// agree bit for bit.  The grid goes out with cudaLaunchCooperativeKernel
// after the entry point has checked that it can be resident; a wait traps
// after 2^35 clocks.  Built without --use_fast_math: with m_{-1} = -1e30,
// f = exp(f~ + m_{-1} - m_0) must give 0, not NaN.
//
// No allocation and no synchronisation here: the entry point launches on the
// caller's stream and returns the launch's cudaError_t.  The caller zeroes
// the arrival counters, one per head.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "slstm_common.cuh"  // the barrier, butterfly and cp.async helpers

namespace {

constexpr float kNegInit = -1e30f;
constexpr float kNMin = 1e-6f;
constexpr int kRows = 4;        // batch rows a pass of the product
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

  for (int t = S - 1; t >= 0; --t) {
    issue(t - (kRing - 1));
    cp_async_wait_ring();   // this thread's copies of steps t and t - 1 are in
    __syncthreads();        // everyone's, and dh_rec of the last step
    const float* sl = ring + (t % kRing) * kFields * BU;
    const float* sp = t > 0 ? ring + ((t - 1) % kRing) * kFields * BU : st0 - 4 * BU;
    for (int i = tid; i < BU; i += nthr) {
      const int b = i / U, u = i % U;
      if (u >= nu) continue;
      const float zt = sl[i], it = sl[BU + i], ft = sl[2 * BU + i], ot = sl[3 * BU + i];
      const float c = sl[4 * BU + i], n = sl[5 * BU + i], m = sl[6 * BU + i];
      const float cp = sp[4 * BU + i], np = sp[5 * BU + i], mp = sp[6 * BU + i];
      const float g = sl[7 * BU + i] + dhr[i];
      const float n_c = fmaxf(n, kNMin);
      const float sig = 1.f / (1.f + expf(-ot));
      const float a = g / n_c;                   // h = (s c) / n~
      const float d_o = a * c * sig * (1.f - sig);
      float dc = car[i] + a * sig;
      float dn = car[BU + i] + (-g * (sig * c) / (n_c * n_c)) * to_first(n, kNMin);
      const float i_g = expf(it - m);
      const float f_g = expf(ft + mp - m);
      const float tz = tanhf(zt);
      const float dz = dc * i_g * (1.f - tz * tz);
      const float di = dc * tz + dn;
      const float df = dc * cp + dn * np;
      float di_t = di * i_g, df_t = df * f_g;
      const float dm = car[2 * BU + i] - di_t - df_t;
      float dmp = df_t;
      const float to_f = to_first(ft + mp, it);
      df_t = df_t + dm * to_f;
      dmp = dmp + dm * to_f;
      di_t = di_t + dm * (1.f - to_f);
      float* dst = p.dwx + ((long long)b * S + t) * 4 * nhd + (long long)head * hd + u0 + u;
      dst[0] = dz;
      dst[nhd] = di_t;
      dst[2 * nhd] = df_t;
      dst[3 * nhd] = d_o;
      car[i] = dc * f_g;
      car[BU + i] = dn * f_g;
      car[2 * BU + i] = dmp;
    }
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
    }
  }
  __syncthreads();
  for (int i = tid; i < BU; i += nthr) {
    const int b = i / U, u = i % U;
    if (u < nu) p.dh0[((long long)b * nh + head) * hd + u0 + u] = dhr[i];
  }
}

}  // namespace

// r: (nh, hd, 4 hd) fp32 contiguous; pre: (B, S, 4, nh, hd), c, n, m, dh:
// (B, S, nh, hd), fp32 contiguous, as the forward's training variant wrote
// them (dh the upstream gradient on h); c0, n0, m0: the initial (B, nh, hd)
// state, fp32 contiguous, all three or none (null: zeros and m = -1e30);
// dwx: (B, S, 4, nh, hd) and dh0: (B, nh, hd) fp32 contiguous outputs;
// arrivals: nh zeroed counters.  units (U) and slices (J, a power of two up to
// 16) come from the wrapper's plan_bwd: ceil(hd / U) blocks a head of U x J
// threads.  Writes the dynamic shared memory a block takes to *smem_bytes and
// the blocks the card holds at once to *resident, and returns
// cudaErrorCooperativeLaunchTooLarge, launching nothing, when the grid
// exceeds them; else the launch's cudaError_t.
extern "C" int slstm_scan_bwd(const float* r, const float* pre,
                              const float* c, const float* n, const float* m,
                              const float* dh, const float* c0,
                              const float* n0, const float* m0, float* dwx,
                              float* dh0, unsigned* arrivals, int B, int S,
                              int nh, int hd, int units, int slices,
                              int* smem_bytes, int* resident,
                              cudaStream_t stream) {
  *smem_bytes = 0;
  *resident = 0;
  if (B < 1 || S < 1 || nh < 1 || hd < 1 || units < 1 || slices < 1 ||
      (long long)units * slices > kMaxThreads || !c0 != !n0 || !c0 != !m0)
    return (int)cudaErrorInvalidValue;
  const int groups = (hd + units - 1) / units;
  if ((long long)S * groups >= (1ll << 32)) return (int)cudaErrorInvalidValue;
  const Layout L = make_layout(B, hd, units, slices);
  const long long smem = (long long)L.total * sizeof(float);
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
  const int threads = units * slices;
  const void* fn = nullptr;
  switch (slices) {
    case 1: fn = (const void*)slstm_scan_bwd_kernel<1>; break;
    case 2: fn = (const void*)slstm_scan_bwd_kernel<2>; break;
    case 4: fn = (const void*)slstm_scan_bwd_kernel<4>; break;
    case 8: fn = (const void*)slstm_scan_bwd_kernel<8>; break;
    case 16: fn = (const void*)slstm_scan_bwd_kernel<16>; break;
    default: return (int)cudaErrorInvalidValue;
  }
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads,
                                                      (size_t)smem);
  if (e != cudaSuccess) return (int)e;
  *resident = per_sm * n_sm;
  const int grid = nh * groups;
  if (grid > *resident) return (int)cudaErrorCooperativeLaunchTooLarge;
  Params p{r, pre, c, n, m, dh, c0, n0, m0, dwx, dh0, arrivals,
           B, S, nh, hd, units, groups};
  void* args[] = {&p};
  return (int)cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(threads), args,
                                          (size_t)smem, stream);
}
