// The sLSTM recurrence (xLSTM's scalar-memory block) for Hopper (sm_90a).
// Built by repro_torch/kernels/build.py into a shared library with a plain C
// interface and bound with ctypes (repro_torch/kernels/slstm_scan.py).
//
// Replaces the TPU kernel in src/repro/kernels/slstm_scan.py (slstm_scan ->
// _slstm_kernel), and computes what it computes, per batch row b and head:
//   pre_t   = wx[b, t, :, head, :] + (h_{t-1} . R[head]).reshape(4, hd)
//   z, i, f, o = pre_t                      (gate-major, each hd wide)
//   m_t = max(f + m_{t-1}, i),  i_g = exp(i - m_t),  f_g = exp(f + m_{t-1} - m_t)
//   c_t = f_g c_{t-1} + i_g tanh(z),  n_t = f_g n_{t-1} + i_g
//   h_t = sigmoid(o) c_t / max(n_t, 1e-6)
// all in fp32.  Where the TPU kernel starts from zeros (m = -1e30) and
// returns h only, this one also takes an initial (h, c, n, m) and writes the
// final one, which the model's prefill hands on to decode.  With no initial
// state (null pointers) it starts from h = c = n = 0 and m = -1e30.
//
// What bounds it: at the serve shape, wx (4, 2048, 4, 4, 512), the
// recurrent products are 2 B S nh hd 4hd = 6.87e10 fp32 operations, 1.03 ms
// at the 67 TFLOP/s fp32 rate; its bytes (wx, R, h and the state, 352.5 MB)
// take 0.105 ms at 3.35 TB/s.  But its 2048 steps depend on each other, and
// each needs every unit of the previous h, so it is bound by the latency of
// a step: the math of one step over as many SMs as hold R, plus one
// exchange of h between them.  Estimated per step at the serve shape: 4 x
// 64 x 512 = 131k FMAs a block, about 1,000 clocks on an SM's 128 fp32
// lanes (0.55 us), plus an L2 round trip for h and the barrier, about 1-2
// us; 3-10 ms a launch.
//
// Design: the TPU kernel keeps a head's R (hd x 4 hd fp32, 4 MiB at hd 512)
// in VMEM for all S steps.  No SM holds 4 MiB, but the 4 heads' 16 MiB fit
// on 128 SMs.  So each head's hd units are split into groups of U units,
// one block a group (U 16 at the serve shape: 32 blocks a head, 128 blocks
// on the 132 SMs), and a block loads R's columns of its U units in all four
// gates (hd x 4U fp32, 128 KiB) into shared memory once, transposed.  Its
// U x J threads split the hd-long sums into J k-slices (16 at the serve
// shape), the J slices of a unit on neighbouring lanes; the first kRegK (28)
// rows of a thread's slice of R also sit in registers, so at the serve
// shape (slices of 32 rows) a step reads 28 of 32 rows from registers and 4
// from shared memory.  Each block takes all B batch rows, in passes of 4, so
// each R element feeds 4 FMAs: thread (u, j) forms unit u's four gate sums
// over slice j for the pass's rows (16 sums in registers, float4 reads of
// the broadcast h), a butterfly of warp shuffles adds the slices in a fixed
// order (so two launches agree bit for bit), and B x U threads apply the
// gates, keeping h, c, n and m in shared memory for the whole run.  Slices
// are stored with a stride of an odd count of float4s, so the float4 reads
// of neighbouring slices fall in distinct banks.
//
// A step needs the whole h_{t-1} of its head, written by the head's other
// blocks.  h_out is the exchange buffer: each step's h lands in a row that
// no block has read before, so no block can overwrite what another may
// still read, and one barrier a step among a head's blocks suffices.  As
// CUTLASS's generic barrier does, a block publishes its units of h_t, after
// a __syncthreads, with one release add to its head's arrival counter, and
// before step t + 1 one thread waits with acquire loads until the counter
// shows all of the head's blocks, then a __syncthreads; the h rows are read
// through L2 (ld.global.cg), never through L1, which is not coherent across
// SMs.  (A __threadfence on either side, or cooperative groups' grid-wide
// sync over all heads' blocks, was slower.)  The next steps' wx inputs are
// copied into a ring in shared memory with cp.async, 3 steps ahead, off the
// critical path.  A wait gives up after 2^35 clocks (over 15 s) and traps,
// so a barrier fault becomes a launch error and not a hung card.  The
// barrier needs every block resident at once: the grid goes out with
// cudaLaunchCooperativeKernel, which refuses a grid that cannot be, after
// the entry point has checked the occupancy itself.
//
// Why not a thread block cluster: a cluster holds at most 16 blocks, so a
// head's R over one cluster is 256 KiB of fp32 a block, over the 227 KB of
// shared memory; only a split between shared memory and registers could
// hold it.  A barrier over co-resident blocks lets R spread over 32 SMs a
// head.
//
// For training the entry point also takes four output pointers: each step's
// gate pre-activations pre_t = (z~, i~, f~, o~) as (B, S, 4, nh, hd), and c_t,
// n_t and m_t as (B, S, nh, hd), which csrc/slstm_scan_bwd.cu reads going
// back.  The gates write them beside h; with null pointers (serving, the
// teacher's pass) nothing more is written.
//
// Built with -DSLSTM_PROFILE, the first block's thread 0 adds up the clocks
// of each phase of a step, read back by slstm_scan_profile()
// (repro_torch/kernels/slstm_scan.py's step_profile); without it the
// kernel has no trace of that.
//
// Built without --use_fast_math: with m = -1e30, exp(f + m - m') must give
// 0 and not NaN, and c / n is an IEEE division.
//
// No allocation and no synchronisation here: the entry point launches on
// the caller's stream and returns the launch's cudaError_t.  The caller
// allocates the arrival counters, zeroed, one per head.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "slstm_common.cuh"  // the barrier, butterfly and cp.async helpers

#ifdef SLSTM_PROFILE
constexpr int kPhases = 10;
__device__ long long g_phase_clocks[kPhases];
#define PHASE(k)                                  \
  if (prof_on) {                                  \
    const long long now = clock64();              \
    phase_clocks[k] += now - phase_last;          \
    phase_last = now;                             \
  }
#else
#define PHASE(k)
#endif

namespace {

constexpr float kNegInit = -1e30f;
constexpr int kRows = 4;        // batch rows a pass: 4 gates x 4 rows of sums
constexpr int kRing = 4;        // wx ring slots: steps t .. t + 3
constexpr int kMaxThreads = 256;
constexpr int kRegK = 28;       // rows of a thread's slice of R in registers
constexpr long long kSpinClocks = 1ll << 35;

// The shared-memory layout, in floats, for B rows, hd units, U units a
// block and J k-slices; repro_torch/kernels/slstm_scan.py's plan() computes
// the same total.  A slice of k_slice rows is stored in slice_stride floats,
// a stride whose count of float4s is odd, so that the float4 reads of J
// neighbouring lanes, one slice each, fall in distinct banks.
struct Layout {
  int k_slice, slice_stride, r_stride, h_stride;
  int h_off, pre_off, wx_off, st_off, total;
};

__host__ __device__ inline Layout make_layout(int B, int hd, int U, int J) {
  Layout L;
  L.k_slice = 4 * ((hd + 4 * J - 1) / (4 * J));
  L.slice_stride = L.k_slice + ((L.k_slice / 4) % 2 ? 8 : 4);
  L.r_stride = J * L.slice_stride;                     // a column of R
  L.h_stride = J * L.slice_stride;                     // a row of h
  L.h_off = 4 * U * L.r_stride;                        // R^T: 4U rows
  L.pre_off = L.h_off + (B + kRows - 1) / kRows * kRows * L.h_stride;
  L.wx_off = L.pre_off + kRows * 4 * U;                // gate inputs
  L.st_off = L.wx_off + kRing * B * 4 * U;             // wx ring
  L.total = L.st_off + 4 * B * U;                      // h, c, n, m
  return L;
}

struct Params {
  const float* wx;
  long long wx_sb, wx_st, wx_sg, wx_sh;
  const float* r;
  const float *h0, *c0, *n0, *m0;
  float *h_out, *h_fin, *c_fin, *n_fin, *m_fin;
  float *pre_out, *c_out, *n_out, *m_out;   // all four or none (null)
  unsigned* arrivals;
  int B, S, nh, hd, units, groups;
};

__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;" :: "n"(kRing - 1) : "memory");
}

template <int J>
__global__ void __launch_bounds__(kMaxThreads, 1)
slstm_scan_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int B = p.B, S = p.S, nh = p.nh, hd = p.hd, U = p.units;
  const Layout L = make_layout(B, hd, U, J);
  const int KS = L.k_slice, SS = L.slice_stride, BU = B * U, B4U = B * 4 * U;
  float* rt = smem;                  // rt[(g U + u) r_stride + j SS + k] = R[j KS + k, g hd + u0 + u]
  float* hs = smem + L.h_off;        // hs[b h_stride + j SS + k] = h_{t-1}[b, j KS + k]
  float* pre = smem + L.pre_off;     // pre[(bb 4 + g) U + u]
  float* wxs = smem + L.wx_off;      // wxs[slot][(b 4 + g) U + u]
  float* st = smem + L.st_off;       // st[q B U + b U + u], q = h, c, n, m
  const int nthr = U * J, tid = threadIdx.x;
  const int ul = tid / J, j = tid % J;     // this thread's unit and k-slice
  const int head = blockIdx.x / p.groups;
  const int u0 = (blockIdx.x % p.groups) * U;
  const int nu = min(U, hd - u0);    // the last group of a head may be ragged
  const bool mine = ul < nu;         // this thread's unit exists
  const int warp_n = min(32, nthr - (tid & ~31));
  const unsigned lanes = warp_n == 32 ? 0xffffffffu : (1u << warp_n) - 1;

  // R's columns of this block's units, transposed, zero past hd and nu; a
  // warp reads U neighbouring columns of a row of R
  const float* rh = p.r + (long long)head * hd * 4 * hd + u0;
  for (int i = tid; i < J * KS * 4 * U; i += nthr) {
    const int u = i % U, g = (i / U) % 4, k = i / (4 * U);
    rt[(g * U + u) * L.r_stride + (k / KS) * SS + k % KS] =
        (k < hd && u < nu) ? rh[(long long)k * 4 * hd + g * hd + u] : 0.f;
  }
  for (int i = tid; i < L.pre_off - L.h_off; i += nthr) hs[i] = 0.f;
  for (int b = j; b < B; b += J) {
    if (!mine) continue;
    const long long s = ((long long)b * nh + head) * hd + u0 + ul;
    const int i = b * U + ul;
    st[i] = p.h0 ? p.h0[s] : 0.f;
    st[BU + i] = p.c0 ? p.c0[s] : 0.f;
    st[2 * BU + i] = p.n0 ? p.n0[s] : 0.f;
    st[3 * BU + i] = p.m0 ? p.m0[s] : kNegInit;
  }
  __syncthreads();
  // the first kRegK rows of the thread's slice, also in registers
  const float* rrow = rt + ul * L.r_stride + j * SS;
  const bool use_reg = KS >= kRegK;
  float rreg[4][kRegK];
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int k = 0; k < kRegK; ++k)
      rreg[g][k] = use_reg ? rrow[g * U * L.r_stride + k] : 0.f;

  // step t's gate inputs into ring slot t % kRing, one row (b, g) of U
  // units a slice; one commit group a step
  auto issue_wx = [&](int t) {
    if (t < S && mine) {
      float* dst = wxs + (t % kRing) * B4U + ul;
      const float* src = p.wx + (long long)t * p.wx_st + head * p.wx_sh + u0 + ul;
      for (int row = j; row < 4 * B; row += J)
        cp_async4(dst + row * U, src + (row >> 2) * p.wx_sb + (row & 3) * p.wx_sg);
    }
    cp_async_commit();
  };
  for (int t = 0; t < kRing - 1; ++t) issue_wx(t);

  // the h rows this thread copies each step: float4s i = tid + q nthr
  // of the B x hd / 4, when hd is a multiple of 4 and they take at most 4
  const bool h_vec = (hd & 3) == 0 && B * (hd / 4) <= 4 * nthr;
  int h_b[4], h_k[4], h_d[4];          // row, unit, place in hs
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int i = tid + q * nthr, n4 = max(hd / 4, 1);
    h_b[q] = i < B * (hd / 4) ? i / n4 : -1;
    h_k[q] = 4 * (i % n4);
    h_d[q] = (i / n4) * L.h_stride + (h_k[q] / KS) * SS + h_k[q] % KS;
  }
  const long long hrow_b = (long long)S * nh * hd;  // h_out's batch stride

#ifdef SLSTM_PROFILE
  const bool prof_on = tid == 0 && blockIdx.x == 0;
  long long phase_clocks[kPhases] = {0}, phase_last = clock64();
#endif
  for (int t = 0; t < S; ++t) {
    PHASE(9);                          // the previous step's publish
    issue_wx(t + kRing - 1);
    PHASE(0);
    // wait for every block of the head to have published h_{t-1}
    if (t > 0 && tid == 0) {
      const unsigned want = (unsigned)t * (unsigned)p.groups;
      const long long c0 = clock64();
      while (ld_acquire(p.arrivals + head) < want)
        if (clock64() - c0 > kSpinClocks) __trap();
    }
    PHASE(1);
    __syncthreads();
    PHASE(2);
    // h_{t-1} of the head, all B rows, through L2
    const float* src = t == 0 ? p.h0 : p.h_out + ((long long)(t - 1) * nh + head) * hd;
    const long long src_b = t == 0 ? (long long)nh * hd : hrow_b;
    if (t == 0 && src) src += head * hd;
    if (src && h_vec && (((uintptr_t)src) & 15) == 0) {
      float4 v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (h_b[q] >= 0)
          v[q] = __ldcg(reinterpret_cast<const float4*>(src + h_b[q] * src_b + h_k[q]));
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (h_b[q] >= 0)
          *reinterpret_cast<float4*>(hs + h_d[q]) = v[q];
    } else if (src) {
      const int tot = B * hd;
      for (int i0 = tid; i0 < tot; i0 += 4 * nthr) {
        float v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = i0 + q * nthr;
          if (i < tot) v[q] = __ldcg(src + (i / hd) * src_b + i % hd);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = i0 + q * nthr, k = i % hd;
          if (i < tot) hs[(i / hd) * L.h_stride + (k / KS) * SS + k % KS] = v[q];
        }
      }
    }
    PHASE(3);
    cp_async_wait_ring();   // this thread's copies of step t's wx are in
    __syncthreads();
    PHASE(4);
    const float* wxt = wxs + (t % kRing) * B4U;
    float* h_t = p.h_out + ((long long)t * nh + head) * hd + u0 + ul;

    for (int b0 = 0; b0 < B; b0 += kRows) {
      // unit ul's four gate sums over slice j for rows b0 .. b0 + 3
      float acc[4][kRows];
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int bb = 0; bb < kRows; ++bb) acc[g][bb] = 0.f;
      const float* hrow = hs + b0 * L.h_stride + j * SS;
      if (use_reg) {
#pragma unroll
        for (int k = 0; k < kRegK; k += 4) {
          float4 hv[kRows];
#pragma unroll
          for (int bb = 0; bb < kRows; ++bb)
            hv[bb] = *reinterpret_cast<const float4*>(hrow + bb * L.h_stride + k);
#pragma unroll
          for (int g = 0; g < 4; ++g)
#pragma unroll
            for (int bb = 0; bb < kRows; ++bb) {
              float a = acc[g][bb];
              a = fmaf(hv[bb].x, rreg[g][k], a);
              a = fmaf(hv[bb].y, rreg[g][k + 1], a);
              a = fmaf(hv[bb].z, rreg[g][k + 2], a);
              a = fmaf(hv[bb].w, rreg[g][k + 3], a);
              acc[g][bb] = a;
            }
        }
      }
      for (int k = use_reg ? kRegK : 0; k < KS; k += 4) {
        float4 rv[4], hv[kRows];
#pragma unroll
        for (int g = 0; g < 4; ++g)
          rv[g] = *reinterpret_cast<const float4*>(rrow + g * U * L.r_stride + k);
#pragma unroll
        for (int bb = 0; bb < kRows; ++bb)
          hv[bb] = *reinterpret_cast<const float4*>(hrow + bb * L.h_stride + k);
#pragma unroll
        for (int g = 0; g < 4; ++g)
#pragma unroll
          for (int bb = 0; bb < kRows; ++bb) {
            float a = acc[g][bb];
            a = fmaf(hv[bb].x, rv[g].x, a);
            a = fmaf(hv[bb].y, rv[g].y, a);
            a = fmaf(hv[bb].z, rv[g].z, a);
            a = fmaf(hv[bb].w, rv[g].w, a);
            acc[g][bb] = a;
          }
      }
      PHASE(5);
      // the J slices of unit ul lie on J neighbouring lanes: a butterfly
      // leaves each lane 16 / J of the 16 sums q = 4 bb + g, added over the
      // slices in a fixed order; lane j holds q = rev(j) + i, i < 16 / J,
      // rev reversing j's 4 bits
      float v[16];
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int bb = 0; bb < kRows; ++bb) v[bb * 4 + g] = acc[g][bb];
      if (J > 1) butterfly<8>(v, j & 1, 1, lanes);
      if (J > 2) butterfly<4>(v, j & 2, 2, lanes);
      if (J > 4) butterfly<2>(v, j & 4, 4, lanes);
      if (J > 8) butterfly<1>(v, j & 8, 8, lanes);
      if (b0 > 0) __syncthreads();   // the last pass's gates have read pre
      const int q0 = __brev(j) >> 28;
#pragma unroll
      for (int i = 0; i < 16 / J; ++i) {
        const int q = q0 + i, b = b0 + (q >> 2);
        pre[q * U + ul] = (b < B && mine) ? wxt[(b * 4 + (q & 3)) * U + ul] + v[i] : 0.f;
      }
      __syncthreads();
      PHASE(6);
      // the gates of unit ul, for the rows bb = j, j + J, ... of this pass
      for (int bb = j; bb < kRows; bb += J) {
        const int b = b0 + bb;
        if (b >= B || !mine) continue;
        const float* pg = pre + bb * 4 * U + ul;
        const float zt = pg[0], it = pg[U], ft = pg[2 * U], ot = pg[3 * U];
        const int si = b * U + ul;
        float c = st[BU + si], n = st[2 * BU + si];
        const float m = st[3 * BU + si];
        const float m_new = fmaxf(ft + m, it);
        const float i_g = expf(it - m_new);
        const float f_g = expf(ft + m - m_new);
        c = f_g * c + i_g * tanhf(zt);
        n = f_g * n + i_g;
        const float sig = 1.f / (1.f + expf(-ot));
        const float h = sig * c / fmaxf(n, 1e-6f);
        st[si] = h;
        st[BU + si] = c;
        st[2 * BU + si] = n;
        st[3 * BU + si] = m_new;
        h_t[b * hrow_b] = h;
        if (p.pre_out) {
          const long long bt = (long long)b * S + t, unit = head * hd + u0 + ul;
          const long long o = bt * nh * hd + unit;
          float* po = p.pre_out + bt * 4 * nh * hd + unit;
          po[0] = zt;
          po[nh * hd] = it;
          po[2 * nh * hd] = ft;
          po[3 * nh * hd] = ot;
          p.c_out[o] = c;
          p.n_out[o] = n;
          p.m_out[o] = m_new;
        }
      }
    }
    PHASE(7);
    __syncthreads();
    PHASE(8);
    // publish this block's units of h_t
    if (t + 1 < S && tid == 0) red_release(p.arrivals + head, 1u);
  }

#ifdef SLSTM_PROFILE
  if (prof_on)
    for (int k = 0; k < kPhases; ++k) g_phase_clocks[k] = phase_clocks[k];
#endif
  for (int b = j; b < B; b += J) {
    if (!mine) continue;
    const long long s = ((long long)b * nh + head) * hd + u0 + ul;
    const int i = b * U + ul;
    p.h_fin[s] = st[i];
    p.c_fin[s] = st[BU + i];
    p.n_fin[s] = st[2 * BU + i];
    p.m_fin[s] = st[3 * BU + i];
  }
}

}  // namespace

#ifdef SLSTM_PROFILE
// The clocks of each phase of a step, summed over the steps of the last
// launch, in its first block: kPhases values.
extern "C" int slstm_scan_profile(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_phase_clocks,
                                   sizeof(g_phase_clocks));
}
#endif

// The card's SM count and the shared memory a block may opt in to, for the
// wrapper's plan.
extern "C" int slstm_scan_limits(int* n_sm, int* smem_optin) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(smem_optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return (int)e;
}

// wx: fp32, addressed as (B, S, 4, nh, hd) through the strides (in elements)
// of its first four dims, the unit dim contiguous; r: (nh, hd, 4 hd) fp32
// contiguous; h0, c0, n0, m0: (B, nh, hd) fp32 contiguous, all four or none
// (null); h_out: (B, S, nh, hd) fp32 contiguous; h_fin, c_fin, n_fin, m_fin:
// (B, nh, hd) fp32 contiguous; pre_out: (B, S, 4, nh, hd) and c_out, n_out,
// m_out: (B, S, nh, hd), fp32 contiguous, all four or none (null);
// arrivals: nh zeroed counters.  units (U) and
// slices (J, a power of two up to 16) come from the wrapper's plan:
// ceil(hd / U) blocks a head of U x J threads.  Writes the dynamic shared memory a block takes to
// *smem_bytes and the blocks the card holds at once to *resident, and
// returns cudaErrorCooperativeLaunchTooLarge, launching nothing, when the
// grid exceeds them; else the launch's cudaError_t.
extern "C" int slstm_scan_fwd(const float* wx, long long wx_sb,
                              long long wx_st, long long wx_sg,
                              long long wx_sh, const float* r,
                              const float* h0, const float* c0,
                              const float* n0, const float* m0, float* h_out,
                              float* h_fin, float* c_fin, float* n_fin,
                              float* m_fin, float* pre_out, float* c_out,
                              float* n_out, float* m_out,
                              unsigned* arrivals, int B, int S,
                              int nh, int hd, int units, int slices,
                              int* smem_bytes, int* resident,
                              cudaStream_t stream) {
  *smem_bytes = 0;
  *resident = 0;
  if (B < 1 || S < 1 || nh < 1 || hd < 1 || units < 1 || slices < 1 ||
      (long long)units * slices > kMaxThreads)
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
    case 1: fn = (const void*)slstm_scan_kernel<1>; break;
    case 2: fn = (const void*)slstm_scan_kernel<2>; break;
    case 4: fn = (const void*)slstm_scan_kernel<4>; break;
    case 8: fn = (const void*)slstm_scan_kernel<8>; break;
    case 16: fn = (const void*)slstm_scan_kernel<16>; break;
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
  if (!pre_out != !c_out || !pre_out != !n_out || !pre_out != !m_out)
    return (int)cudaErrorInvalidValue;
  Params p{wx, wx_sb, wx_st, wx_sg, wx_sh, r, h0, c0, n0, m0, h_out, h_fin,
           c_fin, n_fin, m_fin, pre_out, c_out, n_out, m_out, arrivals,
           B, S, nh, hd, units, groups};
  void* args[] = {&p};
  return (int)cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(threads), args,
                                          (size_t)smem, stream);
}
