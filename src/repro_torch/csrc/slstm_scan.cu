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
// Design: one block per (head, batch row), one thread per hidden unit u
// (hd threads, at most 1024).  The head's h lives in shared memory, double
// buffered so that one __syncthreads() a step suffices: step t reads
// buffer t & 1 and writes buffer (t + 1) & 1.  Each step, thread u forms
// its unit's four recurrent sums from R's columns u, hd + u, 2 hd + u and
// 3 hd + u, read from global memory: neighbouring threads read neighbouring
// columns, so each row of R is one coalesced load per warp, and after the
// first step the head's R (hd x 4 hd fp32, 4 MiB at hd 512) is served from
// L2, which holds all four heads of xlstm-1.3b (16 MiB of its 50 MB).  The
// next step's four wx inputs are loaded before the sums, to hide their
// latency.  wx is read through its batch, time, gate and head strides (the
// unit dim must be contiguous), so the model's (B, S, 4d) projection goes
// in as a (B, S, 4, nh, hd) view with no transposed copy.
//
// What bounds it: at the serve shape, wx (4, 2048, 4, 4, 512), the
// recurrent products are 2 B S nh hd 4hd = 6.9e10 operations on about
// 0.35 GB, so operations bound it: 1.03 ms at the 67 TFLOP/s fp32 rate.
// The R of a head does not fit in shared memory (227 KB an SM) as it sat in
// VMEM on the TPU, so this simple kernel re-reads it from L2 every step,
// 4 MiB a step per block on 16 of the 132 SMs: it is bound by each SM's L2
// read rate and sits far off the bound.  Splitting a head across a cluster
// of blocks (h exchanged through distributed shared memory each step) is
// later work.
//
// Built without --use_fast_math: with m = -1e30, exp(f + m - m') must give
// 0 and not NaN, and c / n is an IEEE division.
//
// No allocation and no synchronisation here: the entry point launches on
// the caller's stream and returns cudaGetLastError().
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kNegInit = -1e30f;
constexpr int kMaxThreads = 1024;

__global__ void slstm_scan_kernel(
    const float* __restrict__ wx, long long wx_sb, long long wx_st,
    long long wx_sg, long long wx_sh, const float* __restrict__ r,
    const float* __restrict__ h0, const float* __restrict__ c0,
    const float* __restrict__ n0, const float* __restrict__ m0,
    float* __restrict__ h_out, float* __restrict__ h_fin,
    float* __restrict__ c_fin, float* __restrict__ n_fin,
    float* __restrict__ m_fin, int S, int nh, int hd) {
  extern __shared__ float h_buf[];  // 2 x hd: h_{t-1} and h_t
  const int head = blockIdx.x;
  const int b = blockIdx.y;
  const int u = threadIdx.x;
  const long long st = ((long long)b * nh + head) * hd + u;  // (B, nh, hd)

  float h = h0 ? h0[st] : 0.f;
  float c = c0 ? c0[st] : 0.f;
  float n = n0 ? n0[st] : 0.f;
  float m = m0 ? m0[st] : kNegInit;
  h_buf[u] = h;

  const float* rc = r + (long long)head * hd * 4 * hd + u;  // column u
  const long long r_row = 4LL * hd;
  const float* wxp = wx + b * wx_sb + head * wx_sh + u;
  float* hp_out = h_out + (long long)b * S * nh * hd + (long long)head * hd + u;
  const long long h_step = (long long)nh * hd;

  float wz = wxp[0], wi = wxp[wx_sg], wf = wxp[2 * wx_sg],
        wo = wxp[3 * wx_sg];
  __syncthreads();

  for (int t = 0; t < S; ++t) {
    const float* hprev = h_buf + (t & 1) * hd;
    const float xz = wz, xi = wi, xf = wf, xo = wo;
    if (t + 1 < S) {  // the next step's inputs, loaded ahead
      const float* p = wxp + (long long)(t + 1) * wx_st;
      wz = p[0];
      wi = p[wx_sg];
      wf = p[2 * wx_sg];
      wo = p[3 * wx_sg];
    }
    float az = 0.f, ai = 0.f, af = 0.f, ao = 0.f;
    const float* row = rc;
#pragma unroll 4
    for (int k = 0; k < hd; ++k, row += r_row) {
      const float hk = hprev[k];
      az = fmaf(hk, row[0], az);
      ai = fmaf(hk, row[hd], ai);
      af = fmaf(hk, row[2 * hd], af);
      ao = fmaf(hk, row[3 * hd], ao);
    }
    const float zt = xz + az, it = xi + ai, ft = xf + af, ot = xo + ao;
    const float m_new = fmaxf(ft + m, it);
    const float i_g = expf(it - m_new);
    const float f_g = expf(ft + m - m_new);
    c = f_g * c + i_g * tanhf(zt);
    n = f_g * n + i_g;
    const float sig = 1.f / (1.f + expf(-ot));
    h = sig * c / fmaxf(n, 1e-6f);
    m = m_new;
    hp_out[(long long)t * h_step] = h;
    h_buf[((t + 1) & 1) * hd + u] = h;
    __syncthreads();
  }
  h_fin[st] = h;
  c_fin[st] = c;
  n_fin[st] = n;
  m_fin[st] = m;
}

}  // namespace

// wx: fp32, addressed as (B, S, 4, nh, hd) through the strides (in elements)
// of its first four dims, the unit dim contiguous; r: (nh, hd, 4 hd) fp32
// contiguous; h0, c0, n0, m0: (B, nh, hd) fp32 contiguous, all four or none
// (null); h_out: (B, S, nh, hd) fp32 contiguous; h_fin, c_fin, n_fin, m_fin:
// (B, nh, hd) fp32 contiguous.  Returns the launch's cudaError_t.
extern "C" int slstm_scan_fwd(const float* wx, long long wx_sb,
                              long long wx_st, long long wx_sg,
                              long long wx_sh, const float* r,
                              const float* h0, const float* c0,
                              const float* n0, const float* m0, float* h_out,
                              float* h_fin, float* c_fin, float* n_fin,
                              float* m_fin, int B, int S, int nh, int hd,
                              cudaStream_t stream) {
  if (B < 1 || S < 1 || nh < 1 || hd < 1 || hd > kMaxThreads)
    return (int)cudaErrorInvalidValue;
  dim3 grid(nh, B);
  const size_t smem = 2 * (size_t)hd * sizeof(float);
  slstm_scan_kernel<<<grid, hd, smem, stream>>>(
      wx, wx_sb, wx_st, wx_sg, wx_sh, r, h0, c0, n0, m0, h_out, h_fin, c_fin,
      n_fin, m_fin, S, nh, hd);
  return (int)cudaGetLastError();
}
