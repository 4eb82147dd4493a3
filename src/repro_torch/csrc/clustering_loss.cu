// Eq. (5) clustering regularization, forward and backward, for Hopper
// (sm_90a).  Built by repro_torch/kernels/build.py into a shared library with
// a plain C interface and bound with ctypes (repro_torch/kernels/
// clustering_loss.py).
//
// Replaces the TPU kernels in src/repro/kernels/clustering_loss.py:
//   clustering_fwd  <- _fwd_kernel (the pallas_call in _run_fwd) plus the
//                      loss reduction of _fwd;
//   clustering_bwd  <- _bwd_kernel (the pallas_call in _run_bwd).
//
// z (B, d) anchors against the queue (Q, d).  The forward keeps, per anchor,
// an online logsumexp over the valid queue entries, the sum of the positive
// logits and the positive count, without materializing the (B, Q) logits.
// The backward recomputes the softmax from the saved lse and accumulates
// dz = g/denom/kappa * [softmax - pos/n_pos] @ queue_z.
//
// What bounds it: at the training round's shape (B = 320, Q = 2048, d = 64) the
// forward is 2*B*Q*d = 84 MFLOP of fp32 arithmetic on 0.6 MB of inputs, so it
// is bound by fp32 operations (about 1.3 us at the 67 TFLOP/s an H100 SXM
// publishes for 700 W), not by bytes (0.2 us at its 3.35 TB/s).  The TPU's
// sequential queue axis becomes a loop inside the block, since blocks carry
// nothing between them: one warp per anchor, eight anchors per block sharing
// each queue tile staged in shared memory (rows padded to d + 1 floats so the
// 32 lanes, each on its own queue row, hit 32 different banks).  Every lane
// keeps its own online (max, sum) over its queue entries; the lanes merge with
// shuffles at the end.  The ragged B and Q edges are masked here rather than
// padded by the caller.  Simple and right first: wgmma/TMA and splitting Q over
// more blocks (only B/8 = 40 blocks at this shape) are later work.
//
// The running max starts at the -1e30 sentinel, not -INFINITY: with -inf,
// exp(m_prev - m_new) is NaN for a lane whose first entries are all invalid.
// An empty queue then gives loss 0.
//
// No allocation and no synchronisation here; each entry point launches on
// the caller's stream and returns cudaGetLastError().
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;               // anchors per block, one warp each
constexpr int kThreads = kWarps * 32;
constexpr int kTileQ = 64;              // queue entries per shared tile
constexpr int kMaxD = 128;
constexpr int kDimsPerLane = kMaxD / 32;
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

struct QueueTile {
  float qz[kTileQ][kMaxD + 1];          // +1: conflict-free column reads
  int label[kTileQ];
  int mask[kTileQ];                     // 0 invalid, 1 valid, 2 valid+conf
};

__device__ void load_tile(QueueTile& t, const float* __restrict__ qz,
                          const int* __restrict__ qlab,
                          const unsigned char* __restrict__ qconf,
                          const unsigned char* __restrict__ qvalid,
                          int q0, int Q, int d) {
  for (int i = threadIdx.x; i < kTileQ * d; i += kThreads) {
    const int j = i / d, k = i - j * d;
    const int qj = q0 + j;
    t.qz[j][k] = qj < Q ? qz[(size_t)qj * d + k] : 0.f;
  }
  for (int j = threadIdx.x; j < kTileQ; j += kThreads) {
    const int qj = q0 + j;
    const bool valid = qj < Q && qvalid[qj];
    t.label[j] = qj < Q ? qlab[qj] : -2;
    t.mask[j] = valid ? (qconf[qj] ? 2 : 1) : 0;
  }
}

__device__ float dot_row(const float* zrow, const float* qrow, int d) {
  float acc = 0.f;
  for (int k = 0; k < d; ++k) acc += zrow[k] * qrow[k];
  return acc;
}

__global__ void __launch_bounds__(kThreads)
fwd_kernel(const float* __restrict__ z, const int* __restrict__ pseudo,
           const unsigned char* __restrict__ aok,
           const float* __restrict__ qz, const int* __restrict__ qlab,
           const unsigned char* __restrict__ qconf,
           const unsigned char* __restrict__ qvalid, int B, int Q, int d,
           float inv_temp, float* __restrict__ pos_sum,
           float* __restrict__ n_pos, float* __restrict__ lse) {
  __shared__ QueueTile tile;
  __shared__ float zs[kWarps][kMaxD];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int a = blockIdx.x * kWarps + warp;
  const bool live = a < B;
  for (int k = lane; k < d; k += 32) zs[warp][k] = live ? z[(size_t)a * d + k] : 0.f;
  const int my_label = live ? pseudo[a] : -1;
  const bool my_ok = live && aok[a];

  float m = kNegInf, l = 0.f, ps = 0.f, pc = 0.f;
  for (int q0 = 0; q0 < Q; q0 += kTileQ) {
    __syncthreads();                    // the previous tile is consumed
    load_tile(tile, qz, qlab, qconf, qvalid, q0, Q, d);
    __syncthreads();
    for (int j = lane; j < kTileQ; j += 32) {
      const int mk = tile.mask[j];
      if (mk == 0) continue;
      const float logit = dot_row(zs[warp], tile.qz[j], d) * inv_temp;
      if (logit > m) {
        l = l * expf(m - logit) + 1.f;
        m = logit;
      } else {
        l += expf(logit - m);
      }
      if (mk == 2 && my_ok && tile.label[j] == my_label) {
        ps += logit;
        pc += 1.f;
      }
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(kFull, m, off);
    const float l2 = __shfl_xor_sync(kFull, l, off);
    const float ps2 = __shfl_xor_sync(kFull, ps, off);
    const float pc2 = __shfl_xor_sync(kFull, pc, off);
    const float mn = fmaxf(m, m2);
    l = l * expf(m - mn) + l2 * expf(m2 - mn);
    m = mn;
    ps += ps2;
    pc += pc2;
  }
  if (live && lane == 0) {
    pos_sum[a] = ps;
    n_pos[a] = pc;
    lse[a] = m + logf(l == 0.f ? 1.f : l);
  }
}

// loss = sum over anchors with positives of (lse - pos_sum/n_pos), divided by
// denom = max(#anchors with positives, 1).  One block, a fixed reduction
// order: the same inputs give the same bits on every run.
constexpr int kFinalThreads = 256;

__global__ void __launch_bounds__(kFinalThreads)
finalize_kernel(const float* __restrict__ pos_sum,
                const float* __restrict__ n_pos,
                const float* __restrict__ lse, int B,
                float* __restrict__ loss, float* __restrict__ denom) {
  __shared__ float ss[kFinalThreads], cs[kFinalThreads];
  float s = 0.f, c = 0.f;
  for (int a = threadIdx.x; a < B; a += kFinalThreads) {
    if (n_pos[a] > 0.f) {
      s += -(pos_sum[a] / n_pos[a]) + lse[a];
      c += 1.f;
    }
  }
  ss[threadIdx.x] = s;
  cs[threadIdx.x] = c;
  __syncthreads();
  for (int w = kFinalThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) {
      ss[threadIdx.x] += ss[threadIdx.x + w];
      cs[threadIdx.x] += cs[threadIdx.x + w];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const float dn = fmaxf(cs[0], 1.f);
    *denom = dn;
    *loss = ss[0] / dn;
  }
}

__global__ void __launch_bounds__(kThreads)
bwd_kernel(const float* __restrict__ z, const int* __restrict__ pseudo,
           const unsigned char* __restrict__ aok,
           const float* __restrict__ qz, const int* __restrict__ qlab,
           const unsigned char* __restrict__ qconf,
           const unsigned char* __restrict__ qvalid, int B, int Q, int d,
           float inv_temp, const float* __restrict__ lse,
           const float* __restrict__ n_pos, const float* __restrict__ g,
           const float* __restrict__ denom, float* __restrict__ dz) {
  __shared__ QueueTile tile;
  __shared__ float zs[kWarps][kMaxD];
  __shared__ float coef[kWarps][kTileQ];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int a = blockIdx.x * kWarps + warp;
  const bool live = a < B;
  for (int k = lane; k < d; k += 32) zs[warp][k] = live ? z[(size_t)a * d + k] : 0.f;
  const int my_label = live ? pseudo[a] : -1;
  const bool my_ok = live && aok[a];
  const float np = live ? n_pos[a] : 0.f;
  const bool has = np > 0.f;             // anchors without positives get 0
  const float inv_np = 1.f / (has ? np : 1.f);
  const float my_lse = live ? lse[a] : 0.f;
  const float gscale = *g / *denom;

  float acc[kDimsPerLane];
#pragma unroll
  for (int i = 0; i < kDimsPerLane; ++i) acc[i] = 0.f;

  for (int q0 = 0; q0 < Q; q0 += kTileQ) {
    __syncthreads();                    // tile and coef are consumed
    load_tile(tile, qz, qlab, qconf, qvalid, q0, Q, d);
    __syncthreads();
    for (int j = lane; j < kTileQ; j += 32) {
      float c = 0.f;
      const int mk = tile.mask[j];
      if (has && mk > 0) {
        const float logit = dot_row(zs[warp], tile.qz[j], d) * inv_temp;
        const float w = expf(logit - my_lse);
        const float p =
            (mk == 2 && my_ok && tile.label[j] == my_label) ? inv_np : 0.f;
        c = (w - p) * gscale * inv_temp;
      }
      coef[warp][j] = c;
    }
    __syncwarp();
    if (has) {
      for (int j = 0; j < kTileQ; ++j) {
        const float c = coef[warp][j];
#pragma unroll
        for (int i = 0; i < kDimsPerLane; ++i) {
          const int k = lane + 32 * i;
          if (k < d) acc[i] += c * tile.qz[j][k];
        }
      }
    }
  }
  if (live) {
#pragma unroll
    for (int i = 0; i < kDimsPerLane; ++i) {
      const int k = lane + 32 * i;
      if (k < d) dz[(size_t)a * d + k] = acc[i];
    }
  }
}

}  // namespace

extern "C" int clustering_fwd(const float* z, const int* pseudo,
                              const unsigned char* aok, const float* qz,
                              const int* qlab, const unsigned char* qconf,
                              const unsigned char* qvalid, int B, int Q, int d,
                              float inv_temp, float* pos_sum, float* n_pos,
                              float* lse, float* loss, float* denom,
                              void* stream) {
  if (B < 1 || Q < 0 || d < 1 || d > kMaxD) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (B + kWarps - 1) / kWarps;
  fwd_kernel<<<blocks, kThreads, 0, s>>>(z, pseudo, aok, qz, qlab, qconf,
                                         qvalid, B, Q, d, inv_temp, pos_sum,
                                         n_pos, lse);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  finalize_kernel<<<1, kFinalThreads, 0, s>>>(pos_sum, n_pos, lse, B, loss,
                                              denom);
  return (int)cudaGetLastError();
}

extern "C" int clustering_bwd(const float* z, const int* pseudo,
                              const unsigned char* aok, const float* qz,
                              const int* qlab, const unsigned char* qconf,
                              const unsigned char* qvalid, int B, int Q, int d,
                              float inv_temp, const float* lse,
                              const float* n_pos, const float* g,
                              const float* denom, float* dz, void* stream) {
  if (B < 1 || Q < 0 || d < 1 || d > kMaxD) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (B + kWarps - 1) / kWarps;
  bwd_kernel<<<blocks, kThreads, 0, s>>>(z, pseudo, aok, qz, qlab, qconf,
                                         qvalid, B, Q, d, inv_temp, lse, n_pos,
                                         g, denom, dz);
  return (int)cudaGetLastError();
}
