// Eq. (5) clustering regularization, forward and backward, for Hopper
// (sm_90a).  Built by repro_torch/kernels/build.py into a shared library with
// a plain C interface and bound with ctypes (repro_torch/kernels/
// clustering_loss.py).
//
// Replaces the TPU kernels in src/repro/kernels/clustering_loss.py:
//   clustering_fwd  <- _fwd_kernel (the pallas_call in _run_fwd) plus the
//                      loss reduction of _fwd: clustering_fwd_partial, then
//                      clustering_fwd_merge;
//   clustering_bwd  <- _bwd_kernel (the pallas_call in _run_bwd):
//                      clustering_bwd_partial, then clustering_bwd_merge.
//
// z (B, d) anchors against the queue (Q, d).  The forward keeps, per anchor,
// the logsumexp over the valid queue entries, the sum of the positive logits
// and the positive count, without materializing the (B, Q) logits.  The
// backward recomputes the softmax from the saved lse and accumulates
// dz = g/denom/kappa * [softmax - pos/n_pos] @ queue_z.
//
// The design, against what made the first port slow (one warp an anchor,
// 40 blocks of 8 warps on 132 SMs, each walking the whole queue by scalar
// loads under an integer division, one dependent FMA chain a lane):
// - The grid tiles the (B, Q) logit matrix, kTileB anchors x kTileQ queue
//   entries a block of 4 warps: 16 Q-blocks x 20 B-tiles = 320 blocks at
//   the training round's shape (B 320, Q 2048, d 64), all resident at once,
//   2 or 3 an SM.  Each block writes a partial for its anchors: (max, sum of
//   exp, positive-logit sum, positive count) in the forward, a partial dz
//   row in the backward, into scratch the wrapper allocates.  A second
//   launch merges the partials in Q-block order (lse = M + log sum_j l_j
//   exp(m_j - M)) and, in the forward, reduces the loss in a fixed order.
//   No float atomics: the same inputs give the same bits on every run.
// - Both tiles go to shared memory by 16-byte cp.async, in commit groups of
//   kChunk float4 columns (32 of d), all issued before the math; the
//   products over one group run while the next group lands.  Row r of a
//   group is copy i >> 3, column i & 7: no integer division per element.
//   Rows past B or Q are zero-filled.  Where d is no multiple of 4 or a
//   base is off 16 bytes, plain loads stage the tiles instead.
// - Each thread computes 4 anchors x 4 queue entries of the tile's logits
//   over k, from float4 shared loads (16 FMAs per pair of loads), 16
//   independent accumulator chains.  The row statistics take the warp's
//   max by shuffles first, then one exp an entry and shuffled sums.  The
//   backward stages its (anchor x queue) coefficient tile in shared memory
//   and multiplies it by the queue tile, each thread holding 2 anchors x 4
//   columns of dz.
// - The backward reads n_pos on the device and does no work for a B-tile
//   without positives; the merge writes 0 for every anchor without one.
//
// What bounds it now: the forward is 2*B*Q*d = 84 MFLOP of fp32 on 0.6 MB at
// that shape, 1.3 us at the 67 TFLOP/s an H100 SXM publishes for 700 W, the
// backward twice that.  Both lie below the fixed cost of two launches, of
// the tiles' trip from L2 and of the merges' dependent L2 reads: a partial
// launch takes several times its share of the products, and removing
// either the products or the loads from it leaves most of its time.
// Tensor cores do not pay here: single-pass TF32 would miss the loss
// tolerance (logits are scaled by 1/kappa = 10), and split terms would
// cost more than the products take.
//
// Each partial's running max starts at the -1e30 sentinel, not -INFINITY:
// with -inf, exp(m_j - M) is NaN where every partial of an anchor is empty
// (m_j = M = -inf).  An empty queue then gives loss 0 and dz 0.
//
// No allocation and no synchronisation here; each entry point launches on
// the caller's stream and returns the first failing cudaGetLastError().
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTileB = 16;              // anchors a block
constexpr int kTileQ = 128;             // queue entries a block
constexpr int kRowsA = 4;               // anchors a thread: warp w, 4w..4w+3
constexpr int kRowsQ = kTileQ / 32;     // queue entries a thread: lane + 32 i
constexpr int kThreads = kTileB / kRowsA * 32;
constexpr int kRows = kTileB + kTileQ;  // staged rows: anchors, then queue
constexpr int kChunk = 8;               // float4 columns a cp.async group
constexpr int kMaxD = 128;
constexpr int kMergeThreads = 512;      // the forward's one merge block
constexpr int kSumRows = 8;             // anchors a block of the dz merge
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

static_assert(kRowsA == 4 && kRowsQ == 4, "the thread tile is 4 x 4");
static_assert(kRows * kChunk % kThreads == 0, "whole copy rounds");

// A staged row's stride in floats: the padded width plus 4 or 8, so that
// the stride is an odd number of 16-byte units and 8 lanes reading float4s
// of 8 consecutive rows hit 8 different bank groups.
__host__ __device__ inline int row_stride(int kq) {
  return 4 * (kq + ((kq & 1) ? 2 : 1));
}

__host__ inline size_t tile_bytes(int d) {
  return (size_t)kRows * row_stride((d + 3) / 4) * sizeof(float);
}

struct TileMeta {
  int qlab[kTileQ];
  int qmask[kTileQ];                    // 0 invalid, 1 valid, 2 valid+conf
  int alab[kTileB];
  int aok[kTileB];
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool fill) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(fill ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

// Stage anchors b0.. (rows 0..kTileB-1) and queue entries q0.. (the next
// kTileQ rows) of the padded width 4 kq, rows past B or Q as zeros.  kVec:
// cp.async, one commit group per kChunk columns, left in flight; else plain
// loads, complete at return (a __syncthreads still has to follow).
template <bool kVec>
__device__ void stage_tiles(float* tile, const float* __restrict__ z,
                            const float* __restrict__ qz, int b0, int q0,
                            int B, int Q, int d, int kq, int rs) {
  if (kVec) {
    for (int c = 0; c * kChunk < kq; ++c) {
#pragma unroll
      for (int n = 0; n < kRows * kChunk / kThreads; ++n) {
        const int i = threadIdx.x + n * kThreads;
        const int r = i / kChunk, f = c * kChunk + i % kChunk;
        if (f < kq) {
          const bool anchor = r < kTileB;
          const int g = anchor ? b0 + r : q0 + r - kTileB;
          const bool in = g < (anchor ? B : Q);
          const float* src = (anchor ? z : qz) + (size_t)(in ? g : 0) * d;
          cp_async16(tile + r * rs + 4 * f, src + 4 * f, in);
        }
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
  } else {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int r = warp; r < kRows; r += kThreads / 32) {
      const bool anchor = r < kTileB;
      const int g = anchor ? b0 + r : q0 + r - kTileB;
      const bool in = g < (anchor ? B : Q);
      const float* src = (anchor ? z : qz) + (size_t)(in ? g : 0) * d;
      for (int k = lane; k < 4 * kq; k += 32)
        tile[r * rs + k] = in && k < d ? src[k] : 0.f;
    }
  }
}

__device__ void load_meta(TileMeta& meta, const int* __restrict__ pseudo,
                          const unsigned char* __restrict__ aok,
                          const int* __restrict__ qlab,
                          const unsigned char* __restrict__ qconf,
                          const unsigned char* __restrict__ qvalid, int b0,
                          int q0, int B, int Q) {
  for (int t = threadIdx.x; t < kTileQ + kTileB; t += kThreads) {
    if (t < kTileQ) {
      const int qj = q0 + t;
      const bool in = qj < Q;
      meta.qlab[t] = in ? qlab[qj] : -2;
      meta.qmask[t] = in && qvalid[qj] ? (qconf[qj] ? 2 : 1) : 0;
    } else {
      const int a = b0 + t - kTileQ;
      const bool in = a < B;
      meta.alab[t - kTileQ] = in ? pseudo[a] : -1;
      meta.aok[t - kTileQ] = in && aok[a];
    }
  }
}

// acc[a][i] = <z row 4w + a, queue row lane + 32 i> over the padded width,
// waiting for each cp.async group before its columns (kVec).  Starts with a
// __syncthreads, so whatever was written to shared memory before is seen.
template <bool kVec>
__device__ void tile_logits(const float* tile, int kq, int rs,
                            float (&acc)[kRowsA][kRowsQ]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* za = tile + kRowsA * warp * rs;
  const float* qa = tile + (kTileB + lane) * rs;
#pragma unroll
  for (int a = 0; a < kRowsA; ++a)
#pragma unroll
    for (int i = 0; i < kRowsQ; ++i) acc[a][i] = 0.f;
  const int chunks = kVec ? (kq + kChunk - 1) / kChunk : 1;
  for (int c = 0; c < chunks; ++c) {
    if (kVec) cp_async_wait(chunks - 1 - c);
    __syncthreads();
    const int f1 = kVec ? min(kq, (c + 1) * kChunk) : kq;
#pragma unroll 4
    for (int f = kVec ? c * kChunk : 0; f < f1; ++f) {
      float4 zv[kRowsA], qv[kRowsQ];
#pragma unroll
      for (int a = 0; a < kRowsA; ++a)
        zv[a] = *reinterpret_cast<const float4*>(za + a * rs + 4 * f);
#pragma unroll
      for (int i = 0; i < kRowsQ; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qa + 32 * i * rs + 4 * f);
#pragma unroll
      for (int a = 0; a < kRowsA; ++a)
#pragma unroll
        for (int i = 0; i < kRowsQ; ++i) {
          float s = acc[a][i];
          s = fmaf(zv[a].x, qv[i].x, s);
          s = fmaf(zv[a].y, qv[i].y, s);
          s = fmaf(zv[a].z, qv[i].z, s);
          s = fmaf(zv[a].w, qv[i].w, s);
          acc[a][i] = s;
        }
    }
  }
}

// One (B-tile, Q-block): part[qb][a] = (max, sum exp(logit - max), positive
// logit sum, positive count) over the block's valid entries, per anchor.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
clustering_fwd_partial(const float* __restrict__ z,
                       const int* __restrict__ pseudo,
                       const unsigned char* __restrict__ aok,
                       const float* __restrict__ qz,
                       const int* __restrict__ qlab,
                       const unsigned char* __restrict__ qconf,
                       const unsigned char* __restrict__ qvalid, int B, int Q,
                       int d, float inv_temp, float4* __restrict__ part) {
  extern __shared__ __align__(16) float g_tile[];
  __shared__ TileMeta meta;
  const int qb = blockIdx.x, b0 = blockIdx.y * kTileB, q0 = qb * kTileQ;
  const int kq = (d + 3) / 4, rs = row_stride(kq);
  stage_tiles<kVec>(g_tile, z, qz, b0, q0, B, Q, d, kq, rs);
  load_meta(meta, pseudo, aok, qlab, qconf, qvalid, b0, q0, B, Q);
  float acc[kRowsA][kRowsQ];
  tile_logits<kVec>(g_tile, kq, rs, acc);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int mk[kRowsQ], lab[kRowsQ];
#pragma unroll
  for (int i = 0; i < kRowsQ; ++i) {
    mk[i] = meta.qmask[lane + 32 * i];
    lab[i] = meta.qlab[lane + 32 * i];
  }
#pragma unroll
  for (int a = 0; a < kRowsA; ++a) {
    const int al = kRowsA * warp + a;
    const int alab = meta.alab[al];
    const bool ok = meta.aok[al];
    // the warp's max over the block's valid entries first, so that each
    // entry takes one exp and the sums reduce without rescaling
    float logit[kRowsQ], m = kNegInf;
#pragma unroll
    for (int i = 0; i < kRowsQ; ++i) {
      logit[i] = acc[a][i] * inv_temp;
      if (mk[i]) m = fmaxf(m, logit[i]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
    float l = 0.f, ps = 0.f, pc = 0.f;
#pragma unroll
    for (int i = 0; i < kRowsQ; ++i) {
      if (mk[i]) l += expf(logit[i] - m);
      if (mk[i] == 2 && ok && lab[i] == alab) {
        ps += logit[i];
        pc += 1.f;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      l += __shfl_xor_sync(kFull, l, off);
      ps += __shfl_xor_sync(kFull, ps, off);
      pc += __shfl_xor_sync(kFull, pc, off);
    }
    if (lane == 0 && b0 + al < B)
      part[(size_t)qb * B + b0 + al] = make_float4(m, l, ps, pc);
  }
}

// Per anchor, the n_qb partials merged in Q-block order into pos_sum, n_pos
// and lse; then loss = sum over anchors with positives of (lse -
// pos_sum/n_pos), divided by denom = max(#anchors with positives, 1).  One
// block, a fixed reduction order.
__global__ void __launch_bounds__(kMergeThreads)
clustering_fwd_merge(const float4* __restrict__ part, int n_qb, int B,
                     float* __restrict__ pos_sum, float* __restrict__ n_pos,
                     float* __restrict__ lse, float* __restrict__ loss,
                     float* __restrict__ denom) {
  __shared__ float ss[kMergeThreads], cs[kMergeThreads];
  float s = 0.f, c = 0.f;
  for (int a = threadIdx.x; a < B; a += kMergeThreads) {
    float m = kNegInf;
    for (int j = 0; j < n_qb; ++j) m = fmaxf(m, part[(size_t)j * B + a].x);
    float l = 0.f, ps = 0.f, pc = 0.f;
    for (int j = 0; j < n_qb; ++j) {
      const float4 p = part[(size_t)j * B + a];
      l += p.y * expf(p.x - m);
      ps += p.z;
      pc += p.w;
    }
    const float ls = m + logf(l == 0.f ? 1.f : l);
    pos_sum[a] = ps;
    n_pos[a] = pc;
    lse[a] = ls;
    if (pc > 0.f) {
      s += -(ps / pc) + ls;
      c += 1.f;
    }
  }
  ss[threadIdx.x] = s;
  cs[threadIdx.x] = c;
  __syncthreads();
  for (int w = kMergeThreads / 2; w > 0; w >>= 1) {
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

// Four columns of a partial dz row: one 16-byte store (kVec), else those of
// the `left` columns still inside d.
template <bool kVec>
__device__ __forceinline__ void store4(float* dst, float4 s, int left) {
  if (kVec) {
    *reinterpret_cast<float4*>(dst) = s;
  } else {
    dst[0] = s.x;
    if (left > 1) dst[1] = s.y;
    if (left > 2) dst[2] = s.z;
    if (left > 3) dst[3] = s.w;
  }
}

// One (B-tile, Q-block): part[qb][a][:] = sum over the block's entries j of
// coef[a][j] queue_z[j], coef = g/denom/kappa * (exp(logit - lse) -
// pos/n_pos) over valid entries, for anchors with positives.  A B-tile
// without any returns at once: the merge writes its rows.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
clustering_bwd_partial(const float* __restrict__ z,
                       const int* __restrict__ pseudo,
                       const unsigned char* __restrict__ aok,
                       const float* __restrict__ qz,
                       const int* __restrict__ qlab,
                       const unsigned char* __restrict__ qconf,
                       const unsigned char* __restrict__ qvalid, int B, int Q,
                       int d, float inv_temp, const float* __restrict__ lse,
                       const float* __restrict__ n_pos,
                       const float* __restrict__ g,
                       const float* __restrict__ denom,
                       float* __restrict__ part) {
  extern __shared__ __align__(16) float g_tile[];
  __shared__ TileMeta meta;
  __shared__ float a_lse[kTileB], a_inv_np[kTileB];
  __shared__ int a_has[kTileB];
  const int qb = blockIdx.x, b0 = blockIdx.y * kTileB, q0 = qb * kTileQ;
  bool has = false;
  if (threadIdx.x < kTileB) {
    const int a = b0 + threadIdx.x;
    const float np = a < B ? n_pos[a] : 0.f;
    has = np > 0.f;
    a_has[threadIdx.x] = has;
    a_inv_np[threadIdx.x] = 1.f / (has ? np : 1.f);
    a_lse[threadIdx.x] = a < B ? lse[a] : 0.f;
  }
  if (!__syncthreads_or(has)) return;

  const int kq = (d + 3) / 4, rs = row_stride(kq);
  float* coef = g_tile + kRows * rs;                // [kTileB][kTileQ]
  stage_tiles<kVec>(g_tile, z, qz, b0, q0, B, Q, d, kq, rs);
  load_meta(meta, pseudo, aok, qlab, qconf, qvalid, b0, q0, B, Q);
  const float gscale = *g / *denom * inv_temp;
  float acc[kRowsA][kRowsQ];
  tile_logits<kVec>(g_tile, kq, rs, acc);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < kRowsQ; ++i) {
    const int j = lane + 32 * i;
    const int mk = meta.qmask[j], lab = meta.qlab[j];
#pragma unroll
    for (int a = 0; a < kRowsA; ++a) {
      const int al = kRowsA * warp + a;
      float c = 0.f;
      if (a_has[al] && mk > 0) {
        const float w = expf(acc[a][i] * inv_temp - a_lse[al]);
        const float p = mk == 2 && meta.aok[al] && lab == meta.alab[al]
                            ? a_inv_np[al]
                            : 0.f;
        c = (w - p) * gscale;
      }
      coef[al * kTileQ + j] = c;
    }
  }
  __syncthreads();

  // rows past Q are zeros and their coefficients 0: stop at the next 4
  const int nj4 = (min(kTileQ, Q - q0) + 3) / 4;
  const float* qrows = g_tile + kTileB * rs;
  for (int it = threadIdx.x; it < kTileB / 2 * kq; it += kThreads) {
    const int pair = it / kq, f = it - pair * kq;
    const float* c0 = coef + 2 * pair * kTileQ;
    const float* c1 = c0 + kTileQ;
    float4 s0 = make_float4(0.f, 0.f, 0.f, 0.f), s1 = s0;
    for (int j4 = 0; j4 < nj4; ++j4) {
      const float4 w0 = *reinterpret_cast<const float4*>(c0 + 4 * j4);
      const float4 w1 = *reinterpret_cast<const float4*>(c1 + 4 * j4);
      const float cw0[4] = {w0.x, w0.y, w0.z, w0.w};
      const float cw1[4] = {w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float4 q = *reinterpret_cast<const float4*>(
            qrows + (4 * j4 + t) * rs + 4 * f);
        s0.x = fmaf(cw0[t], q.x, s0.x);
        s0.y = fmaf(cw0[t], q.y, s0.y);
        s0.z = fmaf(cw0[t], q.z, s0.z);
        s0.w = fmaf(cw0[t], q.w, s0.w);
        s1.x = fmaf(cw1[t], q.x, s1.x);
        s1.y = fmaf(cw1[t], q.y, s1.y);
        s1.z = fmaf(cw1[t], q.z, s1.z);
        s1.w = fmaf(cw1[t], q.w, s1.w);
      }
    }
    const int a = b0 + 2 * pair;
    float* dst = part + ((size_t)qb * B + a) * d + 4 * f;
    if (a < B) store4<kVec>(dst, s0, d - 4 * f);
    if (a + 1 < B) store4<kVec>(dst + d, s1, d - 4 * f);
  }
}

// dz[a][:] = sum over Q-blocks, in order, of part[qb][a][:] for anchors with
// positives, else 0 (their B-tile's partials may never have been written).
// kSumRows anchors a block, 32 lanes along d.
__global__ void __launch_bounds__(kSumRows * 32)
clustering_bwd_merge(const float* __restrict__ part, int n_qb, int B, int d,
                     const float* __restrict__ n_pos,
                     float* __restrict__ dz) {
  const int a = blockIdx.x * kSumRows + threadIdx.y;
  if (a >= B) return;
  const bool has = n_pos[a] > 0.f;
  const size_t plane = (size_t)B * d;
  for (int k = threadIdx.x; k < d; k += 32) {
    const size_t i = (size_t)a * d + k;
    float s = 0.f;
    if (has)
      for (int j = 0; j < n_qb; ++j) s += part[j * plane + i];
    dz[i] = s;
  }
}

bool vector_loads(const float* z, const float* qz, int d) {
  return d % 4 == 0 && (reinterpret_cast<uintptr_t>(z) % 16) == 0 &&
         (reinterpret_cast<uintptr_t>(qz) % 16) == 0;
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

size_t bwd_smem(int d) {
  return tile_bytes(d) + (size_t)kTileB * kTileQ * sizeof(float);
}

}  // namespace

// part: (ceil(Q / 128), B, 4) fp32 scratch.  Writes pos_sum, n_pos, lse (B,)
// and the scalars loss and denom.
extern "C" int clustering_fwd(const float* z, const int* pseudo,
                              const unsigned char* aok, const float* qz,
                              const int* qlab, const unsigned char* qconf,
                              const unsigned char* qvalid, int B, int Q, int d,
                              float inv_temp, float* part, float* pos_sum,
                              float* n_pos, float* lse, float* loss,
                              float* denom, void* stream) {
  if (B < 1 || Q < 0 || d < 1 || d > kMaxD) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_qb = (Q + kTileQ - 1) / kTileQ;
  float4* p = reinterpret_cast<float4*>(part);
  if (n_qb > 0) {
    const dim3 grid(n_qb, (B + kTileB - 1) / kTileB);
    const size_t smem = tile_bytes(d);
    auto kernel = vector_loads(z, qz, d) ? &clustering_fwd_partial<true>
                                         : &clustering_fwd_partial<false>;
    cudaError_t e = set_smem(kernel, smem);
    if (e != cudaSuccess) return (int)e;
    kernel<<<grid, kThreads, smem, s>>>(z, pseudo, aok, qz, qlab, qconf,
                                        qvalid, B, Q, d, inv_temp, p);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  clustering_fwd_merge<<<1, kMergeThreads, 0, s>>>(p, n_qb, B, pos_sum, n_pos,
                                                   lse, loss, denom);
  return (int)cudaGetLastError();
}

// part: (ceil(Q / 128), B, d) fp32 scratch.  Writes dz (B, d).
extern "C" int clustering_bwd(const float* z, const int* pseudo,
                              const unsigned char* aok, const float* qz,
                              const int* qlab, const unsigned char* qconf,
                              const unsigned char* qvalid, int B, int Q, int d,
                              float inv_temp, const float* lse,
                              const float* n_pos, const float* g,
                              const float* denom, float* part, float* dz,
                              void* stream) {
  if (B < 1 || Q < 0 || d < 1 || d > kMaxD) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_qb = (Q + kTileQ - 1) / kTileQ;
  if (n_qb > 0) {
    const dim3 grid(n_qb, (B + kTileB - 1) / kTileB);
    const size_t smem = bwd_smem(d);
    auto kernel = vector_loads(z, qz, d) ? &clustering_bwd_partial<true>
                                         : &clustering_bwd_partial<false>;
    cudaError_t e = set_smem(kernel, smem);
    if (e != cudaSuccess) return (int)e;
    kernel<<<grid, kThreads, smem, s>>>(z, pseudo, aok, qz, qlab, qconf,
                                        qvalid, B, Q, d, inv_temp, lse, n_pos,
                                        g, denom, part);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  clustering_bwd_merge<<<(B + kSumRows - 1) / kSumRows, dim3(32, kSumRows), 0,
                         s>>>(part, n_qb, B, d, n_pos, dz);
  return (int)cudaGetLastError();
}

// The partial kernels' blocks resident on one SM at width d (16-byte loads),
// as the occupancy calculator gives it for their threads and shared memory.
extern "C" int clustering_occupancy(int d, int* fwd_blocks, int* bwd_blocks) {
  if (d < 1 || d > kMaxD) return (int)cudaErrorInvalidValue;
  cudaError_t e = set_smem(&clustering_fwd_partial<true>, tile_bytes(d));
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        fwd_blocks, &clustering_fwd_partial<true>, kThreads, tile_bytes(d));
  if (e == cudaSuccess)
    e = set_smem(&clustering_bwd_partial<true>, bwd_smem(d));
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        bwd_blocks, &clustering_bwd_partial<true>, kThreads, bwd_smem(d));
  return (int)e;
}
