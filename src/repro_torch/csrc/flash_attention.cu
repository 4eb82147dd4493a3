// Forward flash attention with grouped-query heads, causal masking and an
// optional sliding window, for Hopper (sm_90a).  Built by
// repro_torch/kernels/build.py into a shared library with a plain C
// interface and bound with ctypes (repro_torch/kernels/flash_attention.py).
//
// Replaces the TPU kernel in src/repro/kernels/flash_attention.py
// (flash_attention -> _flash_kernel), and computes what it computes:
//   o[b, h, i] = sum_j softmax_j(s[i, j]) v[b, h / G, j],
//   s[i, j]    = (q[b, h, i] . k[b, h / G, j]) / sqrt(hd),
// with G = H / KVH (any integer, 5 for Qwen3-14B's 40 over 8 heads) and no
// replicated K/V.  q and k have head dim hd, v and o head dim hd_v: equal
// (32 to 128), or MLA's (192, 128) (DeepSeek-V2: 128 nope + 64 rope
// columns for the scores, 128 value columns).  Key j is masked unless
// j < Skv, j <= i (causal, top-left: positions counted from 0 on both
// sides) and j > i - window (window > 0).
// Scores, the online softmax (running max from -1e30, masked keys weigh 0)
// and the accumulators are fp32; a row that sees no key outputs 0
// (l == 0 -> 1); the output is in the input's type.  Given a pointer,
// either kernel also writes each row's log-sum-exp of its scaled scores,
// lse = m scale + log l (fp32, (B, H, Sq) contiguous; -inf for a row that
// sees no key), which the backward pass (flash_attention_bwd.cu) reads to
// recompute P without a second softmax.  Every tensor is
// addressed as (B, H, S, hd) through its batch, head and sequence strides
// (the head dim contiguous), so the model hands in views of its (B, S, H,
// hd) projections and gets the output in that layout, with no transposed
// copies.  Ragged Sq and Skv are masked here: a prompt of any length goes
// through.  Two kernels, chosen by the inputs' type:
//
// flash_kernel_wgmma<HD, HDV> (bf16, the serving paths).  One block per (q
// tile of 128 rows, head, batch), a head's tiles launched together, heaviest
// causal tile first; two consumer warpgroups of 64 rows each and one
// producer warpgroup (setmaxnreg moves its registers to the consumers).
// One producer thread loads the Q tile once and the K and V tiles of 128
// keys into a ring of two stages in shared memory with TMA (4-d tensor
// maps over (hd, S, H, B) from the tensors' own strides, 128-byte swizzle,
// boxes of 64 columns; rows and columns out of bounds come in as zeros, which
// covers ragged Sq and Skv and head dims that are no multiple of 64; at MLA's
// (192, 128) a Q or K tile is three boxes and a V tile two, so Q, two K stages
// and two V stages take 48 + 2 (48 + 32) = 208 KB of the 227 KB a block may
// have), each stage behind a "full" mbarrier per tensor and an "empty" one the
// consumers release.  Each consumer warpgroup computes S = Q K^T with wgmma
// (m64n128k16 over hd / 16 k-steps, bf16 in, fp32 accumulate, both operands
// K-major in shared memory), runs the online softmax on the accumulator
// fragment in registers (a row lies in the 4 threads of a quad: the row max
// takes 2 shuffles, the row sum is reduced once at the end; the mask is
// applied only on tiles that hold a masked key; exp2f with log2 e folded into
// the fp32 scale), rounds P to bf16 in registers (the accumulator layout of
// the first product is the A-fragment layout of the second) and adds P V with
// wgmma (A from registers, V in shared memory in its MN-major form, in pieces
// of at most 64 columns, one per swizzle atom).  P in bf16 is the model's own
// arithmetic: the JAX attention casts its softmax weights to v's type before
// the product.
//
// flash_kernel<HD, HDV> (fp32: the card-against-CPU checks).  A simple
// CUDA-core kernel: one block of 128 threads per (q tile of 64 rows, head,
// batch) stages the K/V tiles of 64 keys in shared memory as fp32, keeps
// the 64 x hd_v accumulator in registers (4 rows x hd_v / 8 columns a
// thread; a row is 8 neighbouring lanes, so the row max and sum take three
// shuffles), and sends P through shared memory to the P.V product.  A
// wgmma on fp32 data would be TF32, which misses the fp32 tolerance.
//
// What bounds them: at Qwen3-14B's prefill shape, q (4, 40, 2048, 128) and
// k, v (4, 8, 2048, 128) in bf16, causal, attention does about 1.7e11
// operations on 0.2 GB, far above the card's ridge point, so operations
// bound it: 0.17 ms at the 989 TFLOP/s bf16 tensor-core rate.  The wgmma
// kernel runs both products on the tensor cores and overlaps the loads with
// them; what keeps it off the bound is the softmax between the products,
// which runs on the CUDA cores while the warpgroup's tensor-core work
// waits (only the other warpgroup's products overlap it; FA3's ping-pong
// and intra-warpgroup pipelining are later work), and the masked upper
// halves of the diagonal tiles (6 % more products than the mask leaves at
// S 2048).  At DeepSeek-V2's MLA prefill, q and k (4, 128, 2048, 192) and v
// (4, 128, 2048, 128), the 1.07e9 visible pairs take 640 operations each
// (2 x 192 for S, 2 x 128 for P V): 6.9e11 operations, 0.695 ms at that
// rate, against 1.34 GB moved, 0.40 ms at 3.35 TB/s, so operations bound it
// there too; the (192, 128) pair is the hd-128 kernel with 12 k-steps for
// S instead of 8 and the same 64 x 128 O accumulator a warpgroup.  The
// fp32 kernel multiplies on the CUDA cores, where the same work in fp32
// would take 2.6 ms at 67 TFLOP/s, and shared-memory loads feed every two
// to three of its multiply-adds.
//
// Built without --use_fast_math: exp of scores far below the running max
// must give 0, and masked scores (-inf in the wgmma kernel, -1e30 in the
// fp32 one) must never make a NaN.
//
// No allocation and no synchronisation here: each entry point launches on
// the caller's stream and returns cudaGetLastError() (or, for a tensor map
// cuTensorMapEncodeTiled refuses, the negated CUresult).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"  // mbarriers, TMA, wgmma; the tensor-map encoder

namespace {

struct Strides {
  long long b, h, s;  // in elements; the head dim is contiguous
};

// ===========================================================================
// bf16: wgmma, TMA and mbarriers (hopper.cuh)
// ===========================================================================

template <int HD, int HDV>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_kernel_wgmma(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                   int H, int B, int group, int Sq, int Skv, Strides os,
                   int causal, int window, float scale, float scale_log2) {
  static_assert(HD % 16 == 0 && HD <= 3 * kChunk, "q/k head dim");
  static_assert(HDV % 16 == 0 && HDV <= 2 * kChunk, "v head dim");
  constexpr int kChunks = (HD + kChunk - 1) / kChunk;  // boxes per Q/K tile
  constexpr int kVChunks = (HDV + kChunk - 1) / kChunk;  // per V tile
  constexpr int kTileBytes = kChunks * kBoxBytes;      // Q or K tile
  constexpr int kVTileBytes = kVChunks * kBoxBytes;    // V tile
  constexpr int kSteps = HD / 16;         // k16 steps of Q K^T over hd
  constexpr int kPSteps = kWgKeys / 16;   // k16 steps of P V over the keys
  constexpr int kOut = HDV / 2;           // O floats a thread holds
  constexpr int kS = kWgKeys / 2;         // S floats a thread holds

  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bar_q, bar_k[kStages], bar_v[kStages],
      bar_empty[kStages];
  // the swizzle atoms must start on 1024-byte boundaries
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sq = smem;                              // [kChunks][128][64]
  uint8_t* sk = sq + kTileBytes;                   // [kStages] tiles
  uint8_t* sv = sk + kStages * kTileBytes;         // [kStages] V tiles

  // block -> (q tile, head, batch), the q tile fastest and reversed: a
  // head's tiles run together, so its K/V stays in L2 while they read it,
  // and within a head the tiles that visit the most keys under the causal
  // mask start first, so the last wave holds the lightest ones
  const int n_qt = (Sq + kWgRows - 1) / kWgRows;
  int bid = blockIdx.x;
  const int q0 = (n_qt - 1 - bid % n_qt) * kWgRows;
  bid /= n_qt;
  const int head = bid % H;
  const int batch = bid / H;
  const int kv_head = head / group;

  // the key tiles that can hold an unmasked key for some row of this tile;
  // none when a window ends before the keys do
  int k_end = Skv;
  if (causal) k_end = min(k_end, q0 + kWgRows);
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_begin = k_begin / kWgKeys;
  const int n_tiles = max(0, (k_end + kWgKeys - 1) / kWgKeys - t_begin);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    mbar_init(&bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&bar_k[s], 1);
      mbar_init(&bar_v[s], 1);
      mbar_init(&bar_empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    // the producer warpgroup; one thread loads Q once, then each K/V tile
    // into the next free stage
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kProducerRegs));
    if (warp == kConsumerWarps && lane == 0) {
      mbar_expect_tx(&bar_q, kTileBytes);
      for (int c = 0; c < kChunks; ++c)
        tma_load_4d(sq + c * kBoxBytes, &tm_q, &bar_q, c * kChunk, q0, head,
                    batch);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        const int k0 = (t_begin + i) * kWgKeys;
        mbar_wait(&bar_empty[s], ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(&bar_k[s], kTileBytes);
        for (int c = 0; c < kChunks; ++c)
          tma_load_4d(sk + s * kTileBytes + c * kBoxBytes, &tm_k, &bar_k[s],
                      c * kChunk, k0, kv_head, batch);
        mbar_expect_tx(&bar_v[s], kVTileBytes);
        for (int c = 0; c < kVChunks; ++c)
          tma_load_4d(sv + s * kVTileBytes + c * kBoxBytes, &tm_v, &bar_v[s],
                      c * kChunk, k0, kv_head, batch);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        kConsumerRegs));
    // a consumer: warpgroup wg owns rows q0 + 64 wg .. + 63; in the wgmma
    // fragments a thread holds rows r and r + 8 and, of each 8 columns, the
    // two at 2 (lane % 4)
    const int wg = warp / 4;
    const int wg_row0 = q0 + wg * 64;
    const int row = wg_row0 + (warp % 4) * 16 + lane / 4;
    const int col = 2 * (lane % 4);

    float acc[kOut];
#pragma unroll
    for (int i = 0; i < kOut; ++i) acc[i] = 0.f;
    float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f};

    const uint32_t q_addr = smem_u32(sq) + wg * 64 * 128;
    mbar_wait(&bar_q, 0);

    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStages;
      const uint32_t parity = (i / kStages) & 1;
      const int k0 = (t_begin + i) * kWgKeys;

      // S = Q K^T
      float sc[kS];
      const uint32_t k_addr = smem_u32(sk + s * kTileBytes);
      mbar_wait(&bar_k[s], parity);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
        wgmma_ss_n128(sc, smem_desc(q_addr + off), smem_desc(k_addr + off),
                      kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<kS>(sc);

      // the mask, only where this warpgroup's rows meet a masked key
      const bool ragged = k0 + kWgKeys > Skv;
      const bool diag = causal && k0 + kWgKeys - 1 > wg_row0;
      const bool edge = window > 0 && k0 <= wg_row0 + 63 - window;
      if (ragged || diag || edge) {
#pragma unroll
        for (int j = 0; j < kS / 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + 8 * j + col + (e & 1);
            const int r = row + (e >> 1) * 8;
            const bool ok = key < Skv && (!causal || key <= r) &&
                            (window <= 0 || key > r - window);
            if (!ok) sc[4 * j + e] = -INFINITY;
          }
      }

      // online softmax: the running max of the raw scores over the quad
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < kS / 4; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(sc[4 * j], sc[4 * j + 1]));
        mx[1] = fmaxf(mx[1], fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
      float alpha[2], bias[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        alpha[h] = exp2f((m[h] - mx[h]) * scale_log2);
        bias[h] = -mx[h] * scale_log2;
        m[h] = mx[h];
      }
      // P = exp(scale (s - m)), summed in fp32 and rounded to bf16 as the A
      // fragments of P V: keys 16 kk .. are the n8 blocks 2 kk and 2 kk + 1
      uint32_t p[kPSteps][4];
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < kPSteps; ++kk) {
        float e[8];
#pragma unroll
        for (int t = 0; t < 8; ++t)
          e[t] = exp2f(fmaf(sc[8 * kk + t], scale_log2, bias[(t >> 1) & 1]));
        rs[0] += (e[0] + e[1]) + (e[4] + e[5]);
        rs[1] += (e[2] + e[3]) + (e[6] + e[7]);
        p[kk][0] = pack_bf16(e[0], e[1]);
        p[kk][1] = pack_bf16(e[2], e[3]);
        p[kk][2] = pack_bf16(e[4], e[5]);
        p[kk][3] = pack_bf16(e[6], e[7]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) l[h] = alpha[h] * l[h] + rs[h];
#pragma unroll
      for (int j = 0; j < kOut / 4; ++j) {
        acc[4 * j] *= alpha[0];
        acc[4 * j + 1] *= alpha[0];
        acc[4 * j + 2] *= alpha[1];
        acc[4 * j + 3] *= alpha[1];
      }

      // O += P V, one wgmma per swizzle atom of V's columns
      const uint32_t v_addr = smem_u32(sv + s * kVTileBytes);
      mbar_wait(&bar_v[s], parity);
      fence_regs<kOut>(acc);
      fence_regs<kPSteps * 4>(&p[0][0]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kPSteps; ++kk) {
        const uint32_t off = kk * 2 * kAtomBytes;  // 16 key rows
        wgmma_rs<(HDV < kChunk ? HDV : kChunk)>(acc, p[kk],
                                                smem_desc(v_addr + off));
        if constexpr (HDV > kChunk)
          wgmma_rs<HDV - kChunk>(acc + kChunk / 2, p[kk],
                                 smem_desc(v_addr + kBoxBytes + off));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<kOut>(acc);
      fence_regs<kPSteps * 4>(&p[0][0]);
      __syncwarp();
      if (lane == 0) mbar_arrive(&bar_empty[s]);
    }

    // O / l in bf16, rows < Sq only, through the output's strides; the
    // row's lse (the raw max m is unscaled here) from the quad's first lane
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      const int r = row + 8 * h;
      if (lse != nullptr && lane % 4 == 0 && r < Sq)
        lse[((long long)batch * H + head) * Sq + r] =
            l[h] > 0.f ? fmaf(m[h], scale, logf(l[h])) : -INFINITY;
      l[h] = 1.f / (l[h] == 0.f ? 1.f : l[h]);
    }
    __nv_bfloat16* ob = o + batch * os.b + head * os.h;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row + 8 * h;
      if (r >= Sq) continue;
      __nv_bfloat16* orow = ob + r * os.s + col;
#pragma unroll
      for (int j = 0; j < kOut / 4; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j) = pack_bf16(
            acc[4 * j + 2 * h] * l[h], acc[4 * j + 2 * h + 1] * l[h]);
    }
  }
}


template <int HD, int HDV>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 float* lse, int B, int H, int KVH, int Sq, int Skv,
                 const long long* st, int causal, int window,
                 cudaStream_t stream) {
  static_assert(kWgRows == kWgKeys, "Q and K/V share their box");
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap tm_q, tm_k, tm_v;
  CUresult r = make_map(&tm_q, encode, q, HD, Sq, H, B, st);
  if (r == CUDA_SUCCESS) r = make_map(&tm_k, encode, k, HD, Skv, KVH, B,
                                      st + 3);
  if (r == CUDA_SUCCESS) r = make_map(&tm_v, encode, v, HDV, Skv, KVH, B,
                                      st + 6);
  if (r != CUDA_SUCCESS) return -(int)r;
  constexpr int kTile = (HD + kChunk - 1) / kChunk * kBoxBytes;
  constexpr int kVTile = (HDV + kChunk - 1) / kChunk * kBoxBytes;
  // Q, the K stages, the V stages, + alignment
  constexpr int bytes = (1 + kStages) * kTile + kStages * kVTile + 1024;
  static_assert(bytes <= 232448, "shared memory a block may have");
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel_wgmma<HD, HDV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const long long blocks =
      (long long)((Sq + kWgRows - 1) / kWgRows) * H * B;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  flash_kernel_wgmma<HD, HDV>
      <<<(unsigned)blocks, kWgThreads, bytes, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o), lse, H, B, H / KVH,
      Sq, Skv, Strides{st[9], st[10], st[11]}, causal, window,
      (float)(1.0 / sqrt((double)HD)),
      (float)(1.4426950408889634 / sqrt((double)HD)));
  return (int)cudaGetLastError();
}

// ===========================================================================
// fp32: the CUDA-core kernel
// ===========================================================================

constexpr int kBlockQ = 64;           // query rows per block
constexpr int kBlockK = 64;           // keys per tile
constexpr int kThreads = 128;
constexpr int kLanesPerRow = 8;       // threads sharing one query row
constexpr int kRows = kBlockQ / (kThreads / kLanesPerRow);  // 4 per thread
constexpr int kCols = kBlockK / kLanesPerRow;               // 8 per thread
constexpr int kPad = kBlockQ + 1;     // row stride of the transposed tiles
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

static_assert(kBlockQ == kBlockK, "the transposed tiles share kPad");

// max / sum over the 8 neighbouring lanes of one query row
__device__ __forceinline__ float row_max(float x) {
  for (int off = 1; off < kLanesPerRow; off <<= 1)
    x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
  for (int off = 1; off < kLanesPerRow; off <<= 1)
    x += __shfl_xor_sync(kFull, x, off);
  return x;
}

template <int HD, int HDV>
constexpr int smem_floats() {
  // Q^T [HD][kPad], K^T [max(HD, kBlockK)][kPad] (also P^T [kBlockK][kPad]),
  // V [kBlockK][HDV]
  return HD * kPad + (HD > kBlockK ? HD : kBlockK) * kPad + kBlockK * HDV;
}

template <int HD, int HDV>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o,
             float* __restrict__ lse, int group, int Sq, int Skv, Strides qs,
             Strides ks, Strides vs, Strides os, int causal, int window,
             float sm_scale) {
  static_assert(HD % kLanesPerRow == 0 && HDV % kLanesPerRow == 0,
                "head dims must be multiples of 8");
  constexpr int kOut = HDV / kLanesPerRow;  // output columns per thread
  extern __shared__ float smem[];
  float* q_t = smem;                        // [HD][kPad]
  float* k_t = q_t + HD * kPad;             // [HD][kPad]
  float* p_t = k_t;                         // [kBlockK][kPad], after S
  float* v_s = k_t + (HD > kBlockK ? HD : kBlockK) * kPad;  // [kBlockK][HDV]

  const int q0 = blockIdx.x * kBlockQ;
  const int head = blockIdx.y, batch = blockIdx.z;
  const int kv_head = head / group;
  const int tid = threadIdx.x;
  const int row0 = (tid / kLanesPerRow) * kRows;  // this thread's first row
  const int col = tid % kLanesPerRow;             // its first column

  const float* qb = q + batch * qs.b + head * qs.h;
  const float* kb = k + batch * ks.b + kv_head * ks.h;
  const float* vb = v + batch * vs.b + kv_head * vs.h;
  float* ob = o + batch * os.b + head * os.h;

  for (int i = tid; i < kBlockQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    q_t[d * kPad + r] = q0 + r < Sq ? qb[(q0 + r) * qs.s + d] : 0.f;
  }

  float acc[kRows][kOut];
  float m[kRows], l[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kOut; ++c) acc[i][c] = 0.f;
  }

  // the key tiles that can hold an unmasked key for some row of this tile
  int k_end = Skv;
  if (causal) k_end = min(k_end, q0 + kBlockQ);
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_end = (k_end + kBlockK - 1) / kBlockK;

  for (int t = k_begin / kBlockK; t < t_end; ++t) {
    const int k0 = t * kBlockK;
    __syncthreads();  // the last tile's P and V are no longer read
    for (int i = tid; i < kBlockK * HD; i += kThreads) {
      const int r = i / HD, d = i % HD;
      k_t[d * kPad + r] = k0 + r < Skv ? kb[(k0 + r) * ks.s + d] : 0.f;
    }
    for (int i = tid; i < kBlockK * HDV; i += kThreads) {
      const int r = i / HDV, d = i % HDV;
      v_s[r * HDV + d] = k0 + r < Skv ? vb[(k0 + r) * vs.s + d] : 0.f;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = q_t[d * kPad + row0 + i];
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        kv[j] = k_t[d * kPad + col + j * kLanesPerRow];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // mask, then the online softmax update of each row
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qi = q0 + row0 + i;
      bool ok[kCols];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kj = k0 + col + j * kLanesPerRow;
        ok[j] = kj < Skv && (!causal || kj <= qi) &&
                (window <= 0 || kj > qi - window);
        s[i][j] = ok[j] ? s[i][j] * sm_scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        s[i][j] = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += s[i][j];
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kOut; ++c) acc[i][c] *= alpha;
    }

    __syncthreads();  // every thread is done with K^T: it becomes P^T
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        p_t[(col + j * kLanesPerRow) * kPad + row0 + i] = s[i][j];
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < kBlockK; ++j) {
      float pv[kRows], vv[kOut];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = p_t[j * kPad + row0 + i];
#pragma unroll
      for (int c = 0; c < kOut; ++c)
        vv[c] = v_s[j * HDV + col + c * kLanesPerRow];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < kOut; ++c)
          acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + row0 + i;
    if (qi >= Sq) continue;
    if (lse != nullptr && col == 0)  // m is in scaled units here
      lse[((long long)batch * gridDim.y + head) * Sq + qi] =
          l[i] > 0.f ? m[i] + logf(l[i]) : -INFINITY;
    const float denom = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int c = 0; c < kOut; ++c)
      ob[qi * os.s + col + c * kLanesPerRow] = acc[i][c] / denom;
  }
}


template <int HD, int HDV>
int launch_fp32(const void* q, const void* k, const void* v, void* o,
                float* lse, int B, int H, int KVH, int Sq, int Skv,
                const long long* st, int causal, int window,
                cudaStream_t stream) {
  constexpr int bytes = smem_floats<HD, HDV>() * (int)sizeof(float);
  static_assert(bytes <= 232448, "shared memory a block may have");
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<HD, HDV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + kBlockQ - 1) / kBlockQ, H, B);
  flash_kernel<HD, HDV><<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, H / KVH, Sq,
      Skv,
      Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
      Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]}, causal,
      window, (float)(1.0 / sqrt((double)HD)));
  return (int)cudaGetLastError();
}

using Launch = int (*)(const void*, const void*, const void*, void*, float*,
                       int, int, int, int, int, const long long*, int, int,
                       cudaStream_t);

template <int HD, int HDV = HD>
Launch pick(bool bf16) {
  if (bf16) return launch_wgmma<HD, HDV>;
  return launch_fp32<HD, HDV>;
}

}  // namespace

// q: (B, H, Sq, hd); k: (B, KVH, Skv, hd); v: (B, KVH, Skv, hd_v); o: (B,
// H, Sq, hd_v), hd_v == hd or (hd, hd_v) = (192, 128); each addressed through
// strides[3 * t .. 3 * t + 2] = its (batch, head, sequence) strides in
// elements, t = q, k, v, o.  dtype: 0 = float32 (flash_kernel), 1 =
// bfloat16 (flash_kernel_wgmma, which also needs q, k and v 16-byte aligned
// with strides that are multiples of 8 elements: the tensor maps' rule,
// checked by the wrapper).  lse: (B, H, Sq) fp32, or null for none.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, float* lse,
                                   int dtype, int B, int H, int KVH, int Sq,
                                   int Skv, int hd, int hd_v,
                                   const long long* strides, int causal,
                                   int window, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || H > 65535 || KVH < 1 || H % KVH ||
      Sq < 1 || Skv < 1 || window < 0 || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  const bool bf16 = dtype == 1;
  Launch fn = nullptr;
  if (hd_v != hd) {
    if (hd != 192 || hd_v != 128) return (int)cudaErrorInvalidValue;
    fn = pick<192, 128>(bf16);
  } else switch (hd) {
    case 32: fn = pick<32>(bf16); break;
    case 64: fn = pick<64>(bf16); break;
    case 80: fn = pick<80>(bf16); break;
    case 96: fn = pick<96>(bf16); break;
    case 112: fn = pick<112>(bf16); break;
    case 128: fn = pick<128>(bf16); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return fn(q, k, v, o, lse, B, H, KVH, Sq, Skv, strides, causal, window,
            static_cast<cudaStream_t>(stream));
}
